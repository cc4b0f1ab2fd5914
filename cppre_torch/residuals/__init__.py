"""Physics Residual Error (PRE) operators, one module per PDE family."""

from .ns import PRE_NS

__all__ = ["PRE_NS"]
