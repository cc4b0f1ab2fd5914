"""Physics Residual Error (PRE) operators, one module per PDE family."""

from .jorek import PRE_JOREK
from .mhd import PRE_MHD
from .ns import PRE_NS
from .wave import PRE_Wave

__all__ = ["PRE_JOREK", "PRE_MHD", "PRE_NS", "PRE_Wave"]
