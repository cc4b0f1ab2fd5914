"""Physics Residual Error (PRE) operators, one module per PDE family."""

from .advection import PRE_Advection
from .burgers import PRE_Burgers
from .gs import PRE_GradShafranov
from .jorek import PRE_JOREK
from .mhd import PRE_MHD
from .ns import PRE_NS
from .wave import PRE_Wave

__all__ = ["PRE_Advection", "PRE_Burgers", "PRE_GradShafranov", "PRE_JOREK", "PRE_MHD", "PRE_NS",
           "PRE_Wave"]
