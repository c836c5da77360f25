from . import heat, life, wave  # noqa: F401  (populate the stencil registry)
from .stencil import Stencil, available_stencils, make_stencil

__all__ = ["Stencil", "available_stencils", "make_stencil"]
