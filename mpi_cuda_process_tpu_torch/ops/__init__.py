# imported to populate the stencil registry
from . import advection, heat, life, reaction, sor, wave  # noqa: F401
from .stencil import Stencil, available_stencils, make_stencil

__all__ = ["Stencil", "available_stencils", "make_stencil"]
