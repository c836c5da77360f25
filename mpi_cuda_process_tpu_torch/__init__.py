"""Stencil / finite-difference framework on PyTorch and CUDA (NVIDIA H100).

The port of the TPU package beside it, which stays as the reference: the
same stencil registry, guard-frame semantics, CLI flags and checkpoint
format, with the TPU kernels rewritten by hand in CUDA C++ for Hopper
(``ops/cuda/``).  It imports PyTorch and numpy only.
"""

from .config import RunConfig
from .driver import make_runner, make_step, run_simulation
# register stencils
from .ops import advection, heat, life, reaction, sor, wave  # noqa: F401
from .ops.stencil import Stencil, available_stencils, make_stencil
from .utils.init import init_state

__version__ = "0.1.0"

__all__ = [
    "RunConfig",
    "Stencil",
    "available_stencils",
    "init_state",
    "make_runner",
    "make_stencil",
    "make_step",
    "run_simulation",
    "__version__",
]
