"""Field diagnostics for the CLI's log lines.

Per logging interval: field min/max/mean (population for integer Life
grids), the wave model's ``|u - u_prev|`` velocity norm, and for diffusion
models the one-step Jacobi residual.  The reductions stay on the device as
0-d tensors and are stacked and fetched in ONE host transfer per interval,
so a four-metric line pays one device-to-host round trip, not four.  A
decomposed run's fields are reduced per block and the partial results
combined on the first block's device before that one transfer; under a
multi-process run every process gathers every shard's partials
(``Mesh.gather``) and combines them in mesh row-major order, the order one
process combines its blocks in, so each process's line is the
single-process line, digit for digit.

Every value carries the field's dtype, as the TPU package's result types
do: a sum or mean accumulates in float32 and is rounded once to the field's
dtype (bfloat16 lines print bfloat16 values); ``velocity_l2`` takes the
difference and its square in the field's dtype, then the float32 sum,
rounded, and its square root in that dtype.  Float32 fields reduce exactly
as before.  The residual stays in float32, as in the TPU package.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.stencil import Stencil


def _blocks(f):
    """A field's blocks: itself when whole, its local blocks when sharded."""
    return list(f) if isinstance(f, list) else [f]


def _mesh(f):
    """A sharded field's mesh, None for a whole tensor."""
    return getattr(f, "mesh", None)


def _combine(parts, op, mesh=None):
    """Reduce per-block 0-d tensors on the first block's device, over every
    shard of ``mesh`` (every process's) in mesh row-major order."""
    dev = parts[0].device
    if mesh is not None:
        parts = mesh.gather(parts)
    return op(torch.stack([p.to(dev) for p in parts]))


def _sum_sq(a, b):
    """sum((a - b)^2) over every block, float32."""
    return _combine([torch.sum((x.to(torch.float32) - y.to(torch.float32))
                               ** 2)
                     for x, y in zip(_blocks(a), _blocks(b))], torch.sum,
                    _mesh(a))


def _result_dtype(t) -> torch.dtype:
    """The dtype a reduction of ``t`` is rounded to: its own where it is a
    float type, float32 for an integer one."""
    return t.dtype if t.is_floating_point() else torch.float32


def _velocity_l2(a, b):
    """sqrt(sum((a - b)^2)) in the fields' dtype: the difference and the
    square in it, the sum over every block in float32 rounded to it, then
    the square root (JAX's ``jnp.sqrt(jnp.sum((a - b) ** 2))``)."""
    dtype = _result_dtype(_blocks(a)[0])
    total = _combine([torch.sum((x - y) ** 2, dtype=torch.float32)
                      for x, y in zip(_blocks(a), _blocks(b))], torch.sum,
                     _mesh(a))
    return torch.sqrt(total.to(dtype))


def _staged_diagnostics(stencil: Stencil, fields, step_fn=None):
    """The metric set as unfetched 0-d tensors (device-side)."""
    f0 = _blocks(fields[0])
    mesh = _mesh(fields[0])
    multi = mesh is not None and mesh.multiprocess
    out = {}
    if stencil.name == "life":
        out["population"] = _combine([torch.sum(b) for b in f0], torch.sum,
                                     mesh)
    elif len(f0) == 1 and not multi:
        out["mean"] = torch.mean(f0[0].to(torch.float32)).to(
            _result_dtype(f0[0]))
        out["min"] = torch.min(f0[0])
        out["max"] = torch.max(f0[0])
    else:
        cells = f0[0].numel() * mesh.size
        out["mean"] = (_combine([torch.sum(b.to(torch.float32)) for b in f0],
                                torch.sum, mesh) / cells).to(
            _result_dtype(f0[0]))
        out["min"] = _combine([torch.min(b) for b in f0], torch.min, mesh)
        out["max"] = _combine([torch.max(b) for b in f0], torch.max, mesh)
    if stencil.num_fields > 1:
        out["velocity_l2"] = _velocity_l2(fields[0], fields[1])
    elif step_fn is not None and f0[0].is_floating_point():
        out["residual"] = _residual_scalar(step_fn, fields)
    return out


def field_diagnostics(stencil: Stencil, fields,
                      step_fn=None) -> Dict[str, float]:
    """All metrics for one logging interval — ONE host transfer total.

    Keys come back sorted, as the TPU package's log lines print them."""
    staged = _staged_diagnostics(stencil, fields, step_fn=step_fn)
    dev = next(iter(staged.values())).device
    packed = torch.stack([v.to(dev, torch.float64) for v in staged.values()])
    return dict(sorted(zip(staged, packed.cpu().tolist())))


def _residual_scalar(step_fn, fields):
    """One-step-change L2 norm as an unfetched 0-d tensor."""
    new = step_fn(tuple(fields))
    return torch.sqrt(_sum_sq(new[0], fields[0]))


def format_diagnostics(d: Dict[str, float]) -> str:
    return "  ".join(f"{k}={v:.6g}" for k, v in d.items())
