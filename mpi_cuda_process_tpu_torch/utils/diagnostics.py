"""Field diagnostics for the CLI's log lines.

Per logging interval: field min/max/mean (population for integer Life
grids), the wave model's ``|u - u_prev|`` velocity norm, and for diffusion
models the one-step Jacobi residual.  The reductions stay on the device as
0-d tensors and are stacked and fetched in ONE host transfer per interval,
so a four-metric line pays one device-to-host round trip, not four.  A
decomposed run's fields are reduced per block and the partial results
combined on the first block's device before that one transfer.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.stencil import Stencil


def _blocks(f):
    """A field's blocks: itself when whole, its local blocks when sharded."""
    return list(f) if isinstance(f, list) else [f]


def _combine(parts, op):
    """Reduce per-block 0-d tensors on the first block's device."""
    dev = parts[0].device
    return op(torch.stack([p.to(dev) for p in parts]))


def _sum_sq(a, b):
    """sum((a - b)^2) over every block, float32."""
    return _combine([torch.sum((x.to(torch.float32) - y.to(torch.float32))
                               ** 2)
                     for x, y in zip(_blocks(a), _blocks(b))], torch.sum)


def _staged_diagnostics(stencil: Stencil, fields, step_fn=None):
    """The metric set as unfetched 0-d tensors (device-side)."""
    f0 = _blocks(fields[0])
    out = {}
    if stencil.name == "life":
        out["population"] = _combine([torch.sum(b) for b in f0], torch.sum)
    elif len(f0) == 1:
        out["mean"] = torch.mean(f0[0].to(torch.float32))
        out["min"] = torch.min(f0[0])
        out["max"] = torch.max(f0[0])
    else:
        cells = sum(b.numel() for b in f0)
        out["mean"] = _combine([torch.sum(b.to(torch.float32)) for b in f0],
                               torch.sum) / cells
        out["min"] = _combine([torch.min(b) for b in f0], torch.min)
        out["max"] = _combine([torch.max(b) for b in f0], torch.max)
    if stencil.num_fields > 1:
        out["velocity_l2"] = torch.sqrt(_sum_sq(fields[0], fields[1]))
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
