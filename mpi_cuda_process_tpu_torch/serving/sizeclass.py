"""Size classes: the build identity of a serving job.

The port's copy of the TPU package's ``serving/sizeclass.py``.  A job's
:class:`~..config.RunConfig` splits three ways here:

* LIFECYCLE fields (config.LIFECYCLE_FIELDS) — never part of any built
  step; the scheduler honors the ones that make sense for a slot-resident
  job (telemetry) and rejects the ones that cannot (``--resume``, per-job
  checkpoints, profilers — see ``scheduler.ServingEngine.submit``).
* PER-JOB simulation fields (:data:`PER_JOB_SIM_FIELDS`) — seed, density,
  init kind, iters: they choose a member's *initial state* and *duration*
  but appear nowhere in the built step, which is exactly why N different
  jobs can share one batched step (every kernel takes a block's members in
  one launch, each member bit-equal to its own solo run).
* CLASS fields (:data:`CLASS_FIELDS`) — everything else: stencil, grid,
  dtype, mesh, compute path, fuse/overlap/pipeline/exchange, params, and
  the port's ``device``.  Two jobs agreeing on these can ride the same
  resident step; the canonical JSON of this subset is the size-class key
  (:func:`class_signature`).

The padded dimension of a size class is the MEMBER axis: capacities come
from a small fixed ladder (default 1/2/4/8), each built once when first
needed, so occupancy changes build nothing new at a rung already reached.
The spatial grid is never padded — grid padding would change the
stencil's physics and break the bit-exact-vs-solo contract that makes
slot isolation trustworthy.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

from ..config import RunConfig, SIM_FIELDS

# Simulation fields that select a member's initial state and duration,
# not the built step.  ``ensemble*`` belongs to the scheduler (the member
# axis IS the batching axis), and the --tol runner has no chunk
# boundaries to batch at — submit rejects both non-zero.
PER_JOB_SIM_FIELDS = frozenset({
    "seed", "density", "init", "iters",
    "ensemble", "ensemble_mesh", "ensemble_perturb",
    "tol", "tol_check_every",
})

CLASS_FIELDS = frozenset(SIM_FIELDS) - PER_JOB_SIM_FIELDS


def class_key_dict(cfg: RunConfig) -> Dict[str, Any]:
    """The class-identity fields of ``cfg`` alone, as a plain dict."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in CLASS_FIELDS}


def class_signature(cfg: RunConfig) -> str:
    """Canonical JSON of the class fields — the size-class key.

    Two configs with equal signatures run on the same resident step (same
    kernels, same mesh, same numerics); they may differ freely in
    seed/density/init/iters and every lifecycle field.
    """
    return json.dumps(class_key_dict(cfg), sort_keys=True)


def class_config(cfg: RunConfig, capacity: int) -> RunConfig:
    """The build config of ``cfg``'s size class at ``capacity`` members.

    Class fields are taken from the job; per-job and lifecycle fields
    reset to defaults (the built state is ballast — every occupied slot
    is overwritten with its job's own solo init before it computes
    anything a tenant sees); the member axis opens at ``capacity``.
    """
    defaults = dataclasses.asdict(RunConfig())
    merged = {**defaults, **class_key_dict(cfg)}
    merged["ensemble"] = int(capacity)
    return RunConfig.from_dict(merged)


def ladder_rung(ladder: Tuple[int, ...], demand: int) -> int:
    """Smallest ladder capacity >= ``demand`` (else the top rung)."""
    for c in ladder:
        if c >= demand:
            return c
    return ladder[-1]


def next_rung(ladder: Tuple[int, ...], capacity: int) -> int:
    """The rung above ``capacity``, or ``capacity`` at the top."""
    for c in ladder:
        if c > capacity:
            return c
    return capacity


def prev_rung(ladder: Tuple[int, ...], capacity: int) -> int:
    """The rung below ``capacity``, or ``capacity`` at the bottom."""
    out = capacity
    for c in ladder:
        if c < capacity:
            out = c
    return out
