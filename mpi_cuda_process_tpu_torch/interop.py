"""State carried across between the TPU package and the port.

A run's state is its fields: a tuple of equally shaped arrays.  The TPU
package's fields (handed over as numpy arrays) and its ``npy`` checkpoints
(``utils/checkpointing.py``, the same on-disk format on both sides) become
the port's tensors unchanged, and back.  bfloat16 has no numpy dtype of its
own; it crosses as ``ml_dtypes.bfloat16`` (the type the TPU package's
checkpoints hold) where that package is installed.

A decomposed run's fields (``parallel.stepper.ShardedField``) cross as
their gathered global arrays: :func:`gather_to_numpy` assembles them on the
host block by block (no device holds the global grid), and
:func:`shard_from_numpy` cuts global arrays into the blocks of the shards
this process holds.  Under a multi-process run no process holds the global
grid, so :func:`gather_to_numpy` (and :func:`fields_to_numpy` of sharded
fields) raises there.

A coupled ``--groups`` run's state is one field tuple a group:
:func:`coupled_from_numpy` carries the TPU package's ``CoupledRunner``
fields (per group, as numpy) into the port's runner, so both packages
step from the same state.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .ops.stencil import Fields, as_torch_dtype
from .parallel.stepper import (GLOBAL_GRID_REASON, ShardedField,
                               ensemble_members_local)


def _ml_bfloat16():
    try:
        import ml_dtypes
    except ImportError as e:  # pragma: no cover - depends on the install
        raise NotImplementedError(
            "bfloat16 fields cross to numpy as ml_dtypes.bfloat16, and "
            "ml_dtypes is not installed") from e
    return ml_dtypes.bfloat16


def _is_bfloat16(a: np.ndarray, dtype) -> bool:
    """An ml_dtypes bfloat16 array, or the ``|V2`` array that ``np.load``
    returns for one that ``np.save`` wrote, when ``dtype`` says bfloat16."""
    if a.dtype.name == "bfloat16":
        return True
    return (a.dtype.kind == "V" and a.dtype.itemsize == 2
            and dtype is not None
            and as_torch_dtype(dtype) == torch.bfloat16)


def _to_tensor(a, device, dtype) -> torch.Tensor:
    # a writable copy the tensor owns: never alias the caller's (often
    # read-only) array, even when the tensor stays on the CPU
    a = np.array(a, order="C")
    if _is_bfloat16(a, dtype):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))
    return t.to(device)


def fields_from_numpy(fields: Sequence, device="cuda", dtype=None) -> Fields:
    """numpy arrays -> tensors on ``device`` (cast to ``dtype`` if given;
    a ``|V2`` array from a bfloat16 ``npy`` file needs ``dtype`` bfloat16)."""
    return tuple(_to_tensor(a, device, dtype) for a in fields)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(
            _ml_bfloat16())
    return t.numpy()


def fields_to_numpy(fields: Fields) -> Tuple[np.ndarray, ...]:
    """Tensors (any device) or sharded fields -> host numpy arrays (the
    global grid), dtype preserved."""
    if fields and isinstance(fields[0], ShardedField):
        return gather_to_numpy(fields)
    return tuple(_to_numpy(f) for f in fields)


def gather_to_numpy(fields: Fields) -> Tuple[np.ndarray, ...]:
    """Sharded fields -> their global numpy arrays, assembled on the host
    one block at a time (one process only)."""
    out = []
    for f in fields:
        if f.mesh.multiprocess:
            raise ValueError(f"gather_to_numpy: {GLOBAL_GRID_REASON}")
        g = None
        for c, b in zip(f.mesh.coords(), f):
            a = _to_numpy(b)
            if g is None:
                g = np.empty(f.global_shape, dtype=a.dtype)
            g[tuple(slice(o, o + n) for o, n in zip(f.offsets(c),
                                                    b.shape))] = a
        out.append(g)
    return tuple(out)


def shard_from_numpy(fields: Sequence, mesh, dtype=None,
                     ensemble: bool = False) -> Fields:
    """Global numpy arrays -> sharded fields over ``mesh``: the blocks of
    this process's shards cut on the host and copied to their devices
    (``dtype`` as for :func:`fields_from_numpy`).  ``ensemble=True``:
    batched arrays, the leading member axis cut over the mesh's ensemble
    groups."""
    lead = int(bool(ensemble))
    out = []
    for a in fields:
        a = np.asarray(a)
        counts = mesh.counts(a.ndim - lead)
        if any(g % c for g, c in zip(a.shape[lead:], counts)):
            raise ValueError(f"grid {a.shape} not divisible by mesh "
                             f"{mesh.shape}")
        members = (ensemble_members_local(mesh, a.shape[0]),) * lead
        local = members + tuple(g // c for g, c in zip(a.shape[lead:],
                                                       counts))
        f = ShardedField([], mesh, a.shape, lead)
        for c in mesh.local_coords():
            sl = tuple(slice(o, o + n)
                       for o, n in zip(f.offsets(c, local), local))
            f.append(_to_tensor(a[sl], mesh.device(c), dtype))
        out.append(f)
    return tuple(out)


def coupled_from_numpy(runner, per_group_fields: Sequence[Sequence]) -> None:
    """Load every group's fields (numpy arrays of the group's grid, e.g.
    the TPU package's ``CoupledRunner.fields`` copied to the host) into the
    port's ``parallel.groups.CoupledRunner``: each cut into the blocks of
    the group's mesh, in the group's dtype."""
    if len(per_group_fields) != runner.n_groups:
        raise ValueError(f"{len(per_group_fields)} field tuples for "
                         f"{runner.n_groups} groups")
    for g, (p, arrays) in enumerate(zip(runner.plans, per_group_fields)):
        if len(arrays) != p.stencil.num_fields:
            raise ValueError(f"group {p.name} has {p.stencil.num_fields} "
                             f"field(s), got {len(arrays)}")
        for a in arrays:
            if tuple(np.shape(a)) != tuple(p.grid):
                raise ValueError(f"group {p.name}: a {np.shape(a)} field "
                                 f"for its {p.grid} grid")
        runner.fields[g] = shard_from_numpy(arrays, runner.meshes[g],
                                            dtype=p.stencil.dtype)
