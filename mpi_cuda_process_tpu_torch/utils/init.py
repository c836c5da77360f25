"""State initialization.

``zero`` (zero interior inside the guard-frame walls — the heat family's
Dirichlet init), ``pulse`` (a centred Gaussian bump; the wave model's
``u_prev = u`` is zero initial velocity), ``random`` (Bernoulli(density)
occupancy — Life's universe) and ``auto`` (pick by stencil family).

``random`` reproduces the TPU package's bits exactly: there it is
``bernoulli(PRNGKey(seed), density, shape)`` with the partitionable threefry
stream, i.e. cell ``i`` (its row-major flat index) draws
``threefry2x32(key, (i >> 32, i & 0xffffffff))``, xors the two output
words, keeps 23 mantissa bits as a float in [0, 1) and compares it with
the float32 ``density``.  :func:`threefry2x32` computes that hash with
int64 tensor arithmetic on the block's own device.  ``patch`` (Gray-Scott's
seed) draws ``uniform(PRNGKey(seed), shape)`` from the same stream (the
same 23 bits as a float in [0, 1), without the xor'd compare) and rounds
each product and sum once, as the TPU package's eager ``init_state`` does.

:func:`init_state_sharded` computes each block of a decomposed run on its
own device from global coordinates (the random kind from global flat
indices), so no device ever holds the global grid; gathered, its blocks
equal :func:`init_state` bit for bit.

An ensemble (``ensemble=N``) stacks N independent universes on a leading
member axis, member i initialized from seed + i, and with ``perturb`` eps
scaled by ``1 + eps u_i`` (:func:`perturb_member`: u_i the TPU package's
``uniform(fold_in(PRNGKey(seed), i), (), float32, -1, 1)``, the same bits).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..driver import frame_mask
from ..ops.stencil import Fields, Stencil

_M32 = 0xFFFFFFFF
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Cells hashed per pass of _random_block (bounds the int64 temporaries).
_RANDOM_CHUNK = 1 << 24


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x1, x2)`` under
    the key ``(k1, k2)``: two int64 tensors holding uint32 words."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _prng_key(seed: int):
    """The TPU package's ``PRNGKey(seed)`` words for a 32-bit seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    return 0, seed & _M32


def _hash_pair(k1: int, k2: int, x1: int, x2: int):
    """threefry2x32 of one counter pair, as two Python ints."""
    t = torch.tensor
    y1, y2 = threefry2x32(k1, k2, t([x1], dtype=torch.int64),
                          t([x2], dtype=torch.int64))
    return int(y1[0]), int(y2[0])


def member_uniform(seed: int, member: int) -> torch.Tensor:
    """u_i of :func:`perturb_member`: the TPU package's
    ``uniform(fold_in(PRNGKey(seed), member), (), float32, -1, 1)``, bit
    for bit, as a 0-d float32 tensor.  ``fold_in`` hashes the pair (0,
    member) under the key into the member's key; the draw hashes counter
    (0, 0) under it, xors the two words and keeps 23 bits as a float in
    [0, 1), then ``f * 2 - 1``, at least -1."""
    k = _hash_pair(*_prng_key(seed), 0, int(member) & _M32)
    b1, b2 = _hash_pair(*k, 0, 0)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    f = torch.tensor([bits], dtype=torch.int32).view(torch.float32) - 1.0
    two = torch.tensor(2.0, dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    return torch.maximum(-one, f[0] * two - one)


def perturb_member(fields: Fields, stencil: Stencil, member: int,
                   seed: int, perturb: float, periodic: bool = False,
                   global_shape=None, offsets=None) -> Fields:
    """Member ``member``'s init scaled for ensemble diversity, the TPU
    package's ``perturb_member``: each floating field times ``1 + perturb
    * u_i`` (:func:`member_uniform`, float32 arithmetic rounded once to
    the field's dtype), the guard frame pinned again (on the global
    coordinates of a block at ``offsets`` of ``global_shape``), integer
    fields (Life) untouched; ``perturb == 0`` is the identity."""
    if not perturb:
        return fields
    u = member_uniform(seed, member)
    scale = (1.0 + torch.tensor(float(perturb), dtype=torch.float32) * u)
    out = []
    for f, bc in zip(fields, stencil.bc_value):
        if not f.dtype.is_floating_point:
            out.append(f)
            continue
        g = (f.to(torch.float32) * scale.to(f.device)).to(f.dtype)
        if not periodic:
            g = _pin_frame(g, bc, stencil.halo, global_shape, offsets)
        out.append(g)
    return tuple(out)


def _uniform_chunks(grid_shape, seed: int, offsets, local_shape, device):
    """``uniform(PRNGKey(seed), grid_shape)`` over the block at ``offsets``
    (extent ``local_shape``), in runs of axis-0 rows: yields ``(r0, r1,
    u)``, the float32 draws of the block's rows ``r0:r1``."""
    k1, k2 = _prng_key(seed)
    ndim = len(grid_shape)
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * int(grid_shape[d + 1])
    # flat index of the block's cells past axis 0 (one row of axis 0)
    tail = torch.zeros((), dtype=torch.int64, device=device)
    for d in range(1, ndim):
        shape = [1] * (ndim - 1)
        shape[d - 1] = int(local_shape[d])
        idx = torch.arange(int(offsets[d]), int(offsets[d]) + int(
            local_shape[d]), dtype=torch.int64, device=device)
        tail = tail + (idx * strides[d]).reshape(shape)
    row_cells = max(1, math.prod(int(s) for s in local_shape[1:]))
    rows = max(1, _RANDOM_CHUNK // row_cells)
    for r0 in range(0, int(local_shape[0]), rows):
        r1 = min(r0 + rows, int(local_shape[0]))
        z = torch.arange(int(offsets[0]) + r0, int(offsets[0]) + r1,
                         dtype=torch.int64, device=device)
        flat = (z * strides[0]).reshape((-1,) + (1,) * (ndim - 1)) + tail
        b1, b2 = threefry2x32(k1, k2, flat >> 32, flat & _M32)
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        yield r0, r1, bits.to(torch.int32).view(torch.float32) - 1.0


def _random_block(grid_shape, seed: int, density: float, offsets,
                  local_shape, dtype, device) -> torch.Tensor:
    """The block at ``offsets`` (extent ``local_shape``) of the
    Bernoulli(``density``) occupancy of ``grid_shape``, as ``dtype``."""
    p = torch.tensor(float(density), dtype=torch.float32, device=device)
    out = torch.empty(tuple(int(s) for s in local_shape), dtype=dtype,
                      device=device)
    for r0, r1, u in _uniform_chunks(grid_shape, seed, offsets, local_shape,
                                     device):
        out[r0:r1] = (u < p).to(dtype)
    return out


def _patch_block(grid_shape, seed: int, offsets, local_shape,
                 dtype, device):
    """The block of Gray-Scott's seed: ``u = 1 - 0.5 patch + 0.02 noise``
    and ``v = 0.25 patch``, where ``patch`` is the centred bump above 0.5
    and ``noise`` the uniform draw."""
    bump = _gaussian_bump(grid_shape, device=device, offsets=offsets,
                          local_shape=local_shape)
    patch = (bump > 0.5).to(torch.float32)
    noise = torch.empty(tuple(int(s) for s in local_shape),
                        dtype=torch.float32, device=device)
    for r0, r1, u in _uniform_chunks(grid_shape, seed, offsets, local_shape,
                                     device):
        noise[r0:r1] = u
    u = (1.0 - 0.5 * patch + 0.02 * noise).to(dtype)
    return u, (0.25 * patch).to(dtype)


def _gaussian_bump(grid_shape, sigma: float = 0.05, device="cpu",
                   offsets=None, local_shape=None, dtype=torch.float32):
    """Centred Gaussian bump in [0, 1], normalized coordinates per axis —
    or the block of it at ``offsets`` of extent ``local_shape`` — computed
    in float32 and stored as ``dtype``.  Computed in runs of axis-0 rows,
    each cell by the same operations as the whole block at once, so its
    float32 temporaries stay a run's, not the block's (several processes
    that share a card build their blocks at once)."""
    offsets = offsets or (0,) * len(grid_shape)
    local_shape = tuple(int(s) for s in (local_shape or grid_shape))
    coords = []
    for d, (n, o, ls) in enumerate(zip(grid_shape, offsets, local_shape)):
        c = (torch.arange(o, o + ls, dtype=torch.float32, device=device)
             - (n - 1) / 2.0) / max(n, 2)
        shape = [1] * len(grid_shape)
        shape[d] = ls
        coords.append(c.reshape(shape))
    out = torch.empty(local_shape, dtype=dtype, device=device)
    rows = max(1, _RANDOM_CHUNK // max(1, math.prod(local_shape[1:])))
    for r0 in range(0, local_shape[0], rows):
        r2 = 0.0
        for d, c in enumerate(coords):
            r2 = r2 + (c[r0:r0 + rows] if d == 0 else c) ** 2
        out[r0:r0 + rows] = torch.exp(-r2 / (2 * sigma**2))
    return out


def _pin_frame(x: torch.Tensor, value, width: int, global_shape=None,
               offsets=None) -> torch.Tensor:
    """``x`` with its guard-frame cells set to ``value``, in place."""
    mask = frame_mask(x.shape, global_shape or x.shape,
                      offsets or (0,) * x.ndim, width, x.device)
    return x.masked_fill_(mask, value)


def resolve_kind(stencil: Stencil, kind: str) -> str:
    """The init kind ``auto`` stands for, by stencil family."""
    if kind != "auto":
        return kind
    if stencil.name == "life":
        return "random"
    if stencil.name.startswith("grayscott"):
        return "patch"
    if stencil.name.startswith("advect") or stencil.num_fields == 2:
        return "pulse"
    return "zero"


def init_state(
    stencil: Stencil,
    grid_shape: Sequence[int],
    seed: int = 0,
    density: float = 0.15,
    kind: str = "auto",
    periodic: bool = False,
    device="cuda",
    ensemble: int = 0,
    perturb: float = 0.0,
) -> Fields:
    """Build the initial fields for ``stencil`` on ``grid_shape``.

    kinds:
      - ``"random"``: Bernoulli(density) occupancy, the TPU package's bits.
      - ``"zero"``: zero interior with guard-frame walls.
      - ``"pulse"``: centred Gaussian bump.
      - ``"auto"``: pick by stencil family.
      - ``"patch"``: Gray-Scott's seed, the TPU package's bits.

    ``seed`` feeds the random and patch kinds, ``density`` the random one.
    ``ensemble`` N > 0 stacks N members on a leading axis, member i from
    seed + i, each scaled by :func:`perturb_member` with ``perturb``.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    zeros = (0,) * len(grid_shape)
    if ensemble:
        return _members_block(stencil, grid_shape, kind, periodic, device,
                              zeros, grid_shape, seed, density,
                              range(int(ensemble)), perturb)
    return _init_block(stencil, grid_shape, kind, periodic, device, zeros,
                       grid_shape, seed, density)


def _members_block(stencil, grid_shape, kind, periodic, device, offsets,
                   local_shape, seed, density, members, perturb) -> Fields:
    """The block at ``offsets`` of every member in ``members``, stacked on
    a leading axis: member i's block from seed + i, perturbed."""
    if len(grid_shape) != stencil.ndim:
        raise ValueError(
            f"{stencil.name} is {stencil.ndim}D, got grid {grid_shape}")
    out = None
    for j, i in enumerate(members):
        block = perturb_member(
            _init_block(stencil, grid_shape, kind, periodic, device, offsets,
                        local_shape, seed + i, density),
            stencil, i, seed, perturb, periodic, grid_shape, offsets)
        if out is None:
            out = tuple(torch.empty((len(members),) + tuple(b.shape),
                                    dtype=b.dtype, device=b.device)
                        for b in block)
        for o, b in zip(out, block):
            o[j].copy_(b)
    return out


def _init_block(stencil, grid_shape, kind, periodic, device, offsets,
                local_shape, seed=0, density=0.15) -> Fields:
    """The block of the initial fields at ``offsets`` (``local_shape``)."""
    if len(grid_shape) != stencil.ndim:
        raise ValueError(
            f"{stencil.name} is {stencil.ndim}D, got grid {grid_shape}"
        )
    kind = resolve_kind(stencil, kind)
    dtype = stencil.dtype
    if kind == "random":
        x = _random_block(grid_shape, seed, density, offsets,
                              local_shape, dtype, device)
        fields = (x,) + tuple(
            torch.zeros(local_shape, dtype=dtype, device=device)
            for _ in range(stencil.num_fields - 1))
    elif kind == "zero":
        fields = tuple(
            torch.zeros(local_shape, dtype=dtype, device=device)
            for _ in range(stencil.num_fields)
        )
    elif kind == "patch":
        # reaction-diffusion seed: u ~ 1 with a perturbed central patch, v
        # nonzero only inside it
        if stencil.num_fields < 2:
            raise ValueError(
                f"init kind 'patch' seeds an activator/inhibitor pair; "
                f"{stencil.name} has {stencil.num_fields} field(s)")
        fields = _patch_block(grid_shape, seed, offsets, local_shape, dtype,
                              device) + tuple(
            torch.zeros(local_shape, dtype=dtype, device=device)
            for _ in range(stencil.num_fields - 2))
    elif kind == "pulse":
        u = _gaussian_bump(grid_shape, device=device, offsets=offsets,
                           local_shape=local_shape, dtype=dtype)
        # zero initial velocity: u_prev = u
        fields = (u,) + tuple(u for _ in range(stencil.num_fields - 1))
    else:
        raise ValueError(f"unknown init kind {kind!r}")

    if periodic:
        # No guard frame exists in periodic mode — every cell is ordinary.
        return fields
    # pinned in place; a field that shares its tensor with an earlier one
    # (the pulse's u_prev = u) gets its own copy first
    pinned = []
    for f, v in zip(fields, stencil.bc_value):
        if any(f is p for p in pinned):
            f = f.clone()
        pinned.append(_pin_frame(f, v, stencil.halo, grid_shape, offsets))
    return tuple(pinned)


def init_state_sharded(
    stencil: Stencil,
    grid_shape: Sequence[int],
    mesh,
    seed: int = 0,
    density: float = 0.15,
    kind: str = "auto",
    periodic: bool = False,
    ensemble: int = 0,
    perturb: float = 0.0,
    window=None,
) -> Fields:
    """The initial fields decomposed over ``mesh`` (``ShardedField`` s):
    only the blocks of the shards this process holds, each computed on its
    own device from global coordinates, so a block is the same whichever
    process builds it and no process holds the global grid.

    ``ensemble`` N > 0: batched fields, each block ``(N_local, *local)``
    holding its ensemble group's members (all N without an ensemble mesh
    axis), each member's block from seed + i and perturbed as in
    :func:`init_state`.

    ``window=(origin, shape)``: the fields of the sub-grid ``shape`` whose
    first cell sits at ``origin`` of ``grid_shape`` (a device group's rows,
    ``parallel/groups.py``), decomposed over ``mesh``: each block is the
    init of ``grid_shape`` at its global offsets, frame included, so the
    sub-grid equals the slice of the whole grid's init without any device
    holding the whole grid."""
    from ..parallel.stepper import (ShardedField, ensemble_members_local,
                                    shard_offsets)

    grid_shape = tuple(int(g) for g in grid_shape)
    origin, shape = window or ((0,) * len(grid_shape), grid_shape)
    shape = tuple(int(g) for g in shape)
    if any(o < 0 or o + n > g for o, n, g in zip(origin, shape, grid_shape)):
        raise ValueError(f"window {shape} at {tuple(origin)} leaves the "
                         f"grid {grid_shape}")
    counts = mesh.counts(len(shape))
    if any(g % c for g, c in zip(shape, counts)):
        raise ValueError(f"grid {shape} not divisible by mesh "
                         f"{mesh.shape}")
    n_local = ensemble_members_local(mesh, ensemble)
    local = tuple(g // c for g, c in zip(shape, counts))
    per_field = [[] for _ in range(stencil.num_fields)]
    for c in mesh.local_coords():
        offsets = tuple(o + s for o, s in zip(
            origin, shard_offsets(mesh.spatial(c), local)))
        if n_local:
            first = mesh.group(c) * n_local
            block = _members_block(
                stencil, grid_shape, kind, periodic, mesh.device(c), offsets,
                local, seed, density, range(first, first + n_local), perturb)
        else:
            block = _init_block(stencil, grid_shape, kind, periodic,
                                mesh.device(c), offsets, local, seed,
                                density)
        for f, b in zip(per_field, block):
            f.append(b)
    shape = (int(ensemble),) * bool(n_local) + shape
    return tuple(ShardedField(b, mesh, shape, lead=int(bool(n_local)))
                 for b in per_field)
