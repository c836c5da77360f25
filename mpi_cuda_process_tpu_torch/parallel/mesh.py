"""Device mesh for domain decomposition.

The counterpart of the TPU package's ``parallel/mesh.py``.  A :class:`Mesh`
names the shard count of each decomposed grid axis and holds a row-major
array of ``torch.device`` s, one per shard.  One process drives every shard
of a mesh (the in-process transport of ``halo.py``): on a node with N cards
the blocks live on ``cuda:0 .. cuda:N-1``; with one card, or on the CPU,
several shards share one device.

``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=N`` makes :func:`local_devices`
report its first device N times — the counterpart of the XLA flag
``--xla_force_host_platform_device_count`` the TPU package's tests use — so
``--mesh 2,2`` runs on one card.  Such a run measures what decomposition
costs (exchange copies, per-shard launches); it is not a scaling number.
"""

from __future__ import annotations

import itertools
import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

# Spatial mesh axis names, aligned with grid axes 0..ndim-1.
SPATIAL_AXES: Tuple[str, ...] = ("sx", "sy", "sz")

VIRTUAL_DEVICES_ENV = "MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES"

NCCL_ITEM = "ROADMAP A4 (multi-process NCCL transport)"
ENSEMBLE_ITEM = "ROADMAP A7 (ensembles)"


def spatial_axis_names(ndim: int) -> Tuple[str, ...]:
    return SPATIAL_AXES[:ndim]


class Mesh:
    """Per-grid-axis shard counts over a row-major list of devices.

    ``shape[d]`` shards decompose grid axis ``d``; grid axes beyond
    ``len(shape)`` are whole.  Shard ``c`` (a tuple of mesh coordinates)
    holds the block whose first cell sits at global index
    ``c[d] * local_shape[d]`` along each axis.
    """

    def __init__(self, shape: Sequence[int], devices: Sequence[torch.device]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = spatial_axis_names(len(self.shape))
        devs = list(devices)
        if len(devs) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} devices, "
                             f"got {len(devs)}")
        # row-major: shard c holds devices[index(c)]
        self.devices = tuple(_indexed(torch.device(d)) for d in devs)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def counts(self, ndim: int) -> Tuple[int, ...]:
        """Shard count of each of ``ndim`` grid axes (1 where whole)."""
        if len(self.shape) > ndim:
            raise ValueError(f"mesh {self.shape} has more axes than the "
                             f"{ndim}D grid")
        return self.shape + (1,) * (ndim - len(self.shape))

    def coords(self) -> Iterator[Tuple[int, ...]]:
        """Every shard's mesh coordinate, in row-major (block list) order."""
        return itertools.product(*(range(s) for s in self.shape))

    def index(self, c: Sequence[int]) -> int:
        """Position of shard ``c`` in the row-major block list."""
        if not self.shape:
            return 0
        return int(np.ravel_multi_index(tuple(c), self.shape))

    def device(self, c: Sequence[int]) -> torch.device:
        return self.devices[self.index(c)]

    def unique_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so a mesh device equals the device
    of the tensors placed on it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def local_devices(kind: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices a mesh may use: every visible card for ``cuda``, one
    device for ``cpu``.  With ``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=N``
    set, the first of them N times (several shards on one device)."""
    kind = torch.device(kind).type
    if kind == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    elif kind == "cpu":
        devs = (torch.device("cpu"),)
    else:
        raise ValueError(f"unknown device kind {kind!r}")
    virtual = os.environ.get(VIRTUAL_DEVICES_ENV)
    if virtual:
        devs = (devs[0],) * int(virtual)
    return devs


def make_mesh(
    mesh_shape: Sequence[int],
    devices: Optional[Sequence[torch.device]] = None,
    ensemble: int = 1,
) -> Mesh:
    """Build a Mesh whose axes 0..n-1 decompose grid axes 0..n-1.

    ``devices`` defaults to :func:`local_devices` of ``cuda``; the first
    ``prod(mesh_shape)`` of them are laid out row-major.
    """
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if int(ensemble) > 1:
        raise NotImplementedError(
            f"an ensemble mesh axis is not ported: {ENSEMBLE_ITEM}")
    n = int(np.prod(mesh_shape, dtype=np.int64))
    if devices is None:
        devices = local_devices("cuda")
    devices = list(devices)
    if n > len(devices):
        raise ValueError(
            f"mesh {mesh_shape} needs {n} devices, have {len(devices)}")
    return Mesh(mesh_shape, devices[:n])


def factor_mesh(n_devices: int, ndim: int) -> Tuple[int, ...]:
    """Factor ``n_devices`` into a balanced ndim-axis mesh shape.

    E.g. (8, 3) -> (2, 2, 2); (4, 2) -> (2, 2).  Balanced splits minimize
    the halo surface per shard.
    """
    shape = [1] * ndim
    remaining = n_devices
    f = 2
    factors = []
    while remaining > 1 and f * f <= remaining:
        while remaining % f == 0:
            factors.append(f)
            remaining //= f
        f += 1
    if remaining > 1:
        factors.append(remaining)
    for p in sorted(factors, reverse=True):
        i = shape.index(min(shape))
        shape[i] *= p
    return tuple(shape)


def bootstrap_distributed(coordinator_address: Optional[str] = None) -> bool:
    """Multi-process start-up, when a cluster is configured.

    Returns False when none is (no address given, no ``MASTER_ADDR`` with a
    ``WORLD_SIZE`` above 1): one process drives every shard.  A configured
    cluster raises: the multi-process transport is not ported.
    """
    configured = coordinator_address is not None or (
        os.environ.get("MASTER_ADDR")
        and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not configured:
        return False
    raise NotImplementedError(
        f"a multi-process run needs the NCCL halo transport: {NCCL_ITEM}")
