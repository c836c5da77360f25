"""Device mesh for domain decomposition.

The counterpart of the TPU package's ``parallel/mesh.py``.  A :class:`Mesh`
names the shard count of each decomposed grid axis and the devices of the
shards this process holds.  A mesh is global: its shards are numbered
row-major over the whole grid, and under a multi-process run each process
holds one contiguous run of ``size / processes`` of them (the order in
which JAX lays devices out over processes), so process ``p`` holds the
shards ``p * size / processes`` up to the next process's first.  One
process alone holds every shard: on a node with N cards the blocks live on
``cuda:0 .. cuda:N-1``; with one card, or on the CPU, several shards share
one device.

A multi-process run (``torchrun``, or any launcher that sets
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``) starts with :func:`bootstrap_distributed`: it opens the
process group once, with a timeout, and picks its backend by a fixed rule
from the topology (:func:`choose_backend`).  A process's shards live on
``cuda:LOCAL_RANK % device_count`` (several processes may share one card)
or on the CPU.  Every process runs the same step over the shards it holds;
``halo.py``'s transport carries the slabs that cross a process boundary.

``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=N`` makes :func:`local_devices`
report its first device N times — the counterpart of the XLA flag
``--xla_force_host_platform_device_count`` the TPU package's tests use — so
``--mesh 2,2`` runs on one card in one process.  Such a run measures what
decomposition costs (exchange copies, per-shard launches); it is not a
scaling number.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Spatial mesh axis names, aligned with grid axes 0..ndim-1.
SPATIAL_AXES: Tuple[str, ...] = ("sx", "sy", "sz")
# The member axis of an ensemble mesh (``--ensemble-mesh M``): a leading
# mesh axis of M groups, each an independent spatial mesh.
ENSEMBLE_AXIS = "ens"

VIRTUAL_DEVICES_ENV = "MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES"
# seconds a process waits for its peers (start-up, every receive) before
# it raises instead of hanging
DIST_TIMEOUT_ENV = "MPI_CUDA_PROCESS_TORCH_DIST_TIMEOUT"
DEFAULT_DIST_TIMEOUT_S = 300.0

# The transports of a multi-process mesh, chosen once at bootstrap:
# "nccl" (each process has its own card: device tensors, no host copy),
# "gloo" (CPU tensors) and "gloo-host" (processes share a card: gloo, which
# sends no CUDA tensors point to point, through pinned host buffers).
BACKENDS = ("nccl", "gloo", "gloo-host")


def spatial_axis_names(ndim: int) -> Tuple[str, ...]:
    return SPATIAL_AXES[:ndim]


class Mesh:
    """Per-grid-axis shard counts over a row-major numbering of shards.

    ``shape[d]`` shards decompose grid axis ``d``; grid axes beyond
    ``len(shape)`` are whole.  Shard ``c`` (a tuple of mesh coordinates)
    holds the block whose first cell sits at global index
    ``c[d] * local_shape[d]`` along each axis.

    ``process`` of ``processes`` holds the shards of :meth:`local_coords`,
    on ``devices`` (one per local shard, in that order); ``backend`` names
    the transport between processes (None for one process).

    ``ensemble`` M > 1 puts an :data:`ENSEMBLE_AXIS` of M groups in front
    of the spatial axes: a shard's coordinate is then ``(e, *spatial)``
    (:meth:`group`, :meth:`spatial`), group e holds the e-th slice of the
    members, and every neighbour of a shard lies in its own group, so no
    exchange crosses groups.  ``shape`` stays the spatial shape.
    """

    def __init__(self, shape: Sequence[int], devices: Sequence[torch.device],
                 process: int = 0, processes: int = 1,
                 backend: Optional[str] = None, ensemble: int = 1):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = spatial_axis_names(len(self.shape))
        self.ensemble = max(1, int(ensemble))
        # mesh coordinates before the spatial ones: the group's
        self.group_axes = 1 if self.ensemble > 1 else 0
        self.full_shape = (self.ensemble,) * self.group_axes + self.shape
        self.process, self.processes = int(process), int(processes)
        if self.size % self.processes:
            raise ValueError(
                f"mesh {self.shape} has {self.size} shards, which do not "
                f"divide over {self.processes} processes")
        if self.processes > 1 and backend not in BACKENDS:
            raise ValueError(f"unknown multi-process backend {backend!r} "
                             f"(one of {BACKENDS})")
        self.backend = backend if self.processes > 1 else None
        self.per_process = self.size // self.processes
        devs = list(devices)
        if len(devs) != self.per_process:
            raise ValueError(
                f"mesh {self.shape} needs {self.per_process} devices in "
                f"this process, got {len(devs)}")
        # row-major: local shard j holds devices[j]
        self.devices = tuple(_indexed(torch.device(d)) for d in devs)
        self._first = self.process * self.per_process

    @property
    def size(self) -> int:
        return int(np.prod(self.full_shape, dtype=np.int64))

    def group(self, c: Sequence[int]) -> int:
        """The ensemble group of shard ``c`` (0 without an ensemble axis)."""
        return int(c[0]) if self.group_axes else 0

    def spatial(self, c: Sequence[int]) -> Tuple[int, ...]:
        """Shard ``c``'s spatial coordinate (its block's place in the
        grid)."""
        return tuple(c[self.group_axes:])

    @property
    def multiprocess(self) -> bool:
        return self.processes > 1

    def counts(self, ndim: int) -> Tuple[int, ...]:
        """Shard count of each of ``ndim`` grid axes (1 where whole)."""
        if len(self.shape) > ndim:
            raise ValueError(f"mesh {self.shape} has more axes than the "
                             f"{ndim}D grid")
        return self.shape + (1,) * (ndim - len(self.shape))

    def coords(self) -> Iterator[Tuple[int, ...]]:
        """Every shard's mesh coordinate, in row-major order."""
        return itertools.product(*(range(s) for s in self.full_shape))

    def local_coords(self) -> List[Tuple[int, ...]]:
        """The coordinates of the shards this process holds, in row-major
        (block list) order: every shard for one process."""
        return list(itertools.islice(self.coords(), self._first,
                                     self._first + self.per_process))

    def index(self, c: Sequence[int]) -> int:
        """Position of shard ``c`` in the global row-major order."""
        if not self.full_shape:
            return 0
        return int(np.ravel_multi_index(tuple(c), self.full_shape))

    def rank_of(self, c: Sequence[int]) -> int:
        """The process that holds shard ``c``."""
        return self.index(c) // self.per_process

    def is_local(self, c: Sequence[int]) -> bool:
        return self.rank_of(c) == self.process

    def local_index(self, c: Sequence[int]) -> int:
        """Position of shard ``c`` in this process's block list."""
        if not self.is_local(c):
            raise ValueError(f"shard {tuple(c)} is held by process "
                             f"{self.rank_of(c)}, not {self.process}")
        return self.index(c) - self._first

    def device(self, c: Sequence[int]) -> torch.device:
        return self.devices[self.local_index(c)]

    def unique_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))

    # -- collectives over the processes of a mesh ------------------------

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's 0-d partial result in global row-major order, on
        ``parts[0]``'s device: ``parts`` (one per local shard, all of one
        dtype) themselves for one process, else gathered from every
        process (``all_gather``; gloo through the CPU), so that each
        process combines the same values in the same order."""
        if not self.multiprocess:
            return list(parts)
        import torch.distributed as dist

        dev = parts[0].device
        mine = torch.stack([p.reshape(()) for p in parts])
        via = dev if self.backend == "nccl" else torch.device("cpu")
        # the values' bytes cross, so every dtype does, unchanged
        raw = mine.to(via).view(torch.uint8)
        got = [torch.empty_like(raw) for _ in range(self.processes)]
        dist.all_gather(got, raw)
        return list(torch.cat(got).view(mine.dtype).to(dev).unbind())

    def max_all(self, value: float) -> float:
        """The largest of every process's ``value`` (itself for one)."""
        if not self.multiprocess:
            return value
        import torch.distributed as dist

        via = self.devices[0] if self.backend == "nccl" else "cpu"
        t = torch.tensor([float(value)], dtype=torch.float64, device=via)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def barrier(self) -> None:
        """Every process reaches this point before any goes on."""
        if self.multiprocess:
            _barrier()

    def all_gather_object(self, obj) -> list:
        """Every process's ``obj`` (picklable) in rank order: ``[obj]`` for
        one process.  The peer ring exchanges its regions' handles or
        file names this way, in one global order."""
        if not self.multiprocess:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.processes
        dist.all_gather_object(out, obj)
        return out


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so a mesh device equals the device
    of the tensors placed on it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _barrier() -> None:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def dist_timeout_s() -> float:
    """Seconds any wait for a peer may last
    (``MPI_CUDA_PROCESS_TORCH_DIST_TIMEOUT``, default 300)."""
    return float(os.environ.get(DIST_TIMEOUT_ENV, DEFAULT_DIST_TIMEOUT_S))


def same_node() -> bool:
    """Whether every process of the run is on this node: the launcher's
    ``LOCAL_WORLD_SIZE`` equals ``WORLD_SIZE`` (true for one process and
    when the launcher sets neither)."""
    world = process_count()
    return world == 1 or int(os.environ.get("LOCAL_WORLD_SIZE",
                                            world)) == world


def process_count() -> int:
    """Processes of the run: the process group's size, 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def process_device(kind: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK % device_count``, or the
    CPU."""
    kind = torch.device(kind).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", _local_rank() % n)


def local_devices(kind: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices a mesh may use: every visible card for ``cuda``, one
    device for ``cpu``; under a multi-process run, this process's device
    alone.  With ``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=N`` set (one
    process), the first of them N times (several shards on one device)."""
    kind = torch.device(kind).type
    if process_count() > 1:
        return (process_device(kind),)
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

    One process: ``devices`` defaults to :func:`local_devices` of ``cuda``;
    the first ``prod(mesh_shape)`` of them are laid out row-major.  Under a
    multi-process run (an open process group) the mesh spans every
    process: this process's shards all live on ``devices[0]`` (default: its
    own device), and a shard count the processes do not divide raises
    before anything is allocated.

    ``ensemble`` M > 1 adds the leading :data:`ENSEMBLE_AXIS` of M member
    groups, as the TPU package's ``make_mesh(..., ensemble=M)``: the mesh
    needs ``M * prod(mesh_shape)`` shards, which divide over the processes
    as the spatial ones do (``--ensemble-mesh 2`` with no ``--mesh`` is a
    pure data-parallel run: two groups of one shard, no exchange).
    """
    mesh_shape = tuple(int(s) for s in mesh_shape)
    ens = max(1, int(ensemble))
    n = ens * int(np.prod(mesh_shape, dtype=np.int64))
    what = f"mesh {mesh_shape}" + (f" x ensemble {ens}" if ens > 1 else "")
    procs = process_count()
    if procs > 1:
        if n % procs:
            raise ValueError(
                f"{what} has {n} shards, which do not divide "
                f"over {procs} processes: give every process the same "
                "number of shards")
        dev = _indexed(torch.device(devices[0] if devices
                                    else process_device("cuda")))
        return Mesh(mesh_shape, [dev] * (n // procs), process_index(),
                    procs, backend_of(dev), ensemble=ens)
    if devices is None:
        devices = local_devices("cuda")
    devices = list(devices)
    if n > len(devices):
        raise ValueError(
            f"{what} needs {n} devices, have {len(devices)}"
            + (" (the ensemble axis multiplies the spatial shards)"
               if ens > 1 else ""))
    return Mesh(mesh_shape, devices[:n], ensemble=ens)


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


def choose_backend(kind: str, local_processes: int, cards: int) -> str:
    """The transport of a multi-process run, from its topology: ``gloo``
    on the CPU, ``nccl`` when every process of a node has a card of its
    own, ``gloo-host`` when processes share a card."""
    if torch.device(kind).type == "cpu":
        return "gloo"
    return "nccl" if local_processes <= cards else "gloo-host"


def backend_of(device: torch.device) -> str:
    """The transport of this process's open group for ``device``'s
    tensors: the group's own ``nccl``, else ``gloo`` (CPU tensors) or
    ``gloo-host`` (CUDA tensors staged through the host)."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return "nccl"
    return "gloo-host" if torch.device(device).type == "cuda" else "gloo"


def ranks_on_device() -> int:
    """The processes of this node whose device is this process's card
    (``LOCAL_RANK % device_count`` alike): 1 for one process."""
    if process_count() == 1:
        return 1
    cards = max(torch.cuda.device_count(), 1)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))
    mine = _local_rank() % cards
    return sum(1 for r in range(local) if r % cards == mine)


def _env_int(name: str, default: Optional[int] = None) -> int:
    raw = os.environ.get(name)
    if raw is None:
        if default is None:
            raise ValueError(f"a multi-process run needs {name} set")
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def bootstrap_distributed(coordinator_address: Optional[str] = None,
                          device: str = "cuda") -> bool:
    """Open the process group of a multi-process run, when one is
    configured; else do nothing.

    Configured means ``coordinator_address`` (``host:port``) is given, or
    ``MASTER_ADDR`` with a ``WORLD_SIZE`` above 1 is set, as ``torchrun``
    sets them.  Returns False when none is (one process drives every
    shard), True once the group is open (at once if it already is).

    The fail-fast replacement for the reference's unchecked MPI start-up
    (kernel.cu:175-178): a missing or malformed ``RANK``, ``WORLD_SIZE``
    or ``MASTER_PORT`` raises naming the variable, and the group's timeout
    (``MPI_CUDA_PROCESS_TORCH_DIST_TIMEOUT`` seconds, default 300) bounds
    start-up and every receive, so a peer never hangs forever in a
    blocking receive (kernel.cu:215).  The backend follows
    :func:`choose_backend` for ``device``: ``nccl`` is opened eagerly on
    this process's card, and a failed NCCL start raises; nothing falls
    back to another backend.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    addr = os.environ.get("MASTER_ADDR")
    if coordinator_address is None and not (
            addr and _env_int("WORLD_SIZE", 1) > 1):
        return False
    if coordinator_address is not None:
        addr, _, port = coordinator_address.rpartition(":")
        if not addr or not port:
            raise ValueError(f"coordinator address {coordinator_address!r} "
                             "is not host:port")
        port = int(port)
    else:
        port = _env_int("MASTER_PORT")
    world = _env_int("WORLD_SIZE")
    rank = _env_int("RANK")
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is not a rank of WORLD_SIZE={world}")
    timeout_s = dist_timeout_s()
    kind = torch.device(device).type
    backend = choose_backend(
        kind, _env_int("LOCAL_WORLD_SIZE", world),
        torch.cuda.device_count() if kind == "cuda" else 0)
    extra = {}
    if kind == "cuda":
        dev = process_device("cuda")
        torch.cuda.set_device(dev)
        if backend == "nccl":
            extra["device_id"] = dev  # open the communicator now
    dist.init_process_group(
        backend="nccl" if backend == "nccl" else "gloo",
        init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **extra)
    return True


def shutdown_distributed() -> None:
    """Close the process group, once every process is done with it (a
    barrier first): a process that left with the group open could tear
    down connections its peers still use.  The peer ring's regions come
    down first, in two halves: every process unmaps its peers' regions, a
    barrier, then each frees its own (an owner must not free a region a
    peer still maps)."""
    import torch.distributed as dist

    from ..ops.cuda import remote

    if dist.is_available() and dist.is_initialized():
        remote.close_peer_regions()
        _barrier()
        remote.free_peer_regions()
        _barrier()
        dist.destroy_process_group()
