"""Checkpoint / resume: the TPU package's ``npy`` format and a sharded
backend through ``torch.distributed.checkpoint``.

Two backends, under the TPU package's names (``--checkpoint-backend npy``
and ``orbax`` mean the same on both sides):

* ``npy`` (:func:`save_checkpoint`): one ``field_{i}.npy`` per field plus a
  ``meta.json`` (``step``, ``num_fields``, ``config``) — dtype-exact, and
  written through a temp directory + atomic rename so a failure mid-write
  can never leave a truncated checkpoint behind; the previous good
  checkpoint is moved aside, not deleted, until the new one is in place.
  It holds the global grid, so a multi-process run, whose processes each
  hold only their own shards, cannot save one (it raises, pointing to the
  sharded backend); it can resume from one (each process reads its own
  slices through ``np.load(mmap_mode="r")``).  A checkpoint written by
  either package resumes in the other.
* sharded (:func:`orbax_save_checkpoint`; the TPU package's backend is
  orbax, the port's writes ``torch.distributed.checkpoint``'s format):
  one ``step_{012d}`` directory per checkpoint, in which every process
  writes only its own blocks, each with its global offsets (a chunk of its
  field's global tensor), and process 0 a ``meta.json``.  No process
  gathers.  A load reads, for each block of the target (this run's mesh,
  process count or an unsharded tensor), the saved blocks that overlap it
  and copies the overlaps in, so a checkpoint resumes across a change of
  mesh, of process count or both, bit for bit.  The directory is written
  as ``.tmp_step_{012d}`` and renamed by process 0 once every process has
  written; the previous step directory is deleted only after the new one
  has landed and every process has passed a barrier, by process 0, as is a
  stale co-located ``npy`` checkpoint once the sharded stream is ahead.

:func:`checkpoint_format` tells ``npy``, the port's sharded directories
(``dcp``: a ``step_*`` directory holding ``torch.distributed.checkpoint``'s
``.metadata``) and the TPU package's orbax directories (``orbax``: a
``step_*`` directory without it, which reading would need tensorstore:
:data:`ORBAX_ITEM`) apart; when several are present the newest step wins.

Both writers are the ``checkpoint`` fault site (``resilience/faults.py``):
``before_write`` at entry, ``during_write`` once the payload is written
and before the rename.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import _is_bfloat16, fields_to_numpy
from ..parallel.stepper import ShardedField
from ..resilience import faults

_META = "meta.json"
_DCP_META = ".metadata"  # what torch.distributed.checkpoint writes last
ORBAX_ITEM = ("ROADMAP A2 (reading the TPU package's orbax checkpoints: "
              "tensorstore)")
NPY_ACROSS_PROCESSES = (
    "the npy backend writes the global grid, and no process of a "
    "multi-process run holds it: use --checkpoint-backend orbax (each "
    "process writes its own shards)")

def _mesh_of(fields):
    return getattr(fields[0], "mesh", None) if fields else None


def _multiprocess(fields) -> bool:
    mesh = _mesh_of(fields)
    return mesh is not None and mesh.multiprocess


# ---------------------------------------------------------------------------
# npy backend
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, fields, step: int,
                    config: Optional[Dict] = None) -> None:
    faults.maybe_fire("checkpoint", step=step, phase="before_write")
    if _multiprocess(fields):
        raise ValueError(f"save_checkpoint: {NPY_ACROSS_PROCESSES}")
    arrays = fields_to_numpy(fields)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    try:
        for i, a in enumerate(arrays):
            np.save(os.path.join(tmp, f"field_{i}.npy"), a)
        meta = {"step": int(step), "num_fields": len(arrays),
                "config": config or {}}
        with open(os.path.join(tmp, _META), "w") as fh:
            json.dump(meta, fh, indent=2)
        # payload written, atomic rename not yet performed: the window the
        # rename guarantee protects
        faults.maybe_fire("checkpoint", step=step, phase="during_write")
        # Never destroy the previous good checkpoint before the new one is
        # in place: move it aside, swap in the new one, then delete the old.
        old = None
        if os.path.isdir(path):
            old = tempfile.mkdtemp(prefix=".ckpt_old_", dir=parent)
            os.rmdir(old)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            # step directories NEWER than this save survive it (a rerun
            # with the npy backend into a directory a sharded run wrote):
            # the newest-step-wins rule depends on them; older ones go
            for s in _step_dirs(old):
                if s > step:
                    os.replace(os.path.join(old, _step_name(s)),
                               os.path.join(path, _step_name(s)))
            shutil.rmtree(old, ignore_errors=True)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def load_checkpoint(path: str) -> Tuple[Tuple[np.ndarray, ...], int, Dict]:
    with open(os.path.join(path, _META)) as fh:
        meta = json.load(fh)
    fields = tuple(
        np.load(os.path.join(path, f"field_{i}.npy"))
        for i in range(meta["num_fields"])
    )
    return fields, meta["step"], meta.get("config", {})


def _npy_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, _META)) as fh:
            return int(json.load(fh)["step"])
    except (OSError, ValueError, KeyError):
        return None


def _load_npy_into(path: str, targets):
    """The ``npy`` checkpoint under ``path`` copied into ``targets``, each
    block reading its own slices of a memory-mapped field."""
    with open(os.path.join(path, _META)) as fh:
        meta = json.load(fh)
    if meta["num_fields"] != len(targets):
        raise ValueError(f"checkpoint in {path} holds {meta['num_fields']} "
                         f"field(s), not {len(targets)}")
    out = []
    for i, tgt in enumerate(targets):
        a = np.load(os.path.join(path, f"field_{i}.npy"), mmap_mode="r")
        _check_target(path, tgt, a.shape, _npy_dtype(a, tgt))
        blocks = []
        for off, b in _blocks(tgt):
            sl = tuple(slice(o, o + n) for o, n in zip(off, b.shape))
            part = np.array(a[sl], order="C")
            if _is_bfloat16(part, torch.bfloat16):
                t = torch.from_numpy(part.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(part)
            blocks.append(b.copy_(t))
        out.append(_rebuilt(tgt, blocks))
    return tuple(out), int(meta["step"]), meta.get("config", {})


def _npy_dtype(a: np.ndarray, tgt) -> torch.dtype:
    """The torch dtype an ``npy`` field holds: a 2-byte record field is
    bfloat16 (``np.save`` writes one as ``|V2``, without its type)."""
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=a.dtype)).dtype


# ---------------------------------------------------------------------------
# format detection
# ---------------------------------------------------------------------------


def _step_name(step: int) -> str:
    return f"step_{step:012d}"


def _step_dirs(path: str) -> List[int]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    out = []
    for n in names:
        if n.startswith("step_"):
            try:
                out.append(int(n[len("step_"):]))
            except ValueError:
                continue
    return sorted(out)


def _is_dcp(path: str, step: int) -> bool:
    return os.path.isfile(os.path.join(path, _step_name(step), _DCP_META))


def orbax_latest_step(path: str) -> Optional[int]:
    """The newest ``step_*`` directory under ``path`` (the port's or the
    TPU package's), or None."""
    steps = _step_dirs(path)
    return steps[-1] if steps else None


def latest_step(path: str) -> Optional[int]:
    steps = [s for s in (_npy_step(path), orbax_latest_step(path))
             if s is not None]
    return max(steps) if steps else None


def checkpoint_format(path: str) -> Optional[str]:
    """``'npy'``, ``'dcp'`` (the port's sharded directories), ``'orbax'``
    (the TPU package's, unreadable here) or None: the format of the newest
    step under ``path`` (``npy`` on a tie, as in the TPU package)."""
    n, o = _npy_step(path), orbax_latest_step(path)
    if n is None and o is None:
        return None
    if o is None or (n is not None and n >= o):
        return "npy"
    return "dcp" if _is_dcp(path, o) else "orbax"


def load_any(path: str, target_fields=None):
    """Load the checkpoint under ``path``, whichever backend wrote it:
    ``(fields, step, config)``.

    ``target_fields`` (sharded fields over this run's mesh, or whole
    tensors) says where the state goes: every format is loaded into them,
    block by block, re-sharded to this run's mesh and process count.
    Without them an ``npy`` checkpoint comes back as numpy arrays and a
    sharded one as whole CPU tensors (one process)."""
    fmt = checkpoint_format(path)
    if fmt == "npy":
        if target_fields is not None:
            return _load_npy_into(path, target_fields)
        return load_checkpoint(path)
    if fmt == "dcp":
        return orbax_load_checkpoint(path, target_fields=target_fields)
    if fmt == "orbax":
        raise NotImplementedError(
            f"{path} holds an orbax checkpoint of the TPU package, which the "
            f"port cannot read: {ORBAX_ITEM}")
    raise FileNotFoundError(f"no checkpoint found under {path}")


# ---------------------------------------------------------------------------
# sharded backend (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------


def _blocks(field) -> List[Tuple[Tuple[int, ...], torch.Tensor]]:
    """(global offsets, block) of every block of ``field`` this process
    holds: a sharded field's local shards, or a whole tensor at 0."""
    if isinstance(field, ShardedField):
        return [(field.offsets(c), b)
                for c, b in zip(field.mesh.local_coords(), field)]
    return [((0,) * field.dim(), field)]


def local_nbytes(fields) -> int:
    """Bytes of the blocks of ``fields`` this process holds: what its
    sharded save writes and its sharded load reads."""
    return sum(b.numel() * b.element_size()
               for f in fields for _, b in _blocks(f))


def _rebuilt(target, blocks):
    if isinstance(target, ShardedField):
        return target.with_blocks(blocks)
    return blocks[0]


def _global_shape(field) -> Tuple[int, ...]:
    return tuple(getattr(field, "global_shape", None) or field.shape)


def _check_target(path, target, shape, dtype) -> None:
    if tuple(shape) != _global_shape(target):
        raise ValueError(f"checkpoint in {path} holds a {tuple(shape)} grid, "
                         f"not {_global_shape(target)}")
    if dtype != target.dtype:
        raise ValueError(f"checkpoint in {path} holds {dtype} fields, and "
                         f"this run's are {target.dtype}")


def _planners():
    """Save and load planners that write and read blocks by their global
    offsets: several blocks a process, no ``ShardedTensor`` or ``DTensor``
    (which want one device a rank, and the port's mesh may put several
    shards on one device or a process)."""
    from torch.distributed.checkpoint.default_planner import (
        DefaultLoadPlanner, DefaultSavePlanner)
    from torch.distributed.checkpoint.metadata import (
        ChunkStorageMetadata, MetadataIndex, TensorProperties)
    from torch.distributed.checkpoint.planner import (
        LoadPlan, SavePlan, TensorWriteData, WriteItem, WriteItemType)
    from torch.distributed.checkpoint.planner_helpers import (
        create_read_items_for_chunk_list)

    def chunk(off, block):
        return ChunkStorageMetadata(offsets=torch.Size(off),
                                    sizes=block.size())

    class BlockSavePlanner(DefaultSavePlanner):
        def __init__(self, fields, shapes):
            super().__init__(flatten_state_dict=False,
                             flatten_sharded_tensors=False)
            self.fields = fields  # fqn -> {offsets: block}
            self.shapes = shapes  # fqn -> global shape

        def create_local_plan(self):
            items = []
            for fqn, blocks in self.fields.items():
                for off, b in blocks.items():
                    items.append(WriteItem(
                        index=MetadataIndex(fqn, torch.Size(off)),
                        type=WriteItemType.SHARD,
                        tensor_data=TensorWriteData(
                            chunk=chunk(off, b),
                            properties=TensorProperties.create_from_tensor(b),
                            size=torch.Size(self.shapes[fqn]))))
            self.plan = SavePlan(items)
            return self.plan

        def resolve_data(self, write_item):
            # a device block is copied to the host by the writer, one block
            # (and a bounded copy-ahead) at a time
            index = write_item.index
            return self.fields[index.fqn][tuple(index.offset)].detach()

    class BlockLoadPlanner(DefaultLoadPlanner):
        def __init__(self, fields):
            super().__init__(flatten_state_dict=False,
                             flatten_sharded_tensors=False)
            self.fields = fields

        def create_local_plan(self):
            items = []
            for fqn, blocks in self.fields.items():
                md = self.metadata.state_dict_metadata[fqn]
                items += create_read_items_for_chunk_list(
                    fqn, md, [chunk(off, b) for off, b in blocks.items()])
            self.plan = LoadPlan(items)
            return self.plan

        def resolve_tensor(self, read_item):
            index = read_item.dest_index
            view = self.fields[index.fqn][tuple(index.offset)]
            for d, (o, n) in enumerate(zip(read_item.dest_offsets,
                                           read_item.lengths)):
                view = view.narrow(d, int(o), int(n))
            return view

    return BlockSavePlanner, BlockLoadPlanner


def _dcp_call(fn, *args, multiprocess: bool, **kw):
    """``fn`` (``dcp.save`` / ``dcp.load``) over the default process group
    of a multi-process run, or in this process alone."""
    with warnings.catch_warnings():
        # one process: torch.distributed.checkpoint says it assumes so
        warnings.filterwarnings("ignore", message=".*single process.*")
        return fn(*args, no_dist=not multiprocess, **kw)


def _fqn(i: int) -> str:
    return f"field_{i}"


def orbax_save_checkpoint(path: str, fields, step: int,
                          config: Optional[Dict] = None) -> None:
    """Save ``fields`` (sharded or whole) as ``step_{step:012d}`` under
    ``path``: every process writes its own blocks, none gathers.

    Retention as in the TPU package: one step directory is kept, the
    previous one deleted (with a stale co-located ``npy`` checkpoint, once
    the sharded stream is ahead) only after the new one has landed and
    every process has passed a barrier, by process 0."""
    import torch.distributed.checkpoint as dcp

    faults.maybe_fire("checkpoint", step=step, phase="before_write")
    mesh = _mesh_of(fields)
    multi = mesh is not None and mesh.multiprocess
    lead = not multi or mesh.process == 0
    path = os.path.abspath(path)
    final = os.path.join(path, _step_name(step))
    tmp = os.path.join(path, "." + "tmp_" + _step_name(step))
    previous = _step_dirs(path)
    if lead:
        os.makedirs(path, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)  # a killed write's leftovers
        os.makedirs(tmp)
    _barrier(mesh)
    blocks = {_fqn(i): dict(_blocks(f)) for i, f in enumerate(fields)}
    Save, _ = _planners()
    planner = Save(blocks, {_fqn(i): _global_shape(f)
                            for i, f in enumerate(fields)})
    _dcp_call(dcp.save, {}, storage_writer=dcp.FileSystemWriter(tmp),
              planner=planner, multiprocess=multi)
    if lead:
        meta = {"step": int(step), "num_fields": len(fields),
                "config": config or {},
                "format": "torch.distributed.checkpoint",
                "shape": list(_global_shape(fields[0])),
                "dtype": str(fields[0].dtype).replace("torch.", "")}
        with open(os.path.join(tmp, _META), "w") as fh:
            json.dump(meta, fh, indent=2)
    # payload written by every process, rename not yet performed
    faults.maybe_fire("checkpoint", step=step, phase="during_write")
    _barrier(mesh)
    if lead:
        aside = None
        if os.path.isdir(final):
            aside = os.path.join(path, ".old_" + _step_name(step))
            shutil.rmtree(aside, ignore_errors=True)
            os.replace(final, aside)
        os.replace(tmp, final)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    # the new directory has landed, and every process knows it
    _barrier(mesh)
    if lead:
        for old in previous:
            if old != step:
                shutil.rmtree(os.path.join(path, _step_name(old)),
                              ignore_errors=True)
        n = _npy_step(path)
        if n is not None and n < step:
            for name in os.listdir(path):
                if name == _META or (name.startswith("field_")
                                     and name.endswith(".npy")):
                    os.remove(os.path.join(path, name))


def orbax_load_checkpoint(path: str, target_fields=None):
    """Load the newest sharded checkpoint under ``path``: ``(fields, step,
    config)``.

    ``target_fields`` (sharded fields over this run's mesh, or whole
    tensors; their values are overwritten) receive the state: each process
    reads, for each of its blocks, the parts of the saved blocks that
    overlap it.  Without targets the global fields come back as CPU
    tensors (one process)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    step = orbax_latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no sharded checkpoint under {path}")
    where = os.path.join(path, _step_name(step))
    if not _is_dcp(path, step):
        raise NotImplementedError(
            f"{where} is an orbax checkpoint of the TPU package, which the "
            f"port cannot read: {ORBAX_ITEM}")
    with open(os.path.join(where, _META)) as fh:
        meta = json.load(fh)
    reader = dcp.FileSystemReader(where)
    saved = reader.read_metadata().state_dict_metadata
    n = int(meta["num_fields"])
    if target_fields is None:
        target_fields = tuple(
            torch.empty(tuple(saved[_fqn(i)].size),
                        dtype=saved[_fqn(i)].properties.dtype)
            for i in range(n))
    if len(target_fields) != n:
        raise ValueError(f"checkpoint in {where} holds {n} field(s), not "
                         f"{len(target_fields)}")
    for i, tgt in enumerate(target_fields):
        md = saved[_fqn(i)]
        _check_target(where, tgt, md.size, md.properties.dtype)
    mesh = _mesh_of(target_fields)
    multi = mesh is not None and mesh.multiprocess
    blocks = {_fqn(i): dict(_blocks(f)) for i, f in enumerate(target_fields)}
    _, Load = _planners()
    _dcp_call(dcp.load, {}, storage_reader=reader, planner=Load(blocks),
              multiprocess=multi)
    return tuple(target_fields), int(meta["step"]), meta.get("config", {})


def _barrier(mesh) -> None:
    if mesh is not None:
        mesh.barrier()
