"""Checkpoint / resume in the TPU package's ``npy`` format.

One ``field_{i}.npy`` per field plus a ``meta.json`` (``step``,
``num_fields``, ``config``) — dtype-exact, and written through a temp
directory + atomic rename so a failure mid-write can never leave a
truncated checkpoint behind; the previous good checkpoint is moved aside,
not deleted, until the new one is in place.  A checkpoint written by either
package resumes in the other.  The sharded ``orbax`` backend is not ported,
so a multi-process run, whose processes each hold only their own shards,
saves none (:data:`SHARDED_ITEM`).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from ..interop import fields_to_numpy

_META = "meta.json"
ORBAX_ITEM = "ROADMAP A2 (sharded orbax checkpoint backend)"
SHARDED_ITEM = ("ROADMAP A2 (the sharded checkpoint backend: a multi-process "
                "run's shards)")


def save_checkpoint(path: str, fields, step: int,
                    config: Optional[Dict] = None) -> None:
    mesh = getattr(fields[0], "mesh", None) if fields else None
    if mesh is not None and mesh.multiprocess:
        raise NotImplementedError(
            "a multi-process run's checkpoint needs every process to write "
            f"its own shards: {SHARDED_ITEM}")
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
        # Never destroy the previous good checkpoint before the new one is
        # in place: move it aside, swap in the new one, then delete the old.
        old = None
        if os.path.isdir(path):
            old = tempfile.mkdtemp(prefix=".ckpt_old_", dir=parent)
            os.rmdir(old)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
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


def _has_orbax(path: str) -> bool:
    try:
        return any(n.startswith("step_") for n in os.listdir(path))
    except OSError:
        return False


def latest_step(path: str) -> Optional[int]:
    return _npy_step(path)


def checkpoint_format(path: str) -> Optional[str]:
    """'npy', 'orbax' (present but unreadable here), or None."""
    if _npy_step(path) is not None:
        return "npy"
    return "orbax" if _has_orbax(path) else None


def load_any(path: str):
    """Load the checkpoint under ``path``: ``(fields, step, config)``."""
    fmt = checkpoint_format(path)
    if fmt == "npy":
        return load_checkpoint(path)
    if fmt == "orbax":
        raise NotImplementedError(
            f"{path} holds an orbax checkpoint, which the port cannot read "
            f"yet: {ORBAX_ITEM}")
    raise FileNotFoundError(f"no checkpoint found under {path}")
