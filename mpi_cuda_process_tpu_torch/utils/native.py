"""ctypes bridge to the native host runtime (``native/stencilhost.cpp``).

The port's own copy of the TPU package's ``utils/native.py`` for what the
time loop needs: the asynchronous ``.npy`` writer behind ``--dump-every``.
``libstencilhost`` is built with ``g++`` at first use into ``native/build/``
(git-ignored); its file name carries a hash of the source, so an edited
source is rebuilt and both packages may build side by side.  Nothing is
built at import.

A field is written with the header and bytes the TPU package's dump of the
same state holds: float32, float64 and the integer types through the native
writer pool; bfloat16, which has no numpy dtype in torch, as its raw 2-byte
words under ml_dtypes' descriptor ``'<V2'``, written as ``np.save`` writes
an ml_dtypes array (the TPU package's path for a dtype the writer does not
describe), so the two files are byte-equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "stencilhost.cpp")
_BUILD_DIR = os.path.join(_REPO, "native", "build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_DESCR = {
    np.dtype(np.float32): "<f4",
    np.dtype(np.float64): "<f8",
    np.dtype(np.int32): "<i4",
    np.dtype(np.int64): "<i8",
    np.dtype(np.uint8): "|u1",
}
# what ml_dtypes' bfloat16 reports to np.save (numpy.lib.format)
BF16_DESCR = "<V2"


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD_DIR, f"libstencilhost-{h.hexdigest()[:12]}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library (built on first use), or None where it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        args = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64]
        lib.stencilhost_async_write_npy.argtypes = args
        lib.stencilhost_async_write_npy.restype = ctypes.c_int
        lib.stencilhost_wait_all.argtypes = []
        lib.stencilhost_wait_all.restype = ctypes.c_int64
        lib.stencilhost_pending.argtypes = []
        lib.stencilhost_pending.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def host_array(field) -> Tuple[np.ndarray, str]:
    """``(array, descr)`` of a tensor or array on the host: a bfloat16
    tensor as its 2-byte words (``uint16``) under :data:`BF16_DESCR`."""
    if isinstance(field, torch.Tensor):
        t = field.detach()
        if t.dtype == torch.bfloat16:
            a = t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
            return np.ascontiguousarray(a), BF16_DESCR
        field = t.cpu().numpy()
    a = np.ascontiguousarray(field)
    return a, _DESCR.get(a.dtype, a.dtype.str)


def _write_numpy(path: str, a: np.ndarray, descr: str) -> None:
    """One ``.npy`` file as ``np.save`` writes an array of ``descr``."""
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_1_0(fh, {
            "descr": descr, "fortran_order": False, "shape": a.shape})
        fh.write(a.tobytes())


def async_write_npy(path: str, field) -> None:
    """Queue a non-blocking ``.npy`` write of a tensor or array (the data is
    copied before this returns; the file appears by an atomic rename).
    Without the native library, or for a dtype it does not describe
    (bfloat16), the file is written here, synchronously."""
    a, descr = host_array(field)
    lib = load()
    if lib is None or a.dtype not in _DESCR:
        _write_numpy(path, a, descr)
        return
    shape = (ctypes.c_int64 * a.ndim)(*a.shape)
    rc = lib.stencilhost_async_write_npy(
        path.encode(), descr.encode(), a.ctypes.data_as(ctypes.c_void_p),
        shape, a.ndim, a.dtype.itemsize)
    if rc != 0:
        raise IOError(f"async npy write submit failed for {path}")


def wait_all() -> None:
    """Block until the queued writes finish; raise if any failed."""
    lib = load()
    if lib is None:
        return
    errs = lib.stencilhost_wait_all()
    if errs:
        raise IOError(f"{errs} async npy write(s) failed")
