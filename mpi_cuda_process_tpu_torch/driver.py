"""Time-stepping driver: pad -> update -> re-pin, and the loops around it.

Boundary semantics: the grid INCLUDES its guard frame.  Each step updates
interior cells and re-imposes the frame, so frame cells hold their initial
(Dirichlet) values for the whole run.  State stays on its device for the
whole run; the time loop is a Python loop over the step (each step returns
new tensors, and the caching allocator hands the freed buffers of two steps
ago to the next one — the double buffer, without a swap written out).
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.nn.functional as F

from .ops.cuda import _build
from .ops.stencil import Fields, Stencil
from .resilience import faults


def frame_mask(
    local_shape: Sequence[int],
    global_shape: Sequence[int],
    offsets: Sequence[int],
    width: int,
    device,
) -> torch.Tensor:
    """Boolean mask of guard-frame cells for a block of a grid, on
    ``device`` (the block's own: a sharded step builds one per shard).

    ``offsets[d]`` is the global index of the block's first cell along
    axis d (0 when unsharded).  A cell is frame iff its global coordinate
    is within ``width`` of either wall on any axis.  The mask has the
    block's spatial shape; ``torch.where`` broadcasts it over the members
    of a batched block.
    """
    ndim = len(local_shape)
    mask = None
    for d in range(ndim):
        coord = torch.arange(int(local_shape[d]), device=device,
                             dtype=torch.int64) + int(offsets[d])
        m = (coord < width) | (coord >= int(global_shape[d]) - width)
        shape = [1] * ndim
        shape[d] = int(local_shape[d])
        m = m.reshape(shape)
        mask = m if mask is None else mask | m
    return mask.expand(tuple(int(s) for s in local_shape)).contiguous()


def pad(f: torch.Tensor, width: int, periodic: bool, value=0.0,
        ndim=None):
    """Pad the trailing ``ndim`` axes (default: every axis) by ``width``:
    wrap (periodic) or a constant.  A batched field's member axis is not
    a grid axis and is never padded."""
    ndim = f.ndim if ndim is None else ndim
    if not periodic:
        return F.pad(f, (width, width) * ndim, value=value)
    for d in range(f.ndim - ndim, f.ndim):
        n = f.shape[d]
        f = torch.cat([f.narrow(d, n - width, width), f,
                       f.narrow(d, 0, width)], dim=d)
    return f


def make_step(
    stencil: Stencil,
    global_shape: Sequence[int],
    periodic: bool = False,
    compute_fn=None,
):
    """Single-device step function: pad -> update -> re-pin frame.

    Guard-frame mode (default): padding uses the stencil's guard-cell
    constants, and the frame is then restored from the old state (so any
    frame value set by init is honoured).  Periodic mode: wrap padding,
    every cell updates, no frame.

    ``compute_fn`` overrides the local update (padded fields -> interior
    fields) — the hook through which a kernel replaces the tensor ops.

    The step takes whole fields or batched ones (a leading member axis of
    N independent universes, an ensemble run): the pad, the update, the
    compute_fn kernels and the re-pin all work on the trailing ``ndim``
    axes, so one call advances every member.
    """
    ndim = stencil.ndim
    zeros = (0,) * ndim
    if stencil.phases and compute_fn is not None:
        raise ValueError(
            f"{stencil.name} is multi-phase; compute_fn override unsupported")
    if stencil.parity_sensitive and periodic and \
            any(g % 2 for g in global_shape):
        raise ValueError(
            f"{stencil.name} is parity-sensitive: periodic wrap over odd "
            f"extents {tuple(global_shape)} makes the coloring inconsistent")
    update_fns = stencil.phases or (compute_fn or stencil.update,)
    masks = {}  # device -> frame mask, built once per device

    def one_pass(fields: Fields, update) -> Fields:
        padded = []
        for f, v, fh in zip(fields, stencil.bc_value, stencil.field_halos):
            padded.append(f if fh == 0 else pad(f, fh, periodic, v, ndim))
        new = update(tuple(padded))
        out = []
        for i, nf in enumerate(new):
            j = stencil.carry_map[i]
            if j is not None:
                out.append(fields[j])  # verbatim carry: no compute, no copy
            elif periodic or not stencil.mask_fields[i]:
                out.append(nf)
            else:
                dev = fields[0].device
                if dev not in masks:
                    masks[dev] = frame_mask(
                        fields[0].shape[-ndim:], global_shape, zeros,
                        stencil.halo, device=dev)
                out.append(torch.where(masks[dev], fields[i], nf))
        return tuple(out)

    def step(fields: Fields) -> Fields:
        for upd in update_fns:
            fields = one_pass(fields, upd)
        return fields

    return step


def make_ensemble_step(step_fn):
    """The step over a leading member axis of independent universes, the
    TPU package's ``make_ensemble_step`` (a ``vmap`` there).

    The identity: the port batches explicitly.  The plain step
    (:func:`make_step`) and every kernel step take the member axis
    natively, each kernel in one launch for all members, and the sharded
    and streaming builders build their batched steps with ``ensemble=`` /
    ``batch=``."""
    return step_fn


class Donated:
    """Fields handed over to the time loop (``run_simulation``, a runner of
    ``make_runner``), the counterpart of the TPU package's donated scan
    carry: the loop takes them, so once the first step has made new fields
    nothing holds the initial state and the allocator frees it.  A caller
    that keeps its own reference to the fields instead keeps the initial
    state alive for the whole run: a third copy of the state beside the
    step's input and output."""

    def __init__(self, fields: Fields):
        self._fields = fields

    def take(self) -> Fields:
        fields, self._fields = self._fields, None
        if fields is None:
            raise RuntimeError("donated fields were already taken")
        return fields


def _carry(fields: Fields):
    """(dtype, shape) of every field: the global shape of a sharded one."""
    return [(f.dtype, tuple(getattr(f, "global_shape", None) or f.shape))
            for f in fields]


def pipeline_hooks(step_fn):
    """``(seed, advance, drop)`` of a step, normalizing the slab-carry
    pipelined steppers (``stepper.make_sharded_fused_step(pipeline=
    True)``), as the TPU package's ``pipeline_hooks`` does.

    A pipelined step exposes ``_pipeline_prologue(fields) -> carry`` and
    ``_pipeline_body(fields, carry, post_next) -> (fields, carry)``: the
    exchanged slabs ride the loop so each pass's exchange is posted one
    pass ahead of its consumer.  ``advance(fields, extra, last)`` runs one
    pass; a loop that knows its last pass says so, and that pass posts no
    exchange.  ``drop(carry)`` awaits a posted exchange that no pass will
    consume and discards it, on every process (a transfer left posted
    would leave a peer blocked at its next collective).  For a plain step
    the carry is an empty tuple, so every loop below threads the same
    ``(fields, extra)`` pair whatever the step."""
    if getattr(step_fn, "_pipeline_active", False):
        body = step_fn._pipeline_body

        def advance(fields, carry, last=False):
            return body(fields, carry, post_next=not last)

        def drop(carry):
            if carry is not None:
                carry.wait()

        return step_fn._pipeline_prologue, advance, drop

    def seed(fields):
        return ()

    def advance(fields, extra, last=False):
        return step_fn(fields), ()

    def drop(extra):
        return None

    return seed, advance, drop


def _check_carry(old: Fields, new: Fields) -> None:
    if _carry(new) != _carry(old):
        raise TypeError(
            "step function carry input and carry output must have "
            f"equal types: the step took {_carry(old)} and "
            f"returned {_carry(new)}")


def make_runner(step_fn, n_steps: int):
    """``fields -> fields`` after ``n_steps`` applications of ``step_fn``.

    A step whose output fields differ from its input in number, dtype or
    shape raises, as ``lax.scan`` refuses such a body in the TPU package (a
    heat step promotes int32 fields to float32); the first step of each run
    is checked.  Given :class:`Donated` fields, the runner takes them.

    A slab-carry pipelined step (:func:`pipeline_hooks`) is seeded once a
    call (one prologue exchange) and threaded through the loop; its last
    pass posts no exchange, so n passes exchange n times.  Building a runner is the ``compile``
    fault site (``resilience/faults.py``) and counts as a compile
    (``_build.compiles["runner"]``)."""
    faults.maybe_fire("compile")
    _build.note_compile("runner")
    seed, advance, drop = pipeline_hooks(step_fn)

    def run(fields: Fields) -> Fields:
        if isinstance(fields, Donated):
            fields = fields.take()
        if n_steps <= 0:
            return fields
        extra = seed(fields)
        for i in range(n_steps):
            new, extra = advance(fields, extra, i == n_steps - 1)
            if i == 0:
                _check_carry(fields, new)
            fields = new
        drop(extra)
        return fields

    return run


def _blocks(f):
    """The tensors of a field: its blocks when sharded, else itself."""
    return f if isinstance(f, list) else (f,)


def make_checked_runner(step_fn, n_steps: int, start_step: int = 0):
    """Debug-mode runner (``--debug-checks``): every step checked.

    ``--check-finite`` polls the state at chunk boundaries; this runner
    checks every inexact field after every step and reports the exact step
    where the state first went non-finite, as the TPU package's
    ``make_checked_runner`` (its carry form): the first failing ``(step,
    field)`` is kept in two device scalars updated through ``torch.where``,
    so no step waits for the host, and the runner reads them once a call.
    A sharded field is checked block by block; on a mesh that spans
    processes the first failing step is the minimum over the processes
    (through the run's transport), so every process raises the same
    message.

    Call the runner as ``runner(fields, abs_start_step)``; the step index
    in the message is absolute (``abs_start_step`` + the step's index in
    the call), so it names the true step across chunks and resumes.  Raises
    ``RuntimeError("field i non-finite after step s (NaN/Inf blow-up —
    check stability parameters)")``, else returns the final fields.
    :class:`Donated` fields are taken, as :func:`make_runner` takes them;
    fields the caller still holds stay alive through the caller's
    reference.  A slab-carry pipelined step goes through
    :func:`pipeline_hooks`."""
    seed, advance, drop = pipeline_hooks(step_fn)

    def runner(fields: Fields, start=None) -> Fields:
        if start is None:
            start = start_step
        if isinstance(fields, Donated):
            fields = fields.take()
        if n_steps <= 0:
            return fields
        dev = _blocks(fields[0])[0].device
        bad_step = torch.full((), -1, dtype=torch.int64, device=dev)
        bad_field = torch.full((), -1, dtype=torch.int64, device=dev)
        extra = seed(fields)
        for i in range(n_steps):
            new, extra = advance(fields, extra, i == n_steps - 1)
            if i == 0:
                _check_carry(fields, new)
            for j, f in enumerate(new):
                if not f.dtype.is_floating_point:
                    continue  # int grids cannot hold NaN/Inf
                ok = None
                for b in _blocks(f):
                    fin = torch.isfinite(b).all().to(dev)
                    ok = fin if ok is None else ok & fin
                newly = (bad_step < 0) & ~ok
                bad_field = torch.where(newly, j, bad_field)
                bad_step = torch.where(newly, start + i, bad_step)
            fields = new
        drop(extra)
        step, field = _first_failure(int(bad_step), int(bad_field), fields)
        if step >= 0:
            raise RuntimeError(
                f"field {field} non-finite after step {step} (NaN/Inf "
                "blow-up — check stability parameters)")
        return fields

    return runner


def _first_failure(step: int, field: int, fields: Fields):
    """``(step, field)`` of the first failure over every process of a mesh
    that spans processes (the earliest step, then the lowest field), or
    ``(-1, -1)``; this process's own for one process."""
    mesh = _multiprocess_mesh(fields)
    if mesh is None:
        return step, field
    n = len(fields)
    key = step * n + field if step >= 0 else float("inf")
    worst = -mesh.max_all(-key)
    if worst == float("inf"):
        return -1, -1
    return divmod(int(worst), n)


def all_finite(f) -> bool:
    """Whether every cell of a field is finite: every block of a sharded
    one, and on a mesh that spans processes every process's blocks (so
    every process gets the same answer)."""
    ok = all(bool(torch.isfinite(b).all()) for b in _blocks(f))
    mesh = _multiprocess_mesh((f,))
    return ok if mesh is None else mesh.max_all(0.0 if ok else 1.0) == 0.0


def _multiprocess_mesh(fields: Fields):
    """The mesh of sharded fields that span processes, else None."""
    mesh = getattr(fields[0], "mesh", None) if fields else None
    return mesh if mesh is not None and mesh.multiprocess else None


def synchronize(fields: Fields) -> Fields:
    """Wait for the device work producing ``fields`` (no-op on the CPU);
    for sharded fields, on every device that holds a block, and on a mesh
    that spans processes for every process too (a barrier), so a clock
    started or stopped here starts or stops together on every process."""
    devices = []
    for f in fields:
        for t in _blocks(f):
            if t.is_cuda and t.device not in devices:
                devices.append(t.device)
    for d in devices:
        torch.cuda.synchronize(d)
    mesh = _multiprocess_mesh(fields)
    if mesh is not None:
        mesh.barrier()
    return fields


def run_until(
    step_fn,
    fields: Fields,
    tol: float,
    max_steps: int,
    check_every: int = 1,
    boundary=None,
):
    """Run until the residual drops below ``tol`` (or ``max_steps``).

    The residual is ``max_f max|f_new - f_old|`` measured across a
    ``check_every``-step chunk, over every block of a sharded field (on a
    mesh that spans processes, over every process's blocks, so every
    process stops at the same step: one that stopped alone would leave its
    neighbours waiting for its slabs); the last chunk is clamped so
    ``max_steps`` is a hard cap.  A slab-carry pipelined step is seeded
    once a run and its carry threaded through every chunk, as in the TPU
    package (one prologue exchange a run, not a chunk; the exchange the
    last pass posted is awaited and dropped).  ``boundary(n)``,
    if given, is called after each chunk with the steps done so far.
    Returns ``(fields, steps_done, residual)``.
    """
    if check_every < 1:
        raise ValueError("check_every must be >= 1")
    seed, advance, drop = pipeline_hooks(step_fn)
    n = 0
    res = float("inf")
    extra = seed(fields) if max_steps > 0 else ()
    while res > tol and n < max_steps:
        chunk = min(check_every, max_steps - n)
        new = fields
        for i in range(chunk):
            stepped, extra = advance(new, extra)
            if n == 0 and i == 0:
                _check_carry(new, stepped)
            new = stepped
        fields, n, res = new, n + chunk, _residual(new, fields)
        if boundary is not None:
            boundary(n)
    drop(extra)
    return fields, n, res


def _residual(new: Fields, old: Fields) -> float:
    """``max_f max|new_f - old_f|`` in float32; a sharded field (a list of
    blocks) block by block, and across the processes of its mesh."""
    worst = []
    for a, b in zip(new, old):
        pairs = zip(a, b) if isinstance(a, list) else ((a, b),)
        for x, y in pairs:
            worst.append(torch.max(torch.abs(
                x.to(torch.float32) - y.to(torch.float32))))
    res = max(float(w) for w in worst)
    mesh = _multiprocess_mesh(new)
    return res if mesh is None else mesh.max_all(res)


def run_simulation(
    stencil: Stencil,
    fields: Fields,
    n_steps: int,
    step_fn=None,
    log_every: int = 0,
    callback=None,
    start_step: int = 0,
    runner_factory=None,
    observer=None,
) -> Fields:
    """Run ``n_steps``, optionally surfacing state every ``log_every`` steps.

    ``fields`` are whole tensors or, with a sharded ``step_fn``, sharded
    fields (``parallel.stepper.ShardedField``), or :class:`Donated` ones:
    then no frame of the loop keeps the state a chunk started from, and a
    runner of ``runner_factory`` is given a :class:`Donated` to take.

    With ``log_every == 0`` (or nothing to call at boundaries) the whole run
    is one chunk.  With logging, the run is chunked so
    ``callback(steps_done, fields)`` sees the state at interval boundaries.
    Chunk boundaries align to *absolute* multiples of ``log_every``
    (``start_step`` is where this run resumes from), so a resumed run keeps
    its logging/checkpointing cadence.  A callback may RETURN a replacement
    fields tuple (same structure, shapes, dtypes) and the run carries it
    forward; ``None`` keeps the state.

    ``runner_factory(step_fn, n)`` overrides how a chunk is executed; the
    returned runner is called as ``runner(fields, abs_start_step)``.

    ``observer`` receives ``begin_chunk()`` / ``record_chunk(steps,
    seconds)`` around each chunk, the wall time measured up to a device
    synchronize.  An observer alone (no callback) still gets chunked
    execution when ``log_every`` is set.
    """
    donate = isinstance(fields, Donated)
    if donate:
        fields = fields.take()
    if step_fn is None:
        step_fn = make_step(stencil, fields[0].shape)

    def handed(fs):
        """What a chunk's runner is given for ``fs``."""
        return Donated(fs) if donate else fs

    if runner_factory is None:
        def runner_factory(fn, n):
            r = make_runner(fn, n)
            return lambda fs, start=0: r(fs)

    def _run_chunk(runner, fs, n, abs_step):
        if observer is None:
            return runner(fs, abs_step)
        observer.begin_chunk()
        t0 = time.perf_counter()
        out = synchronize(runner(fs, abs_step))
        observer.record_chunk(n, time.perf_counter() - t0)
        return out

    if not log_every or (callback is None and observer is None):
        arg, fields = handed(fields), None
        return _run_chunk(runner_factory(step_fn, n_steps), arg, n_steps,
                          start_step)

    done = 0
    runners = {}
    while done < n_steps:
        abs_step = start_step + done
        boundary = (abs_step // log_every + 1) * log_every
        chunk = min(boundary - abs_step, n_steps - done)
        if chunk not in runners:
            runners[chunk] = runner_factory(step_fn, chunk)
        arg, fields = handed(fields), None
        fields = _run_chunk(runners[chunk], arg, chunk, abs_step)
        done += chunk
        if callback is not None:
            replacement = callback(done, fields)
            if replacement is not None:
                fields = replacement
    return fields
