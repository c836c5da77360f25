"""Admission control: price a size class before accepting a job.

The port's copy of the TPU package's ``serving/admission.py``.
``utils/budget.py`` already owns the arithmetic (peak live bytes of one
card for every execution strategy, halo/fuse/ensemble/exchange transients
included, for every shard the card holds).  Admission calls it with the
*class* config at the *target member capacity* — the resident step the job
would actually join — and converts a refusal into a structured
:class:`AdmissionError` instead of ever attempting a build that would run
the card out of memory.

The controller prices against the card's memory by default
(``budget.device_hbm_bytes``); a class on the CPU is priced as the card
the port targets (the H100 SXM's 80 GB, as ``obs/costmodel.py`` prices a
CPU run); tests and capacity planning pass an explicit ``hbm_bytes`` so
rejection is provable anywhere.  ``share`` splits that budget into equal
slices, one a controller: the replicas of a router share one card.

Unlike the TPU package, which prices each class alone, a class is priced
against what the controller's resident classes leave free: every class
admitted under a ``holder`` key holds its priced bytes (at its current
capacity) until :meth:`AdmissionController.release`, so classes that are
resident together never add up past the budget.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, Optional

import torch

from ..config import RunConfig

__all__ = ["AdmissionError", "AdmissionController"]

# the H100 SXM's memory (data sheet: 80 GB), the budget of a CPU class
CPU_PRICED_HBM_BYTES = 80 * 10**9


class AdmissionError(ValueError):
    """A job was refused before touching the card.

    ``reason`` is machine-readable (``"over_budget"`` |
    ``"unsupported"``); ``detail`` carries the budget arithmetic or the
    offending field — the structured reject the scheduler also emits as a
    ``scheduler`` event with ``op="reject"``.
    """

    def __init__(self, reason: str, message: str,
                 detail: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.reason = reason
        self.detail = detail or {}


def _shards_on_card(build_cfg: RunConfig) -> int:
    """Shards of the class's mesh on its fullest device: the mesh takes
    the first of the visible devices (virtual devices repeat one card)."""
    from ..parallel import mesh as mesh_lib

    n = max(1, build_cfg.ensemble_mesh) * math.prod(build_cfg.mesh or (1,))
    devs = mesh_lib.local_devices(torch.device(build_cfg.device).type)[:n]
    return max(collections.Counter(devs).values()) if devs else 1


class AdmissionController:
    """Budget-priced yes/no for (class config, capacity) pairs."""

    def __init__(self, hbm_bytes: Optional[int] = None, share: int = 1):
        self.hbm_bytes = hbm_bytes
        self.share = max(1, int(share))
        self._held: Dict[str, int] = {}   # holder -> priced bytes
        self._lock = threading.Lock()

    def _hbm(self, build_cfg: RunConfig) -> int:
        if self.hbm_bytes is not None:
            return int(self.hbm_bytes) // self.share
        if torch.device(build_cfg.device).type != "cuda":
            return CPU_PRICED_HBM_BYTES // self.share
        if not torch.cuda.is_available():
            raise AdmissionError(
                "unsupported", "--device cuda: no CUDA device is available "
                "(pass --device cpu to serve on the CPU)",
                detail={"field": "device", "value": build_cfg.device})
        from ..utils import budget

        return budget.device_hbm_bytes() // self.share

    def hold(self, holder: str, build_cfg: RunConfig) -> None:
        """``holder``'s class shrank to ``build_cfg``: it holds that
        estimate from now on (no check: it held more)."""
        total = self.price(build_cfg)["total_bytes"]
        with self._lock:
            self._held[holder] = int(total)

    def release(self, holder: str) -> None:
        """``holder``'s class is gone: its bytes are free again."""
        with self._lock:
            self._held.pop(holder, None)

    def price(self, build_cfg: RunConfig) -> Dict[str, Any]:
        """Estimated peak bytes of one card for the class build config.

        Returns ``{"total_bytes", "parts", "hbm_bytes"}``; pure host
        arithmetic — nothing builds, nothing allocates.
        """
        from ..cli import _make_cfg_stencil
        from ..utils import budget

        hbm = self._hbm(build_cfg)
        if build_cfg.groups:
            # a coupled job is priced per group (the worst group's card is
            # what the admission budget must cover), interface transients
            # included — the estimate_coupled_bytes the CLI's guard uses
            from ..parallel import groups as groups_lib

            plans = groups_lib.plans_from_config(
                build_cfg.groups, build_cfg.grid,
                default_dtype=build_cfg.dtype or None)
            worst, details = budget.estimate_coupled_bytes(plans)
            worst_name, _, worst_parts = max(details, key=lambda d: d[1])
            return {"total_bytes": int(worst),
                    "parts": worst_parts,
                    "coupled_groups": [
                        {"group": name, "total_bytes": int(t)}
                        for name, t, _ in details],
                    "worst_group": worst_name,
                    "hbm_bytes": int(hbm)}
        st = _make_cfg_stencil(build_cfg)
        total, parts = budget.estimate_run_bytes(
            st, build_cfg.grid, mesh=build_cfg.mesh, fuse=build_cfg.fuse,
            ensemble=build_cfg.ensemble, periodic=build_cfg.periodic,
            compute=build_cfg.compute, fuse_kind=build_cfg.fuse_kind,
            overlap=build_cfg.overlap, pipeline=build_cfg.pipeline,
            exchange=build_cfg.exchange,
            ensemble_mesh=build_cfg.ensemble_mesh,
            shards_per_device=_shards_on_card(build_cfg))
        return {"total_bytes": int(total), "parts": parts,
                "hbm_bytes": int(hbm)}

    def admit_or_raise(self, build_cfg: RunConfig,
                       holder: Optional[str] = None) -> Dict[str, Any]:
        """Admit the class build or raise :class:`AdmissionError`.

        The class fits when its estimate and the bytes the other resident
        classes hold (the result's ``held_bytes``) fit the budget
        together; admitted under ``holder``, it then holds its estimate in
        place of what it held before.  The refusal carries the full arithmetic: estimated
        bytes, the per-part breakdown, the bytes held, and the memory it
        was priced against — the "reject with the reason, never run out
        of memory" contract.
        """
        est = self.price(build_cfg)
        with self._lock:
            held = sum(b for k, b in self._held.items() if k != holder)
            est["held_bytes"] = int(held)
            if est["total_bytes"] + held > est["hbm_bytes"]:
                gib = est["total_bytes"] / 2**30
                cap = est["hbm_bytes"] / 2**30
                raise AdmissionError(
                    "over_budget",
                    f"size class at capacity {build_cfg.ensemble} needs "
                    f"~{gib:.2f} GiB/device, over the {cap:.2f} GiB budget"
                    + (f" less the {held / 2**30:.2f} GiB its resident "
                       f"classes hold" if held else ""),
                    detail=est)
            if holder is not None:
                self._held[holder] = int(est["total_bytes"])
        return est
