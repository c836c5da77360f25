"""Continuous-batching serving layer, the port of the TPU package's
``serving/``.

``engine.SimulationEngine`` makes requests asynchronous but still builds
and runs one config at a time — every submit builds its own step and the
card idles between jobs.  This package applies the continuous-batching
discipline of LLM serving to the batched ensemble step (every kernel takes
a block's members in one launch):

* :class:`~.sizeclass.SizeClass` identity (:func:`class_signature`) — the
  build identity of a job (its simulation fields minus the per-job ones:
  seed/density/init/iters), plus the member-capacity ladder.  The *member
  axis* is the padded dimension: a resident step built for capacity C
  serves any 1..C simultaneous jobs of the class with no new build.  The
  spatial grid is NEVER padded — that would change the physics and break
  the bit-exact-vs-solo contract.
* :class:`~.admission.AdmissionController` — ``utils/budget.py`` pricing
  of the class at target capacity BEFORE a job is accepted: reject with
  the arithmetic, never run the card out of memory.
* :class:`~.scheduler.ServingEngine` — the request queue + scheduler:
  jobs join free member slots of a resident batched step at chunk
  boundaries and leave when done (the step never stops); weighted-FIFO
  fairness with a starvation bound; checkpoint-based preemption;
  per-slot DIVERGED eviction; per-job telemetry streams riding the obs/
  vocabulary.  Occupancy changes migrate live members down/up the
  capacity ladder via ``parallel/reshard.repack_members`` — a defrag,
  never a checkpoint round-trip.
* :class:`~.router.ServingRouter` — the fleet front door: N supervised
  engine replicas (in-process, on one card) behind one submit surface;
  aggregate-budget admission, size-class affinity routing,
  zero-lost-jobs rebalance on replica death, one aggregate
  ``/status.json``.
"""

from .admission import AdmissionController, AdmissionError
from .router import RouterHandle, ServingRouter, serve_router_main
from .scheduler import ServeHandle, ServingEngine, serve_engine_main
from .sizeclass import (CLASS_FIELDS, PER_JOB_SIM_FIELDS, class_config,
                        class_signature)

__all__ = [
    "AdmissionController", "AdmissionError",
    "RouterHandle", "ServingRouter", "serve_router_main",
    "ServeHandle", "ServingEngine", "serve_engine_main",
    "CLASS_FIELDS", "PER_JOB_SIM_FIELDS",
    "class_config", "class_signature",
]
