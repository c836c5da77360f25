"""Fault tolerance: deterministic fault injection (:mod:`.faults`) and the
run supervisor (:mod:`.supervisor`).

The port's copy of the TPU package's ``resilience`` package: the supervisor
relaunches a run from its newest checkpoint on a wedge or a death, watching
the observability layer's heartbeat and events.
"""
