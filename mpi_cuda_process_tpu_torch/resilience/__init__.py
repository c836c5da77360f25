"""Fault tolerance: deterministic fault injection (:mod:`.faults`).

The port's copy of the TPU package's ``resilience`` package.  Its
``supervisor`` (relaunch a run from its newest checkpoint on a wedge or a
death) watches the observability layer's heartbeat and events, and waits
for that layer (ROADMAP A8).
"""
