"""Domain decomposition: mesh, halo exchange, sharded steppers."""

from .halo import (DistributedTransport, InProcessTransport, default_transport,
                   exchange_and_pad, exchange_slabs_2axis,
                   exchange_slabs_axis)
from .mesh import (ENSEMBLE_AXIS, Mesh, bootstrap_distributed, factor_mesh,
                   local_devices, make_mesh)
from .stepper import (ShardedField, ensemble_members_local, gather_fields,
                      make_sharded_fullgrid_step, make_sharded_fused_step,
                      make_sharded_step, make_sharded_temporal_step,
                      shard_fields)

__all__ = [
    "DistributedTransport",
    "ENSEMBLE_AXIS",
    "InProcessTransport",
    "Mesh",
    "ShardedField",
    "bootstrap_distributed",
    "default_transport",
    "ensemble_members_local",
    "exchange_and_pad",
    "exchange_slabs_2axis",
    "exchange_slabs_axis",
    "factor_mesh",
    "gather_fields",
    "local_devices",
    "make_mesh",
    "make_sharded_fullgrid_step",
    "make_sharded_fused_step",
    "make_sharded_step",
    "make_sharded_temporal_step",
    "shard_fields",
]
