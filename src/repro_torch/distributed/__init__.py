"""Distribution layer of the port: tenant→device placement for the serving
engine's modelled mesh (``placement.py``, a copy of the JAX package's).

``DeviceSet`` holds the ordered device profiles with one memoized cost
model per distinct device, ``PlacementPolicy`` binds each tenant to a home
device at its first admission (greedy least-loaded bin-packing over the
modelled steady-state load, deterministic), and ``expert_collective_s``
prices MoE expert parallelism. A tenant's home device and expert span
never change afterwards; each device runs its own scheduler and coalescer
over its own op pool, ops never coalesce across devices
(``clustering.coalesce_key`` leads with the device id), and the schedule
certifier rejects a group that mixes devices or runs off its assignment
(``PlacementHazard``).

The other half runs ONE model SPMD over a mesh: ``sharding.py`` (the
reference's sharding rules as per-dimension specs, turned into DTensor
placements on a ``DeviceMesh``) and ``hints.py`` (activation hints,
``constrain``), used by ``launch/train.py --production`` on a mesh of
any size (one process a rank) and by the dry-run.
"""
from repro_torch.distributed.placement import (DeviceSet, PlacementPolicy,
                                               TenantPlacement,
                                               expert_collective_s,
                                               steady_state_load)
from repro_torch.distributed.sharding import (batch_shardings,
                                              cache_shardings, fsdp_axes,
                                              opt_state_shardings,
                                              param_shardings)

__all__ = [
    "DeviceSet", "PlacementPolicy", "TenantPlacement", "batch_shardings",
    "cache_shardings", "expert_collective_s", "fsdp_axes",
    "opt_state_shardings", "param_shardings", "steady_state_load",
]
