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
(``PlacementHazard``). The JAX package's ``sharding.py`` and ``hints.py``
(one model SPMD over a mesh) are not ported yet (ROADMAP queue 1 item 13).
"""
from repro_torch.distributed.placement import (DeviceSet, PlacementPolicy,
                                               TenantPlacement,
                                               expert_collective_s,
                                               steady_state_load)

__all__ = [
    "DeviceSet", "PlacementPolicy", "TenantPlacement", "expert_collective_s",
    "steady_state_load",
]
