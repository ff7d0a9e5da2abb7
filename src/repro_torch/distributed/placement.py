"""Tenant→device placement for multi-device mesh serving.

The port's copy of the JAX package's ``distributed/placement.py``. The
mesh is modelled: N virtual device timelines whose kernels all run on the
one card the engine serves on, so nothing here needs a second GPU. The
default device profile is the port's spec-sheet ``H100``.

The serving stack models N devices as N independent virtual timelines —
one ``OoOScheduler``/``Coalescer``/``JitSession`` per device, all sharing
one ``VLIWJit`` (plan, block-plan and packed-weight caches are keyed with
the device id). This module decides WHERE each tenant lives:

  * **binding time** — placement binds ONCE, at the tenant's first
    admission (its weights and KV caches are modeled as resident on the
    home device from then on). Per-tick decisions — DISPATCH/WAIT, EDF
    anchoring, coalesced-group formation — happen independently per
    device afterwards; nothing migrates mid-flight, and the schedule
    certifier's ``PlacementHazard`` + per-device conservation checks
    verify the binding held.
  * **policy** — greedy least-loaded bin-packing over the modeled
    steady-state decode load (``core.kernelspec.gemm_population`` ×
    ``CostModel.gemm_time``): each new tenant goes to the device with the
    smallest accumulated load, lowest index on ties. Admission order is
    deterministic (the engine walks the request trace), so the placement
    is reproducible — asserted in tests/test_torch_mesh.py. The greedy
    longest-processing-time argument bounds the resulting skew:
    ``max_load <= total/N + max_tenant_load`` (``load_bound``).
  * **expert span** — an expert-parallel MoE tenant may SPAN devices:
    when the mesh size divides its expert count (the same divisibility
    rule as the JAX package's ``distributed/sharding.py`` expert-
    parallelism fallback), its expert weights are modeled as sharded
    across all N devices. Its
    ops still execute on the home device's timeline (the combine brings
    activations home), but every expert GEMM is charged an all-to-all
    dispatch+combine collective (``CostModel.all_to_all_time``) in its
    EDF slack and plan estimate — the capacity/latency trade of expert
    parallelism, visible to the scheduler instead of free.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import H100, CostModel, Device
from repro_torch.core.kernelspec import gemm_population


@dataclasses.dataclass(frozen=True)
class TenantPlacement:
    """One tenant's binding: home device + expert-parallel span."""

    device: int        # home device — every op of the tenant runs here
    expert_span: int   # devices its MoE expert weights span (1 = local)


class DeviceSet:
    """The modeled mesh: an ordered list of ``Device`` profiles with one
    memoized ``CostModel`` per distinct device OBJECT.

    ``homogeneous(device, n)`` repeats the SAME ``Device`` instance, so
    all n mesh slots share one ``CostModel`` — deliberate: downstream
    caches key on cost-model identity (``ProgramTemplate``'s GEMM-suffix
    memo), and a homogeneous mesh must not thrash them with n distinct
    but equal models."""

    def __init__(self, devices: Sequence[Device]):
        assert devices, "a DeviceSet needs at least one device"
        self.devices: List[Device] = list(devices)
        self._cost_by_dev: Dict[int, CostModel] = {}

    @classmethod
    def homogeneous(cls, device: Device = H100, n: int = 1) -> "DeviceSet":
        return cls([device] * n)

    def __len__(self) -> int:
        return len(self.devices)

    def cost(self, d: int) -> CostModel:
        """The (memoized) cost model of mesh slot ``d``. Slots holding the
        identical ``Device`` object share one ``CostModel`` instance."""
        dev = self.devices[d]
        cm = self._cost_by_dev.get(id(dev))
        if cm is None:
            cm = CostModel(dev)
            self._cost_by_dev[id(dev)] = cm
        return cm

    def bind_cost(self, d: int, cost: CostModel) -> None:
        """Pin mesh slot ``d``'s cost model to an existing instance.

        Cost-model IDENTITY keys downstream memos (the program template's
        GEMM-suffix table), so a caller that already owns a ``CostModel``
        for slot d's device must bind it here rather than let ``cost()``
        mint a second equal-but-distinct one."""
        assert cost.device is self.devices[d], \
            "bound cost model must wrap mesh slot's own Device object"
        self._cost_by_dev[id(self.devices[d])] = cost


def steady_state_load(cost: CostModel, cfg: ModelConfig,
                      batch: int) -> float:
    """Modeled seconds per decode step of one tenant on ``cost``'s device:
    the per-layer GEMM population × depth, plus the unembed. This is the
    bin-packing weight — a static proxy for the tenant's timeline demand
    (real demand varies with batching/coalescing, but placement must bind
    before any of that happens)."""
    pop = gemm_population(cfg, max(1, batch))
    t = 0.0
    for tag, shape in pop:
        per_layer = tag != "unembed"
        t += cost.gemm_time(shape) * (cfg.num_layers if per_layer else 1)
    return t


def expert_collective_s(cost: CostModel, *, m: int, k: int,
                        dtype_bytes: int, layers: int, span: int) -> float:
    """Per-expert-GEMM collective charge for a device-spanning MoE tenant:
    the dispatch half scatters [m, k] activations to the expert shards and
    the combine half gathers the outputs back — one all-to-all over the
    round-trip bytes, repeated per scanned layer."""
    if span <= 1:
        return 0.0
    return cost.all_to_all_time(2.0 * layers * m * k * dtype_bytes, span)


class PlacementPolicy:
    """Greedy least-loaded tenant→device bin-packing (deterministic).

    ``place`` is idempotent per tenant name — the first call binds, every
    later call returns the existing binding (placement is an admission-
    time act; see the module docstring)."""

    def __init__(self, devices: DeviceSet):
        self.devices = devices
        self.load: List[float] = [0.0] * len(devices)
        self.assignments: Dict[str, TenantPlacement] = {}
        self._tenant_load: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def expert_span(self, cfg: ModelConfig) -> int:
        """Mesh span of the tenant's expert weights: the full mesh when
        expert parallelism fits (mesh size divides the expert count —
        the JAX package's sharding rule), else 1 (local, FSDP-style
        fallback)."""
        n = len(self.devices)
        if n > 1 and getattr(cfg, "has_moe", False) \
                and cfg.moe.num_experts % n == 0:
            return n
        return 1

    def place(self, name: str, cfg: ModelConfig,
              batch: int = 1) -> TenantPlacement:
        """Bind ``name`` to a home device (first call) or return its
        existing binding. Ties break to the lowest device index, so the
        placement of a fixed admission order is reproducible."""
        existing = self.assignments.get(name)
        if existing is not None:
            return existing
        d = min(range(len(self.devices)),
                key=lambda i: (self.load[i], i))
        w = steady_state_load(self.devices.cost(d), cfg, batch)
        self.load[d] += w
        self._tenant_load[name] = w
        placement = TenantPlacement(device=d,
                                    expert_span=self.expert_span(cfg))
        self.assignments[name] = placement
        return placement

    # ------------------------------------------------------------------
    def skew(self) -> float:
        """max/mean device load (1.0 = perfectly balanced)."""
        mean = sum(self.load) / len(self.load)
        return max(self.load) / mean if mean > 0 else 1.0

    def load_bound(self) -> float:
        """Greedy guarantee: no device's load exceeds the ideal share plus
        one tenant — ``total/N + max_tenant_load``. Tests assert
        ``max(load) <= load_bound()``."""
        if not self._tenant_load:
            return 0.0
        return (sum(self.load) / len(self.load)
                + max(self._tenant_load.values()))
