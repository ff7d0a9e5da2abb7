"""Superkernel planning (paper §5.3 "VLIW compilation").

A ``SuperkernelPlan`` is the VLIW instruction word: a set of mutually
independent GEMM problems (from different streams) packed for one dispatch.
The coalescer checks feasibility (VMEM footprint of the tile working set,
padding waste bound), picks the block config (from the autotuner's table if
present), and estimates the dispatch latency with the cost model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.autotuner import LiveTuner
from repro_torch.core.clustering import Cluster, exact_key
from repro_torch.core.costmodel import BlockConfig, CostModel, DEFAULT_BLOCK, GemmShape
from repro_torch.core.kernelspec import KernelOp
from repro_torch.core.plancache import PlanCache


@dataclasses.dataclass
class SuperkernelPlan:
    ops: List[KernelOp]
    block: BlockConfig
    est_time_s: float
    padding_waste: float
    shared_operand: bool = False

    @property
    def shapes(self) -> List[GemmShape]:
        return [o.shape for o in self.ops]

    @property
    def num_problems(self) -> int:
        return len(self.ops)


class Coalescer:
    """Packs ready, shape-compatible ops into superkernel plans."""

    def __init__(self, cost: CostModel, max_group: int = 64,
                 max_waste: float = 0.25,
                 tuned_blocks: Optional[Dict[Tuple, BlockConfig]] = None,
                 memo: Optional[PlanCache] = None, *, device_id: int = 0,
                 tuner: Optional[LiveTuner] = None):
        self.cost = cost
        self.max_group = max_group
        self.max_waste = max_waste
        self.tuned_blocks = tuned_blocks or {}
        # live autotuner (core/autotuner.LiveTuner): when present it
        # REPLACES both the AOT table and the static heuristic — every
        # block_for consults it (a tune-cache lookup per call, an
        # exhaustive cost-model search only on a never-seen signature)
        self.tuner = tuner
        # optional block-plan memo (core/plancache.py): the JIT re-plans the
        # same coalesced group signatures on every dispatch of a steady-state
        # decode loop, so (block config, padding waste, modeled latency) are
        # memoized per (ordered shape tuple, shared-operand) key
        self.memo = memo
        # which mesh device this coalescer plans for. The memo may be
        # SHARED across the per-device coalescers (one VLIWJit-owned
        # PlanCache), so the device id is part of every memo key: two
        # devices with different tenant mixes — or heterogeneous device
        # profiles — must never serve each other's block plans (see
        # tests/test_multi_device.py's pre-fix-failing regression).
        self.device_id = device_id

    # ------------------------------------------------------------------
    def block_for(self, shapes: Sequence[GemmShape], *,
                  shared_operand: bool = False) -> BlockConfig:
        if self.tuner is not None:
            return self.tuner.tune(shapes, shared_operand=shared_operand)
        # AOT table lookup keyed on the FULL group signature: the table is
        # per-shape (exact_key), so it only applies when every member
        # shares that one key — a tile tuned for shape s0 alone must not
        # be imposed on a mixed group whose envelope is the max over
        # members (pre-fix this keyed on shapes[0] only, silently
        # mis-tiling every other member; see tests/test_live_tuner.py's
        # regression).
        keys = {exact_key(s) for s in shapes}
        if len(keys) == 1:
            key = next(iter(keys))
            if key in self.tuned_blocks:
                return self.tuned_blocks[key]
        # default: clamp tile to the (padded) problem size, MXU-aligned
        n = max(s.n for s in shapes)
        m = max(s.m for s in shapes)
        bm = min(128, max(8, 1 << (max(m - 1, 1)).bit_length()))
        return BlockConfig(bm=bm, bn=max(8, min(128, n)),
                           bk=DEFAULT_BLOCK.bk)

    def vmem_ok(self, shapes: Sequence[GemmShape], block: BlockConfig) -> bool:
        k = max(s.k for s in shapes)
        return block.vmem_usage(k) <= self.cost.device.vmem_bytes

    # ------------------------------------------------------------------
    def plan(self, ops: Sequence[KernelOp]) -> SuperkernelPlan:
        """Plan a superkernel for an already-compatible op group."""
        ops = list(ops)[: self.max_group]
        shapes = [o.shape for o in ops]
        # same weights across streams (same model+tag) => operand sharing
        shared = len({(o.model_id, o.tag, o.seq_index) for o in ops}) == 1 \
            and len(ops) > 1
        # layer-stacked groups (clustering.coalesce_key buckets them on the
        # full stack signature, so a group is either all-stacked with one
        # signature or all-plain): charge the group slot-by-slot — each
        # operand position of the scanned body is one coalesced wave-train
        # across the member streams, run sequentially
        stacks = [o.stack for o in ops]
        stacked = all(s is not None for s in stacks) and len(
            {tuple((t_, sh.layers, sh.n, sh.k, sh.dtype_bytes)
                   for t_, sh in s) for s in stacks}) == 1

        def derive() -> Tuple[BlockConfig, float, float]:
            if stacked:
                t = 0.0
                useful = padded = 0.0
                block = None
                for slot in zip(*stacks):
                    slot_shapes = [sh for _, sh in slot]
                    c = Cluster(slot_shapes)
                    useful += c.useful_flops
                    padded += c.padded_flops
                    b = self.block_for(slot_shapes, shared_operand=shared)
                    if block is None:
                        block = b
                    t += self.cost.coalesced_time(slot_shapes, b,
                                                  shared_operand=shared)
                waste = 0.0 if padded == 0 else 1.0 - useful / padded
                return (block or self.block_for(shapes,
                                                shared_operand=shared),
                        waste, t)
            block = self.block_for(shapes, shared_operand=shared)
            return (block, Cluster(list(shapes)).padding_waste,
                    self.cost.coalesced_time(shapes, block,
                                             shared_operand=shared))

        # live tuning consults the tuner on EVERY plan (a tune-cache hit
        # per dispatch in steady state — the gated hit-rate criterion),
        # and the tuned block joins the memo key: a re-tune that changed
        # the config can never be served a stale memoized (waste, time)
        tuned = None
        if self.tuner is not None:
            rep = [sh for _, sh in next(zip(*stacks))] if stacked \
                else shapes
            tuned = self.block_for(rep, shared_operand=shared)
        if self.memo is not None:
            key = ("block", self.device_id,
                   tuple((s.m, s.n, s.k, s.dtype_bytes, s.layers)
                         for s in shapes),
                   tuple(tuple((t_, sh.m, sh.layers, sh.n, sh.k,
                                sh.dtype_bytes) for t_, sh in st)
                         for st in stacks) if stacked else None,
                   shared,
                   None if tuned is None else (tuned.bm, tuned.bn,
                                               tuned.bk))
            block, waste, t = self.memo.get_or_build(key, derive)
        else:
            block, waste, t = derive()
        # cross-device collective charge (MoE expert dispatch/combine for
        # device-spanning tenants): added OUTSIDE the memo so the memoized
        # entry stays a pure-GEMM time — the collective depends on the
        # member ops, not the shape signature
        coll = max((op.collective_s for op in ops), default=0.0)
        return SuperkernelPlan(ops=ops, block=block, est_time_s=t + coll,
                               padding_waste=waste, shared_operand=shared)

    # ------------------------------------------------------------------
    def speedup_vs_serial(self, plan: SuperkernelPlan) -> float:
        t_serial = self.cost.time_multiplexed(plan.shapes, plan.block)
        return t_serial / plan.est_time_s if plan.est_time_s > 0 else 1.0

    def marginal_gain(self, base_ops: Sequence[KernelOp],
                      extra: KernelOp) -> float:
        """Time saved by adding ``extra`` to the group vs running it alone."""
        t_alone = self.cost.gemm_time(extra.shape)
        t_base = self.plan(list(base_ops)).est_time_s if base_ops else 0.0
        t_joint = self.plan(list(base_ops) + [extra]).est_time_s
        return (t_base + t_alone) - t_joint
