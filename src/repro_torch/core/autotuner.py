"""Co-tenancy autotuning (paper §5.3, Table 1) — offline AND live.

GPU programs have many tunable parameters; kernels are usually tuned
assuming they own the whole device ("greedy"). The paper's point: when
kernels are dispatched concurrently, a *collaboratively* tuned configuration
— smaller working set, better load balance on a shared device — achieves
higher aggregate throughput despite a modest isolated-run regression.

On TPU the tunable is the Pallas ``BlockSpec`` tile geometry (bm, bn, bk)
under the VMEM budget; the two objectives are:

  * greedy        — minimize isolated latency (full device, sole tenant);
  * collaborative — minimize the superkernel latency of G co-resident
    problems (or, for space-sim comparisons, the K-tenant makespan).

The search space is small and the objective is the analytic cost model, so
exhaustive search is exact and fast; ``tests/test_autotuner.py`` cross-
validates tuned tile choices against interpret-mode Pallas runs.

Offline vs live API
-------------------
``Autotuner`` is the OFFLINE face: given shapes ahead of time it produces
``TuneResult``s (Table 1 rows) or an AOT block table
(``tune_table``) that a ``Coalescer`` can be seeded with. It knows nothing
about dispatch order or caching — every call searches.

``LiveTuner`` is the LIVE face, sitting on the JIT dispatch hot path: the
``Coalescer`` consults it on every ``plan()`` with the actual coalesced
group (the G co-resident problems of THIS tick), and it exhaustively tunes
(bm, bn, bk) for the group's full shape signature under the chosen
objective — collaborative by default, VMEM-bounded via
``Autotuner.candidates`` — memoizing the ``LiveTuneResult`` per
(device, signature) key in a ``PlanCache`` (``VLIWJit.tune_cache``, living
beside the block-plan memo). Steady-state ticks therefore pay one cache
hit, zero search: the tune-cache hit rate is a gated serving acceptance
criterion (benchmarks/compiled_autotune_bench.py). Group churn (a tenant
joining or leaving changes the signature) re-tunes ONCE for the new
signature; the previous signature's entry is untouched, so a group that
churns back — or other groups mid-churn — keep being served their already-
tuned config. Tuning keys carry no params identity (shapes only), so a
weight hot-swap leaves every tuned config intact.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.clustering import exact_key
from repro_torch.core.costmodel import BlockConfig, CostModel, GemmShape
from repro_torch.core.plancache import PlanCache


# MXU-aligned candidate tiles (bm may drop low for decode GEMV problems)
_BM = (8, 16, 32, 64, 128, 256, 512)
_BN = (128, 256, 512)
_BK = (128, 256, 512, 1024, 2048)


@dataclasses.dataclass
class TuneResult:
    shape: GemmShape
    greedy: BlockConfig
    collaborative: BlockConfig
    greedy_isolated_s: float
    collab_isolated_s: float
    greedy_multiplexed_s: float
    collab_multiplexed_s: float
    co_tenants: int

    @property
    def multiplexed_speedup(self) -> float:
        """Collaborative vs greedy under co-tenancy (paper: 1.25×)."""
        return self.greedy_multiplexed_s / self.collab_multiplexed_s

    @property
    def isolated_regression(self) -> float:
        """Isolated slowdown paid by the collaborative kernel (paper: ~20%)."""
        return self.collab_isolated_s / self.greedy_isolated_s - 1.0


class Autotuner:
    def __init__(self, cost: CostModel):
        self.cost = cost

    def candidates(self, shape: GemmShape) -> List[BlockConfig]:
        out = []
        for bm, bn, bk in itertools.product(_BM, _BN, _BK):
            if bm > max(shape.m, 8) * 2 or bn > shape.n * 2 or bk > shape.k * 2:
                continue
            b = BlockConfig(bm, bn, bk)
            if b.vmem_usage(shape.k, shape.dtype_bytes) \
                    <= self.cost.device.vmem_bytes:
                out.append(b)
        return out or [BlockConfig()]

    # ------------------------------------------------------------------
    def tune_greedy(self, shape: GemmShape) -> BlockConfig:
        return min(self.candidates(shape),
                   key=lambda b: self.cost.gemm_time(shape, b))

    def tune_collaborative(self, shape: GemmShape, co_tenants: int
                           ) -> BlockConfig:
        """Minimize the K-tenant concurrent-dispatch makespan (the paper's
        Table 1 setting: retuned kernels dispatched concurrently via MPS)."""
        group = [shape] * co_tenants
        return min(self.candidates(shape),
                   key=lambda b: self.cost.space_multiplexed(group, b))

    def tune_for_coalescing(self, shape: GemmShape, group_size: int
                            ) -> BlockConfig:
        """Best tile for the JIT's coalesced superkernel of G problems."""
        group = [shape] * group_size
        return min(self.candidates(shape),
                   key=lambda b: self.cost.coalesced_time(group, b))

    def tune_group(self, shapes: Sequence[GemmShape],
                   objective: str = "collaborative", *,
                   shared_operand: bool = False) -> BlockConfig:
        """Tune one HETEROGENEOUS coalesced group (the live-path objective).

        Candidates come from the group's envelope shape (max extents —
        the superkernel pads every member to it), VMEM-bounded as always.

          * collaborative — minimize the one-superkernel latency of the G
            co-resident problems (``CostModel.coalesced_time``), padding
            waste and all: the group IS the co-tenancy;
          * greedy — minimize the envelope problem's ISOLATED latency, as
            if the largest member owned the device alone. This is the
            ablation the Table 1 claim is measured against: a greedy tile
            maximizes per-tile reuse but under-fills the device and
            inflates the small members' padding when the group dispatches
            as one superkernel.
        """
        assert objective in ("collaborative", "greedy"), objective
        shapes = list(shapes)
        env = GemmShape(m=max(s.m for s in shapes),
                        n=max(s.n for s in shapes),
                        k=max(s.k for s in shapes),
                        dtype_bytes=max(s.dtype_bytes for s in shapes),
                        layers=max(s.layers for s in shapes))
        cands = self.candidates(env)
        if objective == "greedy":
            return min(cands, key=lambda b: self.cost.gemm_time(env, b))
        return min(cands, key=lambda b: self.cost.coalesced_time(
            shapes, b, shared_operand=shared_operand))

    # ------------------------------------------------------------------
    def tune(self, shape: GemmShape, co_tenants: int = 2) -> TuneResult:
        g = self.tune_greedy(shape)
        c = self.tune_collaborative(shape, co_tenants)
        group = [shape] * co_tenants
        return TuneResult(
            shape=shape, greedy=g, collaborative=c,
            greedy_isolated_s=self.cost.gemm_time(shape, g),
            collab_isolated_s=self.cost.gemm_time(shape, c),
            # multiplexed = each tenant dispatches its own kernel with its
            # tuned config, space-shared (the paper's Table 1 setting)
            greedy_multiplexed_s=self.cost.space_multiplexed(group, g),
            collab_multiplexed_s=self.cost.space_multiplexed(group, c),
            co_tenants=co_tenants,
        )

    # ------------------------------------------------------------------
    def tune_table(self, shapes: Sequence[GemmShape], co_tenants: int = 4
                   ) -> Dict[Tuple, BlockConfig]:
        """AOT-tuned block table keyed like the coalescer expects."""
        table: Dict[Tuple, BlockConfig] = {}
        for s in shapes:
            table[exact_key(s)] = self.tune_for_coalescing(s, co_tenants)
        return table


# ---------------------------------------------------------------------------
# live tuning (the JIT dispatch hot path)
# ---------------------------------------------------------------------------

def group_signature(shapes: Sequence[GemmShape]) -> Tuple:
    """Params-free identity of a coalesced group: the ordered full shape
    tuple — the same signature the coalescer's block-plan memo keys on, so
    'group churn' means exactly one thing across both caches."""
    return tuple((s.m, s.n, s.k, s.dtype_bytes, s.layers) for s in shapes)


@dataclasses.dataclass
class LiveTuneResult:
    """One live tuning decision, cached per (device, group signature)."""
    signature: Tuple
    objective: str               # "collaborative" | "greedy"
    shared_operand: bool
    block: BlockConfig
    modeled_group_s: float       # objective value at ``block``
    candidates: int              # search-space size actually evaluated


class LiveTuner:
    """Exhaustive per-group (bm, bn, bk) tuning on the live dispatch path.

    See the module docstring ("Offline vs live API"). One instance serves
    one device's coalescer; a mesh shares ONE ``cache`` (the JIT-owned
    ``tune_cache``) across per-device tuners, device-disambiguated by the
    ``device_id`` baked into every key — heterogeneous device profiles
    must never serve each other's tuned tiles.
    """

    def __init__(self, cost: CostModel, cache: Optional[PlanCache] = None,
                 *, objective: str = "collaborative", device_id: int = 0):
        assert objective in ("collaborative", "greedy"), objective
        self.autotuner = Autotuner(cost)
        self.cost = cost
        self.objective = objective
        self.cache = cache if cache is not None else PlanCache(256)
        self.device_id = device_id
        # reporting mirror (bench JSON summaries): tuned block per key for
        # every signature THIS tuner actually tuned. Not a cache — never
        # read on the hot path, survives nothing the PlanCache doesn't.
        self.results: Dict[Tuple, LiveTuneResult] = {}

    # ------------------------------------------------------------------
    def key_for(self, shapes: Sequence[GemmShape], *,
                shared_operand: bool = False) -> Tuple:
        return ("tune", self.device_id, self.objective,
                group_signature(shapes), shared_operand)

    def tune(self, shapes: Sequence[GemmShape], *,
             shared_operand: bool = False) -> BlockConfig:
        """Tuned block for this group signature — cached; searches only on
        the first sighting of a signature (or after churn invented a new
        one). The PlanCache orders this correctly under churn: a NEW
        signature builds its own entry while every existing entry — the
        'previous config' of groups mid-churn — keeps being served."""
        shapes = list(shapes)
        key = self.key_for(shapes, shared_operand=shared_operand)

        def build() -> LiveTuneResult:
            block = self.autotuner.tune_group(
                shapes, self.objective, shared_operand=shared_operand)
            env = GemmShape(m=max(s.m for s in shapes),
                            n=max(s.n for s in shapes),
                            k=max(s.k for s in shapes),
                            dtype_bytes=max(s.dtype_bytes for s in shapes),
                            layers=max(s.layers for s in shapes))
            modeled = self.cost.gemm_time(env, block) \
                if self.objective == "greedy" else \
                self.cost.coalesced_time(shapes, block,
                                         shared_operand=shared_operand)
            res = LiveTuneResult(
                signature=group_signature(shapes), objective=self.objective,
                shared_operand=shared_operand, block=block,
                modeled_group_s=modeled,
                candidates=len(self.autotuner.candidates(env)))
            self.results[key] = res
            return res

        return self.cache.get_or_build(key, build).block
