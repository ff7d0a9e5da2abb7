"""The paper's primary contribution: the OoO VLIW JIT.

kernelspec — declarative dispatch IR (§5.1); clustering — Fig. 7 shape
clusters; coalescer — superkernel planning (§5.3); scheduler — OoO EDF +
slack staggering (§5.2); autotuner — greedy vs collaborative tuning
(Table 1); costmodel — the V100, TPU-v5e and H100 roofline device models;
dispatch — the superkernel executor; jit — kernel programs and sessions;
simulator — event-driven multiplexing comparison (Figs 4–6), modelled.
"""
from repro_torch.core.autotuner import (Autotuner, LiveTuner, LiveTuneResult,
                                        TuneResult, group_signature)
from repro_torch.core.clustering import (Cluster, cluster_greedy,
                                         group_ops_exact)
from repro_torch.core.coalescer import Coalescer, SuperkernelPlan
from repro_torch.core.costmodel import (H100, TPUV5E, V100, BlockConfig,
                                        CostModel, Device, GemmShape)
from repro_torch.core.dispatch import DispatchStats, SuperkernelExecutor
from repro_torch.core.kernelspec import (GEMV_MAX_ROWS, KernelOp,
                                         gemm_population, make_op, op_aspect,
                                         stream_program, zoo_population)
from repro_torch.core.plancache import PlanCache, PlanCacheStats
from repro_torch.core.scheduler import Decision, OoOScheduler, SchedulerConfig
from repro_torch.core.simulator import (POLICIES, Request, SimResult,
                                        make_requests, simulate_space_mux,
                                        simulate_time_mux, simulate_vliw)

__all__ = [
    "Autotuner", "BlockConfig", "Cluster", "Coalescer", "CostModel",
    "Decision", "Device", "DispatchStats", "GEMV_MAX_ROWS", "GemmShape",
    "H100", "KernelOp", "LiveTuneResult", "LiveTuner", "OoOScheduler",
    "POLICIES", "PlanCache", "PlanCacheStats", "Request", "SchedulerConfig",
    "SimResult", "SuperkernelExecutor", "SuperkernelPlan", "TPUV5E",
    "TuneResult", "V100", "cluster_greedy", "gemm_population",
    "group_ops_exact", "group_signature", "make_op", "make_requests",
    "op_aspect", "simulate_space_mux", "simulate_time_mux", "simulate_vliw",
    "stream_program", "zoo_population",
]
