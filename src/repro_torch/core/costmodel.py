"""Analytical device/cost model used by the JIT scheduler, the autotuner and
the multiplexing simulator.

Per-kernel latency is a roofline estimate with *wave quantization*: a kernel
that produces fewer output tiles than the device has parallel units cannot
reach peak FLOP/s no matter its arithmetic intensity — this is precisely the
"utilization gap" of paper §3 (Fig. 3) and the physical origin of the
coalescing win (Fig. 6): packing G small problems into one superkernel
multiplies the tile count by ~G, filling the idle units.

Three device profiles are built in:
  * V100  — calibrated to the paper's hardware (15.7 TFLOPS fp32, 900 GB/s),
    used to reproduce the paper's own numbers;
  * TPUV5E — the JAX package's modelled device, kept so the copied
    scheduler/coalescer can be held against the JAX package decision for
    decision in the parity tests;
  * H100  — this package's target, the default of ``VLIWJit`` and
    ``ServingEngine``. Its fields are spec-sheet values (see below); every
    time the cost model derives from them is modelled, not measured.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    peak_flops: float          # FLOP/s at the serving dtype
    hbm_bw: float              # bytes/s
    num_units: int             # parallel execution units (SMs / MXU tiles)
    unit_tile: Tuple[int, int] # native output tile of one unit (m, n)
    vmem_bytes: int            # per-core fast memory (VMEM / L1+smem budget)
    launch_overhead_s: float   # fixed per-kernel dispatch cost
    ici_bw: float = 0.0        # bytes/s per link (TPU only)
    # per-hop interconnect latency for the collective terms (ring step /
    # all-to-all exchange). GPUs without a declared ici_bw fall back to a
    # PCIe/NVLink-ish fraction of HBM bandwidth (see CostModel._ici_bw).
    ici_latency_s: float = 1e-6
    # non-matrix-unit fallback rate (CUDA cores / TPU VPU): tiny-m problems
    # run here without MXU tile-padding losses
    vector_flops: float = 0.0
    # Calibrated spatial-multiplexing saturation: K concurrent uncoordinated
    # kernels achieve ~K^alpha aggregate speedup over serial (paper Fig. 4/6:
    # Hyper-Q reaches ~2.4x at 8 tenants on V100 => alpha ~ 0.38). Block
    # scheduling anomalies add jitter (Fig. 5), worse at odd tenant counts.
    spatial_alpha: float = 0.38
    spatial_jitter: float = 0.35
    # Co-tenancy coordination (Table 1): kernels whose combined per-wave
    # working set fits in shared cache (L2 on GPU) interleave without thrash
    # and approach alpha_coordinated concurrency scaling.
    l2_bytes: int = 6 * 1024 * 1024
    alpha_coordinated: float = 0.78


# The paper's testbed: NVIDIA V100 (Fig. 3 caption: 15.7 TFLOPS advertised).
V100 = Device(
    name="v100",
    peak_flops=15.7e12,
    hbm_bw=900e9,
    num_units=80,              # 80 SMs
    unit_tile=(32, 32),        # warp-level MMA granularity
    vmem_bytes=96 * 1024,      # unified smem/L1 per SM
    launch_overhead_s=5e-6,
    l2_bytes=6 * 1024 * 1024 + 512 * 1024,
    vector_flops=7.8e12,       # fp32 CUDA cores
)

# The JAX package's modelled device, kept as that package defines it.
TPUV5E = Device(
    name="tpuv5e",
    peak_flops=197e12,         # bf16
    hbm_bw=819e9,
    num_units=8,               # MXU-equivalent parallel tiles per core-step
    unit_tile=(128, 128),
    vmem_bytes=16 * 1024 * 1024,
    launch_overhead_s=2e-6,
    ici_bw=50e9,
    vector_flops=4e12,         # VPU
)


# Target of this package: NVIDIA H100 SXM. Spec-sheet values from NVIDIA's
# data sheet and the Hopper white paper, not measurements: 132 SMs,
# 3.35 TB/s HBM3, 989 TFLOP/s bf16 dense on the tensor cores, 67 TFLOP/s
# fp32 on the CUDA cores, 227 KB of shared memory per block, 50 MB of L2,
# 450 GB/s NVLink each way. ``unit_tile`` is one warpgroup MMA tile.
H100 = Device(
    name="h100",
    peak_flops=989e12,         # bf16 dense, tensor cores
    hbm_bw=3.35e12,
    num_units=132,             # SMs
    unit_tile=(64, 128),       # one wgmma output tile
    vmem_bytes=227 * 1024,     # shared memory one block can use
    launch_overhead_s=5e-6,
    ici_bw=450e9,              # NVLink, each way
    vector_flops=67e12,        # fp32 CUDA cores
    l2_bytes=50 * 1024 * 1024,
)


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """One GEMM problem: C[m,n] += A[m,k] @ B[k,n].

    ``layers`` models a LAYER-STACKED operand (core/jit.py
    ``StackedGemmStage``): one op that executes the same (m, n, k) GEMM
    ``layers`` times sequentially inside a loop over layers of a stacked
    B[L,k,n]. The per-wave tile geometry (``CostModel.tiles``) is unchanged
    — each scan step launches the same tile wave — while flops, bytes and
    latency all scale by L (critical path = L·wave, not a single GEMM).
    """
    m: int
    n: int
    k: int
    dtype_bytes: int = 2
    layers: int = 1

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k * self.layers

    @property
    def bytes(self) -> float:
        return self.dtype_bytes * self.layers * (
            self.m * self.k + self.k * self.n + self.m * self.n)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tiling configuration for one (super)kernel — the autotuner's knob."""
    bm: int = 128
    bn: int = 128
    bk: int = 512

    def vmem_usage(self, k: int, dtype_bytes: int = 2) -> int:
        bk = min(self.bk, k)
        return dtype_bytes * (self.bm * bk + bk * self.bn) + 4 * self.bm * self.bn


DEFAULT_BLOCK = BlockConfig()


class CostModel:
    """Roofline + wave-quantization latency estimates on one device."""

    def __init__(self, device: Device):
        self.device = device

    # ------------------------------------------------------------------
    def tiles(self, shape: GemmShape, block: BlockConfig = DEFAULT_BLOCK) -> int:
        return math.ceil(shape.m / block.bm) * math.ceil(shape.n / block.bn)

    def compute_efficiency(self, total_tiles: int,
                           block: BlockConfig = DEFAULT_BLOCK,
                           units: Optional[int] = None) -> float:
        """Fraction of peak reachable given the output-tile count.

        Wave quantization: ``waves = ceil(tiles/units)`` full device steps are
        needed; only ``tiles`` of ``waves*units`` tile-slots do work. A second
        factor penalizes blocks narrower than the native unit tile (MXU padding).
        ``units`` can be overridden to model co-tenancy (each tenant sees a
        fraction of the device's parallel units).
        """
        d = self.device
        units = units or d.num_units
        waves = math.ceil(total_tiles / units)
        quant = total_tiles / (waves * units)
        fill = min(1.0, (block.bm / d.unit_tile[0])) * min(
            1.0, (block.bn / d.unit_tile[1]))
        return quant * fill

    def gemm_bytes(self, shape: GemmShape,
                   block: BlockConfig = DEFAULT_BLOCK) -> float:
        """HBM traffic with k-blocked tiling re-reads.

        Each output tile accumulates over k: the A panel is re-read once per
        n-tile column and the B panel once per m-tile row. Larger tiles =
        less re-read = the 'greedy' single-tenant optimum; smaller tiles =
        better load balance on a shared device = the 'collaborative' optimum
        (paper Table 1)."""
        n_tiles_m = math.ceil(shape.m / block.bm)
        n_tiles_n = math.ceil(shape.n / block.bn)
        a = shape.m * shape.k * n_tiles_n
        b = shape.k * shape.n * n_tiles_m
        c = shape.m * shape.n
        return shape.dtype_bytes * shape.layers * (a + b + c)

    # ------------------------------------------------------------------
    def gemm_time(self, shape: GemmShape,
                  block: BlockConfig = DEFAULT_BLOCK,
                  co_tenants: int = 1) -> float:
        """Latency of one GEMM kernel run with ``co_tenants`` concurrent
        kernels sharing the device (space multiplexing).

        With co-tenancy the kernel sees ~1/K of the units and of HBM
        bandwidth, plus an interference penalty (uncoordinated tile shapes
        thrash the memory system — paper §4.2 / Table 1's 'greedy kernels
        degrade each other')."""
        d = self.device
        units = max(1, d.num_units // co_tenants)
        interference = 1.0 if co_tenants == 1 else 1.25  # calibrated, §4.2
        share = units / d.num_units
        padded = 2.0 * math.ceil(shape.m / block.bm) * block.bm \
            * math.ceil(shape.n / block.bn) * block.bn * shape.k \
            * shape.layers
        t_compute = self._compute_time(shape.flops,
                                       self.tiles(shape, block), block,
                                       units=units, share=share,
                                       padded_flops=padded)
        t_memory = self.gemm_bytes(shape, block) \
            / (d.hbm_bw / co_tenants) * interference
        return max(t_compute, t_memory) + d.launch_overhead_s

    def _compute_time(self, useful_flops: float, total_tiles: int,
                      block: BlockConfig, units: Optional[int] = None,
                      share: float = 1.0,
                      padded_flops: Optional[float] = None) -> float:
        """Best of the matrix-unit path (tile-padded, fill-penalized) and the
        vector-unit fallback (no tile structure, wave-quantized only)."""
        d = self.device
        units = units or d.num_units
        eff = self.compute_efficiency(total_tiles, block, units=units)
        t_mxu = (padded_flops or useful_flops) \
            / (d.peak_flops * share * max(eff, 1e-6))
        if d.vector_flops <= 0:
            return t_mxu
        waves = math.ceil(total_tiles / units)
        quant = total_tiles / (waves * units)
        t_vec = useful_flops / (d.vector_flops * share * max(quant, 1e-6))
        return min(t_mxu, t_vec)

    # ------------------------------------------------------------------
    def coalesced_time(self, shapes: Sequence[GemmShape],
                       block: BlockConfig = DEFAULT_BLOCK,
                       shared_operand: bool = False) -> float:
        """Latency of one superkernel executing all ``shapes`` at once.

        Tiles add up (this is the whole point: the union fills the device).
        Memory traffic is the padded union; ``shared_operand=True`` models
        same-weight coalescing (multiple streams of the same model — the
        GEMV/RNN case §5.3) where the B matrix is loaded once.
        """
        if not shapes:
            return 0.0
        d = self.device
        if shared_operand:
            # same weights (same model+layer across streams): the problems
            # concatenate along m into ONE GEMM — B is loaded once.
            cat = GemmShape(m=sum(s.m for s in shapes),
                            n=max(s.n for s in shapes),
                            k=max(s.k for s in shapes),
                            dtype_bytes=shapes[0].dtype_bytes,
                            layers=max(s.layers for s in shapes))
            total_tiles = self.tiles(cat, block)
            padded = 2.0 * math.ceil(cat.m / block.bm) * block.bm \
                * math.ceil(cat.n / block.bn) * block.bn * cat.k \
                * cat.layers
            useful = sum(s.flops for s in shapes)
            io = self.gemm_bytes(cat, block)
        else:
            total_tiles = sum(self.tiles(s, block) for s in shapes)
            # padded flops: every problem is rounded up to tile multiples
            padded = sum(
                2.0 * math.ceil(s.m / block.bm) * block.bm
                * math.ceil(s.n / block.bn) * block.bn * s.k * s.layers
                for s in shapes)
            useful = sum(s.flops for s in shapes)
            io = sum(self.gemm_bytes(s, block) for s in shapes)
        t_compute = self._compute_time(useful, total_tiles, block,
                                       padded_flops=padded)
        t_memory = io / d.hbm_bw
        return max(t_compute, t_memory) + d.launch_overhead_s

    # ------------------------------------------------------------------
    def time_multiplexed(self, shapes: Sequence[GemmShape],
                         block: BlockConfig = DEFAULT_BLOCK) -> float:
        """Serial execution (paper §4.1) + context-switch flush overhead."""
        switch = 10e-6  # pipeline flush between contexts (§4.1)
        return sum(self.gemm_time(s, block) for s in shapes) \
            + switch * max(len(shapes) - 1, 0)

    def space_multiplexed(self, shapes: Sequence[GemmShape],
                          block: BlockConfig = DEFAULT_BLOCK) -> float:
        """Concurrent uncoordinated execution (paper §4.2).

        Two regimes bound the makespan:
          * saturation — K uncoordinated kernels only reach ~K^alpha aggregate
            speedup over serial (block-scheduler interleaving, L2/DRAM thrash;
            calibrated to the paper's Hyper-Q measurements);
          * partition  — no tenant finishes faster than it would on its 1/K
            device share (per-block-config, used by the Table 1 autotuner).
        """
        K = len(shapes)
        if K == 0:
            return 0.0
        d = self.device
        serial = sum(self.gemm_time(s, block) for s in shapes)
        # combined per-wave working set across resident blocks
        blk_bytes = shapes[0].dtype_bytes * (
            block.bm * min(block.bk, max(s.k for s in shapes))
            + min(block.bk, max(s.k for s in shapes)) * block.bn) \
            + 4 * block.bm * block.bn
        coordinated = d.num_units * blk_bytes <= d.l2_bytes
        if coordinated:
            return serial / (K ** d.alpha_coordinated)
        saturated = serial / (K ** d.spatial_alpha)
        partitioned = max(self.gemm_time(s, block, co_tenants=K)
                          for s in shapes)
        return max(saturated, partitioned)

    # ------------------------------------------------------------------
    # cross-device collectives (multi-device mesh serving)
    # ------------------------------------------------------------------
    def _ici_bw(self) -> float:
        """Effective per-link interconnect bandwidth. Devices that declare
        ``ici_bw`` (TPU ICI) use it; GPU profiles without one fall back to
        hbm_bw/8 — a PCIe4/NVLink-class fraction, so collective charges
        stay finite and conservative rather than silently zero."""
        d = self.device
        return d.ici_bw if d.ici_bw > 0 else d.hbm_bw / 8.0

    def ring_allreduce_time(self, bytes_per_device: float,
                            n_devices: int) -> float:
        """Bandwidth-latency model of a ring all-reduce over ``n_devices``:
        reduce-scatter + all-gather each move (n-1)/n of the buffer per
        device and take (n-1) ring steps — the TP psum charge."""
        if n_devices <= 1 or bytes_per_device <= 0:
            return 0.0
        d = self.device
        steps = 2 * (n_devices - 1)
        moved = 2.0 * (n_devices - 1) / n_devices * bytes_per_device
        return moved / self._ici_bw() + steps * d.ici_latency_s

    def all_to_all_time(self, bytes_per_device: float,
                        n_devices: int) -> float:
        """Bandwidth-latency model of an all-to-all over ``n_devices``:
        each device keeps 1/n of its buffer and exchanges the rest in
        (n-1) pairwise steps — the MoE expert dispatch/combine charge."""
        if n_devices <= 1 or bytes_per_device <= 0:
            return 0.0
        d = self.device
        moved = (n_devices - 1) / n_devices * bytes_per_device
        return moved / self._ici_bw() + (n_devices - 1) * d.ici_latency_s

    # ------------------------------------------------------------------
    def achieved_tflops(self, shapes: Sequence[GemmShape], t: float) -> float:
        return sum(s.flops for s in shapes) / t / 1e12

    def utilization(self, shapes: Sequence[GemmShape], t: float) -> float:
        return sum(s.flops for s in shapes) / (t * self.device.peak_flops)
