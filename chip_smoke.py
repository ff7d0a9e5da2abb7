#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-only [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --gemv-only [--src OTHER_CHECKOUT/src]

Run from the root of a checkout. It needs one CUDA card and ``nvcc``
(``/usr/local/cuda``); it imports nothing of JAX or of the JAX package.
Phases, each printing its own lines; a failing phase raises:

  1. device      — the card's name and power limit (nvidia-smi);
  2. build       — nvcc builds every kernel library from the sources, one
                   nvcc per source, all started together, with each
                   kernel's ptxas lines (registers, shared memory, spills);
                   one line per ``coalesced_gemm`` instance (dtype) and per
                   ``flash_attention`` instance (dtype, head dim) with its
                   MMA path, registers, spill bytes (must be 0) and the
                   HMMA instructions in its SASS (``cuobjdump -sass``; must
                   be > 0: the instance runs on tensor cores); the gemm
                   lines add its blocks per SM, the clusters of 8 the card
                   holds and the K split (cluster size) at the path's K;
                   one line per ``coalesced_gemv`` instance (dtype) with its
                   registers, spill bytes (must be 0), blocks per SM, the
                   clusters of 8 the card holds and the K split (cluster
                   size) at K 2048 and 4096;
  3. kernel      — ``coalesced_gemm`` (CUDA) against its plain PyTorch
                   version at the serving paths' shapes (yi-9b, and the
                   padded envelopes of grok-1's expert GEMMs and
                   mamba2-2.7b's projections), fp32 and bf16, with
                   CUDA-event times (median and spread; L2 flushed before
                   every timed call) of the kernel, the plain version and
                   one PyTorch library call, the host µs a wrapper call
                   takes to enqueue (200 calls, no synchronise between
                   them), beside the least time the card could take (bytes
                   at 3.35 TB/s, or operations at the peak rate of their
                   type: 67 TFLOP/s fp32 without tensor cores, 989 TFLOP/s
                   bf16; fp32 gemm and attention at the 3xTF32 rate, a
                   third of 495 TFLOP/s TF32);
     kernel-gemv — ``coalesced_gemv`` (CUDA) the same way at the LSTM shape
                   of the RNN bench (G = 2, 4, 8; K = 2048, N = 4096) and at
                   the yi-9b decode envelope [4, 4096, 16384], with the
                   spread and host µs per wrapper call; library call
                   ``torch.bmm``; L2 flushed before every timed call;
     kernel-attn — ``flash_attention`` (CUDA) the same way at yi-9b global
                   attention (32 heads, S = 4096, D = 128, causal),
                   gemma3-1b local attention (4 heads on its one kv head,
                   S = 4096, D = 256, window 1024) and one S < 128 case,
                   each line naming the instance's MMA path (``mma=``);
                   library call ``scaled_dot_product_attention``, timed only;
  4. serve-shared  — the main path: ``ServingEngine`` in ``vliw`` mode, two
                   tenants sharing one full-width yi-9b weight set (bf16,
                   48 layers unless the card's free memory forces a cut,
                   which is printed), 4 requests each, prompts of 32
                   tokens, 8 new tokens, served twice: layer-stacked
                   templates (the default; each body GEMM a solo launch)
                   and then ``stacked_layers=False`` (per-layer stages
                   coalesced across the tenants), each engine freed before
                   the next. Per regime: wall s, tokens/s, scheduler
                   dispatches, kernel launches (checked against the
                   dispatches), launches per program, weight hit rate,
                   peak GiB, then the gemm's launches by (M, K, N, G,
                   dtype), each marked by whether phase 3 times that shape
                   (also in phase 5). The tokens of the two regimes must
                   be identical. While the stacked engine lives: one more
                   decode step through a stacked and a per-layer template
                   (logits bitwise equal), and ``profile`` lines: host and
                   wall ms of one steady decode step in each regime, the
                   device time of ``coalesced_gemm`` and of the other
                   kernels (``torch.profiler``), and the device busy share;
  5. serve-grouped — two full-width yi-9b tenants with distinct weights
                   (bf16, 12 layers), both regimes as in phase 4: per-layer
                   the kernel runs with G >= 2 weight matrices;
  5b. serve-moe  — two tenants sharing one full-width grok-1 weight set
                   (bf16, 8 experts top-2, 2 layers: one layer's experts
                   are 9.66 GB), both regimes as in phase 4, the bytes
                   reckoned beside ``torch.cuda.mem_get_info``; per regime
                   also ``expert_coalesced`` and ``nondense_programs``
                   (launches: 4 + 3E a layer of a stacked body plus one a
                   plain dispatch; expert GEMMs coalesced across the
                   tenants per-layer), the extra step and ``profile``
                   lines;
  5c. serve-ssm  — the same with mamba2-2.7b (bf16, all 64 layers; 2
                   launches a layer of a stacked body);
  5d. serve-mesh — the modelled mesh: two full-width yi-9b tenants with
                   distinct weights (bf16, 12 layers unless free memory
                   forces a cut), mamba2-2.7b (bf16, 64 layers) and grok-1
                   at full width (bf16, 1 layer, its 8 experts spanning a
                   2-device mesh; one request at a time), stacked,
                   ``certify=True``, on 1 and then 2 modelled devices (the
                   bytes reckoned beside ``mem_get_info``); per mesh size
                   wall s, tokens/s, programs a tenant, dispatches and
                   coalesced groups per device, ``device_util``,
                   ``device_skew``, the placement, the modelled collective
                   µs, hazard checks and violations (0), the certifier's
                   host ms a dispatch and launches (checked against the
                   tenants' programs); tokens identical at the two sizes;
  5e. serve-daemon — two tenants sharing one full-width yi-9b weight set
                   (bf16, 48 layers unless free memory forces a cut)
                   behind ``serve_forever`` on 2 modelled devices with
                   ``certify`` and admission control: a preloaded door on
                   a ``VirtualClock`` bitwise equal to ``run()``; one
                   request served alone (its real seconds set the SLOs);
                   then 32 live Poisson submissions at 8 req/s from a
                   feeder thread on the real clock (``MonotonicClock``),
                   tiers 0/1/2 (p 0.5/0.3/0.2) with SLOs 1x/2x/4x the
                   alone request: heartbeat lines, attainment overall and
                   per tier, goodput, shed, unfinished, real TTFT (from
                   the feeder's submission instant) and per-token p50/p99
                   (host instants taken in the ticket callback) beside the
                   wait for the loop's poll and the engine's stamps, the
                   modelled cost against the alone request's real
                   seconds, hazard counters; every request finished or
                   shed, ticket streams equal to the report's tokens;
  5f. serve-cli  — ``python -m repro_torch.launch.serve --daemon
                   --duration 3 --num-devices 2 --certify --admission
                   --dtype bfloat16`` (smoke configs) as a subprocess:
                   exits 0 with no hazard;
  6. card-vs-cpu — full-width yi-9b, fp32, 1 layer, two tenants with
                   distinct weights, both regimes (per-layer: the grouped
                   regime, G = 2): the same trace, weights and prompts
                   served on the card (kernel) and on the CPU (plain
                   versions) give identical greedy tokens; then the same
                   for mamba2-2.7b at full width (fp32, 2 layers) and
                   grok-1's smoke config (fp32), each line with the
                   smallest router top-k margin of the run (a mismatch
                   prints the first differing step and routing call);
  7. rnn-matvec  — the matvec regime's path: ``SuperkernelExecutor.matvec``
                   at the LSTM shape (fp32, G = 4) for 20 ticks, distinct
                   weights (``coalesced_gemv``) and shared weights
                   (``coalesced_gemm``), outputs against ``ops.coalesced_
                   matvec`` on the card and the CPU plain path; prints the
                   coalescer's decision and host time per tick;
  8. windowed-attention — ``ops.windowed_attention`` at the gemma3-1b local
                   shape on the card against the CPU plain path;
  9. the kernel table as one JSON line, then the result line.

Launch counts are set to 0 just before each path phase (4-8), and in
phases 4-6 before each regime's run, and read just after it; the
comparisons of phase 3 are not counted there. A ``phase`` line gives each
phase's seconds. Every line of numbers after phase 1 ends with the card's
name and power limit (``card=``). Weights and
inputs are random, made from fixed seeds. ``--gemm-only`` runs phase 1 and
phase 3's ``kernel`` lines alone, ``--gemv-only`` phase 1 and the
``kernel-gemv`` lines; neither prints a result line. With ``--src`` they
drive another checkout's wrapper (e.g. the parent commit's, unpacked with
``git archive``), so two versions are timed on one card.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the gemm and attention kernels run fp32 as 3xTF32 on the tensor cores
# (three TF32 products a product, each at the 495 TFLOP/s TF32 peak): their
# least time is at that rate
MMA_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# (rtol, atol) of kernel against plain version. Both add in fp32, in
# different orders (the kernels' fp32 products as 3xTF32, about 21 bits), so
# their sums differ by a few fp32 ulps (outputs are of order 1: B is scaled
# by 1/sqrt(K)); bf16 then rounds both sums to bf16, so a sound kernel is at
# most one bf16 ulp (2^-7 relative) off. A kernel that accumulates in bf16,
# takes plain TF32 products, or drops a K slice, is several times further
# off than that.
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-4)}
GIB = 1 << 30


# the card's name and power limit as nvidia-smi prints them, set by
# phase_device: every line of numbers after it ends with it
CARD = None


def say(phase: str, **kv) -> None:
    if CARD is not None:
        kv["card"] = repr(CARD)
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_spread(fn, reps: int = 15, warmup: int = 3, flush=None):
    """(median, min, max) CUDA-event time of one call, in ms. ``flush``: a
    tensor larger than the 50 MB L2 cache, overwritten before every timed
    call (outside its events) so the call finds its operands in device
    memory."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.add_(1)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    return statistics.median(times), min(times), max(times)


def time_ms(fn, reps: int = 15, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of one call, in ms (``time_spread``)."""
    return time_spread(fn, reps, warmup, flush)[0]


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time to enqueue one call, in µs: ``calls`` calls with no
    synchronise between them, over the count (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


# mangled instance names: flash_kernel<T, D> and gemm_kernel<T>
_INSTANCE = {
    "flash_kernel": re.compile(r"flash_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
    "gemm_kernel": re.compile(r"gemm_kernelI(f|13__nv_bfloat16)E"),
    "gemv_kernel": re.compile(r"gemv_kernelI(f|13__nv_bfloat16)E"),
}


def _instance(symbol, kernel):
    """'bfloat16/128' for a mangled flash_kernel<T, D> symbol, 'bfloat16'
    for gemm_kernel<T> or gemv_kernel<T>, None for another symbol."""
    m = _INSTANCE[kernel].search(symbol)
    if m is None:
        return None
    dname = "float32" if m.group(1) == "f" else "bfloat16"
    return f"{dname}/{m.group(2)}" if m.lastindex == 2 else dname


def _ptxas_per_instance(log, kernel):
    """{instance: (registers, spill bytes)} of ``kernel`` from ptxas -v
    lines."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", ln)
        if m:
            cur = _instance(m.group(1), kernel)
            continue
        if cur is None:
            continue
        regs, spill = out.get(cur, (0, 0))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs = int(m.group(1))
        out[cur] = (regs, spill)
    return out


def _hmma_per_instance(build, path, kernel):
    """{instance: HMMA count} of ``kernel`` in the SASS of the built library
    (the cuobjdump of the toolkit that built it)."""
    sass = subprocess.run(
        [str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(path)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = _instance(m.group(1), kernel)
            if cur is not None:
                out.setdefault(cur, 0)
        elif cur is not None and "HMMA" in ln:
            out[cur] += 1
    return out


def phase_build(build, cg, gv, fa):
    t0 = time.perf_counter()
    libs = build.load_all([m.LIBRARY for m in (cg, gv, fa)])
    for built in libs:
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        for ln in ptxas:
            print(f"  ptxas[{built.library.name}]:", ln)
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        libraries=",".join(b.path.name for b in libs),
        builds=build.build_count())
    # each coalesced_gemm instance keeps its registers (no spills) and runs on
    # tensor cores (HMMA in its SASS: bf16 MMAs, fp32 as 3xTF32); the
    # wrapper's count of its shared memory is the source's
    ptxas = _ptxas_per_instance(libs[0].log, "gemm_kernel")
    hmma = _hmma_per_instance(build, libs[0].path, "gemm_kernel")
    for dtype, code in cg.DTYPE_CODES.items():
        dname = str(dtype).removeprefix("torch.")
        regs, spill = ptxas[dname]
        assert libs[0].lib.coalesced_gemm_smem_bytes(code) == \
            cg.smem_bytes(dtype), dname
        splits = ",".join(f"K{K}:{cg.k_split(K, dtype)[0]}" for K in
                          sorted({s[2] for s in SHAPES}))
        per_sm, clusters = ctypes.c_int(), ctypes.c_int()
        libs[0].check(libs[0].lib.coalesced_gemm_occupancy(
            code, cg.MAX_CLUSTER, ctypes.byref(per_sm), ctypes.byref(clusters)))
        say("build", gemm_kernel=dname, mma=cg.MMA[dtype],
            smem_bytes=cg.smem_bytes(dtype), registers=regs,
            spill_bytes=spill, hmma=hmma[dname], blocks_per_sm=per_sm.value,
            clusters_of_8=clusters.value, cluster_split=splits)
        assert spill == 0, (dname, spill)
        assert hmma[dname] > 0, (dname, hmma[dname])
    # each coalesced_gemv instance keeps its registers (no spills); its split
    # at the LSTM depth and the yi-9b envelope's
    ptxas = _ptxas_per_instance(libs[1].log, "gemv_kernel")
    for dtype, code in gv.DTYPE_CODES.items():
        dname = str(dtype).removeprefix("torch.")
        regs, spill = ptxas[dname]
        per_sm, clusters = ctypes.c_int(), ctypes.c_int()
        libs[1].check(libs[1].lib.coalesced_gemv_occupancy(
            code, gv.MAX_CLUSTER, ctypes.byref(per_sm), ctypes.byref(clusters)))
        splits = ",".join(f"K{K}:{gv.k_split(K, dtype)}" for K in (2048, 4096))
        say("build", gemv_kernel=dname, threads=gv.THREADS, registers=regs,
            spill_bytes=spill, blocks_per_sm=per_sm.value,
            clusters_of_8=clusters.value, cluster_split=splits)
        assert spill == 0, (dname, spill)
    # the wrapper's count of the attention kernel's dynamic shared memory is
    # the source's, for every dtype and head dim
    lib = libs[-1].lib
    for dtype, code in fa.DTYPE_CODES.items():
        for d in fa.HEAD_DIMS:
            assert lib.flash_attention_smem_bytes(d, code) == \
                fa.smem_bytes(d, dtype), (dtype, d)
    # every attention instance runs on tensor cores (HMMA in its SASS) and
    # keeps its registers (no spills)
    ptxas = _ptxas_per_instance(libs[-1].log, "flash_kernel")
    hmma = _hmma_per_instance(build, libs[-1].path, "flash_kernel")
    for dtype in fa.DTYPE_CODES:
        dname = str(dtype).removeprefix("torch.")
        for d in fa.HEAD_DIMS:
            key = f"{dname}/{d}"
            regs, spill = ptxas[key]
            say("build", flash_kernel=key, mma=fa.MMA[dtype],
                smem_bytes=fa.smem_bytes(d, dtype), registers=regs,
                spill_bytes=spill, hmma=hmma[key])
            assert spill == 0, (key, spill)
            assert hmma[key] > 0, (key, hmma[key])


# ---------------------------------------------------------------------------
# 3. kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------

SHAPES = [
    # (label, rows per problem, K, N, shared weights); the fifth is
    # serve-shared's most launched bucket (M 8, K 4096, G 1: as many
    # launches at N 512, 4096 and 16384), at its widest N. The last four
    # are the MoE and SSM bodies' solo launches (G 1) at their padded
    # envelopes: grok-1's expert GEMMs (C = 2 rows at B = 4; K 6144 and
    # N 6144 pad to 8192) and mamba2-2.7b's projections (B = 4 rows; K 2560
    # pads to 4096, N 10576 to 16384, K 5120 to 8192, N 2560 to 4096)
    ("yi-9b decode grouped (ffn gate/up)", (4, 4), 4096, 16384, False),
    ("shared regime (ffn down)", (8,), 16384, 4096, True),
    ("ragged prefill+decode (attn wq/wo)", (32, 4), 4096, 4096, False),
    ("unembed", (8,), 4096, 65536, True),
    ("shared regime decode (ffn gate/up)", (8,), 4096, 16384, True),
    ("grok-1 expert gate/up", (2,), 8192, 32768, True),
    ("grok-1 expert down", (2,), 32768, 8192, True),
    ("mamba2 in_proj", (4,), 4096, 16384, True),
    ("mamba2 out_proj", (4,), 8192, 4096, True),
]


def _operands(torch, rows, K, N, shared, dtype, bm=8, seed=0):
    """The operands the dispatch executor hands the kernel for this group:
    rows padded to bm, a power-of-two m-tile count (pad tiles read group
    0), weights scaled like a fan-in init."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = 1 if shared else len(rows)
    tiles, gids = [], []
    for p, m in enumerate(rows):
        t = -(-m // bm)
        a = torch.zeros(t * bm, K, device="cuda")
        a[:m] = torch.randn(m, K, device="cuda", generator=g)
        tiles.append(a)
        gids += [0 if shared else p] * t
    m_tiles = 1 << (len(gids) - 1).bit_length()
    gids += [0] * (m_tiles - len(gids))
    a = torch.cat(tiles)
    a = torch.cat([a, a.new_zeros(m_tiles * bm - a.shape[0], K)])
    b = torch.randn(G, K, N, device="cuda", generator=g) / math.sqrt(K)
    gid = torch.tensor(gids, dtype=torch.int32, device="cuda")
    return a.to(dtype).contiguous(), b.to(dtype).contiguous(), gid


def phase_kernel(torch, cg, ref, flush):
    """``coalesced_gemm`` against its plain version at the path's shapes;
    every timed call finds L2 flushed. Only ``cg.coalesced_gemm`` is used."""
    rows_out = []
    for label, rows, K, N, shared in SHAPES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            a, b, gid = _operands(torch, rows, K, N, shared, dtype)
            M, G = int(a.shape[0]), int(b.shape[0])
            got = cg.coalesced_gemm(a, b, gid, bm=8)
            torch.cuda.synchronize()
            want = ref(a, b, gid, 8)
            rtol, atol = TOL[dname]
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            err = float((got.float() - want.float()).abs().max())
            call = lambda: cg.coalesced_gemm(a, b, gid, bm=8)  # noqa: E731
            kernel_ms, kernel_min, kernel_max = time_spread(call, flush=flush)
            host_us = host_us_per_call(call)
            plain_ms = time_ms(lambda: ref(a, b, gid, 8), reps=5,
                               flush=flush)
            if G == 1:
                bw = b[0]
                library_ms = time_ms(lambda: torch.matmul(a, bw), flush=flush)
                library = "torch.matmul"
            else:
                tiles = a.view(M // 8, 8, K)
                b_tile = b[gid.long()].contiguous()
                library_ms = time_ms(lambda: torch.bmm(tiles, b_tile),
                                     flush=flush)
                library = "torch.bmm"
                del b_tile
            db = a.element_size()
            moved = (M * K + G * K * N + M * N) * db + gid.numel() * 4
            bound_ms, bound_by = _bound(moved, 2.0 * M * K * N, dname,
                                        MMA_PEAK_FLOPS)
            row = dict(shape=label, dtype=dname, M=M, K=K, N=N, G=G,
                       max_abs_err=err, ms=kernel_ms, ms_min=kernel_min,
                       ms_max=kernel_max, host_us_per_call=host_us,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library=library, bound_ms=bound_ms, bound_by=bound_by)
            rows_out.append(row)
            say("kernel", shape=repr(label), dtype=dname,
                A=f"[{M},{K}]", B=f"[{G},{K},{N}]", max_abs_err=f"{err:.3e}",
                kernel_ms=f"{kernel_ms:.4f}",
                spread_ms=f"{kernel_min:.4f}..{kernel_max:.4f}",
                host_us_per_call=f"{host_us:.2f}",
                plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}({library})",
                bound_ms=f"{bound_ms:.4f}({bound_by})",
                bound_share=f"{bound_ms / kernel_ms:.3f}",
                library_over_kernel=f"{library_ms / kernel_ms:.3f}")
            del a, b, gid, got, want
    torch.cuda.empty_cache()
    return rows_out


def _bound(moved_bytes, flops, dname, peak=PEAK_FLOPS):
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak[dname]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


GEMV_SHAPES = [
    # (label, G, K, N, dtypes)
    ("lstm G=2", 2, 2048, 4096, ("float32", "bfloat16")),
    ("lstm G=4", 4, 2048, 4096, ("float32", "bfloat16")),
    ("lstm G=8", 8, 2048, 4096, ("float32", "bfloat16")),
    ("yi-9b decode envelope (ffn gate)", 4, 4096, 16384,
     ("float32", "bfloat16")),
]


def phase_kernel_gemv(torch, gv, ref, flush):
    rows_out = []
    for label, G, K, N, dtypes in GEMV_SHAPES:
        for dname in dtypes:
            dtype = getattr(torch, dname)
            g = torch.Generator(device="cuda").manual_seed(G * K + N)
            x = torch.randn(G, K, device="cuda", generator=g).to(dtype)
            w = (torch.randn(G, K, N, device="cuda", generator=g)
                 / math.sqrt(K)).to(dtype)
            got = gv.coalesced_gemv(x, w)
            torch.cuda.synchronize()
            want = ref(x, w)
            rtol, atol = TOL[dname]
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            err = float((got.float() - want.float()).abs().max())
            call = lambda: gv.coalesced_gemv(x, w)  # noqa: E731
            kernel_ms, kernel_min, kernel_max = time_spread(call, flush=flush)
            host_us = host_us_per_call(call)
            plain_ms = time_ms(lambda: ref(x, w), reps=5, flush=flush)
            x3 = x[:, None]
            library_ms = time_ms(lambda: torch.bmm(x3, w), flush=flush)
            db = x.element_size()
            bound_ms, bound_by = _bound((G * K + G * K * N + G * N) * db,
                                        2.0 * G * K * N, dname)
            rows_out.append(dict(
                shape=label, dtype=dname, G=G, K=K, N=N, max_abs_err=err,
                ms=kernel_ms, ms_min=kernel_min, ms_max=kernel_max,
                host_us_per_call=host_us, plain_ms=plain_ms,
                library_ms=library_ms, library="torch.bmm",
                bound_ms=bound_ms, bound_by=bound_by))
            say("kernel-gemv", shape=repr(label), dtype=dname,
                x=f"[{G},{K}]", w=f"[{G},{K},{N}]", max_abs_err=f"{err:.3e}",
                kernel_ms=f"{kernel_ms:.4f}",
                spread_ms=f"{kernel_min:.4f}..{kernel_max:.4f}",
                host_us_per_call=f"{host_us:.2f}",
                plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}(torch.bmm)",
                bound_ms=f"{bound_ms:.4f}({bound_by})",
                bound_share=f"{bound_ms / kernel_ms:.3f}",
                library_over_kernel=f"{library_ms / kernel_ms:.3f}")
            del x, w, x3, got, want
    torch.cuda.empty_cache()
    return rows_out


ATTN_SHAPES = [
    # (label, BH, S, D, causal, window, heads sharing one k/v)
    ("yi-9b global (32 heads)", 32, 4096, 128, True, 0, 1),
    ("gemma3-1b local (4 heads on 1 kv head)", 4, 4096, 256, True, 1024, 4),
    ("short prompt S=96 (yi-9b)", 32, 96, 128, True, 0, 1),
]
# kernel against plain version: fp32 at the attention tolerance of
# tests/test_kernels.py (online softmax against a dense softmax, sums over
# S keys in other orders); bf16 at one bf16 ulp of outputs of order 1
ATTN_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (1e-2, 1e-4)}


def unmasked_pairs(S, causal, window):
    """(row, col) pairs the mask leaves visible: the pairs this input's
    attention has to compute."""
    total = 0
    for r in range(S):
        lo = max(0, r - window + 1) if window > 0 else 0
        hi = r + 1 if causal else S
        total += max(0, hi - lo)
    return total


def _attn_inputs(torch, BH, S, D, share, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(BH, S, D, device="cuda", generator=g)
    k, v = (torch.randn(BH // share, 1, S, D, device="cuda", generator=g)
            .expand(BH // share, share, S, D).reshape(BH, S, D)
            for _ in range(2))
    return q.to(dtype), k.to(dtype).contiguous(), v.to(dtype).contiguous()


def phase_kernel_attn(torch, fa, ref, flush):
    import torch.nn.functional as F
    rows_out = []
    for label, BH, S, D, causal, window, share in ATTN_SHAPES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, k, v = _attn_inputs(torch, BH, S, D, share, dtype, seed=S + D)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref(q, k, v, causal=causal, window=window)
            assert bool(torch.isfinite(got.float()).all())
            rtol, atol = ATTN_TOL[dname]
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            err = float((got.float() - want.float()).abs().max())
            del want
            kernel_ms = time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window), reps=10, flush=flush)
            plain_ms = time_ms(lambda: ref(q, k, v, causal=causal,
                                           window=window),
                               reps=3, warmup=1, flush=flush)
            q4, k4, v4 = (t[None] for t in (q, k, v))
            if window > 0:
                rows = torch.arange(S, device="cuda")[:, None]
                cols = torch.arange(S, device="cuda")[None, :]
                mask = (cols <= rows) & (cols > rows - window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q4, k4, v4, attn_mask=mask)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q4, k4, v4, is_causal=causal)
            library_ms = time_ms(lib, reps=10, flush=flush)
            pairs = unmasked_pairs(S, causal, window)
            db = q.element_size()
            bound_ms, bound_by = _bound(4 * BH * S * D * db,
                                        4.0 * D * pairs * BH, dname,
                                        MMA_PEAK_FLOPS)
            rows_out.append(dict(
                shape=label, dtype=dname, BH=BH, S=S, D=D, causal=causal,
                window=window, mma=fa.MMA[dtype], max_abs_err=err,
                ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library="scaled_dot_product_attention", bound_ms=bound_ms,
                bound_by=bound_by, unmasked_pairs=pairs))
            say("kernel-attn", shape=repr(label), dtype=dname,
                mma=fa.MMA[dtype],
                qkv=f"[{BH},{S},{D}]", causal=causal, window=window,
                max_abs_err=f"{err:.3e}", kernel_ms=f"{kernel_ms:.4f}",
                plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}(sdpa)",
                bound_ms=f"{bound_ms:.4f}({bound_by})",
                bound_share=f"{bound_ms / kernel_ms:.3f}")
            del q, k, v, q4, k4, v4, got
            torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# 4-6. serving
# ---------------------------------------------------------------------------

def _full_yi(num_layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("yi-9b"), num_layers=num_layers)


def _layer_gemms(cfg):
    """(k, n) of every weight GEMM of one layer, in the per-layer
    emission's order (an MoE layer's experts E times)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.arch_type == "ssm":
        s = cfg.ssm
        d_inner = s.expand * d
        return [(d, 2 * d_inner + 2 * s.d_state + s.num_heads(d)),
                (d_inner, d)]
    attn = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
            (d, cfg.num_kv_heads * hd), (cfg.num_heads * hd, d)]
    ffn = [(d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    if cfg.arch_type == "moe":
        return attn + ffn * cfg.moe.num_experts
    return attn + ffn


def _gemms_a_layer(cfg):
    """Weight GEMMs of one layer: GEMM stages a layer of a per-layer
    program, kernel launches a layer of a stacked body (7 dense, 4 + 3E
    MoE, 2 SSM)."""
    return len(_layer_gemms(cfg))


def _layer_bytes(cfg, db):
    """(param bytes, padded-pack bytes) of one decoder layer: its GEMM
    weights (an MoE layer's router in fp32 besides) and their packs padded
    to the executor's (K, N) envelope."""
    from repro_torch.kernels.ops import envelope_bucket as eb
    d = cfg.d_model
    shapes = _layer_gemms(cfg)
    params = sum(k * n for k, n in shapes) * db + 2 * d * db
    if cfg.arch_type == "moe":
        params += d * cfg.moe.num_experts * 4
    packs = sum(eb(k) * eb(n) for k, n in shapes) * db
    return params, packs


def _embed_bytes(cfg, db):
    """(embed and unembed bytes, unembed pack bytes)."""
    from repro_torch.kernels.ops import envelope_bucket as eb
    V, d = cfg.padded_vocab, cfg.d_model
    tables = (1 if cfg.tie_embeddings else 2) * V * d * db
    return tables, eb(d) * eb(V) * db


def _decode_builder(cfg):
    """The family's decode-template builder."""
    from repro_torch.core import jit
    return {"moe": jit.build_moe_decode_template,
            "ssm": jit.build_ssm_decode_template}.get(
        cfg.arch_type, jit.build_dense_decode_template)


REGIMES = ((True, "stacked"), (False, "per-layer"))


def _serve(torch, cfg, tenants_params, *, n_req, prompt_len, new_tokens,
           budget, seed, stacked=True, max_batch=None, **engine_kw):
    """Serve one trace (``n_req`` requests a tenant) on a fresh vliw
    engine; ``max_batch`` gives each tenant's slots (4 each by default),
    ``engine_kw`` the engine's other options (the mesh, the certifier)."""
    from repro_torch.serving import ServingEngine, Tenant, make_trace
    names = [f"t{i}" for i in range(len(tenants_params))]
    trace = make_trace(names, rate_hz=1e4, n_per_tenant=n_req,
                       prompt_len=prompt_len, max_new_tokens=new_tokens,
                       slo_s=1.0, seed=seed)
    tenants = [Tenant(n, m, p, cache_len=prompt_len + new_tokens + 8,
                      max_batch=mb)
               for n, (m, p), mb in zip(names, tenants_params,
                                        max_batch or [4] * len(names))]
    # per-layer emission declares 7 weights a layer: room for every
    # packed entry of both regimes (shared and singleton) of 48 layers
    eng = ServingEngine(tenants, mode="vliw", weight_budget_bytes=budget,
                        plan_capacity=1024, stacked_layers=stacked,
                        device=tenants_params[0][0].device, **engine_kw)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run(trace, seed=seed)       # ends in a synchronize
    wall = time.perf_counter() - t0
    return eng, rep, wall


def _programs(cfg, rep, stacked):
    """Programs run: a per-layer program dispatches g GEMM stages a layer
    (``_gemms_a_layer``) and its unembed, a stacked one one op a body and
    its unembed. Either launches g * L + 1 GEMMs."""
    ops = len(_spans(cfg)) + 1 if stacked \
        else _gemms_a_layer(cfg) * cfg.num_layers + 1
    return rep.jit.ops_executed / ops


def _spans(cfg):
    """The layer bodies of a stacked program: one a homogeneous sub-stack;
    an SSM model is one body."""
    from repro_torch.core.jit import partition_layers
    if cfg.arch_type == "ssm":
        return [(0, cfg.num_layers)]
    return partition_layers(cfg.global_layer_flags())


def _check_launches(cfg, rep, launches, stacked):
    """Per-layer: one launch a scheduler dispatch. Stacked: one launch a
    plain-op dispatch (the unembeds) plus g a layer of every body run (7
    dense, 4 + 3E MoE, 2 SSM). ``dispatch.dispatches`` counts each plain
    dispatch once and each body once, so the bodies are the programs times
    the sub-stacks."""
    j = rep.jit
    if not stacked:
        assert launches == j.superkernels, (launches, j.superkernels)
        return
    programs = round(_programs(cfg, rep, True))
    bodies = programs * len(_spans(cfg))
    plain = j.dispatch.dispatches - bodies
    want = plain + _gemms_a_layer(cfg) * cfg.num_layers * programs
    assert launches == want, (launches, want, plain, bodies)


def _report_serve(torch, phase, cfg, rep, wall, launches, max_groups,
                  regime):
    j = rep.jit
    programs = _programs(cfg, rep, regime == "stacked")
    toks = rep.tokens_out
    g = _gemms_a_layer(cfg)
    say(phase, regime=regime, wall_s=f"{wall:.3f}", tokens=toks,
        tokens_per_s=f"{toks / wall:.2f}",
        scheduler_dispatches=j.superkernels, launches=launches,
        ops=j.ops_executed, programs=f"{programs:.1f}",
        launches_per_program=f"{launches / programs:.1f}"
                             f"({g}*L+1={g * cfg.num_layers + 1})",
        mean_group=f"{j.mean_group:.3f}", shared=j.shared_dispatches,
        prefill_coalesced=j.prefill_coalesced,
        expert_coalesced=j.expert_coalesced,
        nondense_programs=j.nondense_programs,
        weight_hit_rate=f"{j.dispatch.weight_hit_rate:.4f}",
        weight_invalidations=j.dispatch.weight_invalidations,
        kernel_builds=j.dispatch.retraces, max_G=max_groups,
        peak_alloc_GiB=f"{torch.cuda.max_memory_allocated() / GIB:.2f}",
        modeled_ms=f"{rep.modeled_time_s * 1e3:.3f}(H100 cost model)")


def _reset_counts(cg):
    cg.coalesced_gemm.launches = 0
    cg.coalesced_gemm.max_groups = 0
    cg.coalesced_gemm.launches_by_shape = {}


def _report_shapes(phase, cg, timed):
    """One line per (M, K, N, G, dtype) the phase launched, most launched
    first, each marked by whether phase 3 times that shape."""
    out = []
    for (M, K, N, G, dtype), n in sorted(
            cg.coalesced_gemm.launches_by_shape.items(),
            key=lambda kv: (-kv[1], kv[0][:4])):
        dname = str(dtype).removeprefix("torch.")
        say(phase, gemm_shape=f"M{M}_K{K}_N{N}_G{G}_{dname}", launches=n,
            timed_in_phase3=(M, K, N, G, dname) in timed)
        out.append(dict(M=M, K=K, N=N, G=G, dtype=dname, launches=n))
    return out


def _check_served(rep, cfg, n_expected, new_tokens):
    assert len(rep.requests) == n_expected and rep.unfinished == 0, \
        (len(rep.requests), rep.unfinished)
    for r in rep.requests:
        assert r.tokens_out is not None and len(r.tokens_out) == new_tokens, \
            (r.req_id, r.tokens_out)
        assert all(0 <= t < cfg.padded_vocab for t in r.tokens_out)


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _serve_regimes(torch, cg, timed, phase, cfg, tenants_params, *, seed,
                   budget, check, after=None):
    """Serve one trace in both regimes, stacked first, each engine freed
    before the next; the tokens must be identical. ``check(rep, launches,
    max_G, regime)`` holds each run to its phase's assertions; ``after(eng,
    rep)`` runs while the stacked engine is alive."""
    out, tokens = {}, {}
    for stacked, regime in REGIMES:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(cg)
        eng, rep, wall = _serve(torch, cfg, tenants_params, n_req=4,
                                prompt_len=32, new_tokens=8,
                                budget=budget, seed=seed,
                                stacked=stacked)
        launches = cg.coalesced_gemm.launches
        max_g = cg.coalesced_gemm.max_groups
        _check_served(rep, cfg, 8, 8)
        _check_launches(cfg, rep, launches, stacked)
        check(rep, launches, max_g, regime)
        _report_serve(torch, phase, cfg, rep, wall, launches, max_g, regime)
        by_shape = _report_shapes(f"{phase} ({regime})", cg, timed)
        tokens[regime] = {r.req_id: r.tokens_out for r in rep.requests}
        programs = _programs(cfg, rep, stacked)
        out[regime] = dict(
            launches=launches, max_groups=max_g, wall_s=wall,
            tokens=rep.tokens_out, tokens_per_s=rep.tokens_out / wall,
            scheduler_dispatches=rep.jit.superkernels,
            launches_per_program=launches / programs,
            weight_hit_rate=rep.jit.dispatch.weight_hit_rate,
            peak_alloc_GiB=torch.cuda.max_memory_allocated() / GIB,
            expert_coalesced=rep.jit.expert_coalesced,
            nondense_programs=rep.jit.nondense_programs,
            launches_by_shape=by_shape)
        if after is not None and stacked:
            out.update(after(eng, rep))
        del eng, rep
        _free(torch)
    assert tokens["stacked"] == tokens["per-layer"], tokens
    say(phase, tokens_stacked_vs_per_layer="identical",
        requests=len(tokens["stacked"]))
    return out


def phase_serve_shared(torch, cg, timed):
    from repro_torch.models import Model
    db = 2
    free, _ = torch.cuda.mem_get_info()
    cfg48 = _full_yi(48)
    p_layer, k_layer = _layer_bytes(cfg48, db)
    emb = cfg48.padded_vocab * cfg48.d_model * db
    fixed = 4 * emb                  # embed, unembed, two unembed packs
    margin = 6 * GIB                 # activations, workspaces, allocator
    # two pack sets: the per-layer run's shared and singleton packs, or the
    # stacked run's stacked packs and the extra step's per-layer packs
    L = min(48, int((free - margin - fixed) // (p_layer + 2 * k_layer)))
    if L < 48:
        say("serve-shared", depth_cut=f"48->{L}",
            reason=f"free={free / GIB:.1f}GiB holds params+2 packs of "
                   f"{L} layers only")
    assert L >= 1
    cfg = _full_yi(L)
    m = Model(cfg, param_dtype=torch.bfloat16)
    params = m.init(torch.Generator(device=m.device).manual_seed(1))
    budget = int(free - margin - L * p_layer - 2 * emb)
    say("serve-shared", layers=L, d_model=cfg.d_model, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
        param_GiB=f"{(L * p_layer + 2 * emb) / GIB:.2f}",
        pack_GiB_per_regime=f"{(L * k_layer + emb) / GIB:.2f}",
        weight_budget_GiB=f"{budget / GIB:.2f}")

    def check(rep, launches, max_g, regime):
        assert launches > 0
        assert rep.jit.shared_dispatches > 0 and rep.jit.mean_group > 1.0

    def after(eng, rep):
        return dict(
            extra_step=_extra_step(torch, eng, m, params, cfg,
                                   "serve-shared"),
            profile=phase_profile(torch, eng, m, params, "serve-shared"))

    out = _serve_regimes(torch, cg, timed, "serve-shared", cfg,
                         [(m, params), (m, params)], seed=0, budget=budget,
                         check=check, after=after)
    out["layers"] = L
    del params, m
    _free(torch)
    return out


def _extra_step(torch, eng, m, params, cfg, phase):
    """One more decode step of tenant 0 through a stacked and a per-layer
    template: finite logits of the expected shape, bitwise equal between
    the two, beside the plain Model.decode_step."""
    build = _decode_builder(cfg)
    t = eng.tenants["t0"]
    logits = {}
    for stacked, regime in REGIMES:
        prog = build(m, params, t.max_batch, stacked=stacked).bind(
            stream_id=0, tokens=t.slot_tok, cache=t.cache)
        eng.jit.run([prog])
        logits[regime] = prog.env["logits"]
    got = logits["stacked"].float()
    assert tuple(got.shape) == (t.max_batch, cfg.padded_vocab)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(logits["stacked"], logits["per-layer"])
    want, _ = m.decode_step(params, t.slot_tok, t.cache)
    diff = float((got - want[:, 0].float()).abs().max())
    agree = float((got.argmax(-1) == want[:, 0].argmax(-1)).float().mean())
    say(phase, extra_step_logits="finite",
        stacked_vs_per_layer="bitwise_equal",
        max_abs_diff_vs_Model_decode_step_bf16=f"{diff:.4f}",
        argmax_agreement=f"{agree:.2f}")
    return dict(max_abs_diff_vs_decode_step=diff, argmax_agreement=agree)


def _device_split(prof):
    """(coalesced_gemm µs, other device µs) summed over the profiled
    window's device events."""
    from torch.autograd import DeviceType
    gemm = other = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if "gemm_kernel" in e.name:
            gemm += us
        else:
            other += us
    return gemm, other


def _host_split(prof, steps):
    """(top-level host events a step, their host ms a step, the five
    costliest by name as 'name:ms:calls' a step): the torch ops and CUDA
    runtime calls the host makes, under the profiler (which slows each
    one). Host time outside them is Python: the scheduler, the glue
    closures, the wrappers' own code."""
    from torch.autograd import DeviceType
    top = [e for e in prof.events()
           if e.device_type == DeviceType.CPU and e.cpu_parent is None]
    by_name = {}
    for e in top:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.cpu_time_total / 1e3, n + 1)
    costly = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return (len(top) / steps,
            sum(ms for ms, _ in by_name.values()) / steps,
            ",".join(f"{k}:{ms / steps:.2f}:{n // steps}"
                     for k, (ms, n) in costly))


def phase_profile(torch, eng, m, params, phase, steps=3):
    """Host and device time of one decode step of tenant 0 at the serving
    phase's shape, through a stacked and a per-layer template, in a steady
    state
    (packs built, warmed). Host ms: until ``VLIWJit.run`` returns; wall ms:
    until the card has finished (synchronize). Then the same steps under
    ``torch.profiler`` (CPU and CUDA activities) for the device time of
    ``coalesced_gemm`` and of every other kernel (the glue); device busy
    share = device time / wall. If the profiler records no device time,
    CUDA events give the device span of a step instead (idle gaps
    included), and the line says so."""
    from torch.profiler import ProfilerActivity, profile
    build = _decode_builder(m.cfg)
    t = eng.tenants["t0"]
    out = {}
    for stacked, regime in REGIMES:
        tmpl = build(m, params, t.max_batch, stacked=stacked)

        def step():
            eng.jit.run([tmpl.bind(stream_id=0, tokens=t.slot_tok,
                                   cache=t.cache)])

        step()
        torch.cuda.synchronize()
        host, wall = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        host_ms = 1e3 * statistics.median(host)
        wall_ms = 1e3 * statistics.median(wall)
        source = "torch.profiler"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        gemm_us, other_us = _device_split(prof)
        n_host, host_ops_ms, costly = _host_split(prof, steps)
        say("profile", path=phase, regime=regime,
            host_events_per_step=f"{n_host:.0f}",
            host_ms_in_them_per_step=f"{host_ops_ms:.3f}(profiled)",
            costliest=costly)
        if gemm_us + other_us == 0.0:
            source = "cuda_events(no device time from the profiler)"
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            for _ in range(steps):
                step()
            e_ev.record()
            torch.cuda.synchronize()
            other_us = 1e3 * s_ev.elapsed_time(e_ev)
        gemm_ms, glue_ms = gemm_us / 1e3 / steps, other_us / 1e3 / steps
        busy = (gemm_ms + glue_ms) / wall_ms
        say("profile", path=phase, regime=regime, batch=t.max_batch,
            layers=m.cfg.num_layers, steps=steps,
            host_ms_per_step=f"{host_ms:.3f}",
            wall_ms_per_step=f"{wall_ms:.3f}",
            coalesced_gemm_device_ms_per_step=f"{gemm_ms:.3f}",
            other_kernels_device_ms_per_step=f"{glue_ms:.3f}",
            device_busy_share=f"{busy:.3f}", source=source)
        out[regime] = dict(host_ms=host_ms, wall_ms=wall_ms,
                           gemm_device_ms=gemm_ms, glue_device_ms=glue_ms,
                           device_busy_share=busy, source=source)
    return out


def phase_serve_grouped(torch, cg, timed):
    from repro_torch.models import Model
    L = 12
    cfg = _full_yi(L)
    free, _ = torch.cuda.mem_get_info()
    p_layer, _ = _layer_bytes(cfg, 2)
    emb = cfg.padded_vocab * cfg.d_model * 2
    params_bytes = 2 * (L * p_layer + 2 * emb)
    budget = int(free - params_bytes - 6 * GIB)
    tp = []
    for i in range(2):
        m = Model(cfg, param_dtype=torch.bfloat16)
        tp.append((m, m.init(torch.Generator(device=m.device)
                             .manual_seed(10 + i))))
    say("serve-grouped", layers=L, tenants=2, weights="distinct",
        param_GiB=f"{params_bytes / GIB:.2f}",
        weight_budget_GiB=f"{budget / GIB:.2f}")

    def check(rep, launches, max_g, regime):
        assert launches > 0
        assert rep.jit.shared_dispatches == 0 and rep.jit.mean_group > 1.0
        if regime == "per-layer":
            assert max_g >= 2, (launches, max_g)

    out = _serve_regimes(torch, cg, timed, "serve-grouped", cfg, tp, seed=1,
                         budget=budget, check=check)
    del tp
    _free(torch)
    return out


def phase_card_vs_cpu(torch, cg):
    from repro_torch.core.jit import VLIWJit, build_dense_prefill_template
    from repro_torch.models import Model
    cfg = _full_yi(1)
    m_gpu = Model(cfg, param_dtype=torch.float32)
    m_cpu = Model(cfg, param_dtype=torch.float32, device="cpu")
    # two distinct weight sets: the card's per-layer run goes through the
    # grouped regime (stacked packs, device group ids, G_pad padding), not
    # only the shared one
    params = [m_gpu.init(torch.Generator(device=m_gpu.device)
                         .manual_seed(2 + i)) for i in range(2)]

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    params_cpu = [to_cpu(p) for p in params]
    result, toks = {}, {}
    for stacked, regime in REGIMES:
        for m, ps in ((m_gpu, params), (m_cpu, params_cpu)):
            _reset_counts(cg)
            _, rep, wall = _serve(torch, cfg, [(m, p) for p in ps], n_req=2,
                                  prompt_len=16, new_tokens=4,
                                  budget=8 * GIB, seed=2, stacked=stacked)
            _check_served(rep, cfg, 4, 4)
            toks[regime, m.device.type] = {r.req_id: r.tokens_out
                                           for r in rep.requests}
            launches = cg.coalesced_gemm.launches
            max_g = cg.coalesced_gemm.max_groups
            if m is m_gpu:
                assert launches > 0, launches
                _check_launches(cfg, rep, launches, stacked)
                if not stacked:
                    assert max_g >= 2, (launches, max_g)
                result[regime] = dict(launches=launches, max_groups=max_g)
            say("card-vs-cpu", regime=regime, device=m.device.type,
                wall_s=f"{wall:.3f}", launches=launches, max_G=max_g,
                scheduler_dispatches=rep.jit.superkernels,
                mean_group=f"{rep.jit.mean_group:.3f}",
                shared=rep.jit.shared_dispatches)
        assert toks[regime, "cuda"] == toks[regime, "cpu"], toks
    assert toks["stacked", "cuda"] == toks["per-layer", "cuda"], toks
    # logits of one prompt pass through the kernel path on both devices
    prompt = torch.randint(0, cfg.vocab_size, (1, 32),
                           generator=torch.Generator().manual_seed(3))
    diff = 0.0
    for stacked, regime in REGIMES:
        logits = {}
        for m, p in ((m_gpu, params[0]), (m_cpu, params_cpu[0])):
            cache = m.init_cache(1, 40)
            prog = build_dense_prefill_template(
                m, p, 32, stacked=stacked).bind(
                stream_id=0, tokens=prompt.to(m.device), cache=cache,
                env_extra={"real_len": 32, "slot": 0})
            VLIWJit().run([prog])
            logits[m.device.type] = prog.env["logits"].float().cpu()
        assert bool(torch.isfinite(logits["cuda"]).all())
        torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=2e-4,
                                   atol=2e-4)
        diff = max(diff, float((logits["cuda"] - logits["cpu"]).abs().max()))
    say("card-vs-cpu", tokens="identical(cuda=cpu, stacked=per-layer)",
        requests=len(toks["stacked", "cpu"]),
        max_abs_logit_diff=f"{diff:.3e}")
    del params, params_cpu, m_gpu, m_cpu
    _free(torch)
    result["max_abs_logit_diff"] = diff
    return result


def _full(arch, num_layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=num_layers)


def _nondense_plan(torch, phase, arch, want_layers, db, margin):
    """Depth, reckoned bytes and weight budget of a MoE / SSM serving phase
    at full width: ``want_layers`` unless params, one regime's packs, the
    largest single pack (built while the cache is full) and ``margin`` do
    not fit in the card's free memory, in which case the depth is cut and
    the cut printed. The budget leaves room for that largest pack."""
    from repro_torch.kernels.ops import envelope_bucket as eb
    free, total = torch.cuda.mem_get_info()
    cfg1 = _full(arch, 1)
    p_layer, k_layer = _layer_bytes(cfg1, db)
    tables, emb_pack = _embed_bytes(cfg1, db)
    mult = cfg1.moe.num_experts if cfg1.arch_type == "moe" else 1
    pack_layer = mult * max(eb(k) * eb(n) for k, n in _layer_gemms(cfg1)) \
        * db

    def need(L):
        return (L * p_layer + tables, L * k_layer + emb_pack, L * pack_layer)

    L = want_layers
    while L > 1 and sum(need(L)) + margin > free:
        L -= 1
    params, packs, largest = need(L)
    if L < want_layers:
        say(phase, depth_cut=f"{want_layers}->{L}",
            reason=f"free={free / GIB:.1f}GiB holds params, one regime's "
                   f"packs and its largest pack of {L} layers only")
    assert params + packs + largest + margin <= free, (params, packs, free)
    budget = int(free - margin - params - largest)
    return _full(arch, L), dict(
        free_GiB=free / GIB, total_GiB=total / GIB, param_GiB=params / GIB,
        pack_GiB_per_regime=packs / GIB, largest_pack_GiB=largest / GIB,
        layer_param_GiB=p_layer / GIB, layer_pack_GiB=k_layer / GIB,
        weight_budget_GiB=budget / GIB), budget


def _serve_nondense(torch, cg, timed, phase, arch, want_layers, seed):
    """Two tenants sharing one full-width MoE or SSM weight set (bf16),
    served in both regimes as serve-shared is, with the extra step (stacked
    logits bitwise equal to per-layer) and the profile of one step."""
    from repro_torch.models import Model
    cfg, plan, budget = _nondense_plan(torch, phase, arch, want_layers, 2,
                                       6 * GIB)
    m = Model(cfg, param_dtype=torch.bfloat16)
    params = m.init(torch.Generator(device=m.device).manual_seed(seed))
    torch.cuda.synchronize()
    free_after, _ = torch.cuda.mem_get_info()
    widths = dict(d_model=cfg.d_model, vocab=cfg.vocab_size)
    if cfg.arch_type == "moe":
        widths.update(d_ff=cfg.d_ff, experts=cfg.moe.num_experts,
                      top_k=cfg.moe.top_k,
                      heads=f"{cfg.num_heads}/{cfg.num_kv_heads}")
    else:
        s = cfg.ssm
        widths.update(d_state=s.d_state, head_dim=s.head_dim,
                      ssm_heads=s.num_heads(cfg.d_model), expand=s.expand)
    say(phase, layers=cfg.num_layers, **widths,
        **{k: f"{v:.2f}" for k, v in plan.items()},
        mem_get_info_free_GiB_after_init=f"{free_after / GIB:.2f}",
        params_allocated_GiB=f"{torch.cuda.memory_allocated() / GIB:.2f}")

    def check(rep, launches, max_g, regime):
        assert launches > 0
        assert rep.jit.nondense_programs > 0, rep.jit.nondense_programs
        assert rep.jit.shared_dispatches > 0 and rep.jit.mean_group > 1.0
        if cfg.arch_type == "moe" and regime == "per-layer":
            # the two tenants' expert GEMMs share operands
            assert rep.jit.expert_coalesced > 0, rep.jit.expert_coalesced

    def after(eng, rep):
        return dict(extra_step=_extra_step(torch, eng, m, params, cfg, phase),
                    profile=phase_profile(torch, eng, m, params, phase))

    out = _serve_regimes(torch, cg, timed, phase, cfg,
                         [(m, params), (m, params)], seed=seed, budget=budget,
                         check=check, after=after)
    out.update(layers=cfg.num_layers, plan=plan)
    del params, m
    _free(torch)
    return out


def phase_serve_moe(torch, cg, timed):
    # grok-1 at full width: one layer's experts are 9.66 GB of bf16, so the
    # depth is cut from 64 to 2 (params and one regime's packs fit twice
    # over in 80 GB at 2 layers, not at 3)
    return _serve_nondense(torch, cg, timed, "serve-moe", "grok-1-314b", 2,
                           seed=20)


def phase_serve_ssm(torch, cg, timed):
    # mamba2-2.7b at full width and full depth (64 layers)
    return _serve_nondense(torch, cg, timed, "serve-ssm", "mamba2-2.7b", 64,
                           seed=21)


class _RouteLog:
    """Records every MoE routing decision while it is active: the chosen
    experts and the smallest top-k margin (the k-th largest router
    probability minus the next) over the call's tokens. It wraps
    ``models.moe.route``, which the templates' glue and ``moe_ffn`` call
    through the module, and computes nothing the path uses."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route
        torch = self.torch

        def route(router, x, cfg):
            out = self.orig(router, x, cfg)
            probs = torch.softmax(x.float() @ router, dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            k = cfg.top_k
            margin = float((top[:, k - 1] - top[:, k]).min()) \
                if cfg.num_experts > k else math.inf
            self.calls.append((out[1].cpu(), margin))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig
        return False


def _first_difference(want, got):
    """(req_id, token index) of the first token where two runs differ."""
    for rid in sorted(want):
        a, b = want[rid], got.get(rid)
        if b is None or a != b:
            b = b or []
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return rid, i
    return None


def phase_card_vs_cpu_nondense(torch, cg):
    """card-vs-cpu for the MoE and SSM families: mamba2-2.7b at full width
    (fp32, 2 layers) and grok-1's smoke config (fp32; a full-width grok
    layer is 19 GB in fp32, which the CPU's plain path would stream every
    token), two tenants with distinct weights, both regimes: the same
    trace, weights and prompts give identical greedy tokens on the card
    and on the CPU. A mismatch prints the first differing step and, for
    MoE, the first routing call whose experts differ and its top-k
    margin, then fails."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    result = {}
    for arch, cfg, size in (
            ("mamba2-2.7b", _full("mamba2-2.7b", 2), "full width, 2 layers"),
            ("grok-1-314b", smoke_config("grok-1-314b"), "smoke config")):
        m_gpu = Model(cfg, param_dtype=torch.float32)
        m_cpu = Model(cfg, param_dtype=torch.float32, device="cpu")
        params = [m_gpu.init(torch.Generator(device=m_gpu.device)
                             .manual_seed(30 + i)) for i in range(2)]
        params_cpu = [to_cpu(p) for p in params]
        toks, routes = {}, {}
        for stacked, regime in REGIMES:
            for m, ps in ((m_gpu, params), (m_cpu, params_cpu)):
                dev = m.device.type
                _reset_counts(cg)
                with _RouteLog(torch) as log:
                    _, rep, wall = _serve(torch, cfg, [(m, p) for p in ps],
                                          n_req=2, prompt_len=16,
                                          new_tokens=4, budget=8 * GIB,
                                          seed=3, stacked=stacked)
                _check_served(rep, cfg, 4, 4)
                toks[regime, dev] = {r.req_id: r.tokens_out
                                     for r in rep.requests}
                routes[regime, dev] = log.calls
                launches = cg.coalesced_gemm.launches
                if dev == "cuda":
                    assert launches > 0, launches
                    _check_launches(cfg, rep, launches, stacked)
                    result[f"{arch} ({regime})"] = launches
                margin = min((mg for _, mg in log.calls), default=math.inf)
                say("card-vs-cpu", model=arch, size=size, dtype="float32",
                    regime=regime, device=dev, wall_s=f"{wall:.3f}",
                    launches=launches,
                    max_G=cg.coalesced_gemm.max_groups,
                    scheduler_dispatches=rep.jit.superkernels,
                    nondense_programs=rep.jit.nondense_programs,
                    expert_coalesced=rep.jit.expert_coalesced,
                    routing_calls=len(log.calls),
                    min_router_topk_margin=f"{margin:.3e}")
            diff = _first_difference(toks[regime, "cpu"],
                                     toks[regime, "cuda"])
            if diff is not None:
                card, cpu = routes[regime, "cuda"], routes[regime, "cpu"]
                j = next((j for j, (a, b) in enumerate(zip(card, cpu))
                          if not bool((a[0] == b[0]).all())), None)
                say("card-vs-cpu", model=arch, regime=regime,
                    mismatch=f"req {diff[0]} token {diff[1]}",
                    first_routing_divergence=j,
                    router_topk_margin_there="n/a" if j is None else
                    f"card {card[j][1]:.3e} cpu {cpu[j][1]:.3e}")
                raise AssertionError(f"card and CPU tokens differ: {arch} "
                                     f"{regime}: {diff}")
        assert toks["stacked", "cuda"] == toks["per-layer", "cuda"], toks
        say("card-vs-cpu", model=arch,
            tokens="identical(cuda=cpu, stacked=per-layer)",
            requests=len(toks["stacked", "cpu"]))
        del params, params_cpu, m_gpu, m_cpu
        _free(torch)
    return result


# ---------------------------------------------------------------------------
# 5d-5f. the full serving loop: the modelled mesh, the daemon, the CLI
# ---------------------------------------------------------------------------

def _placement(eng):
    """'name->device' for each tenant ('xN': experts spanning N devices)."""
    return ",".join(
        f"{name}->{pl.device}" + (f"(x{pl.expert_span})"
                                  if pl.expert_span > 1 else "")
        for name, pl in sorted(eng.placement.assignments.items()))


def _per_device(eng, n):
    """(dispatches, coalesced groups) per device, from the recorded trace."""
    disp, coal = [0] * n, [0] * n
    for rec in eng.last_trace.dispatches:
        disp[rec.device] += 1
        coal[rec.device] += int(len(rec.ops) > 1)
    return disp, coal


def _certify_ms_per_dispatch(eng):
    """Host ms the certifier takes a dispatch record, by replaying the
    run's trace through a fresh certifier (the engine runs the same
    checks incrementally, one tick's records at a time)."""
    from repro_torch.analysis import certify_trace
    trace = eng.last_trace
    t0 = time.perf_counter()
    cert = certify_trace(trace)
    ms = 1e3 * (time.perf_counter() - t0)
    return ms / max(len(trace.dispatches), 1), cert.checks


def _fleet_plan(torch, phase, fleet, db, margin):
    """Bytes of a mixed fleet at full width (``fleet``: (name, cfg,
    copies)), reckoned as ``_nondense_plan`` reckons one model: params, one
    regime's packs and the largest single pack (a stacked body's slot, built
    while the cache is full) beside the card's free memory. The yi-9b
    tenants' depth is cut, and the cut printed, until it fits; the budget
    leaves room for that largest pack."""
    from repro_torch.kernels.ops import envelope_bucket as eb
    free, total = torch.cuda.mem_get_info()

    def need(cfgs):
        params = packs = largest = 0
        for _, cfg, copies in cfgs:
            p_layer, k_layer = _layer_bytes(cfg, db)
            tables, emb_pack = _embed_bytes(cfg, db)
            mult = cfg.moe.num_experts if cfg.arch_type == "moe" else 1
            slot = mult * max(eb(k) * eb(n) for k, n in _layer_gemms(cfg))
            params += copies * (cfg.num_layers * p_layer + tables)
            packs += copies * (cfg.num_layers * k_layer + emb_pack)
            largest = max(largest, cfg.num_layers * slot * db)
        return params, packs, largest

    want = {name: cfg.num_layers for name, cfg, _ in fleet}
    while sum(need(fleet)) + margin > free:
        assert fleet[0][0] == "yi-9b" and fleet[0][1].num_layers > 1, \
            "the fleet does not fit"
        fleet = [(name, _full_yi(cfg.num_layers - 1)
                  if name == "yi-9b" else cfg, copies)
                 for name, cfg, copies in fleet]
    params, packs, largest = need(fleet)
    for name, cfg, _ in fleet:
        if cfg.num_layers < want[name]:
            say(phase, depth_cut=f"{name} {want[name]}->{cfg.num_layers}",
                reason=f"free={free / GIB:.1f}GiB holds params, one "
                       f"regime's packs and the largest pack only so")
    budget = int(free - margin - params - largest)
    return {name: cfg for name, cfg, _ in fleet}, dict(
        free_GiB=free / GIB, total_GiB=total / GIB, param_GiB=params / GIB,
        pack_GiB=packs / GIB, largest_pack_GiB=largest / GIB,
        weight_budget_GiB=budget / GIB), budget


def _check_fleet_launches(eng, rep, cfgs, launches):
    """``_check_launches`` for a stacked mixed fleet: one launch a plain
    dispatch plus g·L a program of each tenant (g its GEMMs a layer, L its
    depth). The programs a tenant ran are its admissions in the certified
    trace; its ops there must be its bodies plus its unembed a program.
    ``dispatch.dispatches`` counts each plain dispatch once and each body
    once. Returns the programs a tenant."""
    from collections import Counter
    trace = eng.last_trace
    progs = Counter(a.stream for a in trace.prog_admits)
    ops = Counter(op.stream for rec in trace.dispatches for op in rec.ops)
    bodies = body_launches = 0
    per_tenant = {}
    # stream ids follow the engine's tenant order
    for stream, (name, cfg) in enumerate(zip(eng.tenants, cfgs)):
        n, spans = progs[stream], len(_spans(cfg))
        assert ops[stream] == n * (spans + 1), (name, ops[stream], n, spans)
        bodies += n * spans
        body_launches += n * _gemms_a_layer(cfg) * cfg.num_layers
        per_tenant[name] = n
    plain = rep.jit.dispatch.dispatches - bodies
    want = plain + body_launches
    assert launches == want, (launches, want, plain, per_tenant)
    return per_tenant


def phase_serve_mesh(torch, cg):
    """Two full-width yi-9b tenants with distinct weights (bf16, 12 layers),
    mamba2-2.7b at full width and depth (bf16, 64 layers) and grok-1 at
    full width (bf16, 1 layer of 64; its 8 experts span a 2-device mesh, so
    it pays the modelled all-to-all at its real [m, 6144]), served stacked
    with ``certify=True`` on 1 and then 2 modelled devices: tokens
    identical, no hazard, launches as the programs predict. grok takes one
    request at a time (``max_batch=1``): an MoE step routes its whole
    slotted batch, so a row's tokens depend on its batchmates, and which
    rows share a step depends on the mesh's timelines."""
    from repro_torch.models import Model
    db = 2
    fleet = [("yi-9b", _full_yi(12), 2),
             ("mamba2-2.7b", _full("mamba2-2.7b", 64), 1),
             ("grok-1-314b", _full("grok-1-314b", 1), 1)]
    cfg_of, plan, budget = _fleet_plan(torch, "serve-mesh", fleet, db,
                                       6 * GIB)
    yi, ssm, grok = (cfg_of[k] for k in ("yi-9b", "mamba2-2.7b",
                                          "grok-1-314b"))
    say("serve-mesh", tenants=f"yi-9b({yi.num_layers}L,distinct)x2,"
        f"mamba2-2.7b({ssm.num_layers}L),grok-1-314b({grok.num_layers}L,"
        f"{grok.moe.num_experts}experts,d_model={grok.d_model})",
        dtype="bfloat16", **{k: f"{v:.2f}" for k, v in plan.items()})
    # t0, t1: yi-9b; t2: mamba2; t3: grok-1
    cfgs = (yi, yi, ssm, grok)
    tp = []
    for i, cfg in enumerate(cfgs):
        m = Model(cfg, param_dtype=torch.bfloat16)
        tp.append((m, m.init(torch.Generator(device=m.device)
                             .manual_seed(40 + i))))
    torch.cuda.synchronize()
    free_after, _ = torch.cuda.mem_get_info()
    say("serve-mesh",
        params_allocated_GiB=f"{torch.cuda.memory_allocated() / GIB:.2f}",
        mem_get_info_free_GiB_after_init=f"{free_after / GIB:.2f}")
    out, tokens = {}, {}
    for n in (1, 2):
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(cg)
        eng, rep, wall = _serve(torch, yi, tp, n_req=4, prompt_len=32,
                                new_tokens=8, budget=budget, seed=4,
                                max_batch=[4, 4, 4, 1], num_devices=n,
                                certify=True)
        launches = cg.coalesced_gemm.launches
        j = rep.jit
        assert rep.unfinished == 0 and launches > 0, (rep.unfinished,
                                                      launches)
        assert j.hazard_checks > 0 and j.hazard_violations == 0, \
            (j.hazard_checks, j.hazard_violations)
        assert (j.collective_time_s > 0) == (n > 1), j.collective_time_s
        assert rep.num_devices == n
        programs = _check_fleet_launches(eng, rep, cfgs, launches)
        disp, coal = _per_device(eng, n)
        cert_ms, _ = _certify_ms_per_dispatch(eng)
        toks = rep.tokens_out
        tokens[n] = {r.req_id: r.tokens_out for r in rep.requests}
        say("serve-mesh", num_devices=n, wall_s=f"{wall:.3f}", tokens=toks,
            tokens_per_s=f"{toks / wall:.2f}",
            scheduler_dispatches=j.superkernels, launches=launches,
            programs_per_tenant="/".join(map(str, programs.values())),
            launches_per_program="/".join(
                str(_gemms_a_layer(c) * c.num_layers + 1) for c in cfgs),
            dispatches_per_device="/".join(map(str, disp)),
            coalesced_per_device="/".join(map(str, coal)),
            device_util="/".join(f"{u:.3f}" for u in rep.device_util),
            device_skew=f"{rep.device_skew:.3f}",
            placement=_placement(eng),
            collective_us=f"{j.collective_time_s * 1e6:.3f}",
            hazard_checks=j.hazard_checks,
            hazard_violations=j.hazard_violations,
            certify_host_ms_per_dispatch=f"{cert_ms:.4f}",
            weight_hit_rate=f"{j.dispatch.weight_hit_rate:.4f}",
            modeled_ms=f"{rep.modeled_time_s * 1e3:.3f}(H100 cost model)",
            peak_alloc_GiB=f"{torch.cuda.max_memory_allocated() / GIB:.2f}")
        out[n] = dict(wall_s=wall, tokens=toks, tokens_per_s=toks / wall,
                      launches=launches, scheduler_dispatches=j.superkernels,
                      programs_per_tenant=programs,
                      dispatches_per_device=disp,
                      coalesced_per_device=coal,
                      device_util=rep.device_util,
                      device_skew=rep.device_skew,
                      placement=_placement(eng),
                      collective_time_s=j.collective_time_s,
                      hazard_checks=j.hazard_checks,
                      hazard_violations=j.hazard_violations,
                      certify_host_ms_per_dispatch=cert_ms)
        del eng, rep
        _free(torch)
    assert tokens[1] == tokens[2], tokens
    say("serve-mesh", tokens_1_vs_2_devices="identical",
        requests=len(tokens[1]))
    del tp
    _free(torch)
    out.update(plan=plan, layers={k: c.num_layers for k, c in cfg_of.items()})
    return out


def _check_tickets(tickets, rep):
    """Every submitted request finished or shed, ticket streams equal to
    the report's tokens, no tokens on a shed request."""
    by_id = {r.req_id: r for r in rep.requests}
    assert set(tickets) == set(by_id), (len(tickets), len(by_id))
    for rid, tk in tickets.items():
        r = by_id[rid]
        assert r.shed or not math.isnan(r.finish_t), rid
        if r.shed:
            assert not tk.tokens and r.tokens_out is None, rid
        else:
            assert tk.tokens == r.tokens_out, rid
    streamed = sum(len(tk.tokens) for tk in tickets.values())
    assert streamed == rep.tokens_out, (streamed, rep.tokens_out)
    return streamed


def serve_daemon(torch, cg, eng, *, rate_hz, n_req, prompt_len, new_tokens,
                 seed, stats_interval_s=1.0):
    """The daemon's three runs on one engine (tenants t0, t1), each with
    the counts set to 0 just before it and read just after:

      1. a door preloaded with 8 scheduled requests on a ``VirtualClock``
         against ``run()`` of the same trace (tokens and finish times
         bitwise equal);
      2. one request of the daemon's shape served alone (``run``): its
         real seconds set the SLOs;
      3. a ``MonotonicClock`` door fed by a thread: ``n_req`` live Poisson
         submissions at ``rate_hz``, tiers 0/1/2 (p 0.5/0.3/0.2) with SLOs
         1x/2x/4x the alone request's real seconds; the door closes after
         the last one. Each request's submission instant on the door's
         clock is recorded in the feeder, and each token's host instant in
         the ticket callback beside the engine's stamp: real TTFT runs
         from the submission, while the request's ``arrival_t`` is stamped
         when the serving loop next polls the door.
    """
    import threading
    import numpy as np
    from repro_torch.serving import (FrontDoor, MonotonicClock,
                                     ServeRequest, VirtualClock, make_trace)
    out = {}
    # 1. virtual clock against run(), at the real clock's rate: a denser
    #    trace is overload to the controller's arrival forecast (it sheds
    #    5 of 8 requests at 1e4 req/s)
    trace = make_trace(["t0", "t1"], rate_hz=rate_hz, n_per_tenant=4,
                       prompt_len=prompt_len, max_new_tokens=new_tokens,
                       slo_s=1.0, seed=seed)
    _reset_counts(cg)
    rep_run = eng.run(trace, seed=seed)
    launches_run = cg.coalesced_gemm.launches
    door = FrontDoor()
    for r in trace:
        door.submit(ServeRequest(r.req_id, r.tenant, r.arrival_t,
                                 r.prompt_len, r.max_new_tokens, r.slo_s),
                    at=r.arrival_t)
    door.close(at=max(r.arrival_t for r in trace))
    _reset_counts(cg)
    rep_door = eng.serve_forever(door, clock=VirtualClock(), seed=seed)
    launches_door = cg.coalesced_gemm.launches
    # repr: a shed request's finish time is nan, which equals nothing
    want = {r.req_id: (r.tokens_out, repr(r.finish_t), r.shed)
            for r in rep_run.requests}
    got = {r.req_id: (r.tokens_out, repr(r.finish_t), r.shed)
           for r in rep_door.requests}
    assert got == want, (got, want)
    assert rep_door.unfinished == 0 and rep_door.jit.hazard_violations == 0
    say("serve-daemon", clock="virtual", requests=len(got),
        tokens_and_finish_times_vs_run="bitwise_equal",
        launches_run=launches_run, launches_door=launches_door,
        shed=rep_door.shed, wall_s_run=f"{rep_run.wall_time_s:.3f}",
        wall_s_door=f"{rep_door.wall_time_s:.3f}")
    out["virtual"] = dict(requests=len(got), launches_run=launches_run,
                          launches_door=launches_door)
    # 2. one request alone
    alone_req = ServeRequest(10_000, "t0", 0.0, prompt_len, new_tokens, 1e3)
    _reset_counts(cg)
    rep_alone = eng.run([alone_req], seed=seed)
    alone_s = rep_alone.wall_time_s
    cost_s = eng._request_cost_s(eng.tenants["t0"], alone_req)
    lat_model = rep_alone.requests[0].latency
    say("serve-daemon", alone_request=f"prompt {prompt_len}, "
        f"{new_tokens} new tokens", real_s=f"{alone_s:.4f}",
        modeled_cost_s=f"{cost_s:.6f}(admission's _request_cost_s)",
        modeled_latency_s=f"{lat_model:.6f}(H100 cost model)",
        real_over_modeled_cost=f"{alone_s / cost_s:.1f}",
        launches=cg.coalesced_gemm.launches)
    out["alone"] = dict(real_s=alone_s, modeled_cost_s=cost_s,
                        modeled_latency_s=lat_model)
    # 3. the real clock
    slo = (1.0 * alone_s, 2.0 * alone_s, 4.0 * alone_s)
    clock = MonotonicClock()
    door = FrontDoor()
    stamps = {}          # req_id -> [(engine stamp, host instant)]
    tickets, submitted_at = {}, {}

    def feeder():
        rng = np.random.default_rng(seed)
        t = 0.0
        for i in range(n_req):
            t += rng.exponential(1.0 / rate_hz)
            pause = t - clock.now()
            if pause > 0:
                time.sleep(pause)
            tier = int(rng.choice(3, p=[0.5, 0.3, 0.2]))
            submitted_at[i] = clock.now()
            tickets[i] = door.submit(
                ServeRequest(i, ("t0", "t1")[i % 2], 0.0, prompt_len,
                             new_tokens, slo_s=slo[tier], tier=tier),
                on_token=lambda tok, ts, i=i: stamps.setdefault(
                    i, []).append((ts, clock.now())))
        door.close()

    def heartbeat(stats):
        say("serve-daemon", heartbeat=f"t={stats['t']:.2f}s",
            submitted=stats["submitted"], finished=stats["finished"],
            shed=stats["shed"], inflight=stats["inflight"],
            waiting=stats["waiting"])

    th = threading.Thread(target=feeder, daemon=True)
    _reset_counts(cg)
    th.start()
    rep = eng.serve_forever(door, clock=clock, seed=seed, on_stats=heartbeat,
                            stats_interval_s=stats_interval_s)
    th.join(timeout=60)
    assert not th.is_alive()
    launches = cg.coalesced_gemm.launches
    assert len(rep.requests) == n_req, len(rep.requests)
    streamed = _check_tickets(tickets, rep)
    not_shed_unfinished = rep.unfinished - rep.shed
    assert not_shed_unfinished == 0, not_shed_unfinished
    j = rep.jit
    assert j.hazard_checks > 0 and j.hazard_violations == 0, \
        (j.hazard_checks, j.hazard_violations)
    by_id = {r.req_id: r for r in rep.requests}
    # real TTFT from the submission; beside it the wait for the loop's
    # poll, and TTFT from the poll-stamped arrival (host instant, engine
    # stamp), which leaves that wait out
    ttft, poll_wait, ttft_poll, ttft_model = [], [], [], []
    gaps, gaps_model = [], []
    for rid, st in stamps.items():
        arr = by_id[rid].arrival_t
        ttft.append(st[0][1] - submitted_at[rid])
        poll_wait.append(arr - submitted_at[rid])
        ttft_poll.append(st[0][1] - arr)
        ttft_model.append(st[0][0] - arr)
        gaps += [b[1] - a[1] for a, b in zip(st, st[1:])]
        gaps_model += [b[0] - a[0] for a, b in zip(st, st[1:])]
    assert min(poll_wait) >= 0.0, min(poll_wait)
    q_ttft, q_wait, q_ttft_p, q_gap, q_ttft_m, q_gap_m = (
        np.quantile(xs, [0.5, 0.99]) for xs in (
            ttft, poll_wait, ttft_poll, gaps, ttft_model, gaps_model))
    tiers = rep.tier_attainment()
    say("serve-daemon", clock="monotonic", submitted=n_req,
        rate_req_per_s=rate_hz, slo_s="/".join(f"{s:.3f}" for s in slo),
        finished=len(rep.finished), shed=rep.shed,
        unfinished=not_shed_unfinished,
        degraded=sum(r.degraded_from is not None for r in rep.requests),
        attainment=f"{rep.slo_attainment:.3f}",
        tier_attainment=",".join(f"{k}:{v:.3f}" for k, v in tiers.items()),
        goodput_rps=f"{rep.goodput_rps:.3f}", wall_s=f"{rep.wall_time_s:.3f}",
        tokens_streamed=streamed, launches=launches,
        hazard_checks=j.hazard_checks, hazard_violations=j.hazard_violations)
    say("serve-daemon", real_ttft_p50_s=f"{q_ttft[0]:.4f}",
        real_ttft_p99_s=f"{q_ttft[1]:.4f}",
        poll_wait_p50_s=f"{q_wait[0]:.4f}",
        poll_wait_p99_s=f"{q_wait[1]:.4f}",
        ttft_from_poll_p50_s=f"{q_ttft_p[0]:.4f}",
        ttft_from_poll_p99_s=f"{q_ttft_p[1]:.4f}",
        real_per_token_p50_s=f"{q_gap[0]:.4f}",
        real_per_token_p99_s=f"{q_gap[1]:.4f}",
        engine_stamp_ttft_p50_s=f"{q_ttft_m[0]:.4f}",
        engine_stamp_ttft_p99_s=f"{q_ttft_m[1]:.4f}",
        engine_stamp_per_token_p50_s=f"{q_gap_m[0]:.4f}",
        engine_stamp_per_token_p99_s=f"{q_gap_m[1]:.4f}",
        alone_real_s=f"{alone_s:.4f}",
        alone_modeled_cost_s=f"{cost_s:.6f}")
    out["real"] = dict(
        submitted=n_req, finished=len(rep.finished), shed=rep.shed,
        attainment=rep.slo_attainment, tier_attainment=tiers,
        goodput_rps=rep.goodput_rps, wall_s=rep.wall_time_s,
        launches=launches, hazard_checks=j.hazard_checks,
        ttft_p50_s=q_ttft[0], ttft_p99_s=q_ttft[1],
        poll_wait_p50_s=q_wait[0], poll_wait_p99_s=q_wait[1],
        ttft_from_poll_p50_s=q_ttft_p[0], ttft_from_poll_p99_s=q_ttft_p[1],
        per_token_p50_s=q_gap[0], per_token_p99_s=q_gap[1],
        engine_ttft_p50_s=q_ttft_m[0], engine_ttft_p99_s=q_ttft_m[1],
        engine_per_token_p50_s=q_gap_m[0],
        engine_per_token_p99_s=q_gap_m[1])
    return out


def phase_serve_daemon(torch, cg):
    """Two tenants sharing one full-width yi-9b weight set (bf16, 48 layers
    unless the card's free memory forces a cut, as serve-shared), served
    by ``serve_forever`` with ``num_devices=2``, ``certify=True`` and
    ``admission_control=True`` (``serve_daemon``)."""
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine, Tenant
    db = 2
    free, _ = torch.cuda.mem_get_info()
    cfg48 = _full_yi(48)
    p_layer, k_layer = _layer_bytes(cfg48, db)
    emb = cfg48.padded_vocab * cfg48.d_model * db
    margin = 6 * GIB
    # one stacked pack set a device: each tenant is homed on its own
    # device, and the weight cache keys every pack by device
    L = min(48, int((free - margin - 4 * emb) // (p_layer + 2 * k_layer)))
    if L < 48:
        say("serve-daemon", depth_cut=f"48->{L}",
            reason=f"free={free / GIB:.1f}GiB holds params+2 packs of "
                   f"{L} layers only")
    cfg = _full_yi(L)
    m = Model(cfg, param_dtype=torch.bfloat16)
    params = m.init(torch.Generator(device=m.device).manual_seed(1))
    budget = int(free - margin - L * p_layer - 2 * emb)
    eng = ServingEngine(
        [Tenant(n, m, params, cache_len=48, max_batch=4)
         for n in ("t0", "t1")], mode="vliw", num_devices=2, certify=True,
        admission_control=True, weight_budget_bytes=budget,
        plan_capacity=1024, device=m.device)
    say("serve-daemon", layers=L, tenants=2, weights="shared",
        num_devices=2, certify=True, admission=True,
        param_GiB=f"{(L * p_layer + 2 * emb) / GIB:.2f}",
        weight_budget_GiB=f"{budget / GIB:.2f}")
    out = serve_daemon(torch, cg, eng, rate_hz=8.0, n_req=32,
                       prompt_len=32, new_tokens=8, seed=5)
    # the two tenants are homed on two devices
    assert {pl.device for pl in eng.placement.assignments.values()} == \
        {0, 1}, _placement(eng)
    out.update(layers=L, placement=_placement(eng))
    say("serve-daemon", placement=_placement(eng))
    del eng, params, m
    _free(torch)
    return out


def phase_serve_cli(torch):
    """The daemon launcher as a user runs it, on the card: smoke configs,
    bf16, 2 modelled devices, certified, admission on, 3 s."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--daemon",
           "--duration", "3", "--num-devices", "2", "--certify",
           "--admission", "--dtype", "bfloat16"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines[-8:]:
        print(f"    {line}", flush=True)
    say("serve-cli", command=" ".join(cmd[1:]), rc=proc.returncode,
        seconds=f"{secs:.1f}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert any("violations=0" in line for line in lines), lines[-8:]
    return dict(rc=proc.returncode, seconds=secs)


# ---------------------------------------------------------------------------
# 7-8. the matvec regime and windowed attention
# ---------------------------------------------------------------------------

def phase_rnn_matvec(torch, cg, gv):
    from repro_torch.core import (H100, Coalescer, CostModel, GemmShape,
                                  PlanCache, SuperkernelExecutor, make_op)
    from repro_torch.kernels import ops
    G, K, N, ticks = 4, 2048, 4096, 20
    lstm = GemmShape(m=1, n=N, k=K, dtype_bytes=4)
    coal = Coalescer(CostModel(H100))
    for n_ops in (2, 3, 4, 8):
        plan = coal.plan([make_op(i, "gemv", lstm, tag="lstm_x",
                                  model_id="lstm", seq_index=0)
                          for i in range(n_ops)])
        say("rnn-matvec", plan=f"G={n_ops}",
            shared_operand=plan.shared_operand,
            modeled_us=f"{plan.est_time_s * 1e6:.3f}(H100 cost model)")
    g = torch.Generator(device="cuda").manual_seed(7)
    ws = [torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)
          for _ in range(G)]
    xs = torch.randn(ticks, G, K, device="cuda", generator=g)
    result = {}
    for regime, weights in (("distinct", ws), ("shared", [ws[0]] * G)):
        ex = SuperkernelExecutor(PlanCache(16, byte_capacity=1 << 30), bm=8)
        torch.cuda.synchronize()
        cg.coalesced_gemm.launches = 0
        gv.coalesced_gemv.launches = 0
        t0 = time.perf_counter()
        for t in range(ticks):
            outs = ex.matvec(list(xs[t]), weights, group="lstm")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_gemv, n_gemm = gv.coalesced_gemv.launches, cg.coalesced_gemm.launches
        if regime == "distinct":
            assert n_gemv == ticks and n_gemm == 0, (n_gemv, n_gemm)
            assert ex.stats.weight_hit_rate == (ticks - 1) / ticks, ex.stats
        else:
            assert n_gemm == ticks and n_gemv == 0, (n_gemv, n_gemm)
        # the last tick against the eager entry point on the card and the
        # CPU plain path (not counted: the counts were read above)
        x_last = list(xs[-1])
        eager = ops.coalesced_matvec(x_last, weights)
        cpu_w = [w.cpu() for w in weights]
        cpu_w = [cpu_w[0]] * G if regime == "shared" else cpu_w
        cpu = ops.coalesced_matvec([x.cpu() for x in x_last], cpu_w)
        err = 0.0
        for o, e, c in zip(outs, eager, cpu):
            assert tuple(o.shape) == (N,) and bool(torch.isfinite(o).all())
            torch.testing.assert_close(o, e, rtol=2e-4, atol=2e-4)
            torch.testing.assert_close(o.cpu(), c, rtol=2e-4, atol=2e-4)
            err = max(err, float((o.cpu() - c).abs().max()))
        # host wall time per tick: one coalesced call against G calls of
        # G = 1 (each its own executor slot), printed only
        singles = [SuperkernelExecutor(PlanCache(4, byte_capacity=1 << 30),
                                       bm=8) for _ in range(G)]
        for i in range(G):
            singles[i].matvec([xs[0, i]], [weights[i]])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(ticks):
            for i in range(G):
                singles[i].matvec([xs[t, i]], [weights[i]])
        torch.cuda.synchronize()
        wall_single = time.perf_counter() - t1
        say("rnn-matvec", regime=regime, G=G, K=K, N=N, ticks=ticks,
            gemv_launches=n_gemv, gemm_launches=n_gemm,
            weight_hit_rate=f"{ex.stats.weight_hit_rate:.4f}",
            dispatches=ex.stats.dispatches,
            kernel_builds=ex.stats.retraces,
            max_abs_err_vs_cpu=f"{err:.3e}",
            host_ms_per_tick_coalesced=f"{1e3 * wall / ticks:.4f}",
            host_ms_per_tick_G_calls=f"{1e3 * wall_single / ticks:.4f}")
        result[regime] = dict(gemv=n_gemv, gemm=n_gemm, max_abs_err=err,
                              ms_per_tick=1e3 * wall / ticks,
                              ms_per_tick_single=1e3 * wall_single / ticks)
    del ws, xs
    torch.cuda.empty_cache()
    return result


def phase_windowed_attention(torch, fa):
    from repro_torch.kernels import ops
    H, S, D, window = 4, 4096, 256, 1024
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn(1, H, S, D, device="cuda", generator=g)
    k, v = (torch.randn(1, 1, S, D, device="cuda", generator=g)
            .expand(1, H, S, D) for _ in range(2))
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    out = ops.windowed_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    assert launches == 1, launches
    assert tuple(out.shape) == (1, H, S, D)
    assert bool(torch.isfinite(out).all())
    t0 = time.perf_counter()
    want = ops.windowed_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                  window=window)
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(out.cpu(), want, rtol=2e-5, atol=2e-4)
    err = float((out.cpu() - want).abs().max())
    say("windowed-attention", shape=f"[1,{H},{S},{D}]", window=window,
        launches=launches, max_abs_err_vs_cpu=f"{err:.3e}",
        cpu_plain_s=f"{cpu_s:.2f}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--gemm-only", action="store_true",
                      help="the card, then coalesced_gemm against its plain "
                           "version at phase 3's shapes (no result line)")
    only.add_argument("--gemv-only", action="store_true",
                      help="the card, then coalesced_gemv against its plain "
                           "version at phase 3's shapes (no result line)")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the source tree whose repro_torch is driven "
                         "(default: src/ beside this script); with "
                         "--gemm-only or --gemv-only, e.g. another commit's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    src = args.src.resolve()
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}; run "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib
    build = importlib.import_module("repro_torch.kernels.build")
    cg, gv, fa = (importlib.import_module(f"repro_torch.kernels.{name}")
                  for name in ("coalesced_gemm", "coalesced_gemv",
                               "flash_attention"))
    from repro_torch.kernels.ref import (coalesced_gemm_ref,
                                         coalesced_gemv_ref,
                                         flash_attention_ref)

    t_start = time.perf_counter()
    kind, smi = phase_device(torch)

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        say("phase", name=name, seconds=f"{time.perf_counter() - t0:.1f}")
        return out

    if args.gemm_only or args.gemv_only:
        flush = torch.zeros(64 << 20, device="cuda")
        if args.gemm_only:
            say("gemm-only", src=src, wrapper=cg.__file__)
            phase_kernel(torch, cg, coalesced_gemm_ref, flush)
        else:
            say("gemv-only", src=src, wrapper=gv.__file__)
            phase_kernel_gemv(torch, gv, coalesced_gemv_ref, flush)
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        return 0
    timed_phase("build", phase_build, build, cg, gv, fa)
    # overwritten before every timed call of phase 3: 256 MB, five times
    # the L2 cache
    flush = torch.zeros(64 << 20, device="cuda")
    shapes = timed_phase("kernel", phase_kernel, torch, cg,
                         coalesced_gemm_ref, flush)
    gemv_shapes = timed_phase("kernel-gemv", phase_kernel_gemv, torch, gv,
                              coalesced_gemv_ref, flush)
    attn_shapes = timed_phase("kernel-attn", phase_kernel_attn, torch, fa,
                              flash_attention_ref, flush)
    del flush
    torch.cuda.empty_cache()
    timed = {(r["M"], r["K"], r["N"], r["G"], r["dtype"]) for r in shapes}
    shared = timed_phase("serve-shared", phase_serve_shared, torch, cg,
                         timed)
    grouped = timed_phase("serve-grouped", phase_serve_grouped, torch, cg,
                          timed)
    moe = timed_phase("serve-moe", phase_serve_moe, torch, cg, timed)
    ssm = timed_phase("serve-ssm", phase_serve_ssm, torch, cg, timed)
    mesh = timed_phase("serve-mesh", phase_serve_mesh, torch, cg)
    daemon = timed_phase("serve-daemon", phase_serve_daemon, torch, cg)
    timed_phase("serve-cli", phase_serve_cli, torch)
    cpu = timed_phase("card-vs-cpu", phase_card_vs_cpu, torch, cg)
    cpu_nondense = timed_phase("card-vs-cpu (moe, ssm)",
                               phase_card_vs_cpu_nondense, torch, cg)
    rnn = timed_phase("rnn-matvec", phase_rnn_matvec, torch, cg, gv)
    attn = timed_phase("windowed-attention", phase_windowed_attention,
                       torch, fa)
    bad = [k for k in ("jax", "repro") if k in sys.modules]
    assert not bad, f"imported {bad}"

    def entry(name, replaces, launches, by_phase, rows, head, at):
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "at": f"{head['shape']}, {head['dtype']}, {at}",
            "launches_by_phase": by_phase, "shapes": rows}

    head = next(r for r in shapes if r["dtype"] == "bfloat16"
                and r["shape"].startswith("yi-9b decode grouped"))
    g_head = next(r for r in gemv_shapes if r["dtype"] == "float32"
                  and r["shape"] == "lstm G=4")
    a_head = next(r for r in attn_shapes if r["dtype"] == "float32"
                  and r["shape"].startswith("gemma3-1b local"))
    by_phase = {f"{phase} ({regime})": out[regime]["launches"]
                for phase, out in (("serve-shared", shared),
                                   ("serve-grouped", grouped),
                                   ("serve-moe", moe), ("serve-ssm", ssm),
                                   ("card-vs-cpu", cpu))
                for _, regime in REGIMES}
    by_phase.update({f"card-vs-cpu {k}": n for k, n in cpu_nondense.items()})
    by_phase.update({f"serve-mesh (stacked, {n} device{'s' * (n > 1)})":
                     mesh[n]["launches"] for n in (1, 2)})
    by_phase.update({
        "serve-daemon (run)": daemon["virtual"]["launches_run"],
        "serve-daemon (virtual clock)": daemon["virtual"]["launches_door"],
        "serve-daemon (real clock)": daemon["real"]["launches"]})
    by_phase["rnn-matvec (shared)"] = rnn["shared"]["gemm"]
    kernels = [
        entry("coalesced_gemm", "src/repro/kernels/coalesced_gemm.py:43",
              shared["stacked"]["launches"], by_phase,
              shapes, head,
              f"A [{head['M']},{head['K']}], "
              f"B [{head['G']},{head['K']},{head['N']}]"),
        entry("coalesced_gemv", "src/repro/kernels/coalesced_gemv.py:40",
              rnn["distinct"]["gemv"],
              {"rnn-matvec (distinct)": rnn["distinct"]["gemv"],
               "rnn-matvec (shared)": rnn["shared"]["gemv"]},
              gemv_shapes, g_head,
              f"x [{g_head['G']},{g_head['K']}], "
              f"w [{g_head['G']},{g_head['K']},{g_head['N']}]"),
        entry("flash_attention", "src/repro/kernels/flash_attention.py:69",
              attn["launches"], {"windowed-attention": attn["launches"]},
              attn_shapes, a_head,
              f"q/k/v [{a_head['BH']},{a_head['S']},{a_head['D']}], "
              f"window {a_head['window']}"),
    ]
    kernels[0]["launches_by_shape"] = {
        f"{phase} ({regime})": out[regime]["launches_by_shape"]
        for phase, out in (("serve-shared", shared),
                           ("serve-grouped", grouped),
                           ("serve-moe", moe), ("serve-ssm", ssm))
        for _, regime in REGIMES}
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
