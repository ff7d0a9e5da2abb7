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
                   tokens, 8 new tokens, served five times, each engine
                   freed before the next: layer-stacked templates with
                   each decode and prompt body a CUDA graph replay (the
                   default, ``stacked-graphed``; each body GEMM a solo
                   launch inside the graph), the same bodies eager
                   (``cuda_graphs=False``, ``stacked``), ``stacked``,
                   ``stacked-graphed`` in turns, then
                   ``stacked_layers=False`` (per-layer stages coalesced
                   across the tenants). Per run: wall s, tokens/s,
                   scheduler dispatches, kernel launches (checked against
                   the dispatches; a replay counts its capture's
                   launches), launches per program, weight hit rate,
                   graph captures and replays by kind (decode body,
                   prefill body, per-layer glue, monolithic model call,
                   executor dispatch body), each held to
                   ``_vliw_graphs``: one capture a key, the other calls
                   replays (serve-shared: decode 1 / 13, prefill 1 / 7;
                   dispatch: one capture a key a spy on the executor
                   works out from the run's plain dispatches; 0 in an
                   eager run), each kind's capture
                   ms, peak GiB, then the gemm's launches by (M, K, N, G,
                   dtype), each marked by whether phase 3 times that shape
                   (also in phase 5). The tokens of every run must be
                   identical. While the first graphed engine lives: one
                   more decode step as a replay of its graph, eager, and
                   through a per-layer template (logits and cache bitwise
                   equal across the three), and ``profile`` lines: host
                   and wall ms of one 32-token prompt pass, its bodies
                   graphed and eager in turns (``path=serve-shared:
                   prefill``), and of one steady decode step in each
                   regime (the two stacked ones in turns), the device time
                   of ``coalesced_gemm`` and of the other kernels
                   (``torch.profiler``), and the device busy share;
  4b. serve-tuned — phase 4's tenants at 12 layers (the script's time),
                   stacked, served untuned and live-tuned
                   (``live_tune=True``) with each objective, collaborative
                   and greedy, in turns, each setting twice: tokens bitwise
                   equal to the untuned run's; one tuner search a group
                   signature and hits after (misses == the tuner's results
                   > 0, hits > misses). Per run: wall s, launches, the
                   tuned (bm, bn, bk) by plans and by signatures, and the
                   kernel's launches by bm (each a tuned bm);
  4c. kernel-bm  — ``coalesced_gemm`` at every bm serve-tuned launched and
                   at 16, 32 and 64, on serve-tuned's decode and prompt
                   shapes, fp32 and bf16, against its plain version and
                   timed as in phase 3; the real rows must be BITWISE equal
                   to the bm = 8 launch on the same inputs;
  5. serve-grouped — two full-width yi-9b tenants with distinct weights
                   (bf16, 12 layers), graphed stacked, then per-layer with
                   its attention glue and its GEMM dispatches graphed
                   (``per-layer-graphed``: the JAX package's
                   ``_GLUE_JITS`` and jitted dispatch bodies), then eager:
                   per-layer the kernel runs with G >= 2 weight matrices;
     dispatch-graphs — the executor's dispatch bodies as CUDA graphs: the
                   host µs of one dispatch, eager and replayed in turns
                   (grouped at yi-9b's wq and ffn gate/up shapes, G = 1,
                   2, 4, 8, 4 rows a member and ragged, bf16; the LSTM
                   matvec, fp32, distinct and one weight), each replay
                   bitwise the eager call; then serve-grouped's
                   configuration in the per-layer regime, graphed and eager
                   in turns (tokens identical, launches equal, dispatch
                   graphs held to one capture a key); a second run over
                   warm per-layer templates of both tenants: 0 dispatch
                   captures, 0 kernel builds, 0 packs, logits bitwise the
                   eager run's; ``profile`` lines of one per-layer decode
                   step of tenant 0, glue and dispatches graphed and eager
                   in turns; peak GiB of each;
  5b. serve-moe  — two tenants sharing one full-width grok-1 weight set
                   (bf16, 8 experts top-2, 2 layers: one layer's experts
                   are 9.66 GB), the five runs of phase 4, the bytes
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
  5g. serve-families — one engine of five tenants at each config's full
                   width and depth, bf16: two internvl2-2b on one weight
                   set (24 layers; a prompt is 256 patch tokens and the
                   text), hymba-1.5b (32), whisper-tiny (4 + 4, 1500
                   encoder frames) and gemma3-1b with an int8 KV cache (26
                   layers, cache 4096); the params reckoned beside
                   ``mem_get_info``; served in vliw (stacked: the vlm
                   tenants' decode steps are KernelPrograms, the others the
                   monolithic step) and in batched (every step monolithic),
                   each graphed (every ``Model.prefill`` and
                   ``Model.decode_step`` a CUDA graph replay) and eager, in
                   turns, each graphed run twice (six runs, a weight
                   budget of 16 GiB that holds the vlm packs). Per tenant:
                   programs or monolithic steps, tokens, the smallest
                   top-2 logit margin; per
                   mode: wall s, tokens/s, launches (checked in vliw, 0 in
                   batched), graphs by kind (held to
                   ``_families_graphs``), peak GiB; a mode's graphed and
                   eager tokens identical; ``profile`` lines of one
                   monolithic decode step of the hybrid, audio and int8-KV
                   tenants, graphed and eager in turns; vliw's wall over
                   batched's, graphs on and off; the int8 cache's bytes
                   against a bf16 cache of its shape. The monolithic
                   tenants' tokens must be identical in both modes; the vlm
                   tenants' agreement is printed (bf16 kernel against bf16
                   matmuls). It runs after 5f: it ends with the card's
                   free memory 2.3 GiB lower than it found it (0.25 GiB
                   still allocated pins 3.3 GiB of the allocator's
                   segments; printed at its end), which cut serve-mesh's
                   depth when it ran before it;
  6. card-vs-cpu — full-width yi-9b, fp32, 1 layer, two tenants with
                   distinct weights, both regimes (per-layer: the grouped
                   regime, G = 2): the same trace, weights and prompts
                   served on the card (kernel) and on the CPU (plain
                   versions) give identical greedy tokens; then the same
                   for mamba2-2.7b at full width (fp32, 2 layers) and
                   grok-1's smoke config (fp32), each line with the
                   smallest router top-k margin of the run (a mismatch
                   prints the first differing step and routing call);
                   then one vliw engine of serve-families' five tenants
                   at full width, fp32, 1–2 layers (whisper 2 + 2):
                   identical tokens, with each tenant's smallest top-2
                   logit margin;
  7. rnn-matvec  — the matvec regime's path: ``SuperkernelExecutor.matvec``
                   at the LSTM shape (fp32, G = 4) for 20 ticks, distinct
                   weights (``coalesced_gemv``) and shared weights
                   (``coalesced_gemm``), outputs against ``ops.coalesced_
                   matvec`` on the card and the CPU plain path; each
                   regime with its dispatch bodies graphed and eager in
                   turns (outputs bitwise equal, launches one a tick in
                   both, one dispatch capture and 19 replays); prints the
                   coalescer's decision and host ms a tick;
  8. windowed-attention — ``ops.windowed_attention`` at the gemma3-1b local
                   shape on the card against the CPU plain path;
     examples    — each ``examples/torch_*.py`` through its ``main`` on the
                   card (``train_tiny --steps 20``, its checkpoint under
                   ``build/``), its invariants held and its wall seconds
                   printed;
  9. train       — the training path: gemma3-1b at full width and depth
                   (26 layers, d 1152, vocab 262,144 tied), bf16 params,
                   fp32 AdamW, remat, B = 4, S = 2048 (the chunked
                   attention and its banded branch, four CE chunks), 12
                   steps of ``SyntheticLM`` through ``make_train_step``:
                   each step's loss, lr, grad norm and ms; one more step
                   under ``torch.profiler`` (device ms, busy share, the
                   eight costliest kernels by device time, the device ms
                   of the GEMMs of fp32 inputs: p·v and the backward
                   products); before the steps, one local-layer q·kᵀ of
                   the step in bf16 under the profiler (no GEMM of fp32
                   inputs among its kernels: the tensor cores with an
                   fp32 result) and timed beside the widened fp32 einsum
                   it replaced; the median ms
                   a step after 2 warm-up steps, tokens/s, peak GiB, model
                   TFLOP/s (6·N·D over the step) against the H100's
                   spec-sheet bf16 peak. Losses finite and falling (mean
                   of the last 3 below the first 3); the path is plain
                   torch, as in the reference, so no hand-written kernel
                   may launch (all three counts 0);
     train-vs-cpu — one train step of each smoke family (dense, MoE, SSM,
                   hybrid, vlm, audio), fp32, on the card and on the CPU
                   from the same params and batch: loss within 2e-4, every
                   gradient leaf within 1e-3 × its max-abs + 1e-6, the
                   stepped params within 2e-4;
     train-ckpt  — two smoke training steps on the card (bf16 params),
                   checkpointed under ``build/``, restored on the CPU:
                   every leaf bitwise equal;
     dryrun      — the dry-run's step accounting: the train phase's step
                   at world 1, as it runs (3 steps after a warm-up) and
                   once under ``launch/step_cost.py``'s counter on CUDA
                   tensors, its dot FLOPs equal to a trace of the same
                   step on meta tensors; its counted bytes, the least time
                   at the H100's spec-sheet rates beside the measured ms a
                   step, the counted step's ms beside the others, the
                   counted and meta peaks beside ``max_memory_allocated``;
                   then on the host, per chip (meta tensors, a fake world):
                   gemma3-1b ``train_4k`` on 16 × 16, grok-1-314b
                   ``train_4k`` on 2 × 16 × 16 and llama4-maverick
                   ``train_4k`` on both, tensor-parallel over "model",
                   each layer gathered inside its remat body, llama4's
                   experts parallel over the data axes (FLOPs, bytes,
                   each collective kind, peak, dominant term, useful-FLOPs
                   ratio, trace seconds), each beside the same record with
                   the whole tree gathered first and the experts gathered
                   (FLOPs, each kind, peak, useful ratio; the peak held
                   lower, llama4's all-to-all held > 0), gemma3-1b and
                   grok-1 also beside every weight gathered whole;
     train-cli   — one production step at world 1 on the card (nccl, the
                   1×1 ``DeviceMesh``; gemma3-1b and grok-1 smoke, bf16)
                   bitwise equal to the plain step; grok-1 smoke (fp32)
                   under ``moe_groups = 2``, its gradients with remat
                   bitwise those without (the recompute, on the autograd
                   engine's thread, sees the forward's hints); then
                   ``python -m repro_torch.launch.train --steps 20`` (smoke,
                   the card by default) and ``--production --steps 5``
                   (gemma3-1b full config, bf16, remat, DTensor params and
                   optimizer state on the 1×1 ``DeviceMesh``, world 1,
                   nccl; its median ms a step of steps 2-5), both rc 0;
     train-world — the launcher's ``--production --smoke --dtype float32``
                   run on the CPU as four gloo ranks on (data 2, model 2),
                   the FFN and the vocabulary tensor-parallel over
                   "model", each layer gathered inside its remat body,
                   each rank a fresh interpreter, against the world-1
                   run: the 3 losses within 2e-4 (``device=cpu ranks=4``:
                   the card holds one rank); then ``--decode-steps 4``'s
                   greedy tokens on the cache sequence-sharded over
                   "model", identical to world 1; then the MoE step with
                   the experts parallel over "data" and the tokens traded
                   by all-to-all (``--arch grok-1-314b`` on (2, 2),
                   ``--arch llama4-maverick-400b-a17b`` on (4, 1)), the 3
                   losses within 2e-4 of one process's plain steps under
                   ``moe_groups`` = the data ranks;
 10. the kernel table as one JSON line, then the result line.

Launch counts are set to 0 just before each path phase (4-9), and in
phases 4-6 before each run (a regime, a tuning setting, a mode), and
read just after it; the comparisons of phases 3 and 4c are not counted
there. A ``phase`` line gives each
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
# a serving phase's runs, in turns: the default (each stacked decode body a
# CUDA graph replay), the same bodies eager, then the per-layer oracle
SERVE_TURNS = ("stacked-graphed", "stacked", "stacked", "stacked-graphed",
               "per-layer")


def _serve(torch, cfg, tenants_params, *, n_req, prompt_len, new_tokens,
           budget, seed, stacked=True, max_batch=None, setup=None,
           **engine_kw):
    """Serve one trace (``n_req`` requests a tenant) on a fresh vliw
    engine; ``max_batch`` gives each tenant's slots (4 each by default),
    ``engine_kw`` the engine's other options (the mesh, the certifier,
    live tuning); ``setup(engine)`` runs before the trace."""
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
    eng.dispatch_keys = _spy_dispatches(eng.jit.executor)
    if setup is not None:
        setup(eng)
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
    programs = _programs(cfg, rep, not regime.startswith("per-layer"))
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
        graph_captures=j.dispatch.graph_captures,
        graph_replays=j.dispatch.graph_replays,
        peak_alloc_GiB=f"{torch.cuda.max_memory_allocated() / GIB:.2f}",
        modeled_ms=f"{rep.modeled_time_s * 1e3:.3f}(H100 cost model)")


GRAPH_KINDS = ("decode", "prefill", "glue", "monolithic", "dispatch")


def _spy_dispatches(ex):
    """Record, for every plain dispatch of executor ``ex``, the key its
    dispatch graph must have, worked out here from the call: the body
    (shared or grouped), the launch bm, the mesh slot, the activations'
    shapes, strides and dtypes and the weight tensors (their packs and
    group ids follow from these). Returns the list it appends to."""
    keys = []
    run = ex.execute_problems

    def spy(problems, wkeys, *, shared_operand=False, group=None, device=0,
            block=None):
        keys.append((shared_operand, ex.bm if block is None else block.bm,
                     device,
                     tuple((tuple(a.shape), a.stride(), a.dtype)
                           for a, _ in problems),
                     tuple(id(w) for _, w in problems)))
        return run(problems, wkeys, shared_operand=shared_operand,
                   group=group, device=device, block=block)

    ex.execute_problems = spy
    return keys


def _dispatch_want(keys):
    """(captures, replays) of the dispatch graphs of a graphed run whose
    plain dispatches had ``keys``: one capture a distinct key, a replay
    every other dispatch."""
    n = len(set(keys))
    return n, len(keys) - n


def _check_graphs(phase, regime, stats, graphs, want):
    """A run's CUDA graphs by kind (``DispatchStats.graphs_by_kind``: decode
    bodies, prefill bodies, per-layer glue, monolithic model calls) against
    ``want`` {kind: (captures, replays)}: a graphed run captures one graph
    a key and replays it on every other call of that key; an eager run
    (``cuda_graphs=False``) and the eager per-layer run have none. Prints
    the counts and each kind's capture cost (the host seconds of its keys'
    first calls: the eager call and the capture)."""
    got = stats.graphs_by_kind()
    if not regime.endswith("graphed"):
        want = {k: (0, 0) for k in GRAPH_KINDS}
    say(phase, regime=regime, graphs_by_kind=",".join(
        f"{k}:{got[k][0]}/{got[k][1]}" for k in GRAPH_KINDS),
        expected=",".join(f"{k}:{want[k][0]}/{want[k][1]}"
                          for k in GRAPH_KINDS),
        graphs_dropped=graphs.dropped)
    if regime.endswith("graphed"):
        say(phase, regime=regime, capture_ms_by_kind=",".join(
            f"{k}:{1e3 * graphs.capture_s[k]:.1f}" for k in GRAPH_KINDS
            if got[k][0]))
    assert got == want, (phase, regime, got, want)


def _vliw_graphs(cfg, rep, regime, *, weight_sets, n_req, dispatches):
    """{kind: (captures, replays)} a vliw run of ``n_req`` 32-token prompts
    of one model on ``weight_sets`` weight sets must show. Every program
    runs each sub-stack's body once (stacked) or each layer's glue once
    (per-layer); dense prompts are prefill programs (one bucket), MoE / SSM
    prompts ``Model.prefill`` calls (one shape). A key is one (weight set,
    sub-stack) for a body, one (weight set, shape) for a model call, one
    ``_GLUE_JITS`` key for glue, whatever the weights: captures are the
    keys, replays the other calls. Every plain dispatch (the stacked
    programs' unembeds, every per-layer GEMM) runs a dispatch graph: one
    capture a key of ``dispatches`` (``_spy_dispatches``)."""
    dense = cfg.arch_type == "dense"
    want = {k: (0, 0) for k in GRAPH_KINDS}
    if regime.endswith("graphed"):
        want["dispatch"] = _dispatch_want(dispatches)
    if regime == "stacked-graphed":
        S = len(_spans(cfg))
        programs = round(_programs(cfg, rep, True))
        prompts = n_req if dense else 0
        keys = weight_sets * S
        want["decode"] = (keys, (programs - prompts) * S - keys)
        if dense:
            want["prefill"] = (keys, prompts * S - keys)
        else:
            want["monolithic"] = (weight_sets, n_req - weight_sets)
    elif regime == "per-layer-graphed":
        assert dense, cfg.arch_type
        flags = {bool(cfg.layer_is_global(l))
                 for l in range(cfg.num_layers)}
        keys = 2 * len(flags)        # decode-attend and prefill-attend
        programs = round(_programs(cfg, rep, False))
        want["glue"] = (keys, programs * cfg.num_layers - keys)
    return want


def _reset_counts(cg):
    cg.coalesced_gemm.launches = 0
    cg.coalesced_gemm.max_groups = 0
    cg.coalesced_gemm.launches_by_shape = {}
    cg.coalesced_gemm.launches_by_bm = {}


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
                   budget, check, after=None, turns=SERVE_TURNS):
    """Serve one trace in each of ``turns`` (a regime may come twice, in
    turns with another, so their walls can be read against the spread of
    one setting), each engine freed before the next; the tokens of every
    run must be identical. ``check(rep, launches, max_G, regime)`` holds
    each run to its phase's assertions; ``after(eng, rep, regime)`` runs
    while each regime's first engine is alive. Returns per regime its
    first run's numbers, with ``wall_s_turns`` the walls of all its runs.
    A regime ending in ``graphed`` runs with ``cuda_graphs``, one starting
    with ``per-layer`` with ``stacked_layers=False``."""
    out, tokens = {}, {}
    weight_sets = len({id(p) for _, p in tenants_params})
    for regime in turns:
        stacked = not regime.startswith("per-layer")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(cg)
        eng, rep, wall = _serve(torch, cfg, tenants_params, n_req=4,
                                prompt_len=32, new_tokens=8,
                                budget=budget, seed=seed,
                                stacked=stacked,
                                cuda_graphs=regime.endswith("graphed"))
        launches = cg.coalesced_gemm.launches
        max_g = cg.coalesced_gemm.max_groups
        _check_served(rep, cfg, 8, 8)
        _check_launches(cfg, rep, launches, stacked)
        _check_graphs(phase, regime, rep.jit.dispatch, eng.jit.graphs,
                      _vliw_graphs(cfg, rep, regime,
                                   weight_sets=weight_sets, n_req=8,
                                   dispatches=eng.dispatch_keys))
        check(rep, launches, max_g, regime)
        _report_serve(torch, phase, cfg, rep, wall, launches, max_g, regime)
        by_shape = _report_shapes(f"{phase} ({regime})", cg, timed)
        toks = {r.req_id: r.tokens_out for r in rep.requests}
        assert all(toks == t for t in tokens.values()), regime
        tokens[regime] = toks
        if regime in out:
            assert launches == out[regime]["launches"], regime
            out[regime]["wall_s_turns"].append(wall)
        else:
            programs = _programs(cfg, rep, stacked)
            out[regime] = dict(
                launches=launches, max_groups=max_g, wall_s=wall,
                wall_s_turns=[wall],
                tokens=rep.tokens_out, tokens_per_s=rep.tokens_out / wall,
                scheduler_dispatches=rep.jit.superkernels,
                launches_per_program=launches / programs,
                weight_hit_rate=rep.jit.dispatch.weight_hit_rate,
                peak_alloc_GiB=torch.cuda.max_memory_allocated() / GIB,
                graph_captures=rep.jit.dispatch.graph_captures,
                graph_replays=rep.jit.dispatch.graph_replays,
                graphs_by_kind=rep.jit.dispatch.graphs_by_kind(),
                capture_s_by_kind=dict(eng.jit.graphs.capture_s),
                expert_coalesced=rep.jit.expert_coalesced,
                nondense_programs=rep.jit.nondense_programs,
                launches_by_shape=by_shape)
        if after is not None and len(out[regime]["wall_s_turns"]) == 1:
            out.update(after(eng, rep, regime))
        del eng, rep
        _free(torch)
    graphed = {r.endswith("graphed") for r in tokens}
    say(phase, tokens_stacked_vs_per_layer="identical",
        tokens_graphed_vs_eager="identical" if len(graphed) == 2
        else "not_run", regimes="/".join(turns),
        requests=len(tokens[turns[0]]))
    for regime in dict.fromkeys(turns):
        say(phase, regime=regime, wall_s_turns="/".join(
            f"{w:.3f}" for w in out[regime]["wall_s_turns"]))
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

    def after(eng, rep, regime):
        if regime != "stacked-graphed":
            return {}
        # the prompt pass first: the profile empties the weight cache, and
        # the prompt graphs with it
        return dict(
            extra_step=_extra_step(torch, eng, m, params, cfg,
                                   "serve-shared"),
            profile_prefill=phase_profile_prefill(torch, eng, m, params,
                                                  "serve-shared"),
            profile=phase_profile(torch, eng, m, params, "serve-shared"))

    out = _serve_regimes(torch, cg, timed, "serve-shared", cfg,
                         [(m, params), (m, params)], seed=0, budget=budget,
                         check=check, after=after)
    out["layers"] = L
    del params, m
    _free(torch)
    return out


# the extra step's and the profile's regimes: (label, stacked, graphed)
STEP_REGIMES = (("stacked-graphed", True, True), ("stacked", True, False),
                ("per-layer", False, False))


def _extra_step(torch, eng, m, params, cfg, phase):
    """One more decode step of tenant 0 through a stacked template as a
    replay of the serving run's graph, the same template eager, and a
    per-layer template: finite logits of the expected shape, logits and
    every cache leaf bitwise equal across the three, beside the plain
    Model.decode_step."""
    build = _decode_builder(cfg)
    t = eng.tenants["t0"]
    st = eng.jit.executor.stats
    logits, caches = {}, {}
    for regime, stacked, graphed in STEP_REGIMES:
        eng.jit.cuda_graphs = graphed
        r0, c0 = st.graph_replays, st.graph_captures
        prog = build(m, params, t.max_batch, stacked=stacked).bind(
            stream_id=0, tokens=t.slot_tok, cache=t.cache)
        eng.jit.run([prog])
        if graphed:
            # the serving run's graphs, replayed: no new capture
            assert st.graph_replays > r0 and st.graph_captures == c0, \
                (st.graph_replays, r0, st.graph_captures, c0)
        logits[regime], caches[regime] = prog.env["logits"], \
            prog.env["cache"]
    eng.jit.cuda_graphs = True
    got = logits["stacked-graphed"].float()
    assert tuple(got.shape) == (t.max_batch, cfg.padded_vocab)
    assert bool(torch.isfinite(got).all())
    for regime in ("stacked", "per-layer"):
        assert torch.equal(logits["stacked-graphed"], logits[regime]), regime
        want = caches[regime]
        assert torch.equal(caches["stacked-graphed"]["pos"], want["pos"])
        for leaf, tt in want["layers"].items():
            assert torch.equal(caches["stacked-graphed"]["layers"][leaf],
                               tt), (regime, leaf)
    want, _ = m.decode_step(params, t.slot_tok, t.cache)
    diff = float((got - want[:, 0].float()).abs().max())
    agree = float((got.argmax(-1) == want[:, 0].argmax(-1)).float().mean())
    say(phase, extra_step_logits="finite",
        graphed_vs_eager="bitwise_equal(logits,cache)",
        stacked_vs_per_layer="bitwise_equal(logits,cache)",
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


def _profile_regime(torch, phase, regime, step, steps, *, host_ms, wall_ms,
                    batch, layers):
    """``steps`` calls of ``step`` under ``torch.profiler``: the device time
    of ``coalesced_gemm`` and of the other kernels, the busy share against
    ``wall_ms``, and the host events (CUDA events if the profiler records
    no device time)."""
    from torch.profiler import ProfilerActivity, profile
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
    say("profile", path=phase, regime=regime, batch=batch, layers=layers,
        steps=steps, host_ms_per_step=f"{host_ms:.3f}",
        wall_ms_per_step=f"{wall_ms:.3f}",
        coalesced_gemm_device_ms_per_step=f"{gemm_ms:.3f}",
        other_kernels_device_ms_per_step=f"{glue_ms:.3f}",
        device_busy_share=f"{busy:.3f}", source=source)
    return dict(host_ms=host_ms, wall_ms=wall_ms, gemm_device_ms=gemm_ms,
                glue_device_ms=glue_ms, device_busy_share=busy,
                source=source)


def _profile_turns(torch, phase, steps_by_regime, *, batch, layers,
                   steps=3):
    """Host and wall ms of one call of each ``steps_by_regime`` {regime:
    step} in a steady state, the regimes timed in turns (each warmed by
    one call first): host ms until the step returns, wall ms until the card
    has finished (synchronize); then each regime's steps under
    ``torch.profiler`` (``_profile_regime``)."""
    host = {regime: [] for regime in steps_by_regime}
    wall = {regime: [] for regime in steps_by_regime}
    for step in steps_by_regime.values():
        step()
    torch.cuda.synchronize()
    for _ in range(steps):
        for regime, step in steps_by_regime.items():
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host[regime].append(t1 - t0)
            wall[regime].append(time.perf_counter() - t0)
    return {regime: _profile_regime(
        torch, phase, regime, step, steps,
        host_ms=1e3 * statistics.median(host[regime]),
        wall_ms=1e3 * statistics.median(wall[regime]),
        batch=batch, layers=layers)
        for regime, step in steps_by_regime.items()}


def phase_profile(torch, eng, m, params, phase, steps=3):
    """Host and device time of one decode step of tenant 0 at the serving
    phase's shape, in a steady state (packs built, graphs captured,
    warmed), in three regimes (``STEP_REGIMES``): the stacked template as
    replays of its bodies' CUDA graphs (``stacked-graphed``), the same
    template eager (``stacked``), and the per-layer template. The two
    stacked regimes' steps are timed in turns (they share their packs), the
    per-layer steps after them (serve-moe's weight budget holds one
    regime's packs, so turns with it would repack), each group from an
    empty weight cache (``_profile_turns``)."""
    build = _decode_builder(m.cfg)
    t = eng.tenants["t0"]
    tmpls = {regime: (build(m, params, t.max_batch, stacked=stacked), graphed)
             for regime, stacked, graphed in STEP_REGIMES}

    def step(regime):
        tmpl, graphed = tmpls[regime]
        eng.jit.cuda_graphs = graphed
        eng.jit.run([tmpl.bind(stream_id=0, tokens=t.slot_tok,
                               cache=t.cache)])

    out = {}
    for turns in (("stacked-graphed", "stacked"), ("per-layer",)):
        # each group starts from an empty weight cache (its graphs go with
        # it): serve-moe's budget holds one regime's packs, and the other
        # regime's small packs left in 8 GiB segments fragment the pool
        say("profile", path=phase, regimes="/".join(turns),
            allocated_GiB=f"{torch.cuda.memory_allocated() / GIB:.2f}",
            reserved_GiB=f"{torch.cuda.memory_reserved() / GIB:.2f}")
        eng.jit.weight_cache.clear()
        _free(torch)
        out.update(_profile_turns(
            torch, phase,
            {regime: (lambda regime=regime: step(regime))
             for regime in turns},
            batch=t.max_batch, layers=m.cfg.num_layers, steps=steps))
    eng.jit.cuda_graphs = True
    return out


def phase_profile_prefill(torch, eng, m, params, phase, prompt_len=32):
    """One prompt pass of ``prompt_len`` tokens (its bucket) through the
    stacked prefill template, the request's KV rows written into slot 0 of
    tenant 0's cache: its bodies as replays of the serving run's prompt
    graphs (``prefill-graphed``) and eager (``prefill``), in turns."""
    from repro_torch.core.jit import build_dense_prefill_template
    t = eng.tenants["t0"]
    tmpl = build_dense_prefill_template(m, params, prompt_len)
    toks = torch.randint(0, m.cfg.vocab_size, (1, prompt_len),
                         generator=torch.Generator().manual_seed(7)
                         ).to(m.device)

    def step(graphed):
        eng.jit.cuda_graphs = graphed
        eng.jit.run([tmpl.bind(stream_id=0, tokens=toks, cache=t.cache,
                               env_extra={"real_len": prompt_len, "slot": 0,
                                          "req": None})])

    st = eng.jit.executor.stats
    c0 = st.prefill_graph_captures
    out = _profile_turns(torch, f"{phase}:prefill",
                         {"prefill-graphed": lambda: step(True),
                          "prefill": lambda: step(False)},
                         batch=prompt_len, layers=m.cfg.num_layers)
    # the serving run's graphs, replayed: no new capture
    assert st.prefill_graph_captures == c0, (st.prefill_graph_captures, c0)
    eng.jit.cuda_graphs = True
    return out


def phase_serve_grouped(torch, cg, timed):
    cfg, tp, budget = _grouped_tenants(torch, "serve-grouped")
    # graphed (the decode bodies, or the per-layer glue and dispatch
    # bodies) and eager; dispatch-graphs runs the per-layer regime in turns
    out = _serve_regimes(torch, cg, timed, "serve-grouped", cfg, tp, seed=1,
                         budget=budget, check=_grouped_check,
                         turns=("stacked-graphed", "per-layer-graphed",
                                "per-layer"))
    del tp
    _free(torch)
    return out


def _grouped_tenants(torch, phase, L=12):
    """serve-grouped's configuration: yi-9b at full width, ``L`` layers,
    bf16, two weight sets (seeds 10, 11), and a weight budget of the free
    memory less their params and 6 GiB."""
    from repro_torch.models import Model
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
    say(phase, layers=L, tenants=2, weights="distinct",
        param_GiB=f"{params_bytes / GIB:.2f}",
        weight_budget_GiB=f"{budget / GIB:.2f}")
    return cfg, tp, budget


def _grouped_check(rep, launches, max_g, regime):
    """Two weight sets: no shared dispatch, groups of two; per-layer, the
    GEMMs of both tenants coalesce (G = 2)."""
    assert launches > 0
    assert rep.jit.shared_dispatches == 0 and rep.jit.mean_group > 1.0
    if regime.startswith("per-layer"):
        assert max_g >= 2, (launches, max_g)


# the host-µs table's groups: yi-9b's attention q and ffn gate / up
# GEMMs (bf16), G members of 4 rows each or ragged rows
DISPATCH_SHAPES = (("yi-9b wq", 4096, 4096), ("yi-9b ffn gate/up", 4096,
                                                11008))
DISPATCH_G = (1, 2, 4, 8)


def _host_us(torch, fn, calls=15):
    """Median host µs of one call, each started on an idle card (a
    synchronize before it, outside the timing) and timed until it returns."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def _dispatch_host_table(torch):
    """Host µs of one executor dispatch, eager and as a replay of its CUDA
    graph, timed in turns (eager, graphed, graphed, eager; the medians of
    each pair averaged) on two executors over the same weights: grouped
    dispatches at ``DISPATCH_SHAPES`` x ``DISPATCH_G``, 4 rows a member and
    ragged, bf16, and the shared body (one weight, G > 1, 4 rows a
    member); the LSTM matvec (G = 4, K 2048, N 4096, fp32) on
    distinct weights (the gemv) and on one weight (the shared GEMM). Each
    replay is bitwise the eager call."""
    from repro_torch.core import PlanCache, SuperkernelExecutor
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for label, K, N in DISPATCH_SHAPES:
        for G in DISPATCH_G:
            ws = [torch.randn(K, N, device="cuda", generator=g,
                              dtype=torch.bfloat16) / math.sqrt(K)
                  for _ in range(G)]
            for rows in ([4] * G, [1 + (3 * i) % 4 for i in range(G)]):
                cases.append(("grouped", label, ws, rows))
            if G > 1:                # one weight set: the shared body
                cases.append(("shared", label, [ws[0]] * G, [4] * G))
    lstm = [torch.randn(2048, 4096, device="cuda", generator=g)
            / math.sqrt(2048) for _ in range(4)]
    cases += [("matvec", "lstm", lstm, [1] * 4),
              ("shared", "lstm (one weight)", [lstm[0]] * 4, [1] * 4)]
    out = []
    for body, label, ws, rows in cases:
        exs = {graphed: SuperkernelExecutor(
            PlanCache(64, byte_capacity=16 * GIB), cuda_graphs=graphed)
            for graphed in (True, False)}
        acts = [torch.randn(m, int(w.shape[0]), device="cuda", generator=g,
                            dtype=w.dtype) for m, w in zip(rows, ws)]

        def call(ex, acts=acts, ws=ws, body=body, label=label):
            if label.startswith("lstm"):     # the matvec entry point
                return ex.matvec([a[0] for a in acts], ws)
            return ex.execute_problems(list(zip(acts, ws)),
                                       [("m", id(w)) for w in ws],
                                       shared_operand=body == "shared")

        res = {graphed: [call(ex), call(ex)][1]
               for graphed, ex in exs.items()}
        for a, b in zip(res[True], res[False]):
            assert torch.equal(a, b) and a.stride() == b.stride(), label
        st = exs[True].stats.graphs_by_kind()["dispatch"]
        assert st == (1, 1), (label, st)
        us = {True: [], False: []}
        for graphed in (False, True, True, False):
            us[graphed].append(_host_us(torch,
                                        lambda ex=exs[graphed]: call(ex)))
        eager_us, graphed_us = (statistics.mean(us[k]) for k in (False,
                                                                 True))
        row = dict(body=body, shape=label, K=int(ws[0].shape[0]),
                   N=int(ws[0].shape[1]), G=len(ws), rows=rows,
                   dtype=str(ws[0].dtype).removeprefix("torch."),
                   host_us_eager=eager_us, host_us_graphed=graphed_us)
        say("dispatch-graphs", body=body, shape=label, K=row["K"],
            N=row["N"], G=row["G"], rows=",".join(map(str, rows)),
            dtype=row["dtype"], host_us_eager=f"{eager_us:.1f}",
            host_us_graphed=f"{graphed_us:.1f}",
            graphed_over_eager=f"{graphed_us / eager_us:.3f}",
            replay="bitwise_equal")
        out.append(row)
        del exs, res
    return out


def phase_dispatch_graphs(torch, cg, timed):
    """The executor's dispatch bodies as CUDA graphs: the host µs of one
    dispatch, eager and replayed (``_dispatch_host_table``); then
    serve-grouped's configuration in the per-layer regime (every GEMM a
    dispatch), graphed and eager in turns: tokens identical, launches one
    a scheduler dispatch in both, one dispatch graph a key; a second run
    over warm per-layer templates of both tenants captures no dispatch
    graph, and its logits are the eager run's bit for bit; one per-layer
    decode step graphed and eager (``profile``); peak GiB of each."""
    table = _dispatch_host_table(torch)
    _free(torch)
    cfg, tp, budget = _grouped_tenants(torch, "dispatch-graphs")

    def warm_run(eng):
        st = eng.jit.executor.stats
        build = _decode_builder(cfg)
        tmpls = [(build(m, p, eng.tenants[f"t{i}"].max_batch,
                        stacked=False), eng.tenants[f"t{i}"])
                 for i, (m, p) in enumerate(tp)]

        def progs():
            return [tmpl.bind(stream_id=i, tokens=t.slot_tok, cache=t.cache)
                    for i, (tmpl, t) in enumerate(tmpls)]

        eng.jit.run(progs())                 # the first run over them
        c0, r0 = st.dispatch_graph_captures, st.dispatch_graph_replays
        b0, m0 = st.retraces, st.weight_misses
        got = progs()
        eng.jit.run(got)
        replays = st.dispatch_graph_replays - r0
        assert st.dispatch_graph_captures == c0, \
            (st.dispatch_graph_captures, c0)
        assert replays > 0 and st.retraces == b0 and st.weight_misses == m0
        eng.jit.cuda_graphs = False
        want = progs()
        eng.jit.run(want)
        eng.jit.cuda_graphs = True
        for a, b in zip(got, want):
            assert torch.equal(a.env["logits"], b.env["logits"])
        say("dispatch-graphs", second_run="warm per-layer templates",
            dispatch_captures=0, dispatch_replays=replays,
            kernel_builds=0, weight_misses=0,
            logits_graphed_vs_eager="bitwise_equal")
        return dict(second_run_dispatch_captures=0,
                    second_run_dispatch_replays=replays)

    def after(eng, rep, regime):
        if regime != "per-layer-graphed":
            return {}
        out = warm_run(eng)
        # one per-layer decode step of tenant 0: its glue and its GEMM
        # dispatches as replays of their graphs, and eager, in turns
        m, params = tp[0]
        t = eng.tenants["t0"]
        tmpl = _decode_builder(cfg)(m, params, t.max_batch, stacked=False)

        def step(graphed):
            eng.jit.cuda_graphs = graphed
            eng.jit.run([tmpl.bind(stream_id=0, tokens=t.slot_tok,
                                   cache=t.cache)])

        step(True)                 # tenant 0 alone: G = 1 keys, captured
        st = eng.jit.executor.stats
        c0 = (st.glue_graph_captures, st.dispatch_graph_captures)
        out["profile_per_layer"] = _profile_turns(
            torch, "dispatch-graphs:per-layer",
            {"per-layer-graphed": lambda: step(True),
             "per-layer": lambda: step(False)},
            batch=t.max_batch, layers=cfg.num_layers)
        assert (st.glue_graph_captures, st.dispatch_graph_captures) == c0
        eng.jit.cuda_graphs = True
        return out

    out = _serve_regimes(torch, cg, timed, "dispatch-graphs", cfg, tp,
                         seed=1, budget=budget, check=_grouped_check,
                         after=after,
                         turns=("per-layer-graphed", "per-layer",
                                "per-layer", "per-layer-graphed"))
    graphed, eager = out["per-layer-graphed"], out["per-layer"]
    c, r = graphed["graphs_by_kind"]["dispatch"]
    capture_ms = 1e3 * graphed["capture_s_by_kind"]["dispatch"]
    say("dispatch-graphs",
        peak_GiB_graphed=f"{graphed['peak_alloc_GiB']:.2f}",
        peak_GiB_eager=f"{eager['peak_alloc_GiB']:.2f}",
        launches=f"{graphed['launches']}/{eager['launches']}",
        dispatch_captures=c, dispatch_replays=r,
        capture_ms_dispatch=f"{capture_ms:.1f}")
    assert graphed["launches"] == eager["launches"]
    out["host_us_table"] = table
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
                # the card serves its stacked bodies as graph replays
                assert (rep.jit.dispatch.graph_replays > 0) == stacked
            else:
                assert rep.jit.dispatch.graph_captures == 0
            say("card-vs-cpu", regime=regime, device=m.device.type,
                wall_s=f"{wall:.3f}", launches=launches, max_G=max_g,
                graph_captures=rep.jit.dispatch.graph_captures,
                graph_replays=rep.jit.dispatch.graph_replays,
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

    def after(eng, rep, regime):
        if regime != "stacked-graphed":
            return {}
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


# ---------------------------------------------------------------------------
# 4b. live tuning: the tuned tile reaches the superkernel
# ---------------------------------------------------------------------------

TUNED_LAYERS = 12
TUNED_KW = {"untuned": {}, "collaborative": dict(live_tune=True),
            "greedy": dict(live_tune=True, tune_objective="greedy")}
# in turns, each setting twice, so a wall-clock difference between
# settings can be read against the spread of one setting's two runs
TUNED_ORDER = ("untuned", "collaborative", "greedy", "greedy",
               "collaborative", "untuned")


def phase_serve_tuned(torch, cg):
    """serve-shared's tenants (yi-9b, bf16, two tenants on one weight set,
    4 requests each, 32-token prompts, 8 new tokens), stacked, at 12
    layers (the script's time), served untuned and live-tuned with each
    objective in this one process, in turns (``TUNED_ORDER``). The tuned
    runs' tokens must be bitwise the untuned run's; each tuner searches
    once a group signature (misses == its results, > 0) and hits after.
    Per run: wall s, launches, the tuned (bm, bn, bk) by plans and by
    signatures, and the kernel's launches by bm (every one a tuned bm).
    Returns the first run of each setting with its walls in turn order,
    and the set of bm the tuned runs launched."""
    from repro_torch.models import Model
    L = TUNED_LAYERS
    cfg = _full_yi(L)
    free, _ = torch.cuda.mem_get_info()
    m = Model(cfg, param_dtype=torch.bfloat16)
    params = m.init(torch.Generator(device=m.device).manual_seed(1))
    budget = int(free - 6 * GIB - L * _layer_bytes(cfg, 2)[0]
                 - 2 * _embed_bytes(cfg, 2)[0])
    say("serve-tuned", layers=L, depth_cut=f"48->{L}",
        reason="three runs in the script's time", d_model=cfg.d_model,
        weight_budget_GiB=f"{budget / GIB:.2f}")
    runs, tokens, launched = {}, {}, set()
    for label in TUNED_ORDER:
        kw = TUNED_KW[label]
        plans = {}

        def count_plans(eng):
            tuner = eng.jit.tuner
            if tuner is None:
                return
            tune = tuner.tune

            def counted(shapes, **k):
                b = tune(shapes, **k)
                key = (b.bm, b.bn, b.bk)
                plans[key] = plans.get(key, 0) + 1
                return b

            tuner.tune = counted

        torch.cuda.reset_peak_memory_stats()
        _reset_counts(cg)
        eng, rep, wall = _serve(torch, cfg, [(m, params), (m, params)],
                                n_req=4, prompt_len=32, new_tokens=8,
                                budget=budget, seed=0, setup=count_plans,
                                **kw)
        launches = cg.coalesced_gemm.launches
        by_bm = dict(sorted(cg.coalesced_gemm.launches_by_bm.items()))
        _check_served(rep, cfg, 8, 8)
        _check_launches(cfg, rep, launches, True)
        toks = {r.req_id: r.tokens_out for r in rep.requests}
        # every run's tokens bitwise the first (untuned) run's
        assert not tokens or toks == tokens["untuned"], label
        tokens[label] = toks
        st = eng.jit.tune_cache.stats
        signatures = {}
        if eng.jit.tuner is None:
            assert set(by_bm) == {8} and st.accesses == 0, (by_bm, st)
        else:
            results = eng.jit.tuner.results
            assert st.misses == len(results) > 0, (st, len(results))
            assert st.hits > st.misses, st
            assert rep.jit.tune_cache.accesses == st.accesses
            for r in results.values():
                b = (r.block.bm, r.block.bn, r.block.bk)
                signatures[b] = signatures.get(b, 0) + 1
            # every launch took a tuned bm
            assert set(by_bm) <= {b[0] for b in signatures}, \
                (by_bm, signatures)
            launched |= set(by_bm)
        say("serve-tuned", run=label, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{rep.tokens_out / wall:.2f}",
            scheduler_dispatches=rep.jit.superkernels, launches=launches,
            launches_by_bm=by_bm, tune_hits=st.hits, tune_misses=st.misses,
            tuned_blocks_by_plans=dict(sorted(plans.items())),
            tuned_blocks_by_signatures=dict(sorted(signatures.items())),
            peak_alloc_GiB=f"{torch.cuda.max_memory_allocated() / GIB:.2f}",
            modeled_ms=f"{rep.modeled_time_s * 1e3:.3f}(H100 cost model)")
        if label in runs:
            assert launches == runs[label]["launches"], label
            runs[label]["wall_s"].append(wall)
        else:
            runs[label] = dict(wall_s=[wall], launches=launches,
                               launches_by_bm=by_bm, tune_hits=st.hits,
                               tune_misses=st.misses,
                               modeled_ms=rep.modeled_time_s * 1e3)
        del eng, rep
        _free(torch)
    say("serve-tuned", tokens_tuned_vs_untuned="bitwise_equal",
        requests=len(tokens["untuned"]), tuned_bm_launched=sorted(launched),
        wall_s_in_turns={k: [f"{w:.3f}" for w in r["wall_s"]]
                         for k, r in runs.items()})
    del params, m
    _free(torch)
    return runs, launched


BM_SHAPES = [
    # (label, rows per problem, K, N, shared weights): serve-tuned's
    # decode groups and its prompt bodies (m 32, tuned to bm 32 alone or
    # 64 coalesced)
    ("yi-9b decode grouped (ffn gate/up)", (4, 4), 4096, 16384, False),
    ("yi-9b prefill body (ffn gate/up)", (32,), 4096, 16384, True),
    ("yi-9b prefill coalesced (attn wq)", (32, 32), 4096, 4096, False),
]


def _real_rows(out, rows, bm):
    """The real rows of a launch's output, problem by problem (each
    problem's rows start on a bm boundary)."""
    parts, s = [], 0
    for m in rows:
        parts.append(out[s:s + m])
        s += -(-m // bm) * bm
    return parts


def phase_kernel_bm(torch, cg, ref, flush, bms):
    """``coalesced_gemm`` at each tuned ``bm`` (every bm serve-tuned
    launched, and 16, 32 and 64) against its plain version, timed like
    phase 3; the real rows must be BITWISE equal to the bm = 8 launch on
    the same inputs (a row's summation order is a function of K)."""
    rows_out = []
    for label, rows, K, N, shared in BM_SHAPES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            a8, b8, g8 = _operands(torch, rows, K, N, shared, dtype, bm=8)
            base = _real_rows(cg.coalesced_gemm(a8, b8, g8, bm=8), rows, 8)
            for bm in sorted(bms):
                a, b, gid = _operands(torch, rows, K, N, shared, dtype,
                                      bm=bm)
                assert torch.equal(b, b8)
                got = cg.coalesced_gemm(a, b, gid, bm=bm)
                want = ref(a, b, gid, bm)
                rtol, atol = TOL[dname]
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=rtol, atol=atol)
                err = float((got.float() - want.float()).abs().max())
                for p, q in zip(_real_rows(got, rows, bm), base):
                    assert torch.equal(p, q), (label, dname, bm)
                M, G = int(a.shape[0]), int(b.shape[0])
                call = lambda: cg.coalesced_gemm(a, b, gid, bm=bm)  # noqa
                ms, ms_min, ms_max = time_spread(call, flush=flush)
                plain_ms = time_ms(lambda: ref(a, b, gid, bm), reps=5,
                                   flush=flush)
                if G == 1:
                    bw = b[0]
                    library_ms = time_ms(lambda: torch.matmul(a, bw),
                                         flush=flush)
                    library = "torch.matmul"
                else:
                    tiles = a.view(M // bm, bm, K)
                    b_tile = b[gid.long()].contiguous()
                    library_ms = time_ms(lambda: torch.bmm(tiles, b_tile),
                                         flush=flush)
                    library = "torch.bmm"
                    del b_tile
                db = a.element_size()
                moved = (M * K + G * K * N + M * N) * db + gid.numel() * 4
                bound_ms, bound_by = _bound(moved, 2.0 * M * K * N, dname,
                                            MMA_PEAK_FLOPS)
                rows_out.append(dict(shape=label, dtype=dname, bm=bm, M=M,
                                     K=K, N=N, G=G, max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms,
                                     library_ms=library_ms,
                                     bound_ms=bound_ms, bound_by=bound_by))
                say("kernel-bm", shape=repr(label), dtype=dname, bm=bm,
                    A=f"[{M},{K}]", B=f"[{G},{K},{N}]",
                    real_rows_vs_bm8="bitwise_equal",
                    max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}",
                    spread_ms=f"{ms_min:.4f}..{ms_max:.4f}",
                    plain_ms=f"{plain_ms:.4f}",
                    library_ms=f"{library_ms:.4f}({library})",
                    bound_ms=f"{bound_ms:.4f}({bound_by})",
                    bound_share=f"{bound_ms / ms:.3f}")
                del a, b, gid, got, want
            del a8, b8, g8, base
    torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# 5g. the remaining families: vlm, hybrid, audio, int8 KV
# ---------------------------------------------------------------------------

# (tenant, arch, kv_quant, cache_len): the two vlm tenants share one weight
# set; a vlm prompt is its 256 patch tokens and the text
FAMILY_FLEET = (("vlm0", "internvl2-2b", False, 304),
                ("vlm1", "internvl2-2b", False, 304),
                ("hybrid", "hymba-1.5b", False, 48),
                ("audio", "whisper-tiny", False, 48),
                ("int8", "gemma3-1b", True, 4096))


def _family_models(torch, cfgs, dtype, device=None):
    """{arch: (Model, params)} for the fleet's archs (one weight set an
    arch), from fixed seeds."""
    from repro_torch.models import Model
    out = {}
    for i, (name, arch, kvq, _) in enumerate(FAMILY_FLEET):
        if arch in out:
            continue
        m = Model(cfgs[arch], param_dtype=dtype, device=device,
                  kv_quant=kvq)
        out[arch] = (m, m.init(torch.Generator(device=m.device)
                               .manual_seed(40 + i)))
    return out


def _serve_fleet(torch, models, mode, *, n_req, prompt_len, new_tokens,
                 seed, cache_lens=None, cuda_graphs=True):
    """Serve the family fleet in ``mode`` on one engine, counting each
    tenant's decode programs (``_build_program``) and monolithic steps
    (``_tenant_batched_step``) and the smallest top-2 logit margin of its
    decode steps. Returns (engine, report, wall, per-tenant counts)."""
    from repro_torch.serving import ServingEngine, Tenant, make_trace
    tenants = [Tenant(name, *models[arch],
                      cache_len=(cache_lens or {}).get(name, cl),
                      max_batch=4)
               for name, arch, _, cl in FAMILY_FLEET]
    # a weight budget that holds the vlm tenants' packs: under the
    # engine's default 1 GiB every full-width pack passes through the
    # cache, is rebuilt each dispatch, and its body cannot be graphed
    eng = ServingEngine(tenants, mode=mode, plan_capacity=1024,
                        device=tenants[0].model.device,
                        weight_budget_bytes=16 * GIB,
                        cuda_graphs=cuda_graphs)
    eng.dispatch_keys = _spy_dispatches(eng.jit.executor)
    counts = {t.name: dict(programs=0, steps=0, margin=math.inf)
              for t in tenants}
    build, step, consume = (eng._build_program, eng._tenant_batched_step,
                            eng._consume)

    def build_counted(t, *a, **k):
        counts[t.name]["programs"] += 1
        return build(t, *a, **k)

    def step_counted(t, *a, **k):
        counts[t.name]["steps"] += 1
        return step(t, *a, **k)

    def consume_margin(t, logits, *a, **k):
        act = t.active_slots()
        if act:
            top = torch.topk(logits[act, -1].float(), 2, dim=-1).values
            c = counts[t.name]
            c["margin"] = min(c["margin"],
                              float((top[:, 0] - top[:, 1]).min()))
        return consume(t, logits, *a, **k)

    eng._build_program, eng._tenant_batched_step, eng._consume = \
        build_counted, step_counted, consume_margin
    trace = make_trace([n for n, *_ in FAMILY_FLEET], rate_hz=1e4,
                       n_per_tenant=n_req, prompt_len=prompt_len,
                       max_new_tokens=new_tokens, slo_s=1.0, seed=seed)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run(trace, seed=seed)
    return eng, rep, time.perf_counter() - t0, counts


# serve-families' runs, in turns: each mode graphed and eager, then each
# graphed again (vliw over batched, both graphed, is read against the
# spread of two runs)
FAMILY_TURNS = ("vliw-graphed", "vliw", "batched-graphed", "batched",
                "vliw-graphed", "batched-graphed")


def _families_graphs(cfgs, mode, counts, n_req, dispatches):
    """{kind: (captures, replays)} a graphed serve-families run must show.
    vliw: the vlm tenants' stacked decode bodies (one weight set: a key a
    sub-stack), their unembeds' dispatch graphs (a key of ``dispatches``),
    every prompt a ``Model.prefill`` call and the hybrid, audio and
    int8-KV tenants' decode steps ``Model.decode_step`` calls; batched:
    every prompt and every decode step a model call. A model call's key is
    one (weight set, method, shape): an arch here, the prompts all of one
    length."""
    want = {k: (0, 0) for k in GRAPH_KINDS}
    want["dispatch"] = _dispatch_want(dispatches)
    archs = {name: arch for name, arch, _, _ in FAMILY_FLEET}
    prompts = n_req * len(FAMILY_FLEET)
    steps = {name: c["steps"] for name, c in counts.items()}
    stepping = {archs[n] for n, k in steps.items() if k}
    keys = len(set(archs.values())) + len(stepping)
    want["monolithic"] = (keys, prompts + sum(steps.values()) - keys)
    if mode == "vliw":
        S = len(_spans(cfgs["internvl2-2b"]))
        runs = S * (counts["vlm0"]["programs"] + counts["vlm1"]["programs"])
        want["decode"] = (S, runs - S)
    return want


def _profile_monolithic(torch, eng, cfgs):
    """One monolithic decode step of the hybrid, audio and int8-KV tenants
    (``ServingEngine._decode_step`` on the tenant's slotted batch as the
    run left it), as a replay of the run's graph and eager, in turns."""
    out = {}
    st = eng.jit.executor.stats
    for name, arch, _, _ in FAMILY_FLEET:
        if name not in ("hybrid", "audio", "int8"):
            continue
        t = eng.tenants[name]

        def step(graphed, t=t):
            eng.jit.cuda_graphs = graphed
            eng._decode_step(t)

        c0 = st.monolithic_graph_captures
        out[name] = _profile_turns(
            torch, f"serve-families:{arch}" + (":int8-KV" if name == "int8"
                                               else ""),
            {"monolithic-graphed": lambda: step(True),
             "monolithic": lambda: step(False)},
            batch=t.max_batch, layers=cfgs[arch].num_layers)
        # the run's graph, replayed: no new capture
        assert st.monolithic_graph_captures == c0, name
    eng.jit.cuda_graphs = True
    return out


def phase_serve_families(torch, cg):
    """One engine of five tenants at each config's full width and depth,
    bf16: two internvl2-2b tenants on one weight set (vlm: their decode
    steps are KernelPrograms on coalesced_gemm), hymba-1.5b (hybrid),
    whisper-tiny (audio) and gemma3-1b with an int8 KV cache (the last
    three take the monolithic step). Served in vliw (stacked) and in
    batched, each graphed and eager, in turns (``FAMILY_TURNS``): a mode's
    runs give identical tokens, and each run's graphs by kind are what
    ``_families_graphs`` reckons. The monolithic tenants run the same
    Model.decode_step in both modes, so their tokens must be identical;
    the vlm tenants' projections run on the kernel in vliw and as bf16
    matmuls in batched, so their agreement is printed (their exact checks:
    stacked vs per-layer in phase 4, card vs CPU in card-vs-cpu). While
    the first graphed vliw engine lives, one monolithic decode step of the
    hybrid, audio and int8-KV tenants, graphed and eager in turns
    (``profile`` lines); at the end vliw's wall over batched's, graphs on
    and off."""
    from repro_torch.configs import get_config
    cfgs = {arch: get_config(arch) for _, arch, _, _ in FAMILY_FLEET}
    free0, total = torch.cuda.mem_get_info()
    reckoned = sum(c.param_count() * 2 for c in cfgs.values())
    models = _family_models(torch, cfgs, torch.bfloat16)
    torch.cuda.synchronize()
    free1, _ = torch.cuda.mem_get_info()
    say("serve-families",
        tenants=",".join(f"{n}:{a}" + ("(int8 KV)" if q else "")
                         for n, a, q, _ in FAMILY_FLEET),
        layers=",".join(f"{a}={c.num_layers}"
                        + (f"+{c.num_encoder_layers}enc"
                           if c.is_encdec else "")
                        for a, c in cfgs.items()),
        reckoned_param_GiB=f"{reckoned / GIB:.2f}",
        params_allocated_GiB=f"{torch.cuda.memory_allocated() / GIB:.2f}",
        mem_get_info_free_GiB=f"{free0 / GIB:.2f}->{free1 / GIB:.2f}",
        total_GiB=f"{total / GIB:.2f}")
    vlm_cfg = cfgs["internvl2-2b"]
    out, toks = {}, {}
    # vliw and batched, each graphed and eager, in turns
    for mode in FAMILY_TURNS:
        base = mode.removesuffix("-graphed")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(cg)
        eng, rep, wall, counts = _serve_fleet(
            torch, models, base, n_req=4, prompt_len=32, new_tokens=8,
            seed=5, cuda_graphs=mode.endswith("graphed"))
        launches = cg.coalesced_gemm.launches
        assert rep.unfinished == 0, rep.unfinished
        for r in rep.requests:
            assert len(r.tokens_out) == 8, (r.req_id, r.tokens_out)
        got = {r.req_id: (r.tenant, r.tokens_out) for r in rep.requests}
        # graphed and eager runs of one mode: the same tokens, tenant by
        # tenant
        assert all(got == t for m_, t in toks.items()
                   if m_.removesuffix("-graphed") == base), mode
        toks[mode] = got
        peak = torch.cuda.max_memory_allocated() / GIB
        stats = eng.jit.executor.stats
        _check_graphs("serve-families", mode, stats, eng.jit.graphs,
                      _families_graphs(cfgs, base, counts, n_req=4,
                                       dispatches=eng.dispatch_keys))
        if base == "vliw":
            _check_launches(vlm_cfg, rep, launches, True)
            assert launches > 0
            assert counts["vlm0"]["programs"] > 0
            for name in ("vlm0", "vlm1"):
                assert counts[name]["steps"] == 0
            for name in ("hybrid", "audio", "int8"):
                assert counts[name]["steps"] > 0
                assert counts[name]["programs"] == 0
            int8 = eng.tenants["int8"].cache["layers"]
            q8 = sum(int8[k].nbytes for k in ("k", "v"))
            scales = sum(int8[k].nbytes for k in ("k_scale", "v_scale"))
            bf16 = 2 * q8
            if mode not in out:
                say("serve-families", int8_cache_bytes=q8 + scales,
                    int8_values=q8, scales=scales, bf16_cache_bytes=bf16,
                    ratio=f"{(q8 + scales) / bf16:.4f}",
                    shape=tuple(int8["k"].shape))
        else:
            assert launches == 0, launches
        served = {}
        for r in rep.requests:
            served[r.tenant] = served.get(r.tenant, 0) + len(r.tokens_out)
        for name, arch, _, _ in FAMILY_FLEET:
            c = counts[name]
            say("serve-families", mode=mode, tenant=name, arch=arch,
                programs=c["programs"], monolithic_steps=c["steps"],
                tokens=served[name],
                tokens_per_run_s=f"{served[name] / wall:.2f}",
                min_top2_logit_margin=f"{c['margin']:.3e}")
        say("serve-families", mode=mode, wall_s=f"{wall:.3f}",
            tokens=rep.tokens_out,
            tokens_per_s=f"{rep.tokens_out / wall:.2f}",
            launches=launches,
            nondense_programs=(rep.jit.nondense_programs
                               if rep.jit else 0),
            scheduler_dispatches=rep.jit.superkernels if rep.jit else 0,
            graph_captures=stats.graph_captures,
            graph_replays=stats.graph_replays,
            peak_alloc_GiB=f"{peak:.2f}")
        if mode in out:
            assert launches == out[mode]["launches"], mode
            out[mode]["wall_s_turns"].append(wall)
        else:
            out[mode] = dict(wall_s=wall, wall_s_turns=[wall],
                             launches=launches, tokens=rep.tokens_out,
                             peak_alloc_GiB=peak,
                             graphs_by_kind=stats.graphs_by_kind(),
                             capture_s_by_kind=dict(eng.jit.graphs.capture_s),
                             counts={k: dict(programs=v["programs"],
                                             steps=v["steps"])
                                     for k, v in counts.items()})
            if mode == "vliw-graphed":
                out["profile"] = _profile_monolithic(torch, eng, cfgs)
        del eng, rep
        _free(torch)
    for mode in dict.fromkeys(FAMILY_TURNS):
        say("serve-families", mode=mode, wall_s_turns="/".join(
            f"{w:.3f}" for w in out[mode]["wall_s_turns"]))
    # the paper's comparison, both modes compiled: vliw's wall against
    # batched's, the medians of each mode's two runs
    for suffix in ("-graphed", ""):
        v, b = (statistics.median(out[m + suffix]["wall_s_turns"])
                for m in ("vliw", "batched"))
        out[f"vliw_over_batched{suffix}"] = v / b
        say("serve-families", graphs="on" if suffix else "off",
            vliw_wall_s=f"{v:.3f}", batched_wall_s=f"{b:.3f}",
            vliw_over_batched_wall=f"{v / b:.3f}")
    agree, first = {}, {}
    for rid, (name, a) in toks["vliw-graphed"].items():
        b = toks["batched-graphed"][rid][1]
        if name.startswith("vlm"):
            agree[name] = agree.get(name, 0) + int(a == b)
            if a != b:
                i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                first[name] = min(first.get(name, i), i)
        else:
            assert a == b, (name, rid, a, b)
    say("serve-families", tokens_vliw_graphed_vs_eager="identical",
        tokens_batched_graphed_vs_eager="identical",
        monolithic_tokens_vliw_vs_batched="identical",
        vlm_requests_agreeing=agree,
        vlm_first_differing_step=first or "none")
    out["vlm_agreeing"] = agree
    del models
    _free(torch)
    free2, _ = torch.cuda.mem_get_info()
    say("serve-families", mem_get_info_free_GiB_after=f"{free2 / GIB:.2f}",
        allocated_GiB=f"{torch.cuda.memory_allocated() / GIB:.2f}",
        reserved_GiB=f"{torch.cuda.memory_reserved() / GIB:.2f}")
    return out


def phase_card_vs_cpu_families(torch, cg):
    """card-vs-cpu for the four families, fp32, at full width: internvl2-2b
    1 layer, hymba-1.5b 2, whisper-tiny 2 + 2 (1500 frames) and gemma3-1b
    2 layers with the int8 cache; one vliw engine of the five tenants on
    each device, the same trace, weights and prompts: identical greedy
    tokens. A mismatch prints the first differing step and the smallest
    top-2 logit margin, then fails."""
    import dataclasses
    from repro_torch.configs import get_config
    depth = {"internvl2-2b": dict(num_layers=1),
             "hymba-1.5b": dict(num_layers=2),
             "whisper-tiny": dict(num_layers=2, num_encoder_layers=2),
             "gemma3-1b": dict(num_layers=2)}
    cfgs = {a: dataclasses.replace(get_config(a), **kw)
            for a, kw in depth.items()}
    gpu = _family_models(torch, cfgs, torch.float32)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    from repro_torch.models import Model
    cpu = {a: (Model(m.cfg, param_dtype=torch.float32, device="cpu",
                     kv_quant=m.kv_quant), to_cpu(p))
           for a, (m, p) in gpu.items()}
    lens = {"vlm0": 288, "vlm1": 288, "int8": 32}
    toks, margins = {}, {}
    result = {}
    for dev, models in (("cuda", gpu), ("cpu", cpu)):
        _reset_counts(cg)
        _, rep, wall, counts = _serve_fleet(torch, models, "vliw", n_req=2,
                                            prompt_len=16, new_tokens=4,
                                            seed=6, cache_lens=lens)
        assert rep.unfinished == 0
        toks[dev] = {r.req_id: r.tokens_out for r in rep.requests}
        margins[dev] = {k: v["margin"] for k, v in counts.items()}
        launches = cg.coalesced_gemm.launches
        if dev == "cuda":
            assert launches > 0
            result["launches"] = launches
        say("card-vs-cpu", model="families", dtype="float32", device=dev,
            depth=",".join(f"{a}={c.num_layers}" for a, c in cfgs.items()),
            wall_s=f"{wall:.3f}", launches=launches,
            min_top2_logit_margin={k: f"{v:.3e}"
                                   for k, v in margins[dev].items()})
    diff = _first_difference(toks["cpu"], toks["cuda"])
    if diff is not None:
        say("card-vs-cpu", model="families",
            mismatch=f"req {diff[0]} token {diff[1]}",
            min_top2_logit_margin=margins)
        raise AssertionError(f"card and CPU tokens differ: {diff}")
    say("card-vs-cpu", model="families", tokens="identical(cuda=cpu)",
        requests=len(toks["cpu"]))
    del gpu, cpu
    _free(torch)
    return result


class _RouteLog:
    """Records every MoE routing decision while it is active: the chosen
    experts and the smallest top-k margin (the k-th largest router
    probability minus the next) over the call's tokens. It wraps
    ``models.moe.route``, which the templates' glue and ``moe_ffn`` call
    through the module, and computes nothing the path uses. A stacked
    body's routing on the card runs inside its CUDA graph after the first
    step: the log sees the eager first call, and skips the capture (a
    read-back cannot be captured) and the replays (no Python runs)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route
        torch = self.torch

        def route(router, x, cfg):
            out = self.orig(router, x, cfg)
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                return out
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
        # every kind the mesh reaches replays: the decode bodies, the yi
        # tenants' prompt bodies, the mamba2 / grok-1 prompts' Model.prefill;
        # the unembeds' dispatch graphs, one a key (a pack per mesh slot)
        kinds = j.dispatch.graphs_by_kind()
        assert kinds["glue"] == (0, 0) and all(
            kinds[k][0] > 0 and kinds[k][1] > 0
            for k in ("decode", "prefill", "monolithic")), kinds
        assert kinds["dispatch"] == _dispatch_want(eng.dispatch_keys), \
            (kinds, _dispatch_want(eng.dispatch_keys))
        say("serve-mesh", num_devices=n, graphs_by_kind=",".join(
            f"{k}:{c}/{r}" for k, (c, r) in kinds.items()))
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
            graph_captures=j.dispatch.graph_captures,
            graph_replays=j.dispatch.graph_replays,
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
    # the real-clock daemon serves its decode bodies as graph replays
    assert j.dispatch.graph_replays > 0, j.dispatch.graph_replays
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
        graph_captures=j.dispatch.graph_captures,
        graph_replays=j.dispatch.graph_replays,
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
        # the default executor (its dispatch bodies CUDA graphs) and its
        # eager twin, in turns: host ms a tick until the call returns,
        # the first tick (the pack, the capture) apart
        host = {True: [], False: []}
        last = {}
        for graphed in (True, False, False, True):
            ex = SuperkernelExecutor(PlanCache(16, byte_capacity=1 << 30),
                                     bm=8, cuda_graphs=graphed)
            torch.cuda.synchronize()
            cg.coalesced_gemm.launches = 0
            gv.coalesced_gemv.launches = 0
            tick_s = []
            t0 = time.perf_counter()
            for t in range(ticks):
                t1 = time.perf_counter()
                outs = ex.matvec(list(xs[t]), weights, group="lstm")
                tick_s.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
            n_gemv = gv.coalesced_gemv.launches
            n_gemm = cg.coalesced_gemm.launches
            # replays count their launches: the same counts graphed
            if regime == "distinct":
                assert n_gemv == ticks and n_gemm == 0, (n_gemv, n_gemm)
                assert ex.stats.weight_hit_rate == (ticks - 1) / ticks, \
                    ex.stats
            else:
                assert n_gemm == ticks and n_gemv == 0, (n_gemv, n_gemm)
            kinds = ex.stats.graphs_by_kind()["dispatch"]
            assert kinds == ((1, ticks - 1) if graphed else (0, 0)), kinds
            host[graphed].append(statistics.median(tick_s[1:]))
            if graphed in last:
                for a, b in zip(outs, last[graphed][0]):
                    assert torch.equal(a, b)
            else:
                last[graphed] = (outs, tick_s[0],
                                 time.perf_counter() - t0, ex)
        for a, b in zip(last[True][0], last[False][0]):
            assert torch.equal(a, b), regime
        outs, first_s, wall, ex = last[True]
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
        steady = {k: 1e3 * statistics.mean(v) for k, v in host.items()}
        say("rnn-matvec", regime=regime, G=G, K=K, N=N, ticks=ticks,
            gemv_launches=n_gemv, gemm_launches=n_gemm,
            weight_hit_rate=f"{ex.stats.weight_hit_rate:.4f}",
            dispatches=ex.stats.dispatches,
            kernel_builds=ex.stats.retraces,
            max_abs_err_vs_cpu=f"{err:.3e}",
            graphed_vs_eager="bitwise_equal",
            host_ms_per_tick_graphed=f"{steady[True]:.4f}",
            host_ms_per_tick_eager=f"{steady[False]:.4f}",
            first_tick_ms_graphed=f"{1e3 * first_s:.3f}",
            host_ms_per_tick_coalesced=f"{1e3 * wall / ticks:.4f}",
            host_ms_per_tick_G_calls=f"{1e3 * wall_single / ticks:.4f}")
        result[regime] = dict(gemv=n_gemv, gemm=n_gemm, max_abs_err=err,
                              ms_per_tick=1e3 * wall / ticks,
                              ms_per_tick_single=1e3 * wall_single / ticks,
                              host_ms_per_tick_graphed=steady[True],
                              host_ms_per_tick_eager=steady[False])
    del ws, xs
    torch.cuda.empty_cache()
    return result


def _example(name):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, cg):
    """Each ``examples/torch_*.py`` on the card at its smoke sizes, through
    its ``main`` (which prints its own lines), with its invariants held:
    the zoo's 32 clusters and the JIT's logits against the monolithic
    decode (quickstart); tokens identical across the three modes and a
    second wave waited for (multi_tenant_serving); the collaborative bm's
    superkernel against ``a @ b`` (autotune_blocks, fp32 2e-4); the loss
    falls and the checkpoint holds the last step (train_tiny, 20 steps,
    under build/). Each line gives the example's wall seconds, ending in a
    synchronize."""
    out = {}

    def run(name, argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _example(name).main(argv)
        torch.cuda.synchronize()
        out[name] = res
        return res, time.perf_counter() - t0

    res, wall = run("quickstart", [])
    assert (res["zoo_problems"], res["clusters"]) == (70, 32), res
    assert res["launches"] > 0 and max(res["max_err"].values()) < 1e-3, res
    say("examples", example="quickstart", wall_s=f"{wall:.3f}",
        clusters=res["clusters"], launches=res["launches"],
        max_err_vs_decode_step=f"{max(res['max_err'].values()):.2e}",
        modeled_speedup=f"{res['modeled_speedup']:.2f}"
                        f"(H100 cost model, spec-sheet values)")
    res, wall = run("multi_tenant_serving", [])
    assert res["tokens_identical"], res
    assert res["two_wave"]["wait"]["waits"] >= 1
    say("examples", example="multi_tenant_serving", wall_s=f"{wall:.3f}",
        tokens_identical_across_modes=res["tokens_identical"],
        wall_s_by_mode="/".join(f"{m}:{r['wall_s']:.3f}"
                                for m, r in res["modes"].items()),
        vliw_graphs_by_kind=",".join(
            f"{k}:{c}/{r}" for k, (c, r)
            in res["modes"]["vliw"]["graphs_by_kind"].items()))
    res, wall = run("autotune_blocks", [])
    for (a, w), o in zip(res["problems"], res["outputs"]):
        torch.testing.assert_close(o, a @ w, rtol=2e-4, atol=2e-4)
    say("examples", example="autotune_blocks", wall_s=f"{wall:.3f}",
        bm=res["bm"], max_abs_err_vs_matmul=f"{res['max_err']:.2e}")
    ckpt = ROOT / "build" / "examples" / "train_tiny.npz"
    res, wall = run("train_tiny", ["--steps", "20", "--ckpt", str(ckpt)])
    assert res["last"] < res["first"] and res["ckpt_step"] == 20, res
    say("examples", example="train_tiny", wall_s=f"{wall:.3f}", steps=20,
        loss=f"{res['first']:.4f}->{res['last']:.4f}",
        train_wall_s=f"{res['wall_s']:.3f}", ckpt_step=res["ckpt_step"])
    return out


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
# 9. training: plain torch autograd, no hand-written kernel on the path
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = ("gemma3-1b", "grok-1-314b", "mamba2-2.7b", "hymba-1.5b",
                  "internvl2-2b", "whisper-tiny")


def _zero_launches(cg, gv, fa):
    cg.coalesced_gemm.launches = 0
    gv.coalesced_gemv.launches = 0
    fa.flash_attention.launches = 0


def _kernel_launches(cg, gv, fa):
    return {"coalesced_gemm": cg.coalesced_gemm.launches,
            "coalesced_gemv": gv.coalesced_gemv.launches,
            "flash_attention": fa.flash_attention.launches}


def phase_train(torch, cg, gv, fa, steps=12, warmup=2):
    """gemma3-1b at full width and depth (26 layers, d 1152, vocab 262,144
    tied), bf16 params with fp32 AdamW state and remat, B = 4, S = 2048:
    every step reaches the chunked attention (its banded branch on the
    local layers: 512 + 1024 < 2048) and four CE chunks of 512."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.hlo_analysis import PEAK_FLOPS, model_flops_for
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, batch_to_device,
                                      init_opt_state, make_train_step)
    from repro_torch.tree import leaves
    cfg = get_config("gemma3-1b")
    B, S = 4, 2048
    model = Model(cfg, param_dtype=torch.bfloat16, device="cuda", remat=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt_state = init_opt_state(params)
    n_params = sum(p.numel() for p in leaves(params))
    step_fn = make_train_step(model, OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=steps))
    data = iter(SyntheticLM(cfg, DataConfig(batch_size=B, seq_len=S,
                                            seed=0)))
    say("train", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        vocab=cfg.padded_vocab, params=n_params, dtype="bfloat16",
        opt_state="float32", remat=True, B=B, S=S,
        state_GiB=f"{torch.cuda.memory_allocated() / GIB:.3f}")
    # the step's q·kᵀ route, profiled alone before the steps (after the
    # step's long profile below the profiler recorded no device event)
    attention_route = _attention_route(torch, cfg, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches(cg, gv, fa)
    losses, ms = [], []
    for s in range(1, steps + 1):
        batch = batch_to_device(next(data), model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        say("train", step=s, loss=f"{loss:.6f}", lr=f"{float(m['lr']):.4e}",
            grad_norm=f"{float(m['grad_norm']):.6f}", ms=f"{ms[-1]:.3f}")
    # one more step under torch.profiler: where the device time goes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = batch_to_device(next(data), model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
    prof_wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            n_kernels += 1
    device_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say("train", profile="one step under torch.profiler",
        device_ms=f"{device_us / 1e3:.3f}",
        wall_ms_profiled=f"{prof_wall_us / 1e3:.3f}",
        busy_share=f"{device_us / prof_wall_us:.3f}",
        device_events=n_kernels)
    for name, us in top:
        say("train", kernel=repr(name[:90]), device_ms=f"{us / 1e3:.3f}",
            share_of_device=f"{us / max(device_us, 1e-9):.3f}")
    simt = {n: us for n, us in by_name.items() if _fp32_gemm(n)}
    say("train", fp32_simt_gemm_device_ms=f"{sum(simt.values()) / 1e3:.3f}",
        kinds=len(simt), what="p·v and the backward products, fp32 as in "
                               "the reference (q·kᵀ forward: above)")
    launches = _kernel_launches(cg, gv, fa)
    peak = torch.cuda.max_memory_allocated() / GIB
    step_ms = statistics.median(ms[warmup:])
    flops = model_flops_for(cfg, InputShape("train", S, B, "train"))
    tflops = flops / (step_ms / 1e3) / 1e12
    say("train", steps=steps, warmup_steps=warmup,
        median_ms_per_step=f"{step_ms:.3f}",
        tokens_per_s=f"{B * S / (step_ms / 1e3):.1f}",
        peak_GiB=f"{peak:.3f}", model_TFLOPs=f"{tflops:.2f}",
        model_flops_per_step=f"{flops:.4e}",
        spec_peak_TFLOPs=f"{PEAK_FLOPS / 1e12:.0f}(bf16 dense, H100 spec "
                         f"sheet)",
        share_of_spec_peak=f"{tflops * 1e12 / PEAK_FLOPS:.4f}",
        kernel_launches=launches)
    assert all(math.isfinite(x) for x in losses), losses
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3, losses
    assert not any(launches.values()), launches
    del params, opt_state, step_fn, batch
    _free(torch)
    return dict(losses=losses, ms_per_step=step_ms, peak_GiB=peak,
                model_tflops=tflops, launches=launches,
                fp32_simt_gemm_device_ms=sum(simt.values()) / 1e3,
                attention_route=attention_route)


def _fp32_gemm(name):
    """A cuBLAS GEMM of fp32 inputs (``sm80_xmma_gemm_f32f32_...``, without
    tensor cores: ``ffma``)."""
    return "gemm_f32f32" in name or "ffma" in name


def _attention_route(torch, cfg, B, reps=10):
    """The train step's q·kᵀ of one 512-query chunk against a local layer's
    band (bq + window keys), bf16, through ``qk_scores``: its forward
    kernels under ``torch.profiler`` over ``reps`` calls (none may be a
    GEMM of fp32 inputs, ``_fp32_gemm``: the product runs on the tensor
    cores in bf16 with an fp32 result; in this long process the profiler
    has recorded no device event for so short a window, so an empty list
    is printed as such, and tests/test_torch_cuda.py checks the kernels in
    a process of its own),
    and its time beside the widened fp32 einsum it replaced (CUDA events,
    median of ``reps``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.attention import Q_CHUNK, qk_scores
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    T = Q_CHUNK + cfg.window_size
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, Q_CHUNK, Hkv, H // Hkv, hd, device="cuda",
                    generator=g).bfloat16()
    k = torch.randn(B, T, Hkv, hd, device="cuda", generator=g).bfloat16()
    qk_scores(q, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            got = qk_scores(q, k)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA})
    assert not any(_fp32_gemm(n) for n in names), names
    want = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float())
    err = float((got - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err

    def ms(fn):
        ts = []
        for _ in range(reps):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            fn()
            e_ev.record()
            torch.cuda.synchronize()
            ts.append(s_ev.elapsed_time(e_ev))
        return statistics.median(ts)

    route_ms = ms(lambda: qk_scores(q, k))
    widened_ms = ms(lambda: torch.einsum("bshgd,bthd->bhgst", q.float(),
                                         k.float()))
    say("train", attention_qk=f"q [{B},{Q_CHUNK},{Hkv},{H // Hkv},{hd}] "
        f"k [{B},{T},{Hkv},{hd}] bf16", kernels=";".join(
            n[:60] for n in names) or "none_recorded_by_the_profiler",
        max_abs_err_vs_widened=f"{err:.3e}",
        ms=f"{route_ms:.4f}", widened_fp32_einsum_ms=f"{widened_ms:.4f}")
    return dict(kernels=names, ms=route_ms, widened_ms=widened_ms,
                max_abs_err=err)


def _loss_and_grads(torch, model, params, batch):
    from repro_torch.tree import leaves
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    for p in flat:
        p.requires_grad_(False)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(flat, grads)]


def phase_train_vs_cpu(torch, cg, gv, fa):
    """One train step of each smoke family, fp32, on the card and on the
    CPU from the same params and batch: loss within 2e-4, every gradient
    leaf within 1e-3 x its max-abs + 1e-6, the stepped params within 2e-4
    (lr 1e-4: a first AdamW step moves a param by at most lr)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, batch_to_device,
                                      init_opt_state, make_train_step)
    from repro_torch.tree import leaves, tree_map
    out = {}
    _zero_launches(cg, gv, fa)
    for arch in TRAIN_FAMILIES:
        cfg = smoke_config(arch)
        cpu_m = Model(cfg, param_dtype=torch.float32, device="cpu")
        gpu_m = Model(cfg, param_dtype=torch.float32, device="cuda")
        cpu_p = cpu_m.init(torch.Generator().manual_seed(1))
        gpu_p = tree_map(lambda t: t.to("cuda"), cpu_p)
        raw = next(iter(SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=24,
                                                    seed=3))))
        cpu_b, gpu_b = (batch_to_device(raw, m) for m in (cpu_m, gpu_m))
        l_cpu, g_cpu = _loss_and_grads(torch, cpu_m, cpu_p, cpu_b)
        l_gpu, g_gpu = _loss_and_grads(torch, gpu_m, gpu_p, gpu_b)
        assert abs(l_cpu - l_gpu) <= 2e-4, (arch, l_cpu, l_gpu)
        worst = 0.0
        for a, b in zip(g_cpu, g_gpu):
            err = float((a - b.cpu()).abs().max())
            tol = 1e-3 * float(a.abs().max()) + 1e-6
            assert err <= tol, (arch, err, tol)
            worst = max(worst, err / tol)
        opt = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=4)
        p1, _, m1 = make_train_step(cpu_m, opt)(cpu_p, init_opt_state(cpu_p),
                                                cpu_b)
        p2, _, m2 = make_train_step(gpu_m, opt)(gpu_p, init_opt_state(gpu_p),
                                                gpu_b)
        step_err = max(float((a - b.cpu()).abs().max())
                       for a, b in zip(leaves(p1), leaves(p2)))
        assert step_err <= 2e-4, (arch, step_err)
        say("train-vs-cpu", arch=cfg.name, loss_cpu=f"{l_cpu:.6f}",
            loss_card=f"{l_gpu:.6f}", loss_abs_err=f"{abs(l_cpu - l_gpu):.3e}",
            worst_grad_err_over_tol=f"{worst:.4f}",
            step_param_max_abs_err=f"{step_err:.3e}")
        out[arch] = dict(loss_err=abs(l_cpu - l_gpu), grad=worst,
                         step=step_err)
    launches = _kernel_launches(cg, gv, fa)
    assert not any(launches.values()), launches
    _free(torch)
    return out


def phase_train_ckpt(torch, outdir):
    """Save on the card, restore on the CPU, bitwise: smoke gemma3-1b with
    bf16 params (written widened to fp32) and fp32 AdamW state after two
    steps."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, checkpoint_step,
                                      restore_checkpoint, train)
    from repro_torch.tree import flatten_with_path, tree_map
    cfg = smoke_config("gemma3-1b")
    model = Model(cfg, param_dtype=torch.bfloat16, device="cuda")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "train_ckpt.npz")
    res = train(model, SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=64)),
                steps=2, log_every=0, checkpoint_path=path,
                checkpoint_every=2,
                opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=2))
    tree = {"params": res["params"], "opt": res["opt_state"]}
    ref = tree_map(lambda t: torch.empty_like(t, device="meta"), tree)
    back = restore_checkpoint(path, ref, device="cpu")
    n = 0
    for (p, a), (_, b) in zip(flatten_with_path(tree),
                              flatten_with_path(back)):
        assert b.device.type == "cpu" and a.dtype == b.dtype, p
        assert torch.equal(a.cpu(), b), p
        n += 1
    assert checkpoint_step(path) == 2
    say("train-ckpt", arch=cfg.name, leaves=n,
        bytes=os.path.getsize(path), card_to_cpu="bitwise_equal")
    return dict(leaves=n)


# the host records of the dryrun phase as the port traced them with the
# whole tree gathered before the forward and every MoE expert gathered
# (tensor-parallel over "model"), from `python -m repro_torch.launch.dryrun
# --all` on an H100 80GB HBM3 host, torch 2.11 (PERF.md, section 6)
WHOLE_TREE = {
    ("gemma3-1b", "single"): dict(
        flops=129362804342784.0, peak_bytes=11219135244,
        useful_flops_ratio=0.18994153391476487,
        collectives={"all-reduce": 8193170740.0, "all-gather": 14436864.0,
                     "reduce-scatter": 230989824.0}),
    ("grok-1-314b", "multi"): dict(
        flops=4025037191380992.0, peak_bytes=147207561228,
        useful_flops_ratio=0.2581558274431469,
        collectives={"all-reduce": 233064673380.0,
                     "all-gather": 26578255872.0,
                     "reduce-scatter": 55666802688.0}),
    ("llama4-maverick-400b-a17b", "single"): dict(
        flops=3068582334300160.0, peak_bytes=275276111884,
        useful_flops_ratio=0.08940012386977578,
        collectives={"all-reduce": 122396084284.0,
                     "all-gather": 6425374720.0,
                     "reduce-scatter": 102805995520.0}),
    ("llama4-maverick-400b-a17b", "multi"): dict(
        flops=1534291167150080.0, peak_bytes=319610652684,
        useful_flops_ratio=0.08940012386977578,
        collectives={"all-reduce": 158348808292.0,
                     "all-gather": 54615685120.0,
                     "reduce-scatter": 105825894400.0}),
}

# the gemma3-1b and grok-1 records as the port traced them with every
# weight gathered whole (ZeRO-3 alone: "model" ranks repeating their data
# block's step), from the same command, same host
ZERO3_ONLY = {
    "gemma3-1b": dict(flops=557632783908864.0,
                      collective_bytes=604101940.0 + 129821184.0
                      + 1395523584.0,
                      peak_bytes=53645106704,
                      useful_flops_ratio=0.044063710379696384),
    "grok-1-314b": dict(flops=2.797240044434227e+16,
                        collective_bytes=3249582180.0 + 336721870848.0
                        + 947040288768.0,
                        peak_bytes=1686651346956,
                        useful_flops_ratio=0.03714685869372955),
}


def phase_dryrun(torch, cg, gv, fa, uncounted=3):
    """The dry-run's step accounting (``launch/step_cost.py``). On the
    card: the ``train`` phase's step (gemma3-1b, bf16, remat, B 4, S 2048)
    at world 1, three times as it runs, then once under the counter on
    CUDA tensors: its dot FLOPs held equal to a trace of the same step on
    meta tensors; its counted bytes and the least time at the H100's
    spec-sheet rates beside the measured step; the counted and meta peaks
    beside ``max_memory_allocated``. On the host: fake-world traces of
    gemma3-1b ``train_4k`` on 16 × 16, grok-1-314b ``train_4k`` on
    2 × 16 × 16 and llama4-maverick ``train_4k`` on both, per chip,
    tensor-parallel over "model", each layer gathered inside its remat
    body and llama4's experts parallel over the data axes (tokens traded
    by all-to-all), each beside the same record traced with the whole
    tree gathered before the forward and the experts gathered
    (``WHOLE_TREE``): FLOPs, every collective kind's bytes, peak,
    useful-FLOPs ratio; gemma3-1b and grok-1 also beside every weight
    gathered whole (``ZERO3_ONLY``). No process group outlives the
    phase."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS, roofline
    from repro_torch.launch.step_cost import count_step
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, batch_to_device,
                                      init_opt_state, make_train_step)
    cfg = get_config("gemma3-1b")
    B, S = 4, 2048
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    meta = Model(cfg, param_dtype=torch.bfloat16, device="meta", remat=True)
    mp = meta.abstract_params()
    t0 = time.perf_counter()
    _, m_tot, m_mem = count_step(make_train_step(meta, opt_cfg), mp,
                                 init_opt_state(mp),
                                 meta.input_specs(InputShape(
                                     "train", S, B, "train")))
    meta_s = time.perf_counter() - t0

    model = Model(cfg, param_dtype=torch.bfloat16, device="cuda", remat=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt_state = init_opt_state(params)
    step = make_train_step(model, opt_cfg)
    data = iter(SyntheticLM(cfg, DataConfig(batch_size=B, seq_len=S,
                                            seed=0)))
    _zero_launches(cg, gv, fa)
    ms, losses = [], []
    for i in range(uncounted + 2):
        batch = batch_to_device(next(data), model)
        counted = i == uncounted + 1           # the first: warm-up
        torch.cuda.synchronize()
        if counted:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if counted:
            (params, opt_state, m), c_tot, c_mem = count_step(
                step, params, opt_state, batch)
        else:
            params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    max_alloc = torch.cuda.max_memory_allocated()
    launches = _kernel_launches(cg, gv, fa)
    step_ms = statistics.median(ms[1:-1])
    terms = roofline(c_tot.flops, c_tot.bytes, 0.0, 1)
    say("dryrun", where="card", arch=cfg.name, B=B, S=S, dtype="bfloat16",
        remat=True, world=1, dot_flops=f"{c_tot.flops:.6e}",
        meta_dot_flops=f"{m_tot.flops:.6e}",
        card_vs_meta="equal" if c_tot.flops == m_tot.flops else "DIFFERENT",
        counted_bytes=f"{c_tot.bytes:.6e}",
        collective_bytes=f"{c_tot.collective_bytes:.0f}")
    say("dryrun", where="card", rates=f"H100 spec sheet ({PEAK_FLOPS / 1e12:.0f}"
        f" TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s)",
        compute_ms=f"{terms.compute_s * 1e3:.3f}",
        memory_ms=f"{terms.memory_s * 1e3:.3f}",
        bound_ms=f"{terms.bound_s * 1e3:.3f}", bound_by=terms.dominant,
        measured_ms_per_step=f"{step_ms:.3f}",
        bound_share=f"{terms.bound_s * 1e3 / step_ms:.4f}")
    say("dryrun", where="card", counted_step_ms=f"{ms[-1]:.3f}",
        uncounted_step_ms=",".join(f"{x:.3f}" for x in ms[1:-1]),
        warmup_step_ms=f"{ms[0]:.3f}", meta_trace_s=f"{meta_s:.2f}")
    say("dryrun", where="card", meta_peak_GiB=f"{m_mem['peak_bytes'] / GIB:.3f}",
        counted_peak_GiB=f"{c_mem['peak_bytes'] / GIB:.3f}",
        max_memory_allocated_GiB=f"{max_alloc / GIB:.3f}",
        argument_GiB=f"{c_mem['argument_bytes'] / GIB:.3f}",
        kernel_launches=launches)
    assert c_tot.flops == m_tot.flops, (c_tot.flops, m_tot.flops)
    assert c_tot.collective_bytes == 0 and c_tot.bytes > 0
    assert all(math.isfinite(x) for x in losses), losses
    assert not any(launches.values()), launches
    del params, opt_state, step, batch
    _free(torch)
    out = {"card": dict(flops=c_tot.flops, bytes=c_tot.bytes, ms=step_ms,
                        counted_ms=ms[-1], bound_ms=terms.bound_s * 1e3)}
    out.update(_dryrun_host_records())
    assert not dist.is_initialized()
    return out


def _dryrun_host_records():
    """The dryrun phase's host records (meta tensors, a fake world), each
    beside its whole-tree twin (``WHOLE_TREE``) and, for gemma3-1b and
    grok-1, beside every weight gathered whole (``ZERO3_ONLY``)."""
    from repro_torch.launch.dryrun import dryrun_one
    out = {}
    for arch, multi in (("gemma3-1b", False), ("grok-1-314b", True),
                        ("llama4-maverick-400b-a17b", False),
                        ("llama4-maverick-400b-a17b", True)):
        rec = dryrun_one(arch, "train_4k", multi, verbose=False)
        r = rec["roofline"]
        say("dryrun", where="host (meta tensors, fake world, per chip, "
            "H100 spec-sheet rates)", arch=arch, shape="train_4k",
            mesh=rec["mesh"], chips=rec["chips"],
            flops=f"{rec['flops']:.6e}", bytes=f"{rec['bytes']:.6e}",
            **{k.replace("-", "_"): f"{v:.6e}"
               for k, v in rec["collectives"].items()},
            peak_bytes=f"{rec['memory']['peak_bytes']:.6e}",
            compute_s=f"{r['compute_s']:.4f}",
            memory_s=f"{r['memory_s']:.4f}",
            collective_s=f"{r['collective_s']:.4f}",
            useful_flops_ratio=f"{r['useful_flops_ratio']:.4f}",
            dominant=r["dominant"], trace_s=f"{rec['trace_s']:.2f}")
        whole = WHOLE_TREE[(arch, rec["mesh"])]
        kinds = sorted(set(rec["collectives"]) | set(whole["collectives"]))
        say("dryrun", where="host", arch=arch, mesh=rec["mesh"],
            compare="gathered a layer at a time, experts parallel over the "
            "data axes where they divide them, vs the whole tree gathered "
            "(the same trace before, H100 80GB HBM3 host, torch 2.11)",
            flops=f"{rec['flops']:.6e}",
            flops_before=f"{whole['flops']:.6e}",
            **{f"{k.replace('-', '_')}": f"{rec['collectives'].get(k, 0):.6e}"
               for k in kinds},
            **{f"{k.replace('-', '_')}_before":
               f"{whole['collectives'].get(k, 0):.6e}" for k in kinds},
            peak_bytes=f"{rec['memory']['peak_bytes']:.6e}",
            peak_bytes_before=f"{whole['peak_bytes']:.6e}",
            useful_flops_ratio=f"{r['useful_flops_ratio']:.4f}",
            useful_flops_ratio_before=f"{whole['useful_flops_ratio']:.4f}")
        assert rec["memory"]["peak_bytes"] < whole["peak_bytes"], rec
        out[(arch, rec["mesh"])] = rec
        if arch.startswith("llama4"):
            # 128 experts divide the data axes: the tokens go to them
            assert rec["collectives"].get("all-to-all", 0) > 0, rec
            assert rec["collectives"]["reduce-scatter"] < \
                whole["collectives"]["reduce-scatter"], rec
            continue
        old = ZERO3_ONLY[arch]
        coll = sum(rec["collectives"].values())
        say("dryrun", where="host", arch=arch, compare="tensor-parallel "
            "over model vs ZeRO-3 alone (the same trace before the "
            "model-axis compute, H100 80GB HBM3 host, torch 2.11)",
            flops=f"{rec['flops']:.6e}", flops_before=f"{old['flops']:.6e}",
            flops_ratio=f"{rec['flops'] / old['flops']:.4f}",
            collective_bytes=f"{coll:.6e}",
            collective_bytes_before=f"{old['collective_bytes']:.6e}",
            peak_bytes=f"{rec['memory']['peak_bytes']:.6e}",
            peak_bytes_before=f"{old['peak_bytes']:.6e}",
            useful_flops_ratio=f"{r['useful_flops_ratio']:.4f}",
            useful_flops_ratio_before=f"{old['useful_flops_ratio']:.4f}")
        assert rec["collectives"].get("all-gather", 0) > 0, rec
        assert "all-to-all" not in rec["collectives"], rec
        assert rec["flops"] < old["flops"], (rec["flops"], old["flops"])
    return out


def _production_step_bitwise(torch):
    """One production step at world 1 on the card (nccl, the (1, 1)
    DeviceMesh, DTensor params and optimizer state, each weight gathered at
    use, a layer's inside its remat body) against the plain step from the
    same params and batch: loss, grad norm, every stepped param and second
    moment bitwise equal. gemma3-1b and grok-1 smoke, bf16 params. The
    step runs under ``step_cost``'s counter: a data axis of 1 holds every
    expert, so it issues no all-to-all (0 bytes of that kind)."""
    import torch.distributed as dist
    from repro_torch.configs import smoke_config
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.launch.mesh import (ensure_process_group,
                                         make_host_mesh, production_state)
    from repro_torch.launch.step_cost import count_step
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, batch_to_device,
                                      init_opt_state, make_train_step)
    from repro_torch.tree import leaves, tree_map
    started = ensure_process_group("cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_host_mesh("cuda")
        for arch in ("gemma3-1b", "grok-1-314b"):
            cfg = smoke_config(arch)
            model = Model(cfg, param_dtype=torch.bfloat16, device="cuda",
                          remat=True)
            batch = batch_to_device(next(iter(SyntheticLM(
                cfg, DataConfig(batch_size=4, seq_len=64, seed=2)))), model)
            params = model.init(torch.Generator(device="cuda").manual_seed(3))
            plain = tree_map(torch.clone, params)
            step = make_train_step(model, OptimizerConfig(
                lr=1e-3, warmup_steps=1, total_steps=4))
            p1, s1, m1 = step(plain, init_opt_state(plain), batch)
            dparams, dopt, hints = production_state(model, params, mesh, 4)
            with activation_sharding(hints):
                (p2, s2, m2), counted, _ = count_step(step, dparams, dopt,
                                                      batch)
            coll = counted.per_collective
            same = (torch.equal(m1["loss"], m2["loss"])
                    and torch.equal(m1["grad_norm"], m2["grad_norm"])
                    and all(torch.equal(a, b.full_tensor()) for a, b in
                            zip(leaves(p1) + leaves(s1.nu),
                                leaves(p2) + leaves(s2.nu))))
            say("train-cli", check="production_step_world_1", arch=arch,
                dtype="bfloat16", backend="nccl",
                loss=f"{float(m2['loss']):.6f}",
                vs_plain_step="bitwise_equal" if same else "DIFFERENT",
                all_to_all_bytes=f"{coll['all-to-all']:.0f}",
                collective_bytes=f"{counted.collective_bytes:.0f}")
            assert same, arch
            assert coll["all-to-all"] == 0, coll
    finally:
        if started:
            dist.destroy_process_group()


def _remat_recompute_keeps_hints(torch):
    """grok-1 smoke on the card, fp32, under the ``moe_groups = 2`` hint
    (two token groups, each routed with its own capacity): the loss and
    gradients of ``loss_and_grads`` with remat bitwise those without. On
    CUDA the backward, and with it the remat recompute, runs on the
    autograd engine's own thread, which the recompute must not leave
    without the forward's hints (``hints.carry``)."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, SyntheticLM,
                                      batch_to_device, loss_and_grads)
    from repro_torch.tree import leaves
    cfg = smoke_config("grok-1-314b")
    out = {}
    for remat in (False, True):
        model = Model(cfg, param_dtype=torch.float32, device="cuda",
                      remat=remat)
        params = model.init(torch.Generator(device="cuda").manual_seed(3))
        batch = batch_to_device(next(iter(SyntheticLM(
            cfg, DataConfig(batch_size=4, seq_len=64, seed=2)))), model)
        with activation_sharding({"moe_groups": 2}):
            out[remat] = loss_and_grads(model, params, batch)
    (l0, g0), (l1, g1) = out[False], out[True]
    pairs = list(zip(leaves(g0), leaves(g1)))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    same = torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in pairs)
    say("train-cli", check="remat_recompute_hints", arch=cfg.name,
        dtype="float32", moe_groups=2, grad_leaves=len(pairs),
        max_abs_diff=f"{err:.3e}",
        vs_no_remat="bitwise_equal" if same else "DIFFERENT")
    assert same, err


def phase_train_cli(torch):
    """The training launcher as a user runs it, on the card: smoke (fp32,
    20 steps) and --production (gemma3-1b full config, bf16, remat, 5 steps
    on the 1x1 DeviceMesh, world 1, nccl: the median ms a step of steps
    2-5 from its step lines); before them, one production step at world 1
    held bitwise to the plain step, and a remat step under an MoE group
    hint held bitwise to the same step without remat."""
    _production_step_bitwise(torch)
    _remat_recompute_keeps_hints(torch)
    out = {}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for label, extra in (("smoke", ["--steps", "20"]),
                         ("production", ["--production", "--steps", "5"])):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        secs = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines[:1] + lines[-3:]:
            print(f"    {line}", flush=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert "device=cuda" in lines[0], lines[0]
        kv = {}
        if label == "production":
            assert "mesh={'data': 1, 'model': 1} world=1" in lines[0], \
                lines[0]
            ms = [float(m) for m in re.findall(
                r"^step +\d+ loss \S+ lr \S+ ms (\S+)", proc.stdout, re.M)]
            assert len(ms) == 5, proc.stdout
            kv = dict(world=1, backend="nccl",
                      ms_per_step_median=f"{statistics.median(ms[1:]):.1f}",
                      ms_per_step=",".join(f"{m:.1f}" for m in ms))
        say("train-cli", mode=label, command=" ".join(cmd[1:]),
            rc=proc.returncode, seconds=f"{secs:.1f}", **kv)
        out[label] = dict(rc=proc.returncode, seconds=secs, **kv)
    return out


def _world_ranks(cmd, run_dir, env, world, timeout_s):
    """``cmd`` as ``world`` fresh interpreters (gloo ranks of a
    ``file://`` rendezvous under ``run_dir``), each in a session of its
    own: rank 0's stdout once all exit 0 (the others print nothing). Past
    ``timeout_s`` their sessions are killed."""
    import signal
    procs, logs = [], []
    for r in range(world):
        so, se = run_dir / f"rank{r}.out", run_dir / f"rank{r}.err"
        logs.append((so, se))
        with open(so, "w") as fo, open(se, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, *cmd, "--init-method",
                 (run_dir / "pg").as_uri(), "--pg-timeout-s", "60"],
                cwd=ROOT, stdout=fo, stderr=fe,
                stdin=subprocess.DEVNULL, start_new_session=True,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r))))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    rcs = [p.returncode for p in procs]
    errs = "".join(se.read_text()[-2000:] for _, se in logs)
    assert rcs == [0] * world, (rcs, errs)
    assert not any(so.read_text() for so, _ in logs[1:])
    return logs[0][0].read_text()


def _step_losses(text):
    return [float(m) for m in re.findall(r"^step +\d+ loss (\S+)", text,
                                         re.M)]


def _moe_one_process(torch, arch, groups, steps, batch_size, seq_len):
    """The launcher's ``--production --smoke --dtype float32`` steps of
    ``arch`` (its init, data, optimizer and remat) in this process on the
    CPU, the plain step under ``moe_groups = groups`` (the token groups
    the ranks route): the losses."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.models import Model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, batch_to_device,
                                      init_opt_state, make_train_step)
    cfg = smoke_config(arch)
    model = Model(cfg, param_dtype=torch.float32, device="cpu", remat=True)
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    opt = init_opt_state(params)
    step = make_train_step(model, OptimizerConfig(
        lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps))
    it = iter(SyntheticLM(cfg, DataConfig(batch_size=batch_size,
                                          seq_len=seq_len)))
    losses = []
    with activation_sharding({"moe_groups": groups}):
        for _ in range(steps):
            params, opt, m = step(params, opt,
                                  batch_to_device(next(it), model))
            losses.append(float(m["loss"]))
    return losses


def phase_train_world(torch, outdir, world=4, timeout_s=300):
    """The launcher's --production --smoke run (gemma3-1b reduced config,
    fp32, remat) on the CPU as four gloo ranks on the (data 2, model 2)
    mesh, each a fresh interpreter in a session of its own with a
    ``file://`` rendezvous under ``outdir``, the FFN and the vocabulary
    tensor-parallel over "model", each layer gathered inside its remat
    body, against the same run at world 1: the 3 losses within 2e-4; then
    the trained params served on each mesh (``--decode-steps 4``: a
    prefill, then greedy steps on the cache sequence-sharded over "model"
    at world 4), tokens identical. Then the MoE production step with the
    experts parallel over "data", the dispatched tokens traded by
    all-to-all: grok-1 smoke on (2, 2) (4 experts, 2 a rank) and llama4
    smoke on (4, 1) (1 a rank), four ranks each, the 3 losses within 2e-4
    of one process's plain steps under ``moe_groups`` = the data ranks
    (``_moe_one_process``). The card holds one rank, so these worlds run
    on the host's cores."""
    import shutil
    base = ["-m", "repro_torch.launch.train", "--production", "--smoke",
            "--device", "cpu", "--dtype", "float32", "--steps", "3",
            "--batch-size", "4", "--seq-len", "32"]
    run_dir = Path(outdir) / "train_world"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)

    def decoded(text):
        return re.findall(r"^decode tokens=(\S+)$", text, re.M)

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)
    t0 = time.perf_counter()
    dense = base + ["--decode-steps", "4"]
    one = subprocess.run([sys.executable, *dense], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout_s)
    assert one.returncode == 0, one.stderr[-4000:]
    want = _step_losses(one.stdout)
    out0 = _world_ranks(dense + ["--mesh", "2,2"], run_dir, env, world,
                        timeout_s)
    secs = time.perf_counter() - t0
    first = out0.splitlines()[0]
    print(f"    {first}", flush=True)
    assert "mesh={'data': 2, 'model': 2} world=4" in first, first
    got = _step_losses(out0)
    err = max(abs(a - b) for a, b in zip(got, want))
    say("train-world", device="cpu", ranks=world, mesh="data=2,model=2",
        backend="gloo", dtype="float32", arch="gemma3-1b-smoke",
        compute="ffn and vocab tensor-parallel over model, each layer "
        "gathered in its remat body",
        losses=",".join(f"{v:.6f}" for v in got),
        world_1=",".join(f"{v:.6f}" for v in want),
        max_abs_diff=f"{err:.2e}", tol="2e-4", seconds=f"{secs:.1f}")
    assert len(got) == len(want) == 3 and err <= 2e-4, (got, want)
    toks, toks_1 = decoded(out0), decoded(one.stdout)
    same = len(toks) == len(toks_1) == 1 and toks == toks_1
    say("train-world", decode="prefill 16 + 4 greedy steps, batch 4, "
        "cache 32 sequence-sharded over model (16 a rank)",
        tokens=toks[0] if toks else "none",
        decode_tokens_world_4_vs_1="identical" if same else "DIFFERENT")
    assert same, (toks, toks_1)
    out = dict(losses=got, world_1=want, max_abs_diff=err,
               decode_tokens=toks[0])
    for arch, sizes in (("grok-1-314b", (2, 2)),
                        ("llama4-maverick-400b-a17b", (4, 1))):
        moe_dir = run_dir / arch
        moe_dir.mkdir()
        t0 = time.perf_counter()
        out0 = _world_ranks(base + ["--arch", arch, "--mesh",
                                    f"{sizes[0]},{sizes[1]}"],
                            moe_dir, env, world, timeout_s)
        secs = time.perf_counter() - t0
        mesh = f"data={sizes[0]},model={sizes[1]}"
        assert f"mesh={{'data': {sizes[0]}, 'model': {sizes[1]}}} world=4" \
            in out0.splitlines()[0], out0
        got = _step_losses(out0)
        want = _moe_one_process(torch, arch, sizes[0], 3, 4, 32)
        err = max(abs(a - b) for a, b in zip(got, want))
        say("train-world", device="cpu", ranks=world, mesh=mesh,
            backend="gloo", dtype="float32", arch=f"{arch}-smoke",
            compute=f"experts parallel over data ({sizes[0]} ranks, "
            "tokens by all-to-all), d_ff over model",
            losses=",".join(f"{v:.6f}" for v in got),
            one_process_moe_groups=",".join(f"{v:.6f}" for v in want),
            moe_groups=sizes[0], max_abs_diff=f"{err:.2e}", tol="2e-4",
            seconds=f"{secs:.1f}")
        assert len(got) == len(want) == 3 and err <= 2e-4, (got, want)
        out[arch] = dict(losses=got, one_process=want, max_abs_diff=err)
    return out


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
    tuned, tuned_bms = timed_phase("serve-tuned", phase_serve_tuned, torch,
                                   cg)
    flush = torch.zeros(64 << 20, device="cuda")
    bm_shapes = timed_phase("kernel-bm", phase_kernel_bm, torch, cg,
                            coalesced_gemm_ref, flush,
                            tuned_bms | {16, 32, 64})
    del flush
    torch.cuda.empty_cache()
    grouped = timed_phase("serve-grouped", phase_serve_grouped, torch, cg,
                          timed)
    dispatch = timed_phase("dispatch-graphs", phase_dispatch_graphs, torch,
                           cg, timed)
    moe = timed_phase("serve-moe", phase_serve_moe, torch, cg, timed)
    ssm = timed_phase("serve-ssm", phase_serve_ssm, torch, cg, timed)
    mesh = timed_phase("serve-mesh", phase_serve_mesh, torch, cg)
    daemon = timed_phase("serve-daemon", phase_serve_daemon, torch, cg)
    timed_phase("serve-cli", phase_serve_cli, torch)
    # after the mesh and the daemon: the free memory it leaves lower
    # (printed at its end) cut serve-mesh's depth when it ran before it
    families = timed_phase("serve-families", phase_serve_families, torch,
                           cg)
    cpu = timed_phase("card-vs-cpu", phase_card_vs_cpu, torch, cg)
    cpu_nondense = timed_phase("card-vs-cpu (moe, ssm)",
                               phase_card_vs_cpu_nondense, torch, cg)
    cpu_families = timed_phase("card-vs-cpu (families)",
                               phase_card_vs_cpu_families, torch, cg)
    rnn = timed_phase("rnn-matvec", phase_rnn_matvec, torch, cg, gv)
    attn = timed_phase("windowed-attention", phase_windowed_attention,
                       torch, fa)
    examples = timed_phase("examples", phase_examples, torch, cg)
    timed_phase("train", phase_train, torch, cg, gv, fa)
    timed_phase("train-vs-cpu", phase_train_vs_cpu, torch, cg, gv, fa)
    timed_phase("train-ckpt", phase_train_ckpt, torch, ROOT / "build")
    # before train-cli and train-world, which start real process groups
    timed_phase("dryrun", phase_dryrun, torch, cg, gv, fa)
    timed_phase("train-cli", phase_train_cli, torch)
    timed_phase("train-world", phase_train_world, torch, ROOT / "build")
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
    runs = ("stacked-graphed", "stacked", "per-layer")
    by_phase = {f"{phase} ({regime})": out[regime]["launches"]
                for phase, out in (("serve-shared", shared),
                                   ("serve-grouped", grouped),
                                   ("serve-moe", moe), ("serve-ssm", ssm),
                                   ("card-vs-cpu", cpu))
                for regime in runs if regime in out}
    by_phase.update({f"card-vs-cpu {k}": n for k, n in cpu_nondense.items()})
    by_phase["card-vs-cpu families (stacked)"] = cpu_families["launches"]
    by_phase.update({f"serve-tuned ({label}, stacked)": run["launches"]
                     for label, run in tuned.items()})
    by_phase.update({f"serve-families ({mode}, stacked)":
                     families[mode]["launches"]
                     for mode in ("vliw-graphed", "vliw")})
    by_phase.update({f"serve-mesh (stacked, {n} device{'s' * (n > 1)})":
                     mesh[n]["launches"] for n in (1, 2)})
    by_phase.update({
        "serve-daemon (run)": daemon["virtual"]["launches_run"],
        "serve-daemon (virtual clock)": daemon["virtual"]["launches_door"],
        "serve-daemon (real clock)": daemon["real"]["launches"]})
    by_phase.update({f"dispatch-graphs ({regime})": dispatch[regime]
                     ["launches"] for regime in ("per-layer-graphed",
                                                 "per-layer")})
    by_phase["examples (quickstart)"] = examples["quickstart"]["launches"]
    by_phase["rnn-matvec (shared)"] = rnn["shared"]["gemm"]
    kernels = [
        entry("coalesced_gemm", "src/repro/kernels/coalesced_gemm.py:43",
              shared["stacked-graphed"]["launches"], by_phase,
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
    kernels[0]["tuned_bm"] = bm_shapes
    kernels[0]["launches_by_bm"] = {
        f"serve-tuned ({label})": run["launches_by_bm"]
        for label, run in tuned.items()}
    kernels[0]["launches_by_shape"] = {
        f"{phase} ({regime})": out[regime]["launches_by_shape"]
        for phase, out in (("serve-shared", shared),
                           ("serve-grouped", grouped),
                           ("serve-moe", moe), ("serve-ssm", ssm))
        for regime in runs if regime in out}
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
