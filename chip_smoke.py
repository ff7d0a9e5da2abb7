#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and ``nvcc``
(``/usr/local/cuda``); it imports nothing of JAX or of the JAX package.
Phases, each printing its own lines; a failing phase raises:

  1. device      — the card's name and power limit (nvidia-smi);
  2. build       — nvcc builds every kernel library from the sources, one
                   nvcc per source, all started together, with each
                   kernel's ptxas lines (registers, shared memory, spills);
                   one line per ``flash_attention`` instance (dtype, head
                   dim) with its MMA path, registers, spill bytes (must be
                   0) and the HMMA instructions in its SASS (``cuobjdump
                   -sass``; must be > 0: the instance runs on tensor cores);
  3. kernel      — ``coalesced_gemm`` (CUDA) against its plain PyTorch
                   version at the serving path's shapes, fp32 and bf16, with
                   CUDA-event times of the kernel, the plain version and one
                   PyTorch library call, beside the least time the card
                   could take (bytes at 3.35 TB/s, or operations at the
                   peak rate of their type: 67 TFLOP/s fp32 without tensor
                   cores, 989 TFLOP/s bf16; fp32 attention at the 3xTF32
                   rate, a third of 495 TFLOP/s TF32);
     kernel-gemv — ``coalesced_gemv`` (CUDA) the same way at the LSTM shape
                   of the RNN bench (G = 2, 4, 8; K = 2048, N = 4096) and at
                   the yi-9b decode envelope [4, 4096, 16384]; library call
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
                   tokens, 8 new tokens;
  5. serve-grouped — two full-width yi-9b tenants with distinct weights
                   (bf16, 12 layers): the kernel runs with G >= 2 weight
                   matrices;
  6. card-vs-cpu — full-width yi-9b, fp32, 1 layer, two tenants with
                   distinct weights (the grouped regime, G = 2): the same
                   trace, weights and prompts served on the card (kernel)
                   and on the CPU (plain versions) give identical greedy
                   tokens;
  7. rnn-matvec  — the matvec regime's path: ``SuperkernelExecutor.matvec``
                   at the LSTM shape (fp32, G = 4) for 20 ticks, distinct
                   weights (``coalesced_gemv``) and shared weights
                   (``coalesced_gemm``), outputs against ``ops.coalesced_
                   matvec`` on the card and the CPU plain path; prints the
                   coalescer's decision and host time per tick;
  8. windowed-attention — ``ops.windowed_attention`` at the gemma3-1b local
                   shape on the card against the CPU plain path;
  9. the kernel table as one JSON line, then the result line.

Launch counts are set to 0 just before each path phase (4-8) and read just
after it; the comparisons of phase 3 are not counted there. Weights and
inputs are random, made from fixed seeds.
"""
from __future__ import annotations

import gc
import json
import math
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
# fp32 attention runs as 3xTF32 on the tensor cores (three TF32 products a
# product, each at the 495 TFLOP/s TF32 peak): its least time is at that rate
ATTN_PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# (rtol, atol) of kernel against plain version. Both add in IEEE fp32, in
# different orders, so their sums differ by a few fp32 ulps (outputs are of
# order 1: B is scaled by 1/sqrt(K)); bf16 then rounds both sums to bf16,
# so a sound kernel is at most one bf16 ulp (2^-7 relative) off. A kernel that accumulates in bf16, or drops a K
# slice, is several times further off than that.
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-4)}
GIB = 1 << 30


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_ms(fn, reps: int = 15, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of one call, in ms. ``flush``: a tensor
    larger than the 50 MB L2 cache, overwritten before every timed call
    (outside its events) so the call finds its operands in device memory."""
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
    return statistics.median(s.elapsed_time(e) for s, e in events)


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
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


_INSTANCE = re.compile(r"flash_kernelI(f|13__nv_bfloat16)Li(\d+)E")


def _instance(symbol):
    """'bfloat16/128' for a mangled flash_kernel<T, D> symbol, else None."""
    m = _INSTANCE.search(symbol)
    if m is None:
        return None
    return f"{'float32' if m.group(1) == 'f' else 'bfloat16'}/{m.group(2)}"


def _ptxas_per_instance(log):
    """{instance: (registers, spill bytes)} from ptxas -v lines."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", ln)
        if m:
            cur = _instance(m.group(1))
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


def _hmma_per_instance(build, path):
    """{instance: HMMA count} in the SASS of the built library (the
    cuobjdump of the toolkit that built it)."""
    sass = subprocess.run(
        [str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(path)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = _instance(m.group(1))
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
    # the wrapper's count of the attention kernel's dynamic shared memory is
    # the source's, for every dtype and head dim
    lib = libs[-1].lib
    for dtype, code in fa.DTYPE_CODES.items():
        for d in fa.HEAD_DIMS:
            assert lib.flash_attention_smem_bytes(d, code) == \
                fa.smem_bytes(d, dtype), (dtype, d)
    # every attention instance runs on tensor cores (HMMA in its SASS) and
    # keeps its registers (no spills)
    ptxas = _ptxas_per_instance(libs[-1].log)
    hmma = _hmma_per_instance(build, libs[-1].path)
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
    # (label, rows per problem, K, N, shared weights)
    ("yi-9b decode grouped (ffn gate/up)", (4, 4), 4096, 16384, False),
    ("shared regime (ffn down)", (8,), 16384, 4096, True),
    ("ragged prefill+decode (attn wq/wo)", (32, 4), 4096, 4096, False),
    ("unembed", (8,), 4096, 65536, True),
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


def phase_kernel(torch, cg, ref):
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
            kernel_ms = time_ms(lambda: cg.coalesced_gemm(a, b, gid, bm=8))
            plain_ms = time_ms(lambda: ref(a, b, gid, 8), reps=5)
            if G == 1:
                bw = b[0]
                library_ms = time_ms(lambda: torch.matmul(a, bw))
                library = "torch.matmul"
            else:
                tiles = a.view(M // 8, 8, K)
                b_tile = b[gid.long()].contiguous()
                library_ms = time_ms(lambda: torch.bmm(tiles, b_tile))
                library = "torch.bmm"
                del b_tile
            db = a.element_size()
            moved = (M * K + G * K * N + M * N) * db + gid.numel() * 4
            flops = 2.0 * M * K * N
            t_bytes = moved / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[dname]
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            row = dict(shape=label, dtype=dname, M=M, K=K, N=N, G=G,
                       max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, library=library,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows_out.append(row)
            say("kernel", shape=repr(label), dtype=dname,
                A=f"[{M},{K}]", B=f"[{G},{K},{N}]", max_abs_err=f"{err:.3e}",
                kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}({library})",
                bound_ms=f"{bound_ms:.4f}({bound_by})",
                bound_share=f"{bound_ms / kernel_ms:.3f}")
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
            kernel_ms = time_ms(lambda: gv.coalesced_gemv(x, w), flush=flush)
            plain_ms = time_ms(lambda: ref(x, w), reps=5, flush=flush)
            x3 = x[:, None]
            library_ms = time_ms(lambda: torch.bmm(x3, w), flush=flush)
            db = x.element_size()
            bound_ms, bound_by = _bound((G * K + G * K * N + G * N) * db,
                                        2.0 * G * K * N, dname)
            rows_out.append(dict(
                shape=label, dtype=dname, G=G, K=K, N=N, max_abs_err=err,
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                library="torch.bmm", bound_ms=bound_ms, bound_by=bound_by))
            say("kernel-gemv", shape=repr(label), dtype=dname,
                x=f"[{G},{K}]", w=f"[{G},{K},{N}]", max_abs_err=f"{err:.3e}",
                kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{library_ms:.4f}(torch.bmm)",
                bound_ms=f"{bound_ms:.4f}({bound_by})",
                bound_share=f"{bound_ms / kernel_ms:.3f}")
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
                                        ATTN_PEAK_FLOPS)
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


def _layer_bytes(cfg, db):
    """(param bytes, padded-pack bytes) of one decoder layer."""
    from repro_torch.kernels.ops import envelope_bucket as eb
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
              (d, cfg.num_kv_heads * hd), (cfg.num_heads * hd, d),
              (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    params = sum(k * n for k, n in shapes) * db + 2 * d * db
    packs = sum(eb(k) * eb(n) for k, n in shapes) * db
    return params, packs


def _serve(torch, cfg, tenants_params, *, n_req, prompt_len, new_tokens,
           budget, seed):
    from repro_torch.serving import ServingEngine, Tenant, make_trace
    names = [f"t{i}" for i in range(len(tenants_params))]
    trace = make_trace(names, rate_hz=1e4, n_per_tenant=n_req,
                       prompt_len=prompt_len, max_new_tokens=new_tokens,
                       slo_s=1.0, seed=seed)
    tenants = [Tenant(n, m, p, cache_len=prompt_len + new_tokens + 8,
                      max_batch=4)
               for n, (m, p) in zip(names, tenants_params)]
    # per-layer emission declares 7 weights a layer: room for every
    # packed entry of both regimes (shared and singleton) of 48 layers
    eng = ServingEngine(tenants, mode="vliw", weight_budget_bytes=budget,
                        plan_capacity=1024,
                        device=tenants_params[0][0].device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run(trace, seed=seed)       # ends in a synchronize
    wall = time.perf_counter() - t0
    return eng, rep, wall


def _report_serve(torch, phase, cfg, rep, wall, launches, max_groups):
    L = cfg.num_layers
    j = rep.jit
    stages = 7 * L + 1
    programs = j.ops_executed / stages
    toks = rep.tokens_out
    say(phase, wall_s=f"{wall:.3f}", tokens=toks,
        tokens_per_s=f"{toks / wall:.2f}", launches=launches,
        superkernels=j.superkernels, ops=j.ops_executed,
        programs=f"{programs:.1f}",
        stages_per_program=f"{stages}(7*L+1)",
        launches_per_program=f"{launches / programs:.1f}",
        mean_group=f"{j.mean_group:.3f}", shared=j.shared_dispatches,
        prefill_coalesced=j.prefill_coalesced,
        weight_hit_rate=f"{j.dispatch.weight_hit_rate:.4f}",
        weight_invalidations=j.dispatch.weight_invalidations,
        kernel_builds=j.dispatch.retraces, max_G=max_groups,
        peak_alloc_GiB=f"{torch.cuda.max_memory_allocated() / GIB:.2f}",
        modeled_ms=f"{rep.modeled_time_s * 1e3:.3f}(H100 cost model)")


def _check_served(rep, cfg, n_expected, new_tokens):
    assert len(rep.requests) == n_expected and rep.unfinished == 0, \
        (len(rep.requests), rep.unfinished)
    for r in rep.requests:
        assert r.tokens_out is not None and len(r.tokens_out) == new_tokens, \
            (r.req_id, r.tokens_out)
        assert all(0 <= t < cfg.padded_vocab for t in r.tokens_out)


def phase_serve_shared(torch, cg):
    from repro_torch.models import Model
    db = 2
    free, _ = torch.cuda.mem_get_info()
    cfg48 = _full_yi(48)
    p_layer, k_layer = _layer_bytes(cfg48, db)
    emb = cfg48.padded_vocab * cfg48.d_model * db
    fixed = 4 * emb                  # embed, unembed, two unembed packs
    margin = 6 * GIB                 # activations, workspaces, allocator
    L = min(48, int((free - margin - fixed) // (p_layer + 2 * k_layer)))
    if L < 48:
        say("serve-shared", depth_cut=f"48->{L}",
            reason=f"free={free / GIB:.1f}GiB holds params+2 packs of "
                   f"{L} layers only")
    assert L >= 1
    cfg = _full_yi(L)
    torch.cuda.reset_peak_memory_stats()
    m = Model(cfg, param_dtype=torch.bfloat16)
    params = m.init(torch.Generator(device=m.device).manual_seed(1))
    budget = int(free - margin - L * p_layer - 2 * emb)
    say("serve-shared", layers=L, d_model=cfg.d_model, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
        param_GiB=f"{(L * p_layer + 2 * emb) / GIB:.2f}",
        pack_GiB_per_regime=f"{(L * k_layer + emb) / GIB:.2f}",
        weight_budget_GiB=f"{budget / GIB:.2f}")
    cg.coalesced_gemm.launches = 0
    cg.coalesced_gemm.max_groups = 0
    eng, rep, wall = _serve(torch, cfg, [(m, params), (m, params)],
                            n_req=4, prompt_len=32, new_tokens=8,
                            budget=budget, seed=0)
    launches, max_g = cg.coalesced_gemm.launches, cg.coalesced_gemm.max_groups
    _check_served(rep, cfg, 8, 8)
    assert launches > 0 and launches == rep.jit.superkernels
    assert rep.jit.shared_dispatches > 0 and rep.jit.mean_group > 1.0
    _report_serve(torch, "serve-shared", cfg, rep, wall, launches, max_g)
    # one more decode step of tenant 0 through its cached template: finite
    # logits of the expected shape, beside the plain Model.decode_step
    t = eng.tenants["t0"]
    from repro_torch.core.jit import build_dense_decode_template
    prog = build_dense_decode_template(m, params, t.max_batch).bind(
        stream_id=0, tokens=t.slot_tok, cache=t.cache)
    eng.jit.run([prog])
    logits = prog.env["logits"].float()
    assert tuple(logits.shape) == (t.max_batch, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    want, _ = m.decode_step(params, t.slot_tok, t.cache)
    diff = float((logits - want[:, 0].float()).abs().max())
    agree = float((logits.argmax(-1) == want[:, 0].argmax(-1)).float()
                  .mean())
    say("serve-shared", extra_step_logits="finite",
        max_abs_diff_vs_Model_decode_step_bf16=f"{diff:.4f}",
        argmax_agreement=f"{agree:.2f}")
    result = dict(layers=L, launches=launches, wall_s=wall,
                  tokens=rep.tokens_out)
    del eng, rep, prog, params, m, t, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_serve_grouped(torch, cg):
    from repro_torch.models import Model
    L = 12
    cfg = _full_yi(L)
    free, _ = torch.cuda.mem_get_info()
    p_layer, _ = _layer_bytes(cfg, 2)
    emb = cfg.padded_vocab * cfg.d_model * 2
    params_bytes = 2 * (L * p_layer + 2 * emb)
    budget = int(free - params_bytes - 6 * GIB)
    torch.cuda.reset_peak_memory_stats()
    tp = []
    for i in range(2):
        m = Model(cfg, param_dtype=torch.bfloat16)
        tp.append((m, m.init(torch.Generator(device=m.device)
                             .manual_seed(10 + i))))
    say("serve-grouped", layers=L, tenants=2, weights="distinct",
        param_GiB=f"{params_bytes / GIB:.2f}",
        weight_budget_GiB=f"{budget / GIB:.2f}")
    cg.coalesced_gemm.launches = 0
    cg.coalesced_gemm.max_groups = 0
    eng, rep, wall = _serve(torch, cfg, tp, n_req=4, prompt_len=32,
                            new_tokens=8, budget=budget, seed=1)
    launches, max_g = cg.coalesced_gemm.launches, cg.coalesced_gemm.max_groups
    _check_served(rep, cfg, 8, 8)
    assert launches > 0 and max_g >= 2, (launches, max_g)
    assert rep.jit.shared_dispatches == 0 and rep.jit.mean_group > 1.0
    _report_serve(torch, "serve-grouped", cfg, rep, wall, launches, max_g)
    result = dict(launches=launches, max_groups=max_g, wall_s=wall)
    del eng, rep, tp
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_card_vs_cpu(torch, cg):
    from repro_torch.core.jit import VLIWJit, build_dense_prefill_template
    from repro_torch.models import Model
    cfg = _full_yi(1)
    m_gpu = Model(cfg, param_dtype=torch.float32)
    m_cpu = Model(cfg, param_dtype=torch.float32, device="cpu")
    # two distinct weight sets: the card's run goes through the grouped
    # regime (stacked packs, device group ids, G_pad padding), not only the
    # shared one
    params = [m_gpu.init(torch.Generator(device=m_gpu.device)
                         .manual_seed(2 + i)) for i in range(2)]

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    params_cpu = [to_cpu(p) for p in params]
    toks, launches, max_g = {}, 0, 0
    for m, ps in ((m_gpu, params), (m_cpu, params_cpu)):
        cg.coalesced_gemm.launches = 0
        cg.coalesced_gemm.max_groups = 0
        _, rep, wall = _serve(torch, cfg, [(m, p) for p in ps], n_req=2,
                              prompt_len=16, new_tokens=4, budget=8 * GIB,
                              seed=2)
        _check_served(rep, cfg, 4, 4)
        toks[m.device.type] = {r.req_id: r.tokens_out for r in rep.requests}
        if m is m_gpu:
            launches = cg.coalesced_gemm.launches
            max_g = cg.coalesced_gemm.max_groups
        say("card-vs-cpu", device=m.device.type, wall_s=f"{wall:.3f}",
            launches=cg.coalesced_gemm.launches,
            max_G=cg.coalesced_gemm.max_groups,
            mean_group=f"{rep.jit.mean_group:.3f}",
            shared=rep.jit.shared_dispatches)
    assert launches > 0 and max_g >= 2, (launches, max_g)
    assert toks["cuda"] == toks["cpu"], toks
    # logits of one prompt pass through the kernel path on both devices
    prompt = torch.randint(0, cfg.vocab_size, (1, 32),
                           generator=torch.Generator().manual_seed(3))
    logits = {}
    for m, p in ((m_gpu, params[0]), (m_cpu, params_cpu[0])):
        cache = m.init_cache(1, 40)
        prog = build_dense_prefill_template(m, p, 32).bind(
            stream_id=0, tokens=prompt.to(m.device), cache=cache,
            env_extra={"real_len": 32, "slot": 0})
        VLIWJit().run([prog])
        logits[m.device.type] = prog.env["logits"].float().cpu()
    diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    assert bool(torch.isfinite(logits["cuda"]).all())
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=2e-4,
                               atol=2e-4)
    say("card-vs-cpu", tokens="identical", requests=len(toks["cpu"]),
        max_abs_logit_diff=f"{diff:.3e}")
    del params, params_cpu, m_gpu, m_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, max_groups=max_g, max_abs_logit_diff=diff)


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

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}; run "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
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
    phase_build(build, cg, gv, fa)
    shapes = phase_kernel(torch, cg, coalesced_gemm_ref)
    # overwritten before every timed call of the new kernels: 256 MB, five
    # times the L2 cache
    flush = torch.zeros(64 << 20, device="cuda")
    gemv_shapes = phase_kernel_gemv(torch, gv, coalesced_gemv_ref, flush)
    attn_shapes = phase_kernel_attn(torch, fa, flash_attention_ref, flush)
    del flush
    torch.cuda.empty_cache()
    shared = phase_serve_shared(torch, cg)
    grouped = phase_serve_grouped(torch, cg)
    cpu = phase_card_vs_cpu(torch, cg)
    rnn = phase_rnn_matvec(torch, cg, gv)
    attn = phase_windowed_attention(torch, fa)
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
    kernels = [
        entry("coalesced_gemm", "src/repro/kernels/coalesced_gemm.py:43",
              shared["launches"],
              {"serve-shared": shared["launches"],
               "serve-grouped": grouped["launches"],
               "card-vs-cpu": cpu["launches"],
               "rnn-matvec (shared)": rnn["shared"]["gemm"]},
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
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}", card=smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
