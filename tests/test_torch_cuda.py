"""The port's CUDA kernels on the card: these tests need a CUDA device and
skip without one. They import no jax, so a machine with a card and without
jax runs them as they are (``--noconftest``: tests/conftest.py imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same inputs,
with B scaled by 1/sqrt(K) so outputs are of order 1: fp32 at 2e-4 (both
accumulate in IEEE fp32, in different orders); bf16 at one bf16 ulp (both
round their fp32 sums to bf16), rtol 1e-2 with an absolute floor of 1e-4
for the fp32 summation noise, as in chip_smoke.py. ``coalesced_gemv`` is
held the same way (w scaled by 1/sqrt(K), the same two sums in other
orders). ``flash_attention`` in fp32 at 2e-5 relative with a 2e-4 floor (the
attention tolerance of tests/test_kernels.py: online softmax against a
dense softmax, exp2f against torch's exp, sums over S keys in other
orders; the kernel's 3xTF32 products keep about 21 bits, see
tests/test_torch_attention.py); in bf16 at one bf16 ulp of the output, rtol
1e-2, with a 1e-4 floor: bf16 products are exact in fp32, the kernel takes
P V with P split into two bf16 halves, and both sides round fp32 results
of order 1 or less to bf16.
"""
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.core.dispatch import SuperkernelExecutor
from repro_torch.core.plancache import PlanCache
from repro_torch.kernels.ref import (coalesced_gemm_ref, coalesced_gemv_ref,
                                     flash_attention_ref)
from repro_torch.models import Model
from repro_torch.serving import ServingEngine, Tenant, make_trace

cg = importlib.import_module("repro_torch.kernels.coalesced_gemm")
gv = importlib.import_module("repro_torch.kernels.coalesced_gemv")
fa = importlib.import_module("repro_torch.kernels.flash_attention")
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-4)}
ATTN_TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (1e-2, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _ragged(rows, K, N, dtype, device, bm=8, pad_tiles=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    parts, gids = [], []
    for i, m in enumerate(rows):
        m_pad = -(-m // bm) * bm
        a = torch.zeros(m_pad, K)
        a[:m] = torch.randn(m, K, generator=g)
        parts.append(a)
        gids += [i] * (m_pad // bm)
    parts.append(torch.zeros(pad_tiles * bm, K))
    gids += [0] * pad_tiles
    a = torch.cat(parts).to(device, dtype)
    b = torch.randn(len(rows), K, N, generator=g) / K ** 0.5
    b = b.to(device, dtype)
    return a, b, torch.tensor(gids, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,K,N", [([5], 256, 384),
                                      ([3, 17, 8], 300, 256),
                                      ([1, 9, 30, 4], 4096, 512)])
def test_kernel_matches_plain(cuda, rows, K, N, dtype):
    a, b, gid = _ragged(rows, K, N, dtype, cuda)
    n0 = cg.coalesced_gemm.launches
    got = cg.coalesced_gemm(a, b, gid, bm=8)
    torch.cuda.synchronize()
    assert cg.coalesced_gemm.launches == n0 + 1
    assert cg.coalesced_gemm.max_groups >= len(rows)
    want = coalesced_gemm_ref(a, b, gid, 8)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    m_real = sum(-(-m // 8) * 8 for m in rows)
    assert torch.count_nonzero(got[m_real:]) == 0


def test_kernel_refuses_what_it_does_not_take(cuda):
    a, b, gid = _ragged([8], 256, 256, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cg.coalesced_gemm(a, b.transpose(1, 2), gid, bm=8)
    with pytest.raises(TypeError):
        cg.coalesced_gemm(a.half(), b.half(), gid, bm=8)
    with pytest.raises(ValueError):
        cg.coalesced_gemm(a[:, :200].contiguous(), b[:, :200, :200]
                          .contiguous(), gid, bm=8)      # N % 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,K,N,pad_tiles", [
    ([3, 17, 8], 300, 128, 1),         # K tail, unaligned bf16 rows of A
    ([1, 2, 3, 4, 5, 6, 7, 8], 1024, 256, 0),   # G = 8
    ([100, 5], 2048, 256, 2),          # 13 chunks: two passes over B[0]
    ([4], 4096, 128, 7),               # an all-pad tail of 7 m-tiles
    ([3], 1, 128, 1),                  # K = 1
    ([8], 4096, 65536, 0)])            # the widest path N (unembed)
def test_kernel_edge_shapes(cuda, rows, K, N, pad_tiles, dtype):
    a, b, gid = _ragged(rows, K, N, dtype, cuda, pad_tiles=pad_tiles,
                        seed=K + N)
    got = cg.coalesced_gemm(a, b, gid, bm=8)
    torch.cuda.synchronize()
    want = coalesced_gemm_ref(a, b, gid, 8)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    m_real = sum(-(-m // 8) * 8 for m in rows)
    assert torch.count_nonzero(got[m_real:]) == 0


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(4096, 256), (16384, 128), (300, 128)])
def test_kernel_rows_are_batch_invariant(cuda, K, N, dtype, shared):
    """Problem p's rows are bitwise the same launched alone and coalesced
    with two other problems and pad tiles (the K split depends on K alone),
    with distinct weights (p alone in its group) or shared ones (p's chunk
    among six others in one pass), and the same on every call (no
    atomics)."""
    g = torch.Generator().manual_seed(K)
    x = torch.randn(5, K, generator=g)
    ws = [torch.randn(K, N, generator=g) / K ** 0.5 for _ in range(3)]
    others = [torch.randn(3, K, generator=g), torch.randn(17, K, generator=g)]
    alone_a = torch.zeros(8, K)
    alone_a[:5] = x
    alone = cg.coalesced_gemm(alone_a.to(cuda, dtype),
                              ws[1][None].to(cuda, dtype),
                              torch.zeros(1, dtype=torch.int32, device=cuda),
                              bm=8)
    a = torch.zeros(8 + 8 + 24 + 16, K)
    a[:3], a[8:13], a[16:33] = others[0], x, others[1]
    gid = torch.tensor([0] * 7 if shared else [0, 1, 2, 2, 2, 0, 0],
                       dtype=torch.int32, device=cuda)
    b = ws[1][None] if shared else torch.stack(ws)
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    first = cg.coalesced_gemm(a, b, gid, bm=8)
    again = cg.coalesced_gemm(a, b, gid, bm=8)
    torch.cuda.synchronize()
    assert torch.equal(first[8:16], alone)
    assert torch.equal(first, again)


def test_execute_superkernel_on_card(cuda):
    g = torch.Generator().manual_seed(1)
    probs = [(torch.randn(m, k, generator=g).to(cuda),
              torch.randn(k, n, generator=g).to(cuda))
             for m, k, n in ((5, 300, 200), (33, 260, 190))]
    for got, (x, w) in zip(ops.execute_superkernel(probs, bm=8), probs):
        torch.testing.assert_close(got, x @ w, rtol=2e-4, atol=2e-4)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_engine_tokens_card_equals_cpu(cuda):
    """The same weights and prompts on the card (kernel) and on the CPU
    (plain versions) give the same greedy tokens. The two tenants have
    distinct weights and per-layer templates, so the card runs the grouped
    regime (G = 2)."""
    cfg = smoke_config("yi-9b")
    m_cpu = Model(cfg, param_dtype=torch.float32, device="cpu")
    params = [m_cpu.init(torch.Generator().manual_seed(i)) for i in (0, 1)]
    m_gpu = Model(cfg, param_dtype=torch.float32, device=cuda)
    trace = make_trace(["a", "b"], rate_hz=1e4, n_per_tenant=2,
                       prompt_len=16, max_new_tokens=4, slo_s=1.0)
    out = []
    for m, ps in ((m_cpu, params), (m_gpu, [_to(p, cuda) for p in params])):
        tenants = [Tenant(n, m, p, cache_len=32)
                   for n, p in zip(("a", "b"), ps)]
        n0 = cg.coalesced_gemm.launches
        cg.coalesced_gemm.max_groups = 0
        rep = ServingEngine(tenants, mode="vliw", device=m.device,
                            stacked_layers=False).run(trace)
        out.append({r.req_id: r.tokens_out for r in rep.requests})
        assert (cg.coalesced_gemm.launches > n0) == (m is m_gpu)
        if m is m_gpu:
            assert cg.coalesced_gemm.max_groups >= 2
    assert out[0] == out[1]


def _gemma8():
    """gemma3-1b smoke at 8 layers with gemma3's period of one global
    layer in six: sub-stacks of 5, 1 and 2 layers."""
    return dataclasses.replace(smoke_config("gemma3-1b"), num_layers=8,
                               global_every=6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_bitwise_equal_to_per_layer_on_card(cuda, dtype):
    """On the card too, a layer-stacked template gives the per-layer
    template's logits and cache leaves bit for bit, over 3 decode steps
    and one prompt pass: both run every GEMM as a lone kernel launch at
    the same shapes, and the gemm's rows are batch invariant."""
    from repro_torch.core.jit import (VLIWJit, build_dense_decode_template,
                                      build_dense_prefill_template)
    m = Model(_gemma8(), param_dtype=dtype, device=cuda)
    p = m.init(torch.Generator(device=cuda).manual_seed(4))
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, m.cfg.vocab_size, (2, 12), generator=g)
    _, cache0 = m.prefill(p, {"tokens": prompt.to(cuda)}, cache_len=32)
    tok0 = torch.randint(0, m.cfg.vocab_size, (2, 1), generator=g).to(cuda)
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :12] = prompt[0]
    out = {}
    for stacked in (True, False):
        n0 = cg.coalesced_gemm.launches
        tmpl = build_dense_decode_template(m, p, 2, stacked=stacked)
        vj = VLIWJit(max_group=8)
        cache, tok, envs = cache0, tok0, []
        for _ in range(3):
            prog = tmpl.bind(stream_id=0, tokens=tok, cache=cache)
            vj.run([prog])
            envs.append(prog.env["logits"])
            cache = prog.env["cache"]
            tok = torch.argmax(prog.env["logits"], dim=-1)[:, None]
        pre = build_dense_prefill_template(m, p, 16, stacked=stacked).bind(
            stream_id=0, tokens=padded.to(cuda), cache=m.init_cache(2, 32),
            env_extra={"real_len": 12, "slot": 1})
        vj.run([pre])
        assert cg.coalesced_gemm.launches - n0 == 4 * (7 * 8 + 1)
        out[stacked] = (envs, cache, pre.env)
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    for got, want in ((out[True][1], out[False][1]),
                      (out[True][2]["cache"], out[False][2]["cache"])):
        for leaf in ("k", "v"):
            assert torch.equal(got["layers"][leaf], want["layers"][leaf])
        assert torch.equal(got["pos"], want["pos"])
    assert torch.equal(out[True][2]["logits"], out[False][2]["logits"])


def test_stacked_engine_tokens_card_equals_cpu(cuda):
    """Layer-stacked serving (the default) gives the same greedy tokens on
    the card (every body GEMM a kernel launch) as on the CPU."""
    m_cpu = Model(_gemma8(), param_dtype=torch.float32, device="cpu")
    params = [m_cpu.init(torch.Generator().manual_seed(i)) for i in (0, 1)]
    m_gpu = Model(_gemma8(), param_dtype=torch.float32, device=cuda)
    trace = make_trace(["a", "b"], rate_hz=1e4, n_per_tenant=2,
                       prompt_len=16, max_new_tokens=4, slo_s=1.0)
    out = []
    for m, ps in ((m_cpu, params), (m_gpu, [_to(p, cuda) for p in params])):
        tenants = [Tenant(n, m, p, cache_len=32)
                   for n, p in zip(("a", "b"), ps)]
        n0 = cg.coalesced_gemm.launches
        eng = ServingEngine(tenants, mode="vliw", device=m.device)
        assert eng.stacked_layers
        rep = eng.run(trace)
        out.append({r.req_id: r.tokens_out for r in rep.requests})
        assert (cg.coalesced_gemm.launches > n0) == (m is m_gpu)
    assert out[0] == out[1]


def _nondense(arch):
    """grok-1 smoke (4 experts) at 8 layers with gemma3's local/global
    period (sub-stacks of 5, 1 and 2), or mamba2-2.7b smoke."""
    cfg = smoke_config(arch)
    if arch == "grok-1-314b":
        cfg = dataclasses.replace(cfg, num_layers=8, window_size=8,
                                  global_every=6)
    return cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-2.7b"])
def test_nondense_stacked_bitwise_equal_to_per_layer_on_card(cuda, arch,
                                                             dtype):
    """MoE and SSM decode templates: the stacked template gives the
    per-layer template's logits and cache leaves bit for bit on the card,
    over 3 steps, with (4 + 3E) or 2 kernel launches a layer of each."""
    from repro_torch.core.jit import (VLIWJit, build_moe_decode_template,
                                      build_ssm_decode_template)
    cfg = _nondense(arch)
    build = build_moe_decode_template if cfg.arch_type == "moe" \
        else build_ssm_decode_template
    per_layer = 4 + 3 * cfg.moe.num_experts if cfg.arch_type == "moe" else 2
    m = Model(cfg, param_dtype=dtype, device=cuda)
    p = m.init(torch.Generator(device=cuda).manual_seed(4))
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (4, 12), generator=g)
    _, cache0 = m.prefill(p, {"tokens": prompt.to(cuda)}, cache_len=32)
    tok0 = torch.randint(0, cfg.vocab_size, (4, 1), generator=g).to(cuda)
    out = {}
    for stacked in (True, False):
        n0 = cg.coalesced_gemm.launches
        tmpl = build(m, p, 4, stacked=stacked)
        vj = VLIWJit(max_group=8)
        cache, tok, logits = cache0, tok0, []
        for _ in range(3):
            prog = tmpl.bind(stream_id=0, tokens=tok, cache=cache)
            vj.run([prog])
            logits.append(prog.env["logits"])
            cache = prog.env["cache"]
            tok = torch.argmax(prog.env["logits"], dim=-1)[:, None]
        assert cg.coalesced_gemm.launches - n0 == \
            3 * (per_layer * cfg.num_layers + 1)
        out[stacked] = (logits, cache)
    for a, b in zip(out[True][0], out[False][0]):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, b)
    for leaf, t in out[False][1]["layers"].items():
        assert torch.equal(out[True][1]["layers"][leaf], t), leaf


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-2.7b"])
def test_nondense_engine_tokens_card_equals_cpu(cuda, arch, stacked):
    """MoE and SSM tenants with distinct weights serve the same greedy
    tokens on the card (every GEMM a kernel launch) as on the CPU, in
    both regimes."""
    cfg = _nondense(arch)
    m_cpu = Model(cfg, param_dtype=torch.float32, device="cpu")
    params = [m_cpu.init(torch.Generator().manual_seed(i)) for i in (0, 1)]
    m_gpu = Model(cfg, param_dtype=torch.float32, device=cuda)
    trace = make_trace(["a", "b"], rate_hz=1e4, n_per_tenant=2,
                       prompt_len=16, max_new_tokens=4, slo_s=1.0)
    out = []
    for m, ps in ((m_cpu, params), (m_gpu, [_to(p, cuda) for p in params])):
        tenants = [Tenant(n, m, p, cache_len=32)
                   for n, p in zip(("a", "b"), ps)]
        n0 = cg.coalesced_gemm.launches
        rep = ServingEngine(tenants, mode="vliw", device=m.device,
                            stacked_layers=stacked).run(trace)
        out.append({r.req_id: r.tokens_out for r in rep.requests})
        assert rep.jit.nondense_programs > 0
        assert (cg.coalesced_gemm.launches > n0) == (m is m_gpu)
    assert out[0] == out[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K,N", [(3, 300, 256), (3, 384, 384),
                                   (2, 2048, 4096), (3, 2049, 256),
                                   (2, 4100, 128)])
def test_gemv_kernel_matches_plain(cuda, G, K, N, dtype):
    """Ragged K (300: no multiple of any tile), the K = 300 problem padded
    to 384 as ``ops.coalesced_matvec`` pads it, and K split over a full
    cluster with a ragged last rank (2049, 4100)."""
    g = torch.Generator().manual_seed(G + K)
    x = torch.randn(G, K, generator=g).to(cuda, dtype)
    w = (torch.randn(G, K, N, generator=g) / K ** 0.5).to(cuda, dtype)
    n0 = gv.coalesced_gemv.launches
    got = gv.coalesced_gemv(x, w)
    torch.cuda.synchronize()
    assert gv.coalesced_gemv.launches == n0 + 1
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), coalesced_gemv_ref(x, w).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [300, 2048, 4096])
def test_gemv_rows_are_batch_invariant(cuda, K, dtype):
    """out[g] is bitwise the same launched alone (G = 1) and inside G = 2, 4
    and 8 (the K split depends on K alone), and on a second call (no
    atomics)."""
    N = 256
    g = torch.Generator().manual_seed(K)
    x = torch.randn(8, K, generator=g).to(cuda, dtype)
    w = (torch.randn(8, K, N, generator=g) / K ** 0.5).to(cuda, dtype)
    alone = torch.cat([gv.coalesced_gemv(x[i:i + 1].contiguous(),
                                         w[i:i + 1].contiguous())
                       for i in range(8)])
    for G in (2, 4, 8):
        first = gv.coalesced_gemv(x[:G].contiguous(), w[:G].contiguous())
        again = gv.coalesced_gemv(x[:G].contiguous(), w[:G].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(first, alone[:G]), G
        assert torch.equal(first, again), G


def test_coalesced_matvec_on_card(cuda):
    g = torch.Generator().manual_seed(3)
    dims = [(300, 200), (260, 190), (128, 256)]
    xs = [torch.randn(k, generator=g).to(cuda) for k, _ in dims]
    ws = [torch.randn(k, n, generator=g).to(cuda) for k, n in dims]
    n0 = gv.coalesced_gemv.launches
    for got, x, w in zip(ops.coalesced_matvec(xs, ws), xs, ws):
        torch.testing.assert_close(got, x @ w, rtol=2e-4, atol=2e-4)
    assert gv.coalesced_gemv.launches == n0 + 1


def test_executor_matvec_counts_a_gemv_launch_per_call(cuda):
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(300, generator=g).to(cuda) for _ in range(3)]
    ws = [torch.randn(300, 200, generator=g).to(cuda) for _ in range(3)]
    ex = SuperkernelExecutor(PlanCache(8), bm=8)
    n0, m0 = gv.coalesced_gemv.launches, cg.coalesced_gemm.launches
    for _ in range(4):
        outs = ex.matvec(xs, ws)
    torch.cuda.synchronize()
    assert gv.coalesced_gemv.launches == n0 + 4
    assert cg.coalesced_gemm.launches == m0
    assert ex.stats.weight_hits == 3 and ex.stats.weight_misses == 1
    for got, x, w in zip(outs, xs, ws):
        torch.testing.assert_close(got, x @ w, rtol=2e-4, atol=2e-4)
    ex.matvec(xs, [ws[0]] * 3)            # shared weights: the GEMM path
    assert cg.coalesced_gemm.launches == m0 + 1
    assert gv.coalesced_gemv.launches == n0 + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,D,causal,window,q_scale", [
    (4, 300, 256, True, 100, 1.0),  # D = 256 (dynamic shared memory), window
    (3, 48, 64, True, 0, 1.0),      # S below one tile
    (3, 48, 32, False, 16, 1.0),
    (2, 200, 128, False, 0, 1.0),
    (2, 260, 128, True, 0, 8.0),    # peaky rows: logits of std 8
    (2, 190, 256, False, 40, 8.0),  # peaky, window, no causal mask
    (2, 200, 64, True, 5, 1.0),     # window smaller than one kv tile
    (3, 1, 128, True, 0, 1.0),      # S = 1
    (2, 65, 32, True, 0, 1.0),      # S = 65: one key past a 64-key tile
    (2, 65, 256, True, 0, 1.0)])
def test_flash_attention_kernel_matches_plain(cuda, BH, S, D, causal, window,
                                              q_scale, dtype):
    """Every head dim in both dtypes (bf16: split-P MMAs; fp32: 3xTF32),
    ragged S, masks that cut inside a kv tile, and q scaled by 8 so the
    softmax rows are peaky (a few keys carry most of the weight)."""
    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(BH, S, D, generator=g) for _ in range(3))
    q, k, v = ((q * q_scale).to(cuda, dtype), k.to(cuda, dtype),
               v.to(cuda, dtype))
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(got.float()).all())
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    # deterministic: no atomics, one fixed order of sums
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)


def test_windowed_attention_on_card(cuda):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 4, 256, 256, generator=g).to(cuda)
               for _ in range(3))
    n0 = fa.flash_attention.launches
    got = ops.windowed_attention(q, k, v, causal=True, window=64)
    assert fa.flash_attention.launches == n0 + 1
    want = flash_attention_ref(*(t.reshape(4, 256, 256) for t in (q, k, v)),
                               causal=True, window=64)
    torch.testing.assert_close(got.reshape(4, 256, 256), want, rtol=2e-5,
                               atol=2e-4)


def test_build_phase_on_a_warm_cache(cuda, monkeypatch, capsys):
    """chip_smoke.py's build phase twice in one checkout: the second call
    finds every library built and reads its ptxas lines back from disk, so
    each attention, gemm and gemv instance's registers, spill bytes (and
    HMMA count) read as in the first call."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    build = importlib.import_module("repro_torch.kernels.build")
    lines = []
    for _ in range(2):
        monkeypatch.setattr(build, "_BUILT", {})     # a new process
        cs.phase_build(build, cg, gv, fa)
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if "flash_kernel=" in ln or "gemm_kernel=" in ln
                      or "gemv_kernel=" in ln])
    assert len(lines[0]) == len(fa.DTYPE_CODES) * (len(fa.HEAD_DIMS) + 2)
    assert lines[1] == lines[0]


def test_certified_mesh_stacked_tokens_card_equals_cpu(cuda):
    """A certified 2-device stacked run (two dense tenants with distinct
    weights and one grok-1 smoke tenant, whose experts span the mesh)
    serves the CPU's tokens on the card, with no hazard, a collective
    charge, work on both devices, and kernel launches on the card."""
    dense = Model(_gemma8(), param_dtype=torch.float32, device="cpu")
    grok = Model(smoke_config("grok-1-314b"), param_dtype=torch.float32,
                 device="cpu")
    spec = [("a", dense, dense.init(torch.Generator().manual_seed(0)), 2),
            ("b", dense, dense.init(torch.Generator().manual_seed(1)), 2),
            ("g", grok, grok.init(torch.Generator().manual_seed(2)), 1)]
    trace = make_trace(["a", "b", "g"], rate_hz=1e4, n_per_tenant=2,
                       prompt_len=16, max_new_tokens=4, slo_s=1.0)
    out = []
    for dev in ("cpu", cuda):
        tenants = [Tenant(n, Model(m.cfg, param_dtype=torch.float32,
                                   device=dev), _to(p, dev), cache_len=32,
                          max_batch=mb) for n, m, p, mb in spec]
        n0 = cg.coalesced_gemm.launches
        eng = ServingEngine(tenants, mode="vliw", num_devices=2,
                            certify=True, device=dev)
        rep = eng.run(trace)
        assert rep.unfinished == 0 and rep.num_devices == 2
        assert rep.jit.hazard_checks > 0 and rep.jit.hazard_violations == 0
        assert rep.jit.collective_time_s > 0
        assert {d.device for d in eng.last_trace.dispatches} == {0, 1}
        assert (cg.coalesced_gemm.launches > n0) == (dev is cuda)
        out.append({r.req_id: r.tokens_out for r in rep.requests})
    assert out[0] == out[1]
