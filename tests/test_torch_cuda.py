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
import gc
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
@pytest.mark.parametrize("K,N", [(4096, 256), (300, 128)])
def test_kernel_rows_invariant_across_tuned_bm(cuda, K, N, dtype):
    """The live tuner's ``bm`` reaches the launch: problem rows padded to
    bm = 8, 16, 32 or 64 give bitwise the same real rows (the K split is a
    function of K alone), and each launch holds to the plain version."""
    rows = [5, 33, 2]
    outs = {}
    for bm in (8, 16, 32, 64):
        a, b, gid = _ragged(rows, K, N, dtype, cuda, bm=bm, seed=K)
        got = cg.coalesced_gemm(a, b, gid, bm=bm)
        torch.cuda.synchronize()
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got.float(),
                                   coalesced_gemm_ref(a, b, gid, bm).float(),
                                   rtol=rtol, atol=atol)
        starts = [sum(-(-m // bm) * bm for m in rows[:i])
                  for i in range(len(rows))]
        outs[bm] = [got[s:s + m] for s, m in zip(starts, rows)]
    for bm in (16, 32, 64):
        for x, y in zip(outs[bm], outs[8]):
            assert torch.equal(x, y), bm


@pytest.mark.parametrize("arch,kv_quant", [("internvl2-2b", False),
                                           ("hymba-1.5b", False),
                                           ("whisper-tiny", False),
                                           ("gemma3-1b", True)])
def test_family_step_card_equals_cpu(cuda, arch, kv_quant):
    """One prefill and one decode step of each family the port added
    (smoke config, fp32) give the CPU's greedy tokens on the card, and
    logits within 2e-4; the vlm decode step also through its dense
    template (every GEMM a kernel launch)."""
    from repro_torch.core.jit import VLIWJit, build_dense_decode_template
    cfg = smoke_config(arch)
    m_cpu = Model(cfg, param_dtype=torch.float32, device="cpu",
                  kv_quant=kv_quant)
    m_gpu = Model(cfg, param_dtype=torch.float32, device=cuda,
                  kv_quant=kv_quant)
    params = m_cpu.init(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=g)}
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = torch.randn(2, cfg.num_patch_tokens,
                                            cfg.d_model, generator=g)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, cfg.encoder_seq_len, cfg.d_model,
                                      generator=g)
    out = []
    for m, p in ((m_cpu, params), (m_gpu, _to(params, cuda))):
        b = {k: v.to(m.device) for k, v in batch.items()}
        lp, cache = m.prefill(p, b, cache_len=40)
        tok = lp[:, -1].argmax(-1)[:, None]
        ld, _ = m.decode_step(p, tok, cache)
        got = [lp.cpu(), ld.cpu()]
        if cfg.arch_type == "vlm":
            n0 = cg.coalesced_gemm.launches
            prog = build_dense_decode_template(m, p, 2).bind(
                stream_id=0, tokens=tok, cache=cache)
            VLIWJit().run([prog])
            assert (cg.coalesced_gemm.launches > n0) == (m is m_gpu)
            got.append(prog.env["logits"][:, None].cpu())
        out.append(got)
    for x, y in zip(out[0], out[1]):
        torch.testing.assert_close(y, x, rtol=2e-4, atol=2e-4)
        assert torch.equal(x[:, -1].argmax(-1), y[:, -1].argmax(-1))


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


# ---------------------------------------------------------------------------
# CUDA graphs of the stacked decode bodies (core/graphs.py)
# ---------------------------------------------------------------------------

def _graph_model(arch, dtype, device):
    cfg = _gemma8() if arch == "gemma3-1b" else _nondense(arch)
    m = Model(cfg, param_dtype=dtype, device=device)
    return m, m.init(torch.Generator(device=device).manual_seed(4))


def _graph_builder(cfg, stacked=True):
    from repro_torch.core import jit
    build = {"moe": jit.build_moe_decode_template,
             "ssm": jit.build_ssm_decode_template}.get(
        cfg.arch_type, jit.build_dense_decode_template)
    return lambda m, p, B: build(m, p, B, stacked=stacked)


def _graph_decode(vj, tmpl, cache, tok, steps=3):
    logits = []
    for _ in range(steps):
        prog = tmpl.bind(stream_id=0, tokens=tok, cache=cache)
        vj.run([prog])
        logits.append(prog.env["logits"])
        cache = prog.env["cache"]
        tok = torch.argmax(prog.env["logits"], dim=-1)[:, None]
    return logits, cache


def _counts():
    return (cg.coalesced_gemm.launches,
            dict(cg.coalesced_gemm.launches_by_shape),
            dict(cg.coalesced_gemm.launches_by_bm))


def _count_delta(before, after):
    return (after[0] - before[0],
            {k: n - before[1].get(k, 0) for k, n in after[1].items()
             if n != before[1].get(k, 0)},
            {k: n - before[2].get(k, 0) for k, n in after[2].items()
             if n != before[2].get(k, 0)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b",
                                  "mamba2-2.7b"])
def test_graph_replay_bitwise_equal_to_eager(cuda, arch, dtype):
    """A dense, an MoE and an SSM template over 3 decode steps: replays of
    the bodies' graphs give the eager bodies' logits and cache leaves bit
    for bit, and the per-layer template's; one capture a body, replays
    after; the launch counters move as the eager run's do."""
    from repro_torch.core.jit import VLIWJit
    m, p = _graph_model(arch, dtype, cuda)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, m.cfg.vocab_size, (4, 12), generator=g)
    _, cache0 = m.prefill(p, {"tokens": prompt.to(cuda)}, cache_len=32)
    tok0 = torch.randint(0, m.cfg.vocab_size, (4, 1), generator=g).to(cuda)
    out, counts = {}, {}
    for regime in ("eager", "graphed", "per-layer"):
        tmpl = _graph_builder(m.cfg, regime != "per-layer")(m, p, 4)
        vj = VLIWJit(max_group=8, cuda_graphs=regime == "graphed")
        c0 = _counts()
        out[regime] = _graph_decode(vj, tmpl, cache0, tok0)
        torch.cuda.synchronize()
        counts[regime] = _count_delta(c0, _counts())
        st = vj.executor.stats
        if regime == "graphed":
            # the bodies' graphs (the unembed's dispatch graph beside them)
            bodies = vj.graphs.count("decode")
            assert bodies >= 1 and len(vj.graphs) == bodies + 1
            assert (st.graph_captures, st.graph_replays) == (bodies,
                                                            2 * bodies)
            assert st.graphs_by_kind()["dispatch"] == (1, 2)
        else:
            assert st.graph_captures == st.graph_replays == 0
    assert counts["graphed"] == counts["eager"]
    for regime in ("graphed", "per-layer"):
        for a, b in zip(out[regime][0], out["eager"][0]):
            assert bool(torch.isfinite(a.float()).all())
            assert torch.equal(a, b), regime
        for leaf, t in out["eager"][1]["layers"].items():
            assert torch.equal(out[regime][1]["layers"][leaf], t), \
                (regime, leaf)


@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b",
                                  "mamba2-2.7b"])
def test_tenants_sharing_a_graph_keep_each_others_caches(cuda, arch):
    """Two tenants of one template replay one graph in turns: the cache a
    replay handed to one is not overwritten by the other's replay (the
    outputs are copied out), and each step equals the eager step."""
    from repro_torch.core.jit import VLIWJit
    m, p = _graph_model(arch, torch.bfloat16, cuda)
    tmpl = _graph_builder(m.cfg)(m, p, 4)
    g = torch.Generator().manual_seed(6)
    caches, toks = [], []
    for _ in range(2):
        prompt = torch.randint(0, m.cfg.vocab_size, (4, 12), generator=g)
        caches.append(m.prefill(p, {"tokens": prompt.to(cuda)},
                                cache_len=32)[1])
        toks.append(torch.randint(0, m.cfg.vocab_size, (4, 1),
                                  generator=g).to(cuda))
    vj, eager = VLIWJit(max_group=8), VLIWJit(max_group=8, cuda_graphs=False)
    held = []
    for step in range(3):
        for i in range(2):
            prog = tmpl.bind(stream_id=i, tokens=toks[i], cache=caches[i])
            want = tmpl.bind(stream_id=i, tokens=toks[i], cache=caches[i])
            vj.run([prog])
            eager.run([want])
            assert torch.equal(prog.env["logits"], want.env["logits"])
            caches[i] = prog.env["cache"]
            held.append((caches[i], {k: v.clone() for k, v in
                                     caches[i]["layers"].items()}))
            toks[i] = torch.argmax(prog.env["logits"], dim=-1)[:, None]
    torch.cuda.synchronize()
    assert vj.executor.stats.graph_replays > 0
    for cache, snap in held:
        for leaf, t in snap.items():
            assert torch.equal(cache["layers"][leaf], t), leaf


def test_hot_swap_replays_the_new_weights(cuda):
    """A weight hot-swap on a graphed engine drops the graphs that read the
    old packs and serves the new weights: tokens equal a fresh eager
    engine's on them."""
    m, p_old = _graph_model("gemma3-1b", torch.bfloat16, cuda)
    p_new = m.init(torch.Generator(device=cuda).manual_seed(9))
    trace = make_trace(["a"], rate_hz=1e4, n_per_tenant=2, prompt_len=16,
                       max_new_tokens=4, slo_s=1.0)
    eng = ServingEngine([Tenant("a", m, p_old, cache_len=32)], mode="vliw",
                        device=cuda)
    eng.run(trace)
    n = len(eng.jit.graphs)
    assert n > 0 and eng.jit.executor.stats.graph_replays > 0
    eng.tenants["a"].params = p_new
    swapped = eng.run(trace)
    assert eng.jit.graphs.dropped >= n
    assert eng.jit.executor.stats.weight_invalidations >= 1
    fresh = ServingEngine([Tenant("a", m, p_new, cache_len=32)],
                          mode="vliw", device=cuda,
                          cuda_graphs=False).run(trace)
    assert {r.req_id: r.tokens_out for r in swapped.requests} == \
        {r.req_id: r.tokens_out for r in fresh.requests}


@pytest.mark.parametrize("live_tune", [False, True])
def test_launch_counters_equal_under_replay(cuda, live_tune):
    """One trace served graphed and eager: the same tokens and the same
    launches, by shape and by bm (live-tuned too: each tuned bm is a key
    of its own)."""
    m, p = _graph_model("gemma3-1b", torch.bfloat16, cuda)
    trace = make_trace(["a", "b"], rate_hz=1e4, n_per_tenant=3,
                       prompt_len=16, max_new_tokens=6, slo_s=1.0)
    out = {}
    for graphs in (True, False):
        tenants = [Tenant(n, m, p, cache_len=32) for n in ("a", "b")]
        c0 = _counts()
        cg.coalesced_gemm.max_groups = 0
        rep = ServingEngine(tenants, mode="vliw", device=cuda,
                            cuda_graphs=graphs,
                            live_tune=live_tune).run(trace)
        out[graphs] = ({r.req_id: r.tokens_out for r in rep.requests},
                       _count_delta(c0, _counts()),
                       cg.coalesced_gemm.max_groups)
        assert (rep.jit.dispatch.graph_replays > 0) == graphs
    assert out[True] == out[False]


def test_capture_failure_raises(cuda):
    """A body that waits on the card cannot be captured: the capture
    raises, and nothing falls back to the eager body."""
    from repro_torch.core.graphs import BodyIO, GraphCache
    from repro_torch.core.jit import StackedGemmStage, VLIWJit

    def body(inp, padded, ex, block=None):
        return {"x": inp["x"] * float(inp["x"].sum().item() > 0)}

    st = StackedGemmStage(
        tag="body", weight_key=("m", 0, "body"), operands=[], layers=1,
        run=None, graph=BodyIO(("decode", "m", 2),
                               lambda env: {"x": env["x"]}, body))
    ex = VLIWJit().executor
    with pytest.raises(RuntimeError):
        GraphCache().run(st, {"x": torch.ones(2, 4, device=cuda)}, {}, ex)
    torch.cuda.synchronize()
    assert gc.isenabled()


def test_collector_is_off_during_a_capture(cuda):
    """The collector may free a dead cache's graphs (a reference cycle:
    the weight cache and the graph cache hold each other) at any
    allocation, and a graph destroyed while another is capturing
    invalidates that capture (seen on the card in
    test_nondense_stacked_bitwise_equal_to_per_layer_on_card): a capture
    runs with the collector off and turns it back on after."""
    from repro_torch.core.graphs import BodyIO, GraphCache
    from repro_torch.core.jit import StackedGemmStage, VLIWJit
    seen = []

    def body(inp, padded, ex, block=None):
        seen.append(gc.isenabled())
        return {"x": inp["x"] + 1.0}

    st = StackedGemmStage(
        tag="body", weight_key=("m", 0, "body"), operands=[], layers=1,
        run=None, graph=BodyIO(("decode", "m", 2),
                               lambda env: {"x": env["x"]}, body))
    ex = VLIWJit().executor
    graphs = GraphCache()
    for step in range(3):
        env = {"x": torch.full((2, 4), float(step), device=cuda)}
        graphs.run(st, env, {}, ex)
        assert torch.equal(env["x"].cpu(), torch.full((2, 4), step + 1.0))
    # the eager first call, the capture; replays run no Python
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.parametrize("k_heads_first", [False, True])
def test_bf16_scores_on_the_tensor_cores(cuda, k_heads_first):
    """The card's q·kᵀ route (``bmm`` with an fp32 result) against the
    widened fp32 einsum: forward within fp32 summation noise (bf16 products
    are exact in fp32), backward within one bf16 ulp; fp32 operands keep
    the einsum bit for bit. Its forward launches no GEMM of fp32 inputs
    (cuBLAS's ``gemm_f32f32 ... ffma``, without tensor cores)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.attention import qk_scores
    g = torch.Generator().manual_seed(1)
    B, s, H, G, hd, T = 2, 16, 2, 4, 128, 48
    q = torch.randn(B, s, H, G, hd, generator=g)
    k = torch.randn(*((B, H, T, hd) if k_heads_first else (B, T, H, hd)),
                    generator=g)
    eq = "bshgd,bhtd->bhgst" if k_heads_first else "bshgd,bthd->bhgst"
    qb, kb = (t.to(cuda, torch.bfloat16).requires_grad_() for t in (q, k))
    with torch.no_grad():
        qk_scores(qb, kb, k_heads_first=k_heads_first)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            qk_scores(qb, kb, k_heads_first=k_heads_first)
            torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    assert names and not any("gemm_f32f32" in n or "ffma" in n
                             for n in names), names
    got = qk_scores(qb, kb, k_heads_first=k_heads_first)
    want = torch.einsum(eq, qb.float(), kb.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    ct = torch.randn(got.shape, generator=g).to(cuda)
    for a, b in zip(torch.autograd.grad(got, (qb, kb), ct),
                    torch.autograd.grad(want, (qb, kb), ct)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=1e-4)
    qf, kf = q.to(cuda), k.to(cuda)
    assert torch.equal(qk_scores(qf, kf, k_heads_first=k_heads_first),
                       torch.einsum(eq, qf, kf))


# ---------------------------------------------------------------------------
# CUDA graphs of the prompt bodies, the monolithic model calls and the
# per-layer glue (core/graphs.py)
# ---------------------------------------------------------------------------

def _same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    else:
        assert torch.equal(a, b), where


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prompt_body_replay_bitwise_equal_to_eager(cuda, dtype):
    """Three prompt passes of different lengths in one bucket through the
    stacked prefill template: replays of its bodies' graphs give the eager
    bodies' logits and written cache bit for bit, and the per-layer
    template's (its attention glue graphed too); one capture a body."""
    from repro_torch.core.jit import VLIWJit, build_dense_prefill_template
    m, p = _graph_model("gemma3-1b", dtype, cuda)
    out = {}
    for regime in ("graphed", "eager", "per-layer"):
        vj = VLIWJit(max_group=8, cuda_graphs=regime != "eager")
        tmpl = build_dense_prefill_template(m, p, 32,
                                            stacked=regime != "per-layer")
        g = torch.Generator().manual_seed(8)
        cache, logits = m.init_cache(2, 48), []
        for i, S in enumerate((20, 32, 17)):
            toks = torch.zeros((1, 32), dtype=torch.long)
            toks[0, :S] = torch.randint(0, m.cfg.vocab_size, (S,),
                                        generator=g)
            prog = tmpl.bind(stream_id=0, tokens=toks.to(cuda), cache=cache,
                             env_extra={"real_len": S, "slot": i % 2,
                                        "req": None})
            vj.run([prog])
            logits.append(prog.env["logits"])
            cache = prog.env["cache"]
        torch.cuda.synchronize()
        out[regime] = (logits, cache)
        kinds = vj.executor.stats.graphs_by_kind()
        if regime == "graphed":
            assert kinds["prefill"] == (3, 6), kinds
        elif regime == "per-layer":
            assert kinds["glue"] == (2, 22), kinds
        else:
            assert all(v == (0, 0) for v in kinds.values()), kinds
    for regime in ("eager", "per-layer"):
        for a, b in zip(out["graphed"][0], out[regime][0]):
            assert torch.equal(a, b), regime
        _same_tree(out["graphed"][1], out[regime][1], regime)


def _family(arch, kv_quant, dtype, device):
    m = Model(smoke_config(arch), param_dtype=dtype, device=device,
              kv_quant=kv_quant)
    return m, m.init(torch.Generator(device=device).manual_seed(6))


@pytest.mark.parametrize("arch,kv_quant", [("hymba-1.5b", False),
                                           ("whisper-tiny", False),
                                           ("gemma3-1b", True),
                                           ("internvl2-2b", False)])
def test_monolithic_replay_bitwise_equal_to_eager(cuda, arch, kv_quant):
    """The engine's monolithic ``Model.prefill`` and ``Model.decode_step``
    calls (bf16), three each: replays give the plain calls' logits and
    every cache leaf bit for bit; one capture a call shape."""
    m, p = _family(arch, kv_quant, torch.bfloat16, cuda)
    eng = ServingEngine([Tenant("t", m, p, cache_len=48, max_batch=4)],
                        mode="batched", device=cuda)
    t = eng.tenants["t"]
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        batch = {"tokens": torch.randint(0, m.cfg.vocab_size, (1, 12),
                                         generator=g).to(cuda)}
        if m.cfg.arch_type == "vlm":
            batch["patch_embeds"] = torch.randn(
                1, m.cfg.num_patch_tokens, m.cfg.d_model,
                generator=g).to(cuda, torch.bfloat16)
        if m.cfg.is_encdec:
            batch["frames"] = torch.randn(
                1, m.cfg.encoder_seq_len, m.cfg.d_model,
                generator=g).to(cuda, torch.bfloat16)
        got, want = eng._prefill(t, batch), m.prefill(p, batch, cache_len=48)
        assert torch.equal(got[0], want[0])
        _same_tree(got[1], want[1], "prefill")
    t.cache = want[1]
    t.cache = {"pos": t.cache["pos"].repeat(4), "layers": {
        k: v.repeat(1, 4, *([1] * (v.dim() - 2)))
        for k, v in t.cache["layers"].items()}}
    for step in range(3):
        t.slot_tok = torch.randint(0, m.cfg.vocab_size, (4, 1),
                                   generator=g).to(cuda)
        want = m.decode_step(p, t.slot_tok, t.cache)
        got = eng._decode_step(t)
        assert torch.equal(got[0], want[0]), step
        _same_tree(got[1], want[1], f"decode {step}")
        t.cache = got[1]
    torch.cuda.synchronize()
    assert eng.jit.executor.stats.graphs_by_kind()["monolithic"] == (2, 4)


@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b",
                                  "mamba2-2.7b"])
def test_per_layer_glue_replay_bitwise_equal_to_eager(cuda, arch):
    """Three per-layer decode steps (bf16) with the attention / MoE route
    and combine / SSM core glue replayed as graphs and eager: logits and
    caches bit for bit, and the stacked template's."""
    from repro_torch.core.jit import VLIWJit
    m, p = _graph_model(arch, torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, m.cfg.vocab_size, (4, 12), generator=g)
    _, cache0 = m.prefill(p, {"tokens": prompt.to(cuda)}, cache_len=32)
    tok0 = torch.randint(0, m.cfg.vocab_size, (4, 1), generator=g).to(cuda)
    out = {}
    for regime in ("glue-graphed", "eager", "stacked"):
        tmpl = _graph_builder(m.cfg, regime == "stacked")(m, p, 4)
        vj = VLIWJit(max_group=8, cuda_graphs=regime != "eager")
        out[regime] = _graph_decode(vj, tmpl, cache0, tok0)
        torch.cuda.synchronize()
        glue = vj.executor.stats.graphs_by_kind()["glue"]
        assert (glue[0] > 0 and glue[1] > 0) == (regime == "glue-graphed")
    for regime in ("eager", "stacked"):
        for a, b in zip(out["glue-graphed"][0], out[regime][0]):
            assert torch.equal(a, b), regime
        for leaf, t in out[regime][1]["layers"].items():
            assert torch.equal(out["glue-graphed"][1]["layers"][leaf], t), \
                (regime, leaf)


@pytest.mark.parametrize("mode", ["vliw", "batched", "time"])
def test_fleet_graphed_tokens_equal_eager(cuda, mode):
    """A dense + MoE + SSM + hybrid + audio + int8-KV fleet (bf16, smoke
    configs) served with graphs and eagerly: the same tokens; the graphed
    run replays every kind it reaches."""
    fleet = [("dense", *_graph_model("gemma3-1b", torch.bfloat16, cuda)),
             ("moe", *_graph_model("grok-1-314b", torch.bfloat16, cuda)),
             ("ssm", *_graph_model("mamba2-2.7b", torch.bfloat16, cuda)),
             ("hybrid", *_family("hymba-1.5b", False, torch.bfloat16, cuda)),
             ("audio", *_family("whisper-tiny", False, torch.bfloat16,
                                cuda)),
             ("int8", *_family("gemma3-1b", True, torch.bfloat16, cuda))]
    trace = make_trace([n for n, *_ in fleet], rate_hz=1e4, n_per_tenant=2,
                       prompt_len=16, max_new_tokens=4, slo_s=1.0)
    out = {}
    for graphs in (True, False):
        eng = ServingEngine([Tenant(n, m, p, cache_len=32, max_batch=2)
                             for n, m, p in fleet], mode=mode, device=cuda,
                            cuda_graphs=graphs)
        rep = eng.run(trace)
        out[graphs] = {r.req_id: r.tokens_out for r in rep.requests}
        kinds = eng.jit.executor.stats.graphs_by_kind()
        assert (kinds["monolithic"][1] > 0) == graphs, kinds
        if mode == "vliw":
            assert (kinds["prefill"][1] > 0) == graphs, kinds
            assert (kinds["decode"][1] > 0) == graphs, kinds
    assert out[True] == out[False]


def _dispatch_problems(body, G, dtype, device, seed):
    """G problems of the executor's dispatch bodies: ragged rows and
    ragged (K, N) under one envelope (grouped), one weight G times
    (shared), G vectors on distinct weights (matvec)."""
    g = torch.Generator().manual_seed(seed)
    if body == "shared":
        ws = [(torch.randn(300, 260, generator=g) / 300 ** 0.5)
              .to(device, dtype)] * G
    else:
        ws = [(torch.randn(300 - 7 * i, 260 - 5 * i, generator=g)
               / 300 ** 0.5).to(device, dtype) for i in range(G)]
    rows = [1] * G if body == "matvec" else [1 + (4 * i) % 7
                                             for i in range(G)]
    return ws, rows, g


def _dispatch(ex, body, ws, rows, g):
    acts = [torch.randn(m, int(w.shape[0]), generator=g).to(w.device,
                                                            w.dtype)
            for m, w in zip(rows, ws)]
    if body == "matvec":
        return acts, ex.matvec([a[0] for a in acts], ws)
    return acts, ex.execute_problems(
        list(zip(acts, ws)), [("m", id(w)) for w in ws],
        shared_operand=body == "shared")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", ["grouped", "shared", "matvec"])
def test_dispatch_replay_bitwise_equal_to_eager(cuda, body, dtype,
                                                monkeypatch):
    """The executor's dispatch bodies as CUDA graphs at G = 1, 2, 3, 8,
    three calls of one key: each replay is bitwise the eager body (values
    and strides) and agrees with the plain product; the hand-written kernel
    launches from the replay: its wrapper is called only at the key's first
    call (eagerly, then under capture), yet its counter rises by one a
    call."""
    from repro_torch.core import dispatch as tdispatch
    calls = []
    for fn in (cg.coalesced_gemm, gv.coalesced_gemv):
        def spy(*a, _fn=fn, **k):
            calls.append(_fn.__name__)
            return _fn(*a, **k)

        monkeypatch.setattr(tdispatch, fn.__name__, spy)
    rtol, atol = TOL[dtype]
    for G in (1, 2, 3, 8):
        # one vector on one weight is the shared GEMM path
        kernel = gv.coalesced_gemv if body == "matvec" and G > 1 \
            else cg.coalesced_gemm
        ws, rows, g = _dispatch_problems(body, G, dtype, cuda, seed=G)
        eager = SuperkernelExecutor(PlanCache(8, byte_capacity=1 << 30),
                                    cuda_graphs=False)
        graphed = SuperkernelExecutor(PlanCache(8, byte_capacity=1 << 30))
        for step in range(3):
            n0, c0 = kernel.launches, len(calls)
            acts, got = _dispatch(graphed, body, ws, rows, g)
            torch.cuda.synchronize()
            assert kernel.launches == n0 + 1, (G, step)
            assert len(calls) - c0 == (2 if step == 0 else 0), (G, step)
            if body == "matvec":
                want = eager.matvec([a[0] for a in acts], ws)
            else:
                want = eager.execute_problems(
                    list(zip(acts, ws)), [("m", id(w)) for w in ws],
                    shared_operand=body == "shared")
            for o, e, a, w in zip(got, want, acts, ws):
                assert torch.equal(o, e) and o.stride() == e.stride()
                plain = (a.float() @ w.float()).to(dtype)
                if body == "matvec":
                    plain = plain[0]
                torch.testing.assert_close(o, plain, rtol=rtol, atol=atol)
        assert graphed.stats.graphs_by_kind()["dispatch"] == (1, 2)
        assert len(graphed.graphs) == 1


@pytest.mark.parametrize("stacked", [False, True])
def test_dispatch_graphs_steady_state_on_card(cuda, stacked):
    """A per-layer (every GEMM a dispatch) and a stacked (the unembed)
    decode template, bf16, three streams: a second run over warm templates
    captures no dispatch graph and builds no kernel, every dispatch a
    replay; logits bitwise those of the eager JIT, launches the same."""
    from repro_torch.core.jit import VLIWJit
    m, p = _graph_model("gemma3-1b", torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, m.cfg.vocab_size, (2, 12), generator=g)
    _, cache = m.prefill(p, {"tokens": prompt.to(cuda)}, cache_len=32)
    tok = torch.randint(0, m.cfg.vocab_size, (2, 1), generator=g).to(cuda)
    tmpl = _graph_builder(m.cfg, stacked)(m, p, 2)

    def progs():
        return [tmpl.bind(stream_id=i, tokens=tok, cache=cache)
                for i in range(3)]

    vj = VLIWJit(max_group=8)
    warm = vj.run(progs())
    assert warm.dispatch.dispatch_graph_captures > 0
    got = progs()
    n0 = _counts()
    steady = vj.run(got)
    torch.cuda.synchronize()
    graphed_launches = _count_delta(n0, _counts())
    assert steady.dispatch.dispatch_graph_captures == 0
    assert steady.dispatch.dispatch_graph_replays == \
        steady.dispatch.dispatches - (steady.dispatch.graph_replays
                                      + steady.dispatch.graph_captures)
    assert steady.dispatch.retraces == 0
    assert steady.dispatch.weight_hit_rate == 1.0
    eager = VLIWJit(max_group=8, cuda_graphs=False)
    eager.run(progs())
    want = progs()
    n0 = _counts()
    eager.run(want)
    torch.cuda.synchronize()
    assert _count_delta(n0, _counts()) == graphed_launches
    for a, b in zip(got, want):
        assert torch.equal(a.env["logits"], b.env["logits"])


def test_capture_after_every_graph_was_dropped(cuda):
    """An emptied weight cache drops every graph of the pool at once; the
    next captures go into the same pool (its keeper graph holds it live)
    and replay the eager steps bit for bit."""
    from repro_torch.core.jit import VLIWJit
    m, p = _graph_model("gemma3-1b", torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, m.cfg.vocab_size, (4, 12), generator=g)
    _, cache0 = m.prefill(p, {"tokens": prompt.to(cuda)}, cache_len=32)
    tok0 = torch.randint(0, m.cfg.vocab_size, (4, 1), generator=g).to(cuda)
    tmpl = _graph_builder(m.cfg)(m, p, 4)
    vj = VLIWJit(max_group=8)
    first = _graph_decode(vj, tmpl, cache0, tok0)
    n = vj.graphs.count("decode")
    assert len(vj.graphs) == n + 1          # and the unembed's dispatch
    vj.weight_cache.clear()
    assert len(vj.graphs) == 0
    again = _graph_decode(vj, tmpl, cache0, tok0)
    want = _graph_decode(VLIWJit(max_group=8, cuda_graphs=False), tmpl,
                         cache0, tok0)
    torch.cuda.synchronize()
    assert vj.executor.stats.graph_captures == 2 * n
    assert vj.executor.stats.dispatch_graph_captures == 2
    for got in (first, again):
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)


def test_remat_recompute_keeps_the_hints(cuda):
    """On CUDA the backward, and with it a remat recompute, runs on the
    autograd engine's own thread. grok-1 smoke, fp32, under the
    ``moe_groups = 2`` hint: the loss and gradients of ``loss_and_grads``
    with remat are bitwise those without (a recompute without the
    forward's hints would route one group, with another capacity)."""
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.training import (DataConfig, SyntheticLM,
                                      batch_to_device, loss_and_grads)
    from repro_torch.tree import leaves
    cfg = smoke_config("grok-1-314b")
    out = {}
    for remat in (False, True):
        model = Model(cfg, param_dtype=torch.float32, device=cuda,
                      remat=remat)
        params = model.init(torch.Generator(device=cuda).manual_seed(3))
        batch = batch_to_device(next(iter(SyntheticLM(
            cfg, DataConfig(batch_size=4, seq_len=64, seed=2)))), model)
        with activation_sharding({"moe_groups": 2}):
            out[remat] = loss_and_grads(model, params, batch)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1), strict=True):
        assert torch.equal(a, b)
