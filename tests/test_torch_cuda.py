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
    distinct weights, so the card runs the grouped regime (G = 2)."""
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
        rep = ServingEngine(tenants, mode="vliw", device=m.device).run(trace)
        out.append({r.req_id: r.tokens_out for r in rep.requests})
        assert (cg.coalesced_gemm.launches > n0) == (m is m_gpu)
        if m is m_gpu:
            assert cg.coalesced_gemm.max_groups >= 2
    assert out[0] == out[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K,N", [(3, 300, 256), (3, 384, 384),
                                   (2, 2048, 4096)])
def test_gemv_kernel_matches_plain(cuda, G, K, N, dtype):
    """Ragged K (300: no multiple of any tile) and the K = 300 problem
    padded to 384 as ``ops.coalesced_matvec`` pads it."""
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
    each attention instance's registers, spill bytes and HMMA count read as
    in the first call."""
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
                      if "flash_kernel=" in ln])
    assert len(lines[0]) == len(fa.DTYPE_CODES) * len(fa.HEAD_DIMS)
    assert lines[1] == lines[0]
