"""The port's CUDA kernel on the card: these tests need a CUDA device and
skip without one. They import no jax, so a machine with a card and without
jax runs them as they are (``--noconftest``: tests/conftest.py imports jax):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same inputs,
with B scaled by 1/sqrt(K) so outputs are of order 1: fp32 at 2e-4 (both
accumulate in IEEE fp32, in different orders); bf16 at one bf16 ulp (both
round their fp32 sums to bf16), rtol 1e-2 with an absolute floor of 1e-4
for the fp32 summation noise, as in chip_smoke.py.
"""
import importlib

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import coalesced_gemm_ref
from repro_torch.models import Model
from repro_torch.serving import ServingEngine, Tenant, make_trace

cg = importlib.import_module("repro_torch.kernels.coalesced_gemm")
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-4)}


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
