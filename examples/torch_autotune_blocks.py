"""Paper Table 1 on the PyTorch/CUDA port: autotune a kernel's tile for
sole tenancy (greedy) and for co-tenancy (collaborative) on the V100 cost
model, then run the collaborative tile's ``bm`` on the hand-written
``coalesced_gemm`` superkernel (its plain PyTorch version on the CPU).

Run:  PYTHONPATH=src python examples/torch_autotune_blocks.py [--device cpu]

Without ``--device`` it runs on the current CUDA card. The tuning figures
are modelled (V100 cost model), as in the JAX package's example. Only the
tile's ``bm`` reaches the kernel: the CUDA kernel keeps its own N block
and its K-only split, so ``bn`` and ``bk`` stay modelled (a ``bk`` that
reached it would change a row's summation order).
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import V100, Autotuner, CostModel, GemmShape
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.ops import execute_superkernel


def main(argv=None, *, problems=None):
    """Print the example's lines and return its results. ``problems`` (a
    list of (a [196, 288], b [288, 128]) fp32 pairs) replaces the seeded
    draw (the tests pass the JAX package's)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cm = CostModel(V100)
    at = Autotuner(cm)
    shape = GemmShape(m=784, n=512, k=1152, dtype_bytes=4)
    print(f"problem: GEMM {shape.m}x{shape.k} @ {shape.k}x{shape.n} "
          f"(conv-like, fp32); tuning modelled on the V100 cost model\n")
    out = {"device": str(device), "tuned": {}}
    for K in (2, 4):
        r = at.tune(shape, co_tenants=K)
        tf = {"greedy_isolated": cm.achieved_tflops([shape],
                                                    r.greedy_isolated_s),
              "collab_isolated": cm.achieved_tflops([shape],
                                                    r.collab_isolated_s),
              "greedy_multiplexed": cm.achieved_tflops(
                  [shape] * K, r.greedy_multiplexed_s),
              "collab_multiplexed": cm.achieved_tflops(
                  [shape] * K, r.collab_multiplexed_s)}
        print(f"co-tenants={K}")
        print(f"  greedy block        {r.greedy}   isolated "
              f"{tf['greedy_isolated']:.2f} TF")
        print(f"  collaborative block {r.collaborative}   isolated "
              f"{tf['collab_isolated']:.2f} TF")
        print(f"  multiplexed: greedy {tf['greedy_multiplexed']:.2f} TF vs "
              f"collaborative {tf['collab_multiplexed']:.2f} TF -> "
              f"{r.multiplexed_speedup:.2f}x (paper: 1.25x)\n")
        out["tuned"][K] = dict(greedy=r.greedy, collaborative=r.collaborative,
                               multiplexed_speedup=r.multiplexed_speedup,
                               tflops=tf)

    # the collaborative tile's bm on the hand-written grouped-GEMM kernel
    b = at.tune(shape, co_tenants=2).collaborative
    bm = min(b.bm, 64)
    if problems is None:
        g = torch.Generator().manual_seed(0)
        problems = [(torch.randn(196, 288, generator=g),
                     torch.randn(288, 128, generator=g)) for _ in range(2)]
    probs = [(a.to(device), w.to(device)) for a, w in problems]
    launches0 = coalesced_gemm.launches
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = execute_superkernel(probs, bm=bm)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = max(float((o - a @ w).abs().max()) for (a, w), o in zip(probs,
                                                                 outs))
    where = (f"on {torch.cuda.get_device_name(device)}, "
             f"{coalesced_gemm.launches - launches0} launch, "
             f"{wall * 1e3:.3f} ms wall" if device.type == "cuda"
             else "plain version on the CPU")
    print(f"collaborative tile (bm={bm}; bn={b.bn}, bk={b.bk} stay "
          f"modelled) on the grouped-GEMM kernel (reduced size, {where}): "
          f"max err {err:.1e}")
    out.update(bm=bm, block=b, max_err=err, wall_s=wall, outputs=outs,
               problems=probs)
    return out


if __name__ == "__main__":
    main()
