"""Quickstart on the PyTorch/CUDA port: the OoO VLIW JIT in a minute.

Builds two small tenant models, declares their decode steps to the JIT and
shows the paper's three mechanisms: shape clustering, superkernel
coalescing (the hand-written ``coalesced_gemm`` kernel on the card, its
plain PyTorch version on the CPU) and SLO-aware accounting on a cost model.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Without ``--device`` it runs on the current CUDA card.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import REGISTRY, smoke_config
from repro_torch.core import H100, CostModel, cluster_greedy, zoo_population
from repro_torch.core.jit import VLIWJit, build_dense_decode_program
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.models import Model

TENANTS = (("gemma3-1b", 1), ("yi-9b", 2))


def _label(dev):
    """How a modelled figure names its cost model."""
    spec = ", spec-sheet values" if dev is H100 else ""
    return f"modelled: {dev.name} cost model{spec}"


def main(argv=None, *, cost_device=H100, params=None, prompts=None):
    """Print the quickstart's lines and return its results. ``params``
    ({arch: params tree}) and ``prompts`` ({arch: LongTensor [2, 12]})
    replace the seeded draws (the tests pass the JAX package's);
    ``cost_device`` is the modelled device of the cost model."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device)}

    # --- 1. Fig-7 moment: the model zoo's GEMMs cluster tightly ----------
    shapes = [s for _, _, s in zoo_population(list(REGISTRY.values()))]
    clusters = cluster_greedy(shapes)
    print(f"zoo: {len(shapes)} GEMM problems -> {len(clusters)} clusters "
          f"(<=25% padding waste each)")
    out.update(zoo_problems=len(shapes), clusters=len(clusters))

    # --- 2. build two tenants and prefill them ---------------------------
    tenants = []
    out["first_tokens"] = {}
    for arch, seed in TENANTS:
        cfg = smoke_config(arch)
        model = Model(cfg, param_dtype=torch.float32, device=device)
        p = (params or {}).get(arch)
        if p is None:
            p = model.init(torch.Generator(device=device).manual_seed(seed))
        prompt = (prompts or {}).get(arch)
        if prompt is None:
            prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                                   generator=torch.Generator().manual_seed(0))
        logits, cache = model.prefill(p, {"tokens": prompt.to(device)},
                                      cache_len=32)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        tenants.append((model, p, tok, cache))
        out["first_tokens"][arch] = tok[:, 0].tolist()
        print(f"tenant {arch}: prefilled 12 tokens, first decode token "
              f"{tok[:, 0].tolist()}")

    # --- 3. declare both decode steps to the JIT and run coalesced -------
    jit = VLIWJit(CostModel(cost_device), max_group=8)
    progs = [build_dense_decode_program(m, p, t, c, stream_id=i)
             for i, (m, p, t, c) in enumerate(tenants)]
    launches0 = coalesced_gemm.launches
    t0 = time.perf_counter()
    stats = jit.run(progs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"\nVLIW JIT: {stats.ops_executed} declared GEMMs -> "
          f"{stats.superkernels} superkernels "
          f"(mean group {stats.mean_group:.2f}, "
          f"{stats.shared_dispatches} shared-weight dispatches)")
    print(f"modeled speedup vs time-multiplexed dispatch: "
          f"{stats.modeled_speedup:.2f}x ({_label(cost_device)})")
    out.update(ops_executed=stats.ops_executed,
               superkernels=stats.superkernels, mean_group=stats.mean_group,
               shared_dispatches=stats.shared_dispatches,
               modeled_speedup=stats.modeled_speedup,
               cost_device=cost_device.name, wall_s=wall)
    if device.type == "cuda":
        out["launches"] = coalesced_gemm.launches - launches0
        print(f"on {torch.cuda.get_device_name(device)}: "
              f"{out['launches']} coalesced_gemm launches, "
              f"{wall:.3f} s wall (first run: kernel builds and graph "
              f"captures included)")
    out["max_err"] = {}
    for (arch, _), (model, p, tok, cache), prog in zip(TENANTS, tenants,
                                                       progs):
        ref, _ = model.decode_step(p, tok, cache)
        err = float((prog.env["logits"][:, None] - ref).abs().max())
        out["max_err"][arch] = err
        print(f"tenant {arch}: JIT output matches monolithic decode "
              f"(max err {err:.1e})")
    out["logits"] = [prog.env["logits"] for prog in progs]
    return out


if __name__ == "__main__":
    main()
