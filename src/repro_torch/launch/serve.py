"""Serving launcher: bring up the multi-tenant OoO VLIW JIT engine on a
device and replay a synthetic trace (virtual time).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tenants gemma3-1b yi-9b --mode vliw --requests 4 --device cuda

Tenants run the reduced (smoke) variants of their configs with random
weights made from ``--seed``: dense, MoE (``grok-1-314b``,
``llama4-maverick-400b-a17b``) and SSM (``mamba2-2.7b``) families; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead of the CUDA ones. Each line reports the
modelled times (``modeled``, ``mean_lat``, ``p99``, ``tok/s`` — the cost
model's ``H100`` device, spec-sheet values, not measurements) and the host
wall clock (``wall``) of the run. The real-clock front door (``--daemon``
in the JAX package) is not ported yet (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models import Model
from repro_torch.serving import ServingEngine, Tenant, make_trace


def _build_models(arch_names, device, dtype, seed):
    models = {}
    for i, arch in enumerate(dict.fromkeys(arch_names)):
        m = Model(smoke_config(arch), param_dtype=dtype, device=device)
        g = torch.Generator(device=m.device).manual_seed(seed + i + 1)
        models[arch] = (m, m.init(g))
    return models


def _report_line(mode, rep):
    line = (f"{mode:8s} modeled={rep.modeled_time_s*1e3:8.3f} ms  "
            f"mean_lat={rep.mean_latency*1e3:7.3f} ms  "
            f"p99={rep.p_latency(0.99)*1e3:7.3f} ms  "
            f"SLO={rep.slo_attainment:5.1%}  "
            f"tok/s={rep.tokens_per_s:9.0f}  wall={rep.wall_time_s:.3f} s")
    if rep.jit:
        d = rep.jit.dispatch
        line += (f"  [superkernels={rep.jit.superkernels} "
                 f"group={rep.jit.mean_group:.2f} "
                 f"shared={rep.jit.shared_dispatches} "
                 f"wpack_hit={d.weight_hit_rate:.0%} "
                 f"builds={d.retraces} "
                 f"nondense={rep.jit.nondense_programs} "
                 f"expert_coalesced={rep.jit.expert_coalesced}]")
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", nargs="+", default=["gemma3-1b", "yi-9b"],
                    choices=list(ARCH_IDS))
    ap.add_argument("--mode", choices=["time", "batched", "vliw", "all"],
                    default="all")
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per tenant")
    ap.add_argument("--rate", type=float, default=1e4, help="arrivals/s")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--slo-ms", type=float, default=5.0)
    ap.add_argument("--bursty", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "raises when there is none)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dtype = getattr(torch, args.dtype)
    models = _build_models(args.tenants, args.device, dtype, args.seed)
    names = [f"t{i}:{a}" for i, a in enumerate(args.tenants)]
    trace = make_trace(names, rate_hz=args.rate, n_per_tenant=args.requests,
                       prompt_len=args.prompt_len,
                       max_new_tokens=args.max_new_tokens,
                       slo_s=args.slo_ms / 1e3, bursty=args.bursty)
    device = next(iter(models.values()))[0].device
    print(f"{len(trace)} requests over {len(names)} tenants on {device}, "
          f"SLO {args.slo_ms} ms\n")
    modes = ["time", "batched", "vliw"] if args.mode == "all" else [args.mode]
    for mode in modes:
        tenants = [Tenant(n, *models[a], cache_len=max(
            32, args.prompt_len + args.max_new_tokens + 1), max_batch=4)
            for n, a in zip(names, args.tenants)]
        rep = ServingEngine(tenants, mode=mode, device=device).run(
            trace, seed=args.seed)
        print(_report_line(mode, rep))


if __name__ == "__main__":
    main()
