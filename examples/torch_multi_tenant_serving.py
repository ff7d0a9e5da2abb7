"""End-to-end serving on the PyTorch/CUDA port: a small model zoo under
batched requests.

Three tenants (dense gemma3-family, dense yi-family, attention-free
mamba2) receive bursty Poisson traffic with latency SLOs; the engine serves
the same trace in all three multiplexing regimes and prints the paper's
comparison (§4 against §5) with real greedy token generation, then the
§5.2 stagger: a second wave that an arrival-aware scheduler WAITs for.

Run:  PYTHONPATH=src python examples/torch_multi_tenant_serving.py \
          [--device cpu]

Without ``--device`` it runs on the current CUDA card. Modelled times come
from the cost model (the H100's spec-sheet values unless a caller passes
another); the wall seconds are measured and end in a synchronize.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core import H100, CostModel
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.models import Model
from repro_torch.serving import ServingEngine, Tenant, make_trace, \
    two_wave_trace

TENANTS = (("chat", "gemma3-1b", 1), ("code", "yi-9b", 2),
           ("summarize", "mamba2-2.7b", 3))


def _label(dev):
    spec = ", spec-sheet values" if dev is H100 else ""
    return f"{dev.name} cost model{spec}"


def main(argv=None, *, cost_device=H100, params=None, prompt_fn=None):
    """Print the example's lines and return its results. ``params``
    ({arch: params tree}) replaces the seeded inits and ``prompt_fn`` the
    engine's prompt draw (the tests pass the JAX package's);
    ``cost_device`` is the modelled device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    models = {}
    for _, arch, seed in TENANTS:
        m = Model(smoke_config(arch), param_dtype=torch.float32,
                  device=device)
        p = (params or {}).get(arch)
        if p is None:
            p = m.init(torch.Generator(device=device).manual_seed(seed))
        models[arch] = (m, p)

    def engine(tenants, mode, **kw):
        return ServingEngine(tenants, mode=mode, cost=CostModel(cost_device),
                             device=device, prompt_fn=prompt_fn, **kw)

    def serve(eng, trace):
        """(report, wall seconds ending in a synchronize)."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.run(trace)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    trace = make_trace([name for name, _, _ in TENANTS], rate_hz=2e4,
                       n_per_tenant=4, prompt_len=8, max_new_tokens=6,
                       slo_s=0.005, bursty=True)
    print(f"trace: {len(trace)} requests over 3 tenants "
          f"(bursty Poisson, 5 ms SLO); modelled times: "
          f"{_label(cost_device)}\n")

    out = {"device": str(device), "modes": {}}
    reports = {}
    for mode in ("time", "batched", "vliw"):
        tenants = [Tenant(name, *models[arch], cache_len=32, max_batch=4)
                   for name, arch, _ in TENANTS]
        rep, wall = serve(engine(tenants, mode), trace)
        reports[mode] = rep
        line = (f"{mode:8s} modeled={rep.modeled_time_s * 1e3:7.3f} ms  "
                f"mean_lat={rep.mean_latency * 1e3:7.3f} ms  "
                f"p99={rep.p_latency(0.99) * 1e3:7.3f} ms  "
                f"SLO={rep.slo_attainment:5.1%}  "
                f"tok/s={rep.tokens_per_s:9.0f}  wall={wall:.3f} s")
        res = dict(modeled_ms=rep.modeled_time_s * 1e3,
                   slo_attainment=rep.slo_attainment, wall_s=wall,
                   tokens={r.req_id: list(r.tokens_out)
                           for r in rep.requests})
        if rep.jit:
            d = rep.jit.dispatch
            kinds = d.graphs_by_kind()
            line += (f"  [superkernels={rep.jit.superkernels} "
                     f"mean_group={rep.jit.mean_group:.2f} "
                     f"waits={rep.jit.waits} "
                     f"mid_flight={rep.jit.mid_flight_admissions} "
                     f"evictions={rep.jit.evictions} "
                     f"wpack_hit={d.weight_hit_rate:.0%} "
                     f"graphs={sum(c for c, _ in kinds.values())}"
                     f"/{sum(r for _, r in kinds.values())}]")
            res.update(superkernels=rep.jit.superkernels,
                       mean_group=rep.jit.mean_group, waits=rep.jit.waits,
                       graphs_by_kind=kinds)
        print(line)
        out["modes"][mode] = res

    def tokens(rep):
        return [r.tokens_out for r in sorted(rep.requests,
                                             key=lambda r: r.req_id)]

    same = all(tokens(reports[m]) == tokens(reports["vliw"])
               for m in ("time", "batched"))
    print(f"\ngreedy tokens identical across regimes: {same}")
    speedup = reports["time"].modeled_time_s / reports["vliw"].modeled_time_s
    print(f"VLIW JIT speedup over time-multiplexing: {speedup:.2f}x "
          f"(modelled)")
    out.update(tokens_identical=same, modeled_speedup=speedup)

    # --- the paper's §5.2 stagger, live: a second wave arrives just after
    # the first; an arrival-aware scheduler WAITs to coalesce with it -----
    print("\nstaged two-wave arrivals (WAIT vs never-wait):")
    m1, p1 = models["gemma3-1b"]
    probe = engine([Tenant("w1", m1, p1, cache_len=32, max_batch=2)], "vliw")
    gap = 1.2 * probe._prefill_time(m1.cfg, 8)
    staged = two_wave_trace(["w1"], ["w2"], gap, prompt_len=8,
                            max_new_tokens=6, slo_s=1.0)
    out["two_wave"] = {}
    for label, sc in (("wait", SchedulerConfig(min_wait_gain_s=0.0,
                                               max_wait_s=0.05)),
                      ("never-wait", SchedulerConfig(max_wait_s=0.0))):
        eng = engine([Tenant("w1", m1, p1, cache_len=32, max_batch=2),
                      Tenant("w2", m1, p1, cache_len=32, max_batch=2)],
                     "vliw", sched_cfg=sc)
        rep, wall = serve(eng, staged)
        print(f"  {label:10s} waits={rep.jit.waits:2d} "
              f"mean_group={rep.jit.mean_group:.2f} "
              f"superkernels={rep.jit.superkernels} "
              f"modeled={rep.modeled_time_s * 1e6:6.1f} us  "
              f"wall={wall:.3f} s")
        out["two_wave"][label] = dict(
            waits=rep.jit.waits, mean_group=rep.jit.mean_group,
            superkernels=rep.jit.superkernels,
            modeled_us=rep.modeled_time_s * 1e6, wall_s=wall,
            tokens={r.req_id: list(r.tokens_out) for r in rep.requests})
    return out


if __name__ == "__main__":
    main()
