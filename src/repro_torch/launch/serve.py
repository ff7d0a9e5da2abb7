"""Serving launcher: bring up the multi-tenant OoO VLIW JIT engine on a
device, replay a synthetic trace (virtual time) or serve live traffic on
the real clock (daemon mode).

Usage (trace replay):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tenants gemma3-1b yi-9b --mode vliw --requests 4 --device cuda \
      --num-devices 2 --certify

Usage (daemon mode — the real-clock serving front door):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tenants gemma3-1b yi-9b --daemon --duration 5 --rate 20 \
      --admission --stats-interval 1 --device cuda

Tenants run the reduced (smoke) variants of their configs with random
weights made from ``--seed``: dense, MoE (``grok-1-314b``,
``llama4-maverick-400b-a17b``) and SSM (``mamba2-2.7b``) families;
``--device cpu`` runs the plain PyTorch versions of the kernels instead of
the CUDA ones. Each line reports the modelled times (``modeled``,
``mean_lat``, ``p99``, ``tok/s`` — the cost model's ``H100`` device,
spec-sheet values, not measurements) and the host wall clock (``wall``).

``--num-devices N`` serves vliw mode on an N-device modelled mesh (virtual
timelines, all on the one card) and prints a line per device;
``--certify`` runs the schedule certifier on every tick. ``--daemon``
opens a ``FrontDoor`` on the real clock: a feeder thread submits
open-loop Poisson traffic at ``--rate`` for ``--duration`` seconds, tiers
0/1/2 with probabilities 0.5/0.3/0.2 and SLOs ``--slo-ms`` × 1, 2, 4, then
closes the door; the daemon flushes and prints per-tier attainment,
goodput and shed counts. ``--admission`` turns on the SLO-tiered
admission controller; ``--stats-interval`` prints a heartbeat line while
the daemon runs: requests so far, tenants in flight, waiting requests,
occupied of all decode slots and the epoch's mean group, then the
interval's mean slot occupancy and waiting requests (the engine's gauge
logs) and the p95 of queue wait and of latency (polled to admitted, to
retired) over the requests admitted or retired in it (their lifecycles;
``core/telemetry.py``). Ctrl-C stops the door: the daemon returns without
draining and the report is printed. The daemon floors the modelled device
timelines at real elapsed time, and on a host-bound card a request takes
longer than its modelled cost, so millisecond ``--slo-ms`` deadlines may
all miss: that is the clock working, not a fault.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core import telemetry
from repro_torch.models import Model
from repro_torch.serving import (DoorClosed, FrontDoor, ServeRequest,
                                  ServingEngine, Tenant, make_trace)


def _build_models(arch_names, device, dtype, seed):
    models = {}
    for i, arch in enumerate(dict.fromkeys(arch_names)):
        m = Model(smoke_config(arch), param_dtype=dtype, device=device)
        g = torch.Generator(device=m.device).manual_seed(seed + i + 1)
        models[arch] = (m, m.init(g))
    return models


def _make_tenants(names, archs, models, args):
    return [Tenant(n, *models[a], cache_len=max(
        32, args.prompt_len + args.max_new_tokens + 1), max_batch=4)
        for n, a in zip(names, archs)]


def _report_line(mode, rep, certify=False):
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
        if certify:
            line += (f"  [certified: checks={rep.jit.hazard_checks} "
                     f"violations={rep.jit.hazard_violations}]")
    return line


def _mesh_lines(eng, rep):
    """One line for the mesh and one per device: busy share of the
    makespan, modelled busy ms, dispatched groups and coalesced groups
    (from the recorded trace when certifying) and the tenants homed there
    (``xN``: experts spanning N devices)."""
    n = rep.num_devices
    groups = {d: [0, 0] for d in range(n)}
    if eng.last_trace is not None:
        for rec in eng.last_trace.dispatches:
            groups[rec.device][0] += 1
            groups[rec.device][1] += int(len(rec.ops) > 1)
    homed = {d: [] for d in range(n)}
    for name, pl in eng.placement.assignments.items():
        homed[pl.device].append(
            name + (f"(x{pl.expert_span})" if pl.expert_span > 1 else ""))
    print(f"  mesh: {n} devices, skew={rep.device_skew:.2f}, "
          f"collective={rep.jit.collective_time_s*1e6:.1f} us")
    for d in range(n):
        gline = (f"groups={groups[d][0]} coalesced={groups[d][1]}  "
                 if eng.last_trace is not None else "")
        print(f"    dev{d}: util={rep.device_util[d]:5.1%}  "
              f"busy={rep.device_busy_s[d]*1e3:7.3f} ms  "
              f"{gline}tenants={','.join(homed[d]) or '-'}")


def _interval(t0: float, t1: float) -> str:
    """The heartbeat interval [t0, t1] (host clock) from the engine's
    telemetry: mean slot occupancy and waiting requests (the gauge logs),
    p95 of queue wait and of latency over the requests admitted or
    retired in it."""
    rec = telemetry.RECORDER
    occupied, total = rec.gauge_seconds("slots", t0, t1)
    waiting, _ = rec.gauge_seconds("waiting", t0, t1)
    lives = list(rec.requests.values())
    qwait = [x.admitted - x.polled for x in lives if t0 < x.admitted <= t1]
    lat = [x.retired - x.polled for x in lives if t0 < x.retired <= t1]

    def p95(xs):
        return f"{np.percentile(xs, 95) * 1e3:.1f}ms" if xs else "-"

    occ = f"{occupied / total:.0%}" if total > 0 else "-"
    return (f"interval: occupancy={occ} "
            f"waiting={waiting / max(t1 - t0, 1e-9):.1f} "
            f"qwait_p95={p95(qwait)} latency_p95={p95(lat)}")


def _run_daemon(names, args, models, device) -> None:
    eng = ServingEngine(_make_tenants(names, args.tenants, models, args),
                        mode="vliw", certify=args.certify,
                        num_devices=args.num_devices,
                        admission_control=args.admission, device=device)
    door = FrontDoor()

    def feeder() -> None:
        # open-loop Poisson arrivals on the real clock until --duration;
        # this thread only submits and closes, the torch work stays on
        # the serving thread
        rng = np.random.default_rng(args.seed)
        t, rid = 0.0, 0
        t0 = time.monotonic()
        while True:
            t += rng.exponential(1.0 / args.rate)
            if t >= args.duration:
                break
            pause = t - (time.monotonic() - t0)
            if pause > 0:
                time.sleep(pause)
            tier = int(rng.choice(3, p=[0.5, 0.3, 0.2]))
            try:
                door.submit(ServeRequest(
                    rid, names[rid % len(names)], 0.0, args.prompt_len,
                    args.max_new_tokens,
                    slo_s=args.slo_ms / 1e3 * (2 ** tier), tier=tier))
            except DoorClosed:         # stopped (Ctrl-C)
                return
            rid += 1
        door.close()

    last = [telemetry.now()]

    def heartbeat(stats) -> None:
        t0, t1 = last[0], telemetry.now()
        last[0] = t1
        print(f"  [t={stats['t']:6.2f}s] submitted={stats['submitted']:4d} "
              f"finished={stats['finished']:4d} shed={stats['shed']:3d} "
              f"inflight={stats['inflight']} waiting={stats['waiting']} "
              f"slots={stats['occupied']}/{stats['slots']} "
              f"group={stats['mean_group']:.2f}  {_interval(t0, t1)}")

    print(f"daemon: {len(names)} tenants on {eng.device}, "
          f"{args.rate:.0f} req/s open-loop for {args.duration:.1f}s, "
          f"admission={'on' if args.admission else 'off'}\n")
    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    # Ctrl-C stops the door; the daemon returns at its next pass
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        prev = signal.signal(signal.SIGINT, lambda *_: door.stop())
    try:
        rep = eng.serve_forever(door, seed=args.seed, on_stats=heartbeat,
                                stats_interval_s=args.stats_interval)
    finally:
        if on_main:
            signal.signal(signal.SIGINT, prev)
    th.join()
    if door.stopped:
        print("\n  stopped: the requests in flight are left unfinished")
    print()
    print(_report_line("daemon", rep, args.certify))
    print(f"  served={len(rep.requests)} shed={rep.shed} "
          f"unfinished={rep.unfinished} "
          f"goodput={rep.goodput_rps:.1f} req/s")
    for tier, att in rep.tier_attainment().items():
        n = sum(1 for r in rep.requests
                if (r.degraded_from if r.degraded_from is not None
                    else r.tier) == tier)
        print(f"  tier {tier}: attainment={att:5.1%}  n={n}")
    if rep.num_devices > 1:
        _mesh_lines(eng, rep)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", nargs="+", default=["gemma3-1b", "yi-9b"],
                    choices=list(ARCH_IDS))
    ap.add_argument("--mode", choices=["time", "batched", "vliw", "all"],
                    default="all")
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per tenant")
    ap.add_argument("--rate", type=float, default=None,
                    help="arrivals/s (default: 1e4 for a replay, 20 for "
                         "the daemon, whose feeder runs on the real clock)")
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
    ap.add_argument("--num-devices", type=int, default=1,
                    help="serve on an N-device modelled mesh (vliw mode): "
                         "tenants are bin-packed onto per-device timelines "
                         "at admission; expert-parallel MoE tenants span "
                         "the mesh and pay the all-to-all collective")
    ap.add_argument("--certify", action="store_true",
                    help="record a ScheduleTrace and run the hazard "
                         "certifier per tick (vliw mode); raises on the "
                         "first illegal reordering")
    ap.add_argument("--daemon", action="store_true",
                    help="real-clock front door: serve open-loop traffic "
                         "from a feeder thread until --duration elapses "
                         "(vliw mode only)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="daemon: seconds to keep the door open")
    ap.add_argument("--admission", action="store_true",
                    help="daemon: SLO-tiered admission control at the door "
                         "(admit / degrade / shed from the cost model)")
    ap.add_argument("--stats-interval", type=float, default=1.0,
                    help="daemon: seconds between live heartbeat lines")
    args = ap.parse_args(argv)

    dtype = getattr(torch, args.dtype)
    models = _build_models(args.tenants, args.device, dtype, args.seed)
    names = [f"t{i}:{a}" for i, a in enumerate(args.tenants)]
    device = next(iter(models.values()))[0].device
    if args.rate is None:
        args.rate = 20.0 if args.daemon else 1e4
    if args.daemon:
        _run_daemon(names, args, models, device)
        return
    trace = make_trace(names, rate_hz=args.rate, n_per_tenant=args.requests,
                       prompt_len=args.prompt_len,
                       max_new_tokens=args.max_new_tokens,
                       slo_s=args.slo_ms / 1e3, bursty=args.bursty)
    print(f"{len(trace)} requests over {len(names)} tenants on {device}, "
          f"SLO {args.slo_ms} ms\n")
    modes = ["time", "batched", "vliw"] if args.mode == "all" else [args.mode]
    for mode in modes:
        # baseline modes define single-device round semantics; the mesh
        # is a vliw-engine feature
        eng = ServingEngine(_make_tenants(names, args.tenants, models, args),
                            mode=mode, certify=args.certify,
                            num_devices=args.num_devices if mode == "vliw"
                            else 1, device=device)
        rep = eng.run(trace, seed=args.seed)
        print(_report_line(mode, rep, args.certify))
        if rep.jit and rep.num_devices > 1:
            _mesh_lines(eng, rep)


if __name__ == "__main__":
    main()
