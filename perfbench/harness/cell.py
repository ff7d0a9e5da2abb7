"""One run of one cell: set-up, the window, the metrics, the check."""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.harness import correct, manifest, measure
from perfbench.harness.serve import Runner, Run


def device_fields(run: Run, device: torch.device) -> Dict:
    if device.type == "cuda":
        kind, platform = torch.cuda.get_device_name(device), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    out = {"platform": platform, "kind": kind, "count": 1,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    prof = run.profile
    if prof is not None and prof["device"]:
        t0, t1 = profile_window(prof)
        out["busy_s"] = measure.union_s(
            (max(s, t0), min(e, t1)) for _, s, e in prof["device"])
        out["window_s"] = t1 - t0
    return out


def profile_window(prof: Dict) -> Tuple[float, float]:
    """The profiled window: from the first to the last recorded event."""
    spans = prof["host"] + prof["device"]
    return min(s for _, s, _ in spans), max(e for _, _, e in spans)


def breakdown(prof: Dict) -> Dict:
    """The ten costliest device operations, and the ten longest idle-gap
    totals by the host op that was running through them."""
    by_op: Dict[str, float] = {}
    for name, s, e in prof["device"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    t0, t1 = profile_window(prof)
    host = sorted(prof["host"], key=lambda r: r[1])
    starts = [s for _, s, _ in host]
    by_host: Dict[str, float] = {}
    for a, b in measure.gaps([(s, e) for _, s, e in prof["device"]], t0, t1):
        i = bisect.bisect_right(starts, a) - 1
        best, name = 0.0, "host outside torch ops"
        for j in range(max(i - 8, 0), min(i + 8, len(host))):
            n, s, e = host[j]
            over = min(b, e) - max(a, s)
            if over > best:
                best, name = over, n
        by_host[name] = by_host.get(name, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def execute(cell: Dict, config: Dict, mix: Dict, metrics: List[Dict], *,
            seed: int, seconds: float, trace: bool, device: torch.device,
            control: bool = False, t_process: Optional[float] = None
            ) -> Tuple[Dict, List[str]]:
    """Run the cell once; returns (the result object, the check lines for
    standard error)."""
    run = Run(workload=cell, config=config, mix=mix, seed=seed,
              seconds=seconds, device=device,
              t_process=time.monotonic() if t_process is None else t_process)
    runner = Runner(run, trace)
    runner.build()
    runner.warm_up()
    runner.window()
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    runner.close()
    edges = run.counters["edges"]
    d = edges["w1"]["dispatch"] - edges["w0"]["dispatch"]
    run.notes.append(
        "window graphs (captures/replays) " + " ".join(
            f"{k}={c}/{r}" for k, (c, r) in d.graphs_by_kind().items())
        + f" weight_misses={d.weight_misses} "
        f"weight_invalidations={d.weight_invalidations} "
        f"kernel_builds={d.retraces}")
    reports = {}
    for m in metrics:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            reports[m["name"]] = {"value": value, "unit": m["unit"]}
    t_ref = time.monotonic()
    verdict = correct.check(run, control=control)
    run.notes.append(f"reference {time.monotonic() - t_ref:.1f} s")
    wanted = run.window_requests()
    failed = sum(1 for s in wanted if not s.finished) if run.chat else 0
    result = {"correct": bool(verdict["correct"]) and failed == 0,
              "attempted": len(wanted), "failed": failed,
              "metrics": reports, "device": device_fields(run, device)}
    if run.profile is not None and run.profile["device"]:
        result["breakdown"] = breakdown(run.profile)
    lines = [f"perfbench: {cell['name']} seed={seed} sampled_requests="
             f"{verdict['sampled_requests']} sampled_tokens="
             f"{verdict.get('sampled_tokens', 0)}"]
    lines += [f"perfbench: note {n}" for n in run.notes]
    if "why" in verdict:
        lines.append(f"perfbench: not correct: {verdict['why']}")
    if "readings" in verdict:
        lines.append("perfbench: readings " + " ".join(
            f"{k}={v!r}" for k, v in verdict["readings"].items()))
    if "control" in verdict:
        result["control"] = verdict["control"]
        result["control_correct"] = verdict["control_correct"]
        lines.append("perfbench: control " + " ".join(
            f"{k}={v!r}" for k, v in verdict["control"].items()))
        lines += [f"perfbench: control check {k} {v['value']!r} limit "
                  f"{v['limit']!r}"
                  for k, v in verdict["control_numbers"].items()]
        lines.append(f"perfbench: control_correct "
                     f"{verdict['control_correct']}")
    numbers = verdict.get("numbers", {})
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}"
              for k, v in numbers.items()]
    result["checks"] = numbers
    return result, lines
