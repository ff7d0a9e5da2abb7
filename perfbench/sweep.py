"""Find a chat mix's knee once, on the card: one set-up, then one window
per offered rate on the same engine.

    python3 perfbench/sweep.py --workload <chat cell> --seed <n> \
        --seconds <s> --rates 2,4,8,12,16

For each rate it prints the TTFT and inter-token-gap medians and 95th
percentiles over the requests due in the window, how much later the last
quarter of them got their first token than the first quarter (a queue that
grows), and the tokens per second delivered. The knee is the highest rate
whose queue does not grow; the cell's rate and its base SLO limits are
then written into the mix file by hand. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from run import ROOT, _environment


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    _environment()
    import torch
    from perfbench.harness import manifest as mf
    from perfbench.harness import measure
    from perfbench.harness.serve import Runner, Run
    manifest = mf.load(ROOT)
    cell = mf.workload(manifest, args.workload)
    mix = mf.traffic(cell["traffic"])
    run = Run(workload=cell, config=mf.config(manifest, cell["config"], ROOT),
              mix=mix, seed=args.seed, seconds=args.seconds,
              device=torch.device("cuda", 0), t_process=time.monotonic())
    runner = Runner(run, trace=False)
    runner.build()
    runner.warm_up()
    for rate in [float(r) for r in args.rates.split(",")]:
        run.mix = runner.mix = dict(mix, arrival=dict(mix["arrival"],
                                                      rate_rps=rate))
        run.served, run.events, run.prompts = {}, [], {}
        runner.window()
        reqs = sorted(run.window_requests(), key=lambda s: s.due)
        ttft = [s.instants[0] - s.due for s in reqs if s.instants]
        gaps = [b - a for s in reqs for a, b in zip(s.instants,
                                                    s.instants[1:])]
        q = max(len(ttft) // 4, 1)
        t0, t1 = run.t_window
        toks = sum(1 for s in run.served.values() for t in s.instants
                   if t0 <= t <= t1)
        print(json.dumps({
            "rate_rps": rate, "requests": len(reqs),
            "unfinished": sum(not s.finished for s in reqs),
            "ttft_p50_s": statistics.median(ttft),
            "ttft_p95_s": measure.percentile(ttft, 95),
            "gap_p50_s": statistics.median(gaps),
            "gap_p95_s": measure.percentile(gaps, 95),
            "ttft_growth_s": statistics.mean(ttft[-q:])
            - statistics.mean(ttft[:q]),
            "tokens_per_s": toks / (t1 - t0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
