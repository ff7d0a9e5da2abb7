"""Share of the requests due in the window that met both their tier's
TTFT limit and its mean-gap limit; one that did not finish misses."""
from perfbench.harness import traffic


def read(run):
    if not run.chat:
        return None
    reqs = run.window_requests()
    met = 0
    for s in reqs:
        if not s.finished:
            continue
        ttft_lim, gap_lim = traffic.tier_limits(run.mix, s.req.tier)
        n = len(s.instants)
        mean_gap = (s.instants[-1] - s.instants[0]) / (n - 1) if n > 1 \
            else 0.0
        met += (s.instants[0] - s.due <= ttft_lim) and mean_gap <= gap_lim
    return met / len(reqs) if reqs else None
