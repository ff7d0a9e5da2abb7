"""95th percentile over every gap between consecutive tokens of the
requests due in the window."""
from perfbench.harness import measure


def read(run):
    if not run.chat:
        return None
    gaps = [b - a for s in run.window_requests()
            for a, b in zip(s.instants, s.instants[1:])]
    return measure.percentile(gaps, 95) if gaps else None
