"""Admission (serving/engine.py waiting list): 95th percentile of the
seconds each request waited while its tenant had no free decode slot (the
program's request lifecycles, core/telemetry.py), over the window's
requests due before the profiled sub-window opens; one never admitted
counts as infinitely late."""
import math

from perfbench.harness import measure


def read(run):
    if not run.chat:
        return None
    try:
        from repro_torch.core.telemetry import RECORDER
    except ImportError:                 # a program without the lifecycles
        return None
    lives = [RECORDER.requests.get(s.req.rid) for s in run.quiet_requests()]
    lives = [life if life is not None and life.polled >= run.t_process
             else None for life in lives]
    if all(life is None for life in lives):
        return None
    waits = [life.wait_slots
             if life is not None and not math.isnan(life.admitted)
             else math.inf for life in lives]
    return measure.percentile(waits, 95)
