"""Front door (serving/frontdoor.py): 95th percentile of due time to the
loop's poll stamp (``ServeRequest.arrival_t``) over the window's requests
due before the profiled sub-window opens."""
import math

from perfbench.harness import measure


def read(run):
    if not run.chat:
        return None
    waits = [s.poll - s.due if not math.isnan(s.poll) else math.inf
             for s in run.quiet_requests()]
    return measure.percentile(waits, 95) if waits else None
