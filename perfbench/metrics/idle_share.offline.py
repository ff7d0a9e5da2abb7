"""Device: 1 − (union of device-operation intervals ÷ the profiled
window), as a percentage, offline cells."""
from perfbench.harness import measure
from perfbench.harness.cell import profile_window


def read(run):
    if run.chat or run.profile is None or not run.profile["device"]:
        return None
    t0, t1 = profile_window(run.profile)
    spans = [(s, e) for _, s, e in run.profile["device"]]
    return 100.0 * measure.idle_share(spans, t0, t1)
