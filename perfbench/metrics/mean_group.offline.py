"""JIT session, OoO scheduler, coalescer: ops per scheduler dispatch over
the program's ``jit.dispatch`` spans (core/telemetry.py) in the profiled
sub-window, offline cells."""
from perfbench.harness import readers


def read(run):
    span = readers.sub_window(run)
    if run.chat or span is None:
        return None
    try:
        from repro_torch.core.telemetry import RECORDER
    except ImportError:                 # a program without spans
        return None
    groups = [s.attrs["group"] for s in RECORDER.spans_in(*span)
              if s.name == "jit.dispatch"]
    return sum(groups) / len(groups) if groups else None
