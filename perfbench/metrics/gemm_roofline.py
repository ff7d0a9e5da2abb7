"""Kernel (kernels/coalesced_gemm.py, csrc/coalesced_gemm.cu): Σ over the
profiled sub-window's launches (graph replays included) of each launch's
least time ÷ the kernel's device time in the profiler, as a percentage."""
from perfbench.harness import measure, readers


def read(run):
    split = readers.device_split(run)
    if run.chat or split is None or split[0] <= 0.0:
        return None
    return 100.0 * measure.launches_least_s(readers.launches(run)) / split[0]
