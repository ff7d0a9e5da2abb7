"""Glue (core/jit.py glue, models/moe.py): device ms of every operation
other than coalesced_gemm in the profiled sub-window ÷ decode steps."""
from perfbench.harness import readers


def read(run):
    split = readers.device_split(run)
    if run.chat or split is None:
        return None
    steps = readers.decode_steps(run)
    return 1e3 * split[1] / steps if steps else None
