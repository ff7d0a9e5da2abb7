"""Serving engine (serving/engine.py): the profiled sub-window's ms ÷
decode-body executions in it (DispatchStats, decode kind), chat cells."""
from perfbench.harness import readers


def read(run):
    span = readers.sub_window(run)
    if not run.chat or span is None:
        return None
    steps = readers.decode_steps(run)
    return 1e3 * (span[1] - span[0]) / steps if steps else None
