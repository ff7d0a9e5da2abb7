"""Front door and admission: 95th percentile of due time to first token
over the window's requests due before the profiled sub-window opens (one
that got none counts as infinitely late)."""
from perfbench.harness import measure, readers


def read(run):
    if not run.chat:
        return None
    waits = readers.ttfts(run)
    return measure.percentile(waits, 95) if waits else None
