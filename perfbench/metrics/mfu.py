"""Model step (models/model.py, models/transformer.py): model FLOPs of the
prompts and tokens served in the profiled sub-window ÷ (its seconds ×
the bf16 peak), as a percentage."""
from perfbench.harness import measure, readers


def read(run):
    span = readers.sub_window(run)
    if run.chat or span is None:
        return None
    flops = readers.window_flops(run, *span)
    if flops <= 0.0:
        return None
    return 100.0 * flops / ((span[1] - span[0]) * measure.PEAK_BF16_FLOPS)
