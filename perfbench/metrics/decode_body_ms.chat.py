"""Serving engine (serving/engine.py): mean device ms of one decode body
(CUDA events around it, on its span's ``device_ms``; core/telemetry.py)
over the profiled sub-window's dispatches that captured no graph, chat
cells."""
from perfbench.harness import readers


def read(run):
    span = readers.sub_window(run)
    if not run.chat or span is None:
        return None
    try:
        from repro_torch.core.telemetry import RECORDER
    except ImportError:                 # a program without spans
        return None
    spans = RECORDER.spans_in(*span)
    captured = {s.parent for s in spans if s.name == "graphs.capture"}
    ms = [v for s in spans if s.uid not in captured
          for kind, v in s.attrs.get("device_ms", ()) if kind == "decode"]
    return sum(ms) / len(ms) if ms else None
