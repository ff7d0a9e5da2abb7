"""Serving engine (serving/engine.py): occupied decode slot-seconds ÷ all
slot-seconds over the window, from the program's "slots" gauge log
(core/telemetry.py), as a percentage, offline cells."""


def read(run):
    if run.chat:
        return None
    try:
        from repro_torch.core.telemetry import RECORDER
    except ImportError:                 # a program without the gauge log
        return None
    cfg = run.config
    # the harness names its tenants <config>.t<i> (harness/serve.py)
    names = {f"{cfg['name']}.t{i}" for i in range(cfg["engine"]["tenants"])} \
        if "engine" in cfg else None
    occupied, total = RECORDER.gauge_seconds("slots", *run.t_window,
                                             keys=names)
    return 100.0 * occupied / total if total > 0 else None
