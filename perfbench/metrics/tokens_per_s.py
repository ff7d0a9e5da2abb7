"""Tokens delivered in the window ÷ its seconds (offline cells)."""


def read(run):
    if run.chat:
        return None
    t0, t1 = run.t_window
    n = sum(1 for s in run.served.values() for t in s.instants
            if t0 <= t <= t1)
    return n / (t1 - t0)
