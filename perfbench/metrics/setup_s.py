"""Process start to the window's start: imports, kernel load, weights,
engine, warm-up epoch and the window epoch's ramp or lead-in."""


def read(run):
    return run.t_window[0] - run.t_process
