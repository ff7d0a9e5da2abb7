"""JIT session, OoO scheduler, coalescer: ops per scheduler dispatch
(``JitStats.groups``) over the chat window's epoch, folded as its loop
closes."""


def read(run):
    count, total = run.counters.get("groups", (0, 0.0))
    if not run.chat or not count:
        return None
    return total / count
