"""reads_per_s: the reads of every library finished in the window, over
the window's whole time (its first call's start to its last call's end)."""


def read(run):
    done = sum(c["ok"] for c in run.calls)
    return done * run.reads / run.window_s if run.window_s > 0 else None
