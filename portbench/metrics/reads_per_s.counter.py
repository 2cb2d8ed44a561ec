"""reads_per_s.counter: the counter cell's rate, read as reads_per_s
reads it (the reads of every library finished in the window, over the
window's whole time), but in its traced run and as a per-layer metric:
on the card's host its runs spread more than an end-to-end bound may
hold (PERF.md, section 2)."""


def read(run):
    done = sum(c["ok"] for c in run.calls)
    return done * run.reads / run.window_s if run.window_s > 0 else None
