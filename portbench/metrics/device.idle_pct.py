"""device.idle_pct: the share of the traced window in which no kernel,
copy or memset runs on the card (the union of their intervals in the
torch.profiler trace)."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100 * (1 - run.trace.busy_us() / run.trace.window_us)
