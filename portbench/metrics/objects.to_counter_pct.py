"""objects.to_counter_pct: the span portbench.to_counter around
CountTable.to_counter(), summed over the window's calls, as a share of
the window."""


def read(run):
    spent = [c["spans"]["portbench.to_counter"] for c in run.calls
             if "portbench.to_counter" in c["spans"]]
    return 100 * sum(spent) / run.window_s if spent else None
