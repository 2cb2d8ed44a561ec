"""count_api.count_pct: the Count API's part of each call, the span
portbench.count (the entry's wall) less the table's _read_seconds, summed
over the window's calls, as a share of the window."""


def read(run):
    spent = sum(c["spans"].get("portbench.count", 0.0) - c["read_s"]
                for c in run.calls)
    return 100 * spent / run.window_s
