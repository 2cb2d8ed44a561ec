"""table.reads_ms: host ms a library of the lazy table's reads, the span
portbench.top<N> around most_common(N) and total() (both return host
values, so the span holds their synchronisation)."""


def read(run):
    spent = [[s for k, s in c["spans"].items() if k.startswith("portbench.top")]
             for c in run.calls]
    if not any(spent):
        return None
    return 1e3 * sum(map(sum, spent)) / len(spent)
