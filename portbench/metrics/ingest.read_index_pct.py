"""ingest.read_index_pct: the program's own timer of the FASTQ read and
index (each table's _read_seconds), summed over the window's calls, as a
share of the window."""


def read(run):
    return 100 * sum(c["read_s"] for c in run.calls) / run.window_s
