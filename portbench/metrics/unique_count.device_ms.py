"""unique_count.device_ms: device ms a library of the kernels, copies and
memsets launched inside the program's ssq.unique_count ranges (the
torch.profiler trace).  The traced run checks that the trace saw every
launch of unique_count's kernels that the program counted."""

#: {kernel name in the trace: the program's launch counter}.
LAUNCHES = {
    "group_tile_kernel": "shortseq_torch.count.device:group_count.launches",
    "sort_hist_kernel": "shortseq_torch.count.device:sort_rows.launches",
    "row_hash_kernel": "shortseq_torch.count.device:_ROW_HASH.launches",
}


def read(run):
    if run.trace is None or not run.calls:
        return None
    inside = run.trace.launched_in("ssq.unique_count")
    if not inside:
        return None
    return sum(b - a for a, b, _, _ in inside) / 1e3 / len(run.calls)
