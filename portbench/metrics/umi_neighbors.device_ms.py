"""umi_neighbors.device_ms: device ms a library of the kernels, copies and
memsets launched inside the program's ssq.umi_neighbors ranges (the
torch.profiler trace).  The traced run prints the trace's kernel H
launches beside the program's count of them."""

#: {kernel name in the trace: the program's launch counter}.
LAUNCHES = {
    "neighbor_lists_kernel":
        "shortseq_torch.umi.dedup:neighbor_lists_fused.launches",
}


def read(run):
    if run.trace is None or not run.calls:
        return None
    inside = run.trace.launched_in("ssq.umi_neighbors")
    if not inside:
        return None
    return sum(b - a for a, b, _, _ in inside) / 1e3 / len(run.calls)
