"""unique_count_roofline: the bytes of the window's unique_count
calls (inputs read once, the table written once, from their shapes) at
the card's HBM rate, over the device time launched inside the
ssq.unique_count ranges."""

import roofline


def call_bytes(args, result) -> int:
    """Bytes of one unique_count(words, lengths, weights) call: its three
    inputs read once and its table (words, lengths, counts, n_unique)
    written once."""
    return sum(roofline.tensor_bytes(t) for t in (*args[:3], *result[:4]))


def probe(program):
    from shortseq_torch.count import device as cdev

    return roofline.CallBytes(cdev.unique_count, program.modules, call_bytes)


def read(run):
    bytes_ = run.probes["unique_count_roofline"].bytes if run.probes else 0
    if run.trace is None or not run.hbm_bytes_per_s or not bytes_:
        return None
    inside = run.trace.launched_in("ssq.unique_count")
    device_s = sum(b - a for a, b, _, _ in inside) / 1e6
    if device_s <= 0:
        return None
    return 100 * bytes_ / run.hbm_bytes_per_s / device_s
