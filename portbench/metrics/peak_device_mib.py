"""peak_device_mib: torch.cuda.max_memory_allocated() over the window
(its statistics reset at the window's start), less the device bytes of
the one output the harness keeps for the check, in MiB."""


def read(run):
    return run.peak_device_bytes / 2**20
