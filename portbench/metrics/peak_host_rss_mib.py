"""peak_host_rss_mib: the measuring process's peak resident set
(ru_maxrss: from its start, so set-up's warm-up call counts too), less
the resident bytes of what the harness keeps of one output for the
check, in MiB.  The library is generated in a child process, so its
arrays are not in it."""


def read(run):
    return run.peak_rss_bytes / 2**20
