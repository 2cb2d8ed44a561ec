"""umi.pack_pct: the program's ssq.umi_pack ranges (kernel A's pack and
validate of the distinct UMIs, with its copies), their union over the
traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.umi_pack")
