"""Command-line entry point: `python -m shortseq_torch <command>`.

Commands:
  count FILE   exact-dedup a FASTQ (plain, gzip or BGZF), print a TSV count
               table; --shards N / --checkpoint DIR run the resumable
               byte-range pipeline (dist/pipeline.py)
  pack SEQ...  pack sequences and show their width class, hex words, hash
  umi FILE     UMI-deduplicate FASTQ reads (molecule table to stdout)

The same arguments and the same TSV / JSON output as
`python -m shortseq_tpu count|pack|umi`, plus `--device` (default cuda)
for count and umi.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_count(args) -> int:
    import contextlib

    from .api.counter import read_and_count_fastq, read_and_count_fastq_table

    try:
        # The reference phase-timing print goes to stderr so stdout stays
        # a clean table.
        with contextlib.redirect_stdout(sys.stderr):
            if args.shards > 1 or args.checkpoint:
                items = _count_sharded_items(args)
            elif args.top:
                # Lazy path: only the top N rows are fetched and
                # materialized (count/table.py), never the full dict.
                table = read_and_count_fastq_table(
                    args.file, engine=args.engine, device=args.device)
                items = table.most_common(args.top)
            else:
                counts = read_and_count_fastq(args.file, engine=args.engine,
                                              device=args.device)
                items = sorted(counts.items(), key=lambda kv: -kv[1])
    except Exception as e:
        # Invalid bases raise the reference's bare Exception, bad paths
        # OSError, a missing card RuntimeError: all print cleanly.
        print(f"error: {e}", file=sys.stderr)
        return 2

    _write_table(args, items,
                 to_json=lambda items: {str(k): v for k, v in items},
                 to_row=lambda k, v: f"{k}\t{v}\n")
    return 0


def _count_sharded_items(args):
    """The resumable pipeline from the shell: byte-range shards, optional
    crash-safe checkpoint spills (a rerun with the same --checkpoint dir
    skips completed shards), lazy top-N reads."""
    from .config import PipelineConfig
    from .count.table import CountTable
    from .dist.pipeline import count_fastq_sharded

    if args.engine == "host":
        # The sharded pipeline counts on device by construction; silently
        # dropping an explicit engine choice would surprise exactly the
        # user who picked it to avoid the device backend.
        raise ValueError(
            "--engine host is not available with --shards/--checkpoint "
            "(the sharded pipeline counts on device); drop --engine or "
            "run without sharding")
    cfg = PipelineConfig(checkpoint_dir=args.checkpoint)
    n_shards = args.shards
    table = count_fastq_sharded(args.file, n_shards=n_shards, config=cfg,
                                device=args.device)
    lazy = CountTable.from_device_tables([tuple(table)])
    print(f"sharded count: {n_shards} shard(s), "
          f"{len(lazy)} unique sequences"
          + (f", checkpoints in {args.checkpoint}" if args.checkpoint
             else ""))
    if args.top:
        return lazy.most_common(args.top)
    return lazy.most_common()


def _write_table(args, items, to_json, to_row):
    """--top/--json/--output writer."""
    if args.top:
        items = items[:args.top]
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.json:
            json.dump(to_json(items), out)
            out.write("\n")
        else:
            for k, v in items:
                out.write(to_row(k, v))
    finally:
        if args.output:
            out.close()


def _cmd_umi(args) -> int:
    import numpy as np

    from .io.fastq import read_fastq_matrix
    from .umi.dedup import dedup_reads

    if args.len_5p + args.len_3p <= 0:
        print("error: at least one of --len-5p/--len-3p must be positive",
              file=sys.stderr)
        return 2
    mat, lengths = read_fastq_matrix(args.file, pad_to=1)
    if len(lengths) and (lengths == lengths[0]).all():
        reads = np.ascontiguousarray(mat[:, :lengths[0]])  # matrix path
    else:
        reads = [mat[i, :lengths[i]].tobytes() for i in range(len(lengths))]
    try:
        labels, molecules = dedup_reads(
            reads, len_5p=args.len_5p, len_3p=args.len_3p,
            threshold=args.threshold, method=args.method,
            device=args.device)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    counts = np.bincount(labels, minlength=len(molecules))
    print(f"{len(labels)} reads -> {len(molecules)} molecules "
          f"({args.method}, threshold {args.threshold})", file=sys.stderr)

    items = sorted(zip(molecules, counts), key=lambda kv: -kv[1])
    _write_table(
        args, items,
        to_json=lambda items: [{"insert": i.decode("ascii", "replace"),
                                "umi": u.decode("ascii", "replace"),
                                "reads": int(c)} for (i, u), c in items],
        to_row=lambda mol, c: (f"{mol[0].decode('ascii', 'replace')}\t"
                               f"{mol[1].decode('ascii', 'replace')}\t{c}\n"))
    return 0


def _cmd_pack(args) -> int:
    from . import pack
    from .oracle import encode_bytes

    for s in args.seq:
        obj = pack(s)
        blocks = encode_bytes(s.encode())  # reference uint64 block layout
        words = " ".join(f"{b:016x}" for b in blocks)
        print(f"{s}\t{type(obj).__name__}\tlen={len(obj)}\t"
              f"hash={hash(obj)}\tblocks={words or '-'}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m shortseq_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)

    c = sub.add_parser("count", help="exact-dedup a FASTQ file")
    c.add_argument("file")
    c.add_argument("--engine", default="auto",
                   choices=("auto", "host", "device"))
    c.add_argument("--top", type=int, default=0,
                   help="only the N most frequent sequences")
    c.add_argument("--json", action="store_true",
                   help="JSON object instead of TSV")
    c.add_argument("--output", "-o", default=None,
                   help="write the table here instead of stdout")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device engine counts")

    def _positive(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    c.add_argument("--shards", type=_positive, default=1,
                   help="count in N byte-range shards (the resumable "
                        "pipeline; requires uncompressed or BGZF FASTQ "
                        "for N > 1)")
    c.add_argument("--checkpoint", default=None,
                   help="spill per-shard tables here; a rerun skips "
                        "completed shards (crash-safe resume)")
    c.set_defaults(fn=_cmd_count)

    u = sub.add_parser("umi", help="UMI-deduplicate FASTQ reads")
    u.add_argument("file")
    u.add_argument("--len-5p", type=int, default=0,
                   help="UMI length on the 5' end")
    u.add_argument("--len-3p", type=int, default=0,
                   help="UMI length on the 3' end")
    u.add_argument("--threshold", type=int, default=1,
                   help="max hamming distance for UMI collapse")
    u.add_argument("--method", default="directional",
                   choices=("unique", "cluster", "adjacency", "directional"))
    u.add_argument("--top", type=int, default=0,
                   help="only the N most frequent molecules")
    u.add_argument("--json", action="store_true",
                   help="JSON list instead of TSV")
    u.add_argument("--output", "-o", default=None,
                   help="write the table here instead of stdout")
    u.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the pack and adjacency stages run")
    u.set_defaults(fn=_cmd_umi)

    p = sub.add_parser("pack", help="pack sequences, show their encoding")
    p.add_argument("seq", nargs="+")
    p.set_defaults(fn=_cmd_pack)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
