"""The plain reference of the count table: a FASTQ's exact table of
(length, 2-bit lanes) keys and their counts, in plain PyTorch on any
device.  It reads the FASTQ itself and imports nothing of the program.

Key layout (the program's public one): nucleotide i of a read sits in
32-bit lane i // 16 at bits 2 * (i % 16), with code (ascii >> 1) & 3
(A 0, C 1, T 2, G 3); lanes past the read are 0.  A key is a row of
int64 [length, lane_0, ..., lane_{L-1}], lanes as unsigned values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NT_PER_LANE = 16
_NL = 10
_VALID = (65, 67, 71, 84)  # A C G T
_M32 = 0xFFFFFFFF


@dataclass
class Table:
    """A count table: keys int64 [U, 1 + L] (sorted, distinct) and
    counts int64 [U], with the number of reads counted."""

    keys: torch.Tensor
    counts: torch.Tensor
    reads: int

    @property
    def lanes(self) -> int:
        return self.keys.shape[1] - 1


def read_bytes(path, device) -> torch.Tensor:
    return torch.from_numpy(np.fromfile(path, dtype=np.uint8)).to(device)


def sequence_lines(raw: torch.Tensor):
    """(starts, lengths) int64 of every record's sequence line; raises
    unless the buffer is whole 4-line records ('@' header, '+'
    separator, a quality as long as the read)."""
    if raw.numel() == 0:
        z = torch.zeros(0, dtype=torch.int64, device=raw.device)
        return z, z
    nl = torch.nonzero(raw == _NL).flatten()
    if int(raw[-1]) != _NL or nl.numel() % 4:
        raise ValueError("FASTQ is not whole 4-line records")
    first = torch.cat([nl.new_zeros(1), nl[:-1] + 1])
    starts, lengths = first[1::4], nl[1::4] - first[1::4]
    if not (bool((raw[first[0::4]] == ord("@")).all())
            and bool((raw[first[2::4]] == ord("+")).all())
            and torch.equal(nl[3::4] - first[3::4], lengths)):
        raise ValueError("FASTQ records are malformed")
    return starts, lengths


def pack(raw, starts, lengths, lanes: int, block: int = 1 << 18):
    """int64 [N, lanes] of the reads' 2-bit lanes, in blocks of rows;
    raises on a byte that is not A, C, G or T."""
    n = starts.numel()
    out = torch.zeros((n, lanes), dtype=torch.int64, device=raw.device)
    col = torch.arange(lanes * NT_PER_LANE, device=raw.device)
    shift = 2 * (col % NT_PER_LANE)
    last = max(raw.numel() - 1, 0)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        live = col < lengths[lo:hi, None]
        byte = raw[(starts[lo:hi, None] + col).clamp_(max=last)]
        ok = ((byte == _VALID[0]) | (byte == _VALID[1]) | (byte == _VALID[2])
              | (byte == _VALID[3]))
        if not bool((ok | ~live).all()):
            raise ValueError("a read holds a byte other than A, C, G, T")
        code = ((byte >> 1) & 3).to(torch.int64) * live
        out[lo:hi] = (code << shift).view(hi - lo, lanes,
                                          NT_PER_LANE).sum(-1)
    return out


def lanes_for(lengths) -> int:
    top = int(lengths.max()) if lengths.numel() else 0
    return max(1, -(-top // NT_PER_LANE))


def group(keys: torch.Tensor):
    """Table of the key rows: (distinct rows, sorted; their counts)."""
    if keys.shape[0] == 0:
        return keys, torch.zeros(0, dtype=torch.int64, device=keys.device)
    uniq, counts = torch.unique(keys, dim=0, return_counts=True)
    return uniq, counts.to(torch.int64)


def parse(path, device):
    """(keys int64 [N, 1 + L], N) of the FASTQ's reads, in file order."""
    raw = read_bytes(path, device)
    starts, lengths = sequence_lines(raw)
    lanes = pack(raw, starts, lengths, lanes_for(lengths))
    del raw
    return torch.cat([lengths[:, None], lanes], 1), int(lengths.numel())


def count_fastq(path, device="cpu") -> Table:
    """The reference table of the FASTQ at `path`."""
    keys, reads = parse(path, device)
    uniq, counts = group(keys)
    return Table(uniq, counts, reads)


def encode(seqs, lanes: int) -> torch.Tensor:
    """int64 [len(seqs), 1 + lanes] keys of sequences given as str."""
    out = np.zeros((len(seqs), 1 + lanes), np.int64)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("ascii"), np.uint8)
        if len(b) > lanes * NT_PER_LANE or not np.isin(b, _VALID).all():
            out[i, 0] = -1  # matches no key
            continue
        code = ((b >> 1) & 3).astype(np.int64)
        pos = np.arange(len(b))
        out[i, 0] = len(b)
        np.add.at(out[i, 1:], pos // NT_PER_LANE,
                  code << (2 * (pos % NT_PER_LANE)))
    return torch.from_numpy(out)


def lookup(table: Table, keys: torch.Tensor) -> list:
    """The count of each key row in `table` (0 where absent)."""
    keys = fit_lanes(keys.to(table.keys.device), table.lanes)
    u = table.keys.shape[0]
    if keys.shape[0] == 0:
        return []
    _, inverse = torch.unique(torch.cat([table.keys, keys]), dim=0,
                              return_inverse=True)
    row = torch.full((int(inverse.max()) + 1,), -1, dtype=torch.int64,
                     device=keys.device)
    row[inverse[:u]] = torch.arange(u, device=keys.device)
    hit = row[inverse[u:]]
    found = table.counts[hit.clamp(min=0)] if u else torch.zeros_like(hit)
    return [int(c) for c in torch.where(hit >= 0, found, 0)]


def decode(keys: torch.Tensor) -> list:
    """The reads (str) of int64 key rows [length, lanes...]."""
    keys = keys.cpu().numpy()
    letters = np.frombuffer(b"ACTG", np.uint8)
    out = []
    for row in keys:
        n = int(row[0])
        pos = np.arange(n)
        code = (row[1 + pos // NT_PER_LANE] >> (2 * (pos % NT_PER_LANE))) & 3
        out.append(letters[code].tobytes().decode("ascii"))
    return out


def fit_lanes(keys: torch.Tensor, lanes: int) -> torch.Tensor:
    """Key rows cut or zero-padded to `lanes` lanes; a row whose cut
    lanes are not all 0 gets length -1, so that it matches nothing."""
    have = keys.shape[1] - 1
    if have >= lanes:
        out = keys[:, :1 + lanes].clone()
        if have > lanes:
            spill = (keys[:, 1 + lanes:] != 0).any(1)
            out[spill, 0] = -1
        return out
    pad = keys.new_zeros((keys.shape[0], lanes - have))
    return torch.cat([keys, pad], 1)


def rows_wrong(keys: torch.Tensor, counts: torch.Tensor, ref: Table) -> int:
    """Rows by which a table (keys int64 [M, 1 + L'], counts [M]) departs
    from the reference: the repeated rows, plus the size of the symmetric
    difference of the two sets of (key, count) rows."""
    keys = fit_lanes(keys.to(ref.keys.device), ref.lanes)
    mine = torch.cat([keys, counts.to(keys.device, torch.int64)[:, None]], 1)
    theirs = torch.cat([ref.keys, ref.counts[:, None]], 1)
    distinct = torch.unique(mine, dim=0)
    repeated = mine.shape[0] - distinct.shape[0]
    both = torch.cat([distinct, theirs])
    if both.shape[0] == 0:
        return repeated
    _, seen = torch.unique(both, dim=0, return_counts=True)
    return repeated + int((seen == 1).sum())


def top_counts(ref: Table, k: int) -> list:
    """The k largest counts of the reference, in descending order."""
    k = min(k, ref.counts.numel())
    return [int(c) for c in torch.topk(ref.counts, k).values]
