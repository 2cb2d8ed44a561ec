"""The plain reference of UMI-tools' directional deduplication (Smith,
Heger and Sudbery, Genome Research 27:491-499, 2017: `umi_tools dedup
--method directional --edit-distance-threshold 1`) of reads that carry a
UMI at the 3' end, in plain PyTorch on any device.  It imports nothing of
the program.

Reads are grouped by insert (the read less its 3' UMI), which stands in
for the mapping position.  Within an insert, UMI a absorbs UMI b when the
two differ in one base and n_a >= 2 * n_b - 1, n being the reads of an
exact (insert, UMI) key.  The walk takes the keys by descending count,
ties by a given order: an unassigned key roots a molecule and takes every
unassigned key that it reaches along such edges.  A molecule's key is
its highest-count member, ties by the same order.

Neighbours are found by enumerating each UMI's 3 * len_3p one-base
substitutions and looking each up among the sorted (insert, UMI) keys
(`torch.searchsorted`), not by comparing pairs.

Keys follow reference/count.py's layout: int64 rows [length, lane_0,
...], nucleotide i in lane i // 16 at bits 2 * (i % 16), with code
(ascii >> 1) & 3 (A 0, C 1, T 2, G 3).

  from_reads(reads, len_3p)           the order is first occurrence in
                                      the reads: the whole molecule table
                                      and each read's molecule
  molecules_by_insert(table, len_3p)  from a count table (sorted keys, no
                                      order of occurrence): each insert's
                                      molecules and reads, which no tie
                                      order changes
"""

from __future__ import annotations

import numpy as np
import torch

NT_PER_LANE = 16
_LETTERS = np.frombuffer(b"ACTG", np.uint8)  # code -> base
_VALID = np.frombuffer(b"ACGT", np.uint8)
#: Rows a block of the substitution lookup.
_BLOCK = 1 << 18


def encode(reads, device="cpu") -> torch.Tensor:
    """int64 key rows [N, 1 + L] (count.py's layout) of reads given as str
    or bytes; raises on a byte other than A, C, G, T."""
    reads = [r.encode("ascii") if isinstance(r, str) else bytes(r)
             for r in reads]
    lengths = np.fromiter(map(len, reads), np.int64, len(reads))
    lanes = max(1, -(-int(lengths.max(initial=0)) // NT_PER_LANE))
    flat = np.frombuffer(b"".join(reads), np.uint8)
    if not np.isin(flat, _VALID).all():
        raise ValueError("a read holds a byte other than A, C, G, T")
    row = np.repeat(np.arange(len(reads), dtype=np.int64), lengths)
    pos = np.arange(flat.size, dtype=np.int64) \
        - np.repeat(np.cumsum(lengths) - lengths, lengths)
    code = torch.from_numpy(((flat >> 1) & 3).astype(np.int64)).to(device)
    row, pos = (torch.from_numpy(a).to(device) for a in (row, pos))
    out = torch.zeros((len(reads), lanes), dtype=torch.int64, device=device)
    out.view(-1).index_add_(0, row * lanes + pos // NT_PER_LANE,
                            code << (2 * (pos % NT_PER_LANE)))
    return torch.cat([torch.from_numpy(lengths).to(device)[:, None], out], 1)


def decode(keys: torch.Tensor, lengths) -> list:
    """The first lengths[i] bases of key row i, as bytes."""
    keys = keys.cpu().numpy()
    lengths = np.asarray(lengths, np.int64)
    pos = np.arange(int(lengths.max(initial=0)))
    code = (keys[:, 1 + pos // NT_PER_LANE] >> (2 * (pos % NT_PER_LANE))) & 3
    rows = _LETTERS[code]
    return [rows[i, :n].tobytes() for i, n in enumerate(lengths.tolist())]


def split(keys: torch.Tensor, len_3p: int):
    """(insert rows int64 [U, 1 + L]: length and lanes of the read less its
    UMI; the UMIs int64 [U], base j at bits 2 * j) of key rows."""
    if len_3p <= 0:
        raise ValueError("len_3p must be positive")
    dev = keys.device
    lanes = keys[:, 1:]
    ins_len = keys[:, 0] - len_3p
    if bool((ins_len < 0).any()):
        raise ValueError(f"a read is shorter than its {len_3p}-nt UMI")
    j = torch.arange(len_3p, device=dev)
    pos = ins_len[:, None] + j
    code = (lanes.gather(1, pos // NT_PER_LANE)
            >> (2 * (pos % NT_PER_LANE))) & 3
    umi = (code << (2 * j)).sum(1)
    first = torch.arange(lanes.shape[1], device=dev) * NT_PER_LANE
    kept = (ins_len[:, None] - first).clamp(0, NT_PER_LANE)
    mask = (torch.ones_like(kept) << (2 * kept)) - 1
    insert = torch.cat([ins_len[:, None], lanes & mask], 1)
    return insert, umi


def edges(gid, umi, counts, len_3p: int):
    """(src, dst) int64 of the directional edges: keys of one insert whose
    UMIs differ in one base, with counts[src] >= 2 * counts[dst] - 1."""
    dev = umi.device
    if gid.numel() and int(gid.max()).bit_length() + 2 * len_3p > 62:
        raise ValueError("too many inserts for a UMI this long")
    key = (gid << (2 * len_3p)) | umi
    ordered, perm = torch.sort(key)
    j = torch.arange(len_3p, device=dev).repeat_interleave(3)
    flips = torch.arange(1, 4, device=dev).repeat(len_3p) << (2 * j)
    src, dst = [], []
    for lo in range(0, key.numel(), _BLOCK):
        cand = key[lo:lo + _BLOCK, None] ^ flips
        at = torch.searchsorted(ordered, cand).clamp_(max=key.numel() - 1)
        row, col = (ordered[at] == cand).nonzero(as_tuple=True)
        src.append(row + lo)
        dst.append(perm[at[row, col]])
    src = torch.cat(src) if src else key.new_zeros(0)
    dst = torch.cat(dst) if dst else key.new_zeros(0)
    down = counts[src] >= 2 * counts[dst] - 1
    return src[down], dst[down]


def _by(counts, order):
    """Key indices by descending count, ties by ascending order."""
    idx = torch.argsort(order)
    return idx[torch.argsort(-counts[idx], stable=True)]


def walk(src, dst, counts, order) -> torch.Tensor:
    """The root (a key index) of each key's molecule: keys by descending
    count, ties by `order`; each unassigned key roots a molecule and takes
    every unassigned key it reaches along the edges."""
    u = counts.numel()
    by_src = torch.argsort(src, stable=True)
    indptr = [0] + torch.cumsum(torch.bincount(src, minlength=u),
                                0).tolist()
    nbrs = dst[by_src].tolist()
    root = [-1] * u
    for r in _by(counts, order).tolist():
        if root[r] >= 0:
            continue
        root[r] = r
        stack = [r]
        while stack:
            x = stack.pop()
            for y in nbrs[indptr[x]:indptr[x + 1]]:
                if root[y] < 0:
                    root[y] = r
                    stack.append(y)
    return torch.tensor(root, dtype=torch.int64, device=counts.device)


def cluster(keys, counts, order, len_3p: int):
    """(insert rows, group id of each key, root of each key's molecule, its
    representative: the highest-count member, ties by `order`)."""
    insert, umi = split(keys, len_3p)
    _, gid = torch.unique(insert, dim=0, return_inverse=True)
    src, dst = edges(gid, umi, counts, len_3p)
    root = walk(src, dst, counts, order)
    # Members by (molecule, descending count, order): each molecule's
    # first is its representative.
    idx = _by(counts, order)
    idx = idx[torch.argsort(root[idx], stable=True)]
    head = torch.ones_like(idx, dtype=torch.bool)
    head[1:] = root[idx][1:] != root[idx][:-1]
    rep = torch.empty_like(root)
    rep[root[idx[head]]] = idx[head]
    return insert, gid, root, rep[root]


def from_reads(reads, len_3p: int, device="cpu"):
    """Directional deduplication of reads (str or bytes, the UMI the last
    len_3p bases), ties by first occurrence.  Returns (labels, molecules,
    reads_per_molecule): labels int64 [N], the molecule of each read;
    molecules[m] = (insert bytes, UMI bytes) of molecule m's
    representative, molecules in the order of their representative's
    first occurrence; reads_per_molecule int64 [M]."""
    keys = encode(reads, device)
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), [], np.zeros(0, np.int64)
    uniq, inverse, counts = torch.unique(keys, dim=0, return_inverse=True,
                                         return_counts=True)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=keys.device),
                          "amin")
    _, _, _, rep = cluster(uniq, counts, first, len_3p)
    heads = torch.unique(rep)
    heads = heads[torch.argsort(first[heads])]
    mol_of = torch.empty_like(rep)
    mol_of[heads] = torch.arange(heads.numel(), device=keys.device)
    labels = mol_of[rep][inverse].cpu().numpy()
    lengths = uniq[heads, 0].cpu().numpy()
    seqs = decode(uniq[heads], lengths)
    molecules = [(s[:len(s) - len_3p], s[len(s) - len_3p:]) for s in seqs]
    return labels, molecules, np.bincount(labels, minlength=len(molecules))


def molecules_by_insert(table, len_3p: int) -> dict:
    """{insert bytes: (molecules, reads)} of a count table (`keys`, sorted
    distinct key rows, and their `counts`, as reference/count.py's Table).

    No tie order changes these numbers, so the table's own key order
    serves.  A key of count c >= 2 has no edge to another of count c
    (c >= 2c - 1 fails), and edges lead to lower counts except between
    keys of count 1; so every key of count c >= 2 still unassigned when
    the walk reaches count c roots a molecule, whatever its place among
    its ties.  What those roots take together is all that they reach
    through unassigned keys, whatever their order, so the keys still
    unassigned at each count are the same; and the keys of count 1 left
    at the end form a fixed number of components."""
    keys, counts = table.keys, table.counts
    if keys.shape[0] == 0:
        return {}
    order = torch.arange(keys.shape[0], device=keys.device)
    insert, gid, root, _ = cluster(keys, counts, order, len_3p)
    roots = root == order
    groups = int(gid.max()) + 1
    mols = torch.bincount(gid[roots], minlength=groups).tolist()
    reads = torch.zeros(groups, dtype=torch.int64, device=keys.device)
    reads.index_add_(0, gid, counts.to(torch.int64))
    first = torch.full((groups,), keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, gid, order, "amin")
    names = decode(insert[first], insert[first, 0].cpu().numpy())
    return {name: (m, r) for name, m, r in zip(names, mols, reads.tolist())}
