"""PackedBatch: `[N, W]` packed lanes plus `[N]` lengths on one device.

Counterpart of shortseq_tpu/batch.py.  Everything the scalar objects do
(pack, decode, hamming, slice, count) exists here as a batched op on a
structure-of-arrays batch; the scalar ShortSeq objects are the facade on
top.  The device is explicit: `device="cuda"` launches the kernels and
raises when there is no card, `device="cpu"` runs their plain versions.

Trimming runs through kernel F (csrc/batch.cu): `trim_words` (one start
and length for every row) and `trim_words_ragged` (per row) are one
kernel.  A start or length given as a Python int reaches it as a scalar,
as the JAX package's static `_trim_words` made it a constant, so no `[N]`
tensor is built for it; per-row ones go as `[N]` int32 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .constants import (MAX_VAR_NT, NT_PER_LANE, PAD_BYTE, TOO_LONG_MSG,
                        UNSUPPORTED_BASE_MSG, lanes_for_length)

_INT32_MAX = 2**31 - 1


def _ascii_matrix(seqs, width=None):
    """List of str/bytes -> PAD_BYTE-padded uint8 matrix + int32 lengths.
    The pad byte passes the bloom and encodes to code 0, so the pack may
    skip the length mask (pad_valid=True; constants.PAD_BYTE)."""
    norm = [s.encode("ascii") if isinstance(s, str) else bytes(s)
            for s in seqs]
    lengths = np.fromiter(map(len, norm), np.int32, len(norm))
    max_len = int(lengths.max()) if len(norm) else 0
    if max_len > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    if width is None:
        width = max(NT_PER_LANE, -(-max_len // NT_PER_LANE) * NT_PER_LANE)
    if width % NT_PER_LANE:
        raise ValueError(f"width must be a multiple of {NT_PER_LANE}")
    if max_len > width:
        raise ValueError(f"width {width} is too small for a {max_len} nt read")
    mat = np.full((len(norm), width), PAD_BYTE, np.uint8)
    if max_len:
        flat = np.frombuffer(b"".join(norm), np.uint8)
        if (lengths == max_len).all():
            mat[:, :max_len] = flat.reshape(len(norm), max_len)
        else:
            rows = np.repeat(np.arange(len(norm)), lengths)
            cols = np.arange(flat.size) - np.repeat(
                np.cumsum(lengths, dtype=np.int64) - lengths, lengths)
            mat[rows, cols] = flat
    return mat, lengths


# --- kernel F: trim -----------------------------------------------------------


def trim_words_ragged_plain(words, lengths, starts, new_lengths, out_w: int):
    """Plain PyTorch version of kernel F (any device): row i becomes
    seq[s : s + new_lengths[i]] with s = max(starts[i], 0), clamped to the
    row and to 16 * out_w nt.  Returns (`[N, out_w]` words, `[N]` int32
    lengths)."""
    n, w = words.shape
    dev = words.device
    starts = starts.to(torch.int32).clamp_min(0)
    sh = (2 * (starts % NT_PER_LANE))[:, None]
    lane = torch.arange(out_w, dtype=torch.int32, device=dev)
    src = (starts // NT_PER_LANE)[:, None] + lane[None, :]

    def take(idx):
        got = torch.gather(words, 1, idx.clamp(0, max(w - 1, 0)).long())
        return torch.where(idx < w, got, 0)

    lo, hi = take(src), take(src + 1)
    # Shifts are even, 2..30 where they count: the logical right shift's
    # mask (1 << (32 - s)) - 1 fits int32.  Rows with shift 0 select `lo`
    # (a shift by 32 is not 0 in torch), so their stand-in shift of 2 is
    # discarded by the where.
    s = torch.where(sh == 0, 2, sh)
    funnel = ((lo >> s) & ((1 << (32 - s)) - 1)) | (hi << (32 - s))
    shifted = torch.where(sh == 0, lo, funnel)
    new_len = torch.minimum(new_lengths.to(torch.int32).clamp_min(0),
                            (lengths - starts).clamp_min(0))
    new_len = new_len.clamp_max(NT_PER_LANE * out_w)
    r = (new_len[:, None] - NT_PER_LANE * lane[None, :]).clamp(0, NT_PER_LANE)
    # r == 16 keeps the whole lane; (1 << 32) - 1 would overflow int32.
    mask = torch.where(r >= NT_PER_LANE, -1,
                       (1 << (2 * r.clamp_max(NT_PER_LANE - 1))) - 1)
    return shifted & mask, new_len


def _clamp_i32(value) -> int:
    return max(-_INT32_MAX - 1, min(int(value), _INT32_MAX))


def _full(n: int, value: int, device) -> torch.Tensor:
    return torch.full((n,), _clamp_i32(value), dtype=torch.int32,
                      device=device)


def trim_words_ragged(words, lengths, starts, new_lengths, out_w: int):
    """Per-row subsequence on packed lanes (kernel F): `[N, W]` words,
    `[N]` lengths, starts (negative starts clamp to 0) and lengths wanted
    -> (`[N, out_w]` words, `[N]` lengths), tails zeroed.  `starts` and
    `new_lengths` are each an `[N]` int32 tensor or one int for every row,
    which the kernel takes as a scalar.  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    n, w = words.shape
    if out_w < 1:
        raise ValueError("out_w must be >= 1")
    per_row = {"starts": starts, "new_lengths": new_lengths}
    for name, t in (("lengths", lengths), *per_row.items()):
        if (name == "lengths" or isinstance(t, torch.Tensor)) \
                and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    dev = words.device
    if dev.type == "cpu":
        starts, new_lengths = (
            t if isinstance(t, torch.Tensor) else _full(n, t, dev)
            for t in per_row.values())
        return trim_words_ragged_plain(words, lengths, starts, new_lengths,
                                       out_w)
    _build.check_operand(words, "words", torch.int32, 2, dev)
    _build.check_operand(lengths, "lengths", torch.int32, 1, dev)
    ptrs, scalars = [], []
    for name, t in per_row.items():
        if isinstance(t, torch.Tensor):
            _build.check_operand(t, name, torch.int32, 1, dev)
            ptrs.append(t.data_ptr())
            scalars.append(0)
        else:
            ptrs.append(None)
            scalars.append(_clamp_i32(t))
    out = torch.empty((n, out_w), dtype=torch.int32, device=dev)
    out_len = torch.empty(n, dtype=torch.int32, device=dev)
    _build.launch("ssq_trim_words", words.data_ptr(), lengths.data_ptr(),
                  *ptrs, *scalars, out.data_ptr(), out_len.data_ptr(), n, w,
                  out_w)
    trim_words_ragged.launches += 1
    return out, out_len


trim_words_ragged.launches = 0


def trim_words_plain(words, lengths, start: int, length: int, out_width: int):
    """Plain PyTorch version of trim_words (any device)."""
    n = words.shape[0]
    return trim_words_ragged_plain(words, lengths,
                                   _full(n, start, words.device),
                                   _full(n, length, words.device), out_width)


def trim_words(words, lengths, start: int, length: int, out_width: int):
    """Every row becomes seq[start : start + length], clamped per row
    (kernel F with a scalar start and length: one launch, no [N]
    tensor)."""
    return trim_words_ragged(words, lengths, int(start), int(length),
                             out_width)


# --- the batch ----------------------------------------------------------------


def _rows_to_str(ascii_mat: np.ndarray, lengths: np.ndarray) -> list:
    """Host half of decode: row i of a contiguous uint8 matrix, cut at its
    length, as str."""
    width = ascii_mat.shape[1]
    buf = memoryview(ascii_mat.reshape(-1))
    return [str(buf[o:o + ln], "ascii")
            for o, ln in zip(range(0, ascii_mat.size, width),
                             lengths.tolist())]


@dataclass(frozen=True)
class PackedBatch:
    """`[N, W]` int32 packed lanes (uint32 bits) + `[N]` int32 lengths,
    both on one device."""

    words: torch.Tensor
    lengths: torch.Tensor

    # -- construction --------------------------------------------------------

    @classmethod
    def from_seqs(cls, seqs, width: int | None = None,
                  device="cuda") -> "PackedBatch":
        """Pack a list of str/bytes on `device`, validating every base
        there (kernel A) and raising the reference's error on failure."""
        from .oracle import first_invalid_char
        from .ops.bitpack import pack_and_validate_rows
        from .utils.warmup import start_transfer_warmup

        device = _build.resolve_device(device)
        start_transfer_warmup(device)
        mat, lengths = _ascii_matrix(seqs, width)
        lengths_d = torch.from_numpy(lengths).to(device)
        if len(seqs) == 0:
            return cls(torch.zeros((0, 1), dtype=torch.int32, device=device),
                       lengths_d)
        # pad_valid: _ascii_matrix pads with PAD_BYTE.
        words, ok = pack_and_validate_rows(mat.view(np.uint32), lengths,
                                           pad_valid=True, device=device)
        ok = ok.cpu().numpy()
        if not ok.all():
            i = int(np.argmin(ok))
            bad = first_invalid_char(mat[i, :lengths[i]])
            raise Exception(f"{UNSUPPORTED_BASE_MSG}: {bad}")
        return cls(words, lengths_d)

    @classmethod
    def from_matrix(cls, mat, lengths, device="cuda") -> "PackedBatch":
        """Pack an already-padded uint8 ASCII matrix (e.g. straight from
        io.read_fastq_matrix) on `device` without validation (kernel A's
        pack-only mode); columns are zero-padded to a multiple of 16, and
        zero bytes pack to code 0, the reference's zero-filled tail."""
        from .ops.bitpack import pack_rows

        device = _build.resolve_device(device)
        mat = np.ascontiguousarray(mat, np.uint8)
        pad = -mat.shape[1] % 16
        if pad:
            mat = np.ascontiguousarray(np.pad(mat, ((0, 0), (0, pad))))
        lengths = np.ascontiguousarray(lengths, np.int32)
        return cls(pack_rows(mat.view(np.uint32), device=device),
                   torch.from_numpy(lengths).to(device))

    # -- shape ---------------------------------------------------------------

    def __len__(self) -> int:
        return self.words.shape[0]

    @property
    def width_lanes(self) -> int:
        return self.words.shape[1]

    def __getitem__(self, item) -> "PackedBatch":
        """Row selection (int/slice/index array) -> sub-batch."""
        if isinstance(item, (int, np.integer)):
            index = int(item)
            n = len(self)
            if index < 0:
                index += n
            if index < 0 or index >= n:
                raise IndexError("batch row index out of range")
            item = slice(index, index + 1)
        elif isinstance(item, slice) and (item.step or 1) < 0:
            # torch slices take no negative step; JAX's (and numpy's) do.
            item = torch.tensor(range(len(self))[item], dtype=torch.long,
                                device=self.words.device)
        return PackedBatch(self.words[item], self.lengths[item])

    # -- ops -----------------------------------------------------------------

    def hamming(self, other: "PackedBatch") -> torch.Tensor:
        """Row-wise hamming distances `[N]` (kernel G); lengths must match
        row-wise, as the scalar `^` requires."""
        from .ops.hamming import hamming_rows

        if bool((self.lengths != other.lengths).any()):
            from .constants import LENGTH_MISMATCH_MSG

            raise Exception(LENGTH_MISMATCH_MSG)
        return hamming_rows(self.words, other.words)

    def pairwise(self, other: "PackedBatch | None" = None) -> torch.Tensor:
        """All-pairs hamming `[N, M]` by the calibrated formulation
        (ops.pairwise_hamming_auto)."""
        from .ops.pairwise import pairwise_hamming_auto

        other = self if other is None else other
        return pairwise_hamming_auto(self.words, other.words)

    def trim(self, start: int, length: int) -> "PackedBatch":
        """Batched subsequence: rows become seq[start:start+length]
        (clamped per row), e.g. adapter or UMI clipping."""
        if start < 0 or length < 0:
            raise ValueError("trim start/length must be non-negative")
        out_width = lanes_for_length(min(length, self.width_lanes * 16))
        words, lengths = trim_words(self.words, self.lengths, int(start),
                                    int(length), max(out_width, 1))
        return PackedBatch(words, lengths)

    def trim_ragged(self, starts, lengths,
                    out_width_lanes: int | None = None) -> "PackedBatch":
        """Batched subsequence with a start and length per row: row i
        becomes seq[starts[i] : starts[i] + lengths[i]] (clamped per row;
        negative starts clamp to 0).  Ints serve every row (kernel F
        takes them as scalars).  out_width_lanes bounds the output lane
        count (default: this batch's width; rows keep at most
        16 * out_width nt)."""
        n = len(self)
        dev = self.words.device

        def per_row(v):
            if isinstance(v, (int, np.integer)):
                return int(v)
            return torch.as_tensor(v, dtype=torch.int32, device=dev) \
                .broadcast_to((n,)).contiguous()

        out_w = (self.width_lanes if out_width_lanes is None
                 else int(out_width_lanes))
        if out_w < 1:
            raise ValueError("out_width_lanes must be >= 1")
        words, new_len = trim_words_ragged(self.words, self.lengths,
                                           per_row(starts), per_row(lengths),
                                           out_w)
        return PackedBatch(words, new_len)

    def counts(self):
        """Exact dedup of this batch -> ShortSeqCounter (kernels S and D
        on the batch's device, count/device.py)."""
        from .api.counter import ShortSeqCounter, table_to_counter
        from .count.device import count_batch

        if len(self) == 0:
            return ShortSeqCounter()
        return table_to_counter(count_batch(self.words, self.lengths))

    # -- materialization -----------------------------------------------------

    def decode(self) -> list:
        """Batched decode -> list of str: kernel E on the device, one
        copy to the host, then one str per row."""
        from .ops.bitpack import unpack_ascii

        if len(self) == 0:
            return []
        ascii_mat = unpack_ascii(self.words).cpu().numpy()
        return _rows_to_str(ascii_mat, self.lengths.cpu().numpy())

    def to_objects(self) -> list:
        """ShortSeq objects straight from the packed words: one native
        call for the batch when the object extension is built, the
        pure-Python objects otherwise; no re-encoding either way."""
        words = np.ascontiguousarray(self.words.cpu().numpy().view(np.uint32))
        lengths = np.ascontiguousarray(self.lengths.cpu().numpy(), np.int32)
        native = _build.load_objects()
        if native is not None and hasattr(native, "seqs_from_rows"):
            return native.seqs_from_rows(words, lengths)
        from .api import from_blocks
        from .count.device import _rows_to_table

        table = _rows_to_table(words, lengths, np.zeros(len(self), np.int32))
        return [from_blocks(blocks, length) for (length, blocks), _ in table]


def pack_batch(seqs, width: int | None = None, device="cuda") -> PackedBatch:
    """Convenience: PackedBatch.from_seqs."""
    return PackedBatch.from_seqs(seqs, width, device)
