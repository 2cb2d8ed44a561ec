// Kernel S: the stable row sort of shortseq_torch's unique_count, an LSD
// radix sort over 8-bit digits.
//
// Replaces the sorts inside shortseq_tpu/count/device.py unique_count:
// _sort_rows_lex's multi-operand lax.sort over (length, lane_0 ..
// lane_{W-1}) (:57, rows of at most 6 lanes) and _sort_rows_hash's
// lax.sort over (h1, h2, length, iota) (:132, wider rows).  Built with the
// other sources of this directory into one shared library with a plain C
// interface (shortseq_torch/_build.py) and bound with ctypes; the entry
// point launches on the stream it is given, allocates nothing, reads
// nothing back to the host, and returns the first CUDA error of its
// launches.
//
// What it computes: a permutation of rows 0..N-1 that orders them by a
// list of key columns, least significant column first, ties kept in
// input order.  Only the digits that vary take a pass: a digit holding
// one value over all rows is left out (a stable sort by a constant digit
// is the identity).  The columns:
//   lane j    words[:, j] as unsigned, or lanes j and j + 1 as one
//             unsigned 64-bit key (a pair);
//   length    int32, with bit 31 flipped (its signed order as unsigned),
//             or, when no live length exceeds 2046 (reads are at most
//             1024 nt), mapped to an 11-bit key with PAD_LENGTH as 2047:
//             the same order in 2 digits, of which a batch of reads
//             shorter than 256 nt and no PAD row varies in one;
//   hash key  kernel I's int64 ((int32)(h1 ^ 2^31)) << 32 | h2 with bit 63
//             flipped back, so its unsigned order is (h1, h2).
// The key path (W <= 6) sorts by the lane pairs (W-2, W-1) .. (0, 1) (for
// odd W the pairs end at lane 1, then lane 0 alone), then the length; the
// hash path sorts each hash family's keys, the first family after the
// lengths (one histogram launch for both) and the rest from that length
// order, and writes the keys in sorted order (s_hash) beside the
// permutation.
//
// What bounds it on the H100: HBM bytes.  Read once and written once,
// the function moves 12 bytes of key a row at [10M,2] and 8 of
// permutation, 200 MB, 0.06 ms at 3.35 TB/s.  A radix sort moves the rows
// once a pass: its pass model at [10M,2] (8 lane digits as one 64-bit
// pair and one length digit) is 8 x 24 + 16 bytes a row, 2.08 GB, 0.62
// ms, plus the random 32-byte sectors of each column's first gather
// through the order so far.  So passes are few and narrow: digits that do
// not vary are skipped, row indices are 32-bit (N < 2^31, as kernel D
// requires), each column is gathered into the current order once, in its
// first pass, and its later passes carry (value, index) pairs; two
// adjacent lanes sort as one 64-bit column, so one random gather serves
// both.  Only the last pass writes the int64 permutation that D reads.
//
// The launches of one call (ssq_sort), queued back to back with no host
// read between them:
//   memset      the scratch: tile counters, the pass table, the
//               histograms and the look-back states, zeroed at once.
//   sort_hist   every digit's 256-bin histogram of every column, over
//               all rows: 4 consecutive rows a thread a step, the lanes
//               of those rows, their lengths and keys each loaded as
//               16-byte vectors where aligned, counted in shared memory
//               (a warp whose rows share a digit adds once), then global
//               atomics.  The length's digits are those of the mapped
//               length and of the int32 length both (its low byte is the
//               mapped length's, so that histogram is copied), and a flag
//               says whether a live length exceeds 2046.
//   sort_plan   one block turns the histograms into the pass table: for
//               each candidate digit (which the host knows from W and the
//               path) whether it varies (the mapped length's digits only
//               without the flag, the int32 length's only with it), its
//               pass number k among the varying digits (it reads half
//               (k - 1) % 2 of the ping-pong buffers, or the sort's input
//               order when k = 0, and writes half k % 2), whether it is
//               its column's first varying digit (so it gathers the column
//               through the order so far), and its output: carried keys
//               and indices, indices only (the next varying digit is
//               another column's), or the sort's result (the int64
//               permutation and s_hash, or a fixed int32 order for the
//               length sort of the hash path).  When no digit varies, the
//               sort's last candidate copies the input order to the
//               result instead: the identity, without a host branch.
//   sort_pass   one launch a candidate digit, in order; a launch whose
//               table entry says the digit is constant returns at once,
//               and the rest read their pass number, gather flag and
//               output from the table (uniform branches: the host cannot
//               pick template instances for choices made on the card).
//               Persistent: as many blocks as the card holds (2 an SM;
//               ssq_sort_resident_blocks), each reading its table entry
//               once and then taking tile ids of kTileRows rows from the
//               pass's atomic counter in a loop.  Per tile the onesweep
//               pattern: each thread loads its 16 rows' keys and indices
//               straight into registers, all loads in flight at once;
//               each warp ranks its rows 32 at a time in input order (one
//               vote when the 32 share a digit, else 9 ballots); a thread
//               a bin scans the warps' counts, takes the digit's global
//               start from the histogram and publishes the tile's count
//               at once; the tile is staged in digit order in shared
//               memory; the thread finds the bin's rows in the tiles
//               before by a single-pass decoupled look-back (16 states
//               loaded at once; 64-bit states, since a count can reach N,
//               tagged with the candidate's slot + 1, so a skipped slot
//               leaves no states and one zeroed array serves every pass
//               of a call); and the tile is written out in digit order.
//
// Why the look-back cannot deadlock: a block waits only on tiles below
// the one it holds, and takes its next tile only after it has written
// this one out.  The lowest tile whose count is not yet published is
// held by a running block, and a block publishes its tile's count before
// it waits on anything; so that count gets published, and so does every
// tile's.  A tile id past the end ends the block's loop.
//
// Tried on the H100 and not kept (chip_smoke.py kernel_s and s_against;
// PERF.md): taking the next tile as soon as the current one is
// loaded and copying it into a second shared-memory buffer by
// cp.async.bulk on an mbarrier (a gathering pass's keys by cp.async)
// during the current tile's ranks, scan and look-back; the same with the
// copy started after the tile's count is published, after its staging
// or after its write-out, by 16-byte cp.async of every thread, or into
// one buffer; one block a tile; 2048-row tiles at small N.  None was
// faster than these plain loads: two resident blocks an SM already
// overlap one block's loads with the other's work, a pass's time goes to
// the look-back and to each tile's chain of steps, and a round trip
// through shared memory cost more than it hid.
//
// Measured on the H100: chip_smoke.py kernel_s and s_against; PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPadLength = 0x7FFFFFFF;
constexpr uint32_t kMappedPad = 2047;   // PAD_LENGTH under the length map
constexpr uint32_t kMappedMax = 2046;   // the largest live length it maps
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kTop = 1ull << 63;

constexpr int kBins = 256;
constexpr int kThreads = 256;           // one thread a bin in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;              // rows a thread holds
constexpr int kTileRows = kThreads * kItems;
constexpr int kWarpRows = kTileRows / kWarps;
constexpr int kLookback = 16;           // look-back states loaded at once
constexpr int kPassBlocks = 2;          // blocks an SM holds (registers)

constexpr int kMaxLanes = 64;           // reads of up to 1024 nt
constexpr int kMaxCands = 8 * (kMaxLanes / 2) + 6;  // candidates a sort

constexpr int kHistThreads = 512;
constexpr int kHistRows = 4;            // consecutive rows a thread counts
constexpr int kHistLanes = 8;           // lanes a histogram launch covers
constexpr int kOtherDigits = 14;        // length 4 + mapped 2 + hash key 8

// Plan columns (count/device.py _LEN_FULL, _LEN_MAPPED, _HASH_KEY, _PAIR):
// a lane is its index j >= 0, and kPair + j the lanes j and j + 1 as one
// 64-bit key, lane j the high half.
constexpr int kPair = 1 << 16;
constexpr int kLenFull = -1;
constexpr int kLenMapped = -2;
constexpr int kHashKey = -3;

// The sorts of a call (count/device.py _sort_columns), each with its
// candidate digits, least significant first.
constexpr int kSortKeyPath = 0;         // the lane columns, then the length
constexpr int kSortLength = 1;          // the length alone
constexpr int kSortHashKey = 2;         // the hash key alone
// What a call sorts (ssq_sort's `part`; count/device.py _KEY_PATH,
// _HASH_FIRST, _HASH_NEXT).
constexpr int kCallKeyPath = 0;         // words and lengths -> perm
constexpr int kCallHashFirst = 1;       // lengths -> order; keys -> perm
constexpr int kCallHashNext = 2;        // keys from an order -> perm

// A pass table entry (int4): mode, k, gather, out.
constexpr int kSkip = 0;                // the digit is constant
constexpr int kPass = 1;
constexpr int kCopy = 2;                // no digit varies: copy the order
constexpr int kCarry = 0;               // keys and indices to half k % 2
constexpr int kIndices = 1;             // indices only
constexpr int kResult = 2;              // the sort's result

// A look-back state: status in the top two bits, the slot's epoch in the
// next 30, a count of rows in the low 32.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned kEpochMask = (1u << 30) - 1;

struct Cand {
  int col;
  int shift;
};

__host__ __device__ __forceinline__ int cand_count(int sort, int w) {
  if (sort == kSortHashKey) return 8;
  if (sort == kSortLength) return 6;
  return 8 * (w / 2) + 4 * (w % 2) + 6;
}

// Candidate c of a sort: the key path's lane pairs (8 digits each), lane
// 0 alone for odd W (4), then the length: the mapped length's 2 digits
// and the int32 length's 4 (count/device.py _candidates).
__host__ __device__ __forceinline__ Cand cand_at(int sort, int w, int c) {
  if (sort == kSortHashKey) return {kHashKey, 8 * c};
  if (sort == kSortKeyPath) {
    const int pair_digits = 8 * (w / 2);
    if (c < pair_digits) return {kPair + w - 2 - 2 * (c / 8), 8 * (c % 8)};
    if (c < pair_digits + 4 * (w % 2)) return {0, 8 * (c - pair_digits)};
    c -= pair_digits + 4 * (w % 2);
  }
  return c < 2 ? Cand{kLenMapped, 8 * c} : Cand{kLenFull, 8 * (c - 2)};
}

// A digit's slot in the histograms: 4 a lane, then the length's 4, its 2
// under the map, and the hash key's 8 (count/device.py _digit_slot).
__host__ __device__ __forceinline__ int digit_slot(int col, int shift,
                                                   int w) {
  const int byte = shift >> 3;
  if (col >= kPair) return 4 * (col - kPair) + (byte < 4 ? 4 + byte : byte - 4);
  if (col >= 0) return 4 * col + byte;
  return 4 * w + (col == kLenFull ? 0 : col == kLenMapped ? 4 : 6) + byte;
}

__host__ __device__ __forceinline__ bool wide_column(int col) {
  return col >= kPair || col == kHashKey;
}

__device__ __forceinline__ uint32_t mapped_length(int32_t len) {
  return len == kPadLength ? kMappedPad : (uint32_t)len;
}

// ---------------------------------------------------------------------------
// Histograms.
// ---------------------------------------------------------------------------

// Adds one row's digit to a 256-bin shared histogram for every valid lane
// of the warp; when the valid lanes share the digit, one lane adds their
// count (constant digits are common: the high bytes of a length).
__device__ __forceinline__ void hist_add(uint32_t* bins, uint32_t byte,
                                         bool valid, unsigned vmask,
                                         int lane) {
  const int first = __ffs(vmask) - 1;
  const uint32_t b0 = __shfl_sync(kFull, byte, first);
  if (__all_sync(kFull, !valid || byte == b0)) {
    if (lane == first) atomicAdd(bins + b0, (uint32_t)__popc(vmask));
  } else if (valid) {
    atomicAdd(bins + byte, 1u);
  }
}

// Lanes [j0, j0 + L) of words (L = 0: none), the length (when given) and
// the hash key (when given) of every row, into hist: (4 W + 14) x 256
// uint32 bins, then the flag word.  A thread counts rows 4q .. 4q + 3 a
// step; `vec` bit 0: the words are 16-byte aligned and W = L, so the 4
// rows' lanes are W 16-byte vectors; bit 1: the lengths are aligned (one
// vector); bit 2: the keys are (two).
template <int L>
__global__ void __launch_bounds__(kHistThreads)
    sort_hist_kernel(const uint32_t* __restrict__ words, int w, int j0,
                     const int32_t* __restrict__ lengths,
                     const unsigned long long* __restrict__ keys, int64_t n,
                     int vec, uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t s_hist[];
  constexpr int kLocal = (4 * L + kOtherDigits) * kBins;
  for (int i = threadIdx.x; i < kLocal; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  uint32_t* s_other = s_hist + 4 * L * kBins;
  const int lane = threadIdx.x & 31;
  int big = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x;
       base * kHistRows < n; base += stride) {
    const int64_t row0 = (base + threadIdx.x) * kHistRows;
    const bool whole = row0 + kHistRows <= n;
    bool valid[kHistRows];
    unsigned vmask[kHistRows];
#pragma unroll
    for (int r = 0; r < kHistRows; ++r) {
      valid[r] = row0 + r < n;
      vmask[r] = __ballot_sync(kFull, valid[r]);
    }
    if (L > 0) {
      // flat[r * L + j]: lane j0 + j of row row0 + r.
      uint32_t flat[kHistRows * (L > 0 ? L : 1)];
      if ((vec & 1) && whole) {
        const uint4* p = reinterpret_cast<const uint4*>(words + row0 * L);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const uint4 x = __ldg(p + i);
          flat[4 * i] = x.x;
          flat[4 * i + 1] = x.y;
          flat[4 * i + 2] = x.z;
          flat[4 * i + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kHistRows; ++r)
#pragma unroll
          for (int j = 0; j < L; ++j)
            flat[r * L + j] =
                valid[r] ? __ldg(words + (row0 + r) * w + j0 + j) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        if (vmask[r] == 0) continue;
#pragma unroll
        for (int j = 0; j < L; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            hist_add(s_hist + (4 * j + k) * kBins,
                     (flat[r * L + j] >> (8 * k)) & 0xFF, valid[r], vmask[r],
                     lane);
      }
    }
    if (lengths != nullptr) {
      int32_t len[kHistRows];
      if ((vec & 2) && whole) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(lengths + row0));
        len[0] = x.x;
        len[1] = x.y;
        len[2] = x.z;
        len[3] = x.w;
      } else {
#pragma unroll
        for (int r = 0; r < kHistRows; ++r)
          len[r] = valid[r] ? __ldg(lengths + row0 + r) : 0;
      }
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        if (vmask[r] == 0) continue;
        const uint32_t mapped = mapped_length(len[r]);
        const uint32_t full = (uint32_t)len[r] ^ 0x80000000u;
        big |= valid[r] && len[r] != kPadLength &&
               (uint32_t)len[r] > kMappedMax;
#pragma unroll
        for (int k = 0; k < 2; ++k)
          hist_add(s_other + (4 + k) * kBins, (mapped >> (8 * k)) & 0xFF,
                   valid[r], vmask[r], lane);
        // The int32 length's low byte is the mapped length's (PAD's is
        // 0xFF in both): its bins are copied below.
#pragma unroll
        for (int k = 1; k < 4; ++k)
          hist_add(s_other + k * kBins, (full >> (8 * k)) & 0xFF, valid[r],
                   vmask[r], lane);
      }
    }
    if (keys != nullptr) {
      unsigned long long key[kHistRows];
      if ((vec & 4) && whole) {
        const ulonglong2* p = reinterpret_cast<const ulonglong2*>(keys + row0);
        const ulonglong2 x = __ldg(p), y = __ldg(p + 1);
        key[0] = x.x;
        key[1] = x.y;
        key[2] = y.x;
        key[3] = y.y;
      } else {
#pragma unroll
        for (int r = 0; r < kHistRows; ++r)
          key[r] = valid[r] ? __ldg(keys + row0 + r) : 0ull;
      }
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        if (vmask[r] == 0) continue;
        const unsigned long long k64 = key[r] ^ kTop;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          hist_add(s_other + (6 + k) * kBins,
                   (uint32_t)(k64 >> (8 * k)) & 0xFF, valid[r], vmask[r],
                   lane);
      }
    }
  }
  big = __syncthreads_or(big);
  for (int i = threadIdx.x; i < kLocal; i += blockDim.x) {
    const uint32_t c = s_hist[i];
    if (c == 0) continue;
    const int d = i / kBins;
    const int slot = d < 4 * L ? 4 * j0 + d : 4 * w + (d - 4 * L);
    atomicAdd(hist + slot * kBins + (i % kBins), c);
    if (d == 4 * L + 4)  // the mapped length's low byte: the int32's too
      atomicAdd(hist + 4 * w * kBins + (i % kBins), c);
  }
  if (threadIdx.x == 0 && big)
    atomicOr(hist + (4 * w + kOtherDigits) * kBins, 1u);
}

// ---------------------------------------------------------------------------
// The plan.
// ---------------------------------------------------------------------------

// One block of kBins threads: the pass table of the sorts `sort0` and
// `sort1` (-1: none) of a call, their candidates one after the other
// (count/device.py _sort_table_plain is its plain version).  A warp a
// candidate counts its non-empty bins; then thread 0 walks the
// candidates backwards (each varying digit's output) and forwards (its
// pass number and gather flag), writing each entry once.
__global__ void __launch_bounds__(kBins)
    sort_plan_kernel(const uint32_t* __restrict__ hist, int w, int sort0,
                     int sort1, int4* __restrict__ table) {
  __shared__ unsigned char s_var[kMaxCands];
  __shared__ unsigned char s_out[kMaxCands];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool big = hist[(4 * w + kOtherDigits) * kBins] != 0;
  int base = 0;
  for (int s = 0; s < 2; ++s) {
    const int sort = s == 0 ? sort0 : sort1;
    if (sort < 0) break;
    const int count = cand_count(sort, w);
    // Which candidates vary: more than one non-empty bin.
    for (int c = tid >> 5; c < count; c += kWarps) {
      const Cand d = cand_at(sort, w, c);
      const uint32_t* bins = hist + digit_slot(d.col, d.shift, w) * kBins;
      int nonzero = 0;
#pragma unroll
      for (int i = 0; i < kBins / 32; ++i)
        nonzero += __popc(__ballot_sync(kFull, bins[32 * i + lane] != 0));
      if (lane == 0)
        s_var[c] = nonzero > 1 && !(d.col == kLenMapped && big) &&
                   !(d.col == kLenFull && !big);
    }
    __syncthreads();
    if (tid == 0) {
      int next = 0;
      bool any = false;
      for (int c = count - 1; c >= 0; --c) {
        if (!s_var[c]) continue;
        const int col = cand_at(sort, w, c).col;
        s_out[c] = !any ? kResult : col != next ? kIndices : kCarry;
        next = col;
        any = true;
      }
      int k = 0, prev = 0;
      for (int c = 0; c < count; ++c) {
        int4 e = make_int4(kSkip, 0, 0, 0);
        if (s_var[c]) {
          const int col = cand_at(sort, w, c).col;
          e = make_int4(kPass, k, k == 0 || col != prev, s_out[c]);
          prev = col;
          ++k;
        }
        if (!any && c == count - 1) e.x = kCopy;
        table[base + c] = e;
      }
    }
    base += count;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Digit passes.
// ---------------------------------------------------------------------------

// One candidate's launch: its column (`col`: a lane or a pair, words + j
// with stride W; the lengths; the hash keys), its digit, the sort's input
// order and result, the ping-pong halves, and its table entry.
struct PassArgs {
  const void* col;
  int64_t stride;
  int kind;  // the column: a lane, a pair, kLenFull, kLenMapped, kHashKey
  int shift;
  const int32_t* idx_in;      // the sort's input order; null: 0 .. N-1
  void* keys[2];
  int32_t* idx[2];
  long long* perm;            // the result: perm (and s_hash), or
  long long* s_hash;
  int32_t* order;             // the int32 order (the hash path's lengths)
  const uint32_t* hist;       // this digit's 256 bins
  const int4* step;           // this candidate's table entry
  unsigned long long* states;
  unsigned long long* counter;
  int64_t n;
  int tiles;
  uint32_t epoch;
};

// Row src's key of a gathered column, as the pass sorts it: a lane or a
// pair as it is, the length as int32 with bit 31 flipped or mapped, the
// hash key with bit 63 flipped back.
template <typename K>
__device__ __forceinline__ K gather_key(const PassArgs& a, int64_t src);

template <>
__device__ __forceinline__ uint32_t gather_key<uint32_t>(const PassArgs& a,
                                                         int64_t src) {
  if (a.kind >= 0)
    return __ldg(static_cast<const uint32_t*>(a.col) + src * a.stride);
  const int32_t len = __ldg(static_cast<const int32_t*>(a.col) + src);
  return a.kind == kLenFull ? (uint32_t)len ^ 0x80000000u : mapped_length(len);
}

template <>
__device__ __forceinline__ unsigned long long gather_key<unsigned long long>(
    const PassArgs& a, int64_t src) {
  if (a.kind == kHashKey)
    return __ldg(static_cast<const unsigned long long*>(a.col) + src) ^ kTop;
  // A pair: two 4-byte loads (a row of odd W leaves it off 8 bytes), in one
  // 32-byte sector unless the row crosses one.
  const uint32_t* lane = static_cast<const uint32_t*>(a.col) + src * a.stride;
  return (unsigned long long)__ldg(lane) << 32 | __ldg(lane + 1);
}

// The lanes of the warp whose b (a digit, or kBins for no row) equals
// this lane's: all of them when one vote says the warp holds one value
// (runs of equal keys, as skewed reads give once a pass has grouped
// them), else one ballot a bit of b, which costs less than
// __match_any_sync when the 32 lanes hold many values.
__device__ __forceinline__ unsigned match_digit(uint32_t b) {
  if (__all_sync(kFull, b == __shfl_sync(kFull, b, 0))) return kFull;
  unsigned peers = kFull;
#pragma unroll
  for (int bit = 0; bit < 9; ++bit) {
    const unsigned m = __ballot_sync(kFull, (b >> bit) & 1u);
    peers &= ((b >> bit) & 1u) ? m : ~m;
  }
  return peers;
}

template <typename K>
__device__ __forceinline__ uint32_t digit_of(K key, int shift) {
  return (uint32_t)(key >> shift) & 0xFF;
}

// Run by the thread of bin b after it published this tile's count of
// the bin: sums the counts of the tiles before it, nearest first, until
// one carries an inclusive prefix, kLookback states loaded at once (a
// tile whose predecessors are all still in flight walks back over as
// many tiles as run at once, and one load at a time would cost an L2
// round trip a tile), then publishes its own prefix.  Returns the bin's
// rows in the tiles before this one.
__device__ uint32_t bin_prefix(unsigned long long* states, int tile, int b,
                               uint32_t count, uint32_t epoch) {
  volatile unsigned long long* vs = states;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  uint32_t before = 0;
  for (int top = tile - 1; top >= 0; top -= kLookback) {
    unsigned long long s[kLookback];
#pragma unroll
    for (int i = 0; i < kLookback; ++i)
      s[i] = top - i >= 0 ? vs[(int64_t)(top - i) * kBins + b]
                          : kPrefix | tag;  // before tile 0: an empty prefix
    bool done = false;
#pragma unroll
    for (int i = 0; i < kLookback; ++i) {
      if (done) break;
      while (((uint32_t)(s[i] >> 32) & kEpochMask) != epoch) {
        __nanosleep(32);
        s[i] = vs[(int64_t)(top - i) * kBins + b];
      }
      before += (uint32_t)s[i];
      done = (s[i] >> 62) == 2;
    }
    if (done) break;
  }
  vs[(int64_t)tile * kBins + b] = kPrefix | tag | (before + count);
  return before;
}

// No digit of the sort varies: its result is its input order.
template <typename K>
__device__ void copy_order(const PassArgs& a) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t id = a.idx_in != nullptr ? a.idx_in[i] : (int32_t)i;
    if (a.perm == nullptr) {
      a.order[i] = id;
      continue;
    }
    a.perm[i] = id;
    if (sizeof(K) == 8 && a.s_hash != nullptr)
      a.s_hash[i] = static_cast<const long long*>(a.col)[id];
  }
}

// One candidate digit (see the header): each block loops over tiles.
template <typename K>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
    sort_pass_kernel(const PassArgs a) {
  const int4 st = *a.step;
  if (st.x == kSkip) return;
  if (st.x == kCopy) {
    copy_order<K>(a);
    return;
  }
  const int k = st.y;
  const bool gather = st.z != 0;
  const int out = st.w;
  // Halves by select, not by a runtime index into the parameter arrays
  // (which would copy them to local memory).
  const bool odd = k & 1;
  const int32_t* idx_in = k == 0 ? a.idx_in : odd ? a.idx[0] : a.idx[1];
  const K* keys_in = static_cast<const K*>(odd ? a.keys[0] : a.keys[1]);
  K* keys_out = static_cast<K*>(odd ? a.keys[1] : a.keys[0]);
  int32_t* idx_out = odd ? a.idx[1] : a.idx[0];

  extern __shared__ __align__(16) unsigned char pass_smem[];
  K* s_key = reinterpret_cast<K*>(pass_smem);
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_key + kTileRows);
  __shared__ uint32_t s_cnt[kWarps][kBins];
  __shared__ long long s_dst[kBins];
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ int s_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const unsigned long long tag = (unsigned long long)a.epoch << 32;
  for (;;) {
    if (tid == 0) s_tile = (int)atomicAdd(a.counter, 1ull);
    for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_cnt[0][0])[i] = 0;
    __syncthreads();
    const int tile = s_tile;
    if (tile >= a.tiles) break;
    const int64_t t0 = (int64_t)tile * kTileRows;
    const int rows = (int)min((int64_t)kTileRows, a.n - t0);

    // 1. Item i of a thread is row warp * kWarpRows + 32 i + lane of the
    // tile: each load of a warp is 32 consecutive rows, and every load of a
    // thread is issued before any is used.
    K key[kItems];
    int32_t idx[kItems];
    if (gather) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = warp * kWarpRows + i * 32 + lane;
        key[i] = 0;
        idx[i] = 0;
        if (r < rows)
          idx[i] = idx_in != nullptr ? __ldcs(idx_in + t0 + r)
                                     : (int32_t)(t0 + r);
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (warp * kWarpRows + i * 32 + lane < rows)
          key[i] = gather_key<K>(a, idx[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = warp * kWarpRows + i * 32 + lane;
        key[i] = 0;
        idx[i] = 0;
        if (r < rows) {
          idx[i] = __ldcs(idx_in + t0 + r);
          key[i] = __ldcs(keys_in + t0 + r);
        }
      }
    }

    // 2. Each row's rank among the warp's rows of its digit, in row order.
    uint32_t rank[kItems];
    volatile uint32_t* cnt = s_cnt[warp];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool valid = warp * kWarpRows + i * 32 + lane < rows;
      const uint32_t d = valid ? digit_of(key[i], a.shift) : kBins;
      const unsigned peers = match_digit(d);
      const int leader = __ffs(peers) - 1;
      uint32_t start = 0;
      if (lane == leader && valid) {
        start = cnt[d];
        cnt[d] = start + __popc(peers);
      }
      start = __shfl_sync(kFull, start, leader);
      rank[i] = start + __popc(peers & below);
      __syncwarp();
    }
    __syncthreads();

    // 3. Thread b: the tile's count of bin b, published at once for the
    // tiles after this one (a bin no row of the input holds needs no
    // look-back); the warps' offsets in the bin; the bin's start in the
    // tile and in the whole output, by one scan of the global histogram in
    // the high half and the tile's counts in the low half (their sum is at
    // most kTileRows, so nothing carries).
    const int b = tid;
    const uint32_t global = __ldg(a.hist + b);
    uint32_t tot = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c = s_cnt[v][b];
      s_cnt[v][b] = tot;
      tot += c;
    }
    if (global != 0)
      reinterpret_cast<volatile unsigned long long*>(
          a.states)[(int64_t)tile * kBins + b] =
          (tile == 0 ? kPrefix : kAggregate) | tag | tot;
    const unsigned long long v = ((unsigned long long)global << 32) | tot;
    unsigned long long incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned long long excl = incl - v;
    for (int u = 0; u < warp; ++u) excl += s_warp[u];
    const uint32_t bin_start = (uint32_t)excl;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) s_cnt[u][b] += bin_start;
    __syncthreads();

    // 4. Stage the tile in digit order, freeing the registers, then the
    // look-back: staged row i of digit d goes to s_dst[d] + i.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (warp * kWarpRows + i * 32 + lane < rows) {
        const uint32_t p = s_cnt[warp][digit_of(key[i], a.shift)] + rank[i];
        s_key[p] = key[i];
        s_idx[p] = idx[i];
      }
    }
    const uint32_t before = global == 0 || tile == 0
                                ? 0u
                                : bin_prefix(a.states, tile, b, tot, a.epoch);
    s_dst[b] = (long long)(excl >> 32) + before - bin_start;
    __syncthreads();

    // 5. Written out in digit order, consecutive threads storing
    // consecutive addresses of one bin: carried keys and indices to half
    // k % 2, indices only, or the sort's result.
    if (out == kCarry) {
      for (int i = tid; i < rows; i += kThreads) {
        const K kk = s_key[i];
        const long long pos = s_dst[digit_of(kk, a.shift)] + i;
        keys_out[pos] = kk;
        idx_out[pos] = s_idx[i];
      }
    } else if (out == kIndices || a.perm == nullptr) {
      int32_t* dst = out == kIndices ? idx_out : a.order;
      for (int i = tid; i < rows; i += kThreads)
        dst[s_dst[digit_of(s_key[i], a.shift)] + i] = s_idx[i];
    } else {
      for (int i = tid; i < rows; i += kThreads) {
        const K kk = s_key[i];
        const long long pos = s_dst[digit_of(kk, a.shift)] + i;
        a.perm[pos] = s_idx[i];
        if (sizeof(K) == 8 && a.s_hash != nullptr)
          a.s_hash[pos] = (long long)((unsigned long long)kk ^ kTop);
      }
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename K>
constexpr int pass_smem() {
  return kTileRows * (int)(sizeof(K) + sizeof(int32_t));
}

// The pass kernel's dynamic shared memory (above 48 KB with the static
// arrays), opted in once.
template <typename K>
int pass_opt_in() {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_pass_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pass_smem<K>());
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  return 0;
}

// The blocks of the pass the card holds at once (0 on an error).
template <typename K>
int pass_resident() {
  static int resident = 0;
  int per_sm = 0;
  if (resident == 0 && pass_opt_in<K>() == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sort_pass_kernel<K>, kThreads, pass_smem<K>()) ==
          cudaSuccess)
    resident = per_sm * sm_count();
  return resident;
}

template <typename K>
int launch_pass(const PassArgs& a, cudaStream_t stream) {
  const int resident = pass_resident<K>();
  if (resident <= 0) {
    const int err = pass_opt_in<K>();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  sort_pass_kernel<K><<<(unsigned)min(a.tiles, resident), kThreads,
                        pass_smem<K>(), stream>>>(a);
  return (int)cudaGetLastError();
}

template <int L>
int launch_hist(const uint32_t* words, int w, int j0, const int32_t* lengths,
                const unsigned long long* keys, int64_t n, int vec,
                uint32_t* hist, cudaStream_t s) {
  const int64_t per_step = (int64_t)kHistThreads * kHistRows;
  const int64_t want = (n + per_step - 1) / per_step;
  const unsigned blocks = (unsigned)min(want, (int64_t)(4 * sm_count()));
  const size_t smem = (size_t)(4 * L + kOtherDigits) * kBins * sizeof(uint32_t);
  sort_hist_kernel<L><<<blocks, kHistThreads, smem, s>>>(
      words, w, j0, lengths, keys, n, vec, hist);
  return (int)cudaGetLastError();
}

int hist_launches(const uint32_t* words, int w, const int32_t* lengths,
                  const unsigned long long* keys, int64_t n, uint32_t* hist,
                  cudaStream_t s) {
  const auto aligned = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  const int groups = words != nullptr && w > 0
                         ? (w + kHistLanes - 1) / kHistLanes
                         : 1;
  for (int g = 0; g < groups; ++g) {
    const int j0 = g * kHistLanes;
    const int lanes = words != nullptr ? min(w - j0, kHistLanes) : 0;
    const int32_t* lens = g == 0 ? lengths : nullptr;
    const unsigned long long* ks = g == 0 ? keys : nullptr;
    const int vec = (lanes == w && aligned(words) ? 1 : 0) |
                    (aligned(lens) ? 2 : 0) | (aligned(ks) ? 4 : 0);
    int err;
    switch (lanes) {
#define SSQ_HIST_CASE(L)                                             \
  case L:                                                            \
    err = launch_hist<L>(words, w, j0, lens, ks, n, vec, hist, s); \
    break;
      SSQ_HIST_CASE(0)
      SSQ_HIST_CASE(1)
      SSQ_HIST_CASE(2)
      SSQ_HIST_CASE(3)
      SSQ_HIST_CASE(4)
      SSQ_HIST_CASE(5)
      SSQ_HIST_CASE(6)
      SSQ_HIST_CASE(7)
      default:
        err = launch_hist<8>(words, w, j0, lens, ks, n, vec, hist, s);
#undef SSQ_HIST_CASE
    }
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Rows a tile of the digit passes holds (count/device.py SORT_TILE_ROWS).
int ssq_sort_tile_rows() { return kTileRows; }

// Blocks of the digit pass the card holds at once, with 8-byte keys
// (wide) or 4-byte ones; 0 on an error.
int ssq_sort_resident_blocks(int wide) {
  return wide ? pass_resident<unsigned long long>() : pass_resident<uint32_t>();
}

// One sort call.  part: 0 the key path (words [N, W <= 64] and lengths [N] ->
// perm), 1 the hash path's first family (lengths -> the int32 length
// order `order`; then keys [N] from that order -> perm, s_hash), 2 a
// later family (keys from idx_in, int32 [N] or null for the input order
// -> perm, s_hash).  scratch (int64 words, zeroed here): [C tile
// counters, rounded up to even][C table entries of 16 bytes][(4 W + 14) *
// 256 + 1 int32 histograms, rounded up to 8 bytes][tiles * 256 look-back
// states], C the call's candidate digits, tiles = ceil(N / kTileRows);
// key_buf: 2 N keys (8 bytes each when the call has a pair or the hash
// key, else 4); idx_buf: int32 [2 N].  Queues the memset, the histogram
// launch(es), the plan launch and one pass launch a candidate; reads
// nothing back.
int ssq_sort(const void* words, int w, const void* lengths, const void* keys,
             const void* idx_in, int part, void* scratch, void* key_buf,
             void* idx_buf, void* perm, void* s_hash, void* order, int64_t n,
             void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int sorts[2] = {-1, -1};
  if (part == kCallKeyPath) {
    sorts[0] = kSortKeyPath;
  } else if (part == kCallHashFirst) {
    sorts[0] = kSortLength;
    sorts[1] = kSortHashKey;
  } else if (part == kCallHashNext) {
    sorts[0] = kSortHashKey;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (part != kCallKeyPath) w = 0;
  if (w > kMaxLanes) return (int)cudaErrorInvalidValue;
  int cands = 0;
  for (int i = 0; i < 2 && sorts[i] >= 0; ++i) cands += cand_count(sorts[i], w);
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t hist_words = ((4 * w + kOtherDigits) * kBins + 2) / 2;
  const int64_t counter_words = (cands + 1) & ~1;  // the table: 16 bytes
  unsigned long long* counters = (unsigned long long*)scratch;
  int4* table = (int4*)(counters + counter_words);
  uint32_t* hist = (uint32_t*)(counters + counter_words + 2 * cands);
  unsigned long long* states =
      counters + counter_words + 2 * cands + hist_words;
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0,
      (size_t)(counter_words + 2 * cands + hist_words + tiles * kBins) * 8,
      s);
  if (e != cudaSuccess) return (int)e;
  int err = hist_launches((const uint32_t*)words, w, (const int32_t*)lengths,
                          (const unsigned long long*)keys, n, hist, s);
  if (err != 0) return err;
  sort_plan_kernel<<<1, kBins, 0, s>>>(hist, w, sorts[0], sorts[1], table);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  const bool wide = part != kCallKeyPath || w >= 2;
  const int64_t key_bytes = wide ? 8 : 4;
  int slot = 0;
  for (int i = 0; i < 2 && sorts[i] >= 0; ++i) {
    const bool result = i == 1 || sorts[1] < 0;  // perm: the call's last
    for (int c = 0; c < cand_count(sorts[i], w); ++c, ++slot) {
      const Cand d = cand_at(sorts[i], w, c);
      PassArgs a;
      if (d.col >= 0) {
        a.col = (const uint32_t*)words +
                (d.col >= kPair ? d.col - kPair : d.col);
        a.stride = w;
      } else {
        a.col = d.col == kHashKey ? keys : lengths;
        a.stride = 1;
      }
      a.kind = d.col;
      a.shift = d.shift;
      // The hash key's sort after the lengths' starts from their order.
      a.idx_in = (const int32_t*)(i == 0 ? idx_in : order);
      for (int h = 0; h < 2; ++h) {
        a.keys[h] = (char*)key_buf + h * n * key_bytes;
        a.idx[h] = (int32_t*)idx_buf + h * n;
      }
      a.perm = result ? (long long*)perm : nullptr;
      a.s_hash = result ? (long long*)s_hash : nullptr;
      a.order = (int32_t*)order;
      a.hist = hist + digit_slot(d.col, d.shift, w) * kBins;
      a.step = table + slot;
      a.states = states;
      a.counter = counters + slot;
      a.n = n;
      a.tiles = (int)tiles;
      a.epoch = (uint32_t)(slot + 1);
      err = wide_column(d.col) ? launch_pass<unsigned long long>(a, s)
                               : launch_pass<uint32_t>(a, s);
      if (err != 0) return err;
    }
  }
  return 0;
}

}  // extern "C"
