// Kernel S: the stable row sort of shortseq_torch's unique_count, an LSD
// radix sort over 8-bit digits.
//
// Replaces the sorts inside shortseq_tpu/count/device.py unique_count:
// _sort_rows_lex's multi-operand lax.sort over (length, lane_0 ..
// lane_{W-1}) (:57, rows of at most 6 lanes) and _sort_rows_hash's
// lax.sort over (h1, h2, length, iota) (:132, wider rows).  Built with the
// other sources of this directory into one shared library with a plain C
// interface (shortseq_torch/_build.py) and bound with ctypes; the entry
// points launch on the stream they are given, allocate nothing, and
// return the first CUDA error of their launches.
//
// What it computes: a permutation of rows 0..N-1 that orders them by a
// list of key columns, least significant column first, ties kept in
// input order.  The wrapper (count/device.py) reads the histograms and
// makes the plan: the digits to sort by, least significant first, with
// every digit that holds one value over all rows left out (a stable sort
// by a constant digit is the identity).  The columns:
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
// hash path sorts each hash family's keys (_sort_keys), the first family
// after the lengths (one histogram launch for both) and the rest from
// that length order, and writes the keys in sorted order (s_hash) beside
// the permutation.
//
// What bounds it on the H100: HBM bytes.  Read once and written once,
// the function moves 12 bytes of key a row at [10M,2] and 8 of
// permutation, 200 MB, 0.06 ms at 3.35 TB/s.  A radix sort moves the rows
// once a pass.  Its pass model at [10M,2] (8 lane digits and one length
// digit) is about 9 passes x 16 bytes x 10M = 1.44 GB, 0.43 ms, with
// 32-bit columns, plus the random 32-byte sectors of each column's first
// gather through the permutation so far.  So the design keeps passes few
// and narrow: digits that do not vary are skipped, row indices are 32-bit
// (N < 2^31, as kernel D requires), each column is gathered into the
// current order once, in its first pass, and its later passes carry
// (value, index) pairs, 8 bytes a row in and out, or 12 for a 64-bit
// column.  Two adjacent lanes sort as one 64-bit column, so one random
// gather serves both: the pass model at [10M,2] becomes 8 x 24 + 16
// bytes a row, 2.08 GB, 0.62 ms, and a gather less, which costs two to
// three carrying passes.  The hash key is one 64-bit column too.  Only
// the last pass writes the int64 permutation that D reads.
//
// The launches:
//   sort_hist   one launch over all rows (lanes in groups of 8 a launch
//               when W > 8): every digit's 256-bin histogram of every
//               column at once, in shared memory (a warp whose rows share
//               a digit adds once), then global atomics; also a flag when
//               a live length exceeds 2046.  The wrapper copies the
//               histograms to the host (one small copy a call) and plans;
//               only when the flag is set does a second launch count the
//               int32 length's 4 digits.
//   sort_pass   one launch a digit, the onesweep pattern: a block of
//               kThreads threads per tile of kTileRows rows, tile ids from
//               an atomic counter.  Each warp owns kWarpRows consecutive
//               rows and ranks them 32 at a time in input order: lanes of
//               one digit find each other by one vote when the 32 share
//               it, else by 9 ballots (one a bit of the digit, and one for
//               rows past the tile), and the lowest advances the warp's
//               count of that digit in shared memory.
//               A thread a bin then scans the warps' counts, takes the
//               digit's global start from the histogram, and publishes
//               the tile's count of it at once.  The tile's rows are
//               staged in shared memory in digit order; then the thread
//               finds the bin's rows in the tiles before by a single-pass
//               decoupled look-back, 16 states loaded at once (64-bit
//               states: a count can reach N; each pass tags its states
//               with its own epoch, so one zeroed array serves every pass
//               of a call), and the tile is written out in digit order,
//               so consecutive threads store consecutive addresses of one
//               bin.
//
// Measured on the H100 (chip_smoke.py kernel_s; PERF.md): a pass that
// carries pairs takes about twice a copy of the same bytes, a tile
// spending about as long in its ranks, scans and look-back as in moving
// bytes; a column's first pass through the permutation so far gathers 4
// bytes a row from random 32-byte sectors and takes two to three times
// a carrying pass.
//
// Nothing syncs with the host.

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

constexpr int kHistThreads = 512;
constexpr int kHistRows = 4;            // rows a thread counts a step
constexpr int kHistLanes = 8;           // lanes a histogram launch covers
constexpr int kOtherDigits = 14;        // length 4 + mapped 2 + hash key 8

// Plan columns (count/device.py _LEN_FULL, _LEN_MAPPED, _HASH_KEY, _PAIR):
// a lane is its index j >= 0, and kPair + j the lanes j and j + 1 as one
// 64-bit key, lane j the high half.
constexpr int kPair = 1 << 16;
constexpr int kLenFull = -1;
constexpr int kLenMapped = -2;
constexpr int kHashKey = -3;

// A look-back state: status in the top two bits, the pass's epoch in the
// next 30, a count of rows in the low 32.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned kEpochMask = (1u << 30) - 1;

// A digit's slot in the histograms: 4 a lane, then the length's 4, its 2
// under the map, and the hash key's 8 (count/device.py _digit_slot).
__host__ __device__ __forceinline__ int digit_slot(int col, int shift,
                                                   int w) {
  const int byte = shift >> 3;
  if (col >= kPair) return 4 * (col - kPair) + (byte < 4 ? 4 + byte : byte - 4);
  if (col >= 0) return 4 * col + byte;
  return 4 * w + (col == kLenFull ? 0 : col == kLenMapped ? 4 : 6) + byte;
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

// Lanes [j0, j1) of words (when given), the length (when given) and the
// hash key (when given) of every row, into hist: (4 W + 14) x 256 uint32
// bins, then the flag word.  The length's digits: with `full` 0 those of
// the mapped length and the flag, with `full` 1 only the int32 length's
// (the wrapper's second launch, when the flag is set).
__global__ void __launch_bounds__(kHistThreads)
    sort_hist_kernel(const uint32_t* __restrict__ words, int w, int j0,
                     int j1, const int32_t* __restrict__ lengths, int full,
                     const unsigned long long* __restrict__ keys, int64_t n,
                     uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t s_hist[];
  const int lanes = j1 - j0;
  const int local = (4 * lanes + kOtherDigits) * kBins;
  for (int i = threadIdx.x; i < local; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  uint32_t* s_other = s_hist + 4 * lanes * kBins;
  const int lane = threadIdx.x & 31;
  int big = 0;
  // kHistRows rows a thread a step, each column's loads issued before any
  // is counted.
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kHistRows;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x * kHistRows; base < n;
       base += stride) {
    int64_t row[kHistRows];
    bool valid[kHistRows];
    unsigned vmask[kHistRows];
#pragma unroll
    for (int r = 0; r < kHistRows; ++r) {
      row[r] = base + r * blockDim.x + threadIdx.x;
      valid[r] = row[r] < n;
      vmask[r] = __ballot_sync(kFull, valid[r]);
    }
    if (vmask[0] == 0) continue;  // the warp's rows are all past n
    for (int j = j0; j < j1; ++j) {
      uint32_t v[kHistRows];
#pragma unroll
      for (int r = 0; r < kHistRows; ++r)
        v[r] = valid[r] ? __ldg(words + row[r] * w + j) : 0u;
      uint32_t* bins = s_hist + 4 * (j - j0) * kBins;
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        if (vmask[r] == 0) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          hist_add(bins + k * kBins, (v[r] >> (8 * k)) & 0xFF, valid[r],
                   vmask[r], lane);
      }
    }
    if (lengths != nullptr) {
      int32_t len[kHistRows];
#pragma unroll
      for (int r = 0; r < kHistRows; ++r)
        len[r] = valid[r] ? __ldg(lengths + row[r]) : 0;
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        if (vmask[r] == 0) continue;
        if (full) {
          const uint32_t key = (uint32_t)len[r] ^ 0x80000000u;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            hist_add(s_other + k * kBins, (key >> (8 * k)) & 0xFF, valid[r],
                     vmask[r], lane);
        } else {
          const uint32_t mapped = mapped_length(len[r]);
          big |= valid[r] && len[r] != kPadLength &&
                 (uint32_t)len[r] > kMappedMax;
#pragma unroll
          for (int k = 0; k < 2; ++k)
            hist_add(s_other + (4 + k) * kBins, (mapped >> (8 * k)) & 0xFF,
                     valid[r], vmask[r], lane);
        }
      }
    }
    if (keys != nullptr) {
      unsigned long long key[kHistRows];
#pragma unroll
      for (int r = 0; r < kHistRows; ++r)
        key[r] = valid[r] ? __ldg(keys + row[r]) ^ kTop : 0ull;
#pragma unroll
      for (int r = 0; r < kHistRows; ++r) {
        if (vmask[r] == 0) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          hist_add(s_other + (6 + k) * kBins,
                   (uint32_t)(key[r] >> (8 * k)) & 0xFF, valid[r], vmask[r],
                   lane);
      }
    }
  }
  big = __syncthreads_or(big);
  for (int i = threadIdx.x; i < local; i += blockDim.x) {
    const uint32_t c = s_hist[i];
    if (c == 0) continue;
    const int d = i / kBins;
    const int slot = d < 4 * lanes ? 4 * j0 + d : 4 * w + (d - 4 * lanes);
    atomicAdd(hist + slot * kBins + (i % kBins), c);
  }
  if (threadIdx.x == 0 && big)
    atomicOr(hist + (4 * w + kOtherDigits) * kBins, 1u);
}

// ---------------------------------------------------------------------------
// Digit passes.
// ---------------------------------------------------------------------------

// One pass's operands.  `col` is the column gathered in a column's first
// pass (a lane or a pair: words + j with stride W; the length; the hash
// keys);
// later passes read the carried keys.  `idx_in` null: the input order.
struct PassArgs {
  const void* col;
  int64_t stride;
  int kind;  // the plan column: a lane, a pair, kLenFull, kLenMapped, kHashKey
  const void* keys_in;
  const int32_t* idx_in;
  void* keys_out;
  int32_t* idx_out;
  long long* perm;
  long long* s_hash;
  const uint32_t* hist;  // this digit's 256 bins
  unsigned long long* states;
  unsigned long long* counter;
  int64_t n;
  int shift;
  uint32_t epoch;
};

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

// kOut: 0 carry (keys and indices), 1 indices only (the next pass gathers
// a new column, or the length order is the result), 2 the int64
// permutation, 3 the permutation and the keys as kernel I's int64.
template <typename K, bool kGather, int kOut>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
    sort_pass_kernel(const PassArgs a) {
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
  if (tid == 0) s_tile = (int)atomicAdd(a.counter, 1ull);
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int64_t t0 = (int64_t)tile * kTileRows;
  const int rows = (int)min((int64_t)kTileRows, a.n - t0);

  // 1. Item k of a thread is row warp * kWarpRows + 32 k + lane of the
  // tile: each load of a warp is 32 consecutive rows.
  K key[kItems];
  int32_t idx[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    key[k] = 0;
    idx[k] = 0;
    const int r = warp * kWarpRows + k * 32 + lane;
    if (r < rows) {
      const int64_t g = t0 + r;
      if (kGather) {
        idx[k] = a.idx_in != nullptr ? __ldcs(a.idx_in + g) : (int32_t)g;
      } else {
        idx[k] = __ldcs(a.idx_in + g);
        key[k] = __ldcs(static_cast<const K*>(a.keys_in) + g);
      }
    }
  }
  if (kGather) {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (warp * kWarpRows + k * 32 + lane < rows)
        key[k] = gather_key<K>(a, idx[k]);
  }

  // 2. Each row's rank among the warp's rows of its digit, in row order.
  uint32_t rank[kItems];
  volatile uint32_t* cnt = s_cnt[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = warp * kWarpRows + k * 32 + lane < rows;
    const uint32_t b = valid ? digit_of(key[k], a.shift) : kBins;
    const unsigned peers = match_digit(b);
    const int leader = __ffs(peers) - 1;
    uint32_t start = 0;
    if (lane == leader && valid) {
      start = cnt[b];
      cnt[b] = start + __popc(peers);
    }
    start = __shfl_sync(kFull, start, leader);
    rank[k] = start + __popc(peers & below);
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
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_cnt[w][b];
    s_cnt[w][b] = tot;
    tot += c;
  }
  const unsigned long long tag = (unsigned long long)a.epoch << 32;
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
  for (int w = 0; w < warp; ++w) excl += s_warp[w];
  const uint32_t bin_start = (uint32_t)excl;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_cnt[w][b] += bin_start;
  __syncthreads();

  // 4. Stage the tile in digit order, freeing the registers, then the
  // look-back: staged row i of digit d goes to s_dst[d] + i.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (warp * kWarpRows + k * 32 + lane < rows) {
      const uint32_t p = s_cnt[warp][digit_of(key[k], a.shift)] + rank[k];
      s_key[p] = key[k];
      s_idx[p] = idx[k];
    }
  }
  const uint32_t before = global == 0 || tile == 0
                              ? 0u
                              : bin_prefix(a.states, tile, b, tot, a.epoch);
  s_dst[b] = (long long)(excl >> 32) + before - bin_start;
  __syncthreads();
  for (int i = tid; i < rows; i += kThreads) {
    const K kk = s_key[i];
    const int32_t id = s_idx[i];
    const long long pos = s_dst[digit_of(kk, a.shift)] + i;
    if (kOut == 0) {
      static_cast<K*>(a.keys_out)[pos] = kk;
      a.idx_out[pos] = id;
    } else if (kOut == 1) {
      a.idx_out[pos] = id;
    } else {
      a.perm[pos] = id;
      if (kOut == 3) a.s_hash[pos] = (long long)((unsigned long long)kk ^ kTop);
    }
  }
}

template <typename K, bool kGather, int kOut>
int launch_pass(const PassArgs& a, int64_t tiles, cudaStream_t stream) {
  constexpr int smem = kTileRows * (int)(sizeof(K) + sizeof(int32_t));
  static bool opted_in = false;  // above 48 KB with the static arrays
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_pass_kernel<K, kGather, kOut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  sort_pass_kernel<K, kGather, kOut>
      <<<(unsigned)tiles, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename K, bool kGather>
int launch_out(const PassArgs& a, int out, int64_t tiles, cudaStream_t s) {
  switch (out) {
    case 0:
      return launch_pass<K, kGather, 0>(a, tiles, s);
    case 1:
      return launch_pass<K, kGather, 1>(a, tiles, s);
    case 2:
      return launch_pass<K, kGather, 2>(a, tiles, s);
    default:
      return launch_pass<K, kGather, 3>(a, tiles, s);
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

}  // namespace

extern "C" {

int ssq_sort_tile_rows() { return kTileRows; }

// Histograms of every digit: lanes of words [N, W] (null: none), lengths
// [N] (null: none; full: the int32 length's digits only, else the mapped
// length's and the flag), keys [N] int64 (null: none), into the zeroed
// hist[(4 W + 14) * 256 + 1].
int ssq_sort_hist(const void* words, int w, const void* lengths, int full,
                  const void* keys, void* hist, int64_t n, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t want =
      (n + kHistThreads * kHistRows - 1) / (kHistThreads * kHistRows);
  const unsigned blocks = (unsigned)min(want, (int64_t)(4 * sm_count()));
  const int groups = words != nullptr && w > 0
                         ? (w + kHistLanes - 1) / kHistLanes
                         : 1;
  for (int g = 0; g < groups; ++g) {
    const int j0 = words != nullptr ? g * kHistLanes : 0;
    const int j1 = words != nullptr ? min(w, j0 + kHistLanes) : 0;
    const size_t smem =
        (size_t)(4 * (j1 - j0) + kOtherDigits) * kBins * sizeof(uint32_t);
    sort_hist_kernel<<<blocks, kHistThreads, smem, s>>>(
        (const uint32_t*)words, w, j0, j1,
        g == 0 ? (const int32_t*)lengths : nullptr, full,
        g == 0 ? (const unsigned long long*)keys : nullptr, n,
        (uint32_t*)hist);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// The digit passes of `plan` (host int32 [passes][2]: column, shift; least
// significant first), starting from the order idx_in (int32 [N]; null:
// the input order).  scratch: uint64 [passes + tiles * 256], zeroed here;
// key_buf: 2 N keys (8 bytes each when a column is the hash key, else 4);
// idx_buf: int32 [2 N].  The last pass writes perm (int64 [N]) and, when
// given, s_hash (int64 [N]); with perm null it writes its indices to
// idx_buf's half (passes - 1) % 2.
int ssq_sort_passes(const int32_t* plan, int passes, const void* words,
                    int w, const void* lengths, const void* keys,
                    const void* idx_in, const void* hist, void* scratch,
                    void* key_buf, void* idx_buf, void* perm, void* s_hash,
                    int64_t n, void* stream) {
  if (n == 0 || passes == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const cudaError_t zeroed = cudaMemsetAsync(
      scratch, 0, (size_t)(passes + tiles * kBins) * sizeof(uint64_t), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  bool wide = false;
  for (int p = 0; p < passes; ++p)
    wide |= plan[2 * p] == kHashKey || plan[2 * p] >= kPair;
  const size_t key_bytes = wide ? 8 : 4;
  unsigned long long* counters = (unsigned long long*)scratch;
  char* keys_half[2] = {(char*)key_buf, (char*)key_buf + n * key_bytes};
  int32_t* idx_half[2] = {(int32_t*)idx_buf, (int32_t*)idx_buf + n};
  for (int p = 0; p < passes; ++p) {
    const int col = plan[2 * p];
    const bool first = p == 0 || plan[2 * (p - 1)] != col;
    const bool last_of_col = p == passes - 1 || plan[2 * (p + 1)] != col;
    PassArgs a;
    if (col >= 0) {
      a.col = (const uint32_t*)words + (col >= kPair ? col - kPair : col);
      a.stride = w;
    } else {
      a.col = col == kHashKey ? keys : lengths;
      a.stride = 1;
    }
    a.kind = col;
    a.keys_in = keys_half[(p + 1) % 2];
    a.idx_in = p == 0 ? (const int32_t*)idx_in : idx_half[(p + 1) % 2];
    a.keys_out = keys_half[p % 2];
    a.idx_out = idx_half[p % 2];
    a.perm = (long long*)perm;
    a.s_hash = (long long*)s_hash;
    a.hist = (const uint32_t*)hist + digit_slot(col, plan[2 * p + 1], w) * kBins;
    a.states = counters + passes;
    a.counter = counters + p;
    a.n = n;
    a.shift = plan[2 * p + 1];
    a.epoch = (uint32_t)(p + 1);
    int out = last_of_col ? 1 : 0;
    if (p == passes - 1 && perm != nullptr) out = s_hash != nullptr ? 3 : 2;
    int err;
    if (col == kHashKey || col >= kPair) {
      err = first ? launch_out<unsigned long long, true>(a, out, tiles, s)
                  : launch_out<unsigned long long, false>(a, out, tiles, s);
    } else {
      err = first ? launch_out<uint32_t, true>(a, out, tiles, s)
                  : launch_out<uint32_t, false>(a, out, tiles, s);
    }
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
