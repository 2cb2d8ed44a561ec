// Hand-written Hopper kernel of shortseq_torch's sharded merge: K10, the
// bucketed exchange's send buffers.
//
// Replaces shortseq_tpu/dist/count.py _bucket_hash plus the send-buffer
// build of count_sharded_bucketed (a stable argsort by bucket, ranks by
// searchsorted, a capacity check and three scatters in XLA).  Built with
// the other sources of this directory into one shared library with a
// plain C interface (shortseq_torch/_build.py) and bound with ctypes; the
// entry point launches on the stream it is given, allocates nothing, and
// returns the first CUDA error of its launches.
//
// What it computes, for rows i of words [N, W] (uint32 lanes), lengths
// and weights [N], D buckets and a capacity `cap` from the host:
//   h = uint32(length) ^ lane_0 ^ ... ^ lane_{W-1}; h *= 2654435761;
//   bucket = ((h >> 16) * D) >> 16, and D (virtual, never sent) for
//   PAD_LENGTH rows.  A live row's rank is its position among the live
//   rows of its bucket in input order; it goes to slot bucket * cap +
//   rank of the [D * cap] send buffers, or, when rank >= cap, is dropped
//   and sets the overflow flag.  Empty slots hold words 0, length
//   PAD_LENGTH and weight 0.
//
// Bound by HBM bytes: the rows are read once and the send buffers written
// once (at D = 1 and capacity factor 2, 16 B read and 16 B written a row
// of 2 lanes).  A row's rank depends on every earlier row of its bucket,
// so the cost to avoid is a second trip through HBM: writing each row's
// bucket and rank and reading the rows back, as a hash launch and a
// scatter launch would (~60 B a row at W = 2).  The wrapper picks one of
// two plans (dist/count.py k10_plan), both exact:
//
// One pass, for D <= 1024 (every main path at one rank), two launches:
//   1. bucket_tile: a block of 512 threads per tile of 4096 / V row
//      vectors (V vectors of 16, 8 or 4 bytes a row: the widest that
//      divides the row and both buffers' alignment), tile ids from an
//      atomic counter.  Every thread loads 8 vectors of the tile's one
//      flat span, coalesced, all issued before any is used, and KEEPS
//      them in registers until it stores them to their slots: each row
//      is read once and no per-row bucket or rank goes to HBM (lengths,
//      weights, buckets, ranks and slots of the tile live in shared
//      memory).  A row's hash is the XOR of its vectors (in place for
//      V = 1, warp shuffles when V is a power of two, a shared atomicXor
//      otherwise) and its length; D = 1 needs none.  Ranks in the tile:
//      each warp walks its contiguous sixteenth of the tile 32 rows at a
//      time in input order; lanes of one bucket find each other with
//      __match_any_sync and the lowest advances the warp's running count
//      of the bucket in shared memory by the group's popcount.  A warp
//      per bucket then scans the 16 warps' counts and finds the rows of
//      its bucket in the tiles before by a single-pass decoupled
//      look-back over 32 tiles a step (one 32-bit state per (tile,
//      bucket): status in the top two bits, a count below; kernel D's
//      look-back in count.cu is the model).  The last tile writes each
//      bucket's total.  What is left between this launch and its bound
//      is each tile's chain of barriers, its look-back and its tile-id
//      atomic, during which the block moves no bytes.
//   2. bucket_fill: reads only those totals and writes the empty slots
//      past each bucket's rows (a block row per bucket), and the
//      overflow flag.  One memset (in the entry point) zeroes the
//      states first.
//
// Three launches, for D > 1024 or a (tile, bucket) state array over the
// wrapper's budget (no main path at one rank):
//   1. bucket_hash: one warp per tile of tile_rows rows walks its tile 32
//      rows at a time in input order.  The 32 rows' words are read
//      coalesced: a lane a row up to W = 8 (a warp's rows are one span of
//      at most 1 KB), else by groups of G = min(32, pow2 >= W) lanes a
//      row, XOR-reduced by shuffles; ranks by __match_any_sync as above,
//      with the running counts of the tile's column of a per-(bucket,
//      tile) histogram in global memory.  Stores bucket and in-tile rank.
//   2. bucket_scan: one block per bucket turns its row of the histogram
//      into exclusive tile offsets and stores the bucket's total.
//   3. bucket_scatter: a group of threads per row places it at tile
//      offset + in-tile rank, or flags the overflow; a group per slot
//      fills the slots past its bucket's total.
// No sort, scan or search of the library is used in either plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPadLength = 0x7fffffff;
constexpr uint32_t kHashMul = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bucket_of(uint32_t h, int d) {
  h *= kHashMul;
  return (int)(((h >> 16) * (uint32_t)d) >> 16);
}

__device__ __forceinline__ uint32_t fold(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t fold(uint2 v) { return v.x ^ v.y; }
__device__ __forceinline__ uint32_t fold(uint4 v) {
  return v.x ^ v.y ^ v.z ^ v.w;
}

// ---------------------------------------------------------------------------
// One pass (D <= 1024).
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileVectors = 8;                     // vectors a thread keeps
constexpr int kTileSpan = kTileThreads * kTileVectors;  // vectors a tile
constexpr int kTileBlocks = 2;  // blocks an SM should hold (registers)
constexpr int kOnePassBuckets = 1024;

// The wrapper's zeroed int32 scratch: two words, D totals, then one
// look-back state per (tile, bucket), tile-major.
constexpr int kTileCounter = 0;
constexpr int kOverflowFlag = 1;
constexpr int kTotals = 2;

constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kPrefix = 2u << 30;
constexpr uint32_t kValueMask = (1u << 30) - 1;

// Run by one warp: publishes this tile's count of bucket b, then sums
// the counts of the tiles before it 32 at a time until one of them
// carries an inclusive prefix, and publishes its own.  Returns the count
// of the bucket's rows in the tiles before this one, on every lane.
__device__ uint32_t bucket_prefix(uint32_t* states, int tile, int d, int b,
                                  uint32_t count, int lane) {
  volatile uint32_t* vs = states;
  if (tile == 0) {
    if (lane == 0) vs[b] = kPrefix | count;
    return 0;
  }
  if (lane == 0) vs[(int64_t)tile * d + b] = kAggregate | count;
  uint32_t before = 0;
  for (int top = tile - 1;; top -= 32) {
    const int t = top - lane;
    uint32_t s = kPrefix;  // before tile 0: an empty prefix
    if (t >= 0) {
      s = vs[(int64_t)t * d + b];
      while ((s >> 30) == 0) {
        __nanosleep(32);
        s = vs[(int64_t)t * d + b];
      }
    }
    const unsigned prefix_lanes = __ballot_sync(kFull, (s >> 30) == 2);
    const int stop = prefix_lanes ? __ffs(prefix_lanes) - 1 : 31;
    uint32_t v = lane <= stop ? (s & kValueMask) : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    before += v;
    if (prefix_lanes) break;
  }
  if (lane == 0) vs[(int64_t)tile * d + b] = kPrefix | (before + count);
  return before;
}

template <typename V>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    bucket_tile_kernel(const V* __restrict__ words,
                       const int32_t* __restrict__ lengths,
                       const int32_t* __restrict__ weights,
                       int32_t* __restrict__ scratch, V* __restrict__ send_words,
                       int32_t* __restrict__ send_lengths,
                       int32_t* __restrict__ send_weights, int64_t n, int vpr,
                       int d, int64_t cap, int tile_rows, int n_tiles) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  // s_row: each row's hash, then its bucket and rank in the warp, then
  // its slot (-1: not sent); each step reads and writes only its row.
  long long* s_row = reinterpret_cast<long long*>(tile_smem);
  int32_t* s_len = reinterpret_cast<int32_t*>(s_row + tile_rows);
  int32_t* s_wt = s_len + tile_rows;
  int32_t* s_cnt = s_wt + tile_rows;  // [8][d] running counts
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(scratch + kTileCounter, 1);
  for (int i = tid; i < kTileWarps * d; i += kTileThreads) s_cnt[i] = 0;
  for (int i = tid; i < tile_rows; i += kTileThreads) s_row[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int64_t t0 = (int64_t)tile * tile_rows;
  const int rows = (int)min((int64_t)tile_rows, n - t0);
  const int nv = rows * vpr;

  // 1. The tile's vectors, flat and coalesced, kept in registers; its
  // lengths and weights to shared memory.
  const V* src = words + t0 * vpr;
  V v[kTileVectors];
#pragma unroll
  for (int k = 0; k < kTileVectors; ++k) {
    const int p = tid + k * kTileThreads;
    if (p < nv) v[k] = __ldcs(src + p);
  }
  for (int r = tid; r < rows; r += kTileThreads) {
    s_len[r] = __ldcs(lengths + t0 + r);
    s_wt[r] = __ldcs(weights + t0 + r);
  }

  // 2. Row hashes: the XOR of each row's vectors (at D = 1 every live row
  // is in bucket 0, and no hash is needed).
  const bool pow2 = (vpr & (vpr - 1)) == 0;
  const int group = vpr < 32 ? vpr : 32;
  uint32_t* s_hash = reinterpret_cast<uint32_t*>(s_row);
  if (d > 1) {
#pragma unroll
    for (int k = 0; k < kTileVectors; ++k) {
      const int p = tid + k * kTileThreads;
      uint32_t f = p < nv ? fold(v[k]) : 0u;
      if (vpr == 1) {
        if (p < nv) s_hash[2 * p] = f;
      } else if (pow2) {
        // Rows start at multiples of vpr, so a row's lanes of one warp are
        // an aligned group of min(vpr, 32).
        for (int off = group >> 1; off > 0; off >>= 1)
          f ^= __shfl_xor_sync(kFull, f, off);
        if (p < nv && (lane & (group - 1)) == 0) {
          if (vpr <= 32)
            s_hash[2 * (p / vpr)] = f;
          else
            atomicXor(s_hash + 2 * (p / vpr), f);
        }
      } else if (p < nv) {
        atomicXor(s_hash + 2 * (p / vpr), f);
      }
    }
  }
  __syncthreads();

  // 3. Bucket and rank among the warp's rows of the bucket, in order:
  // warp w walks rows [w * chunk, (w + 1) * chunk), 32 at a time.
  const int chunk = (tile_rows + kTileWarps - 1) / kTileWarps;
  volatile int32_t* cnt = s_cnt + warp * d;
  const unsigned below = (1u << lane) - 1u;
  for (int c0 = 0; c0 < chunk; c0 += 32) {  // uniform across the warp
    const int c = c0 + lane;
    const int r = warp * chunk + c;
    int b = -1;  // rows past the tile take part in the match, not the count
    if (c < chunk && r < rows) {
      const int32_t len = s_len[r];
      b = len == kPadLength ? d
          : d == 1          ? 0
                            : bucket_of(s_hash[2 * r] ^ (uint32_t)len, d);
    }
    const unsigned peers = __match_any_sync(kFull, b);
    const int leader = __ffs(peers) - 1;
    int start = 0;
    if (lane == leader && b >= 0 && b < d) {
      start = cnt[b];
      cnt[b] = start + __popc(peers);
    }
    start = __shfl_sync(kFull, start, leader);
    if (b >= 0)
      s_row[r] = ((long long)b << 32) | (uint32_t)(start + __popc(peers & below));
    __syncwarp();
  }
  __syncthreads();

  // 4. A warp per bucket: each warp's first rank in the bucket over the
  // whole input (the warps before it in the tile, then the look-back).
  uint32_t* states = reinterpret_cast<uint32_t*>(scratch + kTotals + d);
  for (int b = warp; b < d; b += kTileWarps) {
    const int32_t c = lane < kTileWarps ? s_cnt[lane * d + b] : 0;
    int32_t incl = c;
#pragma unroll
    for (int off = 1; off < kTileWarps; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int32_t run = __shfl_sync(kFull, incl, kTileWarps - 1);
    const int32_t before =
        (int32_t)bucket_prefix(states, tile, d, b, (uint32_t)run, lane);
    if (lane < kTileWarps) s_cnt[lane * d + b] = before + incl - c;
    if (lane == 0 && tile == n_tiles - 1) scratch[kTotals + b] = before + run;
  }
  __syncthreads();

  // 5. Slots, by the thread that ranked the row; lengths and weights out.
  int over = 0;
  for (int c0 = 0; c0 < chunk; c0 += 32) {
    const int c = c0 + lane;
    const int r = warp * chunk + c;
    if (c >= chunk || r >= rows) continue;
    const long long br = s_row[r];
    const int b = (int)(br >> 32);
    long long slot = -1;
    if (b < d) {
      const int64_t rank = (int64_t)s_cnt[warp * d + b] + (int32_t)br;
      if (rank < cap) {
        slot = (long long)b * cap + rank;
        send_lengths[slot] = s_len[r];
        send_weights[slot] = s_wt[r];
      } else {
        over = 1;
      }
    }
    s_row[r] = slot;
  }
  over = __syncthreads_or(over);  // also: every slot is in s_row
  if (tid == 0 && over) atomicOr(scratch + kOverflowFlag, 1);

  // 6. Each kept vector to its row's slot.
#pragma unroll
  for (int k = 0; k < kTileVectors; ++k) {
    const int p = tid + k * kTileThreads;
    if (p >= nv) continue;
    const int r = vpr == 1 ? p : p / vpr;
    const long long slot = s_row[r];
    if (slot >= 0) send_words[slot * vpr + (p - r * vpr)] = v[k];
  }
}

template <typename V>
__global__ void bucket_fill_kernel(const int32_t* __restrict__ scratch,
                                   V* __restrict__ send_words,
                                   int32_t* __restrict__ send_lengths,
                                   int32_t* __restrict__ send_weights,
                                   int32_t* __restrict__ overflow,
                                   int64_t cap, int vpr) {
  const int b = blockIdx.y;
  if (b == 0 && blockIdx.x == 0 && threadIdx.x == 0)
    *overflow = scratch[kOverflowFlag];
  const int64_t live = min((int64_t)scratch[kTotals + b], cap);
  const int64_t slot0 = (int64_t)b * cap + live;
  const int64_t empty = cap - live;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  V* dst = send_words + slot0 * vpr;
  for (int64_t i = first; i < empty * vpr; i += stride) dst[i] = V{};
  for (int64_t i = first; i < empty; i += stride) {
    send_lengths[slot0 + i] = kPadLength;
    send_weights[slot0 + i] = 0;
  }
}

template <typename V>
int launch_one_pass(const void* words, const void* lengths,
                    const void* weights, int32_t* scratch, void* send_words,
                    void* send_lengths, void* send_weights, void* overflow,
                    int64_t n, int w, int d, int64_t cap, int tile_rows,
                    int n_tiles, cudaStream_t s) {
  const int vpr = w * (int)sizeof(uint32_t) / (int)sizeof(V);
  if (vpr * tile_rows > kTileSpan || d > kOnePassBuckets ||
      (int64_t)tile_rows * n_tiles < n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(long long) + 2 * sizeof(int32_t)) * tile_rows +
                      sizeof(int32_t) * kTileWarps * d;
  // 64 KB of row arrays at 4096 rows, plus 64 KB of counts at D = 1024.
  // The attribute is raised once per size (setting it costs tens of
  // microseconds of host time).
  static size_t smem_set = 48 * 1024;
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(bucket_tile_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  bucket_tile_kernel<V><<<(unsigned)n_tiles, kTileThreads, smem, s>>>(
      (const V*)words, (const int32_t*)lengths, (const int32_t*)weights,
      scratch, (V*)send_words, (int32_t*)send_lengths, (int32_t*)send_weights,
      n, vpr, d, cap, tile_rows, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Enough blocks per bucket to fill the card when most slots are empty;
  // a block that finds its bucket full leaves at once.
  const int threads = 256;
  int64_t per_bucket = (cap * vpr + threads - 1) / threads;
  const int64_t most = (2048 + d - 1) / d;
  if (per_bucket > most) per_bucket = most;
  if (per_bucket < 1) per_bucket = 1;
  bucket_fill_kernel<V><<<dim3((unsigned)per_bucket, (unsigned)d), threads, 0,
                          s>>>(scratch, (V*)send_words, (int32_t*)send_lengths,
                               (int32_t*)send_weights, (int32_t*)overflow, cap,
                               vpr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Three launches (D > 1024, or a state array over budget).
// ---------------------------------------------------------------------------

constexpr int kHashWarps = 8;       // tiles per block of launch 1
constexpr int kSharedBuckets = 1024;  // most D counted in shared memory
constexpr int kScanThreads = 256;   // launch 2
constexpr int kScanItems = 4;       // tile counts per thread per chunk

__global__ void bucket_hash_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ lengths,
                                   int64_t n, int w, int d, int64_t tile_rows,
                                   int64_t n_tiles, int group_shift,
                                   int32_t* __restrict__ bucket_out,
                                   int32_t* __restrict__ rank_out,
                                   int32_t* counts) {
  extern __shared__ int32_t shared_counts[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = (int64_t)blockIdx.x * kHashWarps + warp;
  if (tile >= n_tiles) return;  // the whole warp leaves together
  const unsigned below = (1u << lane) - 1u;
  const int64_t row0 = tile * tile_rows;
  const int64_t row_end = min(row0 + tile_rows, n);
  // Only this warp touches its tile's running counts: D <= kSharedBuckets
  // keeps them in shared memory and copies them to the tile's column of
  // the histogram at the end; a larger D counts in the column itself.
  // volatile keeps each count in memory, where the next group leader
  // reads it.
  const bool in_shared = d <= kSharedBuckets;
  volatile int32_t* col;
  int64_t stride;
  if (in_shared) {
    col = shared_counts + warp * d;
    stride = 1;
    for (int b = lane; b < d; b += 32) col[b] = 0;
    __syncwarp();
  } else {
    col = counts + tile;
    stride = n_tiles;
  }
  // A row's words are read by a group of G lanes, 32 / G rows a pass.
  const int g = 1 << group_shift;
  const int per = 32 / g;
  const int sub = lane & (g - 1);
  for (int64_t base = row0; base < row_end; base += 32) {
    const int64_t i = base + lane;
    uint32_t h = 0;
    if (g == 1) {  // a lane a row: the warp's rows are one short span
      if (i < row_end)
        for (int j = 0; j < w; ++j) h ^= words[i * w + j];
    } else {
      for (int k = 0; k < g; ++k) {
        const int64_t r = base + k * per + (lane >> group_shift);
        uint32_t x = 0;
        if (r < row_end) {
          const uint32_t* src = words + r * w;
          for (int j = sub; j < w; j += g) x ^= src[j];
        }
        for (int off = g >> 1; off > 0; off >>= 1)
          x ^= __shfl_xor_sync(kFull, x, off);
        // Row base + lane was pass lane / per, group lane % per.
        x = __shfl_sync(kFull, x, (lane % per) << group_shift);
        if (lane / per == k) h = x;
      }
    }
    int b = -1;  // rows past the tile take part in the match, not the count
    if (i < row_end) {
      const int32_t len = lengths[i];
      b = len == kPadLength ? d : bucket_of(h ^ (uint32_t)len, d);
      bucket_out[i] = b;
    }
    const unsigned peers = __match_any_sync(kFull, b);
    const int leader = __ffs(peers) - 1;
    int start = 0;
    if (lane == leader && b >= 0 && b < d) {
      start = col[b * stride];
      col[b * stride] = start + __popc(peers);
    }
    start = __shfl_sync(kFull, start, leader);
    if (i < row_end && b < d) rank_out[i] = start + __popc(peers & below);
    __syncwarp();  // this round's counts are visible to the next leaders
  }
  if (in_shared) {
    for (int b = lane; b < d; b += 32) counts[b * n_tiles + tile] = col[b];
  }
}

__global__ void bucket_scan_kernel(int32_t* __restrict__ counts,
                                   int32_t* __restrict__ totals,
                                   int32_t* __restrict__ overflow,
                                   int64_t n_tiles) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) *overflow = 0;  // the scatter sets it
  int32_t* row = counts + (int64_t)blockIdx.x * n_tiles;
  int32_t carry = 0;
  for (int64_t base = 0; base < n_tiles;
       base += kScanThreads * kScanItems) {
    int32_t v[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t t = base + (int64_t)tid * kScanItems + k;
      v[k] = t < n_tiles ? row[t] : 0;
      sum += v[k];
    }
    int32_t incl = sum;  // inclusive scan of the thread sums in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t s = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 1; off < kScanThreads / 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += y;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = s;
    }
    __syncthreads();
    int32_t excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t t = base + (int64_t)tid * kScanItems + k;
      if (t < n_tiles) row[t] = excl;
      excl += v[k];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (tid == 0) totals[blockIdx.x] = carry;
}

// The row copies move V-sized pieces, wv of them a row.  A group of
// 2^group_shift consecutive threads (the least power of two >= wv, at
// most 32) handles each item, a row to place or a slot to fill, and its
// pieces strided by the group size, so wide rows copy coalesced.
template <typename V>
__global__ void bucket_scatter_kernel(
    const V* __restrict__ words, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ weights, const int32_t* __restrict__ bucket,
    const int32_t* __restrict__ rank, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ totals, V* __restrict__ send_words,
    int32_t* __restrict__ send_lengths, int32_t* __restrict__ send_weights,
    int32_t* __restrict__ overflow, int64_t n, int wv, int d, int64_t cap,
    int64_t tile_rows, int64_t n_tiles, int group_shift) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = gid >> group_shift;
  const int sub = (int)(gid & ((1 << group_shift) - 1));
  const int step = 1 << group_shift;
  if (i < n) {
    const int b = bucket[i];
    if (b >= d) return;  // a PAD row: never sent
    const int64_t r =
        (int64_t)offsets[(int64_t)b * n_tiles + i / tile_rows] + rank[i];
    if (r >= cap) {
      *overflow = 1;
      return;
    }
    const int64_t slot = (int64_t)b * cap + r;
    const V* src = words + i * wv;
    V* dst = send_words + slot * wv;
    for (int j = sub; j < wv; j += step) dst[j] = src[j];
    if (sub == 0) {
      send_lengths[slot] = lengths[i];
      send_weights[slot] = weights[i];
    }
    return;
  }
  const int64_t s = i - n;
  if (s >= (int64_t)d * cap) return;
  const int64_t b = s / cap;
  if (s - b * cap < totals[b]) return;  // a live row lands here
  V* dst = send_words + s * wv;
  for (int j = sub; j < wv; j += step) dst[j] = V{};
  if (sub == 0) {
    send_lengths[s] = kPadLength;
    send_weights[s] = 0;
  }
}

int least_shift(int items) {
  int shift = 0;
  while ((1 << shift) < items && shift < 5) ++shift;
  return shift;
}

template <typename V>
int launch_three(const void* words, const void* lengths, const void* weights,
                 int32_t* scratch, void* send_words, void* send_lengths,
                 void* send_weights, void* overflow, int64_t n, int w, int d,
                 int64_t cap, int64_t tile_rows, int64_t n_tiles,
                 cudaStream_t s) {
  // Scratch: the zeroed histogram [d * n_tiles], then bucket [n], rank
  // [n] and totals [d].
  int32_t* counts = scratch;
  int32_t* bucket = counts + (int64_t)d * n_tiles;
  int32_t* rank = bucket + n;
  int32_t* totals = rank + n;
  const unsigned hash_blocks =
      (unsigned)((n_tiles + kHashWarps - 1) / kHashWarps);
  const size_t shared =
      d <= kSharedBuckets ? sizeof(int32_t) * kHashWarps * d : 0;
  bucket_hash_kernel<<<hash_blocks, 32 * kHashWarps, shared, s>>>(
      (const uint32_t*)words, (const int32_t*)lengths, n, w, d, tile_rows,
      n_tiles, w <= 8 ? 0 : least_shift(w), bucket, rank, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bucket_scan_kernel<<<(unsigned)d, kScanThreads, 0, s>>>(
      counts, totals, (int32_t*)overflow, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int wv = w / (int)(sizeof(V) / sizeof(uint32_t));
  const int group_shift = least_shift(wv);
  const int threads = 256;
  const int64_t items = (n + (int64_t)d * cap) << group_shift;
  bucket_scatter_kernel<V><<<(unsigned)((items + threads - 1) / threads),
                             threads, 0, s>>>(
      (const V*)words, (const int32_t*)lengths, (const int32_t*)weights,
      bucket, rank, counts, totals, (V*)send_words, (int32_t*)send_lengths,
      (int32_t*)send_weights, (int32_t*)overflow, n, wv, d, cap, tile_rows,
      n_tiles, group_shift);
  return (int)cudaGetLastError();
}

template <typename V>
int launch(const void* words, const void* lengths, const void* weights,
           int32_t* scratch, void* send_words, void* send_lengths,
           void* send_weights, void* overflow, int64_t n, int w, int d,
           int64_t cap, int64_t tile_rows, int64_t n_tiles, int one_pass,
           cudaStream_t s) {
  if (one_pass)
    return launch_one_pass<V>(words, lengths, weights, scratch, send_words,
                              send_lengths, send_weights, overflow, n, w, d,
                              cap, (int)tile_rows, (int)n_tiles, s);
  return launch_three<V>(words, lengths, weights, scratch, send_words,
                         send_lengths, send_weights, overflow, n, w, d, cap,
                         tile_rows, n_tiles, s);
}

}  // namespace

extern "C" {

// The plan comes from the wrapper (dist/count.py k10_plan): vec_bytes,
// the widest piece that divides the row and both word buffers' alignment;
// tile_rows and n_tiles; one_pass (D <= 1024).  scratch: int32, of which
// the first `zeroed` ints are zeroed here (the call's one memset).
// n > 0, 1 <= d <= 65536.
int ssq_bucket_send(const void* words, const void* lengths,
                    const void* weights, void* scratch, void* send_words,
                    void* send_lengths, void* send_weights, void* overflow,
                    int64_t n, int w, int d, int64_t cap, int64_t tile_rows,
                    int64_t n_tiles, int vec_bytes, int one_pass,
                    int64_t zeroed, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)words | (uintptr_t)send_words;
  if ((4 * w) % vec_bytes || align % vec_bytes)
    return (int)cudaErrorInvalidValue;
  auto sc = (int32_t*)scratch;
  const cudaError_t err =
      cudaMemsetAsync(sc, 0, sizeof(int32_t) * (size_t)zeroed, s);
  if (err != cudaSuccess) return (int)err;
  switch (vec_bytes) {
    case 16:
      return launch<uint4>(words, lengths, weights, sc, send_words,
                           send_lengths, send_weights, overflow, n, w, d, cap,
                           tile_rows, n_tiles, one_pass, s);
    case 8:
      return launch<uint2>(words, lengths, weights, sc, send_words,
                           send_lengths, send_weights, overflow, n, w, d, cap,
                           tile_rows, n_tiles, one_pass, s);
    default:
      return launch<uint32_t>(words, lengths, weights, sc, send_words,
                              send_lengths, send_weights, overflow, n, w, d,
                              cap, tile_rows, n_tiles, one_pass, s);
  }
}

}  // extern "C"
