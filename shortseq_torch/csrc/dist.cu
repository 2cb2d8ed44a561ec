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
// Bound by HBM bytes: the rows are read once and the send buffers, which
// at capacity factor 2 are twice the rows, written once.  Three launches:
//   1. bucket_hash: one warp per tile of tile_rows rows (a multiple of
//      32) walks its tile 32 rows at a time in input order; lanes with the
//      same bucket find each other with __match_any_sync, take their rank
//      inside the tile from a running count per (bucket, tile) that the
//      group's lowest lane advances (in shared memory for D <= 1024), and
//      store bucket and in-tile rank.  The running counts end as the
//      per-tile histogram, bucket-major.
//   2. bucket_scan: one block per bucket turns its row of the histogram
//      into exclusive tile offsets (a block scan over the tiles in order)
//      and stores the bucket's total.
//   3. bucket_scatter: a group of threads per row (8- or 16-byte copies
//      where the row allows) places it at tile offset + in-tile rank, or
//      flags the overflow; a group per slot fills the slots past its
//      bucket's total.
// A row's rank depends only on the rows before it in its bucket, never on
// how rows split into tiles or blocks; no sort, scan or search of the
// library is used.  The histogram holds D * n_tiles ints: the wrapper
// grows tile_rows with D to bound it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPadLength = 0x7fffffff;
constexpr uint32_t kHashMul = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHashWarps = 8;       // tiles per block of launch 1
constexpr int kSharedBuckets = 1024;  // most D counted in shared memory
constexpr int kScanThreads = 256;   // launch 2
constexpr int kScanItems = 4;       // tile counts per thread per chunk

__global__ void bucket_hash_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ lengths,
                                   int64_t n, int w, int d, int64_t tile_rows,
                                   int64_t n_tiles,
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
  for (int64_t base = row0; base < row_end; base += 32) {
    const int64_t i = base + lane;
    int b = -1;  // rows past the tile take part in the match, not the count
    if (i < row_end) {
      const int32_t len = lengths[i];
      if (len == kPadLength) {
        b = d;
      } else {
        uint32_t h = (uint32_t)len;
        const uint32_t* r = words + i * w;
        for (int j = 0; j < w; ++j) h ^= r[j];
        h *= kHashMul;
        b = (int)(((h >> 16) * (uint32_t)d) >> 16);
      }
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
                                   int64_t n_tiles) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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

// The row copies move V-sized pieces (uint32, uint2 or uint4: the widest
// that divides the row and its alignment), wv of them a row.  A group of
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

template <typename V>
void launch_scatter(const void* words, const void* lengths,
                    const void* weights, const void* bucket, const void* rank,
                    const void* counts, const void* totals, void* send_words,
                    void* send_lengths, void* send_weights, void* overflow,
                    int64_t n, int w, int d, int64_t cap, int64_t tile_rows,
                    int64_t n_tiles, cudaStream_t s) {
  const int wv = w / (int)(sizeof(V) / sizeof(uint32_t));
  int group_shift = 0;
  while ((1 << group_shift) < wv && group_shift < 5) ++group_shift;
  const int threads = 256;
  const int64_t items = (n + (int64_t)d * cap) << group_shift;
  bucket_scatter_kernel<V><<<(unsigned)((items + threads - 1) / threads),
                             threads, 0, s>>>(
      (const V*)words, (const int32_t*)lengths, (const int32_t*)weights,
      (const int32_t*)bucket, (const int32_t*)rank, (const int32_t*)counts,
      (const int32_t*)totals, (V*)send_words, (int32_t*)send_lengths,
      (int32_t*)send_weights, (int32_t*)overflow, n, wv, d, cap, tile_rows,
      n_tiles, group_shift);
}

}  // namespace

extern "C" {

// counts: d * n_tiles zeroed ints; bucket, rank: n ints; totals: d ints;
// overflow: one zeroed int.  n > 0, cap > 0, 1 <= d <= 65536.
int ssq_bucket_send(const void* words, const void* lengths,
                    const void* weights, void* bucket, void* rank,
                    void* counts, void* totals, void* send_words,
                    void* send_lengths, void* send_weights, void* overflow,
                    int64_t n, int w, int d, int64_t cap, int64_t tile_rows,
                    int64_t n_tiles, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned hash_blocks =
      (unsigned)((n_tiles + kHashWarps - 1) / kHashWarps);
  const size_t shared =
      d <= kSharedBuckets ? sizeof(int32_t) * kHashWarps * d : 0;
  bucket_hash_kernel<<<hash_blocks, 32 * kHashWarps, shared, s>>>(
      (const uint32_t*)words, (const int32_t*)lengths, n, w, d, tile_rows,
      n_tiles, (int32_t*)bucket, (int32_t*)rank, (int32_t*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bucket_scan_kernel<<<(unsigned)d, kScanThreads, 0, s>>>(
      (int32_t*)counts, (int32_t*)totals, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The widest piece that divides the row and both buffers' alignment.
  const uintptr_t align = (uintptr_t)words | (uintptr_t)send_words;
  if (w % 4 == 0 && align % 16 == 0) {
    launch_scatter<uint4>(words, lengths, weights, bucket, rank, counts,
                          totals, send_words, send_lengths, send_weights,
                          overflow, n, w, d, cap, tile_rows, n_tiles, s);
  } else if (w % 2 == 0 && align % 8 == 0) {
    launch_scatter<uint2>(words, lengths, weights, bucket, rank, counts,
                          totals, send_words, send_lengths, send_weights,
                          overflow, n, w, d, cap, tile_rows, n_tiles, s);
  } else {
    launch_scatter<uint32_t>(words, lengths, weights, bucket, rank, counts,
                             totals, send_words, send_lengths, send_weights,
                             overflow, n, w, d, cap, tile_rows, n_tiles, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
