// Hand-written Hopper kernel of shortseq_torch's UMI slice: H, the
// neighbour lists of many query rows in one pass, with no distance slab.
//
// Built with the other sources by shortseq_torch/_build.py (nvcc, sm_90a,
// plain C interface, ctypes).  The entry points launch on the stream they
// are given, allocate nothing, and return cudaGetLastError().
//
// H: neighbor_lists  replaces shortseq_tpu/umi/dedup.py _adjacency_score +
//                    _extract_ascending (dedup.py:180,203), which ran on a
//                    [block, U] slab from pairwise_hamming_auto (the Pallas
//                    _pairwise_tiled).  In this port that was kernel B
//                    writing the slab to HBM and kernel C reading it back;
//                    H computes the same (idx, cnt) without it.
//
// A neighbour of query row r is a column c with hamming(r, c) <= threshold
// (2-bit fields summed over W <= 2 lanes: UMIs of up to 32 nt), equal
// length, equal group id and c != a_rows[r].  Output: idx[r, :k] = the
// first k neighbour columns in ascending order, empty slots = U;
// cnt[r] = the true neighbour count (it may exceed k).
//
// What bounds it: popcounts.  The two lanes of a row become two bit planes
// (P = the low bit of each field, Q = the high bit, lane 0's fields on the
// even bits, lane 1's on the odd bits), so a field differs iff its bit
// differs in P or Q and a pair costs XOR, LOP3 and one __popc.  At the
// main path's 100,000 rows x 102,144 columns that is 1.02e10 popcounts,
// 2.4 ms at 16 per SM per clock (132 SMs at 1.98 GHz: 4.18e12/s).  HBM
// traffic is the operands in and idx/cnt out, under 10 MB.  Every block
// streams its column range from L2 once, so L2 carries row blocks x U x
// 16 B = 196 x 1.6 MB = 0.32 GB at 512 rows per block: under a tenth of
// a millisecond at L2's rate, far below the popcount term.
//
// Design:
// * A 128-thread block owns 512 query rows, 4 per thread, held in
//   registers as planes with their length, group and own column.
// * The block walks its columns in ascending order in tiles of 1024,
//   staged in shared memory as planes (8 B a column) plus (length, group)
//   (8 B).  Every thread reads the same column (a broadcast), so each
//   thread visits its rows' columns in order: hits come out ascending with
//   no sort, no ballot and no second pass, and a row's count lives in a
//   register.
// * The fast path tests 8 columns x 4 rows (32 pairs) with popcounts
//   alone and ORs the 32 verdicts into one branch.  Hits are rare (the
//   graph is sparse; a row's own column always hits), and only then are
//   the 8 columns re-tested in order with length, group and self masks.
// * When the rows alone give fewer than HBLOCKS_PER_SM blocks per SM, the
//   columns split into ranges over grid.y (ssq_neighbor_lists_splits).
//   Each (range, row) appends to its own k slots of a scratch buffer, and
//   a second launch (neighbor_merge_kernel, a warp per row) concatenates
//   the ranges of a row in order, keeps the first k, sums the counts and
//   fills empty slots.
// ---------------------------------------------------------------------------

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HT = 128;          // threads per block
constexpr int HR = 4;            // query rows per thread
constexpr int HROWS = HT * HR;   // query rows per block
constexpr int HTILE = 1024;      // columns per shared-memory tile
constexpr int HGROUP = 8;        // columns per fast-path test
// Blocks wanted per SM: more than fit at once (6 at 80 registers a
// thread), so the last wave of blocks is a short one.
constexpr int HBLOCKS_PER_SM = 16;
constexpr int64_t HSCRATCH = 1 << 26;   // scratch slots (256 MB) at most

// Bit planes of lanes (lo, hi), as kernel B's lane_planes (kernels.cu).
__device__ __forceinline__ uint2 lane_planes(uint32_t lo, uint32_t hi) {
  const uint32_t m = 0x55555555u;
  return make_uint2((lo & m) | ((hi & m) << 1),
                    ((lo >> 1) & m) | (hi & ~m));
}

__device__ __forceinline__ int field_diffs(uint2 a, uint32_t p, uint32_t q) {
  return __popc((a.x ^ p) | (a.y ^ q));
}

__global__ void __launch_bounds__(HT) neighbor_lists_kernel(
    const uint32_t* __restrict__ a_words, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ a_gid, const int32_t* __restrict__ a_rows,
    const uint32_t* __restrict__ words, const int32_t* __restrict__ len,
    const int32_t* __restrict__ gid, int32_t* __restrict__ sidx,
    int32_t* __restrict__ scnt, int64_t rows, int64_t u, int w,
    int threshold, int k, int64_t split_cols) {
  __shared__ uint4 s_pq[HTILE / 2];  // columns 2j, 2j + 1: (P, Q, P, Q)
  __shared__ int2 s_lg[HTILE];       // (length, group id)
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * HROWS;
  const int64_t c_begin = (int64_t)blockIdx.y * split_cols;
  const int64_t c_end =
      u < c_begin + split_cols ? u : c_begin + split_cols;

  // Row i of this thread is row0 + tid + i * HT (coalesced loads/stores).
  uint2 rpq[HR];
  int rlen[HR], rgid[HR], rself[HR], cnt[HR];
  bool rlive[HR];
#pragma unroll
  for (int i = 0; i < HR; ++i) {
    const int64_t r = row0 + tid + i * HT;
    rlive[i] = r < rows;
    uint32_t lo = 0, hi = 0;
    if (rlive[i]) {
      lo = a_words[r * w];
      if (w > 1) hi = a_words[r * w + 1];
    }
    rpq[i] = lane_planes(lo, hi);
    rlen[i] = rlive[i] ? a_len[r] : 0;
    rgid[i] = rlive[i] ? a_gid[r] : 0;
    rself[i] = rlive[i] ? a_rows[r] : -1;
    cnt[i] = 0;
  }

  for (int64_t c0 = c_begin; c0 < c_end; c0 += HTILE) {
    const int n = (int)(c_end - c0 < HTILE ? c_end - c0 : HTILE);
    const int n_pad = (n + HGROUP - 1) / HGROUP * HGROUP;
    __syncthreads();  // the previous tile is consumed
    uint2* s_pq2 = reinterpret_cast<uint2*>(s_pq);
    for (int j = tid; j < n_pad; j += HT) {
      uint32_t lo = 0, hi = 0;
      int2 lg = make_int2(0, 0);
      if (j < n) {
        const int64_t c = c0 + j;
        lo = words[c * w];
        if (w > 1) hi = words[c * w + 1];
        lg = make_int2(len[c], gid[c]);
      }
      s_pq2[j] = lane_planes(lo, hi);
      s_lg[j] = lg;
    }
    __syncthreads();
    for (int j0 = 0; j0 < n_pad; j0 += HGROUP) {
      uint4 v[HGROUP / 2];
#pragma unroll
      for (int t = 0; t < HGROUP / 2; ++t) v[t] = s_pq[j0 / 2 + t];
      bool any = false;
#pragma unroll
      for (int t = 0; t < HGROUP / 2; ++t)
#pragma unroll
        for (int i = 0; i < HR; ++i)
          any |= (field_diffs(rpq[i], v[t].x, v[t].y) <= threshold) |
                 (field_diffs(rpq[i], v[t].z, v[t].w) <= threshold);
      if (!any) continue;
      // Rare: the group's columns again, in order, with every mask.  The
      // padding past n fails `j < n`.
#pragma unroll
      for (int t = 0; t < HGROUP; ++t) {
        const int j = j0 + t;
        const uint32_t p = (t & 1) ? v[t / 2].z : v[t / 2].x;
        const uint32_t q = (t & 1) ? v[t / 2].w : v[t / 2].y;
        const int2 lg = s_lg[j];
        const int col = (int)(c0 + j);
#pragma unroll
        for (int i = 0; i < HR; ++i) {
          if (rlive[i] && j < n && field_diffs(rpq[i], p, q) <= threshold &&
              lg.x == rlen[i] && lg.y == rgid[i] && col != rself[i]) {
            if (cnt[i] < k) {
              const int64_t r = row0 + tid + i * HT;
              sidx[((int64_t)blockIdx.y * rows + r) * k + cnt[i]] = col;
            }
            ++cnt[i];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < HR; ++i)
    if (rlive[i])
      scnt[(int64_t)blockIdx.y * rows + row0 + tid + i * HT] = cnt[i];
}

// One warp per row: the ranges' lists in range order, the first k kept,
// empty slots = u, the counts summed.  Lane i takes ranges i, i + 32, ...;
// a warp prefix sum over the ranges' counts places each range's entries.
// With one range, sidx/scnt may be idx/cnt themselves: lane 0 then copies
// range 0's entries onto themselves, and the fill writes past them.
__global__ void neighbor_merge_kernel(const int32_t* sidx,
                                      const int32_t* scnt,
                                      int32_t* idx, int32_t* cnt,
                                      int64_t rows, int64_t u, int k,
                                      int splits) {
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  int32_t* out = idx + r * k;
  int64_t total = 0;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int s = s0 + lane;
    const int64_t slot = (int64_t)s * rows + r;
    const int c = s < splits ? scnt[slot] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int64_t start = total + incl - c;
    const int32_t* src = sidx + slot * k;
    for (int j = 0; j < c && start + j < k; ++j) out[start + j] = src[j];
    total += __shfl_sync(0xffffffffu, incl, 31);
  }
  for (int64_t p = total + lane; p < k; p += 32) out[p] = (int32_t)u;
  if (lane == 0) cnt[r] = (int32_t)total;
}

int64_t split_columns(int64_t rows, int64_t u, int k, int sms) {
  const int64_t tiles = (u + HTILE - 1) / HTILE;
  if (tiles <= 1) return HTILE;
  const int64_t row_blocks = (rows + HROWS - 1) / HROWS;
  const int64_t want = ((int64_t)HBLOCKS_PER_SM * sms + row_blocks - 1) /
                       row_blocks;
  const int64_t room = HSCRATCH / (rows * (int64_t)(k > 0 ? k : 1));
  int64_t splits = want < tiles ? want : tiles;
  if (splits > room) splits = room;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  return (tiles + splits - 1) / splits * HTILE;
}

}  // namespace

extern "C" {

// Column ranges of a neighbor_lists launch (grid.y); the caller sizes its
// scratch ([splits, rows, k] and [splits, rows]) from it.
int ssq_neighbor_lists_splits(int64_t rows, int64_t u, int k, int sms) {
  if (rows == 0 || u == 0) return 1;
  const int64_t cols = split_columns(rows, u, k, sms);
  return (int)((u + cols - 1) / cols);
}

int ssq_neighbor_lists(const void* a_words, const void* a_len,
                       const void* a_gid, const void* a_rows,
                       const void* words, const void* len, const void* gid,
                       void* sidx, void* scnt, void* idx, void* cnt,
                       int64_t rows, int64_t u, int w, int threshold, int k,
                       int sms, void* stream) {
  if (rows == 0) return 0;
  if (w < 1 || w > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t cols = u ? split_columns(rows, u, k, sms) : HTILE;
  const int splits = u ? (int)((u + cols - 1) / cols) : 1;
  const dim3 grid((unsigned)((rows + HROWS - 1) / HROWS), (unsigned)splits);
  neighbor_lists_kernel<<<grid, HT, 0, s>>>(
      (const uint32_t*)a_words, (const int32_t*)a_len, (const int32_t*)a_gid,
      (const int32_t*)a_rows, (const uint32_t*)words, (const int32_t*)len,
      (const int32_t*)gid, (int32_t*)sidx, (int32_t*)scnt, rows, u, w,
      threshold, k, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256, rows_per_block = threads / 32;
  neighbor_merge_kernel<<<(unsigned)((rows + rows_per_block - 1) /
                                     rows_per_block),
                          threads, 0, s>>>((const int32_t*)sidx, (const int32_t*)scnt,
                                  (int32_t*)idx, (int32_t*)cnt, rows, u, k,
                                  splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
