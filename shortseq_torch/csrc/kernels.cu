// Hand-written Hopper kernels of shortseq_torch's UMI slice.
//
// Built by nvcc for sm_90a into one shared library with a plain C
// interface (shortseq_torch/_build.py) and bound with ctypes.  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() after its launch so the Python wrapper can raise.
//
// Packed words travel as uint32 lanes: nucleotide i of a row lives in lane
// i / 16 at bits 2 * (i % 16), code = (ascii >> 1) & 3 (A=0 C=1 T=2 G=3).
//
// A: pack_validate     replaces shortseq_tpu/ops/bitpack.py
//                      pack_and_validate_folded (fold = 1); with ok ==
//                      nullptr it is the pack-only mode that replaces
//                      pack_words_u32 / pack_folded / pack_rows.
// B: pairwise_hamming  replaces shortseq_tpu/ops/pallas_kernels.py
//                      _pairwise_tiled (the repo's one pallas_call).
// C: neighbor_extract  replaces shortseq_tpu/umi/dedup.py _adjacency_score
//                      + _extract_ascending.
// Each kernel's note below says what bounds it on the H100 and what its
// design does about that.  These are the simple, right first versions: no
// TMA, no wgmma, no persistent blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// A: pack + validate.
//
// Bound by HBM bytes: it reads 1 B per nucleotide and writes 0.25 B (plus
// one ok byte per row); the arithmetic is ~20 integer ops per 4 bytes.  So
// the design is one read and one write, with no dot and no second pass:
// each thread loads one 16-byte vector (16 nucleotides = one output word),
// packs and validates it in registers and stores one word.  A row's words
// go to a group of G = min(32, pow2 >= W) neighbouring lanes of a warp, so
// a warp's loads are contiguous, and the row's ok flag is an OR of the
// group's fail bits by warp shuffles - no shared memory, no atomics.
// Pack-only mode (VALIDATE = false, selected by ok == nullptr) makes the
// same loads and stores with no bloom test, no length read and no ok
// store: the codes of every lane are written whatever the bytes, so zero
// padding packs to code 0 as in the JAX package's pack_rows.
// ---------------------------------------------------------------------------

// 4 ASCII bytes of a lane -> their 4 two-bit codes in the low byte.
__device__ __forceinline__ uint32_t codes_byte(uint32_t x) {
  uint32_t c = (x >> 1) & 0x03030303u;
  return (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFFu;
}

// 0x40 in each byte that fails the reference bloom, i.e. whose (c & 63)
// differs from the canonical byte rebuilt from its own code: codes
// {0, 1, 2, 3} map to {1, 3, 20, 7} = 1 + 2 * code, plus 15 for code 2.
// Every byte of `diff` is < 0x40, so adding 0x3F sets bit 6 iff the byte is
// nonzero, with no carry into the next byte.
__device__ __forceinline__ uint32_t bloom_fail_bits(uint32_t x) {
  uint32_t c = (x >> 1) & 0x03030303u;
  uint32_t t = c << 1;
  uint32_t is2 = (c & ~t) & 0x02020202u;
  uint32_t expect = (0x01010101u + t + (is2 << 3)) - (is2 >> 1);
  uint32_t diff = (x & 0x3F3F3F3Fu) ^ expect;
  return (diff + 0x3F3F3F3Fu) & 0x40404040u;
}

// Fail-bit mask of the bytes of a lane that lie before the row's length,
// from rem = bytes of the row left at this lane's first byte.
__device__ __forceinline__ uint32_t tail_mask(int rem) {
  if (rem >= 4) return 0x40404040u;
  if (rem <= 0) return 0u;
  return 0x40404040u >> (8 * (4 - rem));
}

template <int G, bool VALIDATE>
__global__ void pack_validate_kernel(const uint4* __restrict__ x,
                                     const int32_t* __restrict__ lengths,
                                     uint32_t* __restrict__ words,
                                     uint8_t* __restrict__ ok, int64_t n,
                                     int w, int pad_valid) {
  const int sub = threadIdx.x & (G - 1);
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  uint32_t bad = 0;
  if (row < n) {
    const int len = VALIDATE ? lengths[row] : 0;
    for (int j = sub; j < w; j += G) {
      const uint4 v = x[row * w + j];
      const uint32_t lane[4] = {v.x, v.y, v.z, v.w};
      uint32_t out = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (VALIDATE) {
          uint32_t fail = bloom_fail_bits(lane[k]);
          if (!pad_valid) fail &= tail_mask(len - 16 * j - 4 * k);
          bad |= fail;
        }
        out |= codes_byte(lane[k]) << (8 * k);
      }
      words[row * w + j] = out;
    }
  }
  if (!VALIDATE) return;
  // Every lane of the warp reaches the shuffles (rows past n carry 0).
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  if (row < n && sub == 0) ok[row] = bad == 0 ? 1 : 0;
}

template <bool VALIDATE>
void launch_pack(int g, dim3 grid, int threads, cudaStream_t s,
                 const uint4* x, const int32_t* lengths, uint32_t* words,
                 uint8_t* ok, int64_t n, int w, int pad_valid) {
  switch (g) {
    case 1: pack_validate_kernel<1, VALIDATE><<<grid, threads, 0, s>>>(x, lengths, words, ok, n, w, pad_valid); break;
    case 2: pack_validate_kernel<2, VALIDATE><<<grid, threads, 0, s>>>(x, lengths, words, ok, n, w, pad_valid); break;
    case 4: pack_validate_kernel<4, VALIDATE><<<grid, threads, 0, s>>>(x, lengths, words, ok, n, w, pad_valid); break;
    case 8: pack_validate_kernel<8, VALIDATE><<<grid, threads, 0, s>>>(x, lengths, words, ok, n, w, pad_valid); break;
    case 16: pack_validate_kernel<16, VALIDATE><<<grid, threads, 0, s>>>(x, lengths, words, ok, n, w, pad_valid); break;
    default: pack_validate_kernel<32, VALIDATE><<<grid, threads, 0, s>>>(x, lengths, words, ok, n, w, pad_valid); break;
  }
}

// ---------------------------------------------------------------------------
// B: all-pairs hamming, [N, W] x [M, W] uint32 -> [N, M] int32.
//
// Per lane: c = a ^ b; c = ((c >> 1) | c) & 0x55555555; popcount; summed
// over the W lanes.  At the slice's width (W = 2, 12-nt UMIs) a pair costs
// 2 popcounts but writes a 4-byte result, so the int32 store stream to HBM,
// not the popcounts, bounds the kernel; only at W = 64 does __popc
// throughput (16 per SM per clock) take over.  Design: a 16x16-thread
// block owns a 64x64 output tile; lanes are staged through shared memory
// in steps of 16 (lane-major, so a warp reads 16 consecutive B rows
// without bank conflicts and broadcasts A), and each thread keeps a 4x4
// register tile of sums.  Stores go out as 64-byte runs of consecutive
// columns.  The ragged edge is masked here, so callers pad nothing.
// Fusing kernel C into this epilogue, so the slab never reaches HBM, is
// left for later.
// ---------------------------------------------------------------------------

constexpr int PT = 64;   // output tile edge
constexpr int PK = 16;   // lanes staged per step
constexpr int PR = 4;    // register tile edge per thread (PT / 16)

__global__ void pairwise_hamming_kernel(const uint32_t* __restrict__ a,
                                        const uint32_t* __restrict__ b,
                                        int32_t* __restrict__ out, int64_t n,
                                        int64_t m, int w) {
  __shared__ uint32_t as[PK][PT];
  __shared__ uint32_t bs[PK][PT];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int64_t row0 = (int64_t)blockIdx.y * PT;
  const int64_t col0 = (int64_t)blockIdx.x * PT;
  int acc[PR][PR];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PR; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += PK) {
    const int kn = min(PK, w - k0);
    for (int e = tid; e < PT * PK; e += 256) {
      const int r = e / PK, k = e % PK;
      uint32_t va = 0, vb = 0;
      if (k < kn) {
        if (row0 + r < n) va = a[(row0 + r) * w + k0 + k];
        if (col0 + r < m) vb = b[(col0 + r) * w + k0 + k];
      }
      as[k][r] = va;
      bs[k][r] = vb;
    }
    __syncthreads();
    for (int k = 0; k < kn; ++k) {
      uint32_t av[PR], bv[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < PR; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PR; ++j) {
          uint32_t c = av[i] ^ bv[j];
          c = ((c >> 1) | c) & 0x55555555u;
          acc[i][j] += __popc(c);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < PR; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (c < m) out[r * m + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// C: neighbour extraction from a [rows, U] distance slab.
//
// A neighbour of row r is a column c with dist <= threshold, equal length,
// equal group id and c != a_rows[r].  Output: idx[r, :k] = the first k
// neighbour columns in ascending order, empty slots = U; cnt[r] = the true
// neighbour count (may exceed k: the caller's overflow tier re-extracts).
// Same (idx, cnt) as the JAX package's max-extraction, which needed k
// rounds over 128-column segment maxima because TPU top_k is a sort.
//
// Bound by HBM bytes: one read of the int32 slab (lengths and gids are
// re-read by every row but stay in L2).  Design: one warp per row walks
// its columns in order, 128 per step as four coalesced 32-column loads
// issued before any is used (memory-level parallelism for a loop that is
// otherwise latency bound); each 32-column chunk becomes a __ballot_sync
// mask whose __popc prefix places the lane's hit, so writes come out in
// ascending column order with no sort and no second pass.
// ---------------------------------------------------------------------------

constexpr int NX_CHUNKS = 4;

__global__ void neighbor_extract_kernel(
    const int32_t* __restrict__ dist, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ a_gid, const int32_t* __restrict__ a_rows,
    const int32_t* __restrict__ len, const int32_t* __restrict__ gid,
    int32_t* __restrict__ idx, int32_t* __restrict__ cnt, int64_t rows,
    int64_t u, int threshold, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp shares `row`
  const int32_t* drow = dist + row * u;
  const int alen = a_len[row];
  const int agid = a_gid[row];
  const int64_t self = a_rows[row];
  int32_t* out = idx + row * k;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int64_t c0 = 0; c0 < u; c0 += 32 * NX_CHUNKS) {
    int d[NX_CHUNKS], l[NX_CHUNKS], g[NX_CHUNKS];
#pragma unroll
    for (int j = 0; j < NX_CHUNKS; ++j) {
      const int64_t col = c0 + 32 * j + lane;
      const bool in = col < u;
      d[j] = in ? drow[col] : threshold + 1;
      l[j] = in ? len[col] : 0;
      g[j] = in ? gid[col] : 0;
    }
#pragma unroll
    for (int j = 0; j < NX_CHUNKS; ++j) {
      const int64_t col = c0 + 32 * j + lane;
      const bool hit =
          d[j] <= threshold && l[j] == alen && g[j] == agid && col != self;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      const int pos = count + __popc(mask & below);
      if (hit && pos < k) out[pos] = (int32_t)col;
      count += __popc(mask);
    }
  }
  for (int p = count + lane; p < k; p += 32) out[p] = (int32_t)u;
  if (lane == 0) cnt[row] = count;
}

}  // namespace

extern "C" {

const char* ssq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ssq_pack_validate(const void* x, const void* lengths, void* words,
                      void* ok, int64_t n, int w, int pad_valid,
                      void* stream) {
  if (n == 0 || w == 0) return 0;
  const int threads = 256;
  int g = 1;
  while (g < w && g < 32) g <<= 1;
  const int64_t rows_per_block = threads / g;
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block));
  cudaStream_t s = (cudaStream_t)stream;
  auto xv = (const uint4*)x;
  auto lv = (const int32_t*)lengths;
  auto wv = (uint32_t*)words;
  auto ov = (uint8_t*)ok;
  // ok == nullptr: pack-only mode (lengths and pad_valid are not read).
  if (ov == nullptr)
    launch_pack<false>(g, grid, threads, s, xv, lv, wv, ov, n, w, pad_valid);
  else
    launch_pack<true>(g, grid, threads, s, xv, lv, wv, ov, n, w, pad_valid);
  return (int)cudaGetLastError();
}

int ssq_pairwise_hamming(const void* a, const void* b, void* out, int64_t n,
                         int64_t m, int w, void* stream) {
  if (n == 0 || m == 0) return 0;
  const dim3 threads(16, 16);
  const dim3 grid((unsigned)((m + PT - 1) / PT), (unsigned)((n + PT - 1) / PT));
  pairwise_hamming_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, n, m, w);
  return (int)cudaGetLastError();
}

int ssq_neighbor_extract(const void* dist, const void* a_len,
                         const void* a_gid, const void* a_rows,
                         const void* len, const void* gid, void* idx,
                         void* cnt, int64_t rows, int64_t u, int threshold,
                         int k, void* stream) {
  if (rows == 0) return 0;
  const int threads = 256;
  const int64_t rows_per_block = threads / 32;
  const dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block));
  neighbor_extract_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dist, (const int32_t*)a_len, (const int32_t*)a_gid,
      (const int32_t*)a_rows, (const int32_t*)len, (const int32_t*)gid,
      (int32_t*)idx, (int32_t*)cnt, rows, u, threshold, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
