// Hand-written Hopper kernels of shortseq_torch's batch slice
// (PackedBatch: decode, trim, row hamming).
//
// Built with the other sources of this directory into one shared library
// with a plain C interface (shortseq_torch/_build.py) and bound with
// ctypes.  Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() after its launch.
//
// Lanes as in kernels.cu: nucleotide i of a row lives in lane i / 16 at
// bits 2 * (i % 16); codes A=0 C=1 T=2 G=3.
//
// E: unpack_ascii  replaces shortseq_tpu/ops/bitpack.py unpack_ascii.
// F: trim_words    replaces shortseq_tpu/batch.py _trim_words and
//                  _trim_words_ragged (one kernel: a static start and
//                  length are scalar arguments, ragged ones [N] arrays).
// G: hamming_rows  replaces shortseq_tpu/ops/hamming.py hamming_rows.
// All three are bound by HBM bytes; the notes say what each moves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// E: packed words -> ASCII, [N, W] uint32 -> [N, 16 W] uint8.
//
// Bound by HBM writes: 16 B written per 4 B read.  One thread per word:
// it reads 4 B and writes its 16 bytes as one 16-byte store (output byte
// 16 j + i of a row is nucleotide i of lane j, so word k of the flat
// input maps to uint4 k of the flat output).  Each byte comes from the
// constant 0x47544341 >> (8 * code) ("ACTG", little-endian): no table in
// memory and no branch.
// ---------------------------------------------------------------------------

constexpr uint32_t kCharmap = 0x47544341u;  // 'A' 'C' 'T' 'G'

// The 4 codes in the low 8 bits of w -> their 4 ASCII bytes.
__device__ __forceinline__ uint32_t ascii4(uint32_t w) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t code = (w >> (2 * k)) & 3u;
    r |= ((kCharmap >> (8 * code)) & 0xFFu) << (8 * k);
  }
  return r;
}

__global__ void unpack_ascii_kernel(const uint32_t* __restrict__ words,
                                    uint4* __restrict__ out, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t w = words[i];
  out[i] = make_uint4(ascii4(w), ascii4(w >> 8), ascii4(w >> 16),
                      ascii4(w >> 24));
}

// ---------------------------------------------------------------------------
// F: per-row subsequence on packed lanes, [N, W] -> [N, out_w] uint32
// plus [N] new lengths.  Row r becomes seq[start : start + len] with
// start = max(starts[r], 0) and len clamped to the row and to 16 out_w.
// With `starts` (or `new_lengths`) null, one scalar start (or length)
// serves every row, as in the JAX package's static _trim_words: no [N]
// tensor is built or read for it.
//
// Output lane j of a row is source lanes s / 16 + j and s / 16 + j + 1
// (zero past W) funnel-shifted right by 2 * (s % 16), which is exact at
// shift 0 (where hi << 32 would be undefined), keeping 2 * clip(len -
// 16 j, 0, 16) bits so the words stay canonical (zero past the new
// length).
//
// Bound by HBM bytes: the rows' words and lengths (and per-row starts and
// lengths when ragged) read once, out_w words and a length a row written
// once; a few integer ops a word.  At these bytes a word, instructions
// set the pace (a 64-bit division, three parameter loads and a 4-byte
// store a word cost a thread-per-word layout 2x its bound), so a block
// owns a run of rows (a multiple of 4, so its contiguous [rows, out_w]
// output span starts on 16 bytes) and each thread builds 4 consecutive
// words of that span, stored as one 16-byte streaming store: row and
// lane come from one 32-bit division a thread, then step; a row's
// parameters are loaded once per thread that touches it, right beside
// its source words (L1 serves a row's words to its neighbouring
// threads), with no shared memory and no barrier.  Measured on the H100
// (PERF.md): staging each block's rows in shared memory with 16-byte
// loads, then building the words after one barrier, was 35% slower;
// reusing a word's high source lane as the next word's low one (5 loads
// for 4 words) chained the loads and was 7% slower.
// ---------------------------------------------------------------------------

constexpr int kTrimThreads = 256;

// (start, new length) of one row.
__device__ __forceinline__ int2 trim_params(
    int64_t row, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ new_lengths, int start_all, int len_all,
    int out_w) {
  const int s = max(starts ? starts[row] : start_all, 0);
  const int want = new_lengths ? new_lengths[row] : len_all;
  const int len = min(min(max(want, 0), max(lengths[row] - s, 0)), 16 * out_w);
  return make_int2(s, len);
}

// Output lane j of a row whose source lanes are rw[0 .. w).
__device__ __forceinline__ uint32_t trim_lane(const uint32_t* rw, int w,
                                              int s, int len, int j) {
  const int src = (s >> 4) + j;
  const uint32_t lo = src < w ? rw[src] : 0u;
  const uint32_t hi = src + 1 < w ? rw[src + 1] : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 2 * (s & 15));
  const int rem = min(max(len - 16 * j, 0), 16);
  return v & (rem >= 16 ? ~0u : (1u << (2 * rem)) - 1u);
}

__global__ void __launch_bounds__(kTrimThreads)
    trim_words_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ new_lengths, int start_all,
                      int len_all, uint32_t* __restrict__ out,
                      int32_t* __restrict__ out_len, int64_t n, int w,
                      int out_w, int block_rows) {
  const int64_t row0 = (int64_t)blockIdx.x * block_rows;
  const int rows = (int)min((int64_t)block_rows, n - row0);
  const int no = rows * out_w;
  uint32_t* dst = out + row0 * out_w;
  for (int q = threadIdx.x; 4 * q < no; q += kTrimThreads) {
    const int o = 4 * q;
    int r = o / out_w, j = o - r * out_w;
    int2 p = trim_params(row0 + r, lengths, starts, new_lengths, start_all,
                         len_all, out_w);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = 0u;
      if (r < rows) {
        if (j == 0) out_len[row0 + r] = p.y;
        v[e] = trim_lane(words + (row0 + r) * w, w, p.x, p.y, j);
      }
      if (++j == out_w) {
        j = 0;
        if (++r < rows)
          p = trim_params(row0 + r, lengths, starts, new_lengths, start_all,
                          len_all, out_w);
      }
    }
    if (o + 4 <= no) {
      __stcs(reinterpret_cast<uint4*>(dst + o), make_uint4(v[0], v[1], v[2], v[3]));
    } else {
      for (int e = 0; o + e < no; ++e) dst[o + e] = v[e];
    }
  }
}

// ---------------------------------------------------------------------------
// G: row-wise hamming, [N, W] x [N, W] uint32 -> [N] int32.
//
// Bound by HBM reads (8 B per lane pair, 4 B written per row).  Kernel A's
// layout: a group of G = min(32, pow2 >= W) neighbouring lanes of a warp
// per row, so a warp's loads are contiguous; each lane takes
// c = a ^ b, ((c >> 1) | c) & 0x55555555, __popc, and the group sums by
// __shfl_xor_sync - no shared memory, no atomics.
// ---------------------------------------------------------------------------

template <int G>
__global__ void hamming_rows_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    int32_t* __restrict__ out, int64_t n,
                                    int w) {
  const int sub = threadIdx.x & (G - 1);
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  int sum = 0;
  if (row < n) {
    for (int j = sub; j < w; j += G) {
      uint32_t c = a[row * w + j] ^ b[row * w + j];
      c = ((c >> 1) | c) & 0x55555555u;
      sum += __popc(c);
    }
  }
  // Every lane of the warp reaches the shuffles (rows past n carry 0).
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n && sub == 0) out[row] = sum;
}

}  // namespace

extern "C" {

int ssq_unpack_ascii(const void* words, void* out, int64_t total,
                     void* stream) {
  if (total == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((total + threads - 1) / threads));
  unpack_ascii_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint4*)out, total);
  return (int)cudaGetLastError();
}

int ssq_trim_words(const void* words, const void* lengths, const void* starts,
                   const void* new_lengths, int start, int length, void* out,
                   void* out_len, int64_t n, int w, int out_w, void* stream) {
  if (n == 0 || out_w <= 0) return 0;
  // The 16-byte stores need an aligned output, which the wrapper allocates.
  if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  // Rows a block: a multiple of 4 (so each block's output span starts on
  // 16 bytes), ~2048 source words and at most 4096 output words.
  int block_rows = 2048 / (w > 0 ? w : 1);
  if (block_rows > 4096 / out_w) block_rows = 4096 / out_w;
  block_rows = block_rows / 4 * 4;
  if (block_rows < 4) block_rows = 4;
  const int64_t blocks = (n + block_rows - 1) / block_rows;
  trim_words_kernel<<<(unsigned)blocks, kTrimThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (const int32_t*)starts,
      (const int32_t*)new_lengths, start, length, (uint32_t*)out,
      (int32_t*)out_len, n, w, out_w, block_rows);
  return (int)cudaGetLastError();
}

int ssq_hamming_rows(const void* a, const void* b, void* out, int64_t n,
                     int w, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  int g = 1;
  while (g < w && g < 32) g <<= 1;
  const int64_t rows_per_block = threads / g;
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block));
  cudaStream_t s = (cudaStream_t)stream;
  auto av = (const uint32_t*)a;
  auto bv = (const uint32_t*)b;
  auto ov = (int32_t*)out;
  switch (g) {
    case 1: hamming_rows_kernel<1><<<grid, threads, 0, s>>>(av, bv, ov, n, w); break;
    case 2: hamming_rows_kernel<2><<<grid, threads, 0, s>>>(av, bv, ov, n, w); break;
    case 4: hamming_rows_kernel<4><<<grid, threads, 0, s>>>(av, bv, ov, n, w); break;
    case 8: hamming_rows_kernel<8><<<grid, threads, 0, s>>>(av, bv, ov, n, w); break;
    case 16: hamming_rows_kernel<16><<<grid, threads, 0, s>>>(av, bv, ov, n, w); break;
    default: hamming_rows_kernel<32><<<grid, threads, 0, s>>>(av, bv, ov, n, w); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
