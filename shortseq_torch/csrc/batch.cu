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
//                  _trim_words_ragged (one kernel: a static start is the
//                  ragged form with one start broadcast).
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
//
// Bound by HBM bytes: each output lane reads two source lanes of its row
// (the second is the next thread's first, so L1 serves it) and writes one.
// One thread per output lane, static and ragged starts alike: it gathers
// source lanes lane0 + j and lane0 + j + 1 (zero past W) and funnel-shifts
// them right by 2 * (start % 16), which is exact at shift 0 (where
// hi << 32 would be undefined), then keeps 2 * clip(len - 16 j, 0, 16)
// bits so the words stay canonical (zero past the new length).
// ---------------------------------------------------------------------------

__global__ void trim_words_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ new_lengths,
                                  uint32_t* __restrict__ out,
                                  int32_t* __restrict__ out_len, int64_t n,
                                  int w, int out_w) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * out_w) return;
  const int64_t row = t / out_w;
  const int j = (int)(t - row * out_w);
  const int start = max(starts[row], 0);
  const int64_t src = (int64_t)(start / 16) + j;
  const uint32_t* r = words + row * w;
  const uint32_t lo = src < w ? r[src] : 0u;
  const uint32_t hi = src + 1 < w ? r[src + 1] : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 2 * (start % 16));
  int len = min(max(new_lengths[row], 0), max(lengths[row] - start, 0));
  len = min(len, 16 * out_w);
  const int rem = min(max(len - 16 * j, 0), 16);
  const uint32_t mask = rem >= 16 ? ~0u : (1u << (2 * rem)) - 1u;
  out[t] = v & mask;
  if (j == 0) out_len[row] = len;
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
                   const void* new_lengths, void* out, void* out_len,
                   int64_t n, int w, int out_w, void* stream) {
  if (n == 0 || out_w == 0) return 0;
  const int threads = 256;
  const int64_t total = n * out_w;
  const dim3 grid((unsigned)((total + threads - 1) / threads));
  trim_words_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths,
      (const int32_t*)starts, (const int32_t*)new_lengths, (uint32_t*)out,
      (int32_t*)out_len, n, w, out_w);
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
