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
// Per lane c = a ^ b, ((c >> 1) | c) & 0x55555555, __popc, summed over
// the row.  Bound by HBM bytes: 8 B read per lane pair and 4 B written
// per row (the bound's ceil(W / 2) popcounts a row take ~1/20 of that
// time).  A byte-bound kernel falls short when too few bytes are in
// flight, so G takes kernel A's validate layout: threads flat over words,
// a block owning a run of block_rows rows (a multiple of 4, about
// kHamBlockWords words), so no row crosses a block: no reduction across
// blocks, no global atomic, no memset, one launch a call.  Each thread
// issues kHamLoads 16-byte streaming loads of a and as many of b before
// it uses any (32 B of each operand in flight a thread).  A group of 4
// words spans at most 2 rows when W >= 4 (4 rows at W = 1): its row comes
// from one float multiply (exact below 2^20 words a block, as in kernel
// A), its popcounts are summed per row in registers, and each nonzero sum
// is added to its row's sum in shared memory.  After one barrier the
// block's sums leave as 16-byte streaming stores.  With block_rows % 4 ==
// 0, a block's spans of a, b and out start on 16 bytes whenever the base
// pointers do; otherwise (a row slice such as b[1:] at W = 10) the
// instance with 4-byte loads and stores runs the same code.  The last
// block's words past a multiple of 4 load one by one.  Measured on the
// H100 (PERF.md): 128 threads x 4 loads, 64 x 4 on 1024-word blocks, 256
// x 4 and 128 x 4 on 4096-word blocks, and the loads issued before the
// barrier that zeroes the sums all came within 2% of this shape; a
// warp-segmented reduction of the row sums (__match_any_sync,
// __reduce_add_sync) was 20% slower at W = 10, and loads without the
// streaming hint or with an L2::256B prefetch hint 3-9% slower.
// ---------------------------------------------------------------------------

constexpr int kHamThreads = 256;
constexpr int kHamLoads = 2;  // 4-word groups of each operand in flight
constexpr int kHamBlockWords = 2048;  // words of a block's rows, about

// Rows a block of G owns at width w: a multiple of 4, at least 4.
int hamming_block_rows(int w) {
  const int rows = kHamBlockWords / (w > 0 ? w : 1) / 4 * 4;
  return rows < 4 ? 4 : rows;
}

// Words p .. p + 3 of a block's span x (p a multiple of 4): one 16-byte
// load when kVec, else four 4-byte loads; words at or past nw read as 0.
template <bool kVec>
__device__ __forceinline__ uint4 load_group(const uint32_t* __restrict__ x,
                                            int p, int nw) {
  if (p + 4 <= nw) {
    if (kVec) return __ldcs(reinterpret_cast<const uint4*>(x + p));
    return make_uint4(__ldg(x + p), __ldg(x + p + 1), __ldg(x + p + 2),
                      __ldg(x + p + 3));
  }
  return make_uint4(p < nw ? __ldg(x + p) : 0u,
                    p + 1 < nw ? __ldg(x + p + 1) : 0u,
                    p + 2 < nw ? __ldg(x + p + 2) : 0u, 0u);
}

__device__ __forceinline__ int lane_distance(uint32_t a, uint32_t b) {
  const uint32_t c = a ^ b;
  return __popc(((c >> 1) | c) & 0x55555555u);
}

template <bool kVec>
__global__ void __launch_bounds__(kHamThreads)
    hamming_rows_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        int32_t* __restrict__ out, int64_t n, int w,
                        int block_rows) {
  extern __shared__ __align__(16) int s_sum[];  // [block_rows]
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * block_rows;
  const int rows = (int)min((int64_t)block_rows, n - row0);
  const int nw = rows * w;
  const bool fast_div = nw < (1 << 20);
  const float inv_w = 1.0f / (float)w;
  const uint32_t* ba = a + row0 * w;
  const uint32_t* bb = b + row0 * w;
  for (int r = tid; r < rows; r += kHamThreads) s_sum[r] = 0;
  __syncthreads();
  for (int base = 0; base < nw; base += 4 * kHamThreads * kHamLoads) {
    uint4 va[kHamLoads], vb[kHamLoads];
#pragma unroll
    for (int k = 0; k < kHamLoads; ++k) {
      const int p = base + 4 * (k * kHamThreads + tid);
      if (p < nw) {
        va[k] = load_group<kVec>(ba, p, nw);
        vb[k] = load_group<kVec>(bb, p, nw);
      }
    }
#pragma unroll
    for (int k = 0; k < kHamLoads; ++k) {
      const int p = base + 4 * (k * kHamThreads + tid);
      if (p >= nw) continue;
      int r = fast_div ? __float2int_rz((p + 0.5f) * inv_w) : p / w;
      int j = p - r * w;
      const int d[4] = {lane_distance(va[k].x, vb[k].x),
                        lane_distance(va[k].y, vb[k].y),
                        lane_distance(va[k].z, vb[k].z),
                        lane_distance(va[k].w, vb[k].w)};
      // Words past nw are 0 in both operands: they add nothing to any row.
      int s = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s += d[e];
        if (++j == w) {
          if (s) atomicAdd(s_sum + r, s);
          s = 0;
          j = 0;
          ++r;
        }
      }
      if (s) atomicAdd(s_sum + r, s);
    }
  }
  __syncthreads();
  int32_t* dst = out + row0;
  if (kVec) {
    for (int q = tid; 4 * q < rows; q += kHamThreads) {
      const int o = 4 * q;
      if (o + 4 <= rows) {
        __stcs(reinterpret_cast<int4*>(dst + o),
               *reinterpret_cast<const int4*>(s_sum + o));
      } else {
        for (int e = o; e < rows; ++e) dst[e] = s_sum[e];
      }
    }
  } else {
    for (int r = tid; r < rows; r += kHamThreads) __stcs(dst + r, s_sum[r]);
  }
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

int ssq_hamming_block_rows(int w) { return hamming_block_rows(w); }

int ssq_hamming_rows(const void* a, const void* b, void* out, int64_t n,
                     int w, void* stream) {
  if (n == 0) return 0;
  const int block_rows = hamming_block_rows(w);
  const dim3 grid((unsigned)((n + block_rows - 1) / block_rows));
  const size_t smem = (size_t)block_rows * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  auto av = (const uint32_t*)a;
  auto bv = (const uint32_t*)b;
  auto ov = (int32_t*)out;
  // 16-byte loads and stores only when every base pointer allows them.
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) % 16 == 0)
    hamming_rows_kernel<true><<<grid, kHamThreads, smem, s>>>(
        av, bv, ov, n, w, block_rows);
  else
    hamming_rows_kernel<false><<<grid, kHamThreads, smem, s>>>(
        av, bv, ov, n, w, block_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
