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
//                      + _extract_ascending on a distance slab from B (the
//                      overflow tier of _neighbor_lists; its main pass
//                      runs kernel H, csrc/umi.cu, with no slab).
// Each kernel's note below says what bounds it on the H100 and what its
// design does about that.  None uses TMA, wgmma or persistent blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// A: pack + validate.
//
// Bound by HBM bytes: it reads 1 B per nucleotide and writes 0.25 B (plus
// the row's length in and one ok byte out when validating); the
// arithmetic is ~20 integer ops per 4 bytes, far below the card's rate.
// So the design is one read and one write, with no dot and no second
// pass, and what matters is keeping enough bytes in flight with no idle
// threads.  Both modes map threads FLAT onto the N * W output words (one
// 16-byte input vector of 16 nucleotides per word), never a row group,
// so no width leaves threads idle (a power-of-two group per row idled 6
// of 16 threads at the 10-word rows of 150-nt reads), and each thread
// issues several 16-byte loads before it uses any.
//
// Pack-only mode (pack_words_kernel, selected by ok == nullptr) has no
// per-row reduction at all: each thread of a grid-stride loop loads 4
// consecutive input vectors (64 B in flight) and writes their 4 words as
// one 16-byte store; the ragged tail of N * W % 4 words stores word by
// word.  No bloom test, no length read: every lane's codes are written
// whatever its bytes, so zero padding packs to code 0 as in the JAX
// package's pack_rows.
//
// Validate mode (pack_validate_kernel): a block owns R whole rows, R * W
// ~ 1024 words (512 or 256 when that leaves fewer than 4 blocks an SM),
// and its threads walk those words flat, 4 issued at once (a coalesced
// 512 B per warp each), so a row's words may fall to several threads.
// Each word's load goes out with its row's length load (one round trip;
// neighbouring words hit the same length in L1); a word's fail bits OR
// into its row's flag in shared memory (atomicOr, only when a byte
// fails); after one barrier a thread per row writes ok.  A block has a
// thread a word up to 256 words, else 256 threads; no block launches a
// warp more than its words need.
// ---------------------------------------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kPackLoads = 4;        // 16-byte loads a thread issues at once
constexpr int kPackBlockWords = kPackThreads * kPackLoads;

// 4 ASCII bytes of a lane -> their 4 two-bit codes in the low byte.
__device__ __forceinline__ uint32_t codes_byte(uint32_t x) {
  uint32_t c = (x >> 1) & 0x03030303u;
  return (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFFu;
}

// 16 ASCII bytes -> their output word (16 codes, LSB first).
__device__ __forceinline__ uint32_t pack_vector(uint4 v) {
  return codes_byte(v.x) | (codes_byte(v.y) << 8) | (codes_byte(v.z) << 16) |
         (codes_byte(v.w) << 24);
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

__global__ void __launch_bounds__(kPackThreads)
    pack_words_kernel(const uint4* __restrict__ x,
                      uint32_t* __restrict__ words, int64_t total) {
  const int64_t groups = total / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint4* out = reinterpret_cast<uint4*>(words);
  for (int64_t g = first; g < groups; g += stride) {
    const uint4* src = x + 4 * g;
    const uint4 a = __ldcs(src), b = __ldcs(src + 1), c = __ldcs(src + 2),
                d = __ldcs(src + 3);
    out[g] = make_uint4(pack_vector(a), pack_vector(b), pack_vector(c),
                        pack_vector(d));
  }
  const int64_t tail = 4 * groups + first;
  if (tail < total) words[tail] = pack_vector(__ldcs(x + tail));
}

__global__ void __launch_bounds__(kPackThreads)
    pack_validate_kernel(const uint4* __restrict__ x,
                         const int32_t* __restrict__ lengths,
                         uint32_t* __restrict__ words,
                         uint8_t* __restrict__ ok, int64_t n, int w,
                         int block_rows, int pad_valid) {
  extern __shared__ uint32_t s_bad[];  // [block_rows]
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const float inv_w = 1.0f / (float)w;
  const int64_t row0 = (int64_t)blockIdx.x * block_rows;
  const int rows = (int)min((int64_t)block_rows, n - row0);
  const int nw = rows * w;
  const uint4* src = x + row0 * w;
  uint32_t* dst = words + row0 * w;
  for (int r = tid; r < rows; r += threads) s_bad[r] = 0;
  __syncthreads();
  for (int base = 0; base < nw; base += threads * kPackLoads) {
    // Each word's 16 bytes and its row's length load together: one round
    // trip to memory (a row's length serves its neighbouring words from
    // L1).  Row of word p: (p + 0.5) / w in float is exact for p < 2^20
    // (the quotient lies >= 0.5 / w from an integer); a block of one row
    // has only row 0.
    uint4 v[kPackLoads];
    int r[kPackLoads], len[kPackLoads];
#pragma unroll
    for (int k = 0; k < kPackLoads; ++k) {
      const int p = base + k * threads + tid;
      r[k] = block_rows == 1 ? 0 : __float2int_rz((p + 0.5f) * inv_w);
      if (p < nw) {
        v[k] = __ldcs(src + p);
        if (!pad_valid) len[k] = __ldg(lengths + row0 + r[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPackLoads; ++k) {
      const int p = base + k * threads + tid;
      uint32_t bad = 0;
      if (p < nw) {
        dst[p] = pack_vector(v[k]);
        const uint32_t f0 = bloom_fail_bits(v[k].x),
                       f1 = bloom_fail_bits(v[k].y),
                       f2 = bloom_fail_bits(v[k].z),
                       f3 = bloom_fail_bits(v[k].w);
        bad = f0 | f1 | f2 | f3;
        if (bad && !pad_valid) {
          // Only bytes before the row's length count.
          const int rem = len[k] - 16 * (p - r[k] * w);
          if (rem < 16)
            bad = (f0 & tail_mask(rem)) | (f1 & tail_mask(rem - 4)) |
                  (f2 & tail_mask(rem - 8)) | (f3 & tail_mask(rem - 12));
        }
      }
      if (bad) atomicOr(s_bad + r[k], 1u);
    }
  }
  __syncthreads();
  for (int r = tid; r < rows; r += threads) ok[row0 + r] = s_bad[r] == 0;
}

// Threads for `items` items of work, a thread an item: rounded up to a
// warp, at most kPackThreads.
int item_threads(int64_t items) {
  const int64_t t = (items + 31) / 32 * 32;
  return (int)(t < kPackThreads ? t : kPackThreads);
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

// ---------------------------------------------------------------------------
// B: all-pairs hamming, [N, W] x [M, W] uint32 -> [N, M] int32.
//
// Per lane the reference takes c = a ^ b; ((c >> 1) | c) & 0x55555555;
// popcount; summed over the W lanes.  Here each pair of lanes is first
// rewritten as two bit planes (lane_planes; kernel H in umi.cu uses the
// same planes): P holds the low bit of each 2-bit field, Q the high bit, lane
// 2p's fields on the even bits and lane 2p+1's on the odd bits.  A field
// differs iff its bit differs in P or in Q, so one pair of lanes costs
// XOR, one LOP3 and ONE popcount: ceil(W / 2) popcounts per output.
//
// What bounds it, per width (H100 SXM: 3.35 TB/s of HBM; __popc at 16
// per SM per clock, 4.18e12/s on 132 SMs at 1.98 GHz): the int32 output
// written once costs 4 B / 3.35e12 = 1.19e-12 s per output, the popcounts
// 2.39e-13 s each, ceil(W / 2) per output.  So the store stream bounds
// W <= 8, the popcounts bound W >= 11, and at W = 9 and 10 (5 popcounts
// per output) the two lie within 1% of each other.
//
// Design: a 256-thread block owns a 128 x 128 output tile, 8 x 8 sums per
// thread in registers.  All lane pairs of the tile's 128 A rows and 128 B
// rows are staged at once as planes in dynamic shared memory (up to 32
// pairs = 64 lanes per stage; wider rows loop), plane-major: staging
// element e is row e % 128 of pair e / 128, so a warp's staging stores
// fill 32 consecutive words (no bank conflicts).  A thread reads its 8
// rows and 8 columns per lane pair as 16-byte vectors (two addresses per
// warp for A, broadcast; 16 consecutive vectors for B).  Its columns
// are two runs of 4 (tx * 4 and 64 + tx * 4), so each 16-byte streaming
// store (__stcs: a 1-2 GB slab must not evict the operands from L2) of a
// warp covers 256 consecutive bytes of a row.  Rows whose start is not
// 16-byte aligned (M % 4 != 0) and the ragged edge store word by word;
// callers pad nothing.
// ---------------------------------------------------------------------------

constexpr int PT = 128;         // output tile edge
constexpr int PR = 8;           // sums per thread along each edge
constexpr int PMAX_PAIRS = 32;  // lane pairs staged at once (64 lanes)

// Bit planes of lanes (lo, hi): P = low bits, Q = high bits of the 16
// fields of each, lo's on the even bits and hi's on the odd bits.
__device__ __forceinline__ uint2 lane_planes(uint32_t lo, uint32_t hi) {
  const uint32_t m = 0x55555555u;
  return make_uint2((lo & m) | ((hi & m) << 1),
                    ((lo >> 1) & m) | (hi & ~m));
}

__global__ void __launch_bounds__(256, 2)
    pairwise_hamming_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            int32_t* __restrict__ out, int64_t n, int64_t m,
                            int w) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int pairs = (w + 1) / 2;
  const int stage = min(pairs, PMAX_PAIRS);
  uint32_t* sa = smem;                   // [stage][P, Q][PT]
  uint32_t* sb = smem + stage * 2 * PT;  // the same for the B rows
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.y * PT;
  const int64_t col0 = (int64_t)blockIdx.x * PT;
  int acc[PR][PR];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PR; ++j) acc[i][j] = 0;

  for (int p0 = 0; p0 < pairs; p0 += stage) {
    const int np = min(stage, pairs - p0);
    if (p0) __syncthreads();  // the previous stage is consumed
    for (int e = tid; e < PT * np; e += 256) {
      const int r = e % PT, p = e / PT;
      const int l0 = 2 * (p0 + p), l1 = l0 + 1;
      uint32_t alo = 0, ahi = 0, blo = 0, bhi = 0;
      if (row0 + r < n) {
        const uint32_t* src = a + (row0 + r) * w;
        alo = src[l0];
        if (l1 < w) ahi = src[l1];
      }
      if (col0 + r < m) {
        const uint32_t* src = b + (col0 + r) * w;
        blo = src[l0];
        if (l1 < w) bhi = src[l1];
      }
      const uint2 pa = lane_planes(alo, ahi), pb = lane_planes(blo, bhi);
      sa[(2 * p) * PT + r] = pa.x;
      sa[(2 * p + 1) * PT + r] = pa.y;
      sb[(2 * p) * PT + r] = pb.x;
      sb[(2 * p + 1) * PT + r] = pb.y;
    }
    __syncthreads();
    for (int p = 0; p < np; ++p) {
      const uint32_t* ap = sa + 2 * p * PT + ty * PR;
      const uint32_t* bp = sb + 2 * p * PT + tx * 4;
      uint32_t aP[PR], aQ[PR], bP[PR], bQ[PR];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 x = *reinterpret_cast<const uint4*>(ap + 4 * h);
        const uint4 y = *reinterpret_cast<const uint4*>(ap + PT + 4 * h);
        const uint4 u = *reinterpret_cast<const uint4*>(bp + 64 * h);
        const uint4 v = *reinterpret_cast<const uint4*>(bp + PT + 64 * h);
        aP[4 * h] = x.x; aP[4 * h + 1] = x.y; aP[4 * h + 2] = x.z; aP[4 * h + 3] = x.w;
        aQ[4 * h] = y.x; aQ[4 * h + 1] = y.y; aQ[4 * h + 2] = y.z; aQ[4 * h + 3] = y.w;
        bP[4 * h] = u.x; bP[4 * h + 1] = u.y; bP[4 * h + 2] = u.z; bP[4 * h + 3] = u.w;
        bQ[4 * h] = v.x; bQ[4 * h + 1] = v.y; bQ[4 * h + 2] = v.z; bQ[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PR; ++j)
          acc[i][j] += __popc((aP[i] ^ bP[j]) | (aQ[i] ^ bQ[j]));
    }
  }
  // Sum j of a thread is column col0 + 64 * (j / 4) + 4 * tx + j % 4.
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int64_t r = row0 + ty * PR + i;
    if (r >= n) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = col0 + 64 * h + 4 * tx;
      int32_t* dst = out + r * m + c;
      if (c + 4 <= m && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        __stcs(reinterpret_cast<int4*>(dst),
               make_int4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                         acc[i][4 * h + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < m) __stcs(dst + j, acc[i][4 * h + j]);
      }
    }
  }
}

size_t pairwise_smem_bytes(int w) {
  const int pairs = (w + 1) / 2;
  const int stage = pairs < PMAX_PAIRS ? pairs : PMAX_PAIRS;
  return (size_t)stage * 2 * PT * 2 * sizeof(uint32_t);
}

// ---------------------------------------------------------------------------
// C: neighbour extraction from a [rows, U] distance slab (the overflow
// tier's re-extraction at a larger k; kernel H does the main pass).
//
// A neighbour of row r is a column c with dist <= threshold, equal length,
// equal group id and c != a_rows[r].  Output: idx[r, :k] = the first k
// neighbour columns in ascending order, empty slots = U; cnt[r] = the true
// neighbour count (may exceed k: the caller's overflow tier re-extracts).
// Same (idx, cnt) as the JAX package's max-extraction, which needed k
// rounds over 128-column segment maxima because TPU top_k is a sort.
//
// What bounds it: one read of the int32 slab (lengths and gids are
// re-read by every row but stay in L2).  On the overflow tier's slabs
// ([256-700, ~7400], written by kernel B just before and still in L2) no
// byte stream sets the pace: a warp that walks a whole row in order is a
// chain of dependent load rounds, and 256 rows are 256 warps for 132 SMs.
// So a row's columns are split into `segs` contiguous segments, one warp
// each (segs from the host, a power of two up to 8: at least 16 warps an
// SM, each segment >= 256 columns; 8 at [256, 7424], 4 at [706, 7424], 1
// at [2688, 102144], the fastest on the H100 of 1, 4, 8 and 16 at each),
// and each lane loads 4 columns of dist, length and gid as three 16-byte
// vectors, two 128-column chunks issued before either is used (0.75
// loads a column, not 3).  A chunk's hits become four __ballot_sync
// masks whose __popc prefixes place each lane's hits in ascending column
// order; a warp keeps its first k hits in its own slice of shared memory
// and its true count.  After one barrier each warp adds the counts of
// the row's earlier segments (its offset), copies its hits that land
// below k to idx[r, offset + i], and the row's warps fill the empty slots
// with U: one pass over the slab, ascending output, no sort.  With one
// segment a row (wide slabs with many rows, or a k whose slices would
// not fit) the warp writes its hits straight to idx.  Rows whose slab is
// not 16-byte aligned (U % 4 != 0, or an offset pointer) load one column
// a lane.
// ---------------------------------------------------------------------------

constexpr int NX_UNROLL = 2;      // chunks of 32 * V columns issued at once
constexpr int NX_MAX_SEGS = 8;    // warps a row at most, and a block

// Appends a lane's hits (bit j of h: column col + j) after the warp's
// `count` earlier ones: slots below cap go to dst; returns the new count.
template <int V>
__device__ __forceinline__ int nx_append(unsigned h, int64_t col, int count,
                                         int32_t* dst, int cap, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int pos = count, total = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const unsigned b = __ballot_sync(0xffffffffu, (h >> j) & 1u);
    pos += __popc(b & below);
    total += __popc(b);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if ((h >> j) & 1u) {
      if (pos < cap) dst[pos] = (int32_t)(col + j);
      ++pos;
    }
  }
  return count + total;
}

template <int V>
__global__ void __launch_bounds__(NX_MAX_SEGS * 32)
    neighbor_extract_kernel(const int32_t* __restrict__ dist,
                            const int32_t* __restrict__ a_len,
                            const int32_t* __restrict__ a_gid,
                            const int32_t* __restrict__ a_rows,
                            const int32_t* __restrict__ len,
                            const int32_t* __restrict__ gid,
                            int32_t* __restrict__ idx,
                            int32_t* __restrict__ cnt, int64_t rows,
                            int64_t u, int threshold, int k, int segs,
                            int64_t seg_cols, int buf) {
  extern __shared__ int32_t s_hits[];  // [warps][buf], then [warps] counts
  const int warps = blockDim.x / 32;
  const int wid = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int rb = wid / segs, seg = wid - rb * segs;
  const int64_t row = (int64_t)blockIdx.x * (warps / segs) + rb;
  int32_t* s_cnt = s_hits + warps * buf;
  int32_t* out = idx + row * k;
  int32_t* dst = segs == 1 ? out : s_hits + wid * buf;
  const int cap = segs == 1 ? k : min(buf, k);
  int count = 0;
  if (row < rows) {
    const int32_t* drow = dist + row * u;
    const int alen = a_len[row], agid = a_gid[row];
    const int64_t self = a_rows[row];
    const int64_t begin = seg * seg_cols;
    const int64_t end = min(u, begin + seg_cols);
    for (int64_t c0 = begin; c0 < end; c0 += 32 * V * NX_UNROLL) {
      int d[NX_UNROLL][V], l[NX_UNROLL][V], g[NX_UNROLL][V];
#pragma unroll
      for (int s = 0; s < NX_UNROLL; ++s) {
        const int64_t col = c0 + 32 * V * s + V * lane;
        bool vec = false;
        if constexpr (V == 4) {
          if (col + 4 <= end) {
            const int4 dv = __ldcs(reinterpret_cast<const int4*>(drow + col));
            const int4 lv = __ldg(reinterpret_cast<const int4*>(len + col));
            const int4 gv = __ldg(reinterpret_cast<const int4*>(gid + col));
            d[s][0] = dv.x; d[s][1] = dv.y; d[s][2] = dv.z; d[s][3] = dv.w;
            l[s][0] = lv.x; l[s][1] = lv.y; l[s][2] = lv.z; l[s][3] = lv.w;
            g[s][0] = gv.x; g[s][1] = gv.y; g[s][2] = gv.z; g[s][3] = gv.w;
            vec = true;
          }
        }
        if (!vec) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const bool in = col + j < end;
            d[s][j] = in ? __ldcs(drow + col + j) : threshold + 1;
            l[s][j] = in ? __ldg(len + col + j) : 0;
            g[s][j] = in ? __ldg(gid + col + j) : 0;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NX_UNROLL; ++s) {
        const int64_t col = c0 + 32 * V * s + V * lane;
        unsigned h = 0;
#pragma unroll
        for (int j = 0; j < V; ++j)
          h |= (unsigned)(d[s][j] <= threshold && l[s][j] == alen &&
                          g[s][j] == agid && col + j != self)
               << j;
        count = nx_append<V>(h, col, count, dst, cap, lane);
      }
    }
  }
  int total = count;
  if (segs > 1) {
    if (lane == 0) s_cnt[wid] = count;
    __syncthreads();
    if (row < rows) {
      int offset = 0;
      total = 0;
      for (int w = rb * segs; w < (rb + 1) * segs; ++w) {
        if (w < wid) offset += s_cnt[w];
        total += s_cnt[w];
      }
      const int n = min(min(count, cap), k - offset);
      for (int i = lane; i < n; i += 32) out[offset + i] = dst[i];
    }
  }
  if (row < rows) {
    for (int p = total + seg * 32 + lane; p < k; p += segs * 32)
      out[p] = (int32_t)u;
    if (seg == 0 && lane == 0) cnt[row] = total;
  }
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
  cudaStream_t s = (cudaStream_t)stream;
  auto xv = (const uint4*)x;
  auto wv = (uint32_t*)words;
  if (ok == nullptr) {
    // Pack-only mode (lengths and pad_valid are not read).  The 16-byte
    // stores need an aligned output, which the wrapper allocates.
    if ((uintptr_t)words % 16) return (int)cudaErrorMisalignedAddress;
    const int64_t total = n * w;
    const int64_t groups = (total + 3) / 4;
    const int threads = item_threads(groups);
    int64_t blocks = (groups + threads - 1) / threads;
    const int64_t most = (int64_t)sm_count() * (2048 / kPackThreads);
    if (blocks > most) blocks = most;
    pack_words_kernel<<<(unsigned)blocks, threads, 0, s>>>(xv, wv, total);
    return (int)cudaGetLastError();
  }
  // A block owns whole rows, about kPackBlockWords words of them, or a
  // half or a quarter of that while fewer than 4 blocks an SM would be
  // left.
  int64_t block_words = kPackBlockWords;
  while (block_words > kPackThreads &&
         n * w < (int64_t)sm_count() * 4 * block_words)
    block_words /= 2;
  const int block_rows = w >= block_words ? 1 : (int)(block_words / w);
  const int64_t blocks = (n + block_rows - 1) / block_rows;
  const int64_t first_rows = n < block_rows ? n : block_rows;
  // Up to kPackLoads words a thread: a block of 256 or 512 words (small
  // inputs) has more threads each with fewer loads.
  const int threads = item_threads(first_rows * w);
  const size_t smem = sizeof(uint32_t) * (size_t)block_rows;
  pack_validate_kernel<<<(unsigned)blocks, threads, smem, s>>>(
      xv, (const int32_t*)lengths, wv, (uint8_t*)ok, n, w, block_rows,
      pad_valid);
  return (int)cudaGetLastError();
}

int ssq_pairwise_hamming(const void* a, const void* b, void* out, int64_t n,
                         int64_t m, int w, void* stream) {
  if (n == 0 || m == 0) return 0;
  const size_t smem = pairwise_smem_bytes(w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairwise_hamming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((m + PT - 1) / PT), (unsigned)((n + PT - 1) / PT));
  pairwise_hamming_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, n, m, w);
  return (int)cudaGetLastError();
}

int ssq_neighbor_extract(const void* dist, const void* a_len,
                         const void* a_gid, const void* a_rows,
                         const void* len, const void* gid, void* idx,
                         void* cnt, int64_t rows, int64_t u, int threshold,
                         int k, int segs, void* stream) {
  if (rows == 0) return 0;
  const bool vec = u % 4 == 0 && (uintptr_t)dist % 16 == 0 &&
                   (uintptr_t)len % 16 == 0 && (uintptr_t)gid % 16 == 0;
  const int v = vec ? 4 : 1;
  if (segs <= 0) {
    // Segments a row (a power of two): at least 16 warps an SM, each
    // segment at least 256 columns.
    segs = 1;
    const int64_t target = (int64_t)sm_count() * 16;
    while (segs < NX_MAX_SEGS && rows * segs < target &&
           u >= (int64_t)512 * segs)
      segs *= 2;
  }
  segs = segs < NX_MAX_SEGS ? segs : NX_MAX_SEGS;
  int64_t seg_cols;
  int buf, warps;
  size_t smem;
  for (;;) {
    seg_cols = ((u + segs - 1) / segs + v - 1) / v * v;
    buf = (int)(seg_cols < k ? seg_cols : k);
    const int rows_per_block = segs < NX_MAX_SEGS ? NX_MAX_SEGS / segs : 1;
    warps = rows_per_block * segs;
    smem = segs == 1 ? 0 : sizeof(int32_t) * (size_t)warps * (buf + 1);
    if (segs == 1 || smem <= 48 * 1024) break;
    segs /= 2;  // the warps' hit slices must fit the default 48 KB
  }
  const int64_t blocks = (rows + warps / segs - 1) / (warps / segs);
  cudaStream_t s = (cudaStream_t)stream;
  auto run = vec ? &neighbor_extract_kernel<4> : &neighbor_extract_kernel<1>;
  run<<<(unsigned)blocks, warps * 32, smem, s>>>(
      (const int32_t*)dist, (const int32_t*)a_len, (const int32_t*)a_gid,
      (const int32_t*)a_rows, (const int32_t*)len, (const int32_t*)gid,
      (int32_t*)idx, (int32_t*)cnt, rows, u, threshold, k, segs, seg_cols,
      buf);
  return (int)cudaGetLastError();
}

}  // extern "C"
