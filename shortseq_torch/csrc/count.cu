// Kernels D and I: the group count and the row hash of shortseq_torch's
// unique_count.
//
// Kernel D replaces the epilogue of shortseq_tpu/count/device.py
// unique_count (:199-259): boundary flags, segment sums with the int32
// wrap verdict, the key scatter, n_unique over the live prefix, pad
// normalization and the whole-table poison.  The sort before it is
// kernel S (csrc/sort.cu); it hands this kernel the permutation
// `perm` that orders rows by (length, lane_0 .. lane_{W-1}), lanes
// unsigned (W <= 6), or by kernel I's key, then length (W > 6), PAD rows
// (length = int32 max) last either way.  Rows are read through `perm`,
// so the sorted [N, W] matrix is never materialized.
//
// Kernel I replaces _row_hash (:62-91) and the PAD forcing of
// _sort_rows_hash (:130-131): two murmur-style 32-bit mixes of a row's
// length and lanes, fused into one int64 sort key.  A row's mix is a
// chain in lane order, so one thread owns a row and loads it by the
// widest vector that divides it.  Given the keys in perm order
// (`s_hash`), D also reports the hash path's collision: two adjacent live
// rows with equal keys that differ in length or in a lane
// (_sort_rows_hash :136-141).  D compares every adjacent pair anyway, so
// the check reads the keys of the rows that head a group and makes no
// second pass over the rows.
//
// What bounds D on the H100: bytes gathered through `perm`.  Each sorted
// row costs its words, its length and its weight, three reads at random
// addresses; a read at a random address moves at least one 32-byte sector
// however few of its bytes are used.  At W = 2 that is ~96 bytes of
// sectors for 16 useful bytes per row, plus 8 bytes of perm read in order;
// at W = 64 a row is 256 contiguous bytes and the gather is nearly dense.
// So the design reads every sorted row through `perm` exactly once, keeps
// the comparisons with the previous row on chip, and bounds each thread's
// work by the tile, whatever the size of a group.
//
// D's two launches:
//
//   group_tile    one block of kThreads threads per tile of kTileRows
//                 consecutive sorted rows.  The block loads its slice of
//                 perm (in order), then gathers each row's length, weight
//                 and words once into shared memory: words by vectors of
//                 16, 8 or 4 bytes, the widest that divides the row (rows
//                 of 4, 8, 20 or 24 bytes at W = 1, 2, 5, 6 are not
//                 16-byte aligned), several threads on one row when it is
//                 wide.  The row just before the tile is gathered too, so
//                 the tile's first row compares on chip like the others.
//                 A row heads a group iff its length or any vector differs
//                 from the previous row's.  Each thread then owns
//                 kItems consecutive rows: a run over them, then a warp
//                 and block segmented scan with the head flags, gives each
//                 group's sum within the tile in int64.  The tile's first
//                 group index comes from a single-pass decoupled look-back
//                 over the tiles before it; tile ids are taken from an
//                 atomic counter, not blockIdx, so a block only ever waits
//                 on tiles that running blocks already hold.  A group that
//                 starts and ends inside the tile stores its sum; the
//                 tile's first and last group may cross a tile edge, and
//                 add their partial sums with 64-bit integer atomicAdd on
//                 a zeroed sum (two's complement, so negative weights need
//                 no special case; integer atomics commute, so the result
//                 is exact and the same every run).  A group of 387,299
//                 rows then costs ~190 atomics and no thread walks it.
//                 The tile writes each group's key row and length.  At
//                 W <= 6 the whole tile's rows fit in shared memory
//                 (kRowSmemBytes) and the key row is written from there
//                 at once: a later pass would gather one more random
//                 sector per group, which at ~1 row per group (10M
//                 singleton reads) is the whole gather again.  Wider rows
//                 stream through shared memory in chunks, and the block
//                 copies each head row once more from global memory (by
//                 then mostly in L2); no non-head row is read twice.  Any
//                 live negative weight sets the poison word; the row that
//                 ends the live prefix writes n_unique (live rows are a
//                 prefix of the sorted order), and the last tile writes
//                 the group total.  With `s_hash`, a row that heads a
//                 group, is live, follows a live row and has that row's
//                 key sets the collision word.
//   group_finish  one thread per 16/8/4-byte vector of the n_out output
//                 rows, in order.  Poison is global, so it is known only
//                 after every tile: this pass writes each live group's
//                 count (-1 when the table is poisoned or the sum leaves
//                 int32, the JAX package's verdict), 0 for dead (PAD)
//                 groups, which keep their stale key words, and length
//                 PAD, count 0 and zero words for the rows past the last
//                 group.  Groups at or past n_out are dropped but still
//                 count in n_unique, so fetch_table raises.
//
// Kernel I, one launch (row_hash): one thread a row, kThreads rows a
// block.  A PAD row's key is the largest, (0xFFFFFFFF, 0xFFFFFFFF); any
// other row's is the JAX package's arithmetic constant for constant in
// uint32 with wrap.  The key is ((int32)(h1 ^ 0x80000000)) << 32 | h2,
// whose signed order is the unsigned order of (h1, h2) (kernel S sorts
// it with bit 63 flipped back, as unsigned).  Bound: the rows' bytes,
// read once in order.  At W = 64 a warp's 16-byte loads fall 256 bytes
// apart, so each load moves whole 32-byte sectors and the next load
// finds the other half in L1 while the line stays there.
//
// Nothing syncs with the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPadLength = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kItems = 8;                     // consecutive rows per thread
constexpr int kTileRows = kThreads * kItems;  // count/device.py GROUP_TILE_ROWS
constexpr int kWarps = kThreads / 32;
constexpr int kLoadBatch = 8;                 // independent gathers in flight
constexpr int kRowSmemBytes = 48 * 1024;      // a W <= 6 tile fits whole
constexpr unsigned kFull = 0xffffffffu;

// The wrapper's zeroed int64 scratch: four words, then one look-back
// state per tile, then one sum per output group.
constexpr int kTileCounter = 0;
constexpr int kPoison = 1;
constexpr int kGroups = 2;
constexpr int kCollision = 3;
constexpr int kStates = 4;

// A look-back state: status in the top two bits, a head count below.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ bool differ(uint32_t a, uint32_t b) {
  return a != b;
}
__device__ __forceinline__ bool differ(uint2 a, uint2 b) {
  return (a.x ^ b.x) | (a.y ^ b.y);
}
__device__ __forceinline__ bool differ(uint4 a, uint4 b) {
  return (a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w);
}

// Chunk rows: the largest power of two <= kTileRows whose rows fit in
// kRowSmemBytes (2048 at W <= 6, 128 at W = 64).
int chunk_rows_for(int row_bytes) {
  int rows = kTileRows;
  while (rows > 1 && rows * row_bytes > kRowSmemBytes) rows >>= 1;
  return rows;
}

__host__ __device__ inline size_t row_buffer_bytes(int chunk_rows,
                                                   int row_bytes) {
  return ((size_t)(chunk_rows + 1) * row_bytes + 15) & ~(size_t)15;
}

constexpr size_t kTileArrayBytes =
    (size_t)kTileRows * (sizeof(long long) + 2 * sizeof(int32_t) +
                         sizeof(uint16_t) + sizeof(uint8_t));

// Decoupled look-back, run by warp 0 of the tile: publishes the tile's
// head count, sums the counts of the tiles before it 32 at a time until
// one of them carries an inclusive prefix, and publishes its own.
// Returns the number of groups that start before the tile.
__device__ long long tile_prefix(unsigned long long* states, int tile,
                                 long long heads, int lane) {
  volatile unsigned long long* vs = states;
  if (tile == 0) {
    if (lane == 0) vs[0] = kPrefix | (unsigned long long)heads;
    return 0;
  }
  if (lane == 0) vs[tile] = kAggregate | (unsigned long long)heads;
  long long before = 0;
  for (int top = tile - 1;; top -= 32) {
    const int t = top - lane;
    unsigned long long s = kPrefix;  // before tile 0: an empty prefix
    if (t >= 0) {
      s = vs[t];
      while ((s >> 62) == 0) {
        __nanosleep(20);
        s = vs[t];
      }
    }
    const unsigned prefix_lanes = __ballot_sync(kFull, (s >> 62) == 2);
    const int stop = prefix_lanes ? __ffs(prefix_lanes) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & kValueMask) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    before += v;
    if (prefix_lanes) break;
  }
  if (lane == 0) vs[tile] = kPrefix | (unsigned long long)(before + heads);
  return before;
}

template <class V>
__global__ void __launch_bounds__(kThreads)
    group_tile_kernel(const V* __restrict__ words,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ weights,
                      const long long* __restrict__ perm,
                      const long long* __restrict__ s_hash,
                      unsigned long long* __restrict__ scratch,
                      unsigned long long* __restrict__ sums,
                      V* __restrict__ u_words, int32_t* __restrict__ u_lengths,
                      int32_t* __restrict__ n_unique, long long n, int vpr,
                      int chunk_rows, long long n_out) {
  extern __shared__ uint4 smem[];
  const int row_bytes = vpr * (int)sizeof(V);
  // rows: slot 0 holds the row before the chunk, slots 1.. the chunk.
  V* rows = reinterpret_cast<V*>(smem);
  long long* s_perm = reinterpret_cast<long long*>(
      reinterpret_cast<char*>(smem) + row_buffer_bytes(chunk_rows, row_bytes));
  int32_t* s_len = reinterpret_cast<int32_t*>(s_perm + kTileRows);
  int32_t* s_wt = s_len + kTileRows;
  uint16_t* s_heads = reinterpret_cast<uint16_t*>(s_wt + kTileRows);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_heads + kTileRows);

  __shared__ long long s_wsum[kWarps];
  __shared__ int s_wflag[kWarps];
  __shared__ int s_wcnt[kWarps];
  __shared__ long long s_before;
  __shared__ int s_tile;
  __shared__ int32_t s_prev_len;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(&scratch[kTileCounter], 1ull);
  __syncthreads();
  const int tile = s_tile;
  const long long t0 = (long long)tile * kTileRows;
  const int nt = (int)min((long long)kTileRows, n - t0);

  // 1. The tile's slice of perm, in order.
  for (int r = tid; r < nt; r += kThreads) s_perm[r] = __ldg(perm + t0 + r);
  if (tid == 0) s_prev_len = t0 > 0 ? __ldg(lengths + __ldg(perm + t0 - 1)) : 0;
  __syncthreads();

  // 2. Each row's length and weight, gathered once.
  {
    int32_t lv[kItems], wv[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = k * kThreads + tid;
      if (r < nt) {
        const long long src = s_perm[r];
        lv[k] = __ldg(lengths + src);
        wv[k] = __ldg(weights + src);
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = k * kThreads + tid;
      if (r < nt) {
        s_len[r] = lv[k];
        s_wt[r] = wv[k];
      }
    }
  }

  // 3. Head flags.  Rows stream through shared memory a chunk at a time;
  // each row's words are gathered once, and a row compares with the one
  // before it on chip, vector by vector.
  const int n_chunks = (nt + chunk_rows - 1) / chunk_rows;
  for (int c = 0; c < n_chunks; ++c) {
    const int r0 = c * chunk_rows;
    const int total = min(chunk_rows, nt - r0) * vpr;
    if (c > 0) {
      // The previous chunk's last row becomes slot 0.
      for (int q = tid; q < vpr; q += kThreads)
        rows[q] = rows[chunk_rows * vpr + q];
      __syncthreads();
    }
    // Vector p of the chunk is vector q of chunk row rr, stored at
    // rows[vpr + p]; p < 0 is the row before the tile, into slot 0.
    const int first = (c == 0 && t0 > 0) ? -vpr : 0;
    for (int b = first + tid; b < total; b += kThreads * kLoadBatch) {
      V v[kLoadBatch];
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int p = b + k * kThreads;
        if (p < total) {
          const int rr = (p + vpr) / vpr - 1;
          const int q = p - rr * vpr;
          const long long src =
              rr >= 0 ? s_perm[r0 + rr] : __ldg(perm + t0 - 1);
          v[k] = __ldg(words + src * vpr + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kLoadBatch; ++k) {
        const int p = b + k * kThreads;
        if (p < total) rows[vpr + p] = v[k];
      }
    }
    if (c == 0) {
      __syncthreads();  // every length of step 2 is in
      for (int r = tid; r < kTileRows; r += kThreads) {
        uint8_t f = 0;
        if (r < nt)
          f = (t0 + r == 0) || s_len[r] != (r > 0 ? s_len[r - 1] : s_prev_len);
        s_flag[r] = f;
      }
    }
    __syncthreads();
    for (int p = tid; p < total; p += kThreads) {
      if (differ(rows[vpr + p], rows[p])) s_flag[r0 + p / vpr] = 1;
    }
    __syncthreads();
  }

  // 4. Each thread's kItems rows: live weights, head count, and the open
  // segment's sum after its last head.
  const int rb = tid * kItems;
  int32_t len[kItems], wt[kItems];
  uint8_t f[kItems];
  {
    const int4* l4 = reinterpret_cast<const int4*>(s_len + rb);
    const int4* w4 = reinterpret_cast<const int4*>(s_wt + rb);
    const int4 la = l4[0], lb = l4[1], wa = w4[0], wb = w4[1];
    len[0] = la.x; len[1] = la.y; len[2] = la.z; len[3] = la.w;
    len[4] = lb.x; len[5] = lb.y; len[6] = lb.z; len[7] = lb.w;
    wt[0] = wa.x; wt[1] = wa.y; wt[2] = wa.z; wt[3] = wa.w;
    wt[4] = wb.x; wt[5] = wb.y; wt[6] = wb.z; wt[7] = wb.w;
    const uint2 fv = *reinterpret_cast<const uint2*>(s_flag + rb);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      f[m] = (fv.x >> (8 * m)) & 0xff;
      f[m + 4] = (fv.y >> (8 * m)) & 0xff;
    }
  }
  long long w[kItems];
  bool poison = false;
  int cnt = 0, any = 0;
  long long tail = 0;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const bool live = rb + m < nt && len[m] != kPadLength;
    w[m] = live ? wt[m] : 0;
    poison |= live && wt[m] < 0;
    cnt += f[m];
    if (f[m]) {
      any = 1;
      tail = 0;
    }
    tail += w[m];
  }
  if (s_hash != nullptr) {
    // The hash path's collision: a live row that heads a group after a
    // live row with the same key (rows of one key differ).
    bool collide = false;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const long long i = t0 + rb + m;
      if (rb + m < nt && f[m] && i > 0 && len[m] != kPadLength) {
        const int32_t prev = m > 0 ? len[m - 1]
                                   : (rb > 0 ? s_len[rb - 1] : s_prev_len);
        collide |= prev != kPadLength &&
                   __ldg(s_hash + i) == __ldg(s_hash + i - 1);
      }
    }
    if (collide) atomicOr(&scratch[kCollision], 1ull);
  }

  // Warp, then block, inclusive scan of (head?, segment sum, heads):
  // (f1, v1) then (f2, v2) combine to (f1 | f2, f2 ? v2 : v1 + v2).
  long long sv = tail;
  int sf = any, sc = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v_up = __shfl_up_sync(kFull, sv, off);
    const int f_up = __shfl_up_sync(kFull, sf, off);
    const int c_up = __shfl_up_sync(kFull, sc, off);
    if (lane >= off) {
      if (!sf) sv += v_up;
      sf |= f_up;
      sc += c_up;
    }
  }
  if (lane == 31) {
    s_wsum[warp] = sv;
    s_wflag[warp] = sf;
    s_wcnt[warp] = sc;
  }
  long long ev = __shfl_up_sync(kFull, sv, 1);
  int ef = __shfl_up_sync(kFull, sf, 1);
  int ec = __shfl_up_sync(kFull, sc, 1);
  if (lane == 0) {
    ev = 0;
    ef = 0;
    ec = 0;
  }
  poison = __syncthreads_or(poison);
  long long pv = 0;
  int pc = 0, tile_heads = 0;
  for (int j = 0; j < kWarps; ++j) {
    if (j < warp) {
      pv = s_wflag[j] ? s_wsum[j] : pv + s_wsum[j];
      pc += s_wcnt[j];
    }
    tile_heads += s_wcnt[j];
  }
  const long long carry = ef ? ev : pv + ev;  // open segment's sum so far
  if (tid == 0 && poison) atomicOr(&scratch[kPoison], 1ull);

  // 5. Groups that start before the tile.
  if (warp == 0) {
    const long long before =
        tile_prefix(scratch + kStates, tile, tile_heads, lane);
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  const long long before = s_before;
  if (tid == 0 && tile == (int)gridDim.x - 1)
    scratch[kGroups] = (unsigned long long)(before + tile_heads);

  // 6. Sums, head list and n_unique, row by row.
  long long run = carry;
  int h = pc + ec;
  const int last = nt - 1;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int r = rb + m;
    if (r < nt) {
      if (f[m]) {
        run = 0;
        s_heads[h++] = (uint16_t)r;
      }
      run += w[m];
      const long long g = before + h - 1;
      const bool ends =
          r == last ||
          (m + 1 < kItems ? f[min(m + 1, kItems - 1)] : s_flag[r + 1]);
      if (ends && g < n_out && run != 0) {
        // Sums start at zero: a group only in this tile stores its sum;
        // one that may cross a tile edge adds its part.
        if (r == last || g < before)
          atomicAdd(&sums[g], (unsigned long long)run);
        else
          sums[g] = (unsigned long long)run;
      }
      const bool live = len[m] != kPadLength;
      const bool prev_live =
          m > 0 ? len[m - 1] != kPadLength
                : (r > 0 ? s_len[r - 1] != kPadLength
                         : (t0 == 0 || s_prev_len != kPadLength));
      if (!live && prev_live) *n_unique = (int32_t)g;  // first dead row
      if (live && t0 + r == n - 1) *n_unique = (int32_t)(g + 1);
    }
  }
  __syncthreads();

  // 7. Key rows and lengths of the tile's groups below n_out, in order.
  const int heads_out =
      (int)max(0LL, min((long long)tile_heads, n_out - before));
  const bool resident = n_chunks == 1;
  const int pieces = heads_out * vpr;
  for (int b = tid; b < pieces; b += kThreads * kLoadBatch) {
    V v[kLoadBatch];
#pragma unroll
    for (int k = 0; k < kLoadBatch; ++k) {
      const int p = b + k * kThreads;
      if (p < pieces) {
        const int hh = p / vpr;
        const int q = p - hh * vpr;
        const int r = s_heads[hh];
        v[k] = resident ? rows[(r + 1) * vpr + q]
                        : __ldg(words + s_perm[r] * vpr + q);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoadBatch; ++k) {
      const int p = b + k * kThreads;
      if (p < pieces) u_words[before * vpr + p] = v[k];
    }
  }
  for (int hh = tid; hh < heads_out; hh += kThreads)
    u_lengths[before + hh] = s_len[s_heads[hh]];
}

template <class V>
__global__ void group_finish_kernel(V* __restrict__ u_words,
                                    int32_t* __restrict__ u_lengths,
                                    int32_t* __restrict__ counts,
                                    const long long* __restrict__ sums,
                                    const unsigned long long* __restrict__ scratch,
                                    long long n_out, int vpr) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_out * vpr) return;
  const long long g = p / vpr;
  const bool lead = p == g * vpr;
  if (g >= (long long)scratch[kGroups]) {
    u_words[p] = V{};
    if (lead) {
      u_lengths[g] = kPadLength;
      counts[g] = 0;
    }
    return;
  }
  if (!lead) return;
  if (u_lengths[g] == kPadLength) {
    counts[g] = 0;
    return;
  }
  const long long s = sums[g];
  const bool wrapped = s > (long long)INT32_MAX || s < (long long)INT32_MIN;
  counts[g] = (scratch[kPoison] || wrapped) ? -1 : (int32_t)s;
}

// The widest vector that divides the row and every row base pointer.
int vector_bytes(int w, uintptr_t addresses) {
  const int row_bytes = 4 * w;
  if (row_bytes % 16 == 0 && addresses % 16 == 0) return 16;
  if (row_bytes % 8 == 0 && addresses % 8 == 0) return 8;
  return 4;
}

template <class V>
int launch_tile(const void* words, const void* lengths, const void* weights,
                const void* perm, const void* s_hash, void* scratch,
                void* sums, void* u_words, void* u_lengths, void* n_unique,
                int64_t n, int w, int64_t n_out, cudaStream_t stream) {
  const int row_bytes = 4 * w;
  const int vpr = row_bytes / (int)sizeof(V);
  const int chunk_rows = chunk_rows_for(row_bytes);
  const size_t smem = row_buffer_bytes(chunk_rows, row_bytes) + kTileArrayBytes;
  cudaError_t err = cudaFuncSetAttribute(
      group_tile_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  group_tile_kernel<V><<<(unsigned)tiles, kThreads, smem, stream>>>(
      (const V*)words, (const int32_t*)lengths, (const int32_t*)weights,
      (const long long*)perm, (const long long*)s_hash,
      (unsigned long long*)scratch,
      (unsigned long long*)sums, (V*)u_words, (int32_t*)u_lengths,
      (int32_t*)n_unique, n, vpr, chunk_rows, n_out);
  return (int)cudaGetLastError();
}

template <class V>
int launch_finish(void* u_words, void* u_lengths, void* counts,
                  const void* sums, const void* scratch, int64_t n_out, int w,
                  cudaStream_t stream) {
  const int vpr = 4 * w / (int)sizeof(V);
  const long long items = n_out * vpr;
  const unsigned blocks = (unsigned)((items + 255) / 256);
  group_finish_kernel<V><<<blocks, 256, 0, stream>>>(
      (V*)u_words, (int32_t*)u_lengths, (int32_t*)counts,
      (const long long*)sums, (const unsigned long long*)scratch, n_out, vpr);
  return (int)cudaGetLastError();
}

// Kernel I.  The JAX package's _row_hash, constant for constant.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

struct RowMix {
  uint32_t h1, h2;
  __device__ __forceinline__ void lane(uint32_t x) {
    h1 = (h1 ^ x) * 0xCC9E2D51u;
    h1 ^= h1 >> 15;
    h2 = (h2 ^ x) * 0x1B873593u;
    h2 ^= h2 >> 13;
  }
  __device__ __forceinline__ void vec(uint32_t v) { lane(v); }
  __device__ __forceinline__ void vec(uint2 v) {
    lane(v.x);
    lane(v.y);
  }
  __device__ __forceinline__ void vec(uint4 v) {
    lane(v.x);
    lane(v.y);
    lane(v.z);
    lane(v.w);
  }
};

template <class V>
__global__ void __launch_bounds__(kThreads)
    row_hash_kernel(const V* __restrict__ words,
                    const int32_t* __restrict__ lengths,
                    unsigned long long* __restrict__ keys, long long n,
                    int vpr, uint32_t seed) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t length = __ldg(lengths + i);
  uint32_t h1 = 0xFFFFFFFFu, h2 = 0xFFFFFFFFu;
  if (length != kPadLength) {
    const uint32_t len = (uint32_t)length;
    const uint32_t s = seed * 0x27D4EB2Fu;
    RowMix mix{(len ^ s) * 0x9E3779B1u,
               (len + s + 0x165667B1u) * 0x85EBCA77u};
    const V* row = words + i * vpr;
#pragma unroll 8
    for (int q = 0; q < vpr; ++q) mix.vec(__ldg(row + q));
    h1 = fmix32(mix.h1);
    h2 = fmix32(mix.h2);
  }
  keys[i] = (unsigned long long)(h1 ^ 0x80000000u) << 32 | h2;
}

template <class V>
int launch_row_hash(const void* words, const void* lengths, void* keys,
                    int64_t n, int w, uint32_t seed, cudaStream_t stream) {
  const int vpr = 4 * w / (int)sizeof(V);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  row_hash_kernel<V><<<blocks, kThreads, 0, stream>>>(
      (const V*)words, (const int32_t*)lengths, (unsigned long long*)keys, n,
      vpr, seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ssq_group_tile_rows() { return kTileRows; }

int ssq_group_tile(const void* words, const void* lengths, const void* weights,
                   const void* perm, const void* s_hash, void* scratch,
                   void* sums, void* u_words, void* u_lengths, void* n_unique,
                   int64_t n, int w, int64_t n_out, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (vector_bytes(w, (uintptr_t)words | (uintptr_t)u_words)) {
    case 16:
      return launch_tile<uint4>(words, lengths, weights, perm, s_hash,
                                scratch, sums, u_words, u_lengths, n_unique,
                                n, w, n_out, s);
    case 8:
      return launch_tile<uint2>(words, lengths, weights, perm, s_hash,
                                scratch, sums, u_words, u_lengths, n_unique,
                                n, w, n_out, s);
    default:
      return launch_tile<uint32_t>(words, lengths, weights, perm, s_hash,
                                   scratch, sums, u_words, u_lengths,
                                   n_unique, n, w, n_out, s);
  }
}

int ssq_row_hash(const void* words, const void* lengths, void* keys,
                 int64_t n, int w, uint32_t seed, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (vector_bytes(w, (uintptr_t)words)) {
    case 16:
      return launch_row_hash<uint4>(words, lengths, keys, n, w, seed, s);
    case 8:
      return launch_row_hash<uint2>(words, lengths, keys, n, w, seed, s);
    default:
      return launch_row_hash<uint32_t>(words, lengths, keys, n, w, seed, s);
  }
}

int ssq_group_finish(void* u_words, void* u_lengths, void* counts,
                     const void* sums, const void* scratch, int64_t n_out,
                     int w, void* stream) {
  if (n_out == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (vector_bytes(w, (uintptr_t)u_words)) {
    case 16:
      return launch_finish<uint4>(u_words, u_lengths, counts, sums, scratch,
                                  n_out, w, s);
    case 8:
      return launch_finish<uint2>(u_words, u_lengths, counts, sums, scratch,
                                  n_out, w, s);
    default:
      return launch_finish<uint32_t>(u_words, u_lengths, counts, sums,
                                     scratch, n_out, w, s);
  }
}

}  // extern "C"
