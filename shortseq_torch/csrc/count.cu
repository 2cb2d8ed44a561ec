// Kernel D: the group count of shortseq_torch's unique_count.
//
// Replaces shortseq_tpu/count/device.py unique_count (:155-259): everything
// after the sort.  The sort itself is a stable LSD pass of torch.sort (CUB
// radix) over the key columns, in count/device.py; it hands this kernel the
// permutation `perm` that orders rows by (length, lane_0 .. lane_{W-1}),
// lanes unsigned, PAD rows (length = int32 max) last.  Rows are read
// through `perm`, so the sorted [N, W] matrix is never materialized.
//
// Two launches, with a torch.cumsum of the flags between them:
//
//   group_flags   one thread per sorted row i: flag[i] = 1 iff i == 0 or
//                 row perm[i] differs from row perm[i-1] in length or any
//                 lane.  Any live row with a negative weight sets *poison
//                 (a -1 count from an upstream table re-entering as a
//                 weight must poison the merged table).
//   group_reduce  one warp per sorted row; the warps on a flagged row (a
//                 group's first row) own group g = ends[i] - 1.  The warp
//                 walks its group's rows 32 at a time, finds the group end
//                 with a ballot over the flags, and sums the rows' weights
//                 in int64, which is exact: a sum outside int32 is written
//                 as -1, the JAX package's verdict for a wrapped count.  It
//                 writes the group's key row, length and count, normalizes
//                 dead (PAD) groups to length PAD and count 0, writes -1 to
//                 every live group when *poison is set, and the warp of the
//                 last live group writes n_unique = g + 1.
//
// Bound by memory latency, not bytes: every access goes through perm,
// which scatters it.  At W = 2 a row is 12 bytes plus 8 of perm, and the
// random 10M-row case moves ~0.5 GB in all.  The design keeps it to one
// indirect read per row per launch and no atomics on the common path.
// One warp per group means a group of a million rows (adapter dimers,
// PhiX in a real library) is walked by one warp; that skew is measured in
// chip_smoke and left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kPadLength = 0x7FFFFFFF;

__global__ void group_flags_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ weights,
                                   const int64_t* __restrict__ perm,
                                   int32_t* __restrict__ flags,
                                   int32_t* __restrict__ poison, int64_t n,
                                   int w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = perm[i];
  const int32_t len = lengths[r];
  if (len != kPadLength && weights[r] < 0) atomicOr(poison, 1);
  int32_t differs = 1;
  if (i > 0) {
    const int64_t p = perm[i - 1];
    differs = len != lengths[p];
    const uint32_t* a = words + r * w;
    const uint32_t* b = words + p * w;
    for (int j = 0; j < w && !differs; ++j) differs = a[j] != b[j];
  }
  flags[i] = differs;
}

__global__ void group_reduce_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ weights, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ flags, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ poison, uint32_t* __restrict__ u_words,
    int32_t* __restrict__ u_lengths, int32_t* __restrict__ counts,
    int32_t* __restrict__ n_unique, int64_t n, int w, int64_t n_out) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (i >= n || !flags[i]) return;  // the whole warp shares i
  const int64_t g = ends[i] - 1;
  const int64_t r0 = perm[i];
  const int32_t len = lengths[r0];
  const bool live = len != kPadLength;
  if (g < n_out) {
    for (int j = lane; j < w; j += 32) u_words[g * w + j] = words[r0 * w + j];
  }
  if (!live) {
    // Dead groups keep their stale key words (as the JAX scatter does) but
    // read as padding: length PAD, count 0 (the caller pre-fills both).
    return;
  }
  // Walk the group: rows [i, end), end = first flagged row after i, or n.
  long long sum = 0;
  int64_t end = n;
  for (int64_t j = i; j < n; j += 32) {
    const int64_t row = j + lane;
    const bool stop = row >= n || (row > i && flags[row]);
    const unsigned mask = __ballot_sync(0xffffffffu, stop);
    const int cut = mask ? __ffs(mask) - 1 : 32;
    if (lane < cut) sum += weights[perm[row]];
    if (mask) {
      end = j + cut;
      break;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane != 0) return;
  if (g < n_out) {
    u_lengths[g] = len;
    const bool wrapped =
        sum > (long long)INT32_MAX || sum < (long long)INT32_MIN;
    counts[g] = (*poison || wrapped) ? -1 : (int32_t)sum;
  }
  // Live rows are a prefix of the sorted order, so the last live group is
  // the one followed by the end or by a PAD row.
  if (end == n || lengths[perm[end]] == kPadLength)
    *n_unique = (int32_t)(g + 1);
}

}  // namespace

extern "C" {

int ssq_group_flags(const void* words, const void* lengths,
                    const void* weights, const void* perm, void* flags,
                    void* poison, int64_t n, int w, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads));
  group_flags_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths,
      (const int32_t*)weights, (const int64_t*)perm, (int32_t*)flags,
      (int32_t*)poison, n, w);
  return (int)cudaGetLastError();
}

int ssq_group_reduce(const void* words, const void* lengths,
                     const void* weights, const void* perm, const void* flags,
                     const void* ends, const void* poison, void* u_words,
                     void* u_lengths, void* counts, void* n_unique, int64_t n,
                     int w, int64_t n_out, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t rows_per_block = threads / 32;
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block));
  group_reduce_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths,
      (const int32_t*)weights, (const int64_t*)perm, (const int32_t*)flags,
      (const int32_t*)ends, (const int32_t*)poison, (uint32_t*)u_words,
      (int32_t*)u_lengths, (int32_t*)counts, (int32_t*)n_unique, n, w, n_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
