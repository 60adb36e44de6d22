// Flush match grids of the bucketed interval join (the fused q7 barrier).
//
// Replaces the Pallas TPU kernel risingwave_tpu/ops/interval_join.py::
// _match_kernel (launched by interval_match_pallas_call). For bucket b and
// lane w:
//
//   del[b, w] = occ[b, w] & old_live[b] & (vals[b, w] == old_max[b])
//   ins[b, w] = occ[b, w] & new_live[b] & (vals[b, w] == new_max[b])
//
// The TPU kernel splits every int64 into hi/lo int32 halves (Mosaic has no
// 64-bit compare) and needs the bucket count to be a multiple of its
// 256-bucket tile. Here the compares are native int64, any bucket count is
// taken (the ragged last block is masked), and the outputs are bool bytes.
//
// Design: a block owns kBuckets buckets. Its first threads stage the four
// per-bucket scalars in shared memory once; then all threads sweep the
// block's kBuckets * W cells with consecutive threads on consecutive cells,
// so every load and store of vals, occ, del and ins is coalesced.
//
// Bound on an H100 at the bench shape (nb = 1 << 15, W = 128): the function
// must read vals (8 B), occ (1 B) per cell and 18 B per bucket, and write
// del and ins (1 B each) per cell: 11 * nb * W + 18 * nb bytes, about
// 46.7 MB, or 13.9 us at 3.35 TB/s. It does two compares per cell, far
// below any compute limit, so it is bound by its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuckets = 16;   // buckets per block

__global__ void interval_match_kernel(
    const int64_t* __restrict__ vals, const uint8_t* __restrict__ occ,
    const int64_t* __restrict__ old_max, const uint8_t* __restrict__ old_live,
    const int64_t* __restrict__ new_max, const uint8_t* __restrict__ new_live,
    uint8_t* __restrict__ del, uint8_t* __restrict__ ins, int nb, int w) {
  __shared__ int64_t s_old[kBuckets];
  __shared__ int64_t s_new[kBuckets];
  __shared__ uint8_t s_old_live[kBuckets];
  __shared__ uint8_t s_new_live[kBuckets];

  const int b0 = blockIdx.x * kBuckets;
  const int rows = min(kBuckets, nb - b0);
  if (threadIdx.x < rows) {
    const int b = b0 + threadIdx.x;
    s_old[threadIdx.x] = old_max[b];
    s_new[threadIdx.x] = new_max[b];
    s_old_live[threadIdx.x] = old_live[b];
    s_new_live[threadIdx.x] = new_live[b];
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(b0) * w;
  const int cells = rows * w;
  for (int e = threadIdx.x; e < cells; e += kThreads) {
    const int r = e / w;
    const int64_t i = base + e;
    const int64_t v = vals[i];
    const bool o = occ[i] != 0;
    del[i] = o && s_old_live[r] && v == s_old[r];
    ins[i] = o && s_new_live[r] && v == s_new[r];
  }
}

}  // namespace

extern "C" int interval_match_launch(const void* vals, const void* occ,
                                     const void* old_max,
                                     const void* old_live,
                                     const void* new_max,
                                     const void* new_live, void* del,
                                     void* ins, int nb, int w,
                                     void* stream) {
  if (nb <= 0 || w <= 0) return 0;
  if (w > INT32_MAX / kBuckets) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nb + kBuckets - 1) / kBuckets;
  interval_match_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(vals), static_cast<const uint8_t*>(occ),
      static_cast<const int64_t*>(old_max),
      static_cast<const uint8_t*>(old_live),
      static_cast<const int64_t*>(new_max),
      static_cast<const uint8_t*>(new_live), static_cast<uint8_t*>(del),
      static_cast<uint8_t*>(ins), nb, w);
  return static_cast<int>(cudaGetLastError());
}
