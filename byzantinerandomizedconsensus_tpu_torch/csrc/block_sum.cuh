// A block reduction of several per-thread counters at once, shared by the
// kernels whose threads own several replicas (fused_round_wide.cuh,
// urn_step.cu): each thread's counts are sums, not predicates, so
// __syncthreads_count does not serve.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace brc {

// Sums each of K per-thread counters over the block, in place: a warp
// shuffle tree, one partial per warp in shared memory, warp 0 sums the
// partials. blockDim is a multiple of 32. Two barriers; the buffers are
// reused safely by the next call because every thread passes the second
// barrier before any thread writes them again.
template <int K>
__device__ __forceinline__ void block_sum(int (&x)[K]) {
  __shared__ int part[32][K];
  __shared__ int total[K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int s = x[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part[warp][i] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      int s = lane < nwarps ? part[lane][i] : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) total[i] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = total[i];
}

}  // namespace brc

#endif  // __CUDACC__
