// The fixed-order block sum of the TV-L1 kernels (K2, K3, tvl1_tile.cuh):
// the stopping test's mean squared update must not depend on launch or
// scheduling order, so no atomics; the sum adds in one fixed order.
#pragma once

namespace {

// Sum of v over the kThreads threads of a block: butterflies within each
// warp, then thread 0 adds the warp sums in warp order. Every thread of
// the block must call it; the result is valid in thread 0 only.
template <int kThreads>
__device__ __forceinline__ float bnlk_block_sum(float v) {
  static_assert(kThreads % 32 == 0, "whole warps only");
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if ((t & 31) == 0) warp_sums[t >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (t == 0)
    for (int k = 0; k < kThreads / 32; ++k) s += warp_sums[k];
  return s;
}

}  // namespace
