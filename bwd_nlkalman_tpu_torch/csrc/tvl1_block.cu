// K3: a block of k_iters fused TV-L1 primal-dual iterations on a level
// too large for K2's plan (the 1080x1920 level of a full-resolution flow).
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/flow/tvl1_pallas.py:52
// (_tvl1_block_kernel, launched by tvl1_iter_block :186). On the TPU it
// runs k_iters = 24 iterations per row tile in VMEM with a 24-row halo
// and ping-pongs the tiles between two HBM state planes. Here the state
// lives in device memory and one launch is one whole Jacobi iteration:
// each thread recomputes the primal update at itself and at its right
// and lower neighbours (the dual step needs their forward differences),
// reading the old state and writing the new one. The block's k_iters
// launches alternate between two buffers so that the last one lands in
// `out`; on the last iteration each thread block writes its partial sum
// of the squared update, and bnlk_mean_of_partials (block_sum.cuh) adds
// them in a fixed order and divides by h*w. The host reads that float
// once per block. Nothing depends on launch order: ping-pong buffers,
// no atomics.
//
// K3's own arithmetic (tvl1_pallas.py:100-159), not K2's:
//   - the where form of the threshold step, with the lo/hi masks against
//     l_t * grad and fi = -rho / max(grad, 1e-10) (zero where grad is);
//   - l_t = lambda * theta taken as a double product, then rounded to
//     float (the Python-float product of the TPU kernel, :64);
//   - the divergence with the reference's border rules: first column /
//     row the value itself, last column / row minus the previous value,
//     else the backward difference (:112-121);
//   - the error over the frame's pixels of the last iteration only,
//     divided by h*w (:156-159, 237).
//
// State: 6 planes (h, w) = u1, u2, p11, p12, p21, p22; constants: 4
// planes = i1wx, i1wy, grad, rho_c (the warp and the constants stay
// outside the kernel, as on the TPU, :269-285).
//
// What bounds it on the card: device-memory bytes and launch latency.
// An iteration reads 6 state planes and 4 constant planes (neighbour
// reads hit L1/L2) and writes 6 planes, 64 bytes per pixel: 133 MB at
// 1080x1920, about 40 us at 3.35 TB/s, against some 50 FLOP per pixel,
// about 1.5 us at 67 TFLOP/s. Design for now: simple and right, one
// launch per iteration. Temporal blocking (several iterations per launch
// on shared-memory tiles with a halo, as the TPU kernel does in VMEM), a
// device-side stopping flag and CUDA graphs are later work.
#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kBx = 32, kBy = 8;
constexpr float kGradIsZero = 1e-10f;  // tvl1flow_lib.c:26

struct Block {
  int h, w;
  float l_t, theta, taut;
  const float* cs;  // 4 planes: i1wx, i1wy, grad, rho_c
};

// Primal update (both components) at pixel (x, y) from the state s:
// threshold step, then u + theta * div(p).
__device__ __forceinline__ void primal(const Block& B,
                                       const float* __restrict__ s, int x,
                                       int y, float* un) {
  const size_t n = (size_t)B.h * B.w, i = (size_t)y * B.w + x;
  const float i1wx = B.cs[i], i1wy = B.cs[n + i];
  const float grad = B.cs[2 * n + i], rho_c = B.cs[3 * n + i];
  const float u1 = s[i], u2 = s[n + i];
  const float rho = rho_c + i1wx * u1 + i1wy * u2;
  const float fi = grad < kGradIsZero ? 0.0f : -rho / fmaxf(grad, kGradIsZero);
  const bool lo = rho < -B.l_t * grad, hi = rho > B.l_t * grad;
  const float d1 = lo ? B.l_t * i1wx : (hi ? -B.l_t * i1wx : fi * i1wx);
  const float d2 = lo ? B.l_t * i1wy : (hi ? -B.l_t * i1wy : fi * i1wy);
  const float v[2] = {u1 + d1, u2 + d2};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* pa = s + (2 + 2 * c) * n;  // p11 / p21
    const float* pb = s + (3 + 2 * c) * n;  // p12 / p22
    const float ax = x == 0         ? pa[i]
                     : x == B.w - 1 ? -pa[i - 1]
                                    : pa[i] - pa[i - 1];
    const float by = y == 0         ? pb[i]
                     : y == B.h - 1 ? -pb[i - B.w]
                                    : pb[i] - pb[i - B.w];
    un[c] = v[c] + B.theta * (ax + by);
  }
}

__global__ void iter_kernel(Block B, const float* __restrict__ s,
                            float* __restrict__ s_new,
                            float* __restrict__ partials, int want_err) {
  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y = blockIdx.y * kBy + threadIdx.y;
  float e = 0.0f;
  if (x < B.w && y < B.h) {
    const size_t n = (size_t)B.h * B.w, i = (size_t)y * B.w + x;
    float un[2], ur[2] = {0.0f, 0.0f}, ud[2] = {0.0f, 0.0f};
    primal(B, s, x, y, un);
    const bool has_r = x < B.w - 1, has_d = y < B.h - 1;
    if (has_r) primal(B, s, x + 1, y, ur);
    if (has_d) primal(B, s, x, y + 1, ud);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float ux = has_r ? ur[c] - un[c] : 0.0f;
      const float uy = has_d ? ud[c] - un[c] : 0.0f;
      const float ng = 1.0f + B.taut * sqrtf(ux * ux + uy * uy);
      const size_t ia = (2 + 2 * c) * n + i, ib = (3 + 2 * c) * n + i;
      s_new[ia] = (s[ia] + B.taut * ux) / ng;
      s_new[ib] = (s[ib] + B.taut * uy) / ng;
      s_new[c * n + i] = un[c];
      const float d = un[c] - s[c * n + i];
      e += d * d;
    }
  }
  if (!want_err) return;
  const float sum = bnlk_block_sum<kBx * kBy>(e);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = sum;
}

}  // namespace

// state, out, tmp: 6 planes of h*w floats each (state is not written);
// consts: 4 planes; partials: ceil(w/32) * ceil(h/8) floats; err: one
// float, the mean squared update of the last iteration.
extern "C" int bnlk_tvl1_block(const void* state, const void* consts,
                               void* out, void* tmp, void* partials,
                               void* err, int h, int w, int k_iters,
                               double tau, double lambda, double theta,
                               void* stream_) {
  if (k_iters < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  Block B;
  B.h = h;
  B.w = w;
  B.l_t = (float)(lambda * theta);
  B.theta = (float)theta;
  B.taut = (float)(tau / theta);
  B.cs = (const float*)consts;
  const dim3 block(kBx, kBy);
  const dim3 grid((w + kBx - 1) / kBx, (h + kBy - 1) / kBy);
  const float* src = (const float*)state;
  for (int j = 0; j < k_iters; ++j) {
    // alternate so that iteration k_iters - 1 writes `out`
    float* dst = (k_iters - 1 - j) % 2 == 0 ? (float*)out : (float*)tmp;
    iter_kernel<<<grid, block, 0, stream>>>(B, src, dst, (float*)partials,
                                            j == k_iters - 1);
    src = dst;
  }
  bnlk_mean_of_partials<<<1, kMeanThreads, 0, stream>>>(
      (const float*)partials, (int)(grid.x * grid.y), (float)((double)h * w),
      (float*)err);
  return (int)cudaGetLastError();
}
