// K2: one whole TV-L1 pyramid level (all warp stages and primal-dual
// iterations of Dual_TVL1_optic_flow, tvl1flow_lib.c:93-275).
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/flow/tvl1_fused.py:65
// (_level_kernel, launched by tvl1_single_scale_fused). On the TPU the
// whole level state lives in VMEM inside one kernel. Here it lives in
// device memory and the level is a short host loop of three kernels:
//
//   - consts_kernel, once per warp stage: bicubic warp of (I1, I1x, I1y)
//     along u with K4's sampler (bicubic.cuh), then the constants
//     i1wx, i1wy, nig = guarded -1/|grad I1w|^2 and rho_c;
//   - iter_kernel, once per primal-dual iteration: one thread per pixel
//     recomputes the primal update at itself and at its right and lower
//     neighbours (the dual step needs their forward differences), so one
//     launch is one whole iteration, reading the old state and writing
//     the new one (ping-pong buffers);
//   - bnlk_mean_of_partials (block_sum.cuh), once per round of k_check
//     iterations: sums the block partials of the last iteration's squared
//     update in a fixed order. The host reads that one float to decide
//     whether to go on.
//
// K2's own semantics, not the XLA path's: the clamp form of the threshold
// step fi = clip(rho * nig, -l_t, l_t) (tvl1_fused.py:200-209, 236-242);
// dual planes zero at the last column / row with the divergence that
// follows (:89-103, 243-253); the error over in-frame pixels on the last
// iteration of each round only (:268-285); the count rising in whole
// rounds of k_check.
//
// What bounds it on the card: device-memory bytes and launch latency. An
// iteration reads the 2 u planes, 4 dual planes and 4 constant planes
// (neighbour reads hit L1/L2) and writes 6 planes, 64 bytes per pixel;
// at 540x960 one iteration kernel takes 5.3 us on an H100 80GB HBM3 at
// 700 W (torch.profiler, PERF.md), the same order as a launch, and each
// round adds a host sync. Design for now: simple and right; fusing
// several iterations per launch with tiles in shared memory, and a
// device-side stopping flag, are later work.
#include <cuda_runtime.h>

#include "bicubic.cuh"
#include "block_sum.cuh"

namespace {

constexpr int kBx = 32, kBy = 8;
constexpr float kGradIsZero = 1e-10f;  // tvl1flow_lib.c:26

struct Level {
  int h, w;
  float l_t, theta, taut;
  const float* cs;  // 4 planes: i1wx, i1wy, nig, rho_c
};

__global__ void consts_kernel(const float* __restrict__ i0,
                              const float* __restrict__ i1s,
                              const float* __restrict__ u,
                              float* __restrict__ cs, int h, int w) {
  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y = blockIdx.y * kBy + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t n = (size_t)h * w, i = (size_t)y * w + x;
  const float u1 = u[i], u2 = u[n + i];
  float s[3];
  bnlk_bicubic_at(i1s, h, w, 3, (float)x + u1, (float)y + u2, s);
  const float i1w = s[0], i1wx = s[1], i1wy = s[2];
  const float grad = i1wx * i1wx + i1wy * i1wy;
  cs[i] = i1wx;
  cs[n + i] = i1wy;
  cs[2 * n + i] =
      grad < kGradIsZero ? 0.0f : -1.0f / fmaxf(grad, kGradIsZero);
  cs[3 * n + i] = i1w - i1wx * u1 - i1wy * u2 - i0[i];
}

// Primal update (both components) at pixel (x, y): threshold step then
// u + theta * div(p). pa = x-difference duals (p11, p21), pb =
// y-difference duals (p12, p22); pa is zero at x = w-1 and pb at y = h-1.
__device__ __forceinline__ void primal(const Level& L,
                                       const float* __restrict__ u,
                                       const float* __restrict__ p, int x,
                                       int y, float* un) {
  const size_t n = (size_t)L.h * L.w, i = (size_t)y * L.w + x;
  const float ig0 = L.cs[i], ig1 = L.cs[n + i];
  const float nig = L.cs[2 * n + i], rho_c = L.cs[3 * n + i];
  const float u0 = u[i], u1 = u[n + i];
  const float rho = rho_c + ig0 * u0 + ig1 * u1;
  const float fi = fminf(fmaxf(rho * nig, -L.l_t), L.l_t);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float* pa = p + c * n;
    const float* pb = p + (2 + c) * n;
    const float div = (pa[i] - (x > 0 ? pa[i - 1] : 0.0f)) +
                      (pb[i] - (y > 0 ? pb[i - L.w] : 0.0f));
    const float v = (c == 0 ? u0 + fi * ig0 : u1 + fi * ig1);
    un[c] = v + L.theta * div;
  }
}

__global__ void iter_kernel(Level L, const float* __restrict__ u,
                            const float* __restrict__ p,
                            float* __restrict__ u_new,
                            float* __restrict__ p_new,
                            float* __restrict__ partials, int want_err) {
  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y = blockIdx.y * kBy + threadIdx.y;
  float e = 0.0f;
  if (x < L.w && y < L.h) {
    const size_t n = (size_t)L.h * L.w, i = (size_t)y * L.w + x;
    float un[2], ur[2] = {0.0f, 0.0f}, ud[2] = {0.0f, 0.0f};
    primal(L, u, p, x, y, un);
    const bool has_r = x < L.w - 1, has_d = y < L.h - 1;
    if (has_r) primal(L, u, p, x + 1, y, ur);
    if (has_d) primal(L, u, p, x, y + 1, ud);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float ux = has_r ? ur[c] - un[c] : 0.0f;
      const float uy = has_d ? ud[c] - un[c] : 0.0f;
      const float g = sqrtf(ux * ux + uy * uy);
      const float r = 1.0f / (1.0f + L.taut * g);
      p_new[c * n + i] = (p[c * n + i] + L.taut * ux) * r;
      p_new[(2 + c) * n + i] = (p[(2 + c) * n + i] + L.taut * uy) * r;
      u_new[c * n + i] = un[c];
      const float d = un[c] - u[c * n + i];
      e += d * d;
    }
  }
  if (!want_err) return;
  const float s = bnlk_block_sum<kBx * kBy>(e);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

}  // namespace

// i0: (h, w); i1s: (h, w, 3) = (I1, I1x, I1y) interleaved; u: (2, h, w)
// initial flow planes, overwritten with the result. scratch holds
// 2*2 + 2*4 + 4 planes of h*w floats plus n_part + 1 floats, where
// n_part = ceil(w/32) * ceil(h/8). *iters (host memory) receives the
// number of primal-dual iterations run over all warp stages.
extern "C" int bnlk_tvl1_level(const void* i0, const void* i1s, void* u,
                               void* scratch, int h, int w, int nwarps,
                               double tau, float lambda, double theta,
                               double epsilon, int k_check, int max_iters,
                               void* iters, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t n = (size_t)h * w;
  float* base = (float*)scratch;
  float* ub[2] = {base, base + 2 * n};
  float* pb[2] = {base + 4 * n, base + 8 * n};
  float* cs = base + 12 * n;
  float* partials = base + 16 * n;
  const dim3 block(kBx, kBy);
  const dim3 grid((w + kBx - 1) / kBx, (h + kBy - 1) / kBy);
  const int n_part = grid.x * grid.y;
  float* err_dev = partials + n_part;

  Level L;
  L.h = h;
  L.w = w;
  L.l_t = lambda * (float)theta;
  L.theta = (float)theta;
  L.taut = (float)(tau / theta);
  L.cs = cs;
  const float eps2 = (float)(epsilon * epsilon);

  cudaMemcpyAsync(ub[0], u, 2 * n * sizeof(float), cudaMemcpyDeviceToDevice,
                  stream);
  cudaMemsetAsync(pb[0], 0, 4 * n * sizeof(float), stream);
  int cur = 0, total = 0;
  for (int wi = 0; wi < nwarps; ++wi) {
    consts_kernel<<<grid, block, 0, stream>>>((const float*)i0,
                                              (const float*)i1s, ub[cur], cs,
                                              h, w);
    float err = INFINITY;
    int it = 0;
    while (err > eps2 && it < max_iters) {
      for (int j = 0; j < k_check; ++j) {
        iter_kernel<<<grid, block, 0, stream>>>(L, ub[cur], pb[cur],
                                                ub[1 - cur], pb[1 - cur],
                                                partials, j == k_check - 1);
        cur = 1 - cur;
      }
      bnlk_mean_of_partials<<<1, kMeanThreads, 0, stream>>>(
          partials, n_part, (float)n, err_dev);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      e = cudaMemcpyAsync(&err, err_dev, sizeof(float),
                          cudaMemcpyDeviceToHost, stream);
      if (e != cudaSuccess) return (int)e;
      e = cudaStreamSynchronize(stream);
      if (e != cudaSuccess) return (int)e;
      it += k_check;
    }
    total += it;
  }
  *(int*)iters = total;
  cudaMemcpyAsync(u, ub[cur], 2 * n * sizeof(float), cudaMemcpyDeviceToDevice,
                  stream);
  return (int)cudaGetLastError();
}
