// K2: one whole TV-L1 pyramid level (all warp stages and primal-dual
// iterations of Dual_TVL1_optic_flow, tvl1flow_lib.c:93-275) in one
// cooperative launch.
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/flow/tvl1_fused.py:65
// (_level_kernel, launched by tvl1_single_scale_fused), which holds the
// whole level in VMEM and runs its stopping while_loop inside the kernel.
// Here the level state lives in device memory and one launch runs, with
// grid-wide barriers between its phases:
//
//   - the start: the flow planes from u_init, the dual planes zero, and
//     (I1, I1x, I1y) with the centred gradient on a replicated border
//     (mask.c:172-208), interleaved for the sampler;
//   - per warp stage, the constants: bicubic warp of (I1, I1x, I1y) along
//     u with bnlk_bicubic_at (bicubic.cuh), then i1wx, i1wy, nig = guarded
//     -1/|grad I1w|^2 and rho_c, one thread per pixel;
//   - per warp stage, the stopping loop of the tile engine
//     (tvl1_tile.cuh): rounds of k_check iterations in sub-rounds of at
//     most KT on shared-memory tiles, the error of each round's last
//     iteration summed in a fixed order and the decision taken on the
//     device;
//   - the end: the flow of the last state into u.
//
// K2's own semantics, not the XLA path's (K2Rule): the clamp form of the
// threshold step fi = clip(rho * nig, -l_t, l_t) (tvl1_fused.py:200-209,
// 236-242); dual planes zero at the last column / row with the divergence
// that follows (:89-103, 243-253); the error over in-frame pixels on the
// last iteration of each round only (:268-285); the count rising in whole
// rounds of k_check. With bf16_duals, K2's state_dtype="bfloat16"
// (tvl1_fused.py:276, 285, 378): the dual planes are rounded to bfloat16 as
// each iteration stores them (K2RuleBf16), one more instance of each
// kernel; u, the constants and the arithmetic stay float32, each
// operation rounded on its own as the plain version's, the warp stage's
// constants too, so that a level gives the plain level's bits.
//
// No host read or stream synchronisation inside the level: the number of
// iterations run is added to a device counter.
//
// The shard form (bnlk_tvl1_level_round, parallel/flow.py) runs one round
// of k_check iterations under K2Rule on a shard's row block with its halo
// (tvl1_tile.cuh, round_kernel): a launch cannot trade halo rows with
// another device, so the caller runs a level's rounds one launch each,
// the constants from K4's TV-L1 entry in K2's form, and each launch takes
// its round's stop-or-go from every shard's sum of the round before. What
// bounds it on the card, and what the design does about it: tvl1_tile.cuh.
#include <cuda_runtime.h>

#include "bicubic.cuh"
#include "tvl1_tile.cuh"

namespace {

struct LevelArgs {
  TileLevel L;
  const float* i0;      // (h, w)
  const float* i1;      // (h, w)
  const float* u_init;  // (h, w, 2)
  float* u;             // (h, w, 2): the result
  float* buf;           // 2 states of 6 planes, 4 constant planes, 3 planes
                        // of (I1, I1x, I1y), 2 * n_tiles partials
  int nwarps, k_check, max_iters;
  float eps2;
  int* iters;           // device counter: += iterations run over all warp stages
};

template <class Rule, int KT>
__global__ void __launch_bounds__(kTileThreads, 1) level_kernel(LevelArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.L.h, w = a.L.w;
  const size_t n = (size_t)h * w;
  float* const sb[2] = {a.buf, a.buf + 6 * n};
  float* cs = a.buf + 12 * n;
  float* i1s = a.buf + 16 * n;
  float* partials = a.buf + 19 * n;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = t0; i < n; i += stride) {
    const int y = (int)(i / w), x = (int)(i % w);
    sb[0][i] = a.u_init[2 * i];
    sb[0][n + i] = a.u_init[2 * i + 1];
    for (int q = 2; q < 6; ++q) sb[0][q * n + i] = 0.0f;
    const float* row = a.i1 + (size_t)y * w;
    i1s[3 * i] = row[x];
    i1s[3 * i + 1] = 0.5f * (row[min(x + 1, w - 1)] - row[max(x - 1, 0)]);
    i1s[3 * i + 2] = 0.5f * (a.i1[(size_t)min(y + 1, h - 1) * w + x] -
                             a.i1[(size_t)max(y - 1, 0) * w + x]);
  }
  grid.sync();
  int cur = 0, parity = 0, total = 0;
  for (int wi = 0; wi < a.nwarps; ++wi) {
    const float* u = sb[cur];
    for (size_t i = t0; i < n; i += stride) {
      const int y = (int)(i / w), x = (int)(i % w);
      const float u1 = __ldcg(u + i), u2 = __ldcg(u + n + i);
      float s[3];
      bnlk_bicubic_at<Rule::kSeparateOps>(i1s, h, w, 3, (float)x + u1, (float)y + u2, s);
      bnlk_k2_consts<Rule::kSeparateOps>(s[0], s[1], s[2], u1, u2, a.i0[i], cs + i, n);
    }
    grid.sync();
    total += solve_stage<Rule, KT>(a.L, sb, cur, cs, a.k_check, a.max_iters,
                                   a.eps2, (float)n, partials, parity, nullptr);
  }
  for (size_t i = t0; i < n; i += stride) {
    a.u[2 * i] = __ldcg(sb[cur] + i);
    a.u[2 * i + 1] = __ldcg(sb[cur] + n + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters += total;
}

}  // namespace

// i0, i1: (h, w); u_init: (h, w, 2) initial flow; u: (h, w, 2) receives the
// result. scratch holds 19 planes of h*w floats plus 2 * tiles_y * tiles_x.
// kt is the tile depth, rows the region's rows and tiles_y x tiles_x the
// tile grid the caller planned (flow/tvl1_tile.py::tile_plan); iters is a
// device int that receives += the iterations run over all warp stages.
// bf16_duals (0 or 1) selects the bfloat16 dual planes.
extern "C" int bnlk_tvl1_level(const void* i0, const void* i1,
                               const void* u_init, void* u, void* scratch,
                               int h, int w, int nwarps,
                               double tau, float lambda, double theta,
                               double epsilon, int k_check, int max_iters,
                               int kt, int rows, int tiles_y,
                               int tiles_x, void* iters, int bf16_duals,
                               void* stream) {
  if (h < 1 || w < 1 || nwarps < 0 || k_check < 1) return (int)cudaErrorInvalidValue;
  LevelArgs a;
  tile_block(a.L, h, w, rows, tiles_y, tiles_x, h, 0, 0, h);
  a.L.l_t = lambda * (float)theta;
  a.L.theta = (float)theta;
  a.L.taut = (float)(tau / theta);
  a.i0 = (const float*)i0;
  a.i1 = (const float*)i1;
  a.u_init = (const float*)u_init;
  a.u = (float*)u;
  a.buf = (float*)scratch;
  a.nwarps = nwarps;
  a.k_check = k_check;
  a.max_iters = max_iters;
  a.eps2 = (float)(epsilon * epsilon);
  a.iters = (int*)iters;
  cudaStream_t st = (cudaStream_t)stream;
  if (kt != kTileDepth || !tile_plan_ok<kTileDepth>(a.L) || (bf16_duals & ~1))
    return (int)cudaErrorInvalidValue;
  return bf16_duals ? launch_tiles(level_kernel<K2RuleBf16, kTileDepth>, &a, a.L, st)
                    : launch_tiles(level_kernel<K2Rule, kTileDepth>, &a, a.L, st);
}

// One round of k iterations under K2Rule on a row block (the shard form):
// state (in/out), tmp: 6 planes of hb*w floats, rows y0 .. y0 + hb - 1 of
// an h x w level; consts: 4 planes (i1wx, i1wy, nig, rho_c); partials:
// tiles_y * tiles_x floats; sums: 2 x n_sums floats, slot (round & 1) *
// n_sums + slot receiving the sum of the squared update of the round's
// last iteration over the owned rows own0 .. own1 - 1; flag: the device's
// int stop-or-go, which round 0 sets and a later round clears (running
// nothing) where the previous round's sums / (h * w) <= epsilon^2
// (tvl1_tile.cuh, round_go); iters (or null): a device int that receives
// += k when the round runs; bf16_duals (0 or 1) the bfloat16 dual planes.
// The plan is tile_plan(hb, w).
extern "C" int bnlk_tvl1_level_round(void* state, const void* consts, void* tmp,
                                     void* partials, void* sums, void* flag, void* iters,
                                     int h, int w, int hb, int y0, int own0,
                                     int own1, int k, int slot, int n_sums, int round,
                                     double epsilon, double tau, float lambda,
                                     double theta, int kt, int rows, int tiles_y,
                                     int tiles_x, int bf16_duals, void* stream) {
  if (bf16_duals & ~1) return (int)cudaErrorInvalidValue;
  auto launch = bf16_duals ? &launch_round<K2RuleBf16> : &launch_round<K2Rule>;
  return launch(state, consts, tmp, partials, sums, flag, iters, k, h, w, hb, y0, own0, own1,
                k, slot, n_sums, round, epsilon, lambda * (float)theta, (float)theta,
                (float)(tau / theta), kt, rows, tiles_y, tiles_x, (cudaStream_t)stream);
}
