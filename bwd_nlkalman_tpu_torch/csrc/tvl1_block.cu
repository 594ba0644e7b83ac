// K3: the TV-L1 iterations of one warp stage on a level too large for K2's
// plan (the 1080x1920 level of a full-resolution flow), with their
// stopping rule, in one cooperative launch.
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/flow/tvl1_pallas.py:52
// (_tvl1_block_kernel, launched by tvl1_iter_block :186). On the TPU it
// runs k_iters = 24 iterations per row tile in VMEM with a 24-row halo,
// and its blocks run in a device lax.while_loop (:287-302). Here the tile
// engine (tvl1_tile.cuh) runs each block of k_iters iterations in
// sub-rounds of at most KT on shared-memory tiles with a KT-pixel halo,
// and the stopping rule, blocks of k_iters tested with n < max_iters and
// n += k_iters (a cap of 300 runs 312 iterations), is decided on the
// device from the fixed-order error sum of each block's last iteration.
//
// K3's own arithmetic (tvl1_pallas.py:100-159), not K2's (K3Rule):
//   - the where form of the threshold step, with the lo/hi masks against
//     l_t * grad and fi = -rho / max(grad, 1e-10) (zero where grad is);
//   - l_t = lambda * theta taken as a double product, then rounded to
//     float (the Python-float product of the TPU kernel, :64);
//   - the divergence with the reference's border rules: first column /
//     row the value itself, last column / row minus the previous value,
//     else the backward difference (:112-121);
//   - the error over the frame's pixels of the block's last iteration
//     only, divided by h*w (:156-159, 237).
//
// State: 6 planes (h, w) = u1, u2, p11, p12, p21, p22; constants: 4
// planes = i1wx, i1wy, grad, rho_c (the warp and the constants stay
// outside the kernel, as on the TPU, :269-285). What bounds it on the card,
// and what the design does about it: tvl1_tile.cuh.
//
// The shard form (bnlk_tvl1_stage_round, parallel/flow.py) runs one block
// of k_iters iterations under K3Rule on a shard's row block with its halo
// (tvl1_tile.cuh, round_kernel), the stop-or-go taken by the launch itself
// from every shard's sum of the round before.
#include <cuda_runtime.h>

#include "tvl1_tile.cuh"

namespace {

struct StageArgs {
  TileLevel L;
  float* state;       // 6 planes: the state in, the result out
  float* tmp;         // 6 planes: the other buffer of the ping-pong pair
  const float* cs;    // 4 planes
  float* partials;    // 2 * n_tiles
  int k_iters, max_iters;
  float eps2, size;
  float* err;         // the mean squared update of the last block
  int* blocks;        // the blocks of k_iters run
  int* blocks_total;  // device counter: += blocks run
};

template <int KT>
__global__ void __launch_bounds__(kTileThreads, 1) stage_kernel(StageArgs a) {
  float* const sb[2] = {a.state, a.tmp};
  int cur = 0, parity = 0;
  const int it = solve_stage<K3Rule, KT>(a.L, sb, cur, a.cs, a.k_iters,
                                         a.max_iters, a.eps2, a.size,
                                         a.partials, parity, a.err);
  if (cur == 1) {  // the last sub-round wrote tmp: copy it into state
    const size_t n6 = 6 * (size_t)a.L.h * a.L.w;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n6;
         i += (size_t)gridDim.x * blockDim.x)
      a.state[i] = __ldcg(a.tmp + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.blocks = it / a.k_iters;
    *a.blocks_total += it / a.k_iters;
  }
}

}  // namespace

// state (in/out), tmp: 6 planes of h*w floats; consts: 4 planes; partials:
// 2 * tiles_y * tiles_x floats; err: one float; blocks, blocks_total: one
// device int each. Runs blocks of k_iters iterations while the last
// block's mean squared update exceeds epsilon^2 and fewer than max_iters
// iterations ran (max_iters = k_iters runs exactly one block). kt is the
// tile depth, rows the region's rows and tiles_y x tiles_x the tile grid
// the caller planned (flow/tvl1_tile.py::tile_plan).
extern "C" int bnlk_tvl1_stage(void* state, const void* consts, void* tmp,
                               void* partials, void* err, void* blocks,
                               void* blocks_total, int h, int w, int k_iters,
                               int max_iters, double tau, double lambda,
                               double theta, double epsilon, int kt,
                               int rows, int tiles_y, int tiles_x,
                               void* stream) {
  if (k_iters < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  StageArgs a;
  tile_block(a.L, h, w, rows, tiles_y, tiles_x, h, 0, 0, h);
  a.L.l_t = (float)(lambda * theta);
  a.L.theta = (float)theta;
  a.L.taut = (float)(tau / theta);
  a.state = (float*)state;
  a.tmp = (float*)tmp;
  a.cs = (const float*)consts;
  a.partials = (float*)partials;
  a.k_iters = k_iters;
  a.max_iters = max_iters;
  a.eps2 = (float)(epsilon * epsilon);
  a.size = (float)((double)h * w);
  a.err = (float*)err;
  a.blocks = (int*)blocks;
  a.blocks_total = (int*)blocks_total;
  cudaStream_t st = (cudaStream_t)stream;
  if (kt != kTileDepth || !tile_plan_ok<kTileDepth>(a.L)) return (int)cudaErrorInvalidValue;
  return launch_tiles(stage_kernel<kTileDepth>, &a, a.L, st);
}

// One block of k iterations under K3Rule on a row block (the shard form):
// the arguments of bnlk_tvl1_level_round, with consts (i1wx, i1wy, grad,
// rho_c) and blocks (or null) a device int that receives += 1 when the
// round runs.
extern "C" int bnlk_tvl1_stage_round(void* state, const void* consts, void* tmp,
                                     void* partials, void* sums, void* flag, void* blocks,
                                     int h, int w, int hb, int y0, int own0,
                                     int own1, int k, int slot, int n_sums, int round,
                                     double epsilon, double tau, double lambda,
                                     double theta, int kt, int rows, int tiles_y,
                                     int tiles_x, void* stream) {
  return launch_round<K3Rule>(state, consts, tmp, partials, sums, flag, blocks, 1, h, w, hb,
                              y0, own0, own1, k, slot, n_sums, round, epsilon,
                              (float)(lambda * theta), (float)theta, (float)(tau / theta), kt,
                              rows, tiles_y, tiles_x, (cudaStream_t)stream);
}
