// The tile-iteration engine of the TV-L1 kernels K2 (tvl1_level.cu) and K3
// (tvl1_block.cu): Jacobi iterations of the primal-dual scheme on
// shared-memory tiles with temporal blocking, and the stopping rule decided
// on the device.
//
// Tiles. A thread block holds a region of `rows` x kTileCols pixels in
// shared memory: the six state planes (u1, u2, p11, p12, p21, p22) and the
// four constant planes. The region is an interior of (rows - 2 KT) x
// (kTileCols - 2 KT) pixels and a halo of KT pixels on each side; the block
// runs up to KT iterations on it before it writes its interior back to the
// other buffer of a ping-pong pair. The primal step reads the duals to the
// left and above, the dual step the new primal to the right and below, so
// each iteration leaves one more pixel of each side stale: after KT
// iterations the interior is still exact. Halo pixels compute garbage that
// never reaches the interior (iteration j computes only the rows the
// interior still needs), and border tests use global coordinates (as the
// TPU kernel's gy / gx iotas do), so a tile edge is never a frame edge.
// Each iteration computes the primal once per pixel into shared memory,
// synchronises, then takes the dual step in place. `rows` is chosen per
// level by the caller (flow/tvl1_tile.py::tile_plan) so that the tiles
// fill the card's SMs in as few waves as possible.
//
// Rounds. A round of k iterations (K2's k_check, K3's k_iters) is split
// into sub-rounds of at most KT, one pass over all tiles each, separated
// by a grid-wide barrier: the kernel is one cooperative launch whose
// blocks walk over the tiles. On a round's last iteration each tile writes
// its partial sum of the squared update (its own in-frame pixels, in a
// fixed order); after the barrier every block adds the partials in the
// same fixed order, so all blocks take the same stop / go-on decision,
// and runs are deterministic (no float atomics). The host never reads the
// error inside a level.
//
// Arithmetic policies keep each kernel's own semantics: K2Rule the clamp
// form of the threshold step and zero duals past the last column / row
// (bwd_nlkalman_tpu/flow/tvl1_fused.py:89-103, 236-253), K3Rule the where
// form with lo / hi masks and the reference's divergence at the first and
// last row and column (bwd_nlkalman_tpu/flow/tvl1_pallas.py:100-143). Both
// keep IEEE divisions and square roots, as their plain versions do.
//
// What likely bounds it on the card (no kernel profiler runs there):
// instruction issue. A pixel iteration compiles to about 100 (K2) to 150
// (K3) instructions, many of them in the IEEE divisions and square roots,
// and 30 shared-memory accesses; device memory moves 64 bytes a pixel once
// per sub-round, not once per iteration. The constants sit in shared
// memory rather than registers, so that a block of 1024 threads (32 warps
// an SM) fits in 64 registers a thread.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTileDepth = 4;       // KT, the iterations of a sub-round at most
constexpr int kTileCols = 128;      // region columns, halo included
constexpr int kTileMaxRows = 44;    // region rows at most: 10 planes in 227 KB
constexpr int kTileThreads = 1024;
constexpr int kTileRowStep = kTileThreads / kTileCols;  // rows a pass covers
constexpr int kTilePlanes = 10;     // 6 state planes, 4 constant planes
constexpr float kGradIsZero = 1e-10f;  // tvl1flow_lib.c:26
static_assert(kTileThreads % kTileCols == 0, "whole region rows per step");

__host__ __device__ constexpr size_t tile_smem(int rows) {
  return (size_t)kTilePlanes * rows * kTileCols * sizeof(float);
}

struct TileLevel {
  int h, w, rows, tiles_y, tiles_x;
  float l_t, theta, taut;
};

// K2: constants (x, y, z, w) = (i1wx, i1wy, nig = guarded -1/|grad|^2, rho_c).
struct K2Rule {
  __device__ __forceinline__ static void threshold(float4 c, float u1, float u2,
                                                   float l_t, float* v) {
    const float rho = c.w + c.x * u1 + c.y * u2;
    const float fi = fminf(fmaxf(rho * c.z, -l_t), l_t);
    v[0] = u1 + fi * c.x;
    v[1] = u2 + fi * c.y;
  }
  // backward difference with a zero dual before the first column / row
  __device__ __forceinline__ static float diff(float p, float p_prev, int g, int) {
    return p - (g > 0 ? p_prev : 0.0f);
  }
  // the dual step, with s = scale(taut, |grad u|)
  __device__ __forceinline__ static float scale(float taut, float g) {
    return 1.0f / (1.0f + taut * g);
  }
  __device__ __forceinline__ static float dual(float p, float d, float taut, float s) {
    return (p + taut * d) * s;
  }
};

// K3: constants (x, y, z, w) = (i1wx, i1wy, grad = |grad|^2, rho_c).
struct K3Rule {
  __device__ __forceinline__ static void threshold(float4 c, float u1, float u2,
                                                   float l_t, float* v) {
    const float grad = c.z;
    const float rho = c.w + c.x * u1 + c.y * u2;
    const float fi = grad < kGradIsZero ? 0.0f : -rho / fmaxf(grad, kGradIsZero);
    const bool lo = rho < -l_t * grad, hi = rho > l_t * grad;
    v[0] = u1 + (lo ? l_t * c.x : (hi ? -l_t * c.x : fi * c.x));
    v[1] = u2 + (lo ? l_t * c.y : (hi ? -l_t * c.y : fi * c.y));
  }
  // first column / row the value itself, last minus the previous value
  __device__ __forceinline__ static float diff(float p, float p_prev, int g, int n) {
    return g == 0 ? p : (g == n - 1 ? -p_prev : p - p_prev);
  }
  __device__ __forceinline__ static float scale(float taut, float g) { return 1.0f + taut * g; }
  __device__ __forceinline__ static float dual(float p, float d, float taut, float s) {
    return (p + taut * d) / s;
  }
};

// The block's sum of v in a fixed order, returned to every thread.
__device__ __forceinline__ float block_total(float v) {
  __shared__ float total;
  const float s = bnlk_block_sum<kTileThreads>(v);
  if (threadIdx.x == 0) total = s;
  __syncthreads();
  const float r = total;
  __syncthreads();
  return r;
}

// n_iter (<= KT) iterations of the region held in shared memory (planes of
// L.rows x kTileCols floats). A thread's pixels are rows row0,
// row0 + kTileRowStep, ... of its column (loops unrolled to the most rows
// a region has, so that a thread's pixels overlap). Iteration j computes
// only the rows the interior still needs after it (each iteration needs
// one more row on each side than the next), whole warps at a time. Border
// rules are tested at each pixel in global coordinates, so no pixel of
// the frame reads one past it. Returns the thread's sum of the squared
// update of the last iteration over the interior's in-frame pixels when
// want_err, else 0.
template <class Rule, int KT>
__device__ __forceinline__ float iterate(const TileLevel& L, int gy0, int gx,
                                         int n_iter, bool want_err) {
  extern __shared__ float sm[];
  const int plane = L.rows * kTileCols, th = L.rows - 2 * KT;
  constexpr int TW = kTileCols - 2 * KT;
  const int col = threadIdx.x % kTileCols, row0 = threadIdx.x / kTileCols;
  const bool own_x = col >= KT && col < KT + TW && gx < L.w;
  float e = 0.0f;
  for (int j = 0; j < n_iter; ++j) {
    const int lo = KT - (n_iter - 1 - j), hi = KT + th + (n_iter - 1 - j);
    const bool last = want_err && j == n_iter - 1;
    // primal: threshold step, then u + theta * div(p), in place (rows lo..hi)
#pragma unroll
    for (int i = 0; i <= kTileMaxRows / kTileRowStep; ++i) {
      const int r = row0 + i * kTileRowStep;
      if (r >= L.rows || r < lo || r > hi) continue;
      const int gy = gy0 + r, s = r * kTileCols + col;
      const float u1 = sm[s], u2 = sm[plane + s];
      const float4 c = make_float4(sm[6 * plane + s], sm[7 * plane + s],
                                   sm[8 * plane + s], sm[9 * plane + s]);
      float v[2];
      Rule::threshold(c, u1, u2, L.l_t, v);
      float un[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* pa = sm + (2 + 2 * q) * plane;  // p11 / p21
        const float* pb = sm + (3 + 2 * q) * plane;  // p12 / p22
        const float dx = Rule::diff(pa[s], pa[s - 1], gx, L.w);
        const float dy = Rule::diff(pb[s], pb[s - kTileCols], gy, L.h);
        un[q] = v[q] + L.theta * (dx + dy);
      }
      if (last && own_x && r >= KT && r < KT + th && gy < L.h) {
        const float d1 = un[0] - u1, d2 = un[1] - u2;
        e += d1 * d1;
        e += d2 * d2;
      }
      sm[s] = un[0];
      sm[plane + s] = un[1];
    }
    __syncthreads();
    // dual: forward differences of the new primal, in place (rows lo..hi-1)
#pragma unroll
    for (int i = 0; i <= kTileMaxRows / kTileRowStep; ++i) {
      const int r = row0 + i * kTileRowStep;
      if (r >= L.rows || r < lo || r >= hi) continue;
      const int gy = gy0 + r, s = r * kTileCols + col;
      const bool has_r = gx < L.w - 1, has_d = gy < L.h - 1;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* u = sm + q * plane;
        const float ux = has_r ? u[s + 1] - u[s] : 0.0f;
        const float uy = has_d ? u[s + kTileCols] - u[s] : 0.0f;
        const float f = Rule::scale(L.taut, sqrtf(ux * ux + uy * uy));
        float* pa = sm + (2 + 2 * q) * plane;
        float* pb = sm + (3 + 2 * q) * plane;
        pa[s] = Rule::dual(pa[s], ux, L.taut, f);
        pb[s] = Rule::dual(pb[s], uy, L.taut, f);
      }
    }
    __syncthreads();
  }
  return e;
}

// Writes the in-frame pixels of tile's interior from shared memory to dst
// (6 planes of h*w); band_only: only those within KT of the interior's
// edge, all that the neighbours' halos read.
template <int KT>
__device__ __forceinline__ void write_interior(const TileLevel& L, float* dst,
                                               int tile, bool band_only) {
  constexpr int TW = kTileCols - 2 * KT;
  extern __shared__ float sm[];
  const size_t n = (size_t)L.h * L.w;
  const int plane = L.rows * kTileCols, th = L.rows - 2 * KT;
  const int col = threadIdx.x % kTileCols, row0 = threadIdx.x / kTileCols;
  const int gy0 = (tile / L.tiles_x) * th - KT;
  const int gx = (tile % L.tiles_x) * TW - KT + col;
  if (gx < 0 || gx >= L.w || col < KT || col >= KT + TW) return;
  const bool band_col = col < 2 * KT || col >= TW;
  for (int r = row0; r < L.rows; r += kTileRowStep) {
    const int gy = gy0 + r;
    if (r < KT || r >= KT + th || gy >= L.h) continue;
    if (band_only && !band_col && r >= 2 * KT && r < th) continue;
    const int s = r * kTileCols + col;
    const size_t i = (size_t)gy * L.w + gx;
#pragma unroll
    for (int q = 0; q < 6; ++q) dst[q * n + i] = sm[q * plane + s];
  }
}

// One sub-round: n_iter (<= KT) iterations on every tile this block walks
// over, from src to dst (6 planes of h*w each), with the constants cs (4
// planes). With partials non-null, each tile writes there the sum of its
// squared update on the last iteration. State written earlier in the same
// launch is read with __ldcg (through L2, never a stale L1 line). Where
// the grid has a block for every tile, each block keeps its tile in shared
// memory from one sub-round to the next (solve_stage writes the whole
// interiors at the stage's end): it writes back only the band its
// neighbours' halos read, and unless reload (the first sub-round of a warp
// stage) reads only its own halo ring, not the constants.
template <class Rule, int KT>
__device__ void tile_pass(const TileLevel& L, const float* src, float* dst,
                          const float* cs, int n_iter, float* partials,
                          bool reload) {
  constexpr int TW = kTileCols - 2 * KT;
  extern __shared__ float sm[];
  const size_t n = (size_t)L.h * L.w;
  const int plane = L.rows * kTileCols, th = L.rows - 2 * KT;
  const int col = threadIdx.x % kTileCols, row0 = threadIdx.x / kTileCols;
  const int n_tiles = L.tiles_y * L.tiles_x;
  const bool resident = (int)gridDim.x >= n_tiles, full = reload || !resident;
  const bool ring_col = col < KT || col >= KT + TW;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int gy0 = (tile / L.tiles_x) * th - KT;
    const int gx0 = (tile % L.tiles_x) * TW - KT, gx = gx0 + col;
    const bool in_x = gx >= 0 && gx < L.w;
    __syncthreads();  // the previous tile's write-back is done with sm
    for (int r = row0; r < L.rows; r += kTileRowStep) {
      if (!full && !ring_col && r >= KT && r < KT + th) continue;
      const int gy = gy0 + r, s = r * kTileCols + col;
      const bool in = in_x && gy >= 0 && gy < L.h;
      const size_t i = in ? (size_t)gy * L.w + gx : 0;
#pragma unroll
      for (int q = 0; q < 6; ++q) sm[q * plane + s] = in ? __ldcg(src + q * n + i) : 0.0f;
      if (!full) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) sm[(6 + q) * plane + s] = in ? __ldcg(cs + q * n + i) : 0.0f;
    }
    __syncthreads();
    const bool want_err = partials != nullptr;
    const float e = iterate<Rule, KT>(L, gy0, gx, n_iter, want_err);
    if (want_err) {
      const float s = bnlk_block_sum<kTileThreads>(e);
      if (threadIdx.x == 0) partials[tile] = s;
    }
    write_interior<KT>(L, dst, tile, resident);
  }
}

// The stopping loop of one warp stage: while err > eps2 and it < max_iters,
// a round of k_round iterations (it += k_round), the error measured on the
// round's last iteration over the frame and divided by size. Every block
// runs it with the same decisions. sb[cur] holds the state on entry and on
// return; partials holds 2 * n_tiles floats, one half per round parity
// (a block may still read one round's partials while another block writes
// the next round's). Returns the iterations run; *err_out (if non-null)
// receives the last round's error.
template <class Rule, int KT>
__device__ int solve_stage(const TileLevel& L, float* const sb[2], int& cur,
                           const float* cs, int k_round, int max_iters,
                           float eps2, float size, float* partials,
                           int& parity, float* err_out) {
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = L.tiles_y * L.tiles_x;
  float err = INFINITY;
  int it = 0;
  while (err > eps2 && it < max_iters) {
    float* part = partials + parity * n_tiles;
    for (int done = 0; done < k_round;) {
      const int m = min(KT, k_round - done);
      done += m;
      tile_pass<Rule, KT>(L, sb[cur], sb[1 - cur], cs, m,
                          done == k_round ? part : nullptr, it == 0 && done == m);
      grid.sync();
      cur = 1 - cur;
    }
    float s = 0.0f;
    for (int k = threadIdx.x; k < n_tiles; k += kTileThreads) s += __ldcg(part + k);
    err = block_total(s) / size;
    parity = 1 - parity;
    it += k_round;
  }
  if (it > 0 && (int)gridDim.x >= n_tiles) {  // resident tiles wrote bands only
    if ((int)blockIdx.x < n_tiles) write_interior<KT>(L, sb[cur], blockIdx.x, false);
    grid.sync();
  }
  if (err_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *err_out = err;
  return it;
}

// Whether the caller's plan (flow/tvl1_tile.py::tile_plan) is one these
// kernels take for an h x w level at depth KT.
template <int KT>
__host__ bool tile_plan_ok(const TileLevel& L) {
  const int th = L.rows - 2 * KT;
  constexpr int TW = kTileCols - 2 * KT;
  return L.rows <= kTileMaxRows && th >= 1 && L.h >= 1 && L.w >= 1 &&
         L.tiles_y == (L.h + th - 1) / th && L.tiles_x == (L.w + TW - 1) / TW;
}

// One cooperative launch of kern (one argument, *args) with as many blocks
// as can be resident at once, at most one per tile; a launch that cannot
// be co-resident is refused with an error, never run another way.
template <class Kernel>
__host__ int launch_tiles(Kernel kern, void* args, const TileLevel& L,
                          cudaStream_t stream) {
  const size_t smem = tile_smem(L.rows);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_smem(kTileMaxRows));
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kTileThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = min(L.tiles_y * L.tiles_x, per_sm * sms);
  void* kargs[] = {args};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kTileThreads),
                                  kargs, smem, stream);
  return (int)e;
}

}  // namespace
