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
// Shard form (parallel/flow.py). The state and constant buffers may hold
// a row block of the frame: rows y0 .. y0 + hb - 1 of an h-row level (a
// shard's own rows and the halo rows it takes from its neighbours), with
// the error summed over the rows it owns only. Border tests stay in the
// frame's coordinates, so they apply at the frame's true edges alone; the
// block's other edges read zeros, whose effect reaches one row further
// each iteration and so stays in the halo for a round of k iterations
// over a halo of k rows. round_kernel runs one such round in one launch
// and takes the stop-or-go decision across shards itself: every shard's
// launch writes its owned rows' sum to its slot of a small array on its
// device (one row per round parity; the caller copies the slots to the
// other devices), and the next round's launches add the previous round's
// slots in slot order, so that every shard on every device takes the same
// decision, and keep it in a flag on the device that the host reads
// behind the launches. The whole level is the block y0 = 0, hb = h that
// owns every row.
//
// Arithmetic policies keep each kernel's own semantics: K2Rule the clamp
// form of the threshold step and zero duals past the last column / row
// (bwd_nlkalman_tpu/flow/tvl1_fused.py:89-103, 236-253), K3Rule the where
// form with lo / hi masks and the reference's divergence at the first and
// last row and column (bwd_nlkalman_tpu/flow/tvl1_pallas.py:100-143). Both
// keep IEEE divisions and square roots, as their plain versions do.
// K2RuleBf16 is K2's state_dtype="bfloat16" (tvl1_fused.py:276, 285): each
// new dual is rounded to bfloat16 (to nearest, ties to even) and widened
// back as it is stored, so the duals hold bf16 values while u, the
// constants and all arithmetic stay float32. A float32 result one ulp off
// the plain version's can round to the other bfloat16 neighbour, a step
// 2^16 ulps wide that the next iterations spread; so this rule computes
// every product and sum on its own with the round-to-nearest intrinsics
// (no contraction into an FMA), in the plain version's order
// (flow/tvl1_fused.py::_one_iter): given the same constants, a round gives
// the plain round's bits, and K2's level kernel computes the constants so
// too (bicubic.cuh), so that a whole level gives the plain level's. The
// rule is a template policy, not a runtime branch: K2Rule's and K3Rule's
// instances are unchanged.
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
#include <cuda_bf16.h>
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
  int h, w, rows, tiles_y, tiles_x;  // h: the level's rows; tiles over the block
  float l_t, theta, taut;
  int hb, y0, own0, own1;  // block rows, its first row in the level, rows it owns
};

// The plan fields of L for a block of hb rows from row y0 of an h x w
// level, owning its rows own0 .. own1 - 1 (the whole level: hb = h, y0 =
// 0, own0 = 0, own1 = h).
__host__ inline void tile_block(TileLevel& L, int h, int w, int rows, int tiles_y,
                                int tiles_x, int hb, int y0, int own0, int own1) {
  L.h = h;
  L.w = w;
  L.rows = rows;
  L.tiles_y = tiles_y;
  L.tiles_x = tiles_x;
  L.hb = hb;
  L.y0 = y0;
  L.own0 = own0;
  L.own1 = own1;
}

// The primal update v + theta * (dx + dy) and |grad u| of the iteration,
// as the compiler contracts them (K2Rule, K3Rule); kSeparateOps: whether
// the rule rounds every operation on its own (K2's level kernel then
// computes its constants so too, bicubic.cuh).
struct ContractedSteps {
  static constexpr bool kSeparateOps = false;
  __device__ __forceinline__ static float primal(float v, float theta, float dx, float dy) {
    return v + theta * (dx + dy);
  }
  __device__ __forceinline__ static float norm(float ux, float uy) {
    return sqrtf(ux * ux + uy * uy);
  }
};

// K2: constants (x, y, z, w) = (i1wx, i1wy, nig = guarded -1/|grad|^2, rho_c).
struct K2Rule : ContractedSteps {
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

// K2 with bfloat16 dual planes: K2Rule's steps, each operation rounded on
// its own as the plain version's tensor operations are, and every stored
// dual rounded to bfloat16.
struct K2RuleBf16 : K2Rule {
  static constexpr bool kSeparateOps = true;
  __device__ __forceinline__ static void threshold(float4 c, float u1, float u2,
                                                   float l_t, float* v) {
    const float rho = __fadd_rn(__fadd_rn(c.w, __fmul_rn(c.x, u1)), __fmul_rn(c.y, u2));
    const float fi = fminf(fmaxf(__fmul_rn(rho, c.z), -l_t), l_t);
    v[0] = __fadd_rn(u1, __fmul_rn(fi, c.x));
    v[1] = __fadd_rn(u2, __fmul_rn(fi, c.y));
  }
  __device__ __forceinline__ static float primal(float v, float theta, float dx, float dy) {
    return __fadd_rn(v, __fmul_rn(theta, __fadd_rn(dx, dy)));
  }
  __device__ __forceinline__ static float norm(float ux, float uy) {
    return __fsqrt_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)));
  }
  __device__ __forceinline__ static float scale(float taut, float g) {
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(taut, g)));
  }
  __device__ __forceinline__ static float dual(float p, float d, float taut, float s) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fadd_rn(p, __fmul_rn(taut, d)), s)));
  }
};

// K3: constants (x, y, z, w) = (i1wx, i1wy, grad = |grad|^2, rho_c).
struct K3Rule : ContractedSteps {
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
// L.rows x kTileCols floats) whose first row is the level's row gy0. A thread's pixels are rows row0,
// row0 + kTileRowStep, ... of its column (loops unrolled to the most rows
// a region has, so that a thread's pixels overlap). Iteration j computes
// only the rows the interior still needs after it (each iteration needs
// one more row on each side than the next), whole warps at a time. Border
// rules are tested at each pixel in global coordinates, so no pixel of
// the frame reads one past it. Returns the thread's sum of the squared
// update of the last iteration over the interior's in-frame pixels of the
// rows the block owns when want_err, else 0.
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
        un[q] = Rule::primal(v[q], L.theta, dx, dy);
      }
      const int by = gy - L.y0;
      if (last && own_x && r >= KT && r < KT + th && by >= L.own0 && by < L.own1) {
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
        const float f = Rule::scale(L.taut, Rule::norm(ux, uy));
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

// Writes the in-block pixels of tile's interior from shared memory to dst
// (6 planes of hb*w); band_only: only those within KT of the interior's
// edge, all that the neighbours' halos read.
template <int KT>
__device__ __forceinline__ void write_interior(const TileLevel& L, float* dst,
                                               int tile, bool band_only) {
  constexpr int TW = kTileCols - 2 * KT;
  extern __shared__ float sm[];
  const size_t n = (size_t)L.hb * L.w;
  const int plane = L.rows * kTileCols, th = L.rows - 2 * KT;
  const int col = threadIdx.x % kTileCols, row0 = threadIdx.x / kTileCols;
  const int gy0 = (tile / L.tiles_x) * th - KT;
  const int gx = (tile % L.tiles_x) * TW - KT + col;
  if (gx < 0 || gx >= L.w || col < KT || col >= KT + TW) return;
  const bool band_col = col < 2 * KT || col >= TW;
  for (int r = row0; r < L.rows; r += kTileRowStep) {
    const int gy = gy0 + r;
    if (r < KT || r >= KT + th || gy >= L.hb) continue;
    if (band_only && !band_col && r >= 2 * KT && r < th) continue;
    const int s = r * kTileCols + col;
    const size_t i = (size_t)gy * L.w + gx;
#pragma unroll
    for (int q = 0; q < 6; ++q) dst[q * n + i] = sm[q * plane + s];
  }
}

// One sub-round: n_iter (<= KT) iterations on every tile this block walks
// over, from src to dst (6 planes of hb*w each), with the constants cs (4
// planes). Tile rows are the block's. With partials non-null, each tile writes there the sum of its
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
  const size_t n = (size_t)L.hb * L.w;
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
      const bool in = in_x && gy >= 0 && gy < L.hb;
      const size_t i = in ? (size_t)gy * L.w + gx : 0;
#pragma unroll
      for (int q = 0; q < 6; ++q) sm[q * plane + s] = in ? __ldcg(src + q * n + i) : 0.0f;
      if (!full) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) sm[(6 + q) * plane + s] = in ? __ldcg(cs + q * n + i) : 0.0f;
    }
    __syncthreads();
    const bool want_err = partials != nullptr;
    const float e = iterate<Rule, KT>(L, L.y0 + gy0, gx, n_iter, want_err);
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

// Whether the caller's plan (flow/tvl1_tile.py::tile_plan of the block's
// hb x w) is one these kernels take at depth KT, for a block inside the
// level that owns some of its own rows.
template <int KT>
__host__ bool tile_plan_ok(const TileLevel& L) {
  const int th = L.rows - 2 * KT;
  constexpr int TW = kTileCols - 2 * KT;
  return L.rows <= kTileMaxRows && th >= 1 && L.h >= 1 && L.w >= 1 && L.hb >= 1 &&
         L.y0 >= 0 && L.y0 + L.hb <= L.h && 0 <= L.own0 && L.own0 <= L.own1 &&
         L.own1 <= L.hb && L.tiles_y == (L.hb + th - 1) / th &&
         L.tiles_x == (L.w + TW - 1) / TW;
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

struct RoundArgs {
  TileLevel L;
  float* state;          // 6 planes of hb*w: the block's state in, the result out
  float* tmp;            // 6 planes: the other buffer of the ping-pong pair
  const float* cs;       // 4 planes
  float* partials;       // n_tiles tile sums
  float* sums;           // 2 x n_sums: each shard's owned sum, a row per round parity
  int* flag;             // the device's stop-or-go: 0 once a round's check held
  int k;                 // iterations of the round
  int slot, n_sums;      // this shard's slot of sums, and the shards
  int round;             // the round of the warp stage: 0 runs at once
  float eps2, size;      // the check: sum of the previous round's slots / size > eps2
  int* counter;          // device counter or null: += count when the round runs
  int count;
};

// Whether round a.round runs: round 0 always; a later one where the flag
// still says go and the previous round's sums, added in slot order, over
// the level's size exceed eps2 (the whole-frame stopping loop's check,
// solve_stage). Every block of every shard takes the same decision; block
// 0 stores it in the flag, which a block may read before or after that
// store: where the store changes it to 0 the check failed anyway.
__device__ __forceinline__ bool round_go(const RoundArgs& a) {
  bool go = true;
  if (a.round > 0) {
    const float* prev = a.sums + ((a.round - 1) & 1) * a.n_sums;
    float s = 0.0f;
    for (int j = 0; j < a.n_sums; ++j) s += __ldcg(prev + j);
    go = *(volatile int*)a.flag != 0 && s / a.size > a.eps2;
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *(volatile int*)a.flag = go ? 1 : 0;
  return go;
}

// One round of k iterations on a block (the shard form above), in
// sub-rounds of at most KT, where round_go says so (else nothing runs);
// the block's own rows' sum of the squared update of the last iteration,
// summed over its tiles in a fixed order, goes to its slot of sums.
template <class Rule, int KT>
__global__ void __launch_bounds__(kTileThreads, 1) round_kernel(RoundArgs a) {
  if (!round_go(a)) return;
  const int n_tiles = a.L.tiles_y * a.L.tiles_x;
  cg::grid_group grid = cg::this_grid();
  float* const sb[2] = {a.state, a.tmp};
  int cur = 0;
  for (int done = 0; done < a.k;) {
    const int m = min(KT, a.k - done);
    done += m;
    tile_pass<Rule, KT>(a.L, sb[cur], sb[1 - cur], a.cs, m,
                        done == a.k ? a.partials : nullptr, done == m);
    grid.sync();
    cur = 1 - cur;
  }
  if ((int)gridDim.x >= n_tiles) {  // resident tiles wrote bands only
    if ((int)blockIdx.x < n_tiles) write_interior<KT>(a.L, sb[cur], blockIdx.x, false);
    grid.sync();
  }
  if (cur == 1) {  // the last sub-round wrote tmp: copy it into state
    const size_t n6 = 6 * (size_t)a.L.hb * a.L.w;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n6;
         i += (size_t)gridDim.x * blockDim.x)
      a.state[i] = __ldcg(a.tmp + i);
  }
  if (blockIdx.x == 0) {
    float s = 0.0f;
    for (int t = threadIdx.x; t < n_tiles; t += kTileThreads) s += __ldcg(a.partials + t);
    s = block_total(s);
    if (threadIdx.x == 0) {
      a.sums[(a.round & 1) * a.n_sums + a.slot] = s;
      if (a.counter != nullptr) *a.counter += a.count;
    }
  }
}

// One round of Rule on a block (round_kernel): the C entries of K2
// (tvl1_level.cu) and K3 (tvl1_block.cu) with their own scalars.
template <class Rule>
__host__ int launch_round(void* state, const void* consts, void* tmp, void* partials,
                          void* sums, void* flag, void* counter, int count, int h, int w,
                          int hb, int y0, int own0, int own1, int k, int slot,
                          int n_sums, int round, double epsilon, float l_t,
                          float theta, float taut, int kt, int rows, int tiles_y,
                          int tiles_x, cudaStream_t stream) {
  if (k < 1 || kt != kTileDepth || n_sums < 1 || slot < 0 || slot >= n_sums || round < 0)
    return (int)cudaErrorInvalidValue;
  RoundArgs a;
  tile_block(a.L, h, w, rows, tiles_y, tiles_x, hb, y0, own0, own1);
  a.L.l_t = l_t;
  a.L.theta = theta;
  a.L.taut = taut;
  if (!tile_plan_ok<kTileDepth>(a.L)) return (int)cudaErrorInvalidValue;
  a.state = (float*)state;
  a.tmp = (float*)tmp;
  a.cs = (const float*)consts;
  a.partials = (float*)partials;
  a.sums = (float*)sums;
  a.flag = (int*)flag;
  a.k = k;
  a.slot = slot;
  a.n_sums = n_sums;
  a.round = round;
  a.eps2 = (float)(epsilon * epsilon);
  a.size = (float)((double)h * w);
  a.counter = (int*)counter;
  a.count = count;
  return launch_tiles(round_kernel<Rule, kTileDepth>, &a, a.L, stream);
}

}  // namespace
