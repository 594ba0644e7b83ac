// G: the banded separable product, out_p = scale * Ay (X_p Ax^T) for each
// plane X_p of a batch, the flow's presmoothing blur, pyramid zoom-outs
// and flow zoom-ins (ops/gaussian.py, ops/zoom.py, flow/tvl1.py).
//
// Replaces no TPU kernel. The JAX package applies its numpy-built axis
// matrices as dense products, which XLA gives the TPU's matrix unit; the
// port took them as dense fp32 cuBLAS products, and more than 99% of
// their multiply-adds were by zero (a 1080p flow: some 46 GFLOP, against
// rows of 9 blur, 11 zoom-out and 4 resample taps). G applies each axis
// matrix in its band form (ops/band_cuda.py): row i's first input index
// lo[i] and its T weights M[i, lo[i] .. lo[i] + T - 1], T the widest row.
//
// What bounds it on this card. By bytes, a 1080p pair's blur (33 MB) is
// 9.9 us at 3.35 TB/s; a tile has to stage the rows its y-band reaches
// beyond its own, and shared-memory reads and the issue of the two passes'
// FMAs, not DRAM, set its time (36 us on an H100). The design: a block
// owns an output tile of tile_y rows by tile_x columns of one plane,
// stages the input rows and columns its bands cover in shared memory
// (16-byte loads where the plane's rows allow), runs the x-pass over those
// rows into a shared fp32 intermediate and the y-pass from there, so the
// intermediate never reaches device memory. The wrapper takes the tallest
// tile whose shared memory leaves four blocks an SM, so that few rows are
// staged twice; each thread owns one column and sums kRows staged rows per
// weight it reads. The small pyramid levels take 4-9 us a call, bound by
// latency and launch: one launch serves every plane of a call.
//
// The arithmetic: each output is acc = 0, then acc = fmaf(w[t], x[lo + t],
// acc) for t ascending, the band's zero taps at in-range indices (where
// fma(0, x, acc) == acc), the x-pass rounded to fp32 before the y-pass.
// The sum is not split, reordered or reassociated, and nothing is built
// with fast-math, so every output is one fixed, ascending fp32 chain. The
// dense cuBLAS products are not: on this card most of the flow's shapes
// take kernels that sum in k-slices of their own, so G's bits differ from
// theirs in the last places of some outputs, within the rounding any
// order of the same sums allows (tests/test_torch_kernels_cuda.py holds
// G to the chain's bits and the dense products to that bound).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // staged rows a thread's x-pass sums at once

struct Args {
  const float* in;     // plane p, row y, column x at in[p*isp + y*isy + x*isx]
  float* out;          // the same with osp, osy, osx
  const int* band_y;   // (ho, 1 + ty): lo, then the weights' float bits
  const int* band_x;   // (wo, 1 + tx)
  int h, w, ho, wo, ty, tx;
  int isp, isy, isx, osp, osy, osx;
  int tile_y, tile_x;
  int rows, pitch;     // the staged input's rows and row pitch, at most
  float scale;
  int vec;             // stage with float4 loads (unit x stride, rows of 4k floats)
};

// Shared memory, in 4-byte words: the staged input (rows, rounded up to
// kRows, x pitch), the intermediate (rows x tile_x), the tile's x-band (tx
// weights by column, then lo) and y-band (ty weights by row, then lo).
__host__ __device__ inline int staged_rows(const Args& a) {
  return (a.rows + kRows - 1) / kRows * kRows;
}

__host__ __device__ inline int smem_words(const Args& a) {
  return staged_rows(a) * a.pitch + a.rows * a.tile_x + (a.tx + 1) * a.tile_x +
         (a.ty + 1) * a.tile_y;
}

__global__ void __launch_bounds__(kThreads) band_sep_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* const in_s = reinterpret_cast<float*>(smem4);
  float* const mid_s = in_s + staged_rows(a) * a.pitch;
  float* const wx_s = mid_s + a.rows * a.tile_x;
  int* const lox_s = reinterpret_cast<int*>(wx_s + a.tx * a.tile_x);
  float* const wy_s = reinterpret_cast<float*>(lox_s + a.tile_x);
  int* const loy_s = reinterpret_cast<int*>(wy_s + a.ty * a.tile_y);
  __shared__ int bounds[4];  // least and largest lo of the tile's rows, then columns

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * a.tile_y, j0 = blockIdx.x * a.tile_x;
  const int ni = min(a.tile_y, a.ho - i0), nj = min(a.tile_x, a.wo - j0);
  // the tile's bands into shared memory, weights transposed
  for (int k = tid; k < ni * (a.ty + 1); k += kThreads) {
    const int r = k / (a.ty + 1), t = k - r * (a.ty + 1);
    const int v = a.band_y[(long long)(i0 + r) * (a.ty + 1) + t];
    if (t == 0)
      loy_s[r] = v;
    else
      wy_s[(t - 1) * a.tile_y + r] = __int_as_float(v);
  }
  for (int k = tid; k < nj * (a.tx + 1); k += kThreads) {
    const int c = k / (a.tx + 1), t = k - c * (a.tx + 1);
    const int v = a.band_x[(long long)(j0 + c) * (a.tx + 1) + t];
    if (t == 0)
      lox_s[c] = v;
    else
      wx_s[(t - 1) * a.tile_x + c] = __int_as_float(v);
  }
  __syncthreads();
  // the input range each block derives from its own lo (lo need not be
  // monotone): warp 0 reduces the rows' lo, warp 1 the columns'
  if (tid < 64) {
    const int* const lo = tid < 32 ? loy_s : lox_s;
    const int n = tid < 32 ? ni : nj;
    int least = INT_MAX, most = INT_MIN;
    for (int k = tid % 32; k < n; k += 32) {
      least = min(least, lo[k]);
      most = max(most, lo[k]);
    }
    least = __reduce_min_sync(0xffffffffu, least);
    most = __reduce_max_sync(0xffffffffu, most);
    if (tid % 32 == 0) {
      bounds[2 * (tid / 32)] = least;
      bounds[2 * (tid / 32) + 1] = most;
    }
  }
  __syncthreads();
  const int ry0 = bounds[0], nr = bounds[1] + a.ty - ry0;
  const int cx0 = a.vec ? (bounds[2] & ~3) : bounds[2];
  const int nc = a.vec ? ((bounds[3] + a.tx - cx0 + 3) & ~3) : bounds[3] + a.tx - cx0;
  // a band that leaves its axis, or a tile past the wrapper's plan
  if (ry0 < 0 || bounds[1] + a.ty > a.h || bounds[2] < 0 || cx0 + nc > a.w ||
      nr > a.rows || nc > a.pitch)
    __trap();

  const float* __restrict__ src = a.in + (long long)blockIdx.z * a.isp;
  if (a.vec) {
    const int nq = nc >> 2;
    for (int k = tid; k < nr * nq; k += kThreads) {
      const int r = k / nq, q = k - r * nq;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          src + (long long)(ry0 + r) * a.isy + cx0 + 4 * q));
      *reinterpret_cast<float4*>(in_s + r * a.pitch + 4 * q) = v;
    }
  } else {
    for (int k = tid; k < nr * nc; k += kThreads) {
      const int r = k / nc, c = k - r * nc;
      in_s[r * a.pitch + c] =
          __ldg(src + (long long)(ry0 + r) * a.isy + (long long)(cx0 + c) * a.isx);
    }
  }
  __syncthreads();

  // x-pass (rows first, as the dense route's X Ax^T): each thread one
  // column of the tile, kRows staged rows at a time, one weight read for
  // the kRows sums, each sum its own ascending chain; the rows past nr
  // read the staged rows' padding and are not kept
  const int c = tid % a.tile_x, group = tid / a.tile_x, groups = kThreads / a.tile_x;
  if (c < nj) {
    const float* const w = wx_s + c;
    const float* const xc = in_s + (lox_s[c] - cx0);
    for (int r0 = group * kRows; r0 < nr; r0 += groups * kRows) {
      const float* const x = xc + r0 * a.pitch;
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < a.tx; ++t) {
        const float wt = w[t * a.tile_x];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = fmaf(wt, x[j * a.pitch + t], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < nr) mid_s[(r0 + j) * a.tile_x + c] = acc[j];
    }
  }
  __syncthreads();

  // y-pass, each thread one column of the tile, then the scale of the
  // rounded sum
  if (c < nj) {
    float* __restrict__ const dst =
        a.out + (long long)blockIdx.z * a.osp + (long long)(j0 + c) * a.osx;
    for (int r = group; r < ni; r += groups) {
      const float* const m = mid_s + (loy_s[r] - ry0) * a.tile_x + c;
      const float* const w = wy_s + r;
      float acc = 0.0f;
#pragma unroll 4
      for (int t = 0; t < a.ty; ++t) acc = fmaf(w[t * a.tile_y], m[t * a.tile_x], acc);
      dst[(long long)(i0 + r) * a.osy] = acc * a.scale;
    }
  }
}

}  // namespace

// One launch over p planes; the wrapper (ops/band_cuda.py) plans the tile
// and the staged rows and pitch from the band forms, and checks shapes.
extern "C" int bnlk_band_sep(const void* in, void* out, const void* band_y,
                             const void* band_x, int p, int h, int w, int ho, int wo,
                             int ty, int tx, int isp, int isy, int isx, int osp,
                             int osy, int osx, int tile_y, int tile_x, int rows,
                             int pitch, float scale, int vec, void* stream) {
  if (p < 1 || p > 65535 || h < 1 || w < 1 || ho < 1 || wo < 1 || ty < 1 || tx < 1 ||
      tile_y < 1 || tile_x < 1 || kThreads % tile_x || rows < ty ||
      pitch < tx || (vec && (pitch % 4 || isx != 1 || isy % 4 || isp % 4 || w % 4)) ||
      (ho + tile_y - 1) / tile_y > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)in, (float*)out, (const int*)band_y, (const int*)band_x,
               h, w, ho, wo, ty, tx, isp, isy, isx, osp, osy, osx,
               tile_y, tile_x, rows, pitch, scale, vec};
  const size_t smem = 4 * (size_t)smem_words(a);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_sep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((wo + tile_x - 1) / tile_x, (ho + tile_y - 1) / tile_y, p);
  band_sep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
