// Design variants of K4's warp (csrc/warp.cu), kept to rerun the
// comparison its design rests on: tools/warp_bench.py --variants builds
// this file into a library of its own, never into the port's, and times
// each variant on the main path's warps, checked against the plain
// version. Every variant samples with K4's sampler (csrc/warp_tap.cuh)
// and takes 1-3 channels:
// - "gather TYxPY/B": csrc/warp.cu's warp at another geometry (TY rows of
//   32 threads, PY pixel rows a thread) or register cap (an SM must hold
//   B blocks); "gather 4x2/16" is csrc/warp.cu's own;
// - "staged B/budget": the staged design. Each block takes the bounding
//   box of its valid pixels' footprints (invalid pixels, whose
//   coordinates may be huge or non-finite, are left out) and, where the
//   box's C planes fit `budget` bytes of shared memory, loads the box
//   with cp.async (rows coalesced, channels planar, the stride padded by
//   one) and takes the taps from there; a block whose box does not fit
//   gathers from global memory as csrc/warp.cu does. Budget 0 runs that
//   gather path alone, at the staged kernel's registers.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_tap.cuh"

namespace {

struct Args {
  const float* im;
  const float* flow;
  const float* occl;
  float* out;
  uint8_t* valid;
  int h, w;
  cudaStream_t stream;
  bool query;  // return the kernel's registers a thread, launch nothing
};

template <int C>
__device__ __forceinline__ void store(float* out, size_t idx, const float (&res)[C]) {
  if constexpr (C % 2 == 0) {
#pragma unroll
    for (int ch = 0; ch < C; ch += 2)
      reinterpret_cast<float2*>(out + idx * C)[ch / 2] = make_float2(res[ch], res[ch + 1]);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[idx * C + ch] = res[ch];
  }
}

template <int C, int TY, int PY, int B>
__global__ void __launch_bounds__(32 * TY, B)
    gather_kernel(const float* __restrict__ im, const float* __restrict__ flow,
                  const float* __restrict__ occl, float* __restrict__ out,
                  uint8_t* __restrict__ valid, int h, int w) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y0 = blockIdx.y * TY * PY + threadIdx.y;
  const auto taps = k4_global_taps<C, C>(im, w, C, C);
#pragma unroll
  for (int q = 0; q < PY; ++q) {
    const int y = y0 + q * TY;
    if (y >= h || x >= w) continue;
    const size_t idx = (size_t)y * w + x;
    const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + idx);
    float res[C];
    const bool ok = k4_sample<C, C>((float)x + f.x, (float)y + f.y, h, w, C,
                                    occl == nullptr || occl[idx] == 0.0f, taps, res);
    store<C>(out, idx, res);
    valid[idx] = ok ? 1 : 0;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

template <int C, int TY, int PY, int B, int BUDGET>
__global__ void __launch_bounds__(32 * TY, B)
    staged_kernel(const float* __restrict__ im, const float* __restrict__ flow,
                  const float* __restrict__ occl, float* __restrict__ out,
                  uint8_t* __restrict__ valid, int h, int w) {
  constexpr int kWords = BUDGET > 0 ? BUDGET / 4 : 1;
  __shared__ float win[kWords];
  // least x, least y, -largest x, -largest y of the valid pixels' tap bases
  __shared__ int box[4];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y0 = blockIdx.y * TY * PY + threadIdx.y;
  if (tid < 4) box[tid] = INT_MAX;
  float cx[PY], cy[PY];
  bool live[PY];
  int b[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
  for (int q = 0; q < PY; ++q) {
    const int y = y0 + q * TY;
    cx[q] = cy[q] = 0.0f;
    live[q] = false;
    if (y >= h || x >= w) continue;
    const size_t idx = (size_t)y * w + x;
    const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + idx);
    cx[q] = (float)x + f.x;
    cy[q] = (float)y + f.y;
    live[q] = occl == nullptr || occl[idx] == 0.0f;
    const float flx = floorf(cx[q]), fly = floorf(cy[q]);
    if (live[q] && bnlk_footprint_in(flx, fly, h, w)) {
      const int bx = (int)flx - 1, by = (int)fly - 1;
      b[0] = min(b[0], bx);
      b[1] = min(b[1], by);
      b[2] = min(b[2], -bx);
      b[3] = min(b[3], -by);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = __reduce_min_sync(0xffffffffu, b[k]);
  __syncthreads();  // box initialised
  if (threadIdx.x == 0 && b[0] != INT_MAX)
    for (int k = 0; k < 4; ++k) atomicMin(&box[k], b[k]);
  __syncthreads();
  const int ox = box[0], oy = box[1];
  const bool any = ox != INT_MAX;
  const int bw = any ? -box[2] - ox + 4 : 0, bh = any ? -box[3] - oy + 4 : 0;
  const int stride = bw + 1;
  const bool fits = BUDGET > 0 && any && (long long)C * bh * stride <= kWords;
  if (fits) {  // the same for the whole block
    const int n = bw * C;  // floats of one box row, channels interleaved
    for (int r = threadIdx.y; r < bh; r += TY) {
      const float* src = im + ((size_t)(oy + r) * w + ox) * C;
      for (int e = threadIdx.x; e < n; e += 32)
        cp_async4(&win[((e % C) * bh + r) * stride + e / C], src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  const auto from_win = [&](int by, int bx) {
    const float* base = win + (by - oy) * stride + (bx - ox);
    const int plane = bh * stride;
    return [=](int k, int i, float(&t)[C]) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) t[ch] = base[ch * plane + k * stride + i];
    };
  };
  const auto from_global = k4_global_taps<C, C>(im, w, C, C);
#pragma unroll
  for (int q = 0; q < PY; ++q) {
    const int y = y0 + q * TY;
    if (y >= h || x >= w) continue;
    const size_t idx = (size_t)y * w + x;
    float res[C];
    const bool ok =
        fits ? k4_sample<C, C>(cx[q], cy[q], h, w, C, live[q], from_win, res)
             : k4_sample<C, C>(cx[q], cy[q], h, w, C, live[q], from_global, res);
    store<C>(out, idx, res);
    valid[idx] = ok ? 1 : 0;
  }
}

template <typename K>
int run(K kernel, int tile_h, int ty, const Args& a) {
  if (a.query) {
    cudaFuncAttributes at;
    return cudaFuncGetAttributes(&at, kernel) == cudaSuccess ? at.numRegs : -1;
  }
  const dim3 grid((a.w + 31) / 32, (a.h + tile_h - 1) / tile_h);
  kernel<<<grid, dim3(32, ty), 0, a.stream>>>(a.im, a.flow, a.occl, a.out, a.valid,
                                              a.h, a.w);
  return (int)cudaGetLastError();
}

template <int TY, int PY, int B>
int gather(int c, const Args& a) {
  switch (c) {
    case 1: return run(gather_kernel<1, TY, PY, B>, TY * PY, TY, a);
    case 2: return run(gather_kernel<2, TY, PY, B>, TY * PY, TY, a);
    case 3: return run(gather_kernel<3, TY, PY, B>, TY * PY, TY, a);
    default: return a.query ? -1 : (int)cudaErrorInvalidValue;
  }
}

template <int B, int BUDGET>
int staged(int c, const Args& a) {
  switch (c) {
    case 1: return run(staged_kernel<1, 4, 2, B, BUDGET>, 8, 4, a);
    case 2: return run(staged_kernel<2, 4, 2, B, BUDGET>, 8, 4, a);
    case 3: return run(staged_kernel<3, 4, 2, B, BUDGET>, 8, 4, a);
    default: return a.query ? -1 : (int)cudaErrorInvalidValue;
  }
}

const char* const kNames[] = {
    "gather 4x2/16", "gather 4x2/12", "gather 4x2/8",    "gather 4x4/16",
    "gather 4x1/16", "gather 2x2/32", "gather 8x1/8",    "staged 8/32768",
    "staged 8/8192", "staged 8/0",    "staged 16/8192", "staged 16/0",
};
constexpr int kCount = sizeof(kNames) / sizeof(kNames[0]);

int dispatch(int i, int c, const Args& a) {
  switch (i) {
    case 0: return gather<4, 2, 16>(c, a);
    case 1: return gather<4, 2, 12>(c, a);
    case 2: return gather<4, 2, 8>(c, a);
    case 3: return gather<4, 4, 16>(c, a);
    case 4: return gather<4, 1, 16>(c, a);
    case 5: return gather<2, 2, 32>(c, a);
    case 6: return gather<8, 1, 8>(c, a);
    case 7: return staged<8, 32768>(c, a);
    case 8: return staged<8, 8192>(c, a);
    case 9: return staged<8, 0>(c, a);
    case 10: return staged<16, 8192>(c, a);
    case 11: return staged<16, 0>(c, a);
    default: return a.query ? -1 : (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bnlk_warp_variant_count() { return kCount; }

extern "C" const char* bnlk_warp_variant_name(int i) {
  return i >= 0 && i < kCount ? kNames[i] : nullptr;
}

// Registers a thread of variant i's kernel for c channels; -1 if none.
extern "C" int bnlk_warp_variant_regs(int i, int c) {
  return dispatch(i, c, Args{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr, true});
}

// Variant i of bnlk_warp (csrc/warp.cu) on a whole frame: its arguments
// after i, without the row offset and count.
extern "C" int bnlk_warp_variant(int i, const void* im, const void* flow, const void* occl,
                                 void* out, void* valid, int h, int w, int c, void* stream) {
  if (h < 1 || w < 1 || ((uintptr_t)im & 7) || ((uintptr_t)flow & 7))
    return (int)cudaErrorInvalidValue;
  return dispatch(i, c, Args{(const float*)im, (const float*)flow, (const float*)occl,
                             (float*)out, (uint8_t*)valid, h, w, (cudaStream_t)stream,
                             false});
}
