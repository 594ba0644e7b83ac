// Catmull-Rom bicubic sampling: the cubic and the footprint test, shared
// by K2's sampler (bnlk_bicubic_at, below; the TV-L1 level kernel's warp
// stage) and K4's (warp_tap.cuh); and K2's warp-stage constants, shared by
// K2's level kernel and K4's TV-L1 entry in K2's form.
//
// Semantics of the JAX package's warps (bwd_nlkalman_tpu/ops/warp.py):
// at absolute coordinates (cx, cy) the tap base is floor(c) - 1, the
// 4x4 footprint is base + {0..3}, and the sample is valid only where the
// whole footprint lies inside the frame. Every output the pipeline reads
// is zeroed where the footprint leaves the frame, so no pad value is ever
// used and only the bounds test is needed. The y-cubic runs first, per
// tap column, then the x-cubic (ops/warp.py:117-121, 229-236).
//
// kSeparate (K2's bfloat16 rule, tvl1_tile.cuh): every operation rounded
// on its own, in the order PyTorch evaluates the plain version
// (ops/warp.py::_cubic, flow/tvl1_fused.py::tvl1_stage_consts_plain), so
// that the constants are the plain version's bits; without it, as the
// compiler contracts them. The instances without it are unchanged.
#pragma once

__device__ __forceinline__ float bnlk_cubic(float v0, float v1, float v2,
                                            float v3, float x) {
  return v1 + 0.5f * x *
                  (v2 - v0 +
                   x * (2.0f * v0 - 5.0f * v1 + 4.0f * v2 - v3 +
                        x * (3.0f * (v1 - v2) + v3 - v0)));
}

// bnlk_cubic with every operation rounded on its own, in _cubic's order.
__device__ __forceinline__ float bnlk_cubic_rn(float v0, float v1, float v2,
                                               float v3, float x) {
  const float c = __fsub_rn(__fadd_rn(__fmul_rn(3.0f, __fsub_rn(v1, v2)), v3), v0);
  const float b = __fadd_rn(
      __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(2.0f, v0), __fmul_rn(5.0f, v1)),
                          __fmul_rn(4.0f, v2)), v3),
      __fmul_rn(x, c));
  return __fadd_rn(v1, __fmul_rn(__fmul_rn(0.5f, x),
                                 __fadd_rn(__fsub_rn(v2, v0), __fmul_rn(x, b))));
}

template <bool kSeparate>
__device__ __forceinline__ float bnlk_cubic_as(float v0, float v1, float v2,
                                               float v3, float x) {
  if constexpr (kSeparate) {
    return bnlk_cubic_rn(v0, v1, v2, v3, x);
  } else {
    return bnlk_cubic(v0, v1, v2, v3, x);
  }
}

// Whether the footprint at the floored coordinates (flx, fly) lies inside
// an h x w frame. The test runs on the floored floats, so a huge or
// non-finite coordinate is invalid and never reaches an integer conversion.
__device__ __forceinline__ bool bnlk_footprint_in(float flx, float fly, int h,
                                                  int w) {
  return (flx - 1.0f >= 0.0f) && (flx + 2.0f <= (float)(w - 1)) &&
         (fly - 1.0f >= 0.0f) && (fly + 2.0f <= (float)(h - 1));
}

// K2's sampler: the C-channel image `im` (H, W, C interleaved) at
// (cx, cy). Writes C values to `out` (zero where invalid) and returns
// validity.
template <bool kSeparate = false>
__device__ __forceinline__ bool bnlk_bicubic_at(const float* __restrict__ im,
                                                int h, int w, int c, float cx,
                                                float cy, float* out) {
  const float flx = floorf(cx), fly = floorf(cy);
  const bool valid = bnlk_footprint_in(flx, fly, h, w);
  if (!valid) {
    for (int ch = 0; ch < c; ++ch) out[ch] = 0.0f;
    return false;
  }
  const int bx = (int)flx - 1, by = (int)fly - 1;
  const float fx = cx - flx, fy = cy - fly;
  for (int ch = 0; ch < c; ++ch) {
    float cols[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* p = im + ((size_t)by * w + (bx + i)) * c + ch;
      const size_t rs = (size_t)w * c;
      cols[i] = bnlk_cubic_as<kSeparate>(p[0], p[rs], p[2 * rs], p[3 * rs], fy);
    }
    out[ch] = bnlk_cubic_as<kSeparate>(cols[0], cols[1], cols[2], cols[3], fx);
  }
  return true;
}

// K2's constants of a warp stage at one pixel (bwd_nlkalman_tpu/flow/
// tvl1_fused.py:200-209): from the warped (I1, I1x, I1y) = (i1w, i1wx,
// i1wy), the flow (u1, u2) and i0, writes i1wx, i1wy, nig = -1/|grad|^2
// (0 where |grad|^2 < 1e-10) and rho_c = i1w - i1wx u1 - i1wy u2 - i0 to
// out[0], out[n], out[2n], out[3n]. One function, so that K2's level
// kernel and a shard's constants (K4, warp.cu) are rounded alike.
template <bool kSeparate = false>
__device__ __forceinline__ void bnlk_k2_consts(float i1w, float i1wx, float i1wy,
                                               float u1, float u2, float i0,
                                               float* out, size_t n) {
  out[0] = i1wx;
  out[n] = i1wy;
  if constexpr (kSeparate) {
    const float grad = __fadd_rn(__fmul_rn(i1wx, i1wx), __fmul_rn(i1wy, i1wy));
    out[2 * n] = grad < 1e-10f ? 0.0f : -__fdiv_rn(1.0f, fmaxf(grad, 1e-10f));
    out[3 * n] = __fsub_rn(__fsub_rn(__fsub_rn(i1w, __fmul_rn(i1wx, u1)),
                                     __fmul_rn(i1wy, u2)), i0);
  } else {
    const float grad = i1wx * i1wx + i1wy * i1wy;
    out[2 * n] = grad < 1e-10f ? 0.0f : -1.0f / fmaxf(grad, 1e-10f);
    out[3 * n] = i1w - i1wx * u1 - i1wy * u2 - i0;
  }
}
