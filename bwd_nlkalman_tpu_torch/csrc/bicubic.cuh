// Catmull-Rom bicubic sampling shared by the warp kernel (K4) and the
// TV-L1 level kernel's warp stage (K2).
//
// Semantics of the JAX package's warps (bwd_nlkalman_tpu/ops/warp.py):
// at absolute coordinates (cx, cy) the tap base is floor(c) - 1, the
// 4x4 footprint is base + {0..3}, and the sample is valid only where the
// whole footprint lies inside the frame. Every output the pipeline reads
// is zeroed where the footprint leaves the frame, so no pad value is ever
// used and only the bounds test is needed. The y-cubic runs first, per
// tap column, then the x-cubic (ops/warp.py:117-121, 229-236).
#pragma once

__device__ __forceinline__ float bnlk_cubic(float v0, float v1, float v2,
                                            float v3, float x) {
  return v1 + 0.5f * x *
                  (v2 - v0 +
                   x * (2.0f * v0 - 5.0f * v1 + 4.0f * v2 - v3 +
                        x * (3.0f * (v1 - v2) + v3 - v0)));
}

// Samples the C-channel image `im` (H, W, C interleaved) at (cx, cy).
// Writes C values to `out` (zero where invalid) and returns validity.
// The bounds test runs on the floored floats, so a huge or non-finite
// coordinate never reaches an integer conversion.
__device__ __forceinline__ bool bnlk_bicubic_at(const float* __restrict__ im,
                                                int h, int w, int c, float cx,
                                                float cy, float* out) {
  const float flx = floorf(cx), fly = floorf(cy);
  const bool valid = (flx - 1.0f >= 0.0f) && (flx + 2.0f <= (float)(w - 1)) &&
                     (fly - 1.0f >= 0.0f) && (fly + 2.0f <= (float)(h - 1));
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
      cols[i] = bnlk_cubic(p[0], p[rs], p[2 * rs], p[3 * rs], fy);
    }
    out[ch] = bnlk_cubic(cols[0], cols[1], cols[2], cols[3], fx);
  }
  return true;
}
