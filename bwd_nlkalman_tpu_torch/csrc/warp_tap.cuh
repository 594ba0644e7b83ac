// K4's bicubic sampler (warp.cu; tools/warp_variants.cu builds the design
// variants measured against it). The semantics and arithmetic order of
// K2's bnlk_bicubic_at, whose cubic and footprint test it uses
// (bicubic.cuh), with the channel count a template parameter: a tap's C
// channels are one or a few loads and the 16 x C taps stay in registers.
#pragma once

#include "bicubic.cuh"

// The most channels one group of a launch covers: fsmo's warp of an RGB
// clip, flt1|flt2|smo, is 3 x 3 (warp.cu); the generic instance holds up
// to kK4GenericC, the width of each group of a launch of more channels.
constexpr int kK4OneGroupC = 9;
constexpr int kK4GenericC = 8;

// Below, C > 0 is an instance for C channels, in CA = C slots; C == 0 the
// generic instance, n channels of a channel group in CA = kK4GenericC
// slots, read at a pixel stride of c channels.

// The n channels at p: float2 loads for even C, and in the generic
// instance where kPair (the pixel stride, the group's first channel and
// its width all even: then p is 8-byte aligned where the image is).
template <int C, int CA, bool kPair = false>
__device__ __forceinline__ void k4_load_px(const float* __restrict__ p, int n,
                                           float (&v)[CA]) {
  if constexpr (C > 0 && C % 2 == 0) {
#pragma unroll
    for (int ch = 0; ch < C; ch += 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p + ch));
      v[ch] = t.x;
      v[ch + 1] = t.y;
    }
  } else if constexpr (C == 0 && kPair) {
#pragma unroll
    for (int ch = 0; ch < CA; ch += 2)
      if (ch < n) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p + ch));
        v[ch] = t.x;
        v[ch + 1] = t.y;
      }
  } else {
#pragma unroll
    for (int ch = 0; ch < CA; ++ch)
      if (C > 0 || ch < n) v[ch] = __ldg(p + ch);
  }
}

// The sample at (cx, cy) of an h x w frame: the y-cubic per tap column
// first, then the x-cubic. taps(by, bx) gives the footprint whose top-left
// pixel is (bx, by) as a load tap(k, i, v) of the channels of pixel
// (bx + i, by + k) into v; the generic instance computes n of CA slots.
// Valid where `live` and the footprint lies in the frame; elsewhere res
// is 0 and no tap is read. kSeparate: the cubics rounded as the plain
// version's (bicubic.cuh).
template <int C, int CA, bool kSeparate = false, typename Taps>
__device__ __forceinline__ bool k4_sample(float cx, float cy, int h, int w,
                                          int n, bool live, Taps taps,
                                          float (&res)[CA]) {
  const float flx = floorf(cx), fly = floorf(cy);
  const bool ok = live && bnlk_footprint_in(flx, fly, h, w);
#pragma unroll
  for (int ch = 0; ch < CA; ++ch) res[ch] = 0.0f;
  if (ok) {
    const float fx = cx - flx, fy = cy - fly;
    const auto tap = taps((int)fly - 1, (int)flx - 1);
    float cols[4][CA];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t[4][CA];
#pragma unroll
      for (int k = 0; k < 4; ++k) tap(k, i, t[k]);
#pragma unroll
      for (int ch = 0; ch < CA; ++ch)
        if (C > 0 || ch < n)
          cols[i][ch] = bnlk_cubic_as<kSeparate>(t[0][ch], t[1][ch], t[2][ch], t[3][ch], fy);
    }
#pragma unroll
    for (int ch = 0; ch < CA; ++ch)
      if (C > 0 || ch < n)
        res[ch] = bnlk_cubic_as<kSeparate>(cols[0][ch], cols[1][ch], cols[2][ch], cols[3][ch],
                                           fx);
  }
  return ok;
}

// taps for k4_sample from the (H, W, c) interleaved image in global
// memory: one base pointer, the taps at constant offsets from its rows; n
// channels of each pixel from im's first (im points at a group's first
// channel), n == c for a whole pixel.
template <int C, int CA, bool kPair = false>
__device__ __forceinline__ auto k4_global_taps(const float* __restrict__ im, int w,
                                               int c, int n) {
  return [=](int by, int bx) {
    const float* base = im + ((size_t)by * w + bx) * c;
    const size_t rs = (size_t)w * c;
    return [=](int k, int i, float(&t)[CA]) {
      k4_load_px<C, CA, kPair>(base + k * rs + i * c, n, t);
    };
  };
}
