// K4: bicubic warp of a C-channel image along a flow field, and the
// constants of a TV-L1 warp stage.
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/ops/warp_pallas.py:59
// (_warp_kernel, launched by bicubic_warp_pallas). That kernel avoided
// gathers, which are slow on the TPU, by shift-selecting over the source
// held in VMEM. A GPU gathers well: this is a direct 16-tap gather per
// pixel with the same base and tap semantics.
//
// What bounds it on the card: not the bytes. A 1080p 2-channel warp
// moves 25 B a pixel, 0.0155 ms at 3.35 TB/s; the first version of this
// kernel (one thread a pixel, 256 a block, an integer division each,
// 16 x C scalar taps, the mask copied to bool by a second kernel) took
// 0.0341 ms of device time with the L2 hot and 0.0366 ms flushed along
// the main path's flow, on an H100 80GB HBM3 at 700 W
// (tools/warp_bench.py): the taps' load latency, with too few warps in
// flight to hide it, held it back. The design below was chosen among the
// variants of tools/warp_variants.cu, timed on that card by
// tools/warp_bench.py --variants (PERF.md, the findings on K4):
// - registers: the main path's channel counts (1, 2, 3) are built for 16
//   blocks of 128 threads an SM, the most it holds, so 32 registers a
//   thread; caps of 40 and 64 were timed against it. 6 and the generic
//   instance, whose taps need more registers, are built for 4;
// - no barrier: staging each block's source window (the bounding box of
//   its valid pixels' footprints) in shared memory with cp.async was
//   slower along the main path's flows: the window's load waits for the
//   block's flow, a box reduction and a barrier before any tap can be
//   read, and the window's shared memory costs resident blocks;
// - a tile of 32 x 8 pixels, 32 threads on consecutive x and 2 rows a
//   thread: each tap's warp-wide load covers one row of 32 pixels, and a
//   thread has two pixels' loads in flight; a 2-D grid, so no integer
//   division; flow read as float2;
// - the channel count a template parameter (1, 2, 3, 6, 9; any other
//   count up to 8 takes the generic instance): a tap's channels are one or
//   a few loads (float2 for even C) and the taps stay in registers
//   (warp_tap.cuh);
// - 9 channels, fsmo's warp of an RGB clip (flt1|flt2|smo, each 3), have
//   an instance of their own: every tap's 9 channels are read by the same
//   thread (36 B apart, in the line its first channel opened). Like 6, it
//   is built for 4 blocks an SM;
// - any count past 9 in one launch, by channel groups: the grid's third
//   dimension runs over groups of kK4GenericC channels (the last one
//   holds the rest), each block the generic instance on its group's
//   channels c0 .. c0 + n - 1 of every tap, read at the pixel stride c
//   from the interleaved (H, W, C) image, float2 loads where c is even
//   (then so is every group's first channel and width). Every group runs
//   the same footprint test on the same flow and occlusion; group 0
//   alone writes the mask. So one launch computes the one validity mask
//   that all the priors it warps share (fsmo's flt1|flt2|smo of a
//   4-channel clip is 12, the filter's pair of a 5-7-channel one 10-14),
//   as the 9-channel instance does, and no two parts can disagree on it;
//   each group reads the flow and occlusion again, 12 B a pixel a group
//   beside its 4 x 16 x n B of taps. A launch of 9 or fewer is one group:
//   the instances above, unchanged. A group gives the bits of the
//   one-group launch of its channels where that launch is the generic
//   instance too (4, 5, 7 or 8 channels), not those of the instances of
//   1, 2, 3 and 6, which the compiler contracts otherwise;
// - the mask written as the bytes of a torch.bool tensor: no second
//   kernel;
// - the TV-L1 entry reads u1 and u2 straight from the solver's (6, H, W)
//   state and writes the (4, H, W) constants {i1wx, i1wy, i1wx^2 +
//   i1wy^2, i1w - i1wx u1 - i1wy u2 - i0} from the same launch, each in
//   the order and rounding of the eager PyTorch composition it replaced
//   (12 launches and 0.198 ms of device time a 1080x1920 warp stage); in
//   K2's form (kConsts == 2) the third plane is nig = -1 / |grad|^2, zero
//   where |grad|^2 < 1e-10, as K2's threshold step takes it, every plane
//   from K2's own function (bnlk_k2_consts, bicubic.cuh); kConsts == 3 is
//   K2's form for its bfloat16 rule, the sample and the constants rounded
//   operation by operation as that rule's level kernel computes them;
// - the shard form (parallel/flow.py): both entries write the rows y0 ..
//   y0 + hb - 1 of an h-row frame, so the flow, occlusion, state, i0 and
//   outputs hold hb rows while the source holds the whole frame (the
//   reach of a tap is the flow's, which has no bound). y0 = 0 and hb = h
//   is the whole frame, with the same arithmetic.
//
// Arithmetic: K4's sampler (warp_tap.cuh), in the order and with the
// bounds test of K2's (bicubic.cuh): NaN flow stays invalid; an occluded
// pixel is invalid.
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_tap.cuh"

namespace {

// A block: kTY rows of 32 threads on consecutive x, each thread kPY pixel
// rows kTY apart, so a tile of 32 x 8 output pixels.
constexpr int kTX = 32, kTY = 4, kPY = 2;
constexpr int kTileW = kTX, kTileH = kTY * kPY;

// Blocks an SM should hold: for the main path's channel counts the 16 that
// 128-thread blocks can (32 registers a thread), 4 for the rest, whose
// taps need more registers.
template <int C>
constexpr int min_blocks() {
  return C >= 1 && C <= 3 ? 16 : 4;
}

// kConsts: 1, 2 or 3, the TV-L1 entry (C == 3) in K3's form, K2's, or
// K2's for its bfloat16 rule (every operation rounded on its own): flow
// from the planar state, the constants written planar; 0 the warp:
// interleaved flow in, out and the bool mask written. Output rows are the
// frame's rows y0 .. y0 + hb - 1; the source im holds all h rows. The
// generic instance (C == 0) computes the channels c0 .. c0 + n - 1 of
// the c_rt-channel image, its group blockIdx.z of kK4GenericC channels;
// kPair: its taps and outputs as float2.
template <int C, int kConsts, bool kPair = false>
__global__ void __launch_bounds__(kTX * kTY, min_blocks<C>())
    warp_tile_kernel(const float* __restrict__ im, const float* __restrict__ flow,
                     const float* __restrict__ aux, float* __restrict__ out,
                     uint8_t* __restrict__ valid, int h, int w, int c_rt, int y0,
                     int hb) {
  constexpr int CA = C > 0 ? C : kK4GenericC;
  const int c = C > 0 ? C : c_rt;
  const int c0 = C > 0 ? 0 : (int)blockIdx.z * kK4GenericC;
  const int n = C > 0 ? C : min(kK4GenericC, c - c0);
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int ly0 = blockIdx.y * kTileH + threadIdx.y;
  const size_t hw = (size_t)hb * w;
  const auto taps = k4_global_taps<C, CA, kPair>(im + c0, w, c, n);
#pragma unroll
  for (int q = 0; q < kPY; ++q) {
    const int ly = ly0 + q * kTY, y = y0 + ly;
    if (ly >= hb || x >= w) continue;
    const size_t idx = (size_t)ly * w + x;
    float u, v;
    if constexpr (kConsts != 0) {
      u = flow[idx];
      v = flow[hw + idx];
    } else {
      const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + idx);
      u = f.x;
      v = f.y;
    }
    const bool live = kConsts != 0 || aux == nullptr || aux[idx] == 0.0f;
    float res[CA];
    const bool ok = k4_sample<C, CA, kConsts == 3>((float)x + u, (float)y + v, h, w, n, live,
                                                   taps, res);
    if constexpr (kConsts == 1) {
      // the eager composition's order and rounding, no contraction
      const float gx = res[1], gy = res[2];
      out[idx] = gx;
      out[hw + idx] = gy;
      out[2 * hw + idx] = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
      out[3 * hw + idx] = __fsub_rn(
          __fsub_rn(__fsub_rn(res[0], __fmul_rn(gx, u)), __fmul_rn(gy, v)), aux[idx]);
    } else if constexpr (kConsts >= 2) {
      // K2's own constants (bicubic.cuh), rounded as its level kernel's
      bnlk_k2_consts<kConsts == 3>(res[0], res[1], res[2], u, v, aux[idx], out + idx, hw);
    } else {
      float* o = out + idx * c + c0;
      if constexpr ((C > 0 && C % 2 == 0) || (C == 0 && kPair)) {
#pragma unroll
        for (int ch = 0; ch < CA; ch += 2)
          if (C > 0 || ch < n)
            *reinterpret_cast<float2*>(o + ch) = make_float2(res[ch], res[ch + 1]);
      } else {
#pragma unroll
        for (int ch = 0; ch < CA; ++ch)
          if (C > 0 || ch < n) o[ch] = res[ch];
      }
      if (C > 0 || c0 == 0) valid[idx] = ok ? 1 : 0;
    }
  }
}

// The grid's third dimension runs over the generic instance's channel
// groups; an instance of C > 0 is one group.
template <int C, int kConsts, bool kPair = false>
int launch(const float* im, const float* flow, const float* aux, float* out,
           uint8_t* valid, int h, int w, int c, int y0, int hb, cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (hb + kTileH - 1) / kTileH,
                  C > 0 ? 1 : (c + kK4GenericC - 1) / kK4GenericC);
  warp_tile_kernel<C, kConsts, kPair><<<grid, dim3(kTX, kTY), 0, stream>>>(
      im, flow, aux, out, valid, h, w, c, y0, hb);
  return (int)cudaGetLastError();
}

// A frame the grid covers (at most 65535 tile rows), output rows inside
// it, and the 8-byte alignment of the float2 reads.
bool bad_args(const void* im, const void* flow, int h, int w, int y0, int hb) {
  return h < 1 || w < 1 || hb < 1 || y0 < 0 || y0 + hb > h ||
         (hb + kTileH - 1) / kTileH > 65535 || ((uintptr_t)im & 7) || ((uintptr_t)flow & 7);
}

}  // namespace

// im (H, W, C) interleaved, flow (hb, W, 2), occl (hb, W) or null, for
// the frame's rows y0 .. y0 + hb - 1; writes out (hb, W, C) and valid
// (hb, W) bytes 0/1. y0 = 0, hb = H: the whole frame. Any C >= 1: past
// kK4OneGroupC, groups of kK4GenericC channels in the same launch.
extern "C" int bnlk_warp(const void* im, const void* flow, const void* occl,
                         void* out, void* valid, int h, int w, int c, int y0, int hb,
                         void* stream) {
  if (c < 1 || (c + kK4GenericC - 1) / kK4GenericC > 65535 ||
      bad_args(im, flow, h, w, y0, hb))
    return (int)cudaErrorInvalidValue;
  const auto* i = (const float*)im;
  const auto* f = (const float*)flow;
  const auto* o = (const float*)occl;
  auto* r = (float*)out;
  auto* v = (uint8_t*)valid;
  auto s = (cudaStream_t)stream;
  if (c > kK4OneGroupC) {
    return c % 2 == 0 ? launch<0, 0, true>(i, f, o, r, v, h, w, c, y0, hb, s)
                      : launch<0, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
  }
  switch (c) {
    case 1: return launch<1, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
    case 2: return launch<2, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
    case 3: return launch<3, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
    case 6: return launch<6, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
    case 9: return launch<9, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
    default: return launch<0, 0>(i, f, o, r, v, h, w, c, y0, hb, s);
  }
}

// i1s (H, W, 3) = (I1, I1x, I1y), state (6, hb, W) whose planes 0 and 1
// are u1 and u2, i0 (hb, W), for the frame's rows y0 .. y0 + hb - 1;
// writes consts (4, hb, W): K3's form (nig = 0), K2's (nig = 1) or K2's for
// its bfloat16 rule (nig = 2).
extern "C" int bnlk_warp_tvl1_consts(const void* i1s, const void* state,
                                     const void* i0, void* consts, int h, int w,
                                     int y0, int hb, int nig, void* stream) {
  if (bad_args(i1s, state, h, w, y0, hb) || nig < 0 || nig > 2)
    return (int)cudaErrorInvalidValue;
  const auto* i = (const float*)i1s;
  const auto* st = (const float*)state;
  const auto* a = (const float*)i0;
  auto* o = (float*)consts;
  auto s = (cudaStream_t)stream;
  switch (nig) {
    case 0: return launch<3, 1>(i, st, a, o, nullptr, h, w, 3, y0, hb, s);
    case 1: return launch<3, 2>(i, st, a, o, nullptr, h, w, 3, y0, hb, s);
    default: return launch<3, 3>(i, st, a, o, nullptr, h, w, 3, y0, hb, s);
  }
}
