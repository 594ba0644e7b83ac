// K4: bicubic warp of a C-channel image along a flow field.
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/ops/warp_pallas.py:59
// (_warp_kernel, launched by bicubic_warp_pallas). That kernel avoided
// gathers, which are slow on the TPU, by shift-selecting over the source
// held in VMEM. A GPU gathers well, so this is one direct 16-tap gather
// per pixel and channel with the same base and tap semantics.
//
// What bounds it on the card: device-memory bytes. Per pixel it reads the
// flow (2 floats) and 16 taps per channel, which neighbouring threads
// share through L1/L2 for smooth flow, and writes C floats and one byte.
// A 1080p 2-channel warp takes 0.064 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py). Design: one thread per pixel, consecutive threads on
// consecutive pixels so the flow reads and the output writes are
// coalesced; the taps come through the cache. No shared memory, nothing
// to tile.
#include <cstdint>
#include <cuda_runtime.h>

#include "bicubic.cuh"

namespace {

constexpr int kMaxC = 8;

__global__ void warp_kernel(const float* __restrict__ im,
                            const float* __restrict__ flow,
                            const float* __restrict__ occl,
                            float* __restrict__ out,
                            uint8_t* __restrict__ valid, int h, int w, int c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int y = idx / w, x = idx - y * w;
  const float cx = (float)x + flow[2 * idx];
  const float cy = (float)y + flow[2 * idx + 1];
  float v[kMaxC];
  bool ok = bnlk_bicubic_at(im, h, w, c, cx, cy, v);
  if (occl != nullptr && occl[idx] != 0.0f) ok = false;
  for (int ch = 0; ch < c; ++ch) out[(size_t)idx * c + ch] = ok ? v[ch] : 0.0f;
  valid[idx] = ok ? 1 : 0;
}

}  // namespace

extern "C" int bnlk_warp(const void* im, const void* flow, const void* occl,
                         void* out, void* valid, int h, int w, int c,
                         void* stream) {
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  const int n = h * w, threads = 256;
  warp_kernel<<<(n + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(
      (const float*)im, (const float*)flow, (const float*)occl, (float*)out,
      (uint8_t*)valid, h, w, c);
  return (int)cudaGetLastError();
}
