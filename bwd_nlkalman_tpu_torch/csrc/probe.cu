// P: the streaming-rate probe, chains of FMAs (or multiplies) on a plane.
//
// Replaces the Pallas kernel tools/vpu_probe.py:39 (_probe_kernel). Per
// element: x from the input, y = x*0.5 + 0.25, nchains accumulators
// a_c = x + c, k steps a_c = a_c*x + y (or a_c*x), then the sum of the
// accumulators written as float. The TPU kernel runs the whole plane at
// each of its GRID grid steps; here blockIdx.y is the grid step, so the
// plane is processed gridDim.y times and every step writes the same
// values. bf16 runs two elements per thread as __nv_bfloat162 with
// __hfma2 / __hmul2 (each step rounds once to bf16).
//
// What bounds it on the card: operations, by design. Each element does
// GRID * k * nchains FMAs on values in registers and moves 8 bytes; with
// one chain a thread waits out each FMA's latency, with several the
// chains overlap. This kernel exists to measure those rates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int NC, bool FMA>
__global__ void probe_f32(const float* __restrict__ a, float* __restrict__ out,
                          int n, int k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = a[i];
  const float y = x * 0.5f + 0.25f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = x + (float)c;
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = FMA ? fmaf(acc[c], x, y) : acc[c] * x;
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) s += acc[c];
  out[i] = s;
}

// n2 pairs of elements; the plane's element count is even.
template <int NC, bool FMA>
__global__ void probe_bf16(const float2* __restrict__ a,
                           float2* __restrict__ out, int n2, int k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 x = __float22bfloat162_rn(a[i]);
  const __nv_bfloat162 y = __hfma2(x, __float2bfloat162_rn(0.5f),
                                   __float2bfloat162_rn(0.25f));
  __nv_bfloat162 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = __hadd2(x, __float2bfloat162_rn((float)c));
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[c] = FMA ? __hfma2(acc[c], x, y) : __hmul2(acc[c], x);
  }
  __nv_bfloat162 s = acc[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) s = __hadd2(s, acc[c]);
  out[i] = __bfloat1622float2(s);
}

template <int NC, bool FMA>
cudaError_t launch(const void* a, void* out, int n, int k, int grid, int bf16,
                   cudaStream_t stream) {
  const int m = bf16 ? n / 2 : n;
  const dim3 blocks((m + kThreads - 1) / kThreads, grid);
  if (bf16)
    probe_bf16<NC, FMA><<<blocks, kThreads, 0, stream>>>(
        (const float2*)a, (float2*)out, m, k);
  else
    probe_f32<NC, FMA><<<blocks, kThreads, 0, stream>>>(
        (const float*)a, (float*)out, m, k);
  return cudaGetLastError();
}

}  // namespace

// a, out: n floats (n even for bf16). nchains 1, 2, 4 or 8; op 0 = FMA,
// 1 = multiply; grid = times the plane is processed.
extern "C" int bnlk_probe(const void* a, void* out, int n, int nchains,
                          int k, int grid, int op, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n < 1 || k < 0 || grid < 1 || (op != 0 && op != 1) || (bf16 && n % 2))
    return (int)cudaErrorInvalidValue;
  const bool fma = op == 0;
  switch (nchains * 2 + (fma ? 1 : 0)) {
    case 3: return (int)launch<1, true>(a, out, n, k, grid, bf16, stream);
    case 2: return (int)launch<1, false>(a, out, n, k, grid, bf16, stream);
    case 5: return (int)launch<2, true>(a, out, n, k, grid, bf16, stream);
    case 4: return (int)launch<2, false>(a, out, n, k, grid, bf16, stream);
    case 9: return (int)launch<4, true>(a, out, n, k, grid, bf16, stream);
    case 8: return (int)launch<4, false>(a, out, n, k, grid, bf16, stream);
    case 17: return (int)launch<8, true>(a, out, n, k, grid, bf16, stream);
    case 16: return (int)launch<8, false>(a, out, n, k, grid, bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
