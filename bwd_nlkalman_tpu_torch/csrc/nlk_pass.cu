// K1: one NL-Kalman filter or RTS smoother pass over a frame.
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/core/engine_pallas.py:128
// (_fused_pass_kernel, launched by dense_pass_pallas). It computes what
// that kernel computes, with the semantics of core/engine.py:101
// (dense_pass_v2), as four kernels that one wrapper launches:
//
//   1. dct_kernel: the orthonormal 8x8 DCT of every patch position of a
//      frame (the x-, d- and n-bands) and, for the d-band, the patch
//      validity (all 64 pixels valid, core/nlkalman.py:70-82);
//   2. site_kernel: one warp per site (stride-4 grid) does the
//      distances over the (2*rad+1)^2 window, the three k-th-smallest
//      thresholds by 31-step bisection on the float bits, the masked
//      group statistics and the Kalman / Wiener gain and bias, and writes
//      the site's gain/bias vectors, its weight and its member bitmask;
//   3. aggregate_kernel: one warp per patch position gathers the
//      weighted gain/bias of every site that chose it as a member (the
//      linearity trick), forms gain * Nd + bias (+ gain_d * Dd) and takes
//      the inverse DCT, times the Gaussian window;
//   4. fold_kernel: one thread per pixel sums the windowed patches that
//      cover it and their weights, and normalises; a pixel no patch
//      covers copies the input (engine_pallas.py:1551-1555).
//
// The gather form of step 3 uses no atomics, so a pass is deterministic.
//
// Summation orders (the float bits of the distances decide selection):
// a distance is the sum of the F squared differences in coefficient
// order f = 0..F-1, one thread per candidate, times 1/F. Group
// statistics sum over the selected members in window order (oy-major).
// The DCT sums rows first (i = 0..7) then columns (j = 0..7), as the JAX
// package's shifted-FMA form does; the inverse DCT is the 64-term sum
// in coefficient order; the fold adds dy-major, like finalize_fields.
//
// What bounds it on the card: at 1080p gray (128,851 sites, F = 64) the
// site kernel loads 441 candidate vectors of 64 floats per site, one
// thread per candidate, so a warp's loads touch 32 different cache lines
// (served mostly from L1/L2, as neighbouring candidates overlap), and
// runs 3 x 31 counting passes over 441 candidates; the aggregation runs
// a 64x64 inverse DCT per patch position (4096 FMAs, operands from
// shared memory). Measured on an H100 80GB HBM3 at 700 W with
// torch.profiler over the 1080p gray T=4 slice (PERF.md), as a mean over
// its 11 passes (8 filter passes at rad 10, 3 smoother passes at rad 5):
// site kernel 6.6 ms, aggregation 5.4 ms, fold 0.6 ms per pass, 0.44 ms
// per DCT band. A whole pass, timed alone: filter 12.3 ms, smoother 9.7 ms.
// Design for now: simple and right. Whole-frame bands in device memory
// instead of the TPU's VMEM-resident rolling bands; one warp per site so
// selection needs only warp shuffles. A separable inverse DCT, tiling the
// window in shared memory and tensor-core distances are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPsz = 8;
constexpr int kK = kPsz * kPsz;    // coefficients per channel
constexpr int kMaxOff = 1024;      // window offsets: rad <= 15
constexpr int kMaxF = 3 * kK;      // channels <= 3
constexpr int kSiteWarps = 4;      // sites per block
constexpr int kAggWarps = 8;       // patch positions in flight per block
constexpr int kInfBits = 0x7f800000;

// flag bits per window offset
constexpr uint8_t kCand = 1, kPrevc = 2, kSel1 = 4, kM0sel = 8, kMemsp = 16;

// ---------------------------------------------------------------- 1. DCT
constexpr int kDctQ = 128;  // patch positions (one row) per block

__global__ void dct_kernel(const float* __restrict__ img,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ dct8,
                           float* __restrict__ band, uint8_t* __restrict__ pval,
                           int h, int w, int c) {
  __shared__ float d[kPsz][kPsz];
  __shared__ float tile[kPsz][kDctQ + kPsz];
  __shared__ float stage[kDctQ * kK];
  const int ww = w - kPsz + 1;
  const int qy = blockIdx.y, qx0 = blockIdx.x * kDctQ, t = threadIdx.x;
  const int nq = min(kDctQ, ww - qx0);
  const int f_all = c * kK;
  if (t < kK) d[t / kPsz][t % kPsz] = dct8[t];
  for (int ci = 0; ci < c; ++ci) {
    __syncthreads();
    for (int k = t; k < kPsz * (kDctQ + kPsz); k += blockDim.x) {
      const int r = k / (kDctQ + kPsz), col = qx0 + k % (kDctQ + kPsz);
      tile[r][k % (kDctQ + kPsz)] =
          col < w ? img[((size_t)(qy + r) * w + col) * c + ci] : 0.0f;
    }
    __syncthreads();
    if (t < nq) {
      float a[kPsz][kPsz];  // a[k][j] = sum_i D[k][i] * tile[i][t + j]
#pragma unroll
      for (int k = 0; k < kPsz; ++k)
#pragma unroll
        for (int j = 0; j < kPsz; ++j) {
          float acc = d[k][0] * tile[0][t + j];
#pragma unroll
          for (int i = 1; i < kPsz; ++i) acc = acc + d[k][i] * tile[i][t + j];
          a[k][j] = acc;
        }
#pragma unroll
      for (int k = 0; k < kPsz; ++k)
#pragma unroll
        for (int l = 0; l < kPsz; ++l) {
          float acc = d[l][0] * a[k][0];
#pragma unroll
          for (int j = 1; j < kPsz; ++j) acc = acc + d[l][j] * a[k][j];
          stage[t * kK + k * kPsz + l] = acc;
        }
    }
    __syncthreads();
    float* out = band + ((size_t)qy * ww + qx0) * f_all + ci * kK;
    for (int k = t; k < nq * kK; k += blockDim.x)
      out[(size_t)(k / kK) * f_all + k % kK] = stage[k];
  }
  if (valid != nullptr && t < nq) {
    bool ok = true;
    for (int r = 0; r < kPsz; ++r)
      for (int j = 0; j < kPsz; ++j)
        ok = ok && valid[(size_t)(qy + r) * w + qx0 + t + j] != 0;
    pval[(size_t)qy * ww + qx0 + t] = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------- 2. per site
struct SiteArgs {
  const float* xband;   // (hh, ww, F) distances and stats source
  const float* dband;   // (hh, ww, F) previous frame, or null
  const uint8_t* pval;  // (hh, ww) previous patch validity, or null
  float* spec;          // (n_sites, n_acc, F): gain | bias | gain_d
  float* wgt;           // (n_sites,)
  uint32_t* mask;       // (n_sites, n_words) member bits over offsets
  int hh, ww, ny, nx, F, n_words;
  int smooth, has_prev;
  int rad, rad_t, np_t, np_x, nagg;
  float sigma2, bts, bxs, beta_t, sub;
};

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ float warp_sumf(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NF>  // NF = F / 32 coefficients per lane
__global__ void site_kernel(SiteArgs a) {
  __shared__ float s_xp[kSiteWarps][kMaxF];
  __shared__ int s_bits[kSiteWarps][kMaxOff];
  __shared__ uint8_t s_flag[kSiteWarps][kMaxOff];
  __shared__ short s_list[kSiteWarps][kMaxOff];
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kSiteWarps + wi;
  if (s >= a.ny * a.nx) return;  // whole warp; no block barriers below
  float* xp = s_xp[wi];
  int* bits = s_bits[wi];
  uint8_t* flag = s_flag[wi];
  short* list = s_list[wi];
  const int F = a.F, n1 = 2 * a.rad + 1, n_off = n1 * n1;
  const int py = 4 * (s / a.nx), px = 4 * (s % a.nx);
  const size_t pc = (size_t)py * a.ww + px;
  for (int f = lane; f < F; f += 32) xp[f] = a.xband[pc * F + f];
  const bool prev_p = a.has_prev && a.pval[pc] != 0;
  const float inv_f = 1.0f / (float)F;
  __syncwarp();

  // distances, candidate masks
  for (int o = lane; o < n_off; o += 32) {
    const int oy = o / n1 - a.rad, ox = o % n1 - a.rad;
    const int qy = py + oy, qx = px + ox;
    bool cand = qy >= 0 && qy < a.hh && qx >= 0 && qx < a.ww;
    if (!a.smooth && prev_p)
      cand = cand && abs(oy) <= a.rad_t && abs(ox) <= a.rad_t;
    int b = kInfBits;
    uint8_t fl = 0;
    if (cand) {
      const size_t q = (size_t)qy * a.ww + qx;
      const float* xq = a.xband + q * F;
      float acc = 0.0f;
      for (int f = 0; f < F; ++f) {
        const float dlt = xq[f] - xp[f];
        acc = acc + dlt * dlt;
      }
      b = __float_as_int(acc * inv_f);
      fl = kCand;
      if (prev_p && a.pval[q] != 0) fl |= kPrevc;
    }
    bits[o] = b;
    flag[o] = fl;
  }
  __syncwarp();

  // k-th smallest bits by bisection, three thresholds at once
  // (engine.py:_kth_smallest_bits): th1 over all candidates with
  // k = np_t if the site's previous patch is valid else np_x, thp over the
  // prev-valid candidates with k = nagg, tha over all with k = nagg
  const int k1 = prev_p ? a.np_t : a.np_x;
  int lo[3] = {0, 0, 0}, hi[3] = {kInfBits, kInfBits, kInfBits};
  for (int it = 0; it < 31; ++it) {
    int mid[3], cnt[3] = {0, 0, 0};
#pragma unroll
    for (int r = 0; r < 3; ++r) mid[r] = lo[r] + (hi[r] - lo[r]) / 2;
    for (int o = lane; o < n_off; o += 32) {
      const int b = bits[o];
      const int pb = (flag[o] & kPrevc) ? b : kInfBits;
      cnt[0] += b <= mid[0];
      cnt[1] += pb <= mid[1];
      cnt[2] += b <= mid[2];
    }
    const int kk[3] = {k1, a.nagg, a.nagg};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const bool ok = warp_sum(cnt[r]) >= kk[r];
      lo[r] = ok ? lo[r] : mid[r] + 1;
      hi[r] = ok ? mid[r] : hi[r];
    }
  }
  const int th1 = k1 <= 0 ? -1 : hi[0];
  const int thp = a.nagg <= 0 ? -1 : hi[1];
  const int tha = a.nagg <= 0 ? -1 : hi[2];

  // selection flags and the member list in window order
  int np1 = 0, np0 = 0;
  for (int o0 = 0; o0 < n_off; o0 += 32) {
    const int o = o0 + lane;
    bool sel = false;
    if (o < n_off) {
      uint8_t fl = flag[o];
      const int b = bits[o];
      sel = (fl & kCand) && b <= th1;
      if (sel) fl |= kSel1;
      if (sel && (fl & kPrevc) && b <= thp) fl |= kM0sel;
      if (sel && b <= tha) fl |= kMemsp;
      flag[o] = fl;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, sel);
    const unsigned balp =
        __ballot_sync(0xffffffffu, sel && (flag[o < n_off ? o : 0] & kPrevc));
    if (sel) list[np1 + __popc(bal & ((1u << lane) - 1u))] = (short)o;
    np1 += __popc(bal);
    np0 += __popc(balp);
  }
  __syncwarp();

  // group statistics, NF coefficients per lane (f = lane + 32 m)
  float sm1[NF], se2[NF], sm0v[NF], se0[NF], sv01[NF], sm0[NF];
#pragma unroll
  for (int m = 0; m < NF; ++m)
    sm1[m] = se2[m] = sm0v[m] = se0[m] = sv01[m] = sm0[m] = 0.0f;
  for (int k = 0; k < np1; ++k) {
    const int o = list[k];
    const uint8_t fl = flag[o];
    const size_t q = (size_t)(py + o / n1 - a.rad) * a.ww + (px + o % n1 - a.rad);
    const float* xq = a.xband + q * F;
    const float* dq = a.has_prev ? a.dband + q * F : nullptr;
#pragma unroll
    for (int m = 0; m < NF; ++m) {
      const int f = lane + 32 * m;
      const float xv = xq[f];
      const float dx = xv - xp[f];
      sm1[m] += dx;
      se2[m] += dx * dx;
      if (fl & kPrevc) {
        const float dv = dq[f];
        const float dd = dv - xp[f];
        sm0v[m] += dd;
        se0[m] += dd * dd;
        const float t = dv - xv;
        sv01[m] += t * t;
        if (fl & kM0sel) sm0[m] += dv;
      }
    }
  }
  const float np1s = fmaxf((float)np1, 1.0f), np0s = fmaxf((float)np0, 1.0f);
  const float naggf = (float)a.nagg;
  const bool temporal = np0 > 0;
  const int n_acc = a.smooth ? 3 : 2;
  float* spec = a.spec + (size_t)s * n_acc * F;
  float vp_part = 0.0f;
  float g0[NF], g1[NF], g2[NF];
#pragma unroll
  for (int m = 0; m < NF; ++m) {
    const int f = lane + 32 * m;
    const float m1c = sm1[m] / np1s;
    const float e2 = se2[m] / np1s;
    const float v1 = fmaxf(e2 - m1c * m1c, 0.0f);
    float v0 = 0.0f, v01 = 0.0f, m0 = 0.0f;
    if (a.has_prev) {
      const float m0vc = sm0v[m] / np0s;
      const float e0 = se0[m] / np0s;
      v0 = fmaxf(e0 - m0vc * m0vc, 0.0f);
      v01 = sv01[m] / np0s;
      m0 = sm0[m] / fminf(np0s, naggf);
    }
    if (!a.smooth) {
      const float v_t = v0 + fmaxf(0.0f, v01 - a.sub);
      const float a_t = v_t / (v_t + a.bts);
      const float v_x = fmaxf(0.0f, v1 - a.sub);
      const float a_x = v_x / (v_x + a.bxs);
      const float gain = temporal ? a_t : a_x;
      const float m_ref = temporal ? m0 : m1c + xp[f];
      vp_part += temporal ? (1.0f - a_t * a_t) * v_t + a_t * a_t * a.sigma2
                          : a_x * v_x;
      g0[m] = gain;
      g1[m] = (1.0f - gain) * m_ref;
      g2[m] = 0.0f;
    } else {
      const float denom = v1 + a.beta_t * v01;
      const float gain = denom > 0.0f ? v1 / fmaxf(denom, 1e-30f) : 0.0f;
      vp_part += (1.0f - gain * gain) * v1 +
                 gain * gain * fmaxf(v0 - a.beta_t * v01, 0.0f);
      // passthrough where np0 == 0 [src/nlkalman.c:1795-1804]
      g0[m] = temporal ? 1.0f - gain : 1.0f;
      g1[m] = 0.0f;
      g2[m] = temporal ? gain : 0.0f;
    }
  }
  float vp = warp_sumf(vp_part);
  if (!a.smooth) {
    vp *= fminf(temporal ? (float)np0 : (float)np1, naggf);
  } else {
    vp *= fminf((float)np0, naggf);
  }
  const float wg = (a.smooth && !temporal) ? 1e6f : 1.0f / fmaxf(vp, 1e-6f);
#pragma unroll
  for (int m = 0; m < NF; ++m) {
    const int f = lane + 32 * m;
    spec[f] = g0[m];
    spec[F + f] = g1[m];
    if (a.smooth) spec[2 * F + f] = g2[m];
  }
  if (lane == 0) a.wgt[s] = wg;
  // member bits: temporal -> first nagg prev-valid (m0sel); spatial ->
  // first nagg selected (memsp); smoother passthrough -> the centre only
  const int centre = a.rad * n1 + a.rad;
  for (int wd = 0; wd < a.n_words; ++wd) {
    const int o = wd * 32 + lane;
    bool mem = false;
    if (o < n_off) {
      const uint8_t fl = flag[o];
      if (a.smooth)
        mem = temporal ? (fl & kM0sel) != 0 : o == centre;
      else
        mem = temporal ? (fl & kM0sel) != 0 : (fl & kMemsp) != 0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, mem);
    if (lane == 0) a.mask[(size_t)s * a.n_words + wd] = bal;
  }
}

// ----------------------------------------------------- 3. aggregation
struct AggArgs {
  const float* spec;
  const float* wgt;
  const uint32_t* mask;
  const float* nband;  // Nd: noisy patches the gain applies to
  const float* dband;  // Dd for the smoother's gain_d, or null
  const float* bk;     // (64, 64) flat basis [K][p]
  const float* win;    // (64,) Gaussian window, p = dy*8+dx
  float* pixw;         // (hh, ww, F) windowed inverse-DCT patches
  float* wq;           // (hh, ww) aggregated weights
  int hh, ww, ny, nx, F, n_acc, rad, n_words, c;
};

__global__ void aggregate_kernel(AggArgs a) {
  __shared__ float s_bk[kK * kK];
  __shared__ float s_win[kK];
  __shared__ float s_fd[kAggWarps][kMaxF];
  for (int k = threadIdx.x; k < kK * kK; k += blockDim.x) s_bk[k] = a.bk[k];
  if (threadIdx.x < kK) s_win[threadIdx.x] = a.win[threadIdx.x];
  __syncthreads();
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_q = a.hh * a.ww, F = a.F, n1 = 2 * a.rad + 1;
  float* fd = s_fd[wi];
  for (int q = blockIdx.x * kAggWarps + wi; q < n_q;
       q += gridDim.x * kAggWarps) {
    const int qy = q / a.ww, qx = q % a.ww;
    float acc[3][kMaxF / 32];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int m = 0; m < kMaxF / 32; ++m) acc[r][m] = 0.0f;
    float wsum = 0.0f;
    const int i0 = max(0, (qy - a.rad + 3) / 4 - 1), i1 = min(a.ny - 1, (qy + a.rad) / 4);
    const int j0 = max(0, (qx - a.rad + 3) / 4 - 1), j1 = min(a.nx - 1, (qx + a.rad) / 4);
    for (int i = i0; i <= i1; ++i) {
      const int oy = qy - 4 * i;
      if (oy < -a.rad || oy > a.rad) continue;
      for (int j = j0; j <= j1; ++j) {
        const int ox = qx - 4 * j;
        if (ox < -a.rad || ox > a.rad) continue;
        const int s = i * a.nx + j;
        const int o = (oy + a.rad) * n1 + (ox + a.rad);
        if (!((a.mask[(size_t)s * a.n_words + (o >> 5)] >> (o & 31)) & 1u))
          continue;
        const float wg = a.wgt[s];
        const float* sp = a.spec + (size_t)s * a.n_acc * F;
#pragma unroll
        for (int m = 0; m < kMaxF / 32; ++m) {
          if (m * 32 >= F) continue;
          const int f = lane + 32 * m;
#pragma unroll
          for (int r = 0; r < 3; ++r)
            if (r < a.n_acc) acc[r][m] += wg * sp[r * F + f];
        }
        wsum += wg;
      }
    }
    const float* nq = a.nband + (size_t)q * F;
#pragma unroll
    for (int m = 0; m < kMaxF / 32; ++m) {
      if (m * 32 >= F) continue;
      const int f = lane + 32 * m;
      float v = acc[0][m] * nq[f] + acc[1][m];
      if (a.dband != nullptr) v = v + acc[2][m] * a.dband[(size_t)q * F + f];
      fd[f] = v;
    }
    __syncwarp();
    float* out = a.pixw + (size_t)q * F;
    for (int ci = 0; ci < a.c; ++ci)
      for (int p = lane; p < kK; p += 32) {
        float v = 0.0f;
        for (int k = 0; k < kK; ++k) v += fd[ci * kK + k] * s_bk[k * kK + p];
        out[ci * kK + p] = s_win[p] * v;
      }
    if (lane == 0) a.wq[q] = wsum;
    __syncwarp();
  }
}

// ------------------------------------------------------------- 4. fold
__global__ void fold_kernel(const float* __restrict__ pixw,
                            const float* __restrict__ wq,
                            const float* __restrict__ win,
                            const float* __restrict__ cur,
                            float* __restrict__ out, int h, int w, int c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int y = idx / w, x = idx % w;
  const int hh = h - kPsz + 1, ww = w - kPsz + 1, F = c * kK;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float agg = 0.0f;
  for (int dy = 0; dy < kPsz; ++dy) {
    const int qy = y - dy;
    if (qy < 0 || qy >= hh) continue;
    for (int dx = 0; dx < kPsz; ++dx) {
      const int qx = x - dx;
      if (qx < 0 || qx >= ww) continue;
      const size_t q = (size_t)qy * ww + qx;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        if (ci < c) acc[ci] += pixw[q * F + ci * kK + dy * kPsz + dx];
      agg += win[dy * kPsz + dx] * wq[q];
    }
  }
  const bool covered = agg > 1e-6f;
#pragma unroll
  for (int ci = 0; ci < 3; ++ci)
    if (ci < c)
      out[(size_t)idx * c + ci] =
          covered ? acc[ci] / fmaxf(agg, 1e-6f) : cur[(size_t)idx * c + ci];
}

}  // namespace

extern "C" int bnlk_nlk_dct(const void* img, const void* valid,
                            const void* dct8, void* band, void* pval, int h,
                            int w, int c, void* stream) {
  if (c < 1 || c > 3 || h < kPsz || w < kPsz) return (int)cudaErrorInvalidValue;
  const int hh = h - kPsz + 1, ww = w - kPsz + 1;
  const dim3 grid((ww + kDctQ - 1) / kDctQ, hh);
  dct_kernel<<<grid, kDctQ, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const uint8_t*)valid, (const float*)dct8,
      (float*)band, (uint8_t*)pval, h, w, c);
  return (int)cudaGetLastError();
}

extern "C" int bnlk_nlk_sites(const void* xband, const void* dband,
                              const void* pval, void* spec, void* wgt,
                              void* mask, int hh, int ww, int c, int smooth,
                              int has_prev, int rad, int rad_t, int np_t,
                              int np_x, int nagg, float sigma2, float bts,
                              float bxs, float beta_t, float sub,
                              void* stream) {
  const int n1 = 2 * rad + 1;
  if (c < 1 || c > 3 || n1 * n1 > kMaxOff) return (int)cudaErrorInvalidValue;
  SiteArgs a;
  a.xband = (const float*)xband;
  a.dband = (const float*)dband;
  a.pval = (const uint8_t*)pval;
  a.spec = (float*)spec;
  a.wgt = (float*)wgt;
  a.mask = (uint32_t*)mask;
  a.hh = hh;
  a.ww = ww;
  a.ny = (hh - 1) / 4 + 1;
  a.nx = (ww - 1) / 4 + 1;
  a.F = c * kK;
  a.n_words = (n1 * n1 + 31) / 32;
  a.smooth = smooth;
  a.has_prev = has_prev;
  a.rad = rad;
  a.rad_t = rad_t;
  a.np_t = np_t;
  a.np_x = np_x;
  a.nagg = nagg;
  a.sigma2 = sigma2;
  a.bts = bts;
  a.bxs = bxs;
  a.beta_t = beta_t;
  a.sub = sub;
  const int n_sites = a.ny * a.nx;
  const int blocks = (n_sites + kSiteWarps - 1) / kSiteWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (c == 1)
    site_kernel<2><<<blocks, 32 * kSiteWarps, 0, st>>>(a);
  else if (c == 2)
    site_kernel<4><<<blocks, 32 * kSiteWarps, 0, st>>>(a);
  else
    site_kernel<6><<<blocks, 32 * kSiteWarps, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int bnlk_nlk_aggregate(const void* spec, const void* wgt,
                                  const void* mask, const void* nband,
                                  const void* dband, const void* bk,
                                  const void* win, void* pixw, void* wq,
                                  int hh, int ww, int c, int smooth, int rad,
                                  void* stream) {
  const int n1 = 2 * rad + 1;
  if (c < 1 || c > 3 || n1 * n1 > kMaxOff) return (int)cudaErrorInvalidValue;
  AggArgs a;
  a.spec = (const float*)spec;
  a.wgt = (const float*)wgt;
  a.mask = (const uint32_t*)mask;
  a.nband = (const float*)nband;
  a.dband = (const float*)dband;
  a.bk = (const float*)bk;
  a.win = (const float*)win;
  a.pixw = (float*)pixw;
  a.wq = (float*)wq;
  a.hh = hh;
  a.ww = ww;
  a.ny = (hh - 1) / 4 + 1;
  a.nx = (ww - 1) / 4 + 1;
  a.F = c * kK;
  a.n_acc = smooth ? 3 : 2;
  a.rad = rad;
  a.n_words = (n1 * n1 + 31) / 32;
  a.c = c;
  const int n_q = hh * ww;
  int blocks = (n_q + kAggWarps * 8 - 1) / (kAggWarps * 8);
  aggregate_kernel<<<blocks, 32 * kAggWarps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int bnlk_nlk_fold(const void* pixw, const void* wq,
                             const void* win, const void* cur, void* out,
                             int h, int w, int c, void* stream) {
  if (c < 1 || c > 3) return (int)cudaErrorInvalidValue;
  const int n = h * w, threads = 256;
  fold_kernel<<<(n + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>((const float*)pixw, (const float*)wq,
                                        (const float*)win, (const float*)cur,
                                        (float*)out, h, w, c);
  return (int)cudaGetLastError();
}
