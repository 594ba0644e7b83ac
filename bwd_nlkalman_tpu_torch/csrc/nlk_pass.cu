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
//   2. site_kernel: a block takes a run of neighbouring sites of one site
//      row (stride-4 grid), one warp each. It streams the x-band rows
//      their windows cover through shared memory, two window rows per
//      stage, double-buffered with cp.async. Each warp computes the
//      distances of its compact candidate list (the inner (2 rad_t + 1)^2
//      square for a filter site whose previous patch is valid, else every
//      in-frame offset of the window), finds the three k-th-smallest
//      thresholds by an exact radix select (4 rounds of 8-bit digits), the
//      masked group statistics and the Kalman / Wiener gain and bias, and
//      writes the site's gain/bias vectors, its weight and its member
//      bitmask over the full window;
//   3. aggregate_kernel: one warp per patch position finds the sites that
//      chose it as a member (lanes over the covering sites, one ballot),
//      gathers their weighted gain/bias (the linearity trick), forms
//      gain * Nd + bias (smoother: gain_n * Nd + gain_d * Dd) and takes a
//      separable inverse DCT
//      (8-point along rows, then columns), times the Gaussian window. A
//      position no site chose is skipped: its weight is 0 and nothing else
//      is written;
//   4. fold_kernel: one thread per pixel sums the windowed patches that
//      cover it and their weights, skipping positions of weight 0, and
//      normalises; a pixel no patch covers copies the input
//      (engine_pallas.py:1551-1555).
//
// Only warp-local shared-memory atomics build the select's histograms, so
// a pass is deterministic.
//
// Summation orders (the float bits of the distances decide selection):
// a distance is the sum of the F squared differences in coefficient
// order f = 0..F-1, one thread per candidate, times 1/F. Group
// statistics sum over the selected members in window order (oy-major),
// the gather over the choosing sites in site order (row-major). The DCT
// sums rows first (i = 0..7) then columns (j = 0..7), as the JAX
// package's shifted-FMA form does; the inverse DCT sums along the
// horizontal frequency, then the vertical; the fold adds dy-major, like
// finalize_fields.
//
// What bounds it on the card: the bound of the work (chip_smoke.py,
// k1_work) is 0.237 ms of float32 operations for a 1080p gray filter
// pass; what the design pays beyond it is the site stage's shared-memory
// loads (one per candidate and coefficient, issued by 11 or 21 of a warp's
// lanes), its selection and its member reads from device memory, the
// gather's re-reads of the choosing sites' gain vectors, the whole-frame
// DCT bands and windowed patches (each (hh, ww, 64 c) float32) in device
// memory, and the fold's strided patch reads. What the design does about
// it: compact candidate lists (121 of 441 offsets for most filter sites),
// a 4-round radix select instead of 93 bisection passes, band rows staged
// once per block of 8 sites instead of one uncoalesced walk per candidate,
// two window rows per warp step where a list row has at most 16
// candidates, a separable inverse DCT (16 FMAs per output instead of 64)
// that skips the patch positions no site chose (25% of them for flt1, 94%
// for flt2, 2% for smo1).
// Measured on an H100 80GB HBM3 at 700 W (tools/k1_bench.py, parent and
// this design in turns in one run; PERF.md), device ms per 1080p gray
// pass, this design (the earlier one-warp-per-site design):
//   flt1 (with a previous frame): DCT 0.62 for 2 bands (0.92), site 1.66
//     (4.72), aggregation 0.95 (6.04), fold 0.49 (0.63); pass 3.74 (12.34)
//   smo1: DCT 0.62 (0.92), site 1.58 (4.53), aggregation 1.20 (3.68),
//     fold 0.61 (0.63); pass 4.03 (9.78)
//   flt1 on a first frame (441 candidates a site): site 2.91 (15.03);
//     pass 4.60 (22.12)
// Later work: the in-kernel patch DCT and fold of the TPU kernel, so that
// the bands and the windowed patches leave device memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPsz = 8;
constexpr int kK = kPsz * kPsz;    // coefficients per channel
constexpr int kMaxRad = 15;        // search radius: n_off <= 961
constexpr int kMaxSites = 8;       // sites (warps) per site block
constexpr int kAggWarps = 8;       // patch positions in flight per block
constexpr int kBins = 256;         // radix-select digit bins (8 bits)
constexpr int kInfBits = 0x7f800000;
constexpr unsigned kFull = 0xffffffffu;

// flag bits per candidate
constexpr uint8_t kPrevc = 1, kM0sel = 2, kMemsp = 4;

// ------------------------------------------------- site kernel layout
// Dynamic shared memory of a site block: region A holds two stage
// buffers of two window rows of the x-band each (stride F + 1 floats per
// position, so that one lane per candidate meets no bank conflict, and a
// row stride of 16 banks mod 32, so that lanes 16-31 can read the second
// row at once) and, once the distances are done, each warp's three select
// histograms and then its member list; then each warp's own arrays (xp,
// bits, flags).
// The wrapper computes the same sizes (core/engine_cuda.py, site_plan),
// picks the sites per block from them and passes the total.
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline int strip_width(int sites, int rad) {
  return 4 * (sites - 1) + 2 * rad + 1;
}

__host__ __device__ inline int strip_row_floats(int sites, int rad, int f) {
  const int n = strip_width(sites, rad) * (f + 1);
  return n + (16 - n % 32 + 32) % 32;
}

__host__ __device__ inline size_t site_region_bytes(int sites, int rad, int f) {
  const size_t strip = 4 * (size_t)strip_row_floats(sites, rad, f) * 4;
  const size_t hist = (size_t)sites * 3 * kBins * 4;
  return align16(strip > hist ? strip : hist);
}

__host__ __device__ inline size_t site_warp_bytes(int rad, int f) {
  const size_t n_off = (size_t)(2 * rad + 1) * (2 * rad + 1);
  return align16(4 * (size_t)f) + align16(4 * n_off) + align16(n_off);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---------------------------------------------------------------- 1. DCT
constexpr int kDctQ = 128;  // patch positions (one row) per block

__global__ void dct_kernel(const float* __restrict__ img,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ dct8,
                           float* __restrict__ band, uint8_t* __restrict__ pval,
                           int h, int w, int c) {
  __shared__ float d[kPsz][kPsz];
  __shared__ float tile[kPsz][kDctQ + kPsz];
  __shared__ float stage[kDctQ * (kK + 1)];  // stride 65: no bank conflicts
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
          stage[t * (kK + 1) + k * kPsz + l] = acc;
        }
    }
    __syncthreads();
    float* out = band + ((size_t)qy * ww + qx0) * f_all + ci * kK;
    for (int k = t; k < nq * kK; k += blockDim.x)
      out[(size_t)(k / kK) * f_all + k % kK] = stage[k / kK * (kK + 1) + k % kK];
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
  float* spec;          // (n_sites, 2, F): gain | bias, or the smoother's
                        // gain_n | gain_d
  float* wgt;           // (n_sites,)
  uint32_t* mask;       // (n_sites, n_words) member bits over offsets
  int hh, ww, ny, nx, n_words, sites, runs;
  int smooth, has_prev;
  int rad, rad_t, np_t, np_x, nagg;
  float sigma2, bts, bxs, beta_t, sub;
};

__device__ __forceinline__ float warp_sumf(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Exact k-th smallest of a warp's candidate bits, three selections in the
// same four rounds of 8-bit digits (most significant first): r = 0 over
// all candidates with k[0], r = 1 over the prev-valid ones (flag kPrevc)
// with k[1], r = 2 over all with k[2]. Returns what
// engine.py:_kth_smallest_bits returns: the smallest t with
// count(bits <= t) >= k, -1 where k <= 0 and INF bits where k exceeds the
// set. hist: 3 * kBins ints of this warp's shared memory.
__device__ void radix_select3(const int* bits, const uint8_t* flag, int n_c,
                              int n_pc, const int kk[3], int* hist, int lane,
                              int th[3]) {
  const int nset[3] = {n_c, n_pc, n_c};
  unsigned pre[3] = {0u, 0u, 0u};
  int krem[3];
  bool run[3];
  bool any = false;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    run[r] = kk[r] > 0 && kk[r] <= nset[r];
    krem[r] = kk[r];
    any = any || run[r];
  }
  for (int shift = 24; any && shift >= 0; shift -= 8) {
    for (int k = lane; k < 3 * kBins / 4; k += 32)
      reinterpret_cast<int4*>(hist)[k] = make_int4(0, 0, 0, 0);
    __syncwarp();
    const unsigned hi = shift == 24 ? 0u : kFull << (shift + 8);
    for (int i = lane; i < n_c; i += 32) {
      const unsigned b = (unsigned)bits[i];
      const bool pc = (flag[i] & kPrevc) != 0;
      const int dg = (int)((b >> shift) & (kBins - 1));
#pragma unroll
      for (int r = 0; r < 3; ++r)
        if (run[r] && (r != 1 || pc) && ((b ^ pre[r]) & hi) == 0u)
          atomicAdd(&hist[r * kBins + dg], 1);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (!run[r]) continue;  // warp-uniform
      const int4 c0 = *reinterpret_cast<const int4*>(hist + r * kBins + 8 * lane);
      const int4 c1 = *reinterpret_cast<const int4*>(hist + r * kBins + 8 * lane + 4);
      const int cnt[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      int s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += cnt[i];
      int inc = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += t;
      }
      const int exc = inc - s;
      const bool here = exc < krem[r] && krem[r] <= inc;
      const int src = __ffs(__ballot_sync(kFull, here)) - 1;
      // in the lane that holds it, the lowest bin where the count reaches k
      int dg = 0, below = exc;
      if (here) {
        int acc = exc;
        bool found = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (!found && acc + cnt[i] >= krem[r]) {
            dg = 8 * lane + i;
            below = acc;
            found = true;
          }
          acc += cnt[i];
        }
      }
      dg = __shfl_sync(kFull, dg, src);
      below = __shfl_sync(kFull, below, src);
      pre[r] |= (unsigned)dg << shift;
      krem[r] -= below;
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    th[r] = kk[r] <= 0 ? -1 : (run[r] ? (int)pre[r] : kInfBits);
}

template <int NF>  // NF = F / 32 coefficients per lane
__global__ void __launch_bounds__(32 * kMaxSites) site_kernel(SiteArgs a) {
  constexpr int F = 32 * NF, FP = F + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.sites, wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n1 = 2 * a.rad + 1, n_off = n1 * n1;
  const int row = blockIdx.x / a.runs, j0 = (blockIdx.x % a.runs) * S;
  const int j = j0 + wi;
  const bool active = j < a.nx;
  const int py = 4 * row, px = 4 * j;
  const int RS = strip_row_floats(S, a.rad, F);
  float* strip = reinterpret_cast<float*>(smem);
  unsigned char* wb =
      smem + site_region_bytes(S, a.rad, F) + (size_t)wi * site_warp_bytes(a.rad, F);
  float* xp = reinterpret_cast<float*>(wb);
  wb += align16(4 * (size_t)F);
  int* bits = reinterpret_cast<int*>(wb);
  wb += align16(4 * (size_t)n_off);
  uint8_t* flag = wb;
  // after the select, this warp's histograms hold its member list
  int* hist = reinterpret_cast<int*>(smem) + wi * 3 * kBins;
  short* list = reinterpret_cast<short*>(hist);

  // the site's own vector and previous-patch validity, its search radius
  // and the candidate rectangle (in-frame offsets within that radius)
  const int r_small = (!a.smooth && a.has_prev) ? min(a.rad_t, a.rad) : a.rad;
  bool prev_p = false;
  int r_s = a.rad;
  if (active) {
    const size_t pc = (size_t)py * a.ww + px;
    for (int f = lane; f < F; f += 32) xp[f] = a.xband[pc * F + f];
    prev_p = a.has_prev && a.pval[pc] != 0;
    if (!a.smooth && prev_p) r_s = r_small;
  }
  const int r_b = __syncthreads_or(active && r_s != r_small) ? a.rad : r_small;
  const int oy_lo = max(-r_s, -py), oy_hi = min(r_s, a.hh - 1 - py);
  const int ox_lo = max(-r_s, -px), ox_hi = min(r_s, a.ww - 1 - px);
  const int nxc = ox_hi - ox_lo + 1, n_c = (oy_hi - oy_lo + 1) * nxc;

  // the block's window rows and columns; two x-band rows per stage
  const int by0 = max(-r_b, -py), by1 = min(r_b, a.hh - 1 - py);
  const int x0 = 4 * j0 - r_b;
  const int xa = max(x0, 0);
  const int xb = min(4 * (min(j0 + S, a.nx) - 1) + r_b, a.ww - 1);
  const int n_load = (xb - xa + 1) * F;
  const int n_st = (by1 - by0 + 2) / 2;
  auto load_stage = [&](int st) {
    float* buf = strip + (st & 1) * 2 * RS + (xa - x0) * FP;
    const int r0 = by0 + 2 * st;
    for (int rr = 0; rr < 2 && r0 + rr <= by1; ++rr) {
      const float* src = a.xband + ((size_t)(py + r0 + rr) * a.ww + xa) * F;
      for (int k = threadIdx.x; k < n_load; k += blockDim.x) {
        const int x = k / F;
        cp_async4(buf + rr * RS + x * FP + (k - x * F), src + k);
      }
    }
    cp_async_commit();
  };

  const float inv_f = 1.0f / (float)F;
  int n_pc = 0;  // this lane's prev-valid candidates
  // the distance of candidate (oy, ox_lo + c), its window row at `row`
  auto distance = [&](const float* row, int oy, int c) {
    const int ox = ox_lo + c;
    const float* xq = row + (px + ox - x0) * FP;
    float acc = 0.0f;
#pragma unroll 4
    for (int f = 0; f < F; f += 4) {
      const float4 p = *reinterpret_cast<const float4*>(xp + f);
      float dlt = xq[f] - p.x;
      acc = acc + dlt * dlt;
      dlt = xq[f + 1] - p.y;
      acc = acc + dlt * dlt;
      dlt = xq[f + 2] - p.z;
      acc = acc + dlt * dlt;
      dlt = xq[f + 3] - p.w;
      acc = acc + dlt * dlt;
    }
    const int i = (oy - oy_lo) * nxc + c;
    bits[i] = __float_as_int(acc * inv_f);
    const bool pc = prev_p && a.pval[(size_t)(py + oy) * a.ww + px + ox] != 0;
    flag[i] = pc ? kPrevc : 0;
    n_pc += pc;
  };
  load_stage(0);
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st)
      load_stage(st + 1);
    else
      cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const float* buf = strip + (st & 1) * 2 * RS;
      const int r0 = by0 + 2 * st;
      if (nxc <= 16) {  // both rows at once: lanes 16-31 take the second
        const int rr = lane >> 4, c = lane & 15, oy = r0 + rr;
        if (c < nxc && oy >= oy_lo && oy <= oy_hi) distance(buf + rr * RS, oy, c);
      } else {
        for (int rr = 0; rr < 2; ++rr) {
          const int oy = r0 + rr;
          if (lane < nxc && oy >= oy_lo && oy <= oy_hi) distance(buf + rr * RS, oy, lane);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;  // whole warp; no block barriers below
  n_pc = __reduce_add_sync(kFull, n_pc);

  // k-th smallest bits (engine.py:_kth_smallest_bits): th1 over all
  // candidates with k = np_t if the site's previous patch is valid else
  // np_x, thp over the prev-valid candidates with k = nagg, tha over all
  // with k = nagg. The histograms reuse the strip buffers.
  const int k1 = prev_p ? a.np_t : a.np_x;
  const int kk[3] = {k1, a.nagg, a.nagg};
  int th[3];
  radix_select3(bits, flag, n_c, n_pc, kk, hist, lane, th);
  const int th1 = th[0], thp = th[1], tha = th[2];

  // selection flags and the member list in window order
  int np1 = 0, np0 = 0;
  for (int i0 = 0; i0 < n_c; i0 += 32) {
    const int i = i0 + lane;
    bool sel = false, selp = false;
    if (i < n_c) {
      uint8_t fl = flag[i];
      const int b = bits[i];
      sel = b <= th1;
      if (sel && (fl & kPrevc) && b <= thp) fl |= kM0sel;
      if (sel && b <= tha) fl |= kMemsp;
      flag[i] = fl;
      selp = sel && (fl & kPrevc);
    }
    const unsigned bal = __ballot_sync(kFull, sel);
    const unsigned balp = __ballot_sync(kFull, selp);
    if (sel) list[np1 + __popc(bal & ((1u << lane) - 1u))] = (short)i;
    np1 += __popc(bal);
    np0 += __popc(balp);
  }
  __syncwarp();

  // group statistics, NF coefficients per lane (f = lane + 32 m)
  float sm1[NF], se2[NF], sm0v[NF], se0[NF], sv01[NF], sm0[NF];
#pragma unroll
  for (int m = 0; m < NF; ++m)
    sm1[m] = se2[m] = sm0v[m] = se0[m] = sv01[m] = sm0[m] = 0.0f;
  // (two members in flight: every member is in frame, so its d-band
  // vector is read whether or not it is prev-valid)
#pragma unroll 2
  for (int k = 0; k < np1; ++k) {
    const int i = list[k];
    const uint8_t fl = flag[i];
    const size_t q = (size_t)(py + oy_lo + i / nxc) * a.ww + (px + ox_lo + i % nxc);
    const float* xq = a.xband + q * F;
    const float* dq = a.has_prev ? a.dband + q * F : xq;
#pragma unroll
    for (int m = 0; m < NF; ++m) {
      const int f = lane + 32 * m;
      const float xv = xq[f];
      const float dv = dq[f];
      const float dx = xv - xp[f];
      sm1[m] += dx;
      se2[m] += dx * dx;
      if (fl & kPrevc) {
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
  const int s = row * a.nx + j;
  float* spec = a.spec + (size_t)s * 2 * F;
  float vp_part = 0.0f;
  float g0[NF], g1[NF];
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
    } else {
      const float denom = v1 + a.beta_t * v01;
      const float gain = denom > 0.0f ? v1 / fmaxf(denom, 1e-30f) : 0.0f;
      vp_part += (1.0f - gain * gain) * v1 +
                 gain * gain * fmaxf(v0 - a.beta_t * v01, 0.0f);
      // passthrough where np0 == 0 [src/nlkalman.c:1795-1804]; the
      // smoother has no bias, so its second row is gain_d
      g0[m] = temporal ? 1.0f - gain : 1.0f;
      g1[m] = temporal ? gain : 0.0f;
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
  }
  if (lane == 0) a.wgt[s] = wg;
  // member bits over the full window: temporal -> first nagg prev-valid
  // (m0sel); spatial -> first nagg selected (memsp); smoother
  // passthrough -> the centre only. Lane wd keeps word wd.
  const int centre = a.rad * n1 + a.rad;
  uint32_t word = 0u;
  for (int wd = 0; wd < a.n_words; ++wd) {
    const int o = wd * 32 + lane;
    const int oy = o / n1 - a.rad, ox = o % n1 - a.rad;
    bool mem = false;
    if (o < n_off && oy >= oy_lo && oy <= oy_hi && ox >= ox_lo && ox <= ox_hi) {
      const uint8_t fl = flag[(oy - oy_lo) * nxc + ox - ox_lo];
      if (a.smooth)
        mem = temporal ? (fl & kM0sel) != 0 : o == centre;
      else
        mem = temporal ? (fl & kM0sel) != 0 : (fl & kMemsp) != 0;
    }
    const unsigned bal = __ballot_sync(kFull, mem);
    if (lane == wd) word = bal;
  }
  if (lane < a.n_words) a.mask[(size_t)s * a.n_words + lane] = word;
}

// ----------------------------------------------------- 3. aggregation
struct AggArgs {
  const float* spec;
  const float* wgt;
  const uint32_t* mask;
  const float* nband;  // Nd: noisy patches the gain applies to
  const float* dband;  // Dd for the smoother's gain_d, or null
  const float* dct8;   // (8, 8) DCT matrix D[k][i]
  const float* win;    // (64,) Gaussian window, p = dy*8+dx
  float* pixw;         // (hh, ww, F) windowed inverse-DCT patches
  float* wq;           // (hh, ww) aggregated weights
  int hh, ww, ny, nx, smooth, rad, n_words;
};

template <int NF>
__global__ void aggregate_kernel(AggArgs a) {
  constexpr int F = 32 * NF, C = F / kK;
  __shared__ float s_fd[kAggWarps][F];
  __shared__ float s_t[kAggWarps][kK];
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_q = a.hh * a.ww, n1 = 2 * a.rad + 1;
  float* fd = s_fd[wi];
  float* tt = s_t[wi];
  // this lane's outputs p = lane and lane + 32: (dy, dx) = (r0, cx) and
  // (r0 + 4, cx); the basis columns it needs stay in registers
  const int cx = lane & 7, r0 = lane >> 3;
  float dcol[kPsz], drow0[kPsz], drow1[kPsz];
#pragma unroll
  for (int k = 0; k < kPsz; ++k) {
    dcol[k] = a.dct8[k * kPsz + cx];
    drow0[k] = a.dct8[k * kPsz + r0];
    drow1[k] = a.dct8[k * kPsz + r0 + 4];
  }
  const float win0 = a.win[lane], win1 = a.win[lane + 32];
  for (int q = blockIdx.x * kAggWarps + wi; q < n_q;
       q += gridDim.x * kAggWarps) {
    const int qy = q / a.ww, qx = q % a.ww;
    float acc[2][NF];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int m = 0; m < NF; ++m) acc[r][m] = 0.0f;
    float wsum = 0.0f;
    // the sites whose window holds q: 4 i in [qy - rad, qy + rad], same in x
    const int i0 = qy > a.rad ? (qy - a.rad + 3) / 4 : 0;
    const int i1 = min(a.ny - 1, (qy + a.rad) / 4);
    const int j0 = qx > a.rad ? (qx - a.rad + 3) / 4 : 0;
    const int j1 = min(a.nx - 1, (qx + a.rad) / 4);
    const int nj = j1 - j0 + 1, n_cell = (i1 - i0 + 1) * nj;
    for (int c0 = 0; c0 < n_cell; c0 += 32) {
      const int cell = c0 + lane;
      bool mem = false;
      float wl = 0.0f;
      int sl = 0;
      if (cell < n_cell) {
        const int i = i0 + cell / nj, jj = j0 + cell % nj;
        const int o = (qy - 4 * i + a.rad) * n1 + (qx - 4 * jj + a.rad);
        sl = i * a.nx + jj;
        mem = (a.mask[(size_t)sl * a.n_words + (o >> 5)] >> (o & 31)) & 1u;
        if (mem) wl = a.wgt[sl];
      }
      // the choosing sites in site order
      for (unsigned bal = __ballot_sync(kFull, mem); bal != 0u; bal &= bal - 1u) {
        const int b = __ffs(bal) - 1;
        const float wg = __shfl_sync(kFull, wl, b);
        const float* sp = a.spec + (size_t)__shfl_sync(kFull, sl, b) * 2 * F;
#pragma unroll
        for (int m = 0; m < NF; ++m) {
          const int f = lane + 32 * m;
          acc[0][m] += wg * sp[f];
          acc[1][m] += wg * sp[F + f];
        }
        wsum += wg;
      }
    }
    if (wsum == 0.0f) {  // no site chose q: nothing to fold
      if (lane == 0) a.wq[q] = 0.0f;
      continue;
    }
    const float* nq = a.nband + (size_t)q * F;
#pragma unroll
    for (int m = 0; m < NF; ++m) {
      const int f = lane + 32 * m;
      float v;
      if (!a.smooth) {
        v = acc[0][m] * nq[f] + acc[1][m];
      } else {
        v = acc[0][m] * nq[f];
        if (a.dband != nullptr) v = v + acc[1][m] * a.dband[(size_t)q * F + f];
      }
      fd[f] = v;
    }
    __syncwarp();
    float* out = a.pixw + (size_t)q * F;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      // t[ky][dx] = sum_kx fd[ky, kx] D[kx][dx], then
      // pix[dy][dx] = sum_ky D[ky][dy] t[ky][dx]
      const float* fc = fd + ci * kK;
      float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
      for (int k = 0; k < kPsz; ++k) {
        t0 += fc[r0 * kPsz + k] * dcol[k];
        t1 += fc[(r0 + 4) * kPsz + k] * dcol[k];
      }
      tt[lane] = t0;
      tt[lane + 32] = t1;
      __syncwarp();
      float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
      for (int k = 0; k < kPsz; ++k) {
        const float tk = tt[k * kPsz + cx];
        v0 += drow0[k] * tk;
        v1 += drow1[k] * tk;
      }
      out[ci * kK + lane] = win0 * v0;
      out[ci * kK + lane + 32] = win1 * v1;
      __syncwarp();
    }
    if (lane == 0) a.wq[q] = wsum;
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
      const float wgt = wq[q];
      if (wgt == 0.0f) continue;  // unchosen: adds exact zeros, pixw unwritten
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        if (ci < c) acc[ci] += pixw[q * F + ci * kK + dy * kPsz + dx];
      agg += win[dy * kPsz + dx] * wgt;
    }
  }
  const bool covered = agg > 1e-6f;
#pragma unroll
  for (int ci = 0; ci < 3; ++ci)
    if (ci < c)
      out[(size_t)idx * c + ci] =
          covered ? acc[ci] / fmaxf(agg, 1e-6f) : cur[(size_t)idx * c + ci];
}

template <int NF>
cudaError_t launch_sites(const SiteArgs& a, int blocks, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        site_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  site_kernel<NF><<<blocks, 32 * a.sites, smem, st>>>(a);
  return cudaGetLastError();
}

template <int NF>
cudaError_t launch_aggregate(const AggArgs& a, cudaStream_t st) {
  const int n_q = a.hh * a.ww;
  const int blocks = (n_q + kAggWarps * 8 - 1) / (kAggWarps * 8);
  aggregate_kernel<NF><<<blocks, 32 * kAggWarps, 0, st>>>(a);
  return cudaGetLastError();
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

// sites: sites (warps) per block; smem: the dynamic shared bytes the
// wrapper's launch plan gives, checked against this file's layout
extern "C" int bnlk_nlk_sites(const void* xband, const void* dband,
                              const void* pval, void* spec, void* wgt,
                              void* mask, int hh, int ww, int c, int smooth,
                              int has_prev, int rad, int rad_t, int np_t,
                              int np_x, int nagg, float sigma2, float bts,
                              float bxs, float beta_t, float sub, int sites,
                              int smem, void* stream) {
  if (c < 1 || c > 3 || rad < 0 || rad > kMaxRad || sites < 1 ||
      sites > kMaxSites || hh < 1 || ww < 1)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      site_region_bytes(sites, rad, c * kK) + (size_t)sites * site_warp_bytes(rad, c * kK);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  const int n1 = 2 * rad + 1;
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
  a.n_words = (n1 * n1 + 31) / 32;
  a.sites = sites;
  a.runs = (a.nx + sites - 1) / sites;
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
  const int blocks = a.ny * a.runs;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (c == 1)
    e = launch_sites<2>(a, blocks, smem, st);
  else if (c == 2)
    e = launch_sites<4>(a, blocks, smem, st);
  else
    e = launch_sites<6>(a, blocks, smem, st);
  return (int)e;
}

extern "C" int bnlk_nlk_aggregate(const void* spec, const void* wgt,
                                  const void* mask, const void* nband,
                                  const void* dband, const void* dct8,
                                  const void* win, void* pixw, void* wq,
                                  int hh, int ww, int c, int smooth, int rad,
                                  void* stream) {
  if (c < 1 || c > 3 || rad < 0 || rad > kMaxRad) return (int)cudaErrorInvalidValue;
  const int n1 = 2 * rad + 1;
  AggArgs a;
  a.spec = (const float*)spec;
  a.wgt = (const float*)wgt;
  a.mask = (const uint32_t*)mask;
  a.nband = (const float*)nband;
  a.dband = (const float*)dband;
  a.dct8 = (const float*)dct8;
  a.win = (const float*)win;
  a.pixw = (float*)pixw;
  a.wq = (float*)wq;
  a.hh = hh;
  a.ww = ww;
  a.ny = (hh - 1) / 4 + 1;
  a.nx = (ww - 1) / 4 + 1;
  a.smooth = smooth;
  a.rad = rad;
  a.n_words = (n1 * n1 + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (c == 1)
    e = launch_aggregate<2>(a, st);
  else if (c == 2)
    e = launch_aggregate<4>(a, st);
  else
    e = launch_aggregate<6>(a, st);
  return (int)e;
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
