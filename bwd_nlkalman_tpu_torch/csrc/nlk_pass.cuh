// K1: one NL-Kalman filter or RTS smoother pass over a frame (the
// kernels; csrc/nlk_pass.cu holds the C entries, the float32 instances and
// the design notes, csrc/nlk_pass_bf16.cu the bfloat16 band instances).
//
// The templates take what must be known when a kernel is compiled:
//   PSZ  the patch size (2, 4, ..., 16) in the DCT, aggregation and fold
//        stages, whose loops over a patch unroll;
//   NCH  coefficients a lane holds at once in the site and aggregation
//        stages (2 for F <= 64, else 6); F = c * PSZ^2 is walked in chunks
//        of 32 * NCH, with a masked tail, so the channel count (1-7) stays
//        a runtime value;
//   CC   the channel count where an instance is compiled for one (1: gray,
//        the main path; 3: RGB), whose F is then known when it is compiled
//        (its loops and registers are those of a kernel written for it), 0
//        for the channel count a runtime value;
//   T    the element type of the x-, d- and n-bands in device memory
//        (float, or __nv_bfloat16 for the bf16 window path). Every value
//        read from a band is widened to float before any arithmetic.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bnlk_nlk {

constexpr int kMaxPsz = 16;        // even patch sizes 2..16
constexpr int kMaxC = 7;           // channels
constexpr int kMaxRad = 15;        // search radius: n_off <= 961
constexpr int kMaxSites = 8;       // sites (warps) per site block
constexpr int kAggWarps = 8;       // patch positions in flight per block
constexpr int kBins = 256;         // radix-select digit bins (8 bits)
constexpr int kInfBits = 0x7f800000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDctQ = 128;         // threads of a DCT block

// flag bits per candidate
constexpr uint8_t kPrevc = 1, kM0sel = 2, kMemsp = 4;

// coefficients per lane and chunk for F coefficients a patch
__host__ __device__ constexpr int chunk_nch(int f) { return f <= 64 ? 2 : 6; }

// ------------------------------------------------------------- bands
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// four consecutive band values f..f+3 of a staged position, as float
// (f a multiple of 4; bf16 pairs packed two to a 32-bit word, low half
// first)
__device__ __forceinline__ float4 strip4(const uint32_t* w, int f, float) {
  return make_float4(__uint_as_float(w[f]), __uint_as_float(w[f + 1]),
                     __uint_as_float(w[f + 2]), __uint_as_float(w[f + 3]));
}
__device__ __forceinline__ float4 strip4(const uint32_t* w, int f, __nv_bfloat16) {
  const uint32_t a = w[f / 2], b = w[f / 2 + 1];
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

// ------------------------------------------------- site kernel layout
// Dynamic shared memory of a site block: region A holds two stage
// buffers of two window rows of the x-band each (pw = F sizeof(T) / 4 + 1
// 32-bit words per position, an odd count, so that one lane per candidate
// meets no bank conflict, and a row stride of 16 banks mod 32, so that
// lanes 16-31 can read the second row at once) and, once the distances
// are done, each warp's three select histograms and then its member list;
// then each warp's own arrays (its vector as float, bits, flags).
// The wrapper computes the same sizes (core/engine_cuda.py, site_plan),
// picks the sites per block from them and passes the total.
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline int strip_width(int sites, int rad, int step) {
  return step * (sites - 1) + 2 * rad + 1;
}

__host__ __device__ inline int strip_row_words(int sites, int rad, int step, int pw) {
  const int n = strip_width(sites, rad, step) * pw;
  return n + (16 - n % 32 + 32) % 32;
}

__host__ __device__ inline size_t site_region_bytes(int sites, int rad, int step, int pw) {
  const size_t strip = 4 * (size_t)strip_row_words(sites, rad, step, pw) * 4;
  const size_t hist = (size_t)sites * 3 * kBins * 4;
  return align16(strip > hist ? strip : hist);
}

__host__ __device__ inline size_t site_warp_bytes(int rad, int f) {
  const size_t n_off = (size_t)(2 * rad + 1) * (2 * rad + 1);
  return align16(4 * (size_t)f) + align16(4 * n_off) + align16(n_off);
}

// dynamic shared bytes of an aggregation block: the DCT matrix and the
// window, then each warp's F filtered coefficients and psz^2 intermediates
__host__ __device__ inline size_t agg_smem_bytes(int psz, int f) {
  const size_t k = (size_t)psz * psz;
  return 4 * (2 * k + (size_t)kAggWarps * (f + k));
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

// kernel arguments of the site and aggregation stages
template <typename T>
struct SiteArgs {
  const T* xband;       // (hh, ww, F) distances and stats source
  const T* dband;       // (hh, ww, F) previous frame, or null
  const uint8_t* pval;  // (hh, ww) previous patch validity, or null
  float* spec;          // (n_sites, 2, F): gain | bias, or the smoother's
                        // gain_n | gain_d; the launched site rows only
  float* wgt;           // (n_sites,)
  uint32_t* mask;       // (n_sites, n_words) member bits over offsets
  int hh, ww, ny, nx, n_words, sites, runs, f;
  int smooth, has_prev;
  int rad, rad_t, np_t, np_x, nagg;
  float sigma2, bts, bxs, beta_t, sub;
  // the site rows launched, [row0, row1), and the candidate patch rows
  // [qlo, qhi): the whole grid and frame, or a shard's own rows and bounds
  int row0, row1, qlo, qhi;
};

template <typename T>
struct AggArgs {
  const float* spec;
  const float* wgt;
  const uint32_t* mask;
  const T* nband;       // Nd: noisy patches the gain applies to
  const T* dband;       // Dd for the smoother's gain_d, or null
  const float* dmat;    // (psz, psz) DCT matrix D[k][i]
  const float* win;     // (psz^2,) Gaussian window, p = dy*psz+dx
  float* pixw;          // (hh, ww, F) windowed inverse-DCT patches
  float* wq;            // (hh, ww) aggregated weights
  int hh, ww, ny, nx, smooth, rad, n_words, c;
  int r0, r1;           // the site rows the site stage wrote: [r0, r1)
};

namespace {

// ---------------------------------------------------------------- 1. DCT
// One block takes dct_q<PSZ>() patch positions of one patch row. Per
// channel it stages the PSZ source rows, takes the vertical pass once per
// column (rows[k][x] = sum_i D[k][i] src[i][x], i = 0..PSZ-1), then the
// horizontal pass of each (position, row k) (sum over j = 0..PSZ-1) into a
// staging buffer (stride K + 1, no bank conflicts), which the block writes
// out coalesced. FUSED: the sums are written acc + d * x, which the
// compiler contracts to fused multiply-adds, as K1 computed every band
// before it took more than psz 8 and 3 channels in float32: the launcher
// keeps that form there, so that those bands, and the selections made on
// them, stay the bits they were. Every other band (other patch sizes, 4-7
// channels, bfloat16) rounds each product and each sum on its own, as the
// plain version does, so that it equals the plain version's bit for bit,
// and so does its rounding to bfloat16.
template <bool FUSED>
__device__ __forceinline__ float dct_madd(float a, float b, float acc) {
  if constexpr (FUSED) return acc + a * b;
  else return __fadd_rn(acc, __fmul_rn(a, b));
}

template <bool FUSED>
__device__ __forceinline__ float dct_first(float a, float b) {
  if constexpr (FUSED) return a * b;
  else return __fmul_rn(a, b);
}

// patch positions a DCT block takes: its staging buffer within 48 KB
template <int PSZ>
__host__ __device__ constexpr int dct_q() { return PSZ <= 8 ? 128 : 32; }

template <int PSZ, bool FUSED, typename T>
__global__ void __launch_bounds__(kDctQ, 5) dct_kernel(const float* __restrict__ img,
                                                    const uint8_t* __restrict__ valid,
                                                    const float* __restrict__ dmat,
                                                    T* __restrict__ band,
                                                    uint8_t* __restrict__ pval, int h,
                                                    int w, int c) {
  constexpr int K = PSZ * PSZ, Q = dct_q<PSZ>(), TW = Q + PSZ;
  constexpr bool kRegD = PSZ <= 8;  // the basis in registers
  __shared__ float d[K];
  __shared__ float tile[PSZ][TW];
  __shared__ float rows[PSZ][TW];
  __shared__ float stage[Q * (K + 1)];
  const int ww = w - PSZ + 1;
  const int qy = blockIdx.y, qx0 = blockIdx.x * Q, t = threadIdx.x;
  const int nq = min(Q, ww - qx0), ncol = nq + PSZ - 1;
  const int f_all = c * K;
  for (int k = t; k < K; k += kDctQ) d[k] = dmat[k];
  __syncthreads();
  float dr[kRegD ? K : 1];
  if constexpr (kRegD) {
#pragma unroll
    for (int k = 0; k < K; ++k) dr[k] = d[k];
  }
  // beyond psz 8 the basis is read from shared memory at every term (a
  // broadcast): hoisted out of the loops, its psz^2 values would spill
  auto dk = [&](int k) {
    if constexpr (kRegD) return dr[k];
    else return static_cast<volatile float*>(d)[k];
  };
  for (int ci = 0; ci < c; ++ci) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PSZ; ++r)
      for (int x = t; x < ncol; x += kDctQ)
        tile[r][x] = img[((size_t)(qy + r) * w + qx0 + x) * c + ci];
    __syncthreads();
    for (int x = t; x < ncol; x += kDctQ) {
      float col[PSZ];
#pragma unroll
      for (int i = 0; i < PSZ; ++i) col[i] = tile[i][x];
#pragma unroll
      for (int kk = 0; kk < PSZ; ++kk) {
        float acc = dct_first<FUSED>(dk(kk * PSZ), col[0]);
#pragma unroll
        for (int i = 1; i < PSZ; ++i) acc = dct_madd<FUSED>(dk(kk * PSZ + i), col[i], acc);
        rows[kk][x] = acc;
      }
    }
    __syncthreads();
    // item = kk * Q + p: a warp takes consecutive positions of one row k
#pragma unroll 1
    for (int item = t; item < PSZ * Q; item += kDctQ) {
      const int kk = item / Q, p = item - kk * Q;
      if (p >= nq) continue;
      float r[PSZ];
#pragma unroll
      for (int j = 0; j < PSZ; ++j) r[j] = rows[kk][p + j];
#pragma unroll
      for (int l = 0; l < PSZ; ++l) {
        float a0 = dct_first<FUSED>(dk(l * PSZ), r[0]);
#pragma unroll
        for (int j = 1; j < PSZ; ++j) a0 = dct_madd<FUSED>(dk(l * PSZ + j), r[j], a0);
        stage[p * (K + 1) + kk * PSZ + l] = a0;
      }
    }
    __syncthreads();
    T* out = band + ((size_t)qy * ww + qx0) * f_all + ci * K;
    for (int k = t; k < nq * K; k += kDctQ) {
      const int p = k / K, kl = k - p * K;
      put(out + (size_t)p * f_all + kl, stage[p * (K + 1) + kl]);
    }
  }
  if (valid != nullptr) {
    // validity of the patch: all PSZ x PSZ pixels valid (a column's
    // minimum over the patch rows, then over PSZ columns)
    __shared__ uint8_t vcol[TW];
    __syncthreads();
    for (int x = t; x < ncol; x += kDctQ) {
      uint8_t ok = 1;
#pragma unroll
      for (int r = 0; r < PSZ; ++r) ok &= valid[(size_t)(qy + r) * w + qx0 + x] != 0;
      vcol[x] = ok;
    }
    __syncthreads();
    if (t < nq) {
      uint8_t ok = 1;
#pragma unroll
      for (int j = 0; j < PSZ; ++j) ok &= vcol[t + j];
      pval[(size_t)qy * ww + qx0 + t] = ok;
    }
  }
}

// ---------------------------------------------------------- 2. per site
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

// (one channel: at most 64 registers, so that 4 blocks of a small window
// fit an SM; more channels: a block fills most of an SM's shared memory,
// so registers do not bound how many run)
template <int PSZ, int NCH, int CC, typename T>
__global__ void __launch_bounds__(32 * kMaxSites, CC == 1 ? 4 : 1) site_kernel(SiteArgs<T> a) {
  constexpr int K = PSZ * PSZ;           // coefficients a channel
  constexpr int KW = K * sizeof(T) / 4;  // 32-bit words a channel
  // chunks of 32 NCH coefficients tile F = c K exactly: no tail to mask
  constexpr bool kWhole = (CC ? CC * K : K) % (32 * NCH) == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CC ? CC : a.f / K, F = C * K, FW = C * KW, PW = FW + 1;
  constexpr int step = PSZ / 2;
  const int S = a.sites, wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n1 = 2 * a.rad + 1, n_off = n1 * n1;
  const int row = a.row0 + blockIdx.x / a.runs, j0 = (blockIdx.x % a.runs) * S;
  const int j = j0 + wi;
  const bool active = j < a.nx;
  const int py = step * row, px = step * j;
  const int RS = strip_row_words(S, a.rad, step, PW);
  uint32_t* strip = reinterpret_cast<uint32_t*>(smem);
  unsigned char* wb = smem + site_region_bytes(S, a.rad, step, PW) +
                      (size_t)wi * site_warp_bytes(a.rad, F);
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
    for (int f = lane; f < F; f += 32) xp[f] = widen(a.xband[pc * F + f]);
    prev_p = a.has_prev && a.pval[pc] != 0;
    if (!a.smooth && prev_p) r_s = r_small;
  }
  const int r_b = __syncthreads_or(active && r_s != r_small) ? a.rad : r_small;
  const int oy_lo = max(-r_s, a.qlo - py), oy_hi = min(r_s, a.qhi - 1 - py);
  const int ox_lo = max(-r_s, -px), ox_hi = min(r_s, a.ww - 1 - px);
  const int nxc = ox_hi - ox_lo + 1, n_c = (oy_hi - oy_lo + 1) * nxc;

  // the block's window rows and columns; two x-band rows per stage
  const int by0 = max(-r_b, a.qlo - py), by1 = min(r_b, a.qhi - 1 - py);
  const int x0 = step * j0 - r_b;
  const int xa = max(x0, 0);
  const int xb = min(step * (min(j0 + S, a.nx) - 1) + r_b, a.ww - 1);
  const int n_load = (xb - xa + 1) * FW;
  const int n_st = (by1 - by0 + 2) / 2;
  const uint32_t* xwords = reinterpret_cast<const uint32_t*>(a.xband);
  auto load_stage = [&](int st) {
    uint32_t* buf = strip + (st & 1) * 2 * RS + (xa - x0) * PW;
    const int r0 = by0 + 2 * st;
    for (int rr = 0; rr < 2 && r0 + rr <= by1; ++rr) {
      const uint32_t* src = xwords + ((size_t)(py + r0 + rr) * a.ww + xa) * FW;
      if constexpr (CC != 0) {
        for (int k = threadIdx.x; k < n_load; k += blockDim.x) {
          const int x = k / (CC * KW);
          cp_async4(buf + rr * RS + x * PW + (k - x * FW), src + k);
        }
      } else {  // a position a warp, its lanes over the words
        for (int x = wi; x < n_load / FW; x += S)
          for (int k = lane; k < FW; k += 32)
            cp_async4(buf + rr * RS + x * PW + k, src + x * FW + k);
      }
    }
    cp_async_commit();
  };

  const float inv_f = 1.0f / (float)F;
  int n_pc = 0;  // this lane's prev-valid candidates
  // the distance of candidate (oy, ox_lo + c), its window row at `row`:
  // the squared differences summed in coefficient order f = 0..F-1
  auto distance = [&](const uint32_t* wrow, int oy, int c) {
    const int ox = ox_lo + c;
    const uint32_t* xq = wrow + (px + ox - x0) * PW;
    float acc = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      const uint32_t* xc = xq + ci * KW;
      const float* pc = xp + ci * K;
#pragma unroll 4
      for (int f = 0; f < K; f += 4) {
        const float4 p = *reinterpret_cast<const float4*>(pc + f);
        const float4 q = strip4(xc, f, T());
        float dlt = q.x - p.x;
        acc = acc + dlt * dlt;
        dlt = q.y - p.y;
        acc = acc + dlt * dlt;
        dlt = q.z - p.z;
        acc = acc + dlt * dlt;
        dlt = q.w - p.w;
        acc = acc + dlt * dlt;
      }
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
      const uint32_t* buf = strip + (st & 1) * 2 * RS;
      const int r0 = by0 + 2 * st;
      if (nxc <= 16) {  // both rows at once: lanes 16-31 take the second
        const int rr = lane >> 4, c = lane & 15, oy = r0 + rr;
        if (c < nxc && oy >= oy_lo && oy <= oy_hi) distance(buf + rr * RS, oy, c);
      } else {
        for (int rr = 0; rr < 2; ++rr) {
          const int oy = r0 + rr;
          for (int c = lane; c < nxc; c += 32)
            if (oy >= oy_lo && oy <= oy_hi) distance(buf + rr * RS, oy, c);
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

  const float np1s = fmaxf((float)np1, 1.0f), np0s = fmaxf((float)np0, 1.0f);
  const float naggf = (float)a.nagg;
  const bool temporal = np0 > 0;
  const int s = (row - a.row0) * a.nx + j;  // among the launched rows
  float* spec = a.spec + (size_t)s * 2 * F;
  float vp_part = 0.0f;
  // group statistics and gains, NCH coefficients per lane at a time
  // (f = f0 + lane + 32 m); each chunk walks the members again
  for (int f0 = 0; f0 < F; f0 += 32 * NCH) {
    float sm1[NCH], se2[NCH], sm0v[NCH], se0[NCH], sv01[NCH], sm0[NCH];
#pragma unroll
    for (int m = 0; m < NCH; ++m)
      sm1[m] = se2[m] = sm0v[m] = se0[m] = sv01[m] = sm0[m] = 0.0f;
    // (two members in flight: every member is in frame, so its d-band
    // vector is read whether or not it is prev-valid)
#pragma unroll 2
    for (int k = 0; k < np1; ++k) {
      const int i = list[k];
      const uint8_t fl = flag[i];
      const size_t q = (size_t)(py + oy_lo + i / nxc) * a.ww + (px + ox_lo + i % nxc);
      const T* xq = a.xband + q * F;
      const T* dq = a.has_prev ? a.dband + q * F : xq;
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const int f = f0 + lane + 32 * m;
        if (kWhole || f < F) {
          const float xv = widen(xq[f]);
          const float dv = widen(dq[f]);
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
    }
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      const int f = f0 + lane + 32 * m;
      if (!kWhole && f >= F) continue;
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
      float g0, g1;
      if (!a.smooth) {
        const float v_t = v0 + fmaxf(0.0f, v01 - a.sub);
        const float a_t = v_t / (v_t + a.bts);
        const float v_x = fmaxf(0.0f, v1 - a.sub);
        const float a_x = v_x / (v_x + a.bxs);
        const float gain = temporal ? a_t : a_x;
        const float m_ref = temporal ? m0 : m1c + xp[f];
        // the weight's terms are rounded as written (intrinsics, which no
        // compiler fuses): a sum of two products can be fused either way,
        // and two builds of this kernel did fuse it differently, moving the
        // weights by an ulp; this is the order K1 computed before it took
        // shards (the second product fused, the first rounded)
        if (temporal) {
          const float at2 = __fmul_rn(a_t, a_t);
          vp_part = __fadd_rn(vp_part, __fmaf_rn(at2, a.sigma2,
                                                 __fmul_rn(v_t, __fsub_rn(1.0f, at2))));
        } else {
          vp_part = __fadd_rn(vp_part, __fmul_rn(a_x, v_x));
        }
        g0 = gain;
        g1 = (1.0f - gain) * m_ref;
      } else {
        const float bv01 = __fmul_rn(a.beta_t, v01);
        const float denom = __fadd_rn(v1, bv01);
        const float gain = denom > 0.0f ? v1 / fmaxf(denom, 1e-30f) : 0.0f;
        const float g2 = __fmul_rn(gain, gain);  // rounded as written, as above
        vp_part = __fadd_rn(vp_part, __fmaf_rn(g2, fmaxf(__fsub_rn(v0, bv01), 0.0f),
                                               __fmul_rn(v1, __fsub_rn(1.0f, g2))));
        // passthrough where np0 == 0 [src/nlkalman.c:1795-1804]; the
        // smoother has no bias, so its second row is gain_d
        g0 = temporal ? 1.0f - gain : 1.0f;
        g1 = temporal ? gain : 0.0f;
      }
      spec[f] = g0;
      spec[F + f] = g1;
    }
  }
  float vp = warp_sumf(vp_part);
  if (!a.smooth) {
    vp *= fminf(temporal ? (float)np0 : (float)np1, naggf);
  } else {
    vp *= fminf((float)np0, naggf);
  }
  // the clamp keeps a NaN, as torch.clamp in the plain pass and
  // jnp.maximum in the JAX package's passes do (fmaxf would drop it):
  // where a gain is 0/0 (a beta of 0 and no group variance) the site's
  // weight is NaN, so is the aggregate under its members, and the fold
  // copies the input there, as the plain pass does
  const float wg = (a.smooth && !temporal) ? 1e6f
                                           : 1.0f / (isnan(vp) ? vp : fmaxf(vp, 1e-6f));
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
template <int PSZ, int NCH, int CC, typename T>
__global__ void aggregate_kernel(AggArgs<T> a) {
  constexpr int K = PSZ * PSZ, NP = (K + 31) / 32;  // outputs per lane
  constexpr bool kRegD = PSZ <= 8;  // basis columns in registers
  constexpr bool kWhole = (CC ? CC * K : K) % (32 * NCH) == 0;  // no tail
  extern __shared__ __align__(16) float asmem[];
  const int C = CC ? CC : a.c, F = C * K;
  constexpr int step = PSZ / 2;
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_q = a.hh * a.ww, n1 = 2 * a.rad + 1;
  float* sD = asmem;
  float* sW = asmem + K;
  float* fd = asmem + 2 * K + (size_t)wi * (F + K);
  float* tt = fd + F;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sD[k] = a.dmat[k];
    sW[k] = a.win[k];
  }
  __syncthreads();
  // this lane's outputs p = lane + 32 i: (row, col) = (p / PSZ, p % PSZ);
  // for PSZ <= 8 the basis columns they need stay in registers
  float dcol[kRegD ? NP : 1][kRegD ? PSZ : 1], drow[kRegD ? NP : 1][kRegD ? PSZ : 1];
  float wv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = min(lane + 32 * i, K - 1), r = p / PSZ, cx = p % PSZ;
    wv[i] = sW[p];
    if constexpr (kRegD) {
#pragma unroll
      for (int k = 0; k < PSZ; ++k) {
        dcol[i][k] = sD[k * PSZ + cx];
        drow[i][k] = sD[k * PSZ + r];
      }
    }
  }
  for (int q = blockIdx.x * kAggWarps + wi; q < n_q; q += gridDim.x * kAggWarps) {
    const int qy = q / a.ww, qx = q % a.ww;
    // the sites whose window holds q: step i in [qy - rad, qy + rad], same in x,
    // among the rows the site stage wrote
    const int i0 = max(a.r0, qy > a.rad ? (qy - a.rad + step - 1) / step : 0);
    const int i1 = min(a.r1 - 1, (qy + a.rad) / step);
    const int j0 = qx > a.rad ? (qx - a.rad + step - 1) / step : 0;
    const int j1 = min(a.nx - 1, (qx + a.rad) / step);
    const int nj = j1 - j0 + 1, n_cell = (i1 - i0 + 1) * nj;
    float wsum = 0.0f;
    // the filtered coefficients, 32 * NCH at a time: each chunk gathers
    // the choosing sites' weighted gain/bias again
    for (int f0 = 0; f0 < F; f0 += 32 * NCH) {
      float acc[2][NCH];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < NCH; ++m) acc[r][m] = 0.0f;
      float ws = 0.0f;
      for (int c0 = 0; c0 < n_cell; c0 += 32) {
        const int cell = c0 + lane;
        bool mem = false;
        float wl = 0.0f;
        int sl = 0;
        if (cell < n_cell) {
          const int i = i0 + cell / nj, jj = j0 + cell % nj;
          const int o = (qy - step * i + a.rad) * n1 + (qx - step * jj + a.rad);
          sl = (i - a.r0) * a.nx + jj;
          mem = (a.mask[(size_t)sl * a.n_words + (o >> 5)] >> (o & 31)) & 1u;
          if (mem) wl = a.wgt[sl];
        }
        // the choosing sites in site order
        for (unsigned bal = __ballot_sync(kFull, mem); bal != 0u; bal &= bal - 1u) {
          const int b = __ffs(bal) - 1;
          const float wg = __shfl_sync(kFull, wl, b);
          const float* sp = a.spec + (size_t)__shfl_sync(kFull, sl, b) * 2 * F;
#pragma unroll
          for (int m = 0; m < NCH; ++m) {
            const int f = f0 + lane + 32 * m;
            if (kWhole || f < F) {
              acc[0][m] += wg * sp[f];
              acc[1][m] += wg * sp[F + f];
            }
          }
          ws += wg;
        }
      }
      wsum = ws;
      if (ws == 0.0f) break;  // no site chose q: nothing to fold
      const T* nq = a.nband + (size_t)q * F;
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const int f = f0 + lane + 32 * m;
        if (!kWhole && f >= F) continue;
        float v;
        if (!a.smooth) {
          v = acc[0][m] * widen(nq[f]) + acc[1][m];
        } else {
          v = acc[0][m] * widen(nq[f]);
          if (a.dband != nullptr) v = v + acc[1][m] * widen(a.dband[(size_t)q * F + f]);
        }
        fd[f] = v;
      }
    }
    if (wsum == 0.0f) {
      if (lane == 0) a.wq[q] = 0.0f;
      continue;
    }
    __syncwarp();
    float* out = a.pixw + (size_t)q * F;
    for (int ci = 0; ci < C; ++ci) {
      // t[ky][dx] = sum_kx fd[ky, kx] D[kx][dx], then
      // pix[dy][dx] = sum_ky D[ky][dy] t[ky][dx]
      const float* fc = fd + ci * K;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = lane + 32 * i;
        if (K % 32 == 0 || p < K) {
          const int r = p / PSZ, cx = p % PSZ;
          float t = 0.0f;
#pragma unroll
          for (int k = 0; k < PSZ; ++k) {
            float dk;
            if constexpr (kRegD) dk = dcol[i][k];
            else dk = sD[k * PSZ + cx];
            t += fc[r * PSZ + k] * dk;
          }
          tt[p] = t;
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = lane + 32 * i;
        if (K % 32 == 0 || p < K) {
          const int r = p / PSZ, cx = p % PSZ;
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < PSZ; ++k) {
            float dk;
            if constexpr (kRegD) dk = drow[i][k];
            else dk = sD[k * PSZ + r];
            v += dk * tt[k * PSZ + cx];
          }
          out[ci * K + p] = wv[i] * v;
        }
      }
      __syncwarp();
    }
    if (lane == 0) a.wq[q] = wsum;
  }
}

// ------------------------------------------------------------- 4. fold
// CMAX: 3 or 7, the most channels the instance's accumulators hold.
// agg_out null: normalise, copying the input where no patch covers a
// pixel; else write the sums and their weights as they are (a shard's
// accumulators, engine_pallas.py:1548-1549), to be folded with its
// neighbours' before the normalisation
template <int PSZ, int CMAX>
__global__ void fold_kernel(const float* __restrict__ pixw,
                            const float* __restrict__ wq,
                            const float* __restrict__ win,
                            const float* __restrict__ cur,
                            float* __restrict__ out, float* __restrict__ agg_out,
                            int h, int w, int c) {
  constexpr int K = PSZ * PSZ;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int y = idx / w, x = idx % w;
  const int hh = h - PSZ + 1, ww = w - PSZ + 1, F = c * K;
  float acc[CMAX];
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci) acc[ci] = 0.0f;
  float agg = 0.0f;
  for (int dy = 0; dy < PSZ; ++dy) {
    const int qy = y - dy;
    if (qy < 0 || qy >= hh) continue;
    for (int dx = 0; dx < PSZ; ++dx) {
      const int qx = x - dx;
      if (qx < 0 || qx >= ww) continue;
      const size_t q = (size_t)qy * ww + qx;
      const float wgt = wq[q];
      if (wgt == 0.0f) continue;  // unchosen: adds exact zeros, pixw unwritten
#pragma unroll
      for (int ci = 0; ci < CMAX; ++ci)
        if (ci < c) acc[ci] += pixw[q * F + ci * K + dy * PSZ + dx];
      agg += win[dy * PSZ + dx] * wgt;
    }
  }
  if (agg_out != nullptr) {
#pragma unroll
    for (int ci = 0; ci < CMAX; ++ci)
      if (ci < c) out[(size_t)idx * c + ci] = acc[ci];
    agg_out[idx] = agg;
    return;
  }
  const bool covered = agg > 1e-6f;
#pragma unroll
  for (int ci = 0; ci < CMAX; ++ci)
    if (ci < c)
      out[(size_t)idx * c + ci] =
          covered ? acc[ci] / fmaxf(agg, 1e-6f) : cur[(size_t)idx * c + ci];
}

template <typename K, typename... Args>
cudaError_t launch_smem(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                        Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------ host launchers
// (defined here, instantiated in nlk_pass.cu for float bands and in
// nlk_pass_bf16.cu for bfloat16 bands; arguments already checked there)

template <typename T>
int launch_dct(const float* img, const uint8_t* valid, const float* dmat, T* band,
               uint8_t* pval, int h, int w, int c, int psz, cudaStream_t st) {
  const int hh = h - psz + 1, ww = w - psz + 1;
  if constexpr (std::is_same<T, float>::value) {
    if (psz == 8 && c <= 3) {
      dct_kernel<8, true, T><<<dim3((ww + dct_q<8>() - 1) / dct_q<8>(), hh), kDctQ, 0, st>>>(
          img, valid, dmat, band, pval, h, w, c);
      return (int)cudaGetLastError();
    }
  }
#define BNLK_DCT(P)                                                                      \
  case P:                                                                                \
    dct_kernel<P, false, T><<<dim3((ww + dct_q<P>() - 1) / dct_q<P>(), hh), kDctQ, 0, st>>>( \
        img, valid, dmat, band, pval, h, w, c);                                          \
    break;
  switch (psz) {
    BNLK_DCT(2) BNLK_DCT(4) BNLK_DCT(6) BNLK_DCT(8)
    BNLK_DCT(10) BNLK_DCT(12) BNLK_DCT(14) BNLK_DCT(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BNLK_DCT
  return (int)cudaGetLastError();
}

// The instance of a stage for F = c P^2 coefficients: one channel or
// three, compiled in; any other count at run time, in chunks of 64 where
// they fit one (P 2, and P 4 with up to four channels), else of 192.
template <int P, typename T>
cudaError_t sites_for(const SiteArgs<T>& a, dim3 grid, int threads, size_t smem,
                      cudaStream_t st) {
  constexpr int K = P * P;
  if (a.f == K)
    return launch_smem(site_kernel<P, chunk_nch(K), 1, T>, grid, threads, smem, st, a);
  if (a.f == 3 * K)
    return launch_smem(site_kernel<P, chunk_nch(3 * K), 3, T>, grid, threads, smem, st, a);
  if constexpr (2 * K <= 64) {
    if (a.f <= 64) return launch_smem(site_kernel<P, 2, 0, T>, grid, threads, smem, st, a);
  }
  return launch_smem(site_kernel<P, 6, 0, T>, grid, threads, smem, st, a);
}

template <int P, typename T>
cudaError_t aggregate_for(const AggArgs<T>& a, int f, dim3 grid, int threads, size_t smem,
                          cudaStream_t st) {
  constexpr int K = P * P;
  if (f == K)
    return launch_smem(aggregate_kernel<P, chunk_nch(K), 1, T>, grid, threads, smem, st, a);
  if (f == 3 * K)
    return launch_smem(aggregate_kernel<P, chunk_nch(3 * K), 3, T>, grid, threads, smem, st,
                       a);
  if constexpr (2 * K <= 64) {
    if (f <= 64) return launch_smem(aggregate_kernel<P, 2, 0, T>, grid, threads, smem, st, a);
  }
  return launch_smem(aggregate_kernel<P, 6, 0, T>, grid, threads, smem, st, a);
}

template <typename T>
int launch_sites(const SiteArgs<T>& a, int psz, int smem, cudaStream_t st) {
  if (a.row1 == a.row0) return (int)cudaSuccess;  // no site row: nothing to write
  const dim3 grid((a.row1 - a.row0) * a.runs);
  const int threads = 32 * a.sites;
  cudaError_t e;
#define BNLK_SITES(P) \
  case P: e = sites_for<P, T>(a, grid, threads, smem, st); break;
  switch (psz) {
    BNLK_SITES(2) BNLK_SITES(4) BNLK_SITES(6) BNLK_SITES(8)
    BNLK_SITES(10) BNLK_SITES(12) BNLK_SITES(14) BNLK_SITES(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BNLK_SITES
  return (int)e;
}

template <typename T>
int launch_aggregate(const AggArgs<T>& a, int psz, cudaStream_t st) {
  const int n_q = a.hh * a.ww, f = a.c * psz * psz;
  const dim3 grid((n_q + kAggWarps * 8 - 1) / (kAggWarps * 8));
  const size_t smem = agg_smem_bytes(psz, f);
  const int threads = 32 * kAggWarps;
  cudaError_t e;
#define BNLK_AGG(P) \
  case P: e = aggregate_for<P, T>(a, f, grid, threads, smem, st); break;
  switch (psz) {
    BNLK_AGG(2) BNLK_AGG(4) BNLK_AGG(6) BNLK_AGG(8)
    BNLK_AGG(10) BNLK_AGG(12) BNLK_AGG(14) BNLK_AGG(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BNLK_AGG
  return (int)e;
}

}  // namespace bnlk_nlk
