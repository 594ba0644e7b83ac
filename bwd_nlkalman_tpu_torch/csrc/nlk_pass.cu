// K1: one NL-Kalman filter or RTS smoother pass over a frame.
//
// Replaces the Pallas kernel bwd_nlkalman_tpu/core/engine_pallas.py:128
// (_fused_pass_kernel, launched by dense_pass_pallas). It computes what
// that kernel computes, over what that kernel takes: any even patch size
// psz from 2 to 16 (sites every psz/2 on each axis), 1 to 7 channels, a
// search radius up to 15, and the DCT bands held in float32 or, on the
// bf16 window path (window_dtype "bfloat16", engine_pallas.py:1465-1469),
// in bfloat16, with distances, statistics, gains and the fold in float32.
// Its semantics are those of core/engine.py:101 (dense_pass_v2) with the
// bands rounded as the TPU kernel rounds them. One wrapper launches four
// kernels (csrc/nlk_pass.cuh):
//
//   1. dct_kernel: the orthonormal psz x psz DCT of every patch position
//      of a frame (the x-, d- and n-bands, float32 or bf16) and, for the
//      d-band, the patch validity (all psz^2 pixels valid,
//      core/nlkalman.py:70-82), exact whatever the band type;
//   2. site_kernel: a block takes a run of neighbouring sites of one site
//      row, one warp each. It streams the x-band rows their windows cover
//      through shared memory in the band's own type, two window rows per
//      stage, double-buffered with cp.async. Each warp computes the
//      distances of its compact candidate list (the inner (2 rad_t + 1)^2
//      square for a filter site whose previous patch is valid, else every
//      in-frame offset of the window), finds the three k-th-smallest
//      thresholds by an exact radix select (4 rounds of 8-bit digits), the
//      masked group statistics and the Kalman / Wiener gain and bias (in
//      chunks of 64 or 192 coefficients), and writes the site's gain/bias
//      vectors, its weight and its member bitmask over the full window;
//   3. aggregate_kernel: one warp per patch position finds the sites that
//      chose it as a member (lanes over the covering sites, one ballot),
//      gathers their weighted gain/bias (the linearity trick), forms
//      gain * Nd + bias (smoother: gain_n * Nd + gain_d * Dd) and takes a
//      separable psz-point inverse DCT (along rows, then columns), times
//      the Gaussian window. A position no site chose is skipped: its
//      weight is 0 and nothing else is written;
//   4. fold_kernel: one thread per pixel sums the windowed patches that
//      cover it and their weights over the psz x psz footprint, skipping
//      positions of weight 0, and normalises; a pixel no patch covers
//      copies the input (engine_pallas.py:1551-1555).
//
// The sharded form (dense_pass_pallas's site_rows, qy_bounds and
// return_accum, engine_pallas.py:1330-1346): a shard passes its
// halo-extended block, the site rows it owns and the global patch-row
// bounds in its own coordinates. The site stage launches over the owned
// rows only and writes their vectors from row 0 of spec/wgt/mask; its
// candidate rows keep to the bounds (the window's and the staged strip's);
// the aggregation gathers from those rows only, so it reads nothing the
// site stage did not write; and the fold can write the sums and their
// weights unnormalised, for the shards to fold together before the
// normalisation. The bounds are launch arguments (the host knows the shard
// geometry): at their defaults (every row, 0..hh) the bands, selections
// and output are those of the kernel before it took shards, bit for bit
// (the weight's two-product sums are written with rounding intrinsics, in
// the order that kernel's build fused them: reading the bounds changed how
// the compiler fused them, which moved the weights by an ulp). A shard
// still takes the DCT and the fold over its whole extended block.
//
// Only warp-local shared-memory atomics build the select's histograms, so
// a pass is deterministic.
//
// Summation orders (the float bits of the distances decide selection):
// a distance is the sum of the F = c psz^2 squared differences in
// coefficient order f = 0..F-1, one thread per candidate, times 1/F.
// Group statistics sum over the selected members in window order
// (oy-major), the gather over the choosing sites in site order
// (row-major). The DCT sums rows first (i = 0..psz-1) then columns
// (j = 0..psz-1), as the JAX package's shifted form does. Where K1 ran
// before it took more (psz 8, 1-3 channels, float32 bands) the sums stay
// the fused multiply-adds the compiler made of them, bit for bit, and so
// do the selections; every other band rounds each product and each sum on
// its own, as the plain version, and equals it bit for bit (so does its
// 8-bit rounding on the bf16 path). Either way a distance summed in
// another order can flip a selection tie: with the plain version's
// rounding at psz 8, a 270x480 RGB filter pass at sigma=40 moved by up to
// 1.29, which the plain pass with K1's distance order reproduces exactly.
// The inverse DCT sums along the horizontal frequency, then the vertical;
// the fold adds dy-major, like finalize_fields.
//
// What bounds it on the card: the bound of the work (chip_smoke.py,
// k1_work) is 0.237 ms of float32 operations for a 1080p gray filter
// pass at psz 8; what the design pays beyond it is the site stage's
// shared-memory loads (one per candidate and coefficient), its selection
// and its member reads from device memory, the gather's re-reads of the
// choosing sites' gain vectors, the whole-frame DCT bands and windowed
// patches (each (hh, ww, c psz^2) values) in device memory, and the fold's
// strided patch reads. At other sizes: a smaller psz has more sites
// (step psz/2) and more candidates a site, so the site stage and the
// gather grow; a larger psz has fewer sites but F grows as psz^2, so the
// bands, the distances and the fold's psz^2 reads a pixel grow, and the
// strip of one site row no longer fits 8 sites a block (site_plan takes
// fewer; where one site does not fit, K1 does not take the pass). The
// bf16 bands halve the DCT stage's writes and every band read, and the
// staged strip, so more sites fit a block. What the design does about
// it: compact candidate lists (121 of 441 offsets for most filter sites at
// the default radii), a 4-round radix select, band rows staged once per
// block of sites, two window rows per warp step where a list row has at
// most 16 candidates, a separable inverse DCT (2 psz FMAs per output
// instead of psz^2) that skips the patch positions no site chose.
// Measured on an H100 80GB HBM3 at 700 W (tools/k1_bench.py; PERF.md),
// device ms per 1080p gray pass of the float32 psz-8 instances:
//   flt1 (with a previous frame): DCT 0.62 for 2 bands, site 1.66,
//     aggregation 0.95, fold 0.49; pass 3.74
//   smo1: DCT 0.62, site 1.58, aggregation 1.20, fold 0.61; pass 4.03
//   flt1 on a first frame (441 candidates a site): site 2.91; pass 4.60
// The other sizes and the bf16 path: PERF.md (chip_smoke.py phase 3).
// Later work: the in-kernel patch DCT and fold of the TPU kernel, so that
// the bands and the windowed patches leave device memory.
//
// Instances built: the DCT for 8 patch sizes x 2 band types, and the
// fused psz-8 float32 one; the site and the aggregation stages each for 26
// (patch size, chunk width, channels) triples (one channel and three at
// each patch size; other counts in chunks of 192, and of 64 at psz 2 and
// 4) x 2 band types; the fold for 8 patch sizes x 2 channel bounds (3,
// 7): 137. The bfloat16 ones are compiled from nlk_pass_bf16.cu, beside
// this file.
#include "nlk_pass.cuh"

namespace bnlk_nlk {

template int launch_dct<float>(const float*, const uint8_t*, const float*, float*,
                               uint8_t*, int, int, int, int, cudaStream_t);
template int launch_sites<float>(const SiteArgs<float>&, int, int, cudaStream_t);
template int launch_aggregate<float>(const AggArgs<float>&, int, cudaStream_t);

extern template int launch_dct<__nv_bfloat16>(const float*, const uint8_t*, const float*,
                                              __nv_bfloat16*, uint8_t*, int, int, int, int,
                                              cudaStream_t);
extern template int launch_sites<__nv_bfloat16>(const SiteArgs<__nv_bfloat16>&, int, int,
                                                cudaStream_t);
extern template int launch_aggregate<__nv_bfloat16>(const AggArgs<__nv_bfloat16>&, int,
                                                    cudaStream_t);

}  // namespace bnlk_nlk

namespace {

using bnlk_nlk::kMaxC;
using bnlk_nlk::kMaxPsz;
using bnlk_nlk::kMaxRad;
using bnlk_nlk::kMaxSites;

bool takes(int c, int psz) {
  return c >= 1 && c <= kMaxC && psz >= 2 && psz <= kMaxPsz && psz % 2 == 0;
}

template <typename T>
int sites_with(const void* xband, const void* dband, const void* pval, void* spec,
               void* wgt, void* mask, int hh, int ww, int f, int psz, int smooth,
               int has_prev, int rad, int rad_t, int np_t, int np_x, int nagg,
               float sigma2, float bts, float bxs, float beta_t, float sub, int sites,
               int smem, int row0, int row1, int qlo, int qhi, cudaStream_t st) {
  using namespace bnlk_nlk;
  const int pw = f * (int)sizeof(T) / 4 + 1, step = psz / 2;
  const size_t need = site_region_bytes(sites, rad, step, pw) +
                      (size_t)sites * site_warp_bytes(rad, f);
  if ((size_t)smem < need || smem > 232448) return (int)cudaErrorInvalidValue;
  const int n1 = 2 * rad + 1;
  SiteArgs<T> a;
  a.xband = (const T*)xband;
  a.dband = (const T*)dband;
  a.pval = (const uint8_t*)pval;
  a.spec = (float*)spec;
  a.wgt = (float*)wgt;
  a.mask = (uint32_t*)mask;
  a.hh = hh;
  a.ww = ww;
  a.ny = (hh - 1) / step + 1;
  a.nx = (ww - 1) / step + 1;
  a.row0 = row0;
  a.row1 = row1;
  a.qlo = qlo;
  a.qhi = qhi;
  a.n_words = (n1 * n1 + 31) / 32;
  a.sites = sites;
  a.runs = (a.nx + sites - 1) / sites;
  a.f = f;
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
  return launch_sites<T>(a, psz, smem, st);
}

template <typename T>
int aggregate_with(const void* spec, const void* wgt, const void* mask,
                   const void* nband, const void* dband, const void* dmat,
                   const void* win, void* pixw, void* wq, int hh, int ww, int c, int psz,
                   int smooth, int rad, int r0, int r1, cudaStream_t st) {
  using namespace bnlk_nlk;
  const int n1 = 2 * rad + 1, step = psz / 2;
  AggArgs<T> a;
  a.spec = (const float*)spec;
  a.wgt = (const float*)wgt;
  a.mask = (const uint32_t*)mask;
  a.nband = (const T*)nband;
  a.dband = (const T*)dband;
  a.dmat = (const float*)dmat;
  a.win = (const float*)win;
  a.pixw = (float*)pixw;
  a.wq = (float*)wq;
  a.hh = hh;
  a.ww = ww;
  a.ny = (hh - 1) / step + 1;
  a.nx = (ww - 1) / step + 1;
  a.r0 = r0;
  a.r1 = r1;
  a.smooth = smooth;
  a.rad = rad;
  a.n_words = (n1 * n1 + 31) / 32;
  a.c = c;
  return launch_aggregate<T>(a, psz, st);
}

}  // namespace

// bf16: the bands are bfloat16 (else float32)
extern "C" int bnlk_nlk_dct(const void* img, const void* valid, const void* dmat,
                            void* band, void* pval, int h, int w, int c, int psz,
                            int bf16, void* stream) {
  if (!takes(c, psz) || h < psz || w < psz) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return bnlk_nlk::launch_dct<__nv_bfloat16>(
        (const float*)img, (const uint8_t*)valid, (const float*)dmat,
        (__nv_bfloat16*)band, (uint8_t*)pval, h, w, c, psz, st);
  return bnlk_nlk::launch_dct<float>((const float*)img, (const uint8_t*)valid,
                                     (const float*)dmat, (float*)band, (uint8_t*)pval,
                                     h, w, c, psz, st);
}

// sites: sites (warps) per block; smem: the dynamic shared bytes the
// wrapper's launch plan gives, checked against the kernel's layout.
// [row0, row1): the site rows to launch, whose gain vectors, weights and
// masks fill spec, wgt and mask from row0 on (the whole grid 0..ny, or a
// shard's own rows, engine_pallas.py:336-337); [qlo, qhi): the patch rows
// a candidate may lie on (0..hh, or a shard's global bounds clipped to its
// block, :524), which must hold every launched site's own row
extern "C" int bnlk_nlk_sites(const void* xband, const void* dband,
                              const void* pval, void* spec, void* wgt,
                              void* mask, int hh, int ww, int c, int psz, int bf16,
                              int smooth, int has_prev, int rad, int rad_t, int np_t,
                              int np_x, int nagg, float sigma2, float bts,
                              float bxs, float beta_t, float sub, int sites,
                              int smem, int row0, int row1, int qlo, int qhi,
                              void* stream) {
  const int step = psz / 2;
  if (!takes(c, psz) || rad < 0 || rad > kMaxRad || sites < 1 || sites > kMaxSites ||
      hh < 1 || ww < 1 || row0 < 0 || row1 < row0 || row1 > (hh - 1) / step + 1 ||
      qlo < 0 || qhi > hh ||
      (row1 > row0 && (step * row0 < qlo || step * (row1 - 1) >= qhi)))
    return (int)cudaErrorInvalidValue;
  const int f = c * psz * psz;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return sites_with<__nv_bfloat16>(xband, dband, pval, spec, wgt, mask, hh, ww, f, psz,
                                     smooth, has_prev, rad, rad_t, np_t, np_x, nagg,
                                     sigma2, bts, bxs, beta_t, sub, sites, smem, row0,
                                     row1, qlo, qhi, st);
  return sites_with<float>(xband, dband, pval, spec, wgt, mask, hh, ww, f, psz, smooth,
                           has_prev, rad, rad_t, np_t, np_x, nagg, sigma2, bts, bxs,
                           beta_t, sub, sites, smem, row0, row1, qlo, qhi, st);
}

// [r0, r1): the site rows bnlk_nlk_sites launched (its row0, row1); the
// gather reads those sites only
extern "C" int bnlk_nlk_aggregate(const void* spec, const void* wgt,
                                  const void* mask, const void* nband,
                                  const void* dband, const void* dmat,
                                  const void* win, void* pixw, void* wq,
                                  int hh, int ww, int c, int psz, int bf16, int smooth,
                                  int rad, int r0, int r1, void* stream) {
  if (!takes(c, psz) || rad < 0 || rad > kMaxRad || r0 < 0 || r1 < r0 ||
      r1 > (hh - 1) / (psz / 2) + 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return aggregate_with<__nv_bfloat16>(spec, wgt, mask, nband, dband, dmat, win, pixw,
                                         wq, hh, ww, c, psz, smooth, rad, r0, r1, st);
  return aggregate_with<float>(spec, wgt, mask, nband, dband, dmat, win, pixw, wq, hh, ww,
                               c, psz, smooth, rad, r0, r1, st);
}

// agg_out null: the normalised frame into out; else the unnormalised sums
// into out and their weights into agg_out, (h, w) float32
extern "C" int bnlk_nlk_fold(const void* pixw, const void* wq,
                             const void* win, const void* cur, void* out,
                             void* agg_out, int h, int w, int c, int psz, void* stream) {
  if (!takes(c, psz)) return (int)cudaErrorInvalidValue;
  const int n = h * w, threads = 256;
  const dim3 grid((n + threads - 1) / threads);
  const cudaStream_t st = (cudaStream_t)stream;
  const float *pw = (const float*)pixw, *q = (const float*)wq, *wn = (const float*)win,
              *cu = (const float*)cur;
  float* o = (float*)out;
  float* ag = (float*)agg_out;
#define BNLK_FOLD(P)                                                               \
  case P:                                                                          \
    if (c <= 3)                                                                    \
      bnlk_nlk::fold_kernel<P, 3><<<grid, threads, 0, st>>>(pw, q, wn, cu, o, ag, h, w, \
                                                             c);                        \
    else                                                                           \
      bnlk_nlk::fold_kernel<P, 7><<<grid, threads, 0, st>>>(pw, q, wn, cu, o, ag, h, w, \
                                                             c);                        \
    break;
  switch (psz) {
    BNLK_FOLD(2) BNLK_FOLD(4) BNLK_FOLD(6) BNLK_FOLD(8)
    BNLK_FOLD(10) BNLK_FOLD(12) BNLK_FOLD(14) BNLK_FOLD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BNLK_FOLD
  return (int)cudaGetLastError();
}
