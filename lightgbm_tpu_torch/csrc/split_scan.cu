// K1: numerical best-threshold scan with the cross-feature select, one
// launch.
//
// Replaces: lightgbm_tpu/ops/split_pallas.py _split_scan_kernel (launched by
// _run_scan, pl.pallas_call at :242), which scans CH stacked children's
// [F, B, 3] histograms in one launch and selects each child's best feature.
//
// What bounds it on an H100: neither bytes nor operations.  One launch reads
// CH*F*B*3 floats (170 KB for two children of the Higgs shape) and does
// ~100 flops a bin, a few microseconds of work at the card's rates; the time
// is the launch, the block's barriers and the latency of its dependent
// steps.
//
// Design: one block per (child, feature) row, one thread per bin, blocks of
// 32*ceil(B/32) threads (B <= 1024).
// - Prefix sums: the Pallas kernel's Hillis-Steele doubling, x[t] +=
//   x[t - sh] for sh = 1, 2, 4, ... < B, in the same association order, so
//   the sums are the very same f32 values as the reference's and
//   split_scan_plain's.  The steps with sh < 32 run in registers by warp
//   shuffles, g, h and count together: besides its own bin t a lane
//   carries bin t - 32 (the previous warp's), whose partial sums supply
//   x[t - sh] when t - sh lies in the previous warp; that copy is right
//   wherever a later step reads it (tests/test_torch_split.py models the
//   order).  The steps with sh >= 32 go through double-buffered shared
//   memory, one barrier each: 3 for B = 256 where the first version took 48.
// - The two argmaxes (ascending: max gain, lowest threshold on ties;
//   descending: max gain, highest threshold) reduce by warp shuffles, then
//   over the warps' partials after one barrier.  The orders are total, so
//   the result does not depend on the reduction's shape; descending beats
//   ascending at equal gain.
// - The select is fused: each block stores its row, and one thread fences
//   and takes a ticket of its child; the child's last block selects the
//   best feature (lowest feature id on ties) and writes the ready-to-store
//   packed split row, then resets the ticket, so back-to-back launches on
//   one stream need no reset in between.  Launches that may overlap (on
//   two streams) take tickets of their own (split_kernel._tickets keeps
//   them per stream).
// The library is built with --fmad=false so the gain formulas round as the
// reference's do.
#include "common.cuh"

namespace {

constexpr float NEG = -1e38f;
constexpr float NEG_GATE = -1e37f;
constexpr float K_EPSILON = 1e-15f;
constexpr int MAX_BINS = 1024;      // one thread a bin, 32 warps at most
constexpr unsigned FULL = 0xffffffffu;

// fvec / svec / pvec column layouts (ops/split_kernel.py)
enum { NB = 0, DB = 1, MT = 2, MONO = 3, PEN = 4, FMASK = 5, CEGBF = 6 };
enum { SG = 0, SH = 1, ND = 2, MINC = 3, MAXC = 4 };
enum { L1 = 0, L2 = 1, MDS = 2, MINCNT = 3, MINH = 4, MINGAIN = 5, CEGBS = 6 };

struct Params {
  float l1, l2, mds;
};

__device__ __forceinline__ float thr_l1(float s, const Params& p) {
  return jsign(s) * jmax(0.f, fabsf(s) - p.l1);
}

__device__ __forceinline__ float leaf_out(float g, float h, const Params& p) {
  float ret = -thr_l1(g, p) / (h + p.l2);
  float clipped = jsign(ret) * p.mds;
  bool use_clip = (p.mds > 0.f) && (fabsf(ret) > p.mds);
  return use_clip ? clipped : ret;
}

__device__ __forceinline__ float gain_given(float g, float h, float out,
                                            const Params& p) {
  float a = (2.f * thr_l1(g, p)) * out;
  float b = ((h + p.l2) * out) * out;
  return -(a + b);
}

struct Dir {
  float gain, lo, ro;
  bool valid;
  float lg, lh, lc, rg, rh, rc;
};

__device__ __forceinline__ Dir eval_dir(float lg, float lh, float lc,
                                        float sum_g, float sum_h, float num_data,
                                        float minc, float maxc, float mono,
                                        float min_cnt, float min_hess,
                                        const Params& p) {
  Dir d;
  d.lg = lg; d.lh = lh; d.lc = lc;
  d.rg = sum_g - lg;
  d.rh = sum_h - lh;
  d.rc = num_data - lc;
  d.lo = jmin(jmax(leaf_out(d.lg, d.lh, p), minc), maxc);
  d.ro = jmin(jmax(leaf_out(d.rg, d.rh, p), minc), maxc);
  float gain = gain_given(d.lg, d.lh, d.lo, p) + gain_given(d.rg, d.rh, d.ro, p);
  bool violates = (mono > 0.f && d.lo > d.ro) || (mono < 0.f && d.lo < d.ro);
  d.gain = violates ? 0.f : gain;
  d.valid = (d.lc >= min_cnt) && (d.rc >= min_cnt) &&
            (d.lh >= min_hess) && (d.rh >= min_hess);
  return d;
}

// The warps' partial argmaxes of one block, reduced by every thread.
struct Best {
  float asc_v, desc_v;
  int asc_i, desc_i;
};

__device__ __forceinline__ void better_asc(float v2, int i2, float& v, int& i) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}
__device__ __forceinline__ void better_desc(float v2, int i2, float& v,
                                            int& i) {
  if (v2 > v || (v2 == v && i2 > i)) { v = v2; i = i2; }
}

// The prefix-sum inputs of bin b: the histogram's g, h, count where the
// bin is live (in range and not the missing bin the scan excludes), else 0.
__device__ __forceinline__ void live_bin(const float* __restrict__ hrow,
                                         int b, int B, float nb, float db,
                                         float mt, float& g, float& h,
                                         float& c) {
  const float bf = (float)b;
  const bool in_range = bf < nb;
  const bool excl = ((mt == 1.f && bf == db) || (mt == 2.f && bf == nb - 1.f)) &&
                    in_range && (nb > 2.f);
  const bool live = b >= 0 && b < B && in_range && !excl;
  const float* hb = hrow + (size_t)(live ? b : 0) * 3;
  g = live ? hb[0] : 0.f;
  h = live ? hb[1] : 0.f;
  c = live ? hb[2] : 0.f;
}

__global__ void __launch_bounds__(MAX_BINS)
split_scan_kernel(const float* __restrict__ hist,   // [R, B, 3]
                  const float* __restrict__ fvec,   // [R, 8]
                  const float* __restrict__ svec,   // [CH, 8]
                  const float* __restrict__ pvec,   // [8]
                  float* __restrict__ out,          // [R, ROW_W]
                  float* __restrict__ best,         // [CH, ROW_W]
                  int* __restrict__ ticket,         // [CH], zero between launches
                  int F, int B) {
  __shared__ float pbuf[2][3][MAX_BINS];
  __shared__ float tot[3];
  __shared__ Best part[MAX_BINS / 32];
  __shared__ int last;
  const int row = blockIdx.x;
  const int ch = row / F;
  const int b = threadIdx.x;
  const int lane = b & 31;
  const int nwarps = blockDim.x >> 5;

  Params p{pvec[L1], pvec[L2], pvec[MDS]};
  const float min_cnt = jmax(pvec[MINCNT], 1.f);
  const float min_hess = pvec[MINH];
  const float min_gain = pvec[MINGAIN];
  const float cegb_split = pvec[CEGBS];

  const float* fv = fvec + row * 8;
  const float nb = fv[NB], db = fv[DB], mt = fv[MT], mono = fv[MONO];
  const float pen = fv[PEN], fmask = fv[FMASK], cegb_f = fv[CEGBF];

  const float* sv = svec + ch * 8;
  const float sum_g = sv[SG];
  const float sum_h = sv[SH] + 2.f * K_EPSILON;
  const float num_data = sv[ND];
  const float minc = sv[MINC], maxc = sv[MAXC];

  const float bf = (float)b;
  const float* hrow = hist + (size_t)row * B * 3;
  // this lane's bin (hi) and the bin 32 below it (lo: 0 in the first warp)
  float cg, chh, cc, lg, lh, lc;
  live_bin(hrow, b, B, nb, db, mt, cg, chh, cc);
  live_bin(hrow, b - 32, B, nb, db, mt, lg, lh, lc);

  int sh = 1;
  for (; sh < 32 && sh < B; sh *= 2) {
    const int src = (lane - sh) & 31;
    const bool own = lane >= sh;
    const float ug = __shfl_up_sync(FULL, cg, sh);
    const float uh = __shfl_up_sync(FULL, chh, sh);
    const float uc = __shfl_up_sync(FULL, cc, sh);
    const float pg = __shfl_sync(FULL, lg, src);
    const float ph = __shfl_sync(FULL, lh, src);
    const float pc = __shfl_sync(FULL, lc, src);
    const float vg = __shfl_up_sync(FULL, lg, sh);
    const float vh = __shfl_up_sync(FULL, lh, sh);
    const float vc = __shfl_up_sync(FULL, lc, sh);
    cg = cg + (own ? ug : pg);
    chh = chh + (own ? uh : ph);
    cc = cc + (own ? uc : pc);
    lg = lg + (own ? vg : 0.f);
    lh = lh + (own ? vh : 0.f);
    lc = lc + (own ? vc : 0.f);
  }
  for (int buf = 0; sh < B; sh *= 2, buf ^= 1) {
    pbuf[buf][0][b] = cg;
    pbuf[buf][1][b] = chh;
    pbuf[buf][2][b] = cc;
    __syncthreads();
    const bool own = b >= sh;
    cg = cg + (own ? pbuf[buf][0][b - sh] : 0.f);
    chh = chh + (own ? pbuf[buf][1][b - sh] : 0.f);
    cc = cc + (own ? pbuf[buf][2][b - sh] : 0.f);
  }
  if (b == B - 1) {
    tot[0] = cg;
    tot[1] = chh;
    tot[2] = cc;
  }
  __syncthreads();
  const float tg = tot[0], th = tot[1], tc = tot[2];

  const float parent_out = leaf_out(sum_g, sum_h, p);
  const float min_gain_shift = gain_given(sum_g, sum_h, parent_out, p) + min_gain;

  Dir asc = eval_dir(cg, chh + K_EPSILON, cc, sum_g, sum_h, num_data,
                     minc, maxc, mono, min_cnt, min_hess, p);
  const float d_rg = tg - cg;
  const float d_rh = th - chh + K_EPSILON;
  const float d_rc = tc - cc;
  Dir desc = eval_dir(sum_g - d_rg, sum_h - d_rh, num_data - d_rc, sum_g, sum_h,
                      num_data, minc, maxc, mono, min_cnt, min_hess, p);

  const bool thr_ok = bf <= nb - 2.f;
  const bool asc_ok = thr_ok && (mt != 0.f) && (nb > 2.f);
  const bool lane_ok = b < B;
  const float asc_m = (asc_ok && asc.valid && asc.gain > min_gain_shift) ? asc.gain : NEG;
  const float desc_m = (thr_ok && desc.valid && desc.gain > min_gain_shift) ? desc.gain : NEG;

  Best m{lane_ok ? asc_m : -INFINITY, lane_ok ? desc_m : -INFINITY,
         lane_ok ? b : 1 << 30, lane_ok ? b : -1};
  for (int o = 16; o > 0; o >>= 1) {
    better_asc(__shfl_xor_sync(FULL, m.asc_v, o),
               __shfl_xor_sync(FULL, m.asc_i, o), m.asc_v, m.asc_i);
    better_desc(__shfl_xor_sync(FULL, m.desc_v, o),
                __shfl_xor_sync(FULL, m.desc_i, o), m.desc_v, m.desc_i);
  }
  if (lane == 0) part[b >> 5] = m;
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    const Best q = part[w];
    better_asc(q.asc_v, q.asc_i, m.asc_v, m.asc_i);
    better_desc(q.desc_v, q.desc_i, m.desc_v, m.desc_i);
  }

  const bool use_desc = m.desc_v >= m.asc_v;
  const float best_gain = jmax(m.desc_v, m.asc_v);
  const int best_thr = use_desc ? m.desc_i : m.asc_i;
  if (b == best_thr) {
    const Dir& d = use_desc ? desc : asc;
    float rel = best_gain - min_gain_shift;
    rel = rel * pen - cegb_split * num_data - cegb_f;
    const bool has = best_gain > NEG_GATE;
    const float feat_gain = (has && rel > 0.f && fmask > 0.5f) ? rel : NEG;
    const bool two_bin_nan = (mt == 2.f) && (nb <= 2.f);

    float* o = out + (size_t)row * ROW_W;
    o[OG] = feat_gain;
    o[OF] = (float)(row - ch * F);
    o[OT] = (float)best_thr;
    o[ODL] = (use_desc && !two_bin_nan) ? 1.f : 0.f;
    o[OLG] = d.lg;
    o[OLH] = d.lh;
    o[OLC] = d.lc;
    o[OLO] = d.lo;
    o[ORG] = d.rg;
    o[ORH] = d.rh;
    o[ORC] = d.rc;
    o[ORO] = d.ro;
  }
  __syncthreads();

  // the child's last block selects its best feature: the block's row is
  // published by one thread's fence and ticket after the barrier (the fence
  // is cumulative), and read after the last ticket's fence
  if (b == 0) {
    __threadfence();
    last = atomicAdd(ticket + ch, 1) == F - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  float bg = -INFINITY;
  int brow = 1 << 30;
  for (int f = b; f < F; f += blockDim.x)
    better_asc(__ldcg(out + (size_t)(ch * F + f) * ROW_W + OG), f, bg, brow);
  for (int o = 16; o > 0; o >>= 1)
    better_asc(__shfl_xor_sync(FULL, bg, o), __shfl_xor_sync(FULL, brow, o),
               bg, brow);
  if (lane == 0) part[b >> 5] = Best{bg, 0.f, brow, 0};
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) better_asc(part[w].asc_v, part[w].asc_i, bg, brow);
  if (b >= ROW_W) return;
  const bool has = bg > NEG_GATE;
  float v = has ? __ldcg(out + (size_t)(ch * F + brow) * ROW_W + b) : 0.f;
  if (b == OG && !has) v = NEG;
  if (b == OF && !has) v = -1.f;
  if (b == OLH || b == ORH) v = v - K_EPSILON;
  best[ch * ROW_W + b] = v;
  if (b == 0) ticket[ch] = 0;
}

}  // namespace

// hist [CH*F, B, 3], fvec [CH*F, 8], svec [CH, 8], pvec [8] f32; out
// [CH*F, ROW_W] and best [CH, ROW_W] f32; ticket int32 [>= CH], zero before
// the first launch (each launch leaves it zero), used by no launch that
// may run at the same time.
LGBT_API int lgbt_split_scan(const float* hist, const float* fvec,
                             const float* svec, const float* pvec, float* out,
                             float* best, int* ticket, int CH, int F, int B,
                             cudaStream_t stream) {
  if (B > MAX_BINS || B < 1 || F < 1 || CH < 1 || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * ((B + 31) / 32);
  split_scan_kernel<<<CH * F, threads, 0, stream>>>(hist, fvec, svec, pvec,
                                                    out, best, ticket, F, B);
  return (int)cudaGetLastError();
}
