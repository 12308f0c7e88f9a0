// K1: numerical best-threshold scan with the cross-feature select.
//
// Replaces: lightgbm_tpu/ops/split_pallas.py _split_scan_kernel (launched by
// _run_scan, pl.pallas_call at :242), which scans CH stacked children's
// [F, B, 3] histograms in one launch and selects each child's best feature.
//
// What bounds it on an H100: neither bytes nor operations.  One launch reads
// CH*F*B*3 floats (170 KB for two children of the Higgs shape) and does
// ~100 flops a bin, a few microseconds of work at the card's rates; the time
// is the launch and the block-wide scans' barriers.
//
// Design: one block per (child, feature) row and one thread per bin.  The
// inclusive prefix sums use the same Hillis-Steele doubling as the Pallas
// kernel (log2(B) steps through shared memory), so the sums are the very
// same f32 values in the same association order; the library is built with
// --fmad=false so the gain formulas round as the reference's do.  Argmax
// ties keep the reference's rules: descending beats ascending at equal gain,
// the higher threshold wins inside descending, the lower inside ascending.
// A second one-block-per-child kernel does select_best_feature (lowest
// feature id on ties) and writes a ready-to-store packed split row.
#include "common.cuh"

namespace {

constexpr float NEG = -1e38f;
constexpr float NEG_GATE = -1e37f;
constexpr float K_EPSILON = 1e-15f;
constexpr int SCAN_THREADS = 256;   // bins per row: B <= 256

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

// Inclusive Hillis-Steele prefix over the first n lanes of buf (one value
// per thread); lanes >= n are zero and never feed a lane below n.
__device__ float prefix_lanes(float* buf, float x, int n) {
  const int t = threadIdx.x;
  for (int sh = 1; sh < n; sh *= 2) {
    buf[t] = x;
    __syncthreads();
    float add = (t >= sh) ? buf[t - sh] : 0.f;
    __syncthreads();
    x = x + add;
  }
  return x;
}

// Block-wide reduction of a value and an index under a caller's order.
template <typename Better>
__device__ void block_best(float* vbuf, int* ibuf, float& v, int& idx,
                           Better better) {
  const int t = threadIdx.x;
  vbuf[t] = v;
  ibuf[t] = idx;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      float v2 = vbuf[t + s];
      int i2 = ibuf[t + s];
      if (better(v2, i2, vbuf[t], ibuf[t])) {
        vbuf[t] = v2;
        ibuf[t] = i2;
      }
    }
    __syncthreads();
  }
  v = vbuf[0];
  idx = ibuf[0];
  __syncthreads();
}

__global__ void __launch_bounds__(SCAN_THREADS)
split_scan_kernel(const float* __restrict__ hist,   // [R, B, 3]
                  const float* __restrict__ fvec,   // [R, 8]
                  const float* __restrict__ svec,   // [CH, 8]
                  const float* __restrict__ pvec,   // [8]
                  float* __restrict__ out,          // [R, ROW_W]
                  int F, int B) {
  __shared__ float fbuf[SCAN_THREADS];
  __shared__ int ibuf[SCAN_THREADS];
  const int row = blockIdx.x;
  const int ch = row / F;
  const int b = threadIdx.x;

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
  const bool in_range = bf < nb;
  const bool excl = ((mt == 1.f && bf == db) || (mt == 2.f && bf == nb - 1.f)) &&
                    in_range && (nb > 2.f);
  const bool live = in_range && !excl && b < B;
  const float* hr = hist + ((size_t)row * B + (b < B ? b : 0)) * 3;
  const float g = live ? hr[0] : 0.f;
  const float h = live ? hr[1] : 0.f;
  const float c = live ? hr[2] : 0.f;

  const float cg = prefix_lanes(fbuf, g, B);
  const float chh = prefix_lanes(fbuf, h, B);
  const float cc = prefix_lanes(fbuf, c, B);
  if (b == B - 1) {
    fbuf[0] = cg;
    fbuf[1] = chh;
    fbuf[2] = cc;
  }
  __syncthreads();
  const float tg = fbuf[0], th = fbuf[1], tc = fbuf[2];
  __syncthreads();

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
  float asc_m = (asc_ok && asc.valid && asc.gain > min_gain_shift) ? asc.gain : NEG;
  float desc_m = (thr_ok && desc.valid && desc.gain > min_gain_shift) ? desc.gain : NEG;

  // ascending: max gain, lowest threshold on ties
  float asc_best = lane_ok ? asc_m : -INFINITY;
  int asc_thr = lane_ok ? b : 1 << 30;
  block_best(fbuf, ibuf, asc_best, asc_thr,
             [](float v2, int i2, float v1, int i1) {
               return v2 > v1 || (v2 == v1 && i2 < i1);
             });
  // descending: max gain, highest threshold on ties
  float desc_best = lane_ok ? desc_m : -INFINITY;
  int desc_thr = lane_ok ? b : -1;
  block_best(fbuf, ibuf, desc_best, desc_thr,
             [](float v2, int i2, float v1, int i1) {
               return v2 > v1 || (v2 == v1 && i2 > i1);
             });

  const bool use_desc = desc_best >= asc_best;
  const float best_gain = jmax(desc_best, asc_best);
  const int best_thr = use_desc ? desc_thr : asc_thr;
  if (b != best_thr) return;

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

constexpr int SELECT_THREADS = 256;

__global__ void __launch_bounds__(SELECT_THREADS)
select_best_kernel(const float* __restrict__ rows,   // [CH*F, ROW_W]
                   float* __restrict__ best,         // [CH, ROW_W]
                   int F) {
  __shared__ float vbuf[SELECT_THREADS];
  __shared__ int ibuf[SELECT_THREADS];
  const int ch = blockIdx.x;
  float bg = -INFINITY;
  int brow = 1 << 30;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float v = rows[(size_t)(ch * F + f) * ROW_W + OG];
    if (v > bg || (v == bg && f < brow)) {
      bg = v;
      brow = f;
    }
  }
  block_best(vbuf, ibuf, bg, brow, [](float v2, int i2, float v1, int i1) {
    return v2 > v1 || (v2 == v1 && i2 < i1);
  });
  const int lane = threadIdx.x;
  if (lane >= ROW_W) return;
  const bool has = bg > NEG_GATE;
  float v = has ? rows[(size_t)(ch * F + brow) * ROW_W + lane] : 0.f;
  if (lane == OG && !has) v = NEG;
  if (lane == OF && !has) v = -1.f;
  if (lane == OLH || lane == ORH) v = v - K_EPSILON;
  best[ch * ROW_W + lane] = v;
}

}  // namespace

LGBT_API int lgbt_split_scan(const float* hist, const float* fvec,
                             const float* svec, const float* pvec, float* out,
                             float* best, int CH, int F, int B,
                             cudaStream_t stream) {
  if (B > SCAN_THREADS || B < 1 || F < 1 || CH < 1) return (int)cudaErrorInvalidValue;
  split_scan_kernel<<<CH * F, SCAN_THREADS, 0, stream>>>(hist, fvec, svec, pvec,
                                                         out, F, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_best_kernel<<<CH, SELECT_THREADS, 0, stream>>>(out, best, F);
  return (int)cudaGetLastError();
}
