// The body of K3 (partition_segment.cu), shared with K8, its stage
// ablation (partition_ablate.cu): one kernel, partition_kernel, whose STAGE
// template parameter defaults to K3 itself.  partition_segment.cu describes
// the design and the in-place argument.
#pragma once

#include "smem_hist.cuh"

namespace {

// sc layout, shared with ops/partition_kernel.py
enum { SC_START = 0, SC_CNT = 1, SC_DST_A = 2, SC_DST_B = 3, SC_CNT_B = 4,
       SC_CNT_A = 5, SC_CHAN = 6, SC_XR = 7 };

// The cumulative stages of partition_kernel (K8, partition_ablate.cu);
// K3 is STAGE_STORE.
enum { STAGE_READ = 0, STAGE_DECIDE = 1, STAGE_LOOKBACK = 2,
       STAGE_GATHER = 3, STAGE_STORE = 4 };

constexpr int PART_THREADS = 256;        // without a histogram
constexpr int PART_HIST_THREADS = 512;   // pred mode with its histogram
constexpr int PART_TILE = 1024;          // rows a tile
constexpr int PART_TILE_SMALL = 512;     // rows a tile, wide G or HIST
constexpr int PART_TWO_BLOCKS = 113 * 1024;    // two blocks an SM below it
constexpr int PART_MAX_SMEM = 231424;   // 227 KB a block, less static

// The launch's state words (int32, zeroed on the stream before it): the
// ticket, then a status word per tile, then a staged flag per tile.  A
// status word holds its flag in the top two bits and an A count below
// (counts stay below 2^24 rows).
constexpr unsigned ST_AGG = 1u << 30;    // the tile's own A count
constexpr unsigned ST_INC = 2u << 30;    // A rows of tiles 0..t inclusive
constexpr unsigned ST_COUNT = ST_AGG - 1;

// Shared-memory layout of one staged tile of T rows: G bin planes, the two
// payload planes and the row-id plane, each with 16 bytes of slack for the
// segment's misalignment, then the tile's output permutation (uint16 [T]).
struct TileGeom {
  int T, sb, sp, sr;
  __host__ __device__ int bytes(int G) const {
    return G * sb + 2 * sp + sr + 2 * T;
  }
};

template <typename P>
__host__ __device__ __forceinline__ TileGeom tile_geom(int T) {
  return TileGeom{T, T + 16, T * (int)sizeof(P) + 16, T * 4 + 16};
}

// Rows a tile, and whether the block keeps a ring of two staged tiles
// (the next tile's copies in flight while it finishes the current one):
// the largest tile whose ring leaves two blocks an SM; pred mode with the
// histogram keeps one 512-row tile beside its sub-histogram.  Mirrored by
// ops/partition_kernel.partition_tile.
struct PartShape {
  int T;
  bool ring;
};

template <typename P>
PartShape part_shape(int G, bool hist) {
  if (hist) return PartShape{PART_TILE_SMALL, false};
  for (int T : {PART_TILE, PART_TILE_SMALL})
    if (2 * tile_geom<P>(T).bytes(G) <= PART_TWO_BLOCKS)
      return PartShape{T, true};
  const bool ring = 2 * tile_geom<P>(PART_TILE_SMALL).bytes(G) <= PART_MAX_SMEM;
  return PartShape{PART_TILE_SMALL, ring};
}

// Decision mode: stream A is (goleft[bin of channel sc[CHAN]] != 0) XOR
// sc[XR], the bin read from the staged tile.  bind() reads the per-launch
// scalars once per block; the channel is clamped into [0, G) so that a
// wrong one cannot read outside the tile.
struct DecisionRoute {
  const uint8_t* goleft;

  struct Bound {
    const uint8_t* goleft;
    int chan, xr;
    __device__ __forceinline__ int plane() const { return chan; }   // the key
    __device__ __forceinline__ int operator()(const uint8_t* bin,
                                              long long) const {
      return (__ldg(goleft + *bin) != 0) ^ xr;
    }
  };
  __device__ __forceinline__ Bound bind(const int* sc, int G) const {
    return Bound{goleft, min(max(sc[SC_CHAN], 0), G - 1), sc[SC_XR]};
  }
};

// Pred mode: stream A is pred[col] != 0 (0 past the predicate's length).
struct PredRoute {
  const uint8_t* pred;
  long long len;

  __device__ __forceinline__ PredRoute bind(const int*, int) const {
    return *this;
  }
  __device__ __forceinline__ int plane() const { return -1; }   // no key plane
  __device__ __forceinline__ int operator()(const uint8_t*,
                                            long long col) const {
    return col < len && __ldg(pred + col) != 0;
  }
};

// The histogram output of a HIST launch.
template <typename P>
struct HistSink {
  typename HistAcc<P>::T* out;   // [G, B, 3], zeroed by the caller
  int B;
  int f_chunk;                   // features summed in shared memory
  int stream;                    // 0: stream A's rows, 1: stream B's
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row's planes summed as bits: K8's checksums.
__device__ __forceinline__ unsigned bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned bits_of(int8_t v) { return (uint8_t)v; }

// Four payload values to four consecutive columns, col % 4 == 0.
__device__ __forceinline__ void store4(float* d, float a, float b, float c,
                                       float e) {
  *reinterpret_cast<float4*>(d) = make_float4(a, b, c, e);
}
__device__ __forceinline__ void store4(int8_t* d, int8_t a, int8_t b,
                                       int8_t c, int8_t e) {
  *reinterpret_cast<unsigned*>(d) =
      (unsigned)(uint8_t)a | (unsigned)(uint8_t)b << 8 |
      (unsigned)(uint8_t)c << 16 | (unsigned)(uint8_t)e << 24;
}

// One staged tile in shared memory: row i of plane c at its shift.
template <typename P>
struct Staged {
  const uint8_t* bins;   // G planes, sb bytes apart
  const P* pay0;
  const P* pay1;
  const int* rid;
  int sb, shift_b, shift_p, shift_r;

  __device__ __forceinline__ uint8_t bin(int c, int i) const {
    return bins[c * sb + shift_b + i];
  }
  __device__ __forceinline__ unsigned words(int G, int i) const {
    unsigned s = 0;
    for (int c = 0; c < G; ++c) s += bin(c, i);
    return s + bits_of(pay0[shift_p + i]) + bits_of(pay1[shift_p + i]) +
           (unsigned)rid[shift_r + i];
  }
};

// Decoupled look-back by one warp: the A rows of tiles 0..t-1, read from
// their status words 32 at a time (lane l reads tile t-1-l of the window),
// each lane spinning until its word is published, up to the nearest
// inclusive word; every lane gets the sum.
__device__ __forceinline__ unsigned look_back(const unsigned* status, int t,
                                              int lane) {
  const volatile unsigned* st = status;
  unsigned prefix = 0;
  for (int base = t - 1; base >= 0; base -= 32) {
    const int j = base - lane;
    unsigned s = j >= 0 ? st[j] : ST_INC;   // before tile 0: zero rows
    while (__any_sync(0xffffffffu, (s & ~ST_COUNT) == 0))
      if ((s & ~ST_COUNT) == 0) s = st[j];
    const unsigned inc = __ballot_sync(0xffffffffu, (s & ST_INC) != 0);
    const int stop = inc ? __ffs(inc) - 1 : 31;   // the nearest inclusive
    prefix += __reduce_add_sync(0xffffffffu,
                                lane <= stop ? (s & ST_COUNT) : 0u);
    if (inc) break;
  }
  return prefix;
}

// A flag store that orders the thread's earlier memory operations before
// it, and a load that orders the thread's later ones after it (gpu scope).
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The block's sum of v; thread 0 gets it.
template <int NT>
__device__ __forceinline__ unsigned block_total(unsigned v, unsigned* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// The flags of one decided tile: bit k of mask for row threadIdx.x * rpt
// + k, the tile's A rows, and the A rows before the thread's first row.
struct Decided {
  unsigned mask;
  int n_a, excl;
};

// K3: see partition_segment.cu.  STAGE < STAGE_STORE is K8's ablation:
// such a launch moves no row and writes, per tile t, a checksum to chk[t]
// (what ops/partition_kernel.partition_ablate_plain computes).
template <typename P, typename Route, bool HIST, int NT,
          int STAGE = STAGE_STORE>
__global__ void __launch_bounds__(NT, 2)
partition_kernel(ArenaT<P> a, int* __restrict__ sc, Route route,
                 unsigned* __restrict__ state, int T, bool ring, int G,
                 int max_tiles, HistSink<P> hs,
                 unsigned* __restrict__ chk) {
  using A = typename HistAcc<P>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket;
  __shared__ unsigned s_prefix;
  __shared__ int s_warp[NT / 32];
  __shared__ unsigned s_red[NT / 32];
  constexpr int VP = 16 / (int)sizeof(P);      // payload values a vector
  const TileGeom geo = tile_geom<P>(T);
  const int tile_bytes = geo.bytes(G);
  // a slot: G bin planes, two payload planes, the row ids, the permutation
  const int off_p0 = G * geo.sb, off_p1 = off_p0 + geo.sp;
  const int off_r = off_p1 + geo.sp, off_perm = off_r + geo.sr;
  A* sh = reinterpret_cast<A*>(smem + (ring ? 2 : 1) * tile_bytes);

  const long long start = sc[SC_START];
  const long long cnt = sc[SC_CNT];
  const long long dst_a = sc[SC_DST_A];
  const long long dst_b = sc[SC_DST_B];
  const auto goes_a = route.bind(sc, G);
  const int kp = goes_a.plane();               // the key plane, or -1
  const long long ntiles_ll = (cnt + T - 1) / T;
  if (ntiles_ll > max_tiles) {
    // a segment longer than the rows the launch was sized for: no row
    // moves, and the counts say so
    if (STAGE >= STAGE_LOOKBACK && blockIdx.x == 0 && threadIdx.x == 0) {
      sc[SC_CNT_A] = -1;
      sc[SC_CNT_B] = -1;
    }
    return;
  }
  const int ntiles = (int)ntiles_ll;
  if (STAGE >= STAGE_LOOKBACK && ntiles == 0 && blockIdx.x == 0 &&
      threadIdx.x == 0) {
    sc[SC_CNT_A] = 0;
    sc[SC_CNT_B] = 0;
  }
  const int rpt = T / NT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = threadIdx.x * rpt;            // the thread's first row
  const int hist_a = HIST ? (hs.stream == 0) : 0;
  const int nf0 = HIST ? min(hs.f_chunk, G) : 0;
  if (HIST) hist_zero(sh, nf0 * hs.B * 3);
  unsigned* status = state + 1;
  unsigned* staged = state + 1 + max_tiles;

  auto claim = [&]() {
    if (threadIdx.x == 0) s_ticket = atomicAdd(state, 1u);
    __syncthreads();
    return s_ticket;
  };
  auto tile_of = [&](int t, int slot) {
    const long long col0 = start + (long long)t * T;
    unsigned char* b = smem + slot * tile_bytes;
    return Staged<P>{b, reinterpret_cast<P*>(b + off_p0),
                     reinterpret_cast<P*>(b + off_p1),
                     reinterpret_cast<int*>(b + off_r), geo.sb,
                     (int)(col0 & 15), (int)(col0 & (VP - 1)),
                     (int)(col0 & 3)};
  };
  auto rows_of = [&](int t) {
    return (int)min((long long)T, cnt - (long long)t * T);
  };

  // Stage tile t in slot: 16-byte copies in two groups, the key plane
  // (decision mode), which the decisions need, then every other plane.
  // Past the last tile, two empty groups keep the count of groups.
  auto issue = [&](int t, int slot) {
    if (t < ntiles) {
      const long long col0 = start + (long long)t * T;
      const int nt = rows_of(t);
      const Staged<P> v = tile_of(t, slot);
      const int nvb = (v.shift_b + nt + 15) >> 4;
      const int nvp = (v.shift_p + nt + VP - 1) / VP;
      const int nvr = (v.shift_r + nt + 3) >> 2;
      uint8_t* b = const_cast<uint8_t*>(v.bins);
      const uint8_t* src_b = a.bins + (col0 - v.shift_b);
      if (kp >= 0)
        for (int k = threadIdx.x; k < nvb; k += NT)
          cp_async16(b + kp * geo.sb + 16 * k,
                     src_b + (long long)kp * a.cap + 16 * k);
      cp_async_commit();
      const int total = G * nvb + 2 * nvp + nvr;
      for (int idx = threadIdx.x; idx < total; idx += NT) {
        const void* src;
        void* dst;
        if (idx < G * nvb) {
          const int c = idx / nvb, k = idx - c * nvb;
          if (c == kp) continue;
          src = src_b + (long long)c * a.cap + 16 * k;
          dst = b + c * geo.sb + 16 * k;
        } else if (idx < G * nvb + 2 * nvp) {
          const int r = idx - G * nvb;
          const int c = r / nvp, k = r - c * nvp;
          src = a.gh + (long long)c * a.cap + (col0 - v.shift_p) + VP * k;
          dst = b + (c ? off_p1 : off_p0) + 16 * k;
        } else {
          const int k = idx - G * nvb - 2 * nvp;
          src = a.rid + (col0 - v.shift_r) + 4 * k;
          dst = b + off_r + 16 * k;
        }
        cp_async16(dst, src);
      }
    } else {
      cp_async_commit();
    }
    cp_async_commit();
  };

  // Decide tile t (its key plane staged in slot), block-scan the flags,
  // build the output permutation, and publish the tile's A count.
  auto decide = [&](int t, int slot) {
    Decided d{0u, 0, 0};
    if constexpr (STAGE >= STAGE_DECIDE) {
      const long long col0 = start + (long long)t * T;
      const int nt = rows_of(t);
      const Staged<P> v = tile_of(t, slot);
      const uint8_t* key = v.bins + max(kp, 0) * geo.sb + v.shift_b;
      for (int k = 0; k < rpt; ++k) {
        const int i = i0 + k;
        if (i < nt && goes_a(key + i, col0 + i)) d.mask |= 1u << k;
      }
      const int c = __popc(d.mask);
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
      int wpre = 0;
      for (int w = 0; w < NT / 32; ++w) {
        const int x = s_warp[w];
        d.n_a += x;
        if (w < warp) wpre += x;
      }
      __syncthreads();                         // s_warp is read
      d.excl = wpre + incl - c;
      if constexpr (STAGE >= STAGE_GATHER) {
        unsigned short* perm =
            reinterpret_cast<unsigned short*>(smem + slot * tile_bytes +
                                              off_perm);
        for (int k = 0; k < rpt; ++k) {
          const int i = i0 + k;
          if (i >= nt) break;
          const int ra = d.excl + __popc(d.mask & ((1u << k) - 1u));
          perm[(d.mask >> k) & 1u ? ra : d.n_a + (i - ra)] =
              (unsigned short)i;
        }
      }
      if constexpr (STAGE >= STAGE_LOOKBACK) {
        if (threadIdx.x == 0)
          reinterpret_cast<volatile unsigned*>(status)[t] =
              (t == 0 ? ST_INC : ST_AGG) | (unsigned)d.n_a;
      }
    }
    return d;
  };

  // Finish tile t, staged in slot and decided: its staged flag, its
  // histogram rows, the look-back, the wait for the tiles its A run
  // covers, and the two runs' stores.
  auto finish = [&](int t, int slot, const Decided& d) {
    const long long row0 = (long long)t * T;
    const int nt = rows_of(t);
    const Staged<P> tile = tile_of(t, slot);
    [[maybe_unused]] unsigned chk_v = 0;
    if constexpr (STAGE < STAGE_STORE) {
      for (int k = 0; k < rpt; ++k)
        if (i0 + k < nt) chk_v += tile.words(G, i0 + k);
      chk_v += __popc(d.mask);
    }
    if constexpr (STAGE >= STAGE_LOOKBACK) {
      // a later tile may now overwrite this tile's columns
      if (threadIdx.x == 0) store_release(staged + t, 1u);
      if (warp == 0) {
        const unsigned prefix = look_back(status, t, lane);
        if (lane == 0) {
          if (t > 0)
            reinterpret_cast<volatile unsigned*>(status)[t] =
                ST_INC | (prefix + (unsigned)d.n_a);
          s_prefix = prefix;
          if (t == ntiles - 1) {
            sc[SC_CNT_A] = (int)(prefix + d.n_a);
            sc[SC_CNT_B] = (int)(cnt - prefix - d.n_a);
          }
        }
      }
    }
    if constexpr (HIST) {
      // the chosen stream's rows: features [0, nf0) in shared memory, the
      // rest in global
      for (int k = 0; k < rpt; ++k) {
        const int i = i0 + k;
        if (i >= nt || (int)((d.mask >> k) & 1u) != hist_a) continue;
        const A g = A(tile.pay0[tile.shift_p + i]);
        const A h = A(tile.pay1[tile.shift_p + i]);
        for (int f = 0; f < nf0; ++f)
          hist_add(sh + (f * hs.B + tile.bin(f, i)) * 3, g, h);
        for (int f = nf0; f < G; ++f)
          hist_add_global(hs.out + ((size_t)f * hs.B + tile.bin(f, i)) * 3,
                          g, h);
      }
    }
    if constexpr (STAGE >= STAGE_LOOKBACK) {
      if (threadIdx.x == 0) {
        // stream A's run may cover columns of this segment's tiles (before
        // this one, when dstA <= start): wait until they are staged
        const long long g_a = dst_a + s_prefix;
        const long long lo = max(g_a, start);
        const long long hi = min(g_a + d.n_a, start + cnt);
        if (lo < hi) {
          const int u1 = min((int)((hi - 1 - start) / T), t - 1);
          for (int u = (int)((lo - start) / T); u <= u1; ++u)
            while (load_acquire(staged + u) == 0) {
            }
        }
      }
      __syncthreads();
      const long long prefix = s_prefix;
      const long long g_a = dst_a + prefix;          // stream A's run
      const long long g_b = dst_b + (row0 - prefix);  // stream B's run
      if constexpr (STAGE < STAGE_STORE) {
        for (int k = 0; k < rpt; ++k) {
          const int i = i0 + k;
          if (i >= nt) break;
          const int ra = d.excl + __popc(d.mask & ((1u << k) - 1u));
          chk_v += (unsigned)((d.mask >> k) & 1u ? g_a + ra
                                                  : g_b + (i - ra));
        }
      }
      if constexpr (STAGE >= STAGE_GATHER) {
        const unsigned short* perm = reinterpret_cast<const unsigned short*>(
            smem + slot * tile_bytes + off_perm);
        const int n_a = d.n_a;
        // Each run in quads of four columns aligned to 4 (a 4-byte word of
        // a bin or int8 plane, 16 bytes of an f32 or row-id plane), with
        // its unaligned head and tail moved one column at a time.  ng
        // threads share a quad's bin planes when a tile has fewer quads
        // than the block threads.
        const int n_b = nt - n_a;
        const int h_a = min(n_a, (int)((4 - (g_a & 3)) & 3));
        const int q_a = (n_a - h_a) >> 2;
        const int e_a = n_a - h_a - 4 * q_a;
        const int h_b = min(n_b, (int)((4 - (g_b & 3)) & 3));
        const int q_b = (n_b - h_b) >> 2;
        const int e_b = n_b - h_b - 4 * q_b;
        const int ng = max(1, 4 * NT / T);
        const int n_quad = (q_a + q_b) * ng;
        const int n_one = h_a + e_a + h_b + e_b;
        for (int it = threadIdx.x; it < n_quad + n_one; it += NT) {
          if (it < n_quad) {
            int q = it / ng;
            const int grp = it - q * ng;
            const bool in_a = q < q_a;
            if (!in_a) q -= q_a;
            const int p0 = (in_a ? h_a : n_a + h_b) + 4 * q;   // in perm
            const long long col = (in_a ? g_a + h_a : g_b + h_b) + 4 * q;
            const int s0 = perm[p0], s1 = perm[p0 + 1], s2 = perm[p0 + 2],
                      s3 = perm[p0 + 3];
            for (int c = grp; c < G; c += ng) {
              const unsigned w = (unsigned)tile.bin(c, s0) |
                                 (unsigned)tile.bin(c, s1) << 8 |
                                 (unsigned)tile.bin(c, s2) << 16 |
                                 (unsigned)tile.bin(c, s3) << 24;
              if constexpr (STAGE == STAGE_GATHER) {
                chk_v += (w & 255) + (w >> 8 & 255) + (w >> 16 & 255) +
                         (w >> 24);
              } else {
                *reinterpret_cast<unsigned*>(a.bins + (long long)c * a.cap +
                                             col) = w;
              }
            }
            if (grp == 0) {
              const P* pl[2] = {tile.pay0 + tile.shift_p,
                                tile.pay1 + tile.shift_p};
              const int* rl = tile.rid + tile.shift_r;
              if constexpr (STAGE == STAGE_GATHER) {
                for (int c = 0; c < 2; ++c)
                  chk_v += bits_of(pl[c][s0]) + bits_of(pl[c][s1]) +
                           bits_of(pl[c][s2]) + bits_of(pl[c][s3]);
                chk_v += (unsigned)rl[s0] + (unsigned)rl[s1] +
                         (unsigned)rl[s2] + (unsigned)rl[s3];
              } else {
                for (int c = 0; c < 2; ++c)
                  store4(a.gh + (long long)c * a.cap + col, pl[c][s0],
                         pl[c][s1], pl[c][s2], pl[c][s3]);
                *reinterpret_cast<int4*>(a.rid + col) =
                    make_int4(rl[s0], rl[s1], rl[s2], rl[s3]);
              }
            }
          } else {
            // one column of a head or a tail
            int s = it - n_quad;
            int p;            // position in perm
            long long col;
            if (s < h_a) {
              p = s;
              col = g_a + s;
            } else if ((s -= h_a) < e_a) {
              p = h_a + 4 * q_a + s;
              col = g_a + p;
            } else if ((s -= e_a) < h_b) {
              p = n_a + s;
              col = g_b + s;
            } else {
              s -= h_b;
              p = n_a + h_b + 4 * q_b + s;
              col = g_b + (p - n_a);
            }
            const int i = perm[p];
            if constexpr (STAGE == STAGE_GATHER) {
              chk_v += tile.words(G, i);
            } else {
              for (int c = 0; c < G; ++c)
                a.bins[(long long)c * a.cap + col] = tile.bin(c, i);
              a.gh[col] = tile.pay0[tile.shift_p + i];
              a.gh[a.cap + col] = tile.pay1[tile.shift_p + i];
              a.rid[col] = tile.rid[tile.shift_r + i];
            }
          }
        }
      }
    }
    if constexpr (STAGE < STAGE_STORE) {
      const unsigned sum = block_total<NT>(chk_v, s_red);
      if (threadIdx.x == 0) chk[t] = sum;
    }
    __syncthreads();   // the slot may be staged again
  };

  // The ring: while tile t finishes, the next tile's copies are in flight
  // and it is decided (its count published) first, so that the tiles after
  // it need not wait for tile t's stores.  Without the ring the next tile
  // is claimed after tile t is finished.
  int t = claim();
  issue(t, 0);
  int slot = 0;
  Decided d{0u, 0, 0};
  if (t < ntiles) {
    cp_async_wait<1>();                        // its key plane
    __syncthreads();
    d = decide(t, 0);
  }
  while (t < ntiles) {
    int tn = ntiles;
    if (ring) {
      tn = claim();
      issue(tn, slot ^ 1);
    } else {
      cp_async_commit();
      cp_async_commit();
    }
    cp_async_wait<1>();        // tile t whole, and tn's key plane
    __syncthreads();
    Decided dn{0u, 0, 0};
    if (ring && tn < ntiles) dn = decide(tn, slot ^ 1);
    finish(t, slot, d);
    if (!ring) {
      tn = claim();
      issue(tn, 0);
      if (tn < ntiles) {
        cp_async_wait<1>();
        __syncthreads();
        dn = decide(tn, 0);
      }
    } else {
      slot ^= 1;
    }
    t = tn;
    d = dn;
  }

  if constexpr (HIST) {
    // the loop ends after a __syncthreads: every row is summed
    hist_flush(sh, hs.out, nf0 * hs.B * 3);
  }
}

// One launch of partition_kernel on a persistent grid (the blocks an SM
// holds at this shared memory, times the SMs), after resetting the ticket,
// the status words and the staged flags of max_rows' tiles on the stream.
template <typename P, typename Route, bool HIST, int NT,
          int STAGE = STAGE_STORE>
int launch_partition(const ArenaT<P>& a, int* sc, Route route,
                     unsigned* state, long long state_len, long long max_rows,
                     int G, HistSink<P> hs, unsigned* chk,
                     cudaStream_t stream) {
  using A = typename HistAcc<P>::T;
  if (G < 1 || max_rows < 0 || state == nullptr)
    return (int)cudaErrorInvalidValue;
  const PartShape shape = part_shape<P>(G, HIST);
  const int T = shape.T;
  int smem = (shape.ring ? 2 : 1) * tile_geom<P>(T).bytes(G);
  if constexpr (HIST) {
    if (hs.out == nullptr || hs.B < 1 || hs.B > 256 || (hs.stream & ~1))
      return (int)cudaErrorInvalidValue;
    const int entry = hs.B * 3 * (int)sizeof(A);
    hs.f_chunk = min(G, (PART_MAX_SMEM - smem) / entry);
    if (hs.f_chunk < 1) return (int)cudaErrorInvalidValue;
    smem += hs.f_chunk * entry;
  }
  if (smem > PART_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long tiles = (max_rows + T - 1) / T;
  if (1 + 2 * tiles > state_len) return (int)cudaErrorInvalidValue;

  auto kernel = partition_kernel<P, Route, HIST, NT, STAGE>;
  static int cached_smem = -1, cached_blocks = 0;
  if (smem != cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cached_blocks = max(per_sm, 1) * sms;
    cached_smem = smem;
  }
  cudaError_t err = cudaMemsetAsync(
      state, 0, (size_t)(1 + 2 * tiles) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<cached_blocks, NT, smem, stream>>>(a, sc, route, state, T,
                                              shape.ring, G, (int)tiles, hs,
                                              chk);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_decision(uint8_t* bins, P* gh, int* rid, long long cap, int* sc,
                    const uint8_t* goleft, unsigned* state,
                    long long state_len, long long max_rows, int G,
                    cudaStream_t stream) {
  const ArenaT<P> a{bins, gh, rid, cap};
  return launch_partition<P, DecisionRoute, false, PART_THREADS>(
      a, sc, DecisionRoute{goleft}, state, state_len, max_rows, G,
      HistSink<P>{}, nullptr, stream);
}

template <typename P>
int launch_pred(uint8_t* bins, P* gh, int* rid, long long cap, int* sc,
                const uint8_t* pred, long long pred_len, unsigned* state,
                long long state_len, long long max_rows, int G,
                typename HistAcc<P>::T* hist, int B, int hist_stream,
                cudaStream_t stream) {
  const ArenaT<P> a{bins, gh, rid, cap};
  const PredRoute route{pred, pred_len};
  if (hist == nullptr)
    return launch_partition<P, PredRoute, false, PART_THREADS>(
        a, sc, route, state, state_len, max_rows, G, HistSink<P>{}, nullptr,
        stream);
  return launch_partition<P, PredRoute, true, PART_HIST_THREADS>(
      a, sc, route, state, state_len, max_rows, G,
      HistSink<P>{hist, B, 0, hist_stream}, nullptr, stream);
}

}  // namespace
