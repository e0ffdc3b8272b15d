// The forward-backward of the alignment-free lattice losses, for training:
// the transducer lattice (lattice_fwdbwd_kernel) and the CRF sequence
// lattice with its seven-state local partition (crf_lattice_fwdbwd_kernel).
//
// Replaces: nothing of a TPU kernel. These are the lax.scans of
// scrappie_tpu/train/lattice.py (_lattice_forward_impl :49,
// _crf_lattice_forward_impl :125, _crf_local_partition_impl :210) and the
// VJPs XLA derives for them when the JAX trainer differentiates the lattice
// losses (train/lattice.py, train/wholeread.py, whose chunked_scan the
// checkpoints below stand for). ops/lattice.py holds the recurrences, the
// normalisation, the checkpoints and the plain twins (lattice_fwd_plain,
// lattice_bwd_plain, crf_fwd_plain, crf_bwd_plain, partition_fwd_plain,
// partition_bwd_plain), whose arithmetic a step these kernels repeat.
//
// What bounds them on the H100: each is a walk of T dependent steps over
// a row's L sequence positions (the CRF: 2(L + 1) states), a barrier a
// step; the bytes the function needs are the emissions it gathers (L + 1
// entries of a logpost row, or a transition row) and the gradient it
// writes ([T, B, S] or [T, B, 25]), so the bound is bytes, far below the
// walk's latency at the windows' B = 8 and a whole read's B = 1. What
// the earlier design lost (a block a row): a whole read's 7 000 positions on
// one SM of 132, a step's arithmetic several thousand issue cycles there;
// each step's emission gathers and stored rows read after the barrier; and
// every step's row kept in device memory, 0.86 and 1.72 GB at a whole read.
//
// Design. A row runs on a cluster of ncta CTAs (ops/lattice.cluster_layout:
// a CTA for each 256 positions, up to 16), CTA c owning the positions
// [c per, (c+1) per), a thread the positions c per + tid + k blockDim (k <
// PPT, at most 512 threads a CTA: 128 registers a thread; ptxas spills
// only at PPT 4 and 8, above 512 x 2 positions a CTA). Above
// 16 x 512 x 8 positions (the MULTI instances) a thread owns ngroup runs of
// PPT = 8 such positions, run g starting g PPT blockDim further, and walks
// them in turn each step, loading a run's inputs as it walks it. A
// step: every input it reads that does not depend on the recurrence (the
// emissions of the thread's positions, the stored row of the backward, the
// kept maxima) was loaded into registers at the top of the step before, so its
// latency hides behind that step's arithmetic; the CTA's rows live in
// shared memory with halos: the forward's two (CRF: one) scores left of
// the CTA, the backward's two (one) u right of it, which the neighbour CTA
// pushes through distributed shared memory. The forward's maximum is pushed
// by every warp to every CTA's slot of it, and each warp reduces the slots
// at the next step; START and END are CTA 0's thread 0's, and the owner of
// the row's last position pushes its score (the backward: CTA 0 pushes
// END's beta_tilde to that owner). So a step ends in one barrier: the
// cluster's (barrier.cluster.arrive.release / wait.acquire), as
// csrc/dtw.cu's dtw_cluster_kernel does, or the block's for one CTA; the
// rows it keeps are stored between the arrive and the wait. Above what
// shared memory holds a CTA's arrays live in a global scratch array
// instead (global_rows). On an H100 a cp.async ring of the inputs, two
// steps ahead, was slower than the registers (a window's 800 positions on
// one SM issue-bound), and so was one CTA a window row (4 CTAs faster).
//
// Memory: checkpoints every chunk steps (ops/lattice.py). The forward keeps
// m, the rows at t % chunk == 0 and t = T, and the last chunk's rows; the
// backward walks the chunks from last to first, each recomputed first from
// its checkpoint into `work` by the forward's arithmetic with the kept m,
// so its rows are the forward's bit for bit.
//
// The gradient, deterministic (no atomics, so that it is the same bit for
// bit at every chunk and every run): each step's posteriors are written by
// position (the transducer: each position's emission posterior to `post`
// [B, chunk, L]; the CRF: ee, es and se to a double-buffered shared array,
// summed a step late into the CTA's 24 classes by the warps from the CTA's
// class lists), each warp's sums of the stays and of every edge go to
// shared memory, and a step later a warp sums them into the CTA's part of
// the step. After a chunk's walk the cluster writes the chunk's gradient
// rows: each step's total over the CTAs, then each kmer state's positions
// summed in position order (the transducer, from ops/lattice.state_lists)
// or each class's CTA parts (the CRF), times gP / total: each step's
// posteriors divided by their sum, 1 in exact arithmetic, which cancels the
// float32 drift common to the step (ops/lattice.py). The CRF's local
// partition runs in its own block a row (grid z = 1), one warp, lanes 0-4
// the five states, 5 START, 6 END, all its rows [B, T+1, 8] and maxima kept
// (8 floats a step); its backward writes its own gradient array, which the
// wrapper adds to the lattice's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;
constexpr int MAXW = MAX_CLUSTER * MAX_THREADS / 32;  // warps of a cluster
constexpr int NCLASS = 25;
constexpr int NPART = NCLASS + 1;  // the CRF's CTA part: 24 classes, ss, total
constexpr int TBLK = 16;   // steps of a transducer gradient task

// jnp.logaddexp: max(a, b) + log1p(exp(-|a - b|)), a + b where a - b is NaN.
__device__ __forceinline__ float lae(float a, float b) {
  const float d = __fsub_rn(a, b);
  if (isnan(d)) return __fadd_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(d))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Where a CTA's arrays are, who it is, and the step's barrier.
struct Cta {
  float* big;       // this CTA's per-position arrays (shared or scratch)
  float* scratch;   // global_rows: the row's CTAs' arrays, nfloats each
  int nfloats;
  int c, ncta, nt, tid, lane, warp, nwarps;
  bool shared;      // big in shared memory or in scratch

  __device__ void sync() const {
    if (ncta == 1) {
      __syncthreads();
    } else {
      cluster_arrive();
      cluster_wait();
    }
  }
  // The same array of CTA r.
  __device__ float* remote(float* p, int r) const {
    if (r == c) return p;
    if (shared) return cg::this_cluster().map_shared_rank(p, r);
    return p + (long long)(r - c) * nfloats;
  }
  __device__ float* remote_static(float* p, int r) const {
    return r == c ? p : cg::this_cluster().map_shared_rank(p, r);
  }
};

__device__ Cta make_cta(float* smem, float* scratch, int nfloats, int b) {
  Cta k;
  k.c = blockIdx.x;
  k.ncta = gridDim.x;
  k.nt = blockDim.x;
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.warp = threadIdx.x >> 5;
  k.nwarps = (blockDim.x + 31) >> 5;
  k.shared = scratch == nullptr;
  k.nfloats = nfloats;
  k.scratch = scratch;
  k.big = k.shared ? smem
                   : scratch + ((size_t)b * k.ncta + k.c) * (size_t)nfloats;
  return k;
}

// The maximum of the cluster's warps' entries of a step, in every thread.
__device__ __forceinline__ float slots_max(const float* w, int n, int lane) {
  float v = NEG;
  for (int i = lane; i < n; i += 32) v = fmaxf(v, w[i]);
  return warp_max(v);
}

// The count of entries >= 0 of seq[0 .. n), in every thread (barriers).
__device__ int count_valid(const int* __restrict__ seq, int n, int* s_count) {
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();
  int c = 0;
  for (int l = threadIdx.x; l < n; l += blockDim.x) c += seq[l] >= 0;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(s_count, c);
  __syncthreads();
  return *s_count;
}

// Where the forward keeps its rows: row t at t = 0, C, ..., (n - 1) C in
// the checkpoints, t = T in the last one, and the last chunk's rows, t =
// (n - 1) C .. T - 1, in `rows`; by a counter, with no division a step.
struct Keep {
  float* ck0;  // this row's checkpoint 0
  float* rw0;  // this row's `rows`, row (n - 1) C
  int C, n, T, R, last_lo;
  int next;    // the next checkpoint step
  // The stores of row t: f(dst) for each place it is kept.
  template <typename F>
  __device__ void each(int t, F&& f) const {
    if (t == next && t <= last_lo) f(ck0 + (size_t)(t / C) * R);
    if (t >= last_lo && t < T) f(rw0 + (size_t)(t - last_lo) * R);
    if (t == T) f(ck0 + (size_t)n * R);
  }
  __device__ void advance(int t) {
    if (t == next) next += C;
  }
  template <typename F>
  __device__ void at(int t, F&& f) {
    each(t, f);
    advance(t);
  }
};

__device__ __forceinline__ Keep make_keep(float* ckpt, float* rows, int b,
                                          int C, int n, int T, int R) {
  return Keep{ckpt + (size_t)b * (n + 1) * R, rows + (size_t)b * C * R, C, n,
              T, R, (n - 1) * C, C};
}

// ------------------------------------------------------------- transducer

struct TArgs {
  const float* lp;    // [T, B, S]
  const int* seq;     // [B, L]
  float* ckpt;        // [B, n+1, R]
  float* rows;        // [B, C, R]
  float* m;           // [B, T+1]
  float* logp;        // [B]
  const float* gP;    // [B]
  float* grad;        // [T, B, S]
  float* work;        // [B, C, R] or null (n == 1)
  float* post;        // [B, C, L]
  float* part;        // [B, C, ncta, 2]
  const int* start;   // [B, S+1]
  const int* pos;     // [B, L]
  float* scratch;     // [B, ncta, nfloats] or null
  int T, B, S, L, C, n, per, nfloats, ngroup;
  float stay, skip, local;
};

// A CTA's arrays (per = P): the forward's rows [2][P+2] (position l at
// l - l0 + 2), the backward's own beta_tilde [P] and u [2][P+2] (l - l0,
// then the right halo).
__host__ __device__ inline size_t t_floats(int P) { return 5 * (size_t)P + 8; }

struct TLay {
  float *rowbuf, *bt, *ub;
};

__device__ TLay t_lay(float* base, int P) {
  TLay y;
  y.rowbuf = base;
  y.bt = y.rowbuf + 2 * (P + 2);
  y.ub = y.bt + P;
  return y;
}

// A forward step's inputs, loaded into registers a step ahead: the
// emissions of the thread's positions, the stay, and (the recompute) the
// offset m_{t-1}.
template <int PPT>
struct TFin {
  float e[PPT];
  float stay, mp;
};

// A backward step t's: the stored row t - 1 at the thread's positions and
// their two left neighbours, lp row t - 2's emissions (for u), row t - 1's
// stay, m_t, m_{t-1}, and for CTA 0's thread 0 row t - 1's START, END and
// last position.
template <int PPT>
struct TBin {
  float a0[PPT], a1[PPT], a2[PPT], e[PPT];
  float stay, mt, mp, start, end, last;
};

// A thread's positions and its steps: the forward, mode 0, and the
// backward's recompute of a chunk share step() so that their arithmetic
// is one.
template <int PPT>
struct TRow {
  const TArgs& a;
  const Cta& k;
  TLay y;
  int b, l0, l1, lastpos;
  int s[PPT];  // the thread's kmer states (of its run g0)
  int g0 = 0;  // the run's offset: g PPT blockDim for run g

  __device__ int pos(int q) const { return l0 + g0 + k.tid + q * k.nt; }

  // The thread's run g of PPT positions: its offset and kmer states.
  __device__ void group(int g) {
    g0 = g * PPT * k.nt;
    const int* sq = a.seq + (size_t)b * a.L;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int l = pos(q);
      s[q] = l < l1 ? __ldg(sq + l) : -1;
    }
  }

  // Step t's inputs (lp row t - 1; with_m, m_{t-1}), for t <= last.
  __device__ void load(int t, int last, bool with_m, TFin<PPT>& in) const {
    if (t > last) return;
    const float* lpt = a.lp + ((size_t)(t - 1) * a.B + b) * a.S;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int l = pos(q);
      if (l >= l1) break;
      in.e[q] = s[q] >= 0 ? __ldg(lpt + s[q]) : NEG;
    }
    in.stay = __ldg(lpt + a.S - 1);
    if (with_m) in.mp = __ldg(a.m + (size_t)b * (a.T + 1) + t - 1);
  }

  // Row t from row t - 1 (offset mp) at the run's positions: the CTA's
  // scores to its rows, the halo pushed right, the last position's score
  // pushed to CTA 0, and (ends: once a step) START and END in CTA 0's
  // thread 0 (pstart, pend: raw scores). vals: the thread's new scores
  // (for the stores after the barrier's arrive).
  __device__ float step(int t, float mp, const TFin<PPT>& in, float& pstart,
                        float& pend, float* s_last, float (&vals)[PPT],
                        float& vstart, float& vend, bool ends) const {
    const int cur = t & 1, prv = cur ^ 1;
    const int P = a.per;
    const float* prev = y.rowbuf + prv * (P + 2);
    float* nxt = y.rowbuf + cur * (P + 2);
    const float stay_lp = in.stay;
    const float start = __fsub_rn(pstart, mp);
    float lmax = NEG;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int l = pos(q);
      vals[q] = NEG;
      if (l >= l1) break;
      const int i = l - l0;
      const float ev = in.e[q];
      const float p0 = __fsub_rn(prev[i + 2], mp);
      const float p1 = l >= 1 ? __fsub_rn(prev[i + 1], mp) : NEG;
      const float p2 = l >= 2 ? __fsub_rn(prev[i], mp) : NEG;
      const float stay_c = __fadd_rn(__fsub_rn(p0, a.stay), stay_lp);
      const float step_c = __fadd_rn(p1, ev);
      const float skip_c = __fadd_rn(__fsub_rn(p2, a.skip), ev);
      float c = lae(lae(stay_c, step_c), skip_c);
      if (l == 0) c = lae(c, __fadd_rn(start, ev));
      c = s[q] >= 0 ? c : NEG;
      nxt[i + 2] = c;
      vals[q] = c;
      lmax = fmaxf(lmax, c);
      if (k.c + 1 < k.ncta && l >= l1 - 2)  // the right CTA's left halo
        k.remote(nxt, k.c + 1)[l - l1 + 2] = c;
      if (l == lastpos) k.remote_static(s_last, 0)[cur] = c;
    }
    if (ends && k.c == 0 && k.tid == 0) {
      const float ls = lae(-a.local, stay_lp);
      const float ex = __fsub_rn(__fsub_rn(s_last[prv], mp), a.local);
      vstart = __fadd_rn(start, ls);
      vend = lae(__fadd_rn(__fsub_rn(pend, mp), ls), ex);
      pstart = vstart;
      pend = vend;
      lmax = fmaxf(lmax, fmaxf(vstart, vend));
    }
    return lmax;
  }

  // The run's scores of a row to dst (a row of R floats), START and END
  // (ends) by CTA 0's thread 0.
  __device__ void store(float* dst, const float (&vals)[PPT], float vstart,
                        float vend, bool ends) const {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int l = pos(q);
      if (l >= l1) break;
      dst[l] = vals[q];
    }
    if (ends && k.c == 0 && k.tid == 0) {
      dst[a.L] = vstart;
      dst[a.L + 1] = vend;
    }
  }

  // Backward step t's inputs (TBin: the stored row t - 1 from src, whose
  // row lo is src's first), for t >= first. The rows are plain loads: the
  // recomputed ones are written in this launch.
  __device__ void load_bwd(int t, int first, const float* src, int lo,
                           TBin<PPT>& in) const {
    if (t < first) return;
    const float* row = src + (size_t)(t - 1 - lo) * (a.L + 2);
    const float* lpn = a.lp + ((size_t)(t - 2) * a.B + b) * a.S;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int l = pos(q);
      if (l >= l1) break;
      in.a0[q] = row[l];
      in.a1[q] = l >= 1 ? row[l - 1] : NEG;
      in.a2[q] = l >= 2 ? row[l - 2] : NEG;
      in.e[q] = (t >= 2 && s[q] >= 0) ? __ldg(lpn + s[q]) : NEG;
    }
    const float* mrow = a.m + (size_t)b * (a.T + 1);
    in.stay = __ldg(a.lp + ((size_t)(t - 1) * a.B + b) * a.S + a.S - 1);
    in.mt = __ldg(mrow + t);
    in.mp = __ldg(mrow + t - 1);
    if (k.c == 0 && k.tid == 0) {
      in.start = row[a.L];
      in.end = row[a.L + 1];
      in.last = row[lastpos];
    }
  }
};

__device__ __forceinline__ float* row_at(float* base, int b, int nrow, int i,
                                         int R) {
  return base + ((size_t)b * nrow + i) * R;
}

template <int PPT, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS)
lattice_fwdbwd_kernel(int mode, const __grid_constant__ TArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_wmax[2][MAXW];   // the warps' maxima of a step
  __shared__ float s_wsum[2][32][2];  // the warps' (total, stay) of a step
  __shared__ float s_last[2];         // CTA 0: the last position's score
  __shared__ float s_bend[2];         // END's beta_tilde, for lastpos
  __shared__ int s_count;
  const int b = blockIdx.y;
  const Cta k = make_cta(smem, a.scratch, a.nfloats, b);
  const int P = a.per, L = a.L, R = L + 2;
  const int l0 = k.c * P, l1 = min(l0 + P, L);
  const int* sq = a.seq + (size_t)b * L;
  const int lastpos = max(count_valid(sq, L, &s_count) - 1, 0);
  const int NW = k.ncta * k.nwarps;
  const int gwarp = k.c * k.nwarps + k.warp;
  const int NG = MULTI ? a.ngroup : 1;  // the thread's runs of positions
  const TLay y = t_lay(k.big, P);
  TRow<PPT> fw{a, k, y, b, l0, l1, lastpos};
  fw.group(0);
  float* mrow = a.m + (size_t)b * (a.T + 1);
  for (int i = k.tid; i < 2 * (P + 2); i += k.nt) y.rowbuf[i] = NEG;

  if (mode == 0) {
    // ---------------------------------------------------------- forward
    for (int i = k.tid; i < NW; i += k.nt) s_wmax[0][i] = i == 0 ? 0.0f : NEG;
    if (k.tid < 2) s_last[k.tid] = NEG;
    float pstart = 0.0f, pend = NEG;  // CTA 0's thread 0
    double asum = 0.0;
    Keep keep = make_keep(a.ckpt, a.rows, b, a.C, a.n, a.T, R);
    {
      float v0[PPT];
#pragma unroll
      for (int q = 0; q < PPT; ++q) v0[q] = NEG;
      for (int g = 0; g < NG; ++g) {
        if (MULTI) fw.group(g);
        fw.store(row_at(a.ckpt, b, a.n + 1, 0, R), v0, 0.0f, NEG, g == 0);
        if (a.n == 1) fw.store(row_at(a.rows, b, a.C, 0, R), v0, 0.0f, NEG, g == 0);
      }
    }
    TFin<PPT> in, in_next;
    if (!MULTI) fw.load(1, a.T, false, in);
    k.sync();
    for (int t = 1; t <= a.T; ++t) {
      if (!MULTI) fw.load(t + 1, a.T, false, in_next);
      const float mp = slots_max(s_wmax[(t - 1) & 1], NW, k.lane);
      if (k.c == 0 && k.tid == 0) {
        mrow[t - 1] = mp;
        asum += mp;
      }
      float vals[PPT], vs = 0.0f, ve = 0.0f, lmax = NEG;
      for (int g = 0; g < NG; ++g) {
        if (MULTI) {
          fw.group(g);
          fw.load(t, a.T, false, in);
        }
        lmax = fmaxf(lmax, fw.step(t, mp, in, pstart, pend, s_last, vals, vs,
                                   ve, g == 0));
        if (MULTI)
          keep.each(t, [&](float* dst) { fw.store(dst, vals, vs, ve, g == 0); });
      }
      const float wm = warp_max(lmax);
      if (k.lane < k.ncta)
        k.remote_static(&s_wmax[0][0], k.lane)[(t & 1) * MAXW + gwarp] = wm;
      if (k.ncta > 1) cluster_arrive();
      else __syncthreads();
      if (MULTI) keep.advance(t);
      else keep.at(t, [&](float* dst) { fw.store(dst, vals, vs, ve, true); });
      if (k.ncta > 1) cluster_wait();
      if (!MULTI) in = in_next;
    }
    const float mT = slots_max(s_wmax[a.T & 1], NW, k.lane);
    if (k.c == 0 && k.tid == 0) {
      mrow[a.T] = mT;
      asum += mT;
      const float fin = lae(__fsub_rn(s_last[a.T & 1], mT), __fsub_rn(pend, mT));
      a.logp[b] = (float)(asum + (double)fin);
    }
    return;
  }

  // ------------------------------------------------------------ backward
  const int S = a.S;
  const float mT = mrow[a.T];
  const float* rowT = row_at(a.ckpt, b, a.n + 1, a.n, R);
  const float fin = lae(__fsub_rn(__ldg(rowT + lastpos), mT),
                        __fsub_rn(__ldg(rowT + L + 1), mT));
  const int G = k.ncta * k.nt, g = k.c * k.nt + k.tid;
  if (fin < 0.5f * NEG) {  // no path: a zero gradient
    for (size_t i = g; i < (size_t)a.T * S; i += G)
      a.grad[((i / S) * a.B + b) * S + i % S] = 0.0f;
    return;
  }
  const float scale = a.gP[b];
  // The walk at t = T: own beta_tilde and u, and the right halo's u.
  for (int i = k.tid; i < 2 * (P + 2); i += k.nt) y.ub[i] = NEG;
  if (a.T > 0) {
    const float* lpT = a.lp + ((size_t)(a.T - 1) * a.B + b) * S;
    float* u = y.ub + (a.T & 1) * (P + 2);
    for (int gr = 0; gr < NG; ++gr) {
      if (MULTI) fw.group(gr);
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int l = fw.pos(q);
        if (l >= l1) break;
        const float v = (l == lastpos && fw.s[q] >= 0) ? -fin : NEG;
        y.bt[l - l0] = v;
        u[l - l0] = __fadd_rn(fw.s[q] >= 0 ? __ldg(lpT + fw.s[q]) : NEG, v);
      }
    }
    if (k.tid < 2 && l1 + k.tid < L) {
      const int l = l1 + k.tid;
      const int sl = __ldg(sq + l);
      const float v = (l == lastpos && sl >= 0) ? -fin : NEG;
      u[P + k.tid] = __fadd_rn(sl >= 0 ? __ldg(lpT + sl) : NEG, v);
    }
  }
  if (k.tid == 0) s_bend[a.T & 1] = -fin;
  float bstart = NEG, bend = -fin;  // CTA 0's thread 0
  k.sync();  // every CTA started, before any push

  for (int c = a.n - 1; c >= 0; --c) {
    const int lo = c * a.C, hi = min(lo + a.C, a.T);
    const float* src;
    if (c == a.n - 1) {
      src = row_at(a.rows, b, a.C, 0, R);
    } else {
      // Recompute rows lo + 1 .. hi - 1 from the checkpoint into work.
      const float* ck = row_at(a.ckpt, b, a.n + 1, c, R);
      float* wk = row_at(a.work, b, a.C, 0, R);
      float* rb = y.rowbuf + (lo & 1) * (P + 2);
      for (int i = k.tid; i < P + 2; i += k.nt) {
        const int l = l0 - 2 + i;
        rb[i] = (l >= 0 && l < L) ? __ldg(ck + l) : NEG;
      }
      for (int l = l0 + k.tid; l < l1; l += k.nt) wk[l] = __ldg(ck + l);
      float pstart = 0.0f, pend = 0.0f;
      if (k.c == 0 && k.tid == 0) {
        pstart = __ldg(ck + L);
        pend = __ldg(ck + L + 1);
        wk[L] = pstart;
        wk[L + 1] = pend;
        s_last[lo & 1] = __ldg(ck + lastpos);
      }
      TFin<PPT> in, in_next;
      if (MULTI) fw.group(0);
      else fw.load(lo + 1, hi - 1, true, in);
      k.sync();
      for (int t = lo + 1; t < hi; ++t) {
        if (!MULTI) fw.load(t + 1, hi - 1, true, in_next);
        float vals[PPT], vs = 0.0f, ve = 0.0f;
        for (int gr = 0; gr < NG; ++gr) {
          if (MULTI) {
            fw.group(gr);
            fw.load(t, hi - 1, true, in);
          }
          fw.step(t, in.mp, in, pstart, pend, s_last, vals, vs, ve, gr == 0);
          if (MULTI) fw.store(wk + (size_t)(t - lo) * R, vals, vs, ve, gr == 0);
        }
        if (k.ncta > 1) cluster_arrive();
        else __syncthreads();
        if (!MULTI) fw.store(wk + (size_t)(t - lo) * R, vals, vs, ve, true);
        if (k.ncta > 1) cluster_wait();
        if (!MULTI) in = in_next;
      }
      k.sync();
      src = wk;
    }
    // The walk back over steps hi .. lo + 1.
    TBin<PPT> in, in_next;
    if (MULTI) fw.group(0);
    else fw.load_bwd(hi, lo + 1, src, lo, in);
    float* postc = a.post + (size_t)b * a.C * L;
    float* partc = a.part + (size_t)b * a.C * k.ncta * 2;
    // The CTA's part of step tp (its total and stays): warp 0 sums the
    // warps'.
    auto cta_part = [&](int tp) {
      const float* w = &s_wsum[tp & 1][0][0];
      const float tt = warp_sum(k.lane < k.nwarps ? w[2 * k.lane] : 0.0f);
      const float st = warp_sum(k.lane < k.nwarps ? w[2 * k.lane + 1] : 0.0f);
      if (k.lane == 0) {
        float* pp = partc + ((size_t)(tp - 1 - lo) * k.ncta + k.c) * 2;
        pp[0] = tt;
        pp[1] = st;
      }
    };
    for (int t = hi; t > lo; --t) {
      if (MULTI) {
        if (NG > 1) fw.group(0);
        fw.load_bwd(t, lo + 1, src, lo, in);
      } else {
        fw.load_bwd(t - 1, lo + 1, src, lo, in_next);
      }
      const int cur = t & 1, nx = cur ^ 1;
      const float stay_lp = in.stay, mt = in.mt, mp = in.mp;
      const float* u = y.ub + cur * (P + 2);
      float* un = y.ub + nx * (P + 2);
      const float bend_t = s_bend[cur];
      float stay_sum = 0.0f, tot = 0.0f;
      float* prow = postc + (size_t)(t - 1 - lo) * L;
      for (int gr = 0; gr < NG; ++gr) {
        if (MULTI && gr > 0) {
          fw.group(gr);
          fw.load_bwd(t, lo + 1, src, lo, in);
        }
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const int l = fw.pos(q);
          if (l >= l1) break;
          const int i = l - l0, sl = fw.s[q];
          const float btl = y.bt[i];
          const float ul = u[i];
          const float a0 = __fsub_rn(in.a0[q], mp);
          const float a1 = l >= 1 ? __fsub_rn(in.a1[q], mp) : NEG;
          const float a2 = l >= 2 ? __fsub_rn(in.a2[q], mp) : NEG;
          float inc = lae(a1, __fsub_rn(a2, a.skip));
          if (l == 0) inc = lae(inc, __fsub_rn(in.start, mp));
          float pe = 0.0f;
          if (sl >= 0) {
            pe = expf(__fsub_rn(__fadd_rn(inc, ul), mt));
            tot += pe;
          }
          prow[l] = pe;
          const float ps = expf(__fsub_rn(
              __fadd_rn(__fadd_rn(__fsub_rn(a0, a.stay), stay_lp), btl), mt));
          stay_sum += ps;
          tot += ps;
          const float u1 = l + 1 < L ? u[i + 1] : NEG;
          const float u2 = l + 2 < L ? u[i + 2] : NEG;
          float nb = lae(lae(__fadd_rn(__fsub_rn(btl, a.stay), stay_lp), u1),
                         __fsub_rn(u2, a.skip));
          if (l == lastpos) nb = lae(nb, __fadd_rn(-a.local, bend_t));
          nb = sl >= 0 ? __fsub_rn(nb, mt) : NEG;
          y.bt[i] = nb;
          const float uv = __fadd_rn(in.e[q], nb);
          un[i] = uv;
          if (k.c > 0 && i < 2) k.remote(un, k.c - 1)[P + i] = uv;
        }
      }
      if (k.c == 0 && k.tid == 0) {
        const float ls = lae(-a.local, stay_lp);
        const float sp = __fsub_rn(in.start, mp), ep = __fsub_rn(in.end, mp);
        const float ends = __fadd_rn(
            expf(__fsub_rn(__fadd_rn(__fadd_rn(sp, ls), bstart), mt)),
            expf(__fsub_rn(__fadd_rn(__fadd_rn(ep, ls), bend), mt)));
        stay_sum += __fmul_rn(ends, expf(__fsub_rn(stay_lp, ls)));
        const float ex = expf(__fsub_rn(
            __fadd_rn(__fsub_rn(__fsub_rn(in.last, mp), a.local), bend), mt));
        tot += __fadd_rn(ends, ex);
        bstart = __fsub_rn(lae(__fadd_rn(ls, bstart), u[0]), mt);
        bend = __fsub_rn(__fadd_rn(ls, bend), mt);
        k.remote_static(s_bend, lastpos / P)[nx] = bend;
      }
      stay_sum = warp_sum(stay_sum);
      tot = warp_sum(tot);
      if (k.lane == 0) {
        s_wsum[cur][k.warp][0] = tot;
        s_wsum[cur][k.warp][1] = stay_sum;
      }
      if (k.warp == 0 && t < hi) cta_part(t + 1);
      k.sync();
      if (!MULTI) in = in_next;
    }
    if (k.warp == 0) cta_part(lo + 1);
    k.sync();
    // The chunk's gradient rows: each step's scale gP / total and stay sum
    // into its CTA 0 part, then each state's positions in order.
    const int nstep = hi - lo;
    for (int tt = g; tt < nstep; tt += G) {
      float* pp = partc + (size_t)tt * k.ncta * 2;
      float tot = 0.0f, st = 0.0f;
      for (int r = 0; r < k.ncta; ++r) {
        tot += pp[2 * r];
        st += pp[2 * r + 1];
      }
      pp[0] = __fdiv_rn(scale, tot);
      pp[1] = st;
    }
    k.sync();
    const int* start = a.start + (size_t)b * (S + 1);
    const int* pos = a.pos + (size_t)b * L;
    const float* __restrict__ pst = postc;
    const float* __restrict__ prt = partc;
    float* __restrict__ gout = a.grad;
    const int nblk = (nstep + TBLK - 1) / TBLK;
    for (int task = g; task < S * nblk; task += G) {
      const int sidx = task % S, blk = task / S;
      const int j0 = __ldg(start + sidx), j1 = __ldg(start + sidx + 1);
      const int t0 = blk * TBLK, t1 = min(t0 + TBLK, nstep);
      constexpr int NPJ = 8;  // a state's first positions, in registers
      int pj[NPJ];
#pragma unroll
      for (int q = 0; q < NPJ; ++q) pj[q] = j0 + q < j1 ? __ldg(pos + j0 + q) : 0;
      for (int tt = t0; tt < t1; ++tt) {
        const float* prow = pst + (size_t)tt * L;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < NPJ; ++q)
          if (j0 + q < j1) v += prow[pj[q]];
        for (int j = j0 + NPJ; j < j1; ++j) v += prow[__ldg(pos + j)];
        const float* pp = prt + (size_t)tt * k.ncta * 2;
        if (sidx == S - 1) v += pp[1];
        gout[((size_t)(lo + tt) * a.B + b) * S + sidx] = __fmul_rn(v, pp[0]);
      }
    }
    k.sync();
  }
}

// -------------------------------------------------------------------- CRF

// Position j's transitions (j bases emitted): ee, es, se, and whether j is
// valid; b(j) is base j - 1 (0 where padded or j = 0).
struct CrfPos {
  int ee, es, se;
  bool valid;
};

__device__ __forceinline__ CrfPos crf_pos(const int* __restrict__ bs, int j) {
  const int bj = j >= 1 ? __ldg(bs + j - 1) : 0;
  const int bjm1 = j >= 2 ? __ldg(bs + j - 2) : 0;
  const int sj = bj >= 0 ? bj : 0, sjm1 = bjm1 >= 0 ? bjm1 : 0;
  return CrfPos{sj * 5 + sjm1, sj * 5 + 4, 20 + sj, j == 0 || bj >= 0};
}

struct CArgs {
  const float* trans;  // [T, B, 25]
  const int* bases;    // [B, L]
  float* ckpt;         // [B, n+1, R]
  float* rows;         // [B, C, R]
  float* m;            // [B, T+1]
  float* z;            // [B, T+1, 8]
  float* zm;           // [B, T+1]
  float* out;          // [2, B]
  const float* gP;     // [B]
  const float* gZ;     // [B]
  float* grads;        // [2, T, B, 25]
  float* work;         // [B, C, R] or null
  float* part;         // [B, C, ncta, NPART]
  const int* start;    // [B, ncta, 25]
  const int* idx;      // [B, ncta, 3 per]
  float* scratch;
  int T, B, L, C, n, per, nfloats, ngroup;
  float local;
};

// A CTA's arrays (per = P positions j): the forward's rows [2][2(P+1)]
// (emit at j - j0 + 1, '-' P + 1 further), the backward's own beta_tilde
// [2P] (emit, '-'), u [2][2(P+1)] (ue at j - j0, then the right halo; us
// P + 1 further), the posteriors [2][3P] (ee, es, se) and the CTA's class
// lists: 32 starts and 3P entries (ints).
__host__ __device__ inline size_t c_floats(int P) {
  return 4 * ((size_t)P + 1) + 2 * (size_t)P + 4 * ((size_t)P + 1) +
         6 * (size_t)P + 32 + 3 * (size_t)P;
}

struct CLay {
  float *rowbuf, *bt, *ub, *pe3;
  int *lstart, *lidx;
};

__device__ CLay c_lay(float* base, int P) {
  CLay y;
  const int W = 2 * (P + 1);
  y.rowbuf = base;
  y.bt = y.rowbuf + 2 * W;
  y.ub = y.bt + 2 * P;
  y.pe3 = y.ub + 2 * W;
  y.lstart = reinterpret_cast<int*>(y.pe3 + 2 * 3 * P);
  y.lidx = y.lstart + 32;
  return y;
}

// A CRF forward step's inputs, loaded into registers a step ahead: each
// position's ee, es and se transition, ss, and (the recompute) m_{t-1}.
template <int PPT>
struct CFin {
  float ee[PPT], es[PPT], se[PPT];
  float ss, mp;
};

// A CRF backward step t's: the stored row t - 1 at the thread's positions
// and the one left of each (emit and '-'), transition row t - 1's ee, es,
// se and ss and row t - 2's ee and es (for u), row t - 1's START, m_t and
// m_{t-1}, and for CTA 0's thread 0 row t - 1's END and the last
// position's two scores.
template <int PPT>
struct CBin {
  float ae0[PPT], as0[PPT], ae1[PPT], as1[PPT];
  float ee[PPT], es[PPT], se[PPT], nee[PPT], nes[PPT];
  float ss, start, mt, mp, end, last_e, last_s;
};

// A thread's positions and its steps, as TRow's.
template <int PPT>
struct CRow {
  const CArgs& a;
  const Cta& k;
  CLay y;
  int b, j0, j1, J, seqlen;
  CrfPos p[PPT];  // the thread's positions' transitions (of its run g0)
  int g0 = 0;

  __device__ int pos(int q) const { return j0 + g0 + k.tid + q * k.nt; }

  // The thread's run g of PPT positions: its offset and transitions.
  __device__ void group(int g) {
    g0 = g * PPT * k.nt;
    const int* bs = a.bases + (size_t)b * a.L;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int j = pos(q);
      p[q] = j < j1 ? crf_pos(bs, j) : CrfPos{0, 4, 20, false};
    }
  }

  // Step t's inputs (transition row t - 1; with_m, m_{t-1}), t <= last.
  __device__ void load(int t, int last, bool with_m, CFin<PPT>& in) const {
    if (t > last) return;
    const float* tr = a.trans + ((size_t)(t - 1) * a.B + b) * NCLASS;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int j = pos(q);
      if (j >= j1) break;
      in.ee[q] = __ldg(tr + p[q].ee);
      in.es[q] = __ldg(tr + p[q].es);
      in.se[q] = __ldg(tr + p[q].se);
    }
    in.ss = __ldg(tr + 24);
    if (with_m) in.mp = __ldg(a.m + (size_t)b * (a.T + 1) + t - 1);
  }

  // Row t from row t - 1 (offset mp), as TRow::step; START's raw score
  // in s_start (CTA 0's thread 0 writes it, thread 1's position j = 1
  // reads it), END's in CTA 0's thread 0's pend.
  __device__ float step(int t, float mp, const CFin<PPT>& in, float* s_start,
                        float& pend, float (*s_last)[2], float (&ve)[PPT],
                        float (&vs)[PPT], float& vstart, float& vend,
                        bool ends) const {
    const int cur = t & 1, prv = cur ^ 1;
    const int P = a.per, W = 2 * (P + 1);
    const float* pe = y.rowbuf + prv * W;  // emit; '-' at P + 1
    float* ne_ = y.rowbuf + cur * W;
    const float ss = in.ss;
    const float start = __fsub_rn(s_start[prv], mp);
    float lmax = NEG;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int j = pos(q);
      ve[q] = vs[q] = NEG;
      if (j >= j1) break;
      const int i = j - j0 + 1;
      const CrfPos& ps = p[q];
      const float ee = in.ee[q], es = in.es[q], se = in.se[q];
      const float ae1 = j >= 1 ? __fsub_rn(pe[i - 1], mp) : NEG;
      const float as1 = j >= 1 ? __fsub_rn(pe[P + 1 + i - 1], mp) : NEG;
      float nev = lae(__fadd_rn(ae1, ee), __fadd_rn(as1, es));
      if (j == 1) nev = lae(nev, __fadd_rn(start, es));
      const float nsv = lae(__fadd_rn(__fsub_rn(pe[i], mp), se),
                            __fadd_rn(__fsub_rn(pe[P + 1 + i], mp), ss));
      const float e = ps.valid ? nev : NEG, s = ps.valid ? nsv : NEG;
      ne_[i] = e;
      ne_[P + 1 + i] = s;
      ve[q] = e;
      vs[q] = s;
      lmax = fmaxf(lmax, fmaxf(e, s));
      if (k.c + 1 < k.ncta && j == j1 - 1) {  // the right CTA's left halo
        float* r = k.remote(ne_, k.c + 1);
        r[0] = e;
        r[P + 1] = s;
      }
      if (j == seqlen) {
        float* sl = k.remote_static(&s_last[0][0], 0);
        sl[2 * cur] = e;
        sl[2 * cur + 1] = s;
      }
    }
    if (ends && k.c == 0 && k.tid == 0) {
      const float ls = lae(-a.local, ss);
      const float ex = __fsub_rn(lae(__fsub_rn(s_last[prv][0], mp),
                                     __fsub_rn(s_last[prv][1], mp)),
                                 a.local);
      vstart = __fadd_rn(start, ls);
      vend = lae(__fadd_rn(__fsub_rn(pend, mp), ls), ex);
      s_start[cur] = vstart;
      pend = vend;
      lmax = fmaxf(lmax, fmaxf(vstart, vend));
    }
    return lmax;
  }

  __device__ void store(float* dst, const float (&ve)[PPT],
                        const float (&vs)[PPT], float vstart, float vend,
                        bool ends) const {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int j = pos(q);
      if (j >= j1) break;
      dst[j] = ve[q];
      dst[J + j] = vs[q];
    }
    if (ends && k.c == 0 && k.tid == 0) {
      dst[2 * J] = vstart;
      dst[2 * J + 1] = vend;
    }
  }

  // Backward step t's inputs (CBin: the stored row t - 1 from src, whose
  // row lo is src's first), for t >= first; plain loads of the rows, as
  // TRow::load_bwd's.
  __device__ void load_bwd(int t, int first, const float* src, int lo,
                           CBin<PPT>& in) const {
    if (t < first) return;
    const float* row = src + (size_t)(t - 1 - lo) * (2 * J + 2);
    const float* tr = a.trans + ((size_t)(t - 1) * a.B + b) * NCLASS;
    const float* trn = t >= 2 ? tr - (size_t)a.B * NCLASS : tr;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int j = pos(q);
      if (j >= j1) break;
      in.ae0[q] = row[j];
      in.as0[q] = row[J + j];
      in.ae1[q] = j >= 1 ? row[j - 1] : NEG;
      in.as1[q] = j >= 1 ? row[J + j - 1] : NEG;
      in.ee[q] = __ldg(tr + p[q].ee);
      in.es[q] = __ldg(tr + p[q].es);
      in.se[q] = __ldg(tr + p[q].se);
      in.nee[q] = __ldg(trn + p[q].ee);
      in.nes[q] = __ldg(trn + p[q].es);
    }
    const float* mrow = a.m + (size_t)b * (a.T + 1);
    in.ss = __ldg(tr + 24);
    in.start = row[2 * J];
    in.mt = __ldg(mrow + t);
    in.mp = __ldg(mrow + t - 1);
    if (k.c == 0 && k.tid == 0) {
      in.end = row[2 * J + 1];
      in.last_e = row[seqlen];
      in.last_s = row[J + seqlen];
    }
  }
};

// The seven-state local partition of one row, by warp 0: lanes 0-4 the
// states A, C, G, T, '-', lane 5 START, lane 6 END; rows [B, T+1, 8].
__device__ __forceinline__ float lse5(float x0, float x1, float x2, float x3,
                                      float x4) {
  const float m = fmaxf(fmaxf(fmaxf(x0, x1), fmaxf(x2, x3)), x4);
  const float s = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(expf(__fsub_rn(x0, m)),
                                    expf(__fsub_rn(x1, m))),
                          expf(__fsub_rn(x2, m))),
                expf(__fsub_rn(x3, m))),
      expf(__fsub_rn(x4, m)));
  return __fadd_rn(logf(s), m);
}

__device__ void partition_fwd(const float* __restrict__ trans, float* z,
                              float* zm, float* logz, int b, int T, int B,
                              float local_pen) {
  const int lane = threadIdx.x;
  float* zrow = z + (size_t)b * (T + 1) * 8;
  float* mrow = zm + (size_t)b * (T + 1);
  float v = lane == 5 ? 0.0f : NEG;  // this lane's raw score
  if (lane < 8) zrow[lane] = v;
  float mp = 0.0f;
  double asum = 0.0;
  if (lane == 0) mrow[0] = 0.0f;
  for (int t = 1; t <= T; ++t) {
    const float* tr = trans + ((size_t)(t - 1) * B + b) * NCLASS;
    const float h = lane < 7 ? __fsub_rn(v, mp) : NEG;
    const float z0 = __shfl_sync(FULL, h, 0), z1 = __shfl_sync(FULL, h, 1);
    const float z2 = __shfl_sync(FULL, h, 2), z3 = __shfl_sync(FULL, h, 3);
    const float z4 = __shfl_sync(FULL, h, 4), zs = __shfl_sync(FULL, h, 5);
    const float ze = __shfl_sync(FULL, h, 6);
    const float ss = __ldg(tr + 24);
    const float ls = lae(-local_pen, ss);
    float nv = NEG;
    if (lane < 5) {
      const float* row = tr + lane * 5;
      nv = lse5(__fadd_rn(__ldg(row), z0), __fadd_rn(__ldg(row + 1), z1),
                __fadd_rn(__ldg(row + 2), z2), __fadd_rn(__ldg(row + 3), z3),
                __fadd_rn(__ldg(row + 4), z4));
      if (lane < 4) nv = lae(nv, __fadd_rn(zs, __ldg(row + 4)));
    } else if (lane == 5) {
      nv = __fadd_rn(zs, ls);
    } else if (lane == 6) {
      nv = lae(__fadd_rn(ze, ls),
               __fsub_rn(lse5(z0, z1, z2, z3, z4), local_pen));
    }
    v = nv;
    if (lane < 8) zrow[(size_t)t * 8 + lane] = v;
    mp = warp_max(v);
    if (lane == 0) mrow[t] = mp;
    asum += mp;
  }
  const float h = lane < 7 ? __fsub_rn(v, mp) : NEG;
  const float f5 = lse5(__shfl_sync(FULL, h, 0), __shfl_sync(FULL, h, 1),
                        __shfl_sync(FULL, h, 2), __shfl_sync(FULL, h, 3),
                        __shfl_sync(FULL, h, 4));
  const float fin = lae(f5, __shfl_sync(FULL, h, 6));
  if (lane == 0) logz[b] = (float)(asum + (double)fin);
}

__device__ void partition_bwd(const float* __restrict__ trans,
                              const float* __restrict__ z,
                              const float* __restrict__ zm,
                              const float* __restrict__ gZ, float* grad, int b,
                              int T, int B, float local_pen) {
  const int lane = threadIdx.x;
  const float* zrow = z + (size_t)b * (T + 1) * 8;
  const float* mrow = zm + (size_t)b * (T + 1);
  const float scale = gZ[b];
  float fin;
  {
    const float mT = mrow[T];
    const float h = lane < 7 ? __fsub_rn(zrow[(size_t)T * 8 + lane], mT) : NEG;
    fin = lae(lse5(__shfl_sync(FULL, h, 0), __shfl_sync(FULL, h, 1),
                   __shfl_sync(FULL, h, 2), __shfl_sync(FULL, h, 3),
                   __shfl_sync(FULL, h, 4)),
              __shfl_sync(FULL, h, 6));
  }
  float beta = lane < 5 || lane == 6 ? -fin : NEG;  // this lane's state's
  for (int t = T; t >= 1; --t) {
    const float* tr = trans + ((size_t)(t - 1) * B + b) * NCLASS;
    const float mt = mrow[t], mp = mrow[t - 1];
    const float a = lane < 7 ? __fsub_rn(zrow[(size_t)(t - 1) * 8 + lane], mp)
                             : NEG;
    float zf[5], bto[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      zf[k] = __shfl_sync(FULL, a, k);
      bto[k] = __shfl_sync(FULL, beta, k);
    }
    const float zs = __shfl_sync(FULL, a, 5), ze = __shfl_sync(FULL, a, 6);
    const float bS = __shfl_sync(FULL, beta, 5), bE = __shfl_sync(FULL, beta, 6);
    const float ss = __ldg(tr + 24);
    const float ls = lae(-local_pen, ss);
    float ends = 0.0f;
    if (lane == 5) ends = expf(__fsub_rn(__fadd_rn(__fadd_rn(zs, ls), bS), mt));
    if (lane == 6) ends = expf(__fsub_rn(__fadd_rn(__fadd_rn(ze, ls), bE), mt));
    ends = __fadd_rn(__shfl_sync(FULL, ends, 5), __shfl_sync(FULL, ends, 6));
    if (lane < 5) {  // lane = to: the edges into it
      const float* row = tr + lane * 5;
      float* out = grad + ((size_t)(t - 1) * B + b) * NCLASS + lane * 5;
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        const float w = __ldg(row + f);
        float p = expf(__fsub_rn(__fadd_rn(__fadd_rn(zf[f], w), bto[lane]), mt));
        if (f == 4 && lane < 4)
          p += expf(__fsub_rn(__fadd_rn(__fadd_rn(zs, w), bto[lane]), mt));
        if (f == 4 && lane == 4) p += __fmul_rn(ends, expf(__fsub_rn(ss, ls)));
        out[f] = __fmul_rn(p, scale);
      }
    }
    float nb = NEG;
    if (lane < 5) {  // lane = from
      nb = lse5(__fadd_rn(__ldg(tr + lane), bto[0]),
                __fadd_rn(__ldg(tr + 5 + lane), bto[1]),
                __fadd_rn(__ldg(tr + 10 + lane), bto[2]),
                __fadd_rn(__ldg(tr + 15 + lane), bto[3]),
                __fadd_rn(__ldg(tr + 20 + lane), bto[4]));
      nb = __fsub_rn(lae(nb, __fadd_rn(-local_pen, bE)), mt);
    } else if (lane == 5) {
      const float m4 = fmaxf(fmaxf(__fadd_rn(__ldg(tr + 4), bto[0]),
                                   __fadd_rn(__ldg(tr + 9), bto[1])),
                             fmaxf(__fadd_rn(__ldg(tr + 14), bto[2]),
                                   __fadd_rn(__ldg(tr + 19), bto[3])));
      const float s4 = __fadd_rn(
          __fadd_rn(expf(__fsub_rn(__fadd_rn(__ldg(tr + 4), bto[0]), m4)),
                    expf(__fsub_rn(__fadd_rn(__ldg(tr + 9), bto[1]), m4))),
          __fadd_rn(expf(__fsub_rn(__fadd_rn(__ldg(tr + 14), bto[2]), m4)),
                    expf(__fsub_rn(__fadd_rn(__ldg(tr + 19), bto[3]), m4))));
      nb = __fsub_rn(lae(__fadd_rn(ls, bS), __fadd_rn(logf(s4), m4)), mt);
    } else if (lane == 6) {
      nb = __fsub_rn(__fadd_rn(ls, bE), mt);
    }
    beta = nb;
  }
}

template <int PPT, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS)
crf_lattice_fwdbwd_kernel(int mode, const __grid_constant__ CArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_wmax[2][MAXW];
  __shared__ float s_wsum[2][32][2];
  __shared__ float s_last[2][2];  // CTA 0: the last position's emit, '-'
  __shared__ float s_start[2];    // CTA 0: START's raw score
  __shared__ float s_bend[2];
  __shared__ int s_count;
  const int b = blockIdx.y;
  if (blockIdx.z == 1) {  // the local partition: one warp of CTA 0
    if (blockIdx.x != 0 || threadIdx.x >= 32) return;
    if (mode == 0)
      partition_fwd(a.trans, a.z, a.zm, a.out + a.B, b, a.T, a.B, a.local);
    else
      partition_bwd(a.trans, a.z, a.zm, a.gZ,
                    a.grads + (size_t)a.T * a.B * NCLASS, b, a.T, a.B,
                    a.local);
    return;
  }
  const Cta k = make_cta(smem, a.scratch, a.nfloats, b);
  const int P = a.per, L = a.L, J = L + 1, R = 2 * J + 2, W = 2 * (P + 1);
  const int j0 = k.c * P, j1 = min(j0 + P, J);
  const int* bs = a.bases + (size_t)b * L;
  const int seqlen = count_valid(bs, L, &s_count);
  const int NW = k.ncta * k.nwarps;
  const int gwarp = k.c * k.nwarps + k.warp;
  const int NG = MULTI ? a.ngroup : 1;  // the thread's runs of positions
  const CLay y = c_lay(k.big, P);
  CRow<PPT> fw{a, k, y, b, j0, j1, J, seqlen};
  fw.group(0);
  float* mrow = a.m + (size_t)b * (a.T + 1);
  for (int i = k.tid; i < 2 * W; i += k.nt) y.rowbuf[i] = NEG;

  if (mode == 0) {
    for (int i = k.tid; i < NW; i += k.nt) s_wmax[0][i] = i == 0 ? 0.0f : NEG;
    if (k.tid < 4) (&s_last[0][0])[k.tid] = NEG;
    if (k.tid == 0) s_start[0] = 0.0f;
    float pend = NEG;
    double asum = 0.0;
    Keep keep = make_keep(a.ckpt, a.rows, b, a.C, a.n, a.T, R);
    {
      float v0[PPT];
#pragma unroll
      for (int q = 0; q < PPT; ++q) v0[q] = NEG;
      for (int g = 0; g < NG; ++g) {
        if (MULTI) fw.group(g);
        fw.store(row_at(a.ckpt, b, a.n + 1, 0, R), v0, v0, 0.0f, NEG, g == 0);
        if (a.n == 1)
          fw.store(row_at(a.rows, b, a.C, 0, R), v0, v0, 0.0f, NEG, g == 0);
      }
    }
    CFin<PPT> in, in_next;
    if (!MULTI) fw.load(1, a.T, false, in);
    k.sync();
    for (int t = 1; t <= a.T; ++t) {
      if (!MULTI) fw.load(t + 1, a.T, false, in_next);
      const float mp = slots_max(s_wmax[(t - 1) & 1], NW, k.lane);
      if (k.c == 0 && k.tid == 0) {
        mrow[t - 1] = mp;
        asum += mp;
      }
      float ve[PPT], vs[PPT], v0 = 0.0f, v1 = 0.0f, lmax = NEG;
      for (int g = 0; g < NG; ++g) {
        if (MULTI) {
          fw.group(g);
          fw.load(t, a.T, false, in);
        }
        lmax = fmaxf(lmax, fw.step(t, mp, in, s_start, pend, s_last, ve, vs,
                                   v0, v1, g == 0));
        if (MULTI)
          keep.each(t, [&](float* dst) { fw.store(dst, ve, vs, v0, v1, g == 0); });
      }
      const float wm = warp_max(lmax);
      if (k.lane < k.ncta)
        k.remote_static(&s_wmax[0][0], k.lane)[(t & 1) * MAXW + gwarp] = wm;
      if (k.ncta > 1) cluster_arrive();
      else __syncthreads();
      if (MULTI) keep.advance(t);
      else keep.at(t, [&](float* dst) { fw.store(dst, ve, vs, v0, v1, true); });
      if (k.ncta > 1) cluster_wait();
      if (!MULTI) in = in_next;
    }
    const float mT = slots_max(s_wmax[a.T & 1], NW, k.lane);
    if (k.c == 0 && k.tid == 0) {
      mrow[a.T] = mT;
      asum += mT;
      const float fin = lae(lae(__fsub_rn(s_last[a.T & 1][0], mT),
                                __fsub_rn(s_last[a.T & 1][1], mT)),
                            __fsub_rn(pend, mT));
      a.out[b] = (float)(asum + (double)fin);
    }
    return;
  }

  // ------------------------------------------------------------ backward
  const float mT = mrow[a.T];
  const float* rowT = row_at(a.ckpt, b, a.n + 1, a.n, R);
  const float fin = lae(lae(__fsub_rn(__ldg(rowT + seqlen), mT),
                            __fsub_rn(__ldg(rowT + J + seqlen), mT)),
                        __fsub_rn(__ldg(rowT + 2 * J + 1), mT));
  const int G = k.ncta * k.nt, g = k.c * k.nt + k.tid;
  if (fin < 0.5f * NEG) {
    for (size_t i = g; i < (size_t)a.T * NCLASS; i += G)
      a.grads[((i / NCLASS) * a.B + b) * NCLASS + i % NCLASS] = 0.0f;
    return;
  }
  const float scale = a.gP[b];
  {  // the CTA's class lists
    const int* ls = a.start + ((size_t)b * k.ncta + k.c) * NCLASS;
    const int* li = a.idx + ((size_t)b * k.ncta + k.c) * 3 * P;
    for (int i = k.tid; i < NCLASS; i += k.nt) y.lstart[i] = __ldg(ls + i);
    for (int i = k.tid; i < 3 * P; i += k.nt) y.lidx[i] = __ldg(li + i);
  }
  for (int i = k.tid; i < 2 * W; i += k.nt) y.ub[i] = NEG;
  __syncthreads();
  if (a.T > 0) {
    const float* tr = a.trans + ((size_t)(a.T - 1) * a.B + b) * NCLASS;
    float* u = y.ub + (a.T & 1) * W;
    for (int gr = 0; gr < NG; ++gr) {
      if (MULTI) fw.group(gr);
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int j = fw.pos(q);
        if (j >= j1) break;
        const CrfPos& ps = fw.p[q];
        const float v = (j == seqlen && ps.valid) ? -fin : NEG;
        y.bt[j - j0] = v;
        y.bt[P + j - j0] = v;
        u[j - j0] = __fadd_rn(__ldg(tr + ps.ee), v);
        u[P + 1 + j - j0] = __fadd_rn(__ldg(tr + ps.es), v);
      }
    }
    if (k.tid == 0 && j1 < J) {  // the right halo
      const CrfPos ps = crf_pos(bs, j1);
      const float v = (j1 == seqlen && ps.valid) ? -fin : NEG;
      u[P] = __fadd_rn(__ldg(tr + ps.ee), v);
      u[P + 1 + P] = __fadd_rn(__ldg(tr + ps.es), v);
    }
  }
  if (k.tid == 0) s_bend[a.T & 1] = -fin;
  float bstart = NEG, bend = -fin;
  k.sync();

  for (int c = a.n - 1; c >= 0; --c) {
    const int lo = c * a.C, hi = min(lo + a.C, a.T);
    const float* src;
    if (c == a.n - 1) {
      src = row_at(a.rows, b, a.C, 0, R);
    } else {
      const float* ck = row_at(a.ckpt, b, a.n + 1, c, R);
      float* wk = row_at(a.work, b, a.C, 0, R);
      float* rb = y.rowbuf + (lo & 1) * W;
      for (int i = k.tid; i < P + 1; i += k.nt) {
        const int j = j0 - 1 + i;
        const bool in = j >= 0 && j < J;
        rb[i] = in ? __ldg(ck + j) : NEG;
        rb[P + 1 + i] = in ? __ldg(ck + J + j) : NEG;
      }
      for (int j = j0 + k.tid; j < j1; j += k.nt) {
        wk[j] = __ldg(ck + j);
        wk[J + j] = __ldg(ck + J + j);
      }
      float pend = 0.0f;
      if (k.c == 0 && k.tid == 0) {
        s_start[lo & 1] = __ldg(ck + 2 * J);
        pend = __ldg(ck + 2 * J + 1);
        wk[2 * J] = s_start[lo & 1];
        wk[2 * J + 1] = pend;
        s_last[lo & 1][0] = __ldg(ck + seqlen);
        s_last[lo & 1][1] = __ldg(ck + J + seqlen);
      }
      CFin<PPT> in, in_next;
      if (MULTI) fw.group(0);
      else fw.load(lo + 1, hi - 1, true, in);
      k.sync();
      for (int t = lo + 1; t < hi; ++t) {
        if (!MULTI) fw.load(t + 1, hi - 1, true, in_next);
        float ve[PPT], vs[PPT], v0 = 0.0f, v1 = 0.0f;
        for (int gr = 0; gr < NG; ++gr) {
          if (MULTI) {
            fw.group(gr);
            fw.load(t, hi - 1, true, in);
          }
          fw.step(t, in.mp, in, s_start, pend, s_last, ve, vs, v0, v1, gr == 0);
          if (MULTI) fw.store(wk + (size_t)(t - lo) * R, ve, vs, v0, v1, gr == 0);
        }
        if (k.ncta > 1) cluster_arrive();
        else __syncthreads();
        if (!MULTI) fw.store(wk + (size_t)(t - lo) * R, ve, vs, v0, v1, true);
        if (k.ncta > 1) cluster_wait();
        if (!MULTI) in = in_next;
      }
      k.sync();
      src = wk;
    }
    CBin<PPT> in, in_next;
    if (MULTI) fw.group(0);
    else fw.load_bwd(hi, lo + 1, src, lo, in);
    float* partc = a.part + (size_t)b * a.C * k.ncta * NPART;
    // The CTA's 26 parts of step tp from its posteriors and warp sums.
    auto classes = [&](int tp) {
      const int par = tp & 1;
      const float* pe3 = y.pe3 + par * 3 * P;
      for (int cls = k.warp; cls < NPART; cls += k.nwarps) {
        float v = 0.0f;
        if (cls < NCLASS - 1) {
          const int q0 = y.lstart[cls], q1 = y.lstart[cls + 1];
          for (int q = q0 + k.lane; q < q1; q += 32) v += pe3[y.lidx[q]];
        } else if (k.lane < k.nwarps) {  // 24: ss, 25: every edge
          v = s_wsum[par][k.lane][cls == NCLASS - 1 ? 1 : 0];
        }
        v = warp_sum(v);
        if (k.lane == 0)
          partc[((size_t)(tp - 1 - lo) * k.ncta + k.c) * NPART + cls] = v;
      }
    };
    for (int t = hi; t > lo; --t) {
      if (MULTI) {
        fw.group(0);
        fw.load_bwd(t, lo + 1, src, lo, in);
      } else {
        fw.load_bwd(t - 1, lo + 1, src, lo, in_next);
      }
      const int cur = t & 1, nx = cur ^ 1;
      const float ss = in.ss, mt = in.mt, mp = in.mp;
      const float start = __fsub_rn(in.start, mp);
      const float* u = y.ub + cur * W;
      float* un = y.ub + nx * W;
      float* pe3 = y.pe3 + cur * 3 * P;
      const float bend_t = s_bend[cur];
      float p_ss = 0.0f, tot = 0.0f;
      for (int gr = 0; gr < NG; ++gr) {
        if (MULTI && gr > 0) {
          fw.group(gr);
          fw.load_bwd(t, lo + 1, src, lo, in);
        }
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const int j = fw.pos(q);
          if (j >= j1) break;
          const int i = j - j0;
          const CrfPos& ps = fw.p[q];
          const float ee = in.ee[q], es = in.es[q], se = in.se[q];
          const float be = y.bt[i], bsj = y.bt[P + i];
          const float ae0 = __fsub_rn(in.ae0[q], mp);
          const float as0 = __fsub_rn(in.as0[q], mp);
          float pee = 0.0f, pes = 0.0f;
          if (j >= 1) {
            const float ae1 = __fsub_rn(in.ae1[q], mp);
            const float as1 = __fsub_rn(in.as1[q], mp);
            pee = expf(__fsub_rn(__fadd_rn(__fadd_rn(ae1, ee), be), mt));
            pes = expf(__fsub_rn(__fadd_rn(__fadd_rn(as1, es), be), mt));
            if (j == 1)
              pes += expf(__fsub_rn(__fadd_rn(__fadd_rn(start, es), be), mt));
            tot += pee + pes;
          }
          const float pse = expf(__fsub_rn(__fadd_rn(__fadd_rn(ae0, se), bsj), mt));
          const float pss = expf(__fsub_rn(__fadd_rn(__fadd_rn(as0, ss), bsj), mt));
          pe3[i] = pee;
          pe3[P + i] = pes;
          pe3[2 * P + i] = pse;
          p_ss += pss;
          tot += pse + pss;
          const float ue1 = j + 1 < J ? u[i + 1] : NEG;
          const float us1 = j + 1 < J ? u[P + 1 + i + 1] : NEG;
          float nbe = lae(ue1, __fadd_rn(se, bsj));
          float nbs = lae(us1, __fadd_rn(ss, bsj));
          if (j == seqlen) {
            const float ex = __fadd_rn(-a.local, bend_t);
            nbe = lae(nbe, ex);
            nbs = lae(nbs, ex);
          }
          nbe = ps.valid ? __fsub_rn(nbe, mt) : NEG;
          nbs = ps.valid ? __fsub_rn(nbs, mt) : NEG;
          y.bt[i] = nbe;
          y.bt[P + i] = nbs;
          const float uev = __fadd_rn(in.nee[q], nbe);
          const float usv = __fadd_rn(in.nes[q], nbe);
          un[i] = uev;
          un[P + 1 + i] = usv;
          if (k.c > 0 && i == 0) {  // the left CTA's right halo
            float* r = k.remote(un, k.c - 1);
            r[P] = uev;
            r[P + 1 + P] = usv;
          }
        }
      }
      if (k.c == 0 && k.tid == 0) {
        const float ls = lae(-a.local, ss);
        const float ep = __fsub_rn(in.end, mp);
        const float ends = __fadd_rn(
            expf(__fsub_rn(__fadd_rn(__fadd_rn(start, ls), bstart), mt)),
            expf(__fsub_rn(__fadd_rn(__fadd_rn(ep, ls), bend), mt)));
        p_ss += __fmul_rn(ends, expf(__fsub_rn(ss, ls)));
        const float exb = __fsub_rn(__fadd_rn(-a.local, bend), mt);
        const float ex =
            __fadd_rn(expf(__fadd_rn(__fsub_rn(in.last_e, mp), exb)),
                      expf(__fadd_rn(__fsub_rn(in.last_s, mp), exb)));
        tot += __fadd_rn(ends, ex);
        bstart = __fsub_rn(lae(__fadd_rn(ls, bstart), u[P + 1 + 1]), mt);
        bend = __fsub_rn(__fadd_rn(ls, bend), mt);
        k.remote_static(s_bend, seqlen / P)[nx] = bend;
      }
      p_ss = warp_sum(p_ss);
      tot = warp_sum(tot);
      if (k.lane == 0) {
        s_wsum[cur][k.warp][0] = tot;
        s_wsum[cur][k.warp][1] = p_ss;
      }
      if (t < hi) classes(t + 1);
      k.sync();
      if (!MULTI) in = in_next;
    }
    classes(lo + 1);
    k.sync();
    // The chunk's gradient rows: each class's CTA parts, times gP / total.
    const int nstep = hi - lo;
    for (int task = g; task < nstep * NCLASS; task += G) {
      const int tt = task / NCLASS, cls = task % NCLASS;
      const float* pp = partc + (size_t)tt * k.ncta * NPART;
      float tot = 0.0f, v = 0.0f;
      for (int r = 0; r < k.ncta; ++r) {
        tot += pp[r * NPART + NPART - 1];
        v += pp[r * NPART + cls];
      }
      a.grads[((size_t)(lo + tt) * a.B + b) * NCLASS + cls] =
          __fmul_rn(v, __fdiv_rn(scale, tot));
    }
    k.sync();
  }
}

template <typename K>
cudaError_t cluster_config(K kernel, dim3 grid, int ncta, int threads,
                           size_t smem, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (ncta > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int PPT, typename Args>
cudaError_t launch_ppt(void (*kernel)(int, Args), int mode, const Args& args,
                       dim3 grid, int ncta, int threads, size_t smem,
                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      cluster_config(kernel, grid, ncta, threads, smem, cfg, attr, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, mode, args);
}

// The runs of PPT positions a thread walks: one, or (MULTI, PPT = 8) as
// many as the CTA's positions need.
int groups_of(int per, int threads, int ppt) {
  const long run = (long)threads * ppt;
  return (int)((per + run - 1) / run);
}

bool valid_layout(int npos, int ncta, int per, int threads, int ppt) {
  const int ng = groups_of(per, threads, ppt);
  return ncta >= 1 && ncta <= MAX_CLUSTER && per >= 2 && threads >= 32 &&
         threads <= MAX_THREADS && threads % 32 == 0 &&
         (ng == 1 || ppt == 8) &&
         (long)(ncta - 1) * per < npos && (long)ncta * per >= npos;
}

}  // namespace

extern "C" {

// Floats of a CTA's per-position arrays at per positions: kind 0 the
// transducer's, 1 the CRF's (in shared memory, or a global scratch).
int scrappie_lattice_floats(int kind, int per) {
  return (int)(kind ? c_floats(per) : t_floats(per));
}

// mode 0: lp [T, B, S] (time-major), seq [B, L] int32 (-1 padding) ->
// ckpt [B, n+1, L+2], rows [B, C, L+2], m [B, T+1], logp [B] (C, n:
// ops/lattice.chunking); mode 1: with those and gP [B] -> grad [T, B, S],
// using work [B, C, L+2] (n > 1), post [B, C, L], part [B, C, ncta, 2] and
// the state lists start [B, S+1], pos [B, L] (ops/lattice.state_lists).
// Layout ncta, per, threads, ppt (a thread's runs of positions follow from
// them): ops/lattice.cluster_layout; scratch:
// null (shared memory) or [B, ncta, scrappie_lattice_floats(0, per)]. All
// fp32 but the ints, contiguous, on the current device. Returns a
// cudaError_t.
int scrappie_lattice(int mode, const float* lp, const int* seq, float* ckpt,
                     float* rows, float* m, float* logp, const float* gP,
                     float* grad, float* work, float* post, float* part,
                     const int* start, const int* pos, float* scratch, int T,
                     int B, int S, int L, int C, int ncta, int per,
                     int threads, int ppt, float stay_pen, float skip_pen,
                     float local_pen, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (L < 1 || S < 1 || C < 1 || !valid_layout(L, ncta, per, threads, ppt))
    return (int)cudaErrorInvalidValue;
  const int n = T > 0 ? (T + C - 1) / C : 1;
  const int nfloats = (int)t_floats(per);
  const int ng = groups_of(per, threads, ppt);
  const TArgs args{lp, seq, ckpt, rows, m, logp, gP, grad, work, post, part,
                   start, pos, scratch, T, B, S, L, C, n, per, nfloats, ng,
                   stay_pen, skip_pen, local_pen};
  const size_t smem = scratch ? 0 : sizeof(float) * (size_t)nfloats;
  const dim3 grid(ncta, B, 1);
  if (ng > 1)
    return (int)launch_ppt<8>(lattice_fwdbwd_kernel<8, true>, mode, args, grid, ncta, threads, smem, stream);
  switch (ppt) {
    case 1: return (int)launch_ppt<1>(lattice_fwdbwd_kernel<1, false>, mode, args, grid, ncta, threads, smem, stream);
    case 2: return (int)launch_ppt<2>(lattice_fwdbwd_kernel<2, false>, mode, args, grid, ncta, threads, smem, stream);
    case 4: return (int)launch_ppt<4>(lattice_fwdbwd_kernel<4, false>, mode, args, grid, ncta, threads, smem, stream);
    case 8: return (int)launch_ppt<8>(lattice_fwdbwd_kernel<8, false>, mode, args, grid, ncta, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mode 0: trans [T, B, 25], bases [B, L] int32 -> ckpt [B, n+1, 2L+4],
// rows [B, C, 2L+4], m [B, T+1], z [B, T+1, 8], zm [B, T+1], out [2, B]
// (log P, logZ_local); mode 1: with those and gP, gZ [B] -> grads
// [2, T, B, 25] (the lattice's, the partition's), using work (n > 1), part
// [B, C, ncta, 26] and the class lists start [B, ncta, 25], idx
// [B, ncta, 3 per] (ops/lattice.class_lists). Grid (ncta, B, 2): the
// lattice a row on its cluster, then its partition. Layout and scratch as
// scrappie_lattice's (kind 1). Returns a cudaError_t.
int scrappie_crf_lattice(int mode, const float* trans, const int* bases,
                         float* ckpt, float* rows, float* m, float* z,
                         float* zm, float* out, const float* gP,
                         const float* gZ, float* grads, float* work,
                         float* part, const int* start, const int* idx,
                         float* scratch, int T, int B, int L, int C, int ncta,
                         int per, int threads, int ppt, float local_pen,
                         cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (L < 1 || C < 1 || !valid_layout(L + 1, ncta, per, threads, ppt))
    return (int)cudaErrorInvalidValue;
  const int n = T > 0 ? (T + C - 1) / C : 1;
  const int nfloats = (int)c_floats(per);
  const int ng = groups_of(per, threads, ppt);
  const CArgs args{trans, bases, ckpt, rows, m, z, zm, out, gP, gZ, grads,
                   work, part, start, idx, scratch, T, B, L, C, n, per,
                   nfloats, ng, local_pen};
  const size_t smem = scratch ? 0 : sizeof(float) * (size_t)nfloats;
  const dim3 grid(ncta, B, 2);
  if (ng > 1)
    return (int)launch_ppt<8>(crf_lattice_fwdbwd_kernel<8, true>, mode, args, grid, ncta, threads, smem, stream);
  switch (ppt) {
    case 1: return (int)launch_ppt<1>(crf_lattice_fwdbwd_kernel<1, false>, mode, args, grid, ncta, threads, smem, stream);
    case 2: return (int)launch_ppt<2>(crf_lattice_fwdbwd_kernel<2, false>, mode, args, grid, ncta, threads, smem, stream);
    case 4: return (int)launch_ppt<4>(crf_lattice_fwdbwd_kernel<4, false>, mode, args, grid, ncta, threads, smem, stream);
    case 8: return (int)launch_ppt<8>(crf_lattice_fwdbwd_kernel<8, false>, mode, args, grid, ncta, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
