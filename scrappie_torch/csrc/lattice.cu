// The forward-backward of the alignment-free lattice losses, for training:
// the transducer lattice (lattice_fwdbwd_kernel) and the CRF sequence
// lattice with its seven-state local partition (crf_lattice_fwdbwd_kernel).
//
// Replaces: nothing of a TPU kernel. These are the lax.scans of
// scrappie_tpu/train/lattice.py (_lattice_forward_impl :49,
// _crf_lattice_forward_impl :125, _crf_local_partition_impl :210) and the
// VJPs XLA derives for them when the JAX trainer differentiates the lattice
// losses (train/lattice.py, train/wholeread.py). ops/lattice.py holds the
// recurrences, the normalisation and the plain twins (lattice_fwd_plain,
// lattice_bwd_plain, crf_fwd_plain, crf_bwd_plain, partition_fwd_plain,
// partition_bwd_plain), whose arithmetic a step these kernels repeat.
//
// What bounds them on the H100: each is a walk of T dependent steps over
// a row's L sequence positions (the CRF: 2(L + 1) states), one barrier a
// step; the bytes the function needs are the emissions it gathers (L + 1
// entries of a logpost row, or a transition row) and the gradient it
// writes ([T, B, S] or [T, B, 25]), so the bound is bytes, far below the
// walk's latency at the windows' B = 8 and a whole read's B = 1.
//
// Design (both kernels, one block a row, mode 0 forward, mode 1
// backward): the block's threads own positions l = tid, tid + blockDim,
// ... (any L: a thread takes several). Forward: a step reads the previous
// row's scores of its positions and their one or two left neighbours
// (double-buffered rows in shared memory, or when 2 rows do not fit in a
// global scratch array through the same generic pointer), gathers its
// emissions, and writes the new row to the buffer and to the store of
// every step's row [B, T+1, R] in global memory. Each row is stored less
// the running sum of the earlier steps' maxima; the step's own maximum is
// reduced by a warp shuffle and one entry a warp in shared memory, and the
// next step reduces those entries by a shuffle again, so the maximum costs
// no barrier of its own: one barrier a step. Thread 0 carries START and END
// and the sum of the maxima in float64; log P is that sum plus the final
// logaddexp. Backward: the scaled backward scores beta_tilde (see
// ops/lattice.py) walk from T to 1; a thread keeps its positions' own
// beta_tilde in a row it alone reads, and publishes u = (the next step's
// emission) + beta_tilde, which its right neighbours' step and skip need,
// in a double-buffered row; each edge's posterior is exp(alpha_hat_{t-1} +
// weight + beta_tilde_t - m_t), alpha_hat read from the stored rows, and
// every edge's posterior of the step (END's exits too) is summed into a
// total, one entry a warp beside the maxima's, which the step's gradient
// row is divided by after the barrier: 1 in exact arithmetic, it cancels
// the float32 drift common to the step's scores (ops/lattice.py). The
// transducer adds each position's emission posterior into its kmer state's
// entry of a double-buffered [S] row in shared memory (shared atomics; rows
// with repeated kmers collide there), the stays warp-reduced into the stay
// class; after the step's barrier the row is scaled by gP, written to the
// gradient and zeroed. The CRF's 25 classes would serialise the atomics of
// every position on 25 addresses, so a lane adds into its own copy of them
// (32 copies of 25, double-buffered), which warp 0 sums, writes and zeroes
// after the barrier. The CRF's local partition rides in the same launch as
// a second block a row (blockIdx.y = 1), one warp, lanes 0-4 the five
// states, 5 START, 6 END, its own rows [B, T+1, 8] and maxima in global
// memory (no total: its seven states drift too little to need one); its
// backward writes its own gradient array, which the wrapper
// adds to the lattice's. Every row of the forward is kept (no
// checkpoints): at a whole read of 30 720 blocks and 7 000 bases that is
// 30 721 x 7 002 x 4 B = 0.86 GB for the transducer and 30 721 x 14 004 x
// 4 B = 1.72 GB for the CRF, against the card's 80 GB; the backward's rows
// are 3L + 2 (transducer) and 6L + 6 floats (CRF) a block.
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int NCOPY = 32;  // the CRF gradient's copies, one a lane
constexpr int NCLASS = 25;

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

// The maximum of the warps' entries of a step, in every thread.
__device__ __forceinline__ float step_max(const float* wmax, int nwarps) {
  const int lane = threadIdx.x & 31;
  return warp_max(lane < nwarps ? wmax[lane] : NEG);
}

// The sum of the warps' entries of a step, in every thread.
__device__ __forceinline__ float step_sum(const float* wsum, int nwarps) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < nwarps ? wsum[lane] : 0.0f);
}

// Publish this thread's maximum of the step: its warp's, one entry.
__device__ __forceinline__ void put_max(float* wmax, float v) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = v;
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

struct Pens {
  float stay, skip, local;
};

// ------------------------------------------------------------- transducer

// Row layout: positions 0 .. L-1, START at L, END at L + 1 (R = L + 2).
__device__ void transducer_fwd(const float* __restrict__ lp,
                               const int* __restrict__ seq, float* alpha,
                               float* mstore, float* logp, float* rows,
                               float* wmax, int* s_count, int T, int B, int S,
                               int L, Pens pen) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int nwarps = (nt + 31) >> 5;
  const int R = L + 2;
  const int* sq = seq + (size_t)b * L;
  const int lastpos = max(count_valid(sq, L, s_count) - 1, 0);
  float* arow0 = alpha + (size_t)b * (T + 1) * R;
  float* mrow = mstore + (size_t)b * (T + 1);
  for (int l = tid; l < R; l += nt) {
    const float v = l == L ? 0.0f : NEG;
    rows[l] = v;
    arow0[l] = v;
  }
  if (tid < 32) wmax[tid] = tid == 0 ? 0.0f : NEG;  // m_0 = 0
  double asum = 0.0;
  __syncthreads();
  for (int t = 1; t <= T; ++t) {
    const float* prev = rows + ((t - 1) & 1) * R;
    float* cur = rows + (t & 1) * R;
    float* arow = arow0 + (size_t)t * R;
    const float mp = step_max(wmax + ((t - 1) & 1) * 32, nwarps);
    if (tid == 0) {
      mrow[t - 1] = mp;
      asum += mp;
    }
    const float* lpt = lp + ((size_t)(t - 1) * B + b) * S;
    const float stay_lp = __ldg(lpt + S - 1);
    const float start = __fsub_rn(prev[L], mp);
    float lmax = NEG;
    for (int l = tid; l < L; l += nt) {
      const int s = __ldg(sq + l);
      const float e = s >= 0 ? __ldg(lpt + s) : NEG;
      const float p0 = __fsub_rn(prev[l], mp);
      const float p1 = l >= 1 ? __fsub_rn(prev[l - 1], mp) : NEG;
      const float p2 = l >= 2 ? __fsub_rn(prev[l - 2], mp) : NEG;
      const float stay_c = __fadd_rn(__fsub_rn(p0, pen.stay), stay_lp);
      const float step_c = __fadd_rn(p1, e);
      const float skip_c = __fadd_rn(__fsub_rn(p2, pen.skip), e);
      float c = lae(lae(stay_c, step_c), skip_c);
      if (l == 0) c = lae(c, __fadd_rn(start, e));
      c = s >= 0 ? c : NEG;
      cur[l] = c;
      arow[l] = c;
      lmax = fmaxf(lmax, c);
    }
    if (tid == 0) {
      const float ls = lae(-pen.local, stay_lp);
      const float ex = __fsub_rn(__fsub_rn(prev[lastpos], mp), pen.local);
      const float st = __fadd_rn(start, ls);
      const float en = lae(__fadd_rn(__fsub_rn(prev[L + 1], mp), ls), ex);
      cur[L] = st;
      cur[L + 1] = en;
      arow[L] = st;
      arow[L + 1] = en;
      lmax = fmaxf(lmax, fmaxf(st, en));
    }
    put_max(wmax + (t & 1) * 32, lmax);
    __syncthreads();
  }
  const float mT = step_max(wmax + (T & 1) * 32, nwarps);
  if (tid == 0) {
    mrow[T] = mT;
    asum += mT;
    const float* fin_row = rows + (T & 1) * R;
    const float fin = lae(__fsub_rn(fin_row[lastpos], mT),
                          __fsub_rn(fin_row[L + 1], mT));
    logp[b] = (float)(asum + (double)fin);
  }
}

// bt [L] (own positions' beta_tilde), ub [2][L + 1] (u, then END's
// beta_tilde at L), g [2][S] in shared memory.
__device__ void transducer_bwd(const float* __restrict__ lp,
                               const int* __restrict__ seq,
                               const float* __restrict__ alpha,
                               const float* __restrict__ mstore,
                               const float* __restrict__ gP, float* grad,
                               float* rows, float* g2, float* wtot,
                               int* s_count, float* s_fin, int T, int B, int S,
                               int L, Pens pen) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int nwarps = (nt + 31) >> 5;
  const int R = L + 2;
  const int* sq = seq + (size_t)b * L;
  const int lastpos = max(count_valid(sq, L, s_count) - 1, 0);
  const float* abase = alpha + (size_t)b * (T + 1) * R;
  const float* mrow = mstore + (size_t)b * (T + 1);
  float* bt = rows;
  float* ub = rows + L;  // [2][L + 1]
  if (tid == 0) {
    const float mT = mrow[T];
    const float* ar = abase + (size_t)T * R;
    *s_fin = lae(__fsub_rn(ar[lastpos], mT), __fsub_rn(ar[L + 1], mT));
  }
  __syncthreads();
  const float fin = *s_fin;
  if (fin < 0.5f * NEG) {  // no path: a zero gradient
    for (int t = 0; t < T; ++t)
      for (int k = tid; k < S; k += nt) grad[((size_t)t * B + b) * S + k] = 0.0f;
    return;
  }
  const float scale = gP[b];
  for (int k = tid; k < 2 * S; k += nt) g2[k] = 0.0f;
  if (T > 0) {
    const float* lpt = lp + ((size_t)(T - 1) * B + b) * S;
    float* u = ub + (T & 1) * (L + 1);
    for (int l = tid; l < L; l += nt) {
      const int s = __ldg(sq + l);
      const float v = (l == lastpos && s >= 0) ? -fin : NEG;
      bt[l] = v;
      u[l] = __fadd_rn(s >= 0 ? __ldg(lpt + s) : NEG, v);
    }
    if (tid == 0) u[L] = -fin;
  }
  float bstart = NEG;  // thread 0's
  __syncthreads();
  for (int t = T; t >= 1; --t) {
    const float* u = ub + (t & 1) * (L + 1);
    float* un = ub + ((t - 1) & 1) * (L + 1);
    float* g = g2 + (t & 1) * S;
    const float* lpt = lp + ((size_t)(t - 1) * B + b) * S;
    const float* lpn = t > 1 ? lp + ((size_t)(t - 2) * B + b) * S : lpt;
    const float stay_lp = __ldg(lpt + S - 1);
    const float mt = mrow[t], mp = mrow[t - 1];
    const float* ap = abase + (size_t)(t - 1) * R;
    const float bend = u[L];
    float stay_sum = 0.0f, tot = 0.0f;  // tot: every edge's posterior
    for (int l = tid; l < L; l += nt) {
      const int s = __ldg(sq + l);
      const float btl = bt[l];
      const float ul = u[l];
      const float a0 = __fsub_rn(ap[l], mp);
      const float a1 = l >= 1 ? __fsub_rn(ap[l - 1], mp) : NEG;
      const float a2 = l >= 2 ? __fsub_rn(ap[l - 2], mp) : NEG;
      float inc = lae(a1, __fsub_rn(a2, pen.skip));
      if (l == 0) inc = lae(inc, __fsub_rn(ap[L], mp));
      if (s >= 0) {
        const float pe = expf(__fsub_rn(__fadd_rn(inc, ul), mt));
        atomicAdd(g + s, pe);
        tot += pe;
      }
      const float ps = expf(__fsub_rn(
          __fadd_rn(__fadd_rn(__fsub_rn(a0, pen.stay), stay_lp), btl), mt));
      stay_sum += ps;
      tot += ps;
      const float u1 = l + 1 < L ? u[l + 1] : NEG;
      const float u2 = l + 2 < L ? u[l + 2] : NEG;
      float nb = lae(lae(__fadd_rn(__fsub_rn(btl, pen.stay), stay_lp), u1),
                     __fsub_rn(u2, pen.skip));
      if (l == lastpos) nb = lae(nb, __fadd_rn(-pen.local, bend));
      nb = s >= 0 ? __fsub_rn(nb, mt) : NEG;
      bt[l] = nb;
      un[l] = __fadd_rn(s >= 0 ? __ldg(lpn + s) : NEG, nb);
    }
    if (tid == 0) {
      const float ls = lae(-pen.local, stay_lp);
      const float sp = __fsub_rn(ap[L], mp), ep = __fsub_rn(ap[L + 1], mp);
      const float ends =
          __fadd_rn(expf(__fsub_rn(__fadd_rn(__fadd_rn(sp, ls), bstart), mt)),
                    expf(__fsub_rn(__fadd_rn(__fadd_rn(ep, ls), bend), mt)));
      stay_sum += __fmul_rn(ends, expf(__fsub_rn(stay_lp, ls)));
      const float ex = expf(__fsub_rn(
          __fadd_rn(__fsub_rn(__fsub_rn(ap[lastpos], mp), pen.local), bend),
          mt));
      tot += __fadd_rn(ends, ex);
      bstart = __fsub_rn(lae(__fadd_rn(ls, bstart), u[0]), mt);
      un[L] = __fsub_rn(__fadd_rn(ls, bend), mt);
    }
    stay_sum = warp_sum(stay_sum);
    tot = warp_sum(tot);
    if ((tid & 31) == 0) {
      atomicAdd(g + S - 1, stay_sum);
      wtot[(t & 1) * 32 + (tid >> 5)] = tot;
    }
    __syncthreads();
    const float st = __fdiv_rn(scale, step_sum(wtot + (t & 1) * 32, nwarps));
    float* out = grad + ((size_t)(t - 1) * B + b) * S;
    for (int k = tid; k < S; k += nt) {
      out[k] = __fmul_rn(g[k], st);
      g[k] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
lattice_fwdbwd_kernel(int mode, const float* __restrict__ lp,
                      const int* __restrict__ seq, float* alpha, float* mstore,
                      float* logp, const float* __restrict__ gP, float* grad,
                      float* scratch, int nrow, int T, int B, int S, int L,
                      Pens pen) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_warp[2 * 32];  // a warp's maximum or total a step
  __shared__ int s_count;
  __shared__ float s_fin;
  float* g2 = smem;  // backward: [2][S]
  float* shared_rows = smem + (mode ? 2 * S : 0);
  float* rows = scratch ? scratch + (size_t)blockIdx.x * nrow : shared_rows;
  if (mode == 0)
    transducer_fwd(lp, seq, alpha, mstore, logp, rows, s_warp, &s_count, T, B,
                   S, L, pen);
  else
    transducer_bwd(lp, seq, alpha, mstore, gP, grad, rows, g2, s_warp,
                   &s_count, &s_fin, T, B, S, L, pen);
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

// Row layout: emit states 0 .. J-1, '-' states J .. 2J-1, START at 2J,
// END at 2J + 1 (J = L + 1, R = 2J + 2).
__device__ void crf_fwd(const float* __restrict__ trans,
                        const int* __restrict__ bases, float* alpha,
                        float* mstore, float* logp, float* rows, float* wmax,
                        int* s_count, int T, int B, int L, float local_pen) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int nwarps = (nt + 31) >> 5;
  const int J = L + 1, R = 2 * J + 2;
  const int* bs = bases + (size_t)b * L;
  const int seqlen = count_valid(bs, L, s_count);
  float* arow0 = alpha + (size_t)b * (T + 1) * R;
  float* mrow = mstore + (size_t)b * (T + 1);
  for (int l = tid; l < R; l += nt) {
    const float v = l == 2 * J ? 0.0f : NEG;
    rows[l] = v;
    arow0[l] = v;
  }
  if (tid < 32) wmax[tid] = tid == 0 ? 0.0f : NEG;
  double asum = 0.0;
  __syncthreads();
  for (int t = 1; t <= T; ++t) {
    const float* prev = rows + ((t - 1) & 1) * R;
    float* cur = rows + (t & 1) * R;
    float* arow = arow0 + (size_t)t * R;
    const float mp = step_max(wmax + ((t - 1) & 1) * 32, nwarps);
    if (tid == 0) {
      mrow[t - 1] = mp;
      asum += mp;
    }
    const float* tr = trans + ((size_t)(t - 1) * B + b) * NCLASS;
    const float ss = __ldg(tr + 24);
    const float start = __fsub_rn(prev[2 * J], mp);
    float lmax = NEG;
    for (int j = tid; j < J; j += nt) {
      const CrfPos p = crf_pos(bs, j);
      const float ee = __ldg(tr + p.ee), es = __ldg(tr + p.es);
      const float se = __ldg(tr + p.se);
      const float ae1 = j >= 1 ? __fsub_rn(prev[j - 1], mp) : NEG;
      const float as1 = j >= 1 ? __fsub_rn(prev[J + j - 1], mp) : NEG;
      float ne = lae(__fadd_rn(ae1, ee), __fadd_rn(as1, es));
      if (j == 1) ne = lae(ne, __fadd_rn(start, es));
      const float ns = lae(__fadd_rn(__fsub_rn(prev[j], mp), se),
                           __fadd_rn(__fsub_rn(prev[J + j], mp), ss));
      const float e = p.valid ? ne : NEG, s = p.valid ? ns : NEG;
      cur[j] = e;
      cur[J + j] = s;
      arow[j] = e;
      arow[J + j] = s;
      lmax = fmaxf(lmax, fmaxf(e, s));
    }
    if (tid == 0) {
      const float ls = lae(-local_pen, ss);
      const float ex = __fsub_rn(lae(__fsub_rn(prev[seqlen], mp),
                                     __fsub_rn(prev[J + seqlen], mp)),
                                 local_pen);
      const float st = __fadd_rn(start, ls);
      const float en = lae(__fadd_rn(__fsub_rn(prev[2 * J + 1], mp), ls), ex);
      cur[2 * J] = st;
      cur[2 * J + 1] = en;
      arow[2 * J] = st;
      arow[2 * J + 1] = en;
      lmax = fmaxf(lmax, fmaxf(st, en));
    }
    put_max(wmax + (t & 1) * 32, lmax);
    __syncthreads();
  }
  const float mT = step_max(wmax + (T & 1) * 32, nwarps);
  if (tid == 0) {
    mrow[T] = mT;
    asum += mT;
    const float* f = rows + (T & 1) * R;
    const float fin = lae(lae(__fsub_rn(f[seqlen], mT),
                              __fsub_rn(f[J + seqlen], mT)),
                          __fsub_rn(f[2 * J + 1], mT));
    logp[b] = (float)(asum + (double)fin);
  }
}

// bt [2J] (own beta_tilde: emit, then '-'), ub [2][2J + 1] (ue, us, then
// END's beta_tilde at 2J), g [2][NCOPY][NCLASS] in shared memory.
__device__ void crf_bwd(const float* __restrict__ trans,
                        const int* __restrict__ bases,
                        const float* __restrict__ alpha,
                        const float* __restrict__ mstore,
                        const float* __restrict__ gP, float* grad, float* rows,
                        float* g2, float* wtot, int* s_count, float* s_fin,
                        int T, int B, int L, float local_pen) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, nwarps = (nt + 31) >> 5;
  const int J = L + 1, R = 2 * J + 2, U = 2 * J + 1;
  const int* bs = bases + (size_t)b * L;
  const int seqlen = count_valid(bs, L, s_count);
  const float* abase = alpha + (size_t)b * (T + 1) * R;
  const float* mrow = mstore + (size_t)b * (T + 1);
  float* bt = rows;
  float* ub = rows + 2 * J;  // [2][U]
  if (tid == 0) {
    const float mT = mrow[T];
    const float* ar = abase + (size_t)T * R;
    *s_fin = lae(lae(__fsub_rn(ar[seqlen], mT), __fsub_rn(ar[J + seqlen], mT)),
                 __fsub_rn(ar[2 * J + 1], mT));
  }
  __syncthreads();
  const float fin = *s_fin;
  if (fin < 0.5f * NEG) {
    for (int k = tid; k < T * NCLASS; k += nt)
      grad[((size_t)(k / NCLASS) * B + b) * NCLASS + k % NCLASS] = 0.0f;
    return;
  }
  const float scale = gP[b];
  for (int k = tid; k < 2 * NCOPY * NCLASS; k += nt) g2[k] = 0.0f;
  if (T > 0) {
    const float* tr = trans + ((size_t)(T - 1) * B + b) * NCLASS;
    float* u = ub + (T & 1) * U;
    for (int j = tid; j < J; j += nt) {
      const CrfPos p = crf_pos(bs, j);
      const float v = (j == seqlen && p.valid) ? -fin : NEG;
      bt[j] = v;
      bt[J + j] = v;
      u[j] = __fadd_rn(__ldg(tr + p.ee), v);
      u[J + j] = __fadd_rn(__ldg(tr + p.es), v);
    }
    if (tid == 0) u[2 * J] = -fin;
  }
  float bstart = NEG;
  __syncthreads();
  for (int t = T; t >= 1; --t) {
    const float* u = ub + (t & 1) * U;
    float* un = ub + ((t - 1) & 1) * U;
    float* g = g2 + (t & 1) * NCOPY * NCLASS + lane * NCLASS;
    const float* tr = trans + ((size_t)(t - 1) * B + b) * NCLASS;
    const float* trn = t > 1 ? trans + ((size_t)(t - 2) * B + b) * NCLASS : tr;
    const float ss = __ldg(tr + 24);
    const float mt = mrow[t], mp = mrow[t - 1];
    const float* ap = abase + (size_t)(t - 1) * R;
    const float start = __fsub_rn(ap[2 * J], mp);
    const float bend = u[2 * J];
    float p_ss = 0.0f, tot = 0.0f;  // tot: every edge's posterior
    for (int j = tid; j < J; j += nt) {
      const CrfPos p = crf_pos(bs, j);
      const float ee = __ldg(tr + p.ee), es = __ldg(tr + p.es);
      const float se = __ldg(tr + p.se);
      const float be = bt[j], bsj = bt[J + j];
      const float ae0 = __fsub_rn(ap[j], mp), as0 = __fsub_rn(ap[J + j], mp);
      if (j >= 1) {
        const float ae1 = __fsub_rn(ap[j - 1], mp);
        const float as1 = __fsub_rn(ap[J + j - 1], mp);
        const float pee = expf(__fsub_rn(__fadd_rn(__fadd_rn(ae1, ee), be), mt));
        atomicAdd(g + p.ee, pee);
        float pes = expf(__fsub_rn(__fadd_rn(__fadd_rn(as1, es), be), mt));
        if (j == 1)
          pes += expf(__fsub_rn(__fadd_rn(__fadd_rn(start, es), be), mt));
        atomicAdd(g + p.es, pes);
        tot += pee + pes;
      }
      const float pse = expf(__fsub_rn(__fadd_rn(__fadd_rn(ae0, se), bsj), mt));
      const float pss = expf(__fsub_rn(__fadd_rn(__fadd_rn(as0, ss), bsj), mt));
      atomicAdd(g + p.se, pse);
      p_ss += pss;
      tot += pse + pss;
      const float ue1 = j + 1 < J ? u[j + 1] : NEG;
      const float us1 = j + 1 < J ? u[J + j + 1] : NEG;
      float nbe = lae(ue1, __fadd_rn(se, bsj));
      float nbs = lae(us1, __fadd_rn(ss, bsj));
      if (j == seqlen) {
        const float ex = __fadd_rn(-local_pen, bend);
        nbe = lae(nbe, ex);
        nbs = lae(nbs, ex);
      }
      nbe = p.valid ? __fsub_rn(nbe, mt) : NEG;
      nbs = p.valid ? __fsub_rn(nbs, mt) : NEG;
      bt[j] = nbe;
      bt[J + j] = nbs;
      un[j] = __fadd_rn(__ldg(trn + p.ee), nbe);
      un[J + j] = __fadd_rn(__ldg(trn + p.es), nbe);
    }
    if (tid == 0) {
      const float ls = lae(-local_pen, ss);
      const float ep = __fsub_rn(ap[2 * J + 1], mp);
      const float ends = __fadd_rn(
          expf(__fsub_rn(__fadd_rn(__fadd_rn(start, ls), bstart), mt)),
          expf(__fsub_rn(__fadd_rn(__fadd_rn(ep, ls), bend), mt)));
      p_ss += __fmul_rn(ends, expf(__fsub_rn(ss, ls)));
      const float exb = __fsub_rn(__fadd_rn(-local_pen, bend), mt);
      const float ex =
          __fadd_rn(expf(__fadd_rn(__fsub_rn(ap[seqlen], mp), exb)),
                    expf(__fadd_rn(__fsub_rn(ap[J + seqlen], mp), exb)));
      tot += __fadd_rn(ends, ex);
      bstart = __fsub_rn(lae(__fadd_rn(ls, bstart), u[J + 1]), mt);
      un[2 * J] = __fsub_rn(__fadd_rn(ls, bend), mt);
    }
    atomicAdd(g + 24, p_ss);
    tot = warp_sum(tot);
    if (lane == 0) wtot[(t & 1) * 32 + (tid >> 5)] = tot;
    __syncthreads();
    if (tid < 32) {  // warp 0: the step's 25 classes from the 32 copies
      const float st = __fdiv_rn(scale, step_sum(wtot + (t & 1) * 32, nwarps));
      float* gc = g2 + (t & 1) * NCOPY * NCLASS;
      if (lane < NCLASS) {
        float sum = 0.0f;
        for (int c = 0; c < NCOPY; ++c) {
          sum += gc[c * NCLASS + lane];
          gc[c * NCLASS + lane] = 0.0f;
        }
        grad[((size_t)(t - 1) * B + b) * NCLASS + lane] = __fmul_rn(sum, st);
      }
    }
  }
}

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
                              float* zm, float* logz, int T, int B,
                              float local_pen) {
  const int b = blockIdx.x, lane = threadIdx.x;
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
                              const float* __restrict__ gZ, float* grad, int T,
                              int B, float local_pen) {
  const int b = blockIdx.x, lane = threadIdx.x;
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

__global__ void __launch_bounds__(MAX_THREADS)
crf_lattice_fwdbwd_kernel(int mode, const float* __restrict__ trans,
                          const int* __restrict__ bases, float* alpha,
                          float* mstore, float* z, float* zm, float* out,
                          const float* __restrict__ gP,
                          const float* __restrict__ gZ, float* grads,
                          float* scratch, int nrow, int T, int B, int L,
                          float local_pen) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_warp[2 * 32];  // a warp's maximum or total a step
  __shared__ int s_count;
  __shared__ float s_fin;
  if (blockIdx.y == 1) {  // the local partition: one warp
    if (threadIdx.x >= 32) return;
    if (mode == 0)
      partition_fwd(trans, z, zm, out + B, T, B, local_pen);
    else
      partition_bwd(trans, z, zm, gZ, grads + (size_t)T * B * NCLASS, T, B,
                    local_pen);
    return;
  }
  float* g2 = smem;  // backward: [2][NCOPY][NCLASS]
  float* shared_rows = smem + (mode ? 2 * NCOPY * NCLASS : 0);
  float* rows = scratch ? scratch + (size_t)blockIdx.x * nrow : shared_rows;
  if (mode == 0)
    crf_fwd(trans, bases, alpha, mstore, out, rows, s_warp, &s_count, T, B, L,
            local_pen);
  else
    crf_bwd(trans, bases, alpha, mstore, gP, grads, rows, g2, s_warp, &s_count,
            &s_fin, T, B, L, local_pen);
}

int threads_for(int npos) {
  const int n = (npos + 31) / 32 * 32;
  return n < 32 ? 32 : (n > MAX_THREADS ? MAX_THREADS : n);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// mode 0: lp [T, B, S] (time-major), seq [B, L] int32 (-1 padding) ->
// alpha [B, T+1, L+2], m [B, T+1], logp [B]; mode 1: with those and gP [B]
// -> grad [T, B, S]. scratch: null (the rows in shared memory) or
// [B, 2(L+2)] (mode 0) / [B, 3L+2] (mode 1) floats. All fp32 but seq,
// contiguous, on the current device. Returns a cudaError_t.
int scrappie_lattice(int mode, const float* lp, const int* seq, float* alpha,
                     float* m, float* logp, const float* gP, float* grad,
                     float* scratch, int T, int B, int S, int L, float stay_pen,
                     float skip_pen, float local_pen, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (L < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int nrow = mode ? 3 * L + 2 : 2 * (L + 2);
  const size_t smem = sizeof(float) * ((mode ? 2 * (size_t)S : 0) +
                                       (scratch ? 0 : (size_t)nrow));
  cudaError_t err = set_smem(lattice_fwdbwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lattice_fwdbwd_kernel<<<B, threads_for(L), smem, stream>>>(
      mode, lp, seq, alpha, m, logp, gP, grad, scratch, nrow, T, B, S, L,
      Pens{stay_pen, skip_pen, local_pen});
  return (int)cudaGetLastError();
}

// mode 0: trans [T, B, 25], bases [B, L] int32 -> alpha [B, T+1, 2L+4],
// m [B, T+1], z [B, T+1, 8], zm [B, T+1], out [2, B] (log P, logZ_local);
// mode 1: with those and gP, gZ [B] -> grads [2, T, B, 25] (the lattice's,
// the partition's). scratch: null or [B, 4L+8] (mode 0) / [B, 6L+6]
// (mode 1) floats. Grid (B, 2): the lattice a row, then its partition.
// Returns a cudaError_t.
int scrappie_crf_lattice(int mode, const float* trans, const int* bases,
                         float* alpha, float* m, float* z, float* zm,
                         float* out, const float* gP, const float* gZ,
                         float* grads, float* scratch, int T, int B, int L,
                         float local_pen, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (L < 1) return (int)cudaErrorInvalidValue;
  const int J = L + 1;
  const int nrow = mode ? 2 * J + 2 * (2 * J + 1) : 2 * (2 * J + 2);
  const size_t smem =
      sizeof(float) * ((mode ? 2 * (size_t)NCOPY * NCLASS : 0) +
                       (scratch ? 0 : (size_t)nrow));
  cudaError_t err = set_smem(crf_lattice_fwdbwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  crf_lattice_fwdbwd_kernel<<<dim3(B, 2), threads_for(J), smem, stream>>>(
      mode, trans, bases, alpha, m, z, zm, out, gP, gZ, grads, scratch, nrow,
      T, B, L, local_pen);
  return (int)cudaGetLastError();
}

}  // extern "C"
