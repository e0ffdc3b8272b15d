// Signal-to-squiggle alignment: the DP forward pass over the raw samples of
// one read, Viterbi (with a traceback of moves) or forward (log-sum-exp),
// and the walk of the Viterbi traceback.
//
// Replaces scrappie_tpu/ops/dtw.py:_dtw_kernel (wrapper squiggle_match_tm,
// scrappie_torch/ops/dtw.py), whose lax.scan program
// scrappie_tpu/decode/dtw.py:_squiggle_match gives the order of operations,
// and the host walk of scrappie_tpu/decode/dtw.py:squiggle_match_viterbi.
// States: forward states [start | npos positions | end] (nf = npos + 2),
// then npos back states (nstate = 2 npos + 2). Per sample x:
//   forward state st, candidates in this order (move byte in brackets):
//     stay   f[st] + stay_pen[st]                         [0] from st
//     step   f[st-1] + move_pen[st-1]                     [1] from st-1
//     skip   (f[st-2] + move_pen[st-2]) - skip_pen        [2] from st-2
//     start  f[0] + start_jump[st]                        [3] from 0
//     end    (st = nf-1 only) max over st' of f[st'] + end_jump[st'],
//            from its first argmax, end_src[t]            [4]
//     back   b[st-2] + log(1/2), 2 <= st <= npos          [5] from nf+st-2
//   back state j: b[j] + log(1/2) [0] (from nf+j), then f[j+2] +
//   log(prob_back) for j < npos-1 [1] (from j+2);
//   then positions add max(-minscore, (-|x-loc|/scale - logscale) - log 2)
//   and start and end subtract local_pen.
// Out-of-range candidates are -1e30, as in the scan. Viterbi takes a
// candidate only if strictly greater; the forward variant combines by
// jnp.logaddexp's formula (max + log1p(exp(-|a-b|)), and a+b where a-b is
// NaN, so -inf with -inf stays -inf) and takes the end jump by
// jax.nn.logsumexp's. Every addition is an explicit __fadd_rn/__fsub_rn in
// the scan's order and the emission divides by __fdiv_rn, so the Viterbi
// scores and moves are identical bit for bit to the plain twin
// (ops/dtw.py:squiggle_match_plain); the forward variant's expf/log1pf
// differ from the host's by ulps. The traceback is a byte a state (the
// winning candidate) plus end_src [T] int32, the end jump's first argmax
// at every sample: ops/dtw.py:moves_to_states rebuilds JAX's int32 states.
//
// What bounds it on the H100: latency. The DP is sequential in the
// samples (10^4 to 10^5 a read), and each step needs its neighbours'
// previous scores and the end jump's reduction over all nf scores. The
// traceback, a byte a state (0.72 GB for 60 000 samples against 6 000
// positions), is the only large traffic.
//
// Design (dtw_cluster_kernel): one read on a thread-block cluster of up to
// 16 CTAs, launched with cudaLaunchKernelEx. CTA c owns the forward states
// [c per, (c+1) per) and their positions' back states, SPT consecutive
// states a thread (the layout comes from ops/dtw.py:cluster_layout), so a
// thread keeps its states' constants (loc, scale, log scale, stay, move,
// start and end jump penalties) and its own scores in registers for the
// whole read. A CTA's shared memory holds its scores, double-buffered,
// with halos: the two forward scores and one back score left of its range
// and one forward score right of it, and f[0]. Each sample a CTA writes
// its new scores locally and pushes through distributed shared memory
// what its neighbours read: its last two forward and last back scores to
// the right, its first forward score to the left; the owner of f[0]
// pushes it to every CTA. Each warp folds f + end_jump over its new scores
// into a running (max, first index) or (max, sum of exp) and pushes that
// partial to the CTA owning the end state, whose warp merges the partials
// at the next sample. So a sample needs one cluster barrier
// (barrier.cluster.arrive.release / wait.acquire), and the move bytes are
// stored between its arrive and its wait. A read whose states fit one CTA
// runs on a cluster of one, which needs only __syncthreads a sample.
//
// dtw_global_kernel, for squiggles beyond the cluster's capacity, keeps
// the single-block design: 1024 threads, the scores in a global scratch
// [2, nstate], thread i owning the forward states i, i + 1024, ... with
// their back states. dtw_walk_kernel follows the moves back from the final
// state on one thread: T dependent one-byte loads, latency-bound, and only
// the path [T] int32 leaves the card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float LARGE = 1.0e30f;
constexpr float LOG_HALF = -0.693147182464599609375f;  // float32(log(0.5))
constexpr float LOG2 = 0.693147182464599609375f;       // float32(log(2))
constexpr int GLOBAL_THREADS = 1024;
constexpr int CLUSTER_THREADS = 512;  // at most, a CTA of the cluster kernel
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_PARTIALS = MAX_CLUSTER * CLUSTER_THREADS / 32;
enum : uint8_t { STAY = 0, STEP = 1, SKIP = 2, START = 3, END = 4, BACK = 5 };

struct DtwParams {
  float skip_pen;
  float local_pen;
  float minscore;
  float move_back_pen;
};

// jnp.logaddexp's formula.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float delta = __fsub_rn(a, b);
  if (isnan(delta)) return __fadd_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(delta))));
}

// Viterbi: take cand if strictly greater. Forward: log-sum-exp.
template <bool kViterbi, typename Tb>
__device__ __forceinline__ void contend(float& cur, Tb& tb, float cand,
                                        Tb ctb) {
  if (kViterbi) {
    if (cand > cur) {
      cur = cand;
      tb = ctb;
    }
  } else {
    cur = logaddexp(cur, cand);
  }
}

// The running end-jump partial: (max, first index) for Viterbi, (max, sum
// of exp(v - max)) for the forward variant.
struct Partial {
  float m;
  float s;
  int i;
};

__device__ __forceinline__ Partial empty_partial() {
  return Partial{-CUDART_INF_F, 0.0f, 0x7fffffff};
}

template <bool kViterbi>
__device__ __forceinline__ void fold(Partial& p, float v, int i) {
  if (kViterbi) {
    if (v > p.m) {
      p.m = v;
      p.i = i;
    }
  } else if (v != -CUDART_INF_F) {
    if (v > p.m) {
      p.s = __fadd_rn(p.m == -CUDART_INF_F ? 0.0f : p.s * expf(p.m - v), 1.0f);
      p.m = v;
    } else {
      p.s = __fadd_rn(p.s, expf(__fsub_rn(v, p.m)));
    }
  }
}

template <bool kViterbi>
__device__ __forceinline__ Partial merge(Partial a, Partial b) {
  if (kViterbi) {
    return (b.m > a.m || (b.m == a.m && b.i < a.i)) ? b : a;
  }
  const float m = fmaxf(a.m, b.m);
  if (m == -CUDART_INF_F) return a;
  const float sa = a.m == -CUDART_INF_F ? 0.0f : a.s * expf(a.m - m);
  const float sb = b.m == -CUDART_INF_F ? 0.0f : b.s * expf(b.m - m);
  return Partial{m, __fadd_rn(sa, sb), 0};
}

template <bool kViterbi>
__device__ __forceinline__ Partial warp_merge(Partial p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Partial q = p;  // Viterbi needs no sum, the forward variant no index
    q.m = __shfl_xor_sync(0xffffffffu, p.m, off);
    if (kViterbi) {
      q.i = __shfl_xor_sync(0xffffffffu, p.i, off);
    } else {
      q.s = __shfl_xor_sync(0xffffffffu, p.s, off);
    }
    p = merge<kViterbi>(p, q);
  }
  return p;
}

// The end jump's candidate from its merged partial: the max (Viterbi) or
// jax.nn.logsumexp's log(sum) + max.
template <bool kViterbi>
__device__ __forceinline__ float end_candidate(const Partial& q) {
  if (kViterbi) return q.m;
  const float m = isfinite(q.m) ? q.m : 0.0f;
  const float s = isfinite(q.m) ? q.s : q.s * expf(q.m - m);
  return __fadd_rn(logf(s), m);
}

// Floored Laplace log emission of sample x at one position.
__device__ __forceinline__ float emission(float x, float loc, float scale,
                                          float logscale, float minscore) {
  const float e = __fsub_rn(
      __fsub_rn(__fdiv_rn(-fabsf(__fsub_rn(x, loc)), scale), logscale), LOG2);
  return fmaxf(-minscore, e);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One CTA's shared memory: per buffer (two), the forward scores of states
// [s0 - 2, s0 + span + 1) (index st - s0 + 2), the back scores of the
// forward states [s0 - 1, s0 + span) (index st - s0 + 1), and f[0], where
// span = threads x SPT >= per covers every thread's window. The end jump's
// partials of every warp of the cluster, [2][ncta nwarp], are read only in
// the CTA that owns the end state.
struct ClusterSmem {
  float* f[2];
  float* b[2];
  float* f0[2];
};

__device__ __forceinline__ ClusterSmem cluster_smem(float* base, int span) {
  const int nfw = span + 3;
  const int nbw = span + 1;
  ClusterSmem s;
  for (int k = 0; k < 2; ++k) {
    float* buf = base + k * (nfw + nbw + 1);
    s.f[k] = buf;
    s.b[k] = buf + nfw;
    s.f0[k] = buf + nfw + nbw;
  }
  return s;
}

// sig [T]; locs/scales/logscales [npos]; move/stay_pen, start/end_jump
// [nf] -> final [nstate]; for Viterbi moves [T, nstate] uint8 and end_src
// [T] int32. Grid: one cluster of ncta CTAs of blockDim.x threads; CTA c
// owns the forward states [c per, min((c+1) per, nf)), thread i of it the
// SPT states from c per + i SPT; per is a multiple of SPT, so no thread's
// states straddle two CTAs.
template <bool kViterbi, int SPT>
__global__ void __launch_bounds__(CLUSTER_THREADS)
dtw_cluster_kernel(const float* __restrict__ sig,
                   const float* __restrict__ locs,
                   const float* __restrict__ scales,
                   const float* __restrict__ logscales,
                   const float* __restrict__ move_pen,
                   const float* __restrict__ stay_pen,
                   const float* __restrict__ start_jump,
                   const float* __restrict__ end_jump,
                   float* __restrict__ final_, uint8_t* __restrict__ moves,
                   int* __restrict__ end_src, int T, int npos, int per,
                   DtwParams p) {
  extern __shared__ float smem[];
  __shared__ float red_m[2][MAX_PARTIALS];
  __shared__ float red_s[2][MAX_PARTIALS];
  __shared__ int red_i[2][MAX_PARTIALS];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nwarp = blockDim.x >> 5;
  const int gwarp = c * nwarp + (tid >> 5);
  const int npart = ncta * nwarp;
  const int nf = npos + 2;
  const int nstate = nf + npos;
  const int s0 = c * per;
  const int s1 = min(s0 + per, nf);
  const int st0 = s0 + tid * SPT;
  const int end_cta = (nf - 1) / per;
  const bool end_warp = c == end_cta && ((nf - 1 - s0) / SPT) >> 5 == tid >> 5;
  const int span = blockDim.x * SPT;
  const ClusterSmem sm = cluster_smem(smem, span);
  // where this CTA's pushes land: the neighbours' and the end CTA's memory
  const ClusterSmem left =
      c > 0 ? cluster_smem(cluster.map_shared_rank(smem, c - 1), span) : sm;
  const ClusterSmem right =
      c + 1 < ncta ? cluster_smem(cluster.map_shared_rank(smem, c + 1), span)
                   : sm;
  float* end_m = cluster.map_shared_rank(&red_m[0][0], end_cta);
  float* end_s = cluster.map_shared_rank(&red_s[0][0], end_cta);
  int* end_i = cluster.map_shared_rank(&red_i[0][0], end_cta);

  // This thread's states and their constants, for the whole read.
  float fo[SPT], bo[SPT], stay[SPT], sj[SPT], ej[SPT], loc[SPT], scl[SPT],
      lsc[SPT], mp[SPT + 2];
#pragma unroll
  for (int k = 0; k < SPT + 2; ++k) {
    const int st = st0 - 2 + k;
    mp[k] = (st >= 0 && st < nf) ? __ldg(move_pen + st) : 0.0f;
  }
  Partial part = empty_partial();
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int st = st0 + k;
    const bool own = st < s1;
    const bool pos = own && st >= 1 && st <= npos;
    fo[k] = st == 0 ? 0.0f : -LARGE;
    bo[k] = -LARGE;
    stay[k] = own ? __ldg(stay_pen + st) : 0.0f;
    sj[k] = own ? __ldg(start_jump + st) : 0.0f;
    ej[k] = own ? __ldg(end_jump + st) : 0.0f;
    loc[k] = pos ? __ldg(locs + st - 1) : 0.0f;
    scl[k] = pos ? __ldg(scales + st - 1) : 1.0f;
    lsc[k] = pos ? __ldg(logscales + st - 1) : 0.0f;
    if (own) fold<kViterbi>(part, __fadd_rn(fo[k], ej[k]), st);
  }
  // Initial scores, halos included (no pushes needed): start 0, everything
  // else -1e30; and the end-jump partials of those scores, in slot 0.
  for (int i = tid; i < span + 3; i += blockDim.x) {
    const int st = s0 - 2 + i;
    sm.f[0][i] = st == 0 ? 0.0f : -LARGE;
  }
  for (int i = tid; i < span + 1; i += blockDim.x) sm.b[0][i] = -LARGE;
  if (tid == 0) sm.f0[0][0] = 0.0f;
  part = warp_merge<kViterbi>(part);
  // a cluster of one CTA needs only the block's barrier; a larger one
  // writes into another CTA's shared memory only once every CTA of the
  // cluster has started (a cluster barrier)
  const bool solo = ncta == 1;
  if (!solo) {
    cluster_arrive();
    cluster_wait();
  }
  if (lane == 0) {
    end_m[gwarp] = part.m;
    end_s[gwarp] = part.s;
    end_i[gwarp] = part.i;
  }
  if (solo) {
    __syncthreads();
  } else {
    cluster_arrive();
    cluster_wait();
  }

  float x = T > 0 ? __ldg(sig) : 0.0f;
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const int nxt = cur ^ 1;
    const float x_next = t + 1 < T ? __ldg(sig + t + 1) : 0.0f;
    const float f0 = sm.f0[cur][0];
    // neighbours' scores: f[st0-2], f[st0-1], b(st0-1), f[st0+SPT]
    const float* fp = sm.f[cur] + (st0 - s0);
    const float fl2 = fp[0];
    const float fl1 = fp[1];
    const float bl1 = sm.b[cur][st0 - s0];
    const float fr1 = fp[SPT + 2];

    // The end jump from the partials of this step's scores.
    float endc = 0.0f;
    int esrc = 0;
    if (end_warp) {
      Partial q = empty_partial();
      for (int i = lane; i < npart; i += 32) {
        q = merge<kViterbi>(q, Partial{red_m[cur][i], red_s[cur][i],
                                       red_i[cur][i]});
      }
      q = warp_merge<kViterbi>(q);
      endc = end_candidate<kViterbi>(q);
      esrc = q.i;
    }

    float fn[SPT], bn[SPT];
    uint8_t mf[SPT], mb[SPT];
    part = empty_partial();
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int st = st0 + k;
      const float fm1 = k >= 1 ? fo[k - 1] : fl1;
      const float fm2 = k >= 2 ? fo[k - 2] : (k == 1 ? fl1 : fl2);
      const float bm1 = k >= 1 ? bo[k - 1] : bl1;
      const float fp1 = k + 1 < SPT ? fo[k + 1] : fr1;
      float cur_f = __fadd_rn(fo[k], stay[k]);
      uint8_t mv = STAY;
      contend<kViterbi, uint8_t>(
          cur_f, mv, st >= 1 ? __fadd_rn(fm1, mp[k + 1]) : -LARGE, STEP);
      contend<kViterbi, uint8_t>(
          cur_f, mv,
          st >= 2 ? __fsub_rn(__fadd_rn(fm2, mp[k]), p.skip_pen) : -LARGE, SKIP);
      contend<kViterbi, uint8_t>(cur_f, mv, __fadd_rn(f0, sj[k]), START);
      if (st == nf - 1) {
        if (kViterbi) {
          if (endc > cur_f) {
            cur_f = endc;
            mv = END;
          }
        } else {
          cur_f = logaddexp(cur_f, endc);
        }
      }
      contend<kViterbi, uint8_t>(
          cur_f, mv, (st >= 2 && st <= npos) ? __fadd_rn(bm1, LOG_HALF) : -LARGE,
          BACK);
      float cur_b = -LARGE;
      uint8_t mvb = STAY;
      if (st >= 1 && st <= npos) {
        const float em = emission(x, loc[k], scl[k], lsc[k], p.minscore);
        cur_f = __fadd_rn(cur_f, em);
        cur_b = __fadd_rn(bo[k], LOG_HALF);
        contend<kViterbi, uint8_t>(
            cur_b, mvb, st < npos ? __fadd_rn(fp1, p.move_back_pen) : -LARGE,
            (uint8_t)1);
        cur_b = __fadd_rn(cur_b, em);
      } else {
        cur_f = __fsub_rn(cur_f, p.local_pen);
      }
      fn[k] = cur_f;
      bn[k] = cur_b;
      mf[k] = mv;
      mb[k] = mvb;
      if (st < s1) fold<kViterbi>(part, __fadd_rn(cur_f, ej[k]), st);
    }
    // Publish: locally, then what the neighbours and the end CTA read.
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int st = st0 + k;
      if (st >= s1) continue;
      fo[k] = fn[k];
      bo[k] = bn[k];
      sm.f[nxt][st - s0 + 2] = fn[k];
      sm.b[nxt][st - s0 + 1] = bn[k];
      if (st == 0) {
        for (int r = 0; r < ncta; ++r)
          cluster.map_shared_rank(sm.f0[nxt], r)[0] = fn[k];
      }
      if (c + 1 < ncta && st >= s1 - 2) {  // the right CTA's left halo
        right.f[nxt][st - s1 + 2] = fn[k];
        if (st == s1 - 1) right.b[nxt][0] = bn[k];
      }
      if (c > 0 && st == s0) left.f[nxt][per + 2] = fn[k];  // right halo
    }
    part = warp_merge<kViterbi>(part);
    if (lane == 0) {
      end_m[nxt * MAX_PARTIALS + gwarp] = part.m;
      end_s[nxt * MAX_PARTIALS + gwarp] = part.s;
      end_i[nxt * MAX_PARTIALS + gwarp] = part.i;
    }
    if (solo) {
      __syncthreads();
    } else {
      cluster_arrive();
    }
    if (kViterbi) {
      uint8_t* row = moves + (size_t)t * nstate;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int st = st0 + k;
        if (st >= s1) continue;
        row[st] = mf[k];
        if (st >= 1 && st <= npos) row[nf + st - 1] = mb[k];
      }
      if (end_warp && lane == 0) end_src[t] = esrc;
    }
    x = x_next;
    if (!solo) cluster_wait();
  }

#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int st = st0 + k;
    if (st >= s1) continue;
    final_[st] = fo[k];
    if (st >= 1 && st <= npos) final_[nf + st - 1] = bo[k];
  }
}

// The same DP on one block of GLOBAL_THREADS threads with the scores in
// a global scratch [2, nstate], for squiggles beyond the cluster's
// capacity. Thread i owns the forward states st = i, i + GLOBAL_THREADS,
// ... and with each position st also its back state st-1.
template <bool kViterbi>
__global__ void __launch_bounds__(GLOBAL_THREADS)
dtw_global_kernel(const float* __restrict__ sig, const float* __restrict__ locs,
                  const float* __restrict__ scales,
                  const float* __restrict__ logscales,
                  const float* __restrict__ move_pen,
                  const float* __restrict__ stay_pen,
                  const float* __restrict__ start_jump,
                  const float* __restrict__ end_jump, float* state,
                  float* __restrict__ final_, uint8_t* __restrict__ moves,
                  int* __restrict__ end_src, int T, int npos, DtwParams p) {
  constexpr int NWARP = GLOBAL_THREADS / 32;
  __shared__ float red_m[2][NWARP];
  __shared__ float red_s[2][NWARP];
  __shared__ int red_i[2][NWARP];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nf = npos + 2;
  const int nstate = nf + npos;
  const int end_warp = ((nf - 1) % GLOBAL_THREADS) >> 5;

  Partial part = empty_partial();
  for (int st = tid; st < nf; st += GLOBAL_THREADS) {
    const float v = st == 0 ? 0.0f : -LARGE;
    state[st] = v;
    if (st >= 1 && st <= npos) state[nf + st - 1] = -LARGE;
    fold<kViterbi>(part, __fadd_rn(v, __ldg(end_jump + st)), st);
  }
  part = warp_merge<kViterbi>(part);
  if (lane == 0) {
    red_m[0][warp] = part.m;
    red_s[0][warp] = part.s;
    red_i[0][warp] = part.i;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur_slot = t & 1;
    const float* fp = state + cur_slot * nstate;
    const float* bp = fp + nf;
    float* fn = state + (cur_slot ^ 1) * nstate;
    float* bn = fn + nf;
    uint8_t* row = kViterbi ? moves + (size_t)t * nstate : nullptr;
    const float x = __ldg(sig + t);
    const float f0 = fp[0];

    float endc = 0.0f;
    int esrc = 0;
    if (warp == end_warp) {
      Partial q{red_m[cur_slot][lane], red_s[cur_slot][lane],
                red_i[cur_slot][lane]};
      q = warp_merge<kViterbi>(q);
      endc = end_candidate<kViterbi>(q);
      esrc = q.i;
    }

    part = empty_partial();
    for (int st = tid; st < nf; st += GLOBAL_THREADS) {
      float cur = __fadd_rn(fp[st], __ldg(stay_pen + st));
      uint8_t mv = STAY;
      contend<kViterbi, uint8_t>(
          cur, mv,
          st >= 1 ? __fadd_rn(fp[st - 1], __ldg(move_pen + st - 1)) : -LARGE,
          STEP);
      contend<kViterbi, uint8_t>(
          cur, mv,
          st >= 2 ? __fsub_rn(__fadd_rn(fp[st - 2], __ldg(move_pen + st - 2)),
                              p.skip_pen)
                  : -LARGE,
          SKIP);
      contend<kViterbi, uint8_t>(cur, mv, __fadd_rn(f0, __ldg(start_jump + st)),
                                 START);
      if (st == nf - 1) {
        if (kViterbi) {
          if (endc > cur) {
            cur = endc;
            mv = END;
          }
        } else {
          cur = logaddexp(cur, endc);
        }
        if (kViterbi) end_src[t] = esrc;
      }
      contend<kViterbi, uint8_t>(
          cur, mv,
          (st >= 2 && st <= npos) ? __fadd_rn(bp[st - 2], LOG_HALF) : -LARGE,
          BACK);
      if (st >= 1 && st <= npos) {
        const int j = st - 1;  // this position's back state
        const float em =
            emission(x, __ldg(locs + j), __ldg(scales + j),
                     __ldg(logscales + j), p.minscore);
        cur = __fadd_rn(cur, em);
        float bcur = __fadd_rn(bp[j], LOG_HALF);
        uint8_t mvb = STAY;
        contend<kViterbi, uint8_t>(
            bcur, mvb,
            j < npos - 1 ? __fadd_rn(fp[j + 2], p.move_back_pen) : -LARGE,
            (uint8_t)1);
        bcur = __fadd_rn(bcur, em);
        bn[j] = bcur;
        if (kViterbi) row[nf + j] = mvb;
      } else {
        cur = __fsub_rn(cur, p.local_pen);
      }
      fn[st] = cur;
      if (kViterbi) row[st] = mv;
      fold<kViterbi>(part, __fadd_rn(cur, __ldg(end_jump + st)), st);
    }
    part = warp_merge<kViterbi>(part);
    if (lane == 0) {
      red_m[cur_slot ^ 1][warp] = part.m;
      red_s[cur_slot ^ 1][warp] = part.s;
      red_i[cur_slot ^ 1][warp] = part.i;
    }
    __syncthreads();
  }

  const float* last = state + (T & 1) * nstate;
  for (int s = tid; s < nstate; s += GLOBAL_THREADS) final_[s] = last[s];
}

// The Viterbi path from the final scores: the last position's state if it
// beats the end state, else the end state; then each earlier sample's
// state from the move that entered the later one. path [T] int32.
__global__ void dtw_walk_kernel(const float* __restrict__ final_,
                                const uint8_t* __restrict__ moves,
                                const int* __restrict__ end_src,
                                int* __restrict__ path, int T, int npos) {
  const int nf = npos + 2;
  const size_t nstate = (size_t)nf + npos;
  int cur = final_[nf - 2] > final_[nf - 1] ? nf - 2 : nf - 1;
  path[T - 1] = cur;
  for (int s = T - 1; s > 0; --s) {
    const int mv = moves[(size_t)s * nstate + cur];
    if (cur < nf) {
      cur = mv == STAY    ? cur
            : mv == STEP  ? cur - 1
            : mv == SKIP  ? cur - 2
            : mv == START ? 0
            : mv == END   ? end_src[s]
                          : nf + cur - 2;
    } else if (mv != STAY) {
      cur = cur - nf + 2;
    }
    path[s - 1] = cur;
  }
}

// The cluster kernel's dynamic shared memory.
size_t cluster_smem_bytes(int threads, int spt) {
  return sizeof(float) * 2 * (size_t)(2 * threads * spt + 5);
}

template <bool kViterbi, int SPT>
cudaError_t cluster_config(int ncta, int threads, int per,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           cudaStream_t stream) {
  const size_t smem = cluster_smem_bytes(threads, SPT);
  auto kernel = dtw_cluster_kernel<kViterbi, SPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (ncta > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ncta);
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

template <bool kViterbi, int SPT>
cudaError_t launch_cluster(const float* sig, const float* locs,
                           const float* scales, const float* logscales,
                           const float* move_pen, const float* stay_pen,
                           const float* start_jump, const float* end_jump,
                           float* final_, uint8_t* moves, int* end_src, int T,
                           int npos, int ncta, int threads, int per,
                           DtwParams p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      cluster_config<kViterbi, SPT>(ncta, threads, per, cfg, attr, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, dtw_cluster_kernel<kViterbi, SPT>, sig, locs,
                            scales, logscales, move_pen, stay_pen, start_jump,
                            end_jump, final_, moves, end_src, T, npos, per, p);
}

template <bool kViterbi, int SPT>
int max_clusters(int ncta, int threads, int per) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<kViterbi, SPT>(ncta, threads, per, cfg, attr,
                                                  nullptr);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, dtw_cluster_kernel<kViterbi, SPT>,
                                       &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

bool valid_layout(int npos, int ncta, int threads, int per, int spt) {
  const int nf = npos + 2;
  return ncta >= 1 && ncta <= MAX_CLUSTER && threads >= 32 &&
         threads <= CLUSTER_THREADS && threads % 32 == 0 && per >= 2 &&
         per % spt == 0 &&
         (long)threads * spt >= per && (long)(ncta - 1) * per < nf &&
         (long)ncta * per >= nf;
}

}  // namespace

extern "C" {

// The squiggle-match DP of one read. With ncta > 0 the cluster kernel
// (layout ncta, threads, per, spt from ops/dtw.py:cluster_layout), else
// the global-state kernel on `scratch` [2, nstate]. moves and end_src are
// written for Viterbi and may be null for the forward variant.
int scrappie_dtw(const float* sig, const float* locs, const float* scales,
                 const float* logscales, const float* move_pen,
                 const float* stay_pen, const float* start_jump,
                 const float* end_jump, float* scratch, float* final_,
                 uint8_t* moves, int* end_src, int T, int npos, float skip_pen,
                 float local_pen, float minscore, float move_back_pen,
                 int viterbi, int ncta, int threads, int per, int spt,
                 cudaStream_t stream) {
  const DtwParams p{skip_pen, local_pen, minscore, move_back_pen};
  if (ncta == 0) {
    if (viterbi) {
      dtw_global_kernel<true><<<1, GLOBAL_THREADS, 0, stream>>>(
          sig, locs, scales, logscales, move_pen, stay_pen, start_jump,
          end_jump, scratch, final_, moves, end_src, T, npos, p);
    } else {
      dtw_global_kernel<false><<<1, GLOBAL_THREADS, 0, stream>>>(
          sig, locs, scales, logscales, move_pen, stay_pen, start_jump,
          end_jump, scratch, final_, moves, end_src, T, npos, p);
    }
    return (int)cudaGetLastError();
  }
  if (!valid_layout(npos, ncta, threads, per, spt))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return (int)fn(sig, locs, scales, logscales, move_pen, stay_pen,
                   start_jump, end_jump, final_, moves, end_src, T, npos,
                   ncta, threads, per, p, stream);
  };
  switch (spt * 2 + (viterbi ? 1 : 0)) {
    case 3: return go(launch_cluster<true, 1>);
    case 2: return go(launch_cluster<false, 1>);
    case 5: return go(launch_cluster<true, 2>);
    case 4: return go(launch_cluster<false, 2>);
    case 9: return go(launch_cluster<true, 4>);
    case 8: return go(launch_cluster<false, 4>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters for the cluster kernel at this layout:
// how many such clusters the card can hold at once (0: none fits), or
// minus a CUDA error.
int scrappie_dtw_max_clusters(int viterbi, int ncta, int threads, int per,
                              int spt) {
  switch (spt * 2 + (viterbi ? 1 : 0)) {
    case 3: return max_clusters<true, 1>(ncta, threads, per);
    case 2: return max_clusters<false, 1>(ncta, threads, per);
    case 5: return max_clusters<true, 2>(ncta, threads, per);
    case 4: return max_clusters<false, 2>(ncta, threads, per);
    case 9: return max_clusters<true, 4>(ncta, threads, per);
    case 8: return max_clusters<false, 4>(ncta, threads, per);
    default: return -(int)cudaErrorInvalidValue;
  }
}

int scrappie_dtw_walk(const float* final_, const uint8_t* moves,
                      const int* end_src, int* path, int T, int npos,
                      cudaStream_t stream) {
  if (T == 0) return (int)cudaSuccess;
  dtw_walk_kernel<<<1, 1, 0, stream>>>(final_, moves, end_src, path, T, npos);
  return (int)cudaGetLastError();
}

}  // extern "C"
