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
// their back states.
//
// dtw_walk_kernel follows the moves back from the final state (no TPU
// kernel: the host walk of scrappie_tpu/decode/dtw.py:squiggle_match_viterbi;
// wrapper dtw_walk, twin dtw_walk_plain in scrappie_torch/ops/dtw.py), and
// only the path [T] int32 leaves the card. What bounds it: latency. A
// sample's move decides which byte of the next (earlier) row to read, and
// the rows are 2 npos + 2 bytes apart (12 002 at 6 000 positions), so a
// walk that reads the plane itself waits a device-memory round trip a
// sample (about 180 ns, with one thread walking); the bound, a byte a
// sample and the path, is 0.0001 ms. The floor of this design is a
// sample's chain: a shared-memory load of its byte and one add.
//
// Design: two warps, one walking, one copying. The walk's forward state
// moves down by 0 to 2 columns a sample (about 0.1 on a read), except
// START (to 0) and END (to end_src[s]); a back state sits at nf + c - 2
// beside its forward column c. So a window of WALK_ROWS rows keeps, a row,
// the WALK_SPAN forward states up to the walk's column and the WALK_SPAN
// back states beside them, in shared memory, each piece as the 7 16-byte
// pieces that enclose it at the row's alignment (rows are not 16-byte
// aligned: the back piece's copy lands at 112 or 128 bytes into the row so
// that both pieces share one index, the walk's `L`: forward state ff + L
// for L < WALK_SPAN, back state ff + nf - 2 + L - gap from gap = 112 +
// npos % 16 on). The walker warp walks with every lane (the same values;
// lane 0 writes the path). A forward state's stays and steps go WALK_BATCH
// rows a check: each row's byte is loaded at the L the byte before leads
// to, so the chain is the load and an add, and one test of the batch's
// bytes follows (a batch with another byte is walked a row at a time); a
// back state's stays take a loop of their own. Any other move takes a
// general step by a __byte_perm table of the moves' index changes (to the
// back state +gap, back to the forward state -gap, skip -2); START, END, a
// move that leaves the window and any byte no DP writes take an exact step
// as the one-thread walk took it (the row's byte read as the flat address
// s (2 npos + 2) + state, END reading end_src[s]). At row WALK_AHEAD of a
// window the walker asks the copier warp, through a named barrier, for the
// next window anchored at the walk's column then; the copier fills the
// other buffer (cp.async, a row a lane at a time) while the walk goes on,
// and signals through a second barrier, which the walker waits for at the
// window's end. A window whose anchor misses the walk, and any jump out of
// the window, loads a window anchored at the walk's state on the walker
// and waits for it. Pieces that leave the plane are copied a byte at a
// time, within it. (Splitting the walk in time, as the transducer's
// backtrace does, would need each segment's map over all 12 002 states: a
// read of the whole 0.72 GB plane at the least, 0.215 ms, and 7.2e8
// dependent byte loads spread over the card.)
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
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

constexpr int WALK_ROWS = 256;   // rows (samples) a window holds
constexpr int WALK_SPAN = 96;    // forward states, and back states, a row
constexpr int WALK_PIECES = 7;   // 16-byte pieces that enclose a span
constexpr int WALK_PITCH = 256;  // a row: forward pieces, back ones at 112|128
constexpr int WALK_AHEAD = 160;  // the window's row that starts the next copy
constexpr uint32_t WALK_BIAS = 0x80808080u;
constexpr int WALK_BATCH = 8;    // forward stays and steps a check
constexpr int WALK_PAD = 2304;   // bytes around the windows, for look-aheads

// The named barriers between the walking warp and the copying warp: a
// request (the walker arrives, the copier waits) and its copy done (the
// copier arrives, the walker waits).
constexpr int BAR_REQUEST = 1;
constexpr int BAR_DONE = 2;

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_signal(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u8(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// byte b of the 8 bytes {y, x} (bytes 0-3 of x first), for b < 8
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t b) {
  uint32_t v;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(v) : "r"(x), "r"(y), "r"(b));
  return v;
}

// Copy the WALK_PIECES 16-byte pieces that enclose [a, a + WALK_SPAN) of
// the plane [first, last) to dst: by cp.async where they lie inside the
// plane (one branch for the seven), else the bytes inside it one at a
// time.
__device__ __forceinline__ void walk_pieces(uint8_t* dst, long long a,
                                           long long first, long long last) {
  const long long a0 = a & ~15LL;
  if (a0 >= first && a0 + 16 * WALK_PIECES <= last) {
#pragma unroll
    for (int c = 0; c < WALK_PIECES; ++c)
      __pipeline_memcpy_async(dst + 16 * c,
                              reinterpret_cast<const void*>(a0 + 16 * c), 16);
    return;
  }
  for (int k = 0; k < 16 * WALK_PIECES; ++k)
    if (a0 + k >= first && a0 + k < last)
      dst[k] = *reinterpret_cast<const uint8_t*>(a0 + k);
}

// The Viterbi path from the final scores: the last position's state if it
// beats the end state, else the end state; then each earlier sample's
// state from the move that entered the later one. path [T] int32. Two
// warps, the walker and the copier of the next window; dynamic shared
// memory: two windows [WALK_ROWS][WALK_PITCH] between pads of WALK_PAD
// bytes.
__global__ void __launch_bounds__(64)
dtw_walk_kernel(const float* __restrict__ final_,
                const uint8_t* __restrict__ moves,
                const int* __restrict__ end_src, int* __restrict__ path,
                int T, int npos) {
  extern __shared__ __align__(16) uint8_t wsm[];
  __shared__ long long req_ff;  // the copier's request: window, buffer
  __shared__ int req_top, req_buf;
  const int lane = threadIdx.x & 31;
  const bool copier = threadIdx.x >= 32;
  const int nf = npos + 2;
  const long long nstate = (long long)nf + npos;
  const int nmod = (int)(nstate & 15);
  const int r = npos & 15;        // (nf - 2) % 16
  const int gap = 112 + r;        // L of the first back state
  const int limit = gap + WALK_SPAN;
  const long long first = (long long)reinterpret_cast<uintptr_t>(moves);
  const long long last = first + (long long)T * nstate;
  // __byte_perm tables, byte b = the move: 0x80 + the change of L (0x80
  // where the move takes the exact step); bytes 1-3 of the result are
  // byte 0, stay's 0x80, so perm - WALK_BIAS is the signed change.
  const uint32_t fx = 0x80u | 0x7Fu << 8 | 0x7Eu << 16 | 0x80u << 24;
  const uint32_t fy = 0x80u | (0x80u + gap) << 8 | 0x80u << 16 | 0x80u << 24;
  const uint32_t bk = 0x80u - gap;
  const uint32_t bx = 0x80u | bk << 8 | bk << 16 | bk << 24;
  const uint32_t by = bk * 0x01010101u;

  // the forward span's first state of a window anchored at a state
  auto anchor = [&](int st) -> long long {
    return (long long)(st < nf ? st : st - nf + 2) - (WALK_SPAN - 1);
  };
  // L of a state in a window anchored at ff, or -1
  auto locate = [&](int st, long long ff) -> int {
    const long long kf = (long long)st - ff;
    if (st < nf) return kf >= 0 && kf < WALK_SPAN ? (int)kf : -1;
    const long long kb = kf - (nf - 2);
    return kb >= 0 && kb < WALK_SPAN ? gap + (int)kb : -1;
  };
  // row i (sample wtop - i) of the window (b, wtop, ff), if it is read
  auto copy_row = [&](int b, int wtop, long long ff, int i) {
    const int row = wtop - i;
    if (i >= WALK_ROWS || row < 1) return;
    const long long af = first + (long long)row * nstate + ff;
    uint8_t* dst = wsm + WALK_PAD + ((size_t)b * WALK_ROWS + i) * WALK_PITCH;
    walk_pieces(dst, af, first, last);
    walk_pieces(dst + ((int)(af & 15) + r >= 16 ? 128 : 112), af + nf - 2,
                first, last);
  };
  auto load = [&](int b, int wtop, long long ff) {
    __syncwarp();
    for (int j = 0; j < WALK_ROWS / 32; ++j) copy_row(b, wtop, ff, 32 * j + lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
  };

  if (copier) {  // warp 1: each request's window, then done
    for (;;) {
      bar_wait(BAR_REQUEST);
      const int wtop = req_top;
      if (wtop < 0) return;
      for (int q = 0; q < WALK_ROWS / 32; ++q)
        copy_row(req_buf, wtop, req_ff, 32 * q + lane);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      bar_signal(BAR_DONE);
    }
  }
  // warp 0, the walker
  bool pending = false;  // a request whose done is not yet waited for
  auto finish = [&] {
    if (pending) bar_wait(BAR_DONE);
    if (lane == 0) req_top = -1;
    __syncwarp();
    bar_signal(BAR_REQUEST);
  };
  int cur = final_[nf - 2] > final_[nf - 1] ? nf - 2 : nf - 1;
  if (lane == 0) path[T - 1] = cur;
  int s = T - 1;  // path[s] = cur is written; row s gives path[s-1]
  if (s == 0) {
    finish();
    return;
  }
  const unsigned smem_base =
      (unsigned)__cvta_generic_to_shared(wsm) + WALK_PAD;
  int buf = 0;
  int top = s;
  long long ff = anchor(cur);
  load(buf, top, ff);
  int L = locate(cur, ff);
  int i = 0;           // s = top - i
  int next_top = -1;   // the other buffer holds (next_top, next_ff)
  long long next_ff = 0;
  for (;;) {
    const int rows = top - max(top - WALK_ROWS + 1, 1) + 1;  // rows to walk
    // the next window, not yet asked for
    const bool ahead = top - WALK_ROWS >= 1 && next_top != top - WALK_ROWS;
    // The walk runs up to the row where the next window's copy starts (an
    // exact step may have passed it), or the window's last row; a byte it
    // cannot take ends it early.
    const int stop = ahead ? max(WALK_AHEAD, i) : rows;
    // the shared address of the walk's j-th row from here, at its L = 0
    const unsigned rows0 = smem_base + (unsigned)((buf * WALK_ROWS + i) * WALK_PITCH);
    const int off0 = (int)((first + (long long)s * nstate + ff) & 15);
    auto row = [&](int j) {
      return rows0 + (unsigned)(j * WALK_PITCH + ((off0 - j * nmod) & 15));
    };
    const int fwd_base = (int)ff;
    const int back_base = (int)(ff + (nf - 2) - gap);
    // Stays and steps of a forward state and stays of a back state take
    // loops whose chain is the byte's load and one add: each step loads
    // the next row's byte at the L it leads to before it checks its own
    // move (a rejected L, down to WALK_BATCH x 255 below a row, reads a
    // byte within the pads around the windows, never used). Any other
    // byte takes one general step, by the table, then the loops again;
    // START, END, bytes no DP writes (forward 3, 4, 6, 7, any 8 and up), a
    // move to the back state of forward state 0 or 1, which the one-thread
    // walk read as a forward state, and a move out of the window end the
    // walk in this window at that byte.
    int* out = path + s - 1;  // where the next state goes
    int j = 0;                // rows walked since rows0
    uint32_t b = ld_shared_u8(row(0) + L);
    bool exact = false;
    auto take = [&](int st) {
      if (lane == 0) *out = st;
      --out;
      cur = st;
      --s;
      ++i;
      ++j;
    };
    while (i < stop) {
      // a forward state's stays and steps, WALK_BATCH rows a check: the
      // bytes' loads chain with an add each, and the batch's check waits
      // for the last (a batch with any other byte is walked a row at a
      // time)
      while (L < gap && i + WALK_BATCH <= stop) {
        int Lk[WALK_BATCH + 1];
        uint32_t bb[WALK_BATCH + 1];
        Lk[0] = L;
        bb[0] = b;
#pragma unroll
        for (int k = 1; k <= WALK_BATCH; ++k) {
          Lk[k] = Lk[k - 1] - (int)bb[k - 1];
          bb[k] = ld_shared_u8(row(j + k) + Lk[k]);
        }
        uint32_t any = 0;
#pragma unroll
        for (int k = 0; k < WALK_BATCH; ++k) any |= bb[k];
        if (!((any <= 1) & (Lk[WALK_BATCH] >= 0))) break;
        if (lane == 0) {
#pragma unroll
          for (int k = 1; k <= WALK_BATCH; ++k) out[1 - k] = fwd_base + Lk[k];
        }
        out -= WALK_BATCH;
        s -= WALK_BATCH;
        i += WALK_BATCH;
        j += WALK_BATCH;
        L = Lk[WALK_BATCH];
        b = bb[WALK_BATCH];
        cur = fwd_base + L;
      }
      if (i == stop) break;
      if (L < gap) {
        for (;;) {  // a forward state: stay or step
          const int Ln = L - (int)b;
          const uint32_t bn = ld_shared_u8(row(j + 1) + Ln);
          if (!((b <= 1) & (Ln >= 0))) break;
          take(fwd_base + Ln);
          L = Ln;
          b = bn;
          if (i == stop) break;
        }
      } else {
        for (;;) {  // a back state: stay
          const uint32_t bn = ld_shared_u8(row(j + 1) + L);
          if (b != 0) break;
          take(back_base + L);
          b = bn;
          if (i == stop) break;
        }
      }
      if (i == stop) break;
      // the general step, by the table
      const bool fwd = L < gap;
      const int Ln = L + (int)(prmt(fwd ? fx : bx, fwd ? fy : by, b) - WALK_BIAS);
      const bool special =
          (b >= 8) | (fwd & ((((0xD8u >> (b & 7)) & 1) != 0) |
                             ((b == 5) & (fwd_base + L < 2))));
      if (special | ((unsigned)Ln >= (unsigned)limit)) {
        exact = true;
        break;
      }
      take(Ln < gap ? fwd_base + Ln : back_base + Ln);
      L = Ln;
      if (i < stop) b = ld_shared_u8(row(j) + L);
    }
    if (exact) {
      // the step as the one-thread walk takes it from the byte at row s
      if (cur < nf) {
        cur = b == STAY    ? cur
              : b == STEP  ? cur - 1
              : b == SKIP  ? cur - 2
              : b == START ? 0
              : b == END   ? end_src[s]
                           : nf + cur - 2;
      } else if (b != STAY) {
        cur = cur - nf + 2;
      }
      --s;
      ++i;
      if (lane == 0) path[s] = cur;
    } else if (ahead) {
      // the next window, anchored at the walk's column now, into the
      // other buffer by the copier while this one is walked (a dropped
      // request's done is waited for first)
      next_top = top - WALK_ROWS;
      next_ff = anchor(cur);
      if (pending) bar_wait(BAR_DONE);
      if (lane == 0) {
        req_top = next_top;
        req_ff = next_ff;
        req_buf = buf ^ 1;
      }
      __syncwarp();
      bar_signal(BAR_REQUEST);
      pending = true;
      continue;
    }
    if (s == 0) break;
    if (i < rows) {
      L = locate(cur, ff);
      if (L >= 0) continue;  // the exact step stayed in the window
    } else if (next_top == s) {
      // the walk reached the prefetched window
      bar_wait(BAR_DONE);
      pending = false;
      buf ^= 1;
      top = next_top;
      ff = next_ff;
      i = 0;
      next_top = -1;
      L = locate(cur, ff);
      if (L >= 0) continue;
    }
    // a window anchored at the walk's state (the prefetch is dropped)
    next_top = -1;
    top = s;
    ff = anchor(cur);
    i = 0;
    load(buf, top, ff);
    L = locate(cur, ff);
  }
  finish();
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
  // two windows between pads, which a step's look-ahead may read
  const size_t smem = 2 * WALK_PAD + 2 * (size_t)WALK_ROWS * WALK_PITCH;
  const cudaError_t err = cudaFuncSetAttribute(
      dtw_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dtw_walk_kernel<<<1, 64, smem, stream>>>(final_, moves, end_src, path, T, npos);
  return (int)cudaGetLastError();
}

}  // extern "C"
