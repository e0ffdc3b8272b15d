// Signal-to-squiggle alignment: the DP forward pass over the raw samples of
// one read, Viterbi (with an int32 traceback) or forward (log-sum-exp).
//
// Replaces scrappie_tpu/ops/dtw.py:_dtw_kernel (wrapper squiggle_match_tm,
// scrappie_torch/ops/dtw.py), whose lax.scan program
// scrappie_tpu/decode/dtw.py:_squiggle_match gives the order of operations.
// States: forward states [start | npos positions | end] (nf = npos + 2),
// then npos back states (nstate = 2 npos + 2). Per sample x:
//   forward state st, candidates in this order:
//     stay   f[st] + stay_pen[st]                         tb st
//     step   f[st-1] + move_pen[st-1]                     tb st-1
//     skip   (f[st-2] + move_pen[st-2]) - skip_pen        tb st-2
//     start  f[0] + start_jump[st]                        tb 0
//     end    (st = nf-1 only) max over st' of f[st'] + end_jump[st'],
//            from its first argmax
//     back   b[st-2] + log(1/2), 2 <= st <= npos          tb nf + st-2
//   back state j: b[j] + log(1/2) (tb nf+j), then f[j+2] + log(prob_back)
//   for j < npos-1 (tb j+2);
//   then positions add max(-minscore, (-|x-loc|/scale - logscale) - log 2)
//   and start and end subtract local_pen.
// Out-of-range candidates are -1e30, as in the scan. Viterbi takes a
// candidate only if strictly greater; the forward variant combines by
// jnp.logaddexp's formula (max + log1p(exp(-|a-b|)), and a+b where a-b is
// NaN, so -inf with -inf stays -inf) and takes the end jump by
// jax.nn.logsumexp's. Every addition is an explicit __fadd_rn/__fsub_rn in
// the scan's order, so the Viterbi scores and traceback are identical bit
// for bit to the plain twin (ops/dtw.py:squiggle_match_plain); the forward
// variant's expf/log1pf differ from the host's by ulps.
//
// What bounds it on the H100: latency. The DP is sequential in the
// samples (10^4 to 10^5 a read), and each step needs all of the previous
// step's scores: a block-wide barrier per sample, plus the end jump's
// reduction over all nf scores. The traceback, 4 (2 npos + 2) bytes per
// sample (2.9 GB for 60 000 samples against 6 000 positions), is the only
// large traffic, and one SM writes it far below the card's bandwidth.
//
// Design: one block of 1024 threads per call (one read, as in JAX). Thread
// i owns the forward states st = i, i + 1024, ... and with each position
// st also its back state st-1, so one emission serves both and a warp
// writes 32 consecutive traceback entries. The scores live in shared memory
// double-buffered ([2][nstate] floats, up to DTW_MAX_SHARED_NPOS = 14 463
// positions in 227 KB), or, for longer squiggles, in a global scratch of the
// same layout (the template switch kShared; block-local, so the barrier
// orders it too). The end jump's reduction is taken where the scores are
// made: each thread folds f + end_jump over its new scores into a running
// (max, first index) or (max, sum of exp), a warp shuffle merges them, and
// each warp writes its partial; the warp that owns the end state merges the
// 32 partials at the next step. So a step needs one __syncthreads. The
// per-position constants are read through the read-only cache; the TPU's
// lane rolls, 128-lane padding and time padding are gone (exactly T steps).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float LARGE = 1.0e30f;
constexpr float LOG_HALF = -0.693147182464599609375f;  // float32(log(0.5))
constexpr float LOG2 = 0.693147182464599609375f;       // float32(log(2))
constexpr int THREADS = 1024;
constexpr int NWARP = THREADS / 32;

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
template <bool kViterbi>
__device__ __forceinline__ void contend(float& cur, int& tb, float cand,
                                        int ctb) {
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
    Partial q;
    q.m = __shfl_xor_sync(0xffffffffu, p.m, off);
    q.s = __shfl_xor_sync(0xffffffffu, p.s, off);
    q.i = __shfl_xor_sync(0xffffffffu, p.i, off);
    p = merge<kViterbi>(p, q);
  }
  return p;
}

// Floored Laplace log emission of sample x at one position.
__device__ __forceinline__ float emission(float x, float loc, float scale,
                                          float logscale, float minscore) {
  const float e = __fsub_rn(
      __fsub_rn(__fdiv_rn(-fabsf(__fsub_rn(x, loc)), scale), logscale), LOG2);
  return fmaxf(-minscore, e);
}

// sig [T]; locs/scales/logscales [npos]; move/stay_pen, start/end_jump
// [nf] -> final [nstate], tb [T, nstate] int32 (Viterbi; may be null).
// scratch [2, nstate] holds the scores when !kShared.
template <bool kViterbi, bool kShared>
__global__ void __launch_bounds__(THREADS)
dtw_kernel(const float* __restrict__ sig, const float* __restrict__ locs,
           const float* __restrict__ scales,
           const float* __restrict__ logscales,
           const float* __restrict__ move_pen,
           const float* __restrict__ stay_pen,
           const float* __restrict__ start_jump,
           const float* __restrict__ end_jump, float* scratch,
           float* __restrict__ final_, int* __restrict__ tb, int T, int npos,
           DtwParams p) {
  extern __shared__ float smem[];
  __shared__ float red_m[2][NWARP];
  __shared__ float red_s[2][NWARP];
  __shared__ int red_i[2][NWARP];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nf = npos + 2;
  const int nstate = nf + npos;
  float* state = kShared ? smem : scratch;
  const int end_warp = ((nf - 1) % THREADS) >> 5;

  // Initial scores: start 0, everything else -1e30; and the end-jump
  // partials of those scores, in slot 0.
  Partial part = empty_partial();
  for (int st = tid; st < nf; st += THREADS) {
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
    int* tbrow = tb == nullptr ? nullptr : tb + (size_t)t * nstate;
    const float x = __ldg(sig + t);
    const float f0 = fp[0];

    // The end jump from the partials of this step's scores.
    float endc = 0.0f;
    int esrc = 0;
    if (warp == end_warp) {
      Partial q{red_m[cur_slot][lane], red_s[cur_slot][lane],
                red_i[cur_slot][lane]};
      q = warp_merge<kViterbi>(q);
      if (kViterbi) {
        endc = q.m;
        esrc = q.i;
      } else {
        const float m = isfinite(q.m) ? q.m : 0.0f;
        const float s = isfinite(q.m) ? q.s : q.s * expf(q.m - m);
        endc = __fadd_rn(logf(s), m);
      }
    }

    part = empty_partial();
    for (int st = tid; st < nf; st += THREADS) {
      float cur = __fadd_rn(fp[st], __ldg(stay_pen + st));
      int tbv = st;
      contend<kViterbi>(
          cur, tbv, st >= 1 ? __fadd_rn(fp[st - 1], __ldg(move_pen + st - 1))
                            : -LARGE,
          st - 1);
      contend<kViterbi>(
          cur, tbv,
          st >= 2 ? __fsub_rn(__fadd_rn(fp[st - 2], __ldg(move_pen + st - 2)),
                              p.skip_pen)
                  : -LARGE,
          st - 2);
      contend<kViterbi>(cur, tbv, __fadd_rn(f0, __ldg(start_jump + st)), 0);
      if (st == nf - 1) {
        if (kViterbi) {
          if (endc > cur) {
            cur = endc;
            tbv = esrc;
          }
        } else {
          cur = logaddexp(cur, endc);
        }
      }
      contend<kViterbi>(
          cur, tbv,
          (st >= 2 && st <= npos) ? __fadd_rn(bp[st - 2], LOG_HALF) : -LARGE,
          nf + st - 2);
      if (st >= 1 && st <= npos) {
        const int j = st - 1;  // this position's back state
        const float em =
            emission(x, __ldg(locs + j), __ldg(scales + j),
                     __ldg(logscales + j), p.minscore);
        cur = __fadd_rn(cur, em);
        float bcur = __fadd_rn(bp[j], LOG_HALF);
        int btb = nf + j;
        contend<kViterbi>(
            bcur, btb,
            j < npos - 1 ? __fadd_rn(fp[j + 2], p.move_back_pen) : -LARGE,
            j + 2);
        bcur = __fadd_rn(bcur, em);
        bn[j] = bcur;
        if (tbrow != nullptr) tbrow[nf + j] = btb;
      } else {
        cur = __fsub_rn(cur, p.local_pen);
      }
      fn[st] = cur;
      if (tbrow != nullptr) tbrow[st] = tbv;
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
  for (int s = tid; s < nstate; s += THREADS) final_[s] = last[s];
}

template <bool kViterbi, bool kShared>
cudaError_t launch(const float* sig, const float* locs, const float* scales,
                   const float* logscales, const float* move_pen,
                   const float* stay_pen, const float* start_jump,
                   const float* end_jump, float* scratch, float* final_,
                   int* tb, int T, int npos, DtwParams p,
                   cudaStream_t stream) {
  const size_t smem = kShared ? sizeof(float) * 2 * (size_t)(2 * npos + 2) : 0;
  if (kShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        dtw_kernel<kViterbi, kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dtw_kernel<kViterbi, kShared><<<1, THREADS, smem, stream>>>(
      sig, locs, scales, logscales, move_pen, stay_pen, start_jump, end_jump,
      scratch, final_, tb, T, npos, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int scrappie_dtw(const float* sig, const float* locs, const float* scales,
                 const float* logscales, const float* move_pen,
                 const float* stay_pen, const float* start_jump,
                 const float* end_jump, float* scratch, float* final_,
                 int* tb, int T, int npos, float skip_pen, float local_pen,
                 float minscore, float move_back_pen, int viterbi, int shared,
                 cudaStream_t stream) {
  const DtwParams p{skip_pen, local_pen, minscore, move_back_pen};
  auto go = [&](auto fn) {
    return (int)fn(sig, locs, scales, logscales, move_pen, stay_pen,
                   start_jump, end_jump, scratch, final_, tb, T, npos, p,
                   stream);
  };
  if (viterbi) {
    return shared ? go(launch<true, true>) : go(launch<true, false>);
  }
  return shared ? go(launch<false, true>) : go(launch<false, false>);
}

}  // extern "C"
