// CRF decoding for the rnnrf head: the Viterbi forward pass, the backtrace
// and the log partition function.
//
// Replaces, in scrappie_tpu/ops/crf.py:
//   _crf_fwd_kernel   wrapper crf_viterbi_scores_tm   (crf_fwd_kernel)
//   _crf_bt_kernel    wrapper crf_backtrace_tm        (crf_backtrace_kernel)
// and, with no TPU kernel of its own, the lax.scan of
// scrappie_tpu/nn/layers.py:crf_partition_function (wrapper
// crf_partition_tm, crf_partition_kernel), which globalnorm runs on every
// rnnrf path.
//
// Five states {A, C, G, T, blank}; transitions trans[t, b, to*5 + from],
// fp32, time-major [T, B, 25]. Scores start at 0. Per step t and state to:
//   forward    best = tr[to*5+0] + prev[0]; for from = 1..4 the candidate
//              tr[to*5+from] + prev[from] is taken only if strictly
//              greater; tb[t, to, b] = the `from` taken (int8);
//   partition  x_from = tr[to*5+from] + prev[from],
//              prev'[to] = m + log(sum_from exp(x_from - m)), m = max x_from
//              (0 where m is not finite); logZ = the same over the last
//              scores.
// The forward's additions and tie rule are those of
// scrappie_tpu/decode/crf.py:_crf_viterbi (argmax = first max), so finals
// and tracebacks are identical bit for bit to the plain twins. The
// partition function uses accurate expf/logf (no fast math), which differ
// from the host's by a few ulps; its twin holds it to a relative 1e-5.
//
// Layouts: final [B, 5] f32; tb [T, 5, B] int8, batch innermost (the TPU
// kernel's [T, 8, B] without its padding rows), so the backtrace reads a
// warp's rows coalesced; path [B, T+1] int32; logZ [B] f32.
//
// What bounds the forward and the partition on the H100: the latency of
// one step. A row is a chain of T dependent steps, and the engine's rows
// are few (B = 8 in fast mode, 1-2 whole reads of up to 31 744 blocks in a
// stitch group), so bandwidth (100 B a row and step) and arithmetic are
// far away; a call costs T times the dependent latency of a step. Measured
// on an H100 at 1980 MHz (chip_smoke.py, phase crf_kernels and --ab), a
// step takes about 92 cycles in the forward and 276 in the partition at
// T = 31 744, B = 2 (145 and 329 at T = 5000, B = 64, where the loads
// wait: a deeper ring or an L2 prefetch gains about 10% there); the
// one-thread-a-row kernels this design replaced took about 600 and 960 at
// B = 2.
//
// Design: five lanes a row, one per `to` state, six rows a warp (lanes
// 30-31 and the rows past B repeat the last row and store nothing), one
// warp a block, so B = 64 spreads over 11 SMs. Lane `to` adds its five
// transitions to the five previous scores and reduces them: the forward
// takes their maximum (a 3-deep fmaxf tree) and, off the chain, the first
// `from` whose candidate equals it, which is the sequential strict-`>`
// rule for inputs without NaN (no candidate is -0: the scores start at +0);
// the partition takes their logsumexp (5 expf and 1 logf a lane). The
// row's five lanes then trade their new scores with five __shfl_sync, so
// every lane holds all of `prev`. The one-thread-a-row kernels did 25 adds
// and 20 compares (25 expf, 5 logf) a step in one lane. Each lane reads
// only its own 20 contiguous bytes a step (a warp's six rows: 600
// contiguous bytes), so there is no shared-memory ring and no barrier:
// plain loads fill a ring in registers DEPTH steps ahead, off the chain
// (a ring of 20 or 24 steps gained at most 5% at B = 8 and 2 and took all
// 255 registers of a thread). The rows of a block are one step's 600 bytes apart from
// the next step's, so TMA would only replace these five loads. The
// traceback bytes are stored as they come, one byte a lane and step, off
// the chain.
//
// The backtrace runs one thread per row and loads the traceback bytes of
// UNROLL steps, which do not depend on the walk, before it walks them.
#include <cuda_runtime.h>

namespace {

constexpr int NS = 5;
constexpr int NTR = NS * NS;
constexpr int WARP = 32;
constexpr int ROWS_PER_WARP = 6;  // five lanes a row: 30 of 32 lanes live
constexpr int DEPTH = 16;         // steps of transitions in flight
constexpr int BT_ROWS = 32;       // backtrace rows per block: one warp
constexpr int UNROLL = 8;         // backtrace steps loaded ahead
constexpr unsigned FULL = 0xffffffffu;

// What a lane of the forward and partition kernels owns: state `to` of
// batch row b (clamped to B-1 for the lanes that store nothing), whose
// five lanes start at `first`.
struct RowLane {
  int to, first, b;
  bool live;
};

__device__ __forceinline__ RowLane row_lane(int B) {
  const int lane = threadIdx.x;
  const int r = lane / NS;
  const int b = blockIdx.x * ROWS_PER_WARP + r;
  return {lane - r * NS, r * NS, min(b, B - 1), r < ROWS_PER_WARP && b < B};
}

__device__ __forceinline__ void load5(float (&v)[NS], const float* p) {
#pragma unroll
  for (int f = 0; f < NS; ++f) v[f] = __ldg(p + f);
}

// Every lane of the row gets the row's five new scores.
__device__ __forceinline__ void trade(float (&prev)[NS], float mine,
                                      int first) {
#pragma unroll
  for (int s = 0; s < NS; ++s) prev[s] = __shfl_sync(FULL, mine, first + s);
}

// logsumexp of five values, as jax.nn.logsumexp and torch.logsumexp take
// it: a maximum that is not finite is replaced by 0.
__device__ __forceinline__ float lse5(const float (&x)[NS]) {
  float m = fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])), x[4]);
  if (!isfinite(m)) m = 0.0f;
  float e[NS];
#pragma unroll
  for (int f = 0; f < NS; ++f) e[f] = expf(__fsub_rn(x[f], m));
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(e[0], e[1]),
                                      __fadd_rn(e[2], e[3])), e[4]);
  return __fadd_rn(logf(s), m);
}

// The step loop both kernels share: Step(tr, prev, t, real) -> this
// lane's new score, from its five transitions tr[from] = trans[t, b,
// to*5 + from]. The loop runs T rounded up to DEPTH steps, so that every
// load is issued unconditionally (a guarded load made each step wait for
// it); a step past T (real = false) takes the identity transitions (-0
// from `to` itself, -inf from the others), which leave both recurrences'
// scores unchanged bit for bit.
template <class Step>
__device__ __forceinline__ void run_steps(const float* __restrict__ trans,
                                          int T, int B, const RowLane& l,
                                          float (&prev)[NS], Step step) {
  if (T == 0) return;
  const size_t stride = (size_t)B * NTR;
  const float* src = trans + (size_t)l.b * NTR + l.to * NS;
  const int last = T - 1;
  float ring[DEPTH][NS];
#pragma unroll
  for (int u = 0; u < DEPTH; ++u)
    load5(ring[u], src + (size_t)min(u, last) * stride);
  const float minus_inf = __int_as_float(0xff800000);
  for (int t0 = 0; t0 < T; t0 += DEPTH) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int t = t0 + u;
      const bool real = t < T;
      float tr[NS];
#pragma unroll
      for (int f = 0; f < NS; ++f)
        tr[f] = real ? ring[u][f] : (f == l.to ? -0.0f : minus_inf);
      load5(ring[u], src + (size_t)min(t + DEPTH, last) * stride);
      trade(prev, step(tr, prev, t, real), l.first);
    }
  }
}

// trans [T, B, 25] -> final [B, 5], tb [T, 5, B] int8.
__global__ void __launch_bounds__(WARP)
crf_fwd_kernel(const float* __restrict__ trans, float* __restrict__ final_,
               signed char* __restrict__ tb, int T, int B) {
  const RowLane l = row_lane(B);
  signed char* out = tb + (size_t)l.to * B + l.b;
  const size_t out_stride = (size_t)NS * B;
  float prev[NS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  run_steps(
      trans, T, B, l, prev,
      [&](const float (&tr)[NS], const float (&p)[NS], int t, bool real) {
        float c[NS];
#pragma unroll
        for (int f = 0; f < NS; ++f) c[f] = __fadd_rn(tr[f], p[f]);
        const float best =
            fmaxf(fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3])), c[4]);
        int from = NS - 1;
#pragma unroll
        for (int f = NS - 2; f >= 0; --f) from = c[f] == best ? f : from;
        if (l.live && real) out[(size_t)t * out_stride] = (signed char)from;
        return best;
      });
  if (l.live && l.to == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) final_[(size_t)l.b * NS + s] = prev[s];
  }
}

// trans [T, B, 25] -> logZ [B].
__global__ void __launch_bounds__(WARP)
crf_partition_kernel(const float* __restrict__ trans, float* __restrict__ logz,
                     int T, int B) {
  const RowLane l = row_lane(B);
  float prev[NS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  run_steps(
      trans, T, B, l, prev,
      [](const float (&tr)[NS], const float (&p)[NS], int, bool) {
        float x[NS];
#pragma unroll
        for (int f = 0; f < NS; ++f) x[f] = __fadd_rn(tr[f], p[f]);
        return lse5(x);
      });
  if (l.live && l.to == 0) logz[l.b] = lse5(prev);
}

// tb[t, s, b] for the state s that `cur` names, from five loaded values.
__device__ __forceinline__ int pick(const signed char (&v)[NS], int cur) {
  int r = v[0];
#pragma unroll
  for (int s = 1; s < NS; ++s) r = cur == s ? v[s] : r;
  return r;
}

// final [B, 5], tb [T, 5, B] int8 -> score [B], path [B, T+1] int32.
__global__ void __launch_bounds__(BT_ROWS)
crf_backtrace_kernel(const float* __restrict__ final_,
                     const signed char* __restrict__ tb,
                     float* __restrict__ score, int* __restrict__ path, int T,
                     int B) {
  const int b = blockIdx.x * BT_ROWS + threadIdx.x;
  if (b >= B) return;
  const float* f = final_ + (size_t)b * NS;
  float best = f[0];
  int cur = 0;
#pragma unroll
  for (int s = 1; s < NS; ++s) {
    if (f[s] > best) {
      best = f[s];
      cur = s;
    }
  }
  score[b] = best;
  int* pb = path + (size_t)b * (T + 1);
  int t = T - 1;
  for (; t >= UNROLL - 1; t -= UNROLL) {
    signed char v[UNROLL][NS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        v[u][s] = tb[((size_t)(t - u) * NS + s) * B + b];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      pb[t - u + 1] = cur;
      cur = pick(v[u], cur);
    }
  }
  for (; t >= 0; --t) {
    pb[t + 1] = cur;
    cur = tb[((size_t)t * NS + cur) * B + b];
  }
  pb[0] = cur;
}

int row_warps(int B) { return (B + ROWS_PER_WARP - 1) / ROWS_PER_WARP; }

}  // namespace

extern "C" {

int scrappie_crf_fwd(const float* trans, float* final_, signed char* tb,
                     int T, int B, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  crf_fwd_kernel<<<row_warps(B), WARP, 0, stream>>>(trans, final_, tb, T, B);
  return (int)cudaGetLastError();
}

int scrappie_crf_partition(const float* trans, float* logz, int T, int B,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  crf_partition_kernel<<<row_warps(B), WARP, 0, stream>>>(trans, logz, T, B);
  return (int)cudaGetLastError();
}

int scrappie_crf_backtrace(const float* final_, const signed char* tb,
                           float* score, int* path, int T, int B,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  crf_backtrace_kernel<<<(B + BT_ROWS - 1) / BT_ROWS, BT_ROWS, 0, stream>>>(
      final_, tb, score, path, T, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
