// CRF decoding for the rnnrf head: the Viterbi forward pass, the backtrace
// and the log partition function.
//
// Replaces, in scrappie_tpu/ops/crf.py:
//   _crf_fwd_kernel   wrapper crf_viterbi_scores_tm
//   _crf_bt_kernel    wrapper crf_backtrace_tm
// and, with no TPU kernel of its own, the lax.scan of
// scrappie_tpu/nn/layers.py:crf_partition_function (wrapper
// crf_partition_tm), which globalnorm runs on every rnnrf path.
//
// Five states {A, C, G, T, blank}; transitions trans[t, b, to*5 + from],
// fp32, time-major [T, B, 25]. Scores start at 0. Per step t and state to:
//   forward    best = tr[to*5+0] + prev[0]; for from = 1..4 the candidate
//              tr[to*5+from] + prev[from] is taken only if strictly
//              greater; tb[t, to, b] = the `from` taken (int8);
//   partition  x_from = tr[to*5+from] + prev[from],
//              prev'[to] = m + log(sum_from exp(x_from - m)), m = max x_from;
//              logZ = the same reduction over the last scores.
// The forward's additions and tie rule are those of
// scrappie_tpu/decode/crf.py:_crf_viterbi (argmax = first max), so finals
// and tracebacks are identical bit for bit to the plain twins. The
// partition function uses expf/logf, which differ from the host's by a few
// ulps; its twin holds it to a relative 1e-5.
//
// Layouts: final [B, 5] f32; tb [T, 5, B] int8, batch innermost (the TPU
// kernel's [T, 8, B] without its padding rows), so a warp's 32 rows write
// 32 contiguous bytes per state and the backtrace reads them back
// coalesced; path [B, T+1] int32; logZ [B] f32.
//
// What bounds them on the H100: latency. Each row is a chain of T
// dependent steps of 25 adds and 20 compares (forward) or 25 exp and 5 log
// (partition), and the engine's B rows (8 to 256) fill at most 8 warps of
// the 132 SMs. Neither bandwidth (100 B of transitions per row and step)
// nor arithmetic binds; a step costs its issue and dependency latency in a
// single warp, and a call costs T of them.
//
// Design: one thread per batch row, one warp (32 rows) per block. A step's
// transitions for the warp's rows are 32 x 100 contiguous bytes; the warp
// copies them into shared memory with coalesced 4-byte cp.async (lane i
// copies words i, i+32, ...) through a ring of NSTAGE step buffers, so the
// loads of step t+NSTAGE-1 are in flight while step t computes. Each lane
// then reads its own 25 words (a stride of 25 words: no bank conflicts).
// The backtrace runs one thread per row and loads the traceback bytes of
// UNROLL steps, which do not depend on the walk, before it walks them.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 5;
constexpr int NTR = NS * NS;
constexpr int ROWS = 32;                // batch rows per block: one warp
constexpr int STEP_WORDS = ROWS * NTR;  // one step's transitions for a block
constexpr int NSTAGE = 8;               // steps in flight
constexpr int UNROLL = 8;               // backtrace steps loaded ahead

// Start copying step t's transitions for this block's nrow rows into buf.
// Every lane commits a group, empty past the end, so the groups stay in
// step with t.
__device__ __forceinline__ void issue_step(float* buf,
                                           const float* __restrict__ trans,
                                           int t, int T, int B, int b0,
                                           int nrow) {
  if (t < T) {
    const float* src = trans + ((size_t)t * B + b0) * NTR;
    for (int i = threadIdx.x; i < nrow * NTR; i += ROWS)
      __pipeline_memcpy_async(buf + i, src + i, sizeof(float));
  }
  __pipeline_commit();
}

// logsumexp of five values, as jax.nn.logsumexp and torch.logsumexp take
// it: a maximum that is not finite is replaced by 0.
__device__ __forceinline__ float lse5(const float (&x)[NS]) {
  float m = x[0];
#pragma unroll
  for (int f = 1; f < NS; ++f) m = fmaxf(m, x[f]);
  if (!isfinite(m)) m = 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int f = 0; f < NS; ++f) s = __fadd_rn(s, expf(__fsub_rn(x[f], m)));
  return __fadd_rn(logf(s), m);
}

// trans [T, B, 25] -> final [B, 5], tb [T, 5, B] int8.
__global__ void __launch_bounds__(ROWS)
crf_fwd_kernel(const float* __restrict__ trans, float* __restrict__ final_,
               signed char* __restrict__ tb, int T, int B) {
  __shared__ float ring[NSTAGE][STEP_WORDS];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * ROWS;
  const int nrow = min(ROWS, B - b0);
  const int b = b0 + lane;
  const bool live = lane < nrow;

  for (int s = 0; s < NSTAGE - 1; ++s)
    issue_step(ring[s], trans, s, T, B, b0, nrow);
  float prev[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) prev[s] = 0.0f;

  for (int t = 0; t < T; ++t) {
    // This buffer held step t-1, which every lane finished reading before
    // the __syncwarp that ended the previous iteration.
    issue_step(ring[(t + NSTAGE - 1) % NSTAGE], trans, t + NSTAGE - 1, T, B,
               b0, nrow);
    __pipeline_wait_prior(NSTAGE - 1);
    __syncwarp();
    if (live) {
      const float* tr = ring[t % NSTAGE] + lane * NTR;
      float next[NS];
#pragma unroll
      for (int to = 0; to < NS; ++to) {
        float best = __fadd_rn(tr[to * NS], prev[0]);
        int from = 0;
#pragma unroll
        for (int f = 1; f < NS; ++f) {
          const float cand = __fadd_rn(tr[to * NS + f], prev[f]);
          if (cand > best) {
            best = cand;
            from = f;
          }
        }
        next[to] = best;
        tb[((size_t)t * NS + to) * B + b] = (signed char)from;
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) prev[s] = next[s];
    }
    __syncwarp();
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < NS; ++s) final_[(size_t)b * NS + s] = prev[s];
  }
}

// trans [T, B, 25] -> logZ [B].
__global__ void __launch_bounds__(ROWS)
crf_partition_kernel(const float* __restrict__ trans, float* __restrict__ logz,
                     int T, int B) {
  __shared__ float ring[NSTAGE][STEP_WORDS];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * ROWS;
  const int nrow = min(ROWS, B - b0);
  const int b = b0 + lane;
  const bool live = lane < nrow;

  for (int s = 0; s < NSTAGE - 1; ++s)
    issue_step(ring[s], trans, s, T, B, b0, nrow);
  float prev[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) prev[s] = 0.0f;

  for (int t = 0; t < T; ++t) {
    issue_step(ring[(t + NSTAGE - 1) % NSTAGE], trans, t + NSTAGE - 1, T, B,
               b0, nrow);
    __pipeline_wait_prior(NSTAGE - 1);
    __syncwarp();
    if (live) {
      const float* tr = ring[t % NSTAGE] + lane * NTR;
      float next[NS];
#pragma unroll
      for (int to = 0; to < NS; ++to) {
        float x[NS];
#pragma unroll
        for (int f = 0; f < NS; ++f) x[f] = __fadd_rn(tr[to * NS + f], prev[f]);
        next[to] = lse5(x);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) prev[s] = next[s];
    }
    __syncwarp();
  }
  if (live) logz[b] = lse5(prev);
}

// tb[t, s, b] for the state s that `cur` names, from five loaded values.
__device__ __forceinline__ int pick(const signed char (&v)[NS], int cur) {
  int r = v[0];
#pragma unroll
  for (int s = 1; s < NS; ++s) r = cur == s ? v[s] : r;
  return r;
}

// final [B, 5], tb [T, 5, B] int8 -> score [B], path [B, T+1] int32.
__global__ void __launch_bounds__(ROWS)
crf_backtrace_kernel(const float* __restrict__ final_,
                     const signed char* __restrict__ tb,
                     float* __restrict__ score, int* __restrict__ path, int T,
                     int B) {
  const int b = blockIdx.x * ROWS + threadIdx.x;
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

int blocks(int B) { return (B + ROWS - 1) / ROWS; }

}  // namespace

extern "C" {

int scrappie_crf_fwd(const float* trans, float* final_, signed char* tb,
                     int T, int B, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  crf_fwd_kernel<<<blocks(B), ROWS, 0, stream>>>(trans, final_, tb, T, B);
  return (int)cudaGetLastError();
}

int scrappie_crf_partition(const float* trans, float* logz, int T, int B,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  crf_partition_kernel<<<blocks(B), ROWS, 0, stream>>>(trans, logz, T, B);
  return (int)cudaGetLastError();
}

int scrappie_crf_backtrace(const float* final_, const signed char* tb,
                           float* score, int* path, int T, int B,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  crf_backtrace_kernel<<<blocks(B), ROWS, 0, stream>>>(final_, tb, score, path,
                                                       T, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
