// CRF decoding for the rnnrf head: the Viterbi forward pass, the backtrace,
// the log partition function, and the forward-backward (the state posterior
// and the partition's gradient).
//
// Replaces, in scrappie_tpu/ops/crf.py:
//   _crf_fwd_kernel   wrapper crf_viterbi_scores_tm   (crf_fwd_kernel)
//   _crf_bt_kernel    wrapper crf_backtrace_tm        (crf_backtrace_kernel)
// and, with no TPU kernel of its own, the lax.scan of
// scrappie_tpu/nn/layers.py:crf_partition_function (wrapper
// crf_partition_tm, crf_partition_kernel), which globalnorm runs on every
// rnnrf path; and, with none either, the lax.scan of
// scrappie_tpu/decode/crf.py:_crf_posterior and the VJP XLA derives for
// crf_partition_function's in the JAX trainer (crf_walk_kernel, then
// crf_state_marginals_kernel or crf_edge_marginals_kernel; wrappers
// crf_posterior_tm and crf_partition_grad_tm; the note is beside them).
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
// The backtrace (replaces _crf_bt_kernel). What bounded the kernel it
// replaced, one thread a row walking x_t = tb[t, x_{t+1}, b]: one L2
// round trip a step. It loaded a step's five bytes ahead to pick one, but
// ptxas turned the pick into five loads predicated on the state, each
// waiting for the step before (SASS); so a step took about 450, 1270 and
// 215 cycles at T = 5000, B = 8 and 64 and at T = 31 744, B = 2 (H100,
// 2 x standard-normal transitions), and leaving out its path stores saved
// only 3-5%. Design: the walk is split in time. Step t is a map f_t of the
// five states, f_t(s) = tb[t, s, b], and composing maps is exact, so a
// lane owns SEG consecutive steps: it loads their 5 SEG bytes (none
// depends on the walk), composes the SEG maps with prmt (__byte_perm:
// two a step, the maps as bytes and selectors), a suffix scan of the
// lanes' maps (shuffles in a warp, shared memory across warps) gives each
// lane the state its steps start from, and it walks them again in
// registers. One block a row, up to BT_MAX_THREADS lanes (16 384 steps a
// chunk, the last first); the path is staged in shared memory (a byte a
// state, a lane's bytes padded into distinct banks) and written out
// contiguous. No chain waits on memory: what bounds it now is the loads,
// 5 bytes a step from 32 steps a warp instruction apart (one sector each),
// and the scan's two barriers a chunk.
#include <cuda_runtime.h>

namespace {

constexpr int NS = 5;
constexpr int NTR = NS * NS;
constexpr int WARP = 32;
constexpr int ROWS_PER_WARP = 6;  // five lanes a row: 30 of 32 lanes live
constexpr int DEPTH = 16;         // steps of transitions in flight
constexpr int SEG = 32;           // backtrace steps a lane composes
constexpr int SEG_PAD = SEG + 4;  // a lane's states in the backtrace's stage
constexpr int BT_MAX_THREADS = 512;  // backtrace lanes a row, at most
constexpr unsigned FULL = 0xffffffffu;

// What a lane of the forward and partition kernels owns: state `to` of
// batch row b (clamped to B-1 for the lanes that store nothing), whose
// five lanes start at `first`.
struct RowLane {
  int to, first, b;
  bool live;
};

__device__ __forceinline__ RowLane row_lane(int B, int group) {
  const int lane = threadIdx.x;
  const int r = lane / NS;
  const int b = group * ROWS_PER_WARP + r;
  return {lane - r * NS, r * NS, min(b, B - 1), r < ROWS_PER_WARP && b < B};
}

template <int kStride>
__device__ __forceinline__ void load5(float (&v)[NS], const float* p) {
#pragma unroll
  for (int f = 0; f < NS; ++f) v[f] = __ldg(p + f * kStride);
}

// Every lane of the row gets the row's five new scores.
__device__ __forceinline__ void trade(float (&prev)[NS], float mine,
                                      int first) {
#pragma unroll
  for (int s = 0; s < NS; ++s) prev[s] = __shfl_sync(FULL, mine, first + s);
}

// logsumexp of five values, as jax.nn.logsumexp and torch.logsumexp take
// it, in two parts: m, the maximum (0 where it is not finite), and the
// returned log(sum_f exp(x_f - m)).
__device__ __forceinline__ float log_sum_shifted(const float (&x)[NS], float& m) {
  m = fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])), x[4]);
  if (!isfinite(m)) m = 0.0f;
  float e[NS];
#pragma unroll
  for (int f = 0; f < NS; ++f) e[f] = expf(__fsub_rn(x[f], m));
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(e[0], e[1]),
                                      __fadd_rn(e[2], e[3])), e[4]);
  return logf(s);
}

__device__ __forceinline__ float lse5(const float (&x)[NS]) {
  float m;
  const float l = log_sum_shifted(x, m);
  return __fadd_rn(l, m);
}

// lse5(x) - k, with k taken from m before the log is added (m - k does not
// wait for the exponentials).
__device__ __forceinline__ float lse5_less(const float (&x)[NS], float k) {
  float m;
  const float l = log_sum_shifted(x, m);
  return __fadd_rn(l, __fsub_rn(m, k));
}

// The step loop the forward, partition and walk kernels share: Step(tr,
// prev, n, real) -> this lane's new score. Forward (kBack false), step n
// reads block t = n and lane `to` its five transitions tr[from] =
// trans[t, b, to*5 + from] (20 contiguous bytes); back, step n reads
// block t = T-1-n and lane `from` tr[to] = trans[t, b, to*5 + from]
// (stride 5). The loop runs T rounded up to DEPTH steps, so that every
// load is issued unconditionally (a guarded load made each step wait for
// it); a step past T (real = false) takes the identity transitions (-0
// from the lane's own state, -inf from the others), which leave the
// forward's and the partition's scores unchanged bit for bit.
template <bool kBack, class Step>
__device__ __forceinline__ void run_steps(const float* __restrict__ trans,
                                          int T, int B, const RowLane& l,
                                          float (&prev)[NS], Step step) {
  if (T == 0) return;
  constexpr int kStride = kBack ? NS : 1;
  const size_t stride = (size_t)B * NTR;
  const float* src = trans + (size_t)l.b * NTR + l.to * (NS / kStride);
  const int last = T - 1;
  auto block = [&](int n) -> size_t {
    const int c = min(n, last);
    return kBack ? last - c : c;
  };
  float ring[DEPTH][NS];
#pragma unroll
  for (int u = 0; u < DEPTH; ++u)
    load5<kStride>(ring[u], src + block(u) * stride);
  const float minus_inf = __int_as_float(0xff800000);
  for (int n0 = 0; n0 < T; n0 += DEPTH) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const int n = n0 + u;
      const bool real = n < T;
      float tr[NS];
#pragma unroll
      for (int f = 0; f < NS; ++f)
        tr[f] = real ? ring[u][f] : (f == l.to ? -0.0f : minus_inf);
      load5<kStride>(ring[u], src + block(n + DEPTH) * stride);
      trade(prev, step(tr, prev, n, real), l.first);
    }
  }
}

// trans [T, B, 25] -> final [B, 5], tb [T, 5, B] int8.
__global__ void __launch_bounds__(WARP)
crf_fwd_kernel(const float* __restrict__ trans, float* __restrict__ final_,
               signed char* __restrict__ tb, int T, int B) {
  const RowLane l = row_lane(B, blockIdx.x);
  signed char* out = tb + (size_t)l.to * B + l.b;
  const size_t out_stride = (size_t)NS * B;
  float prev[NS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  run_steps<false>(
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
  const RowLane l = row_lane(B, blockIdx.x);
  float prev[NS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  run_steps<false>(
      trans, T, B, l, prev,
      [](const float (&tr)[NS], const float (&p)[NS], int, bool) {
        float x[NS];
#pragma unroll
        for (int f = 0; f < NS; ++f) x[f] = __fadd_rn(tr[f], p[f]);
        return lse5(x);
      });
  if (l.live && l.to == 0) logz[l.b] = lse5(prev);
}

// The forward-backward (wrappers crf_posterior_tm, crf_partition_grad_tm):
// two walks and a marginal pass. The walks keep their scores less their
// maximum over the five states, a_t = alpha_t - max alpha_t and b_t =
// beta_t - max beta_t, with alpha_0 = beta_T = 0,
//   alpha_{t+1}[to] = lse_from(trans[t, to, from] + a_t[from]),
//   beta_t[from]    = lse_to(trans[t, to, from] + b_{t+1}[to]);
// a marginal is a softmax in which each step's offsets cancel, so it is
// computed from these without logZ: mode 0, the state posterior,
// post[b, t, s] = softmax_s(a_t[s] + b_t[s]) for t = 0..T, [B, T+1, 5];
// mode 1, the partition's gradient, grad[t, b, to*5 + from] =
// softmax over the 25 (to, from) of v = a_t[from] + (trans[t, to, from] +
// b_{t+1}[to]), times g[b]: the edge marginals times the incoming gradient
// of logZ, [T, B, 25]. Unnormalised, alpha, beta and logZ grow as the sum
// of T steps' transitions (logZ about 5 400 over 300 blocks of the rnnrf
// head with the repository's weights), and exp(alpha + trans + beta -
// logZ) keeps only their float32 precision: the gradient was off by 1e-3
// relative there. The normalised scores stay within the transitions' range.
//
// What bounded the kernel this design replaced (one warp walked a row's T
// steps forward, then T steps back with the marginal's softmax, or its
// gradient's two lse5, in the walk back's instruction stream): about 1 400
// cycles a block at T = 5000 and 31 744 (H100), where the partition's
// step takes 276-330. Design: alpha depends only on the walk forward and
// beta only on the walk back, so crf_walk_kernel runs both at once, in
// twice the partition's grid (block i < nw walks row group i forward,
// block nw + i walks it back), the serial length T instead of 2T. Each is
// the partition's step on five lanes a row (lane s is state `to` = s
// forward, `from` = s back, whose five transitions are a stride-5 column
// of the row's 100 bytes): one lse5 and five shuffles, the carried
// c_{t+1} = lse(trans + c_t) - max c_t, its subtraction folded into the
// lse5's last addition so the max does not wait on the chain; c_t differs
// from alpha_t (beta_t) by a constant, and the lane stores its entry less
// the max, off the chain, into scores [T+1, B, 5] (mode 1) or [B, T+1, 5]
// (mode 0, the posterior's own layout). A stitch pad block (moves into
// blank only, at cost 0) turns five equal scores into five equal scores,
// so the walk back reaches a padded row's last real boundary with c = 0
// exactly, as an unpadded row starts: each row of a padded batch equals
// its own call bit for bit. The marginals are then a pass parallel over
// (t, b), bound by bandwidth: one max, five (mode 0) or 25 (mode 1) expf
// and one division a thread. Measured on an H100 at 1980 MHz (chip_smoke.py,
// phase crf_kernels): 314 cycles a block at T = 31 744, B = 2 and 383 at
// T = 5000, B = 64 (the posterior, its marginal pass included), against
// the partition's 271 and 331.
__device__ __forceinline__ float max5(const float (&v)[NS]) {
  return fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])), v[4]);
}

template <bool kBack>
__device__ __forceinline__ void walk(const float* __restrict__ trans,
                                     float* __restrict__ score, int T, int B,
                                     size_t ts, size_t bs, const RowLane& l) {
  float* mine = score + (size_t)l.b * bs + l.to;  // boundary u at + u * ts
  float c[NS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  run_steps<kBack>(
      trans, T, B, l, c,
      [&](const float (&tr)[NS], const float (&p)[NS], int n, bool real) {
        const float mc = max5(p);
        if (l.live && real)
          mine[(size_t)(kBack ? T - n : n) * ts] = __fsub_rn(p[l.to], mc);
        float x[NS];
#pragma unroll
        for (int f = 0; f < NS; ++f) x[f] = __fadd_rn(tr[f], p[f]);
        return lse5_less(x, mc);
      });
  if (l.live) mine[(size_t)(kBack ? 0 : T) * ts] = __fsub_rn(c[l.to], max5(c));
}

// trans [T, B, 25] -> a, b at boundary t and row r at (t ts + r bs) * 5.
__global__ void __launch_bounds__(WARP)
crf_walk_kernel(const float* __restrict__ trans, float* __restrict__ a,
                float* __restrict__ b, int T, int B, int ts, int bs) {
  const int nw = gridDim.x / 2;
  if (blockIdx.x < nw) {
    walk<false>(trans, a, T, B, (size_t)ts * NS, (size_t)bs * NS,
                row_lane(B, blockIdx.x));
  } else {
    walk<true>(trans, b, T, B, (size_t)ts * NS, (size_t)bs * NS,
               row_lane(B, blockIdx.x - nw));
  }
}

constexpr int MARGINAL_THREADS = 256;

// Mode 0: a, b, post [n, 5] (n = B (T+1) entries, the posterior's layout);
// post = softmax(a + b) over the five states, as jax.nn.softmax.
__global__ void __launch_bounds__(MARGINAL_THREADS)
crf_state_marginals_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ post, int n) {
  const int i = blockIdx.x * MARGINAL_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * NS;
  float v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = __fadd_rn(a[o + s], b[o + s]);
  const float m = max5(v);
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = expf(__fsub_rn(v[s], m));
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]),
                                        __fadd_rn(v[2], v[3])), v[4]);
#pragma unroll
  for (int s = 0; s < NS; ++s) post[o + s] = __fdiv_rn(v[s], sum);
}

// Mode 1: trans, grad [T, B, 25], a, b [T+1, B, 5], g [B]; a thread a
// block and row (entry i = t B + row): grad = softmax over the 25 of
// a_t[from] + (trans + b_{t+1}[to]), times g.
__global__ void __launch_bounds__(MARGINAL_THREADS)
crf_edge_marginals_kernel(const float* __restrict__ trans,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ g,
                          float* __restrict__ grad, int n, int B) {
  const int i = blockIdx.x * MARGINAL_THREADS + threadIdx.x;
  if (i >= n) return;
  const float* tr = trans + (size_t)i * NTR;
  float at[NS], bt[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    at[s] = a[(size_t)i * NS + s];
    bt[s] = b[((size_t)i + B) * NS + s];
  }
  float v[NTR];
  float m = __int_as_float(0xff800000);
#pragma unroll
  for (int to = 0; to < NS; ++to) {
#pragma unroll
    for (int from = 0; from < NS; ++from) {
      const int k = to * NS + from;
      v[k] = __fadd_rn(at[from], __fadd_rn(__ldg(tr + k), bt[to]));
      m = fmaxf(m, v[k]);
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < NTR; ++k) {
    v[k] = expf(__fsub_rn(v[k], m));
    sum = __fadd_rn(sum, v[k]);
  }
  const float scale = __fdiv_rn(g[i % B], sum);
  float* out = grad + (size_t)i * NTR;
#pragma unroll
  for (int k = 0; k < NTR; ++k) out[k] = __fmul_rn(v[k], scale);
}

// The backtrace composes maps of the five states. A map m: {0..4} ->
// {0..4} is kept as bytes (entry s in byte s of lo, hi), which prmt
// (__byte_perm) indexes, or as a selector (entry s in nibble s), which
// prmt takes. Composition is exact, so a row's walk may be split in time.
struct Map {
  unsigned lo, hi;
};

__device__ __forceinline__ Map id_map() { return {0x03020100u, 4u}; }
constexpr unsigned ID_SEL = 0x43210u;

// m as a selector: the entries are below 8, so bytes 0-3 fold into four
// nibbles (the bytes above hi's first do not reach bits 16-23).
__device__ __forceinline__ unsigned selector(const Map& m) {
  const unsigned y = m.lo | (m.lo >> 4);  // bytes 0 and 2: e0|e1<<4, e2|e3<<4
  return __byte_perm(y, 0, 0x4420) | (m.hi << 16);
}

// a o g (g first), g as a selector: entry s is a's entry g(s). Only byte 0
// of hi is kept meaningful.
__device__ __forceinline__ Map compose(const Map& a, unsigned g) {
  return {__byte_perm(a.lo, a.hi, g), __byte_perm(a.lo, a.hi, g >> 16)};
}

__device__ __forceinline__ int apply(const Map& m, int x) {
  return __byte_perm(m.lo, m.hi, x) & 0xff;
}

__device__ __forceinline__ Map shfl_down(const Map& m, int off) {
  return {__shfl_down_sync(FULL, m.lo, off), __shfl_down_sync(FULL, m.hi, off)};
}

// Suffix scan over the warp's lanes: lane i ends with m_i o m_{i+1} o ...
// o m_31, each m_j the map of a later stretch of time than m_{j-1}.
__device__ __forceinline__ Map suffix_compose(Map m, int lane) {
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1) {
    const Map later = shfl_down(m, off);
    if (lane + off < WARP) m = compose(m, selector(later));
  }
  return m;
}

// final [B, 5], tb [T, 5, B] int8 -> score [B], path [B, T+1] int32. One
// block a row. The states are x_T = first argmax of the finals and
// x_t = f_t(x_{t+1}), f_t(s) = tb[t, s, b]; path[b, t] = x_t. The row's
// steps are cut into chunks of blockDim.x * SEG, walked from the last;
// lane k of a chunk owns its steps [c0 + k SEG, c0 + (k+1) SEG).
__global__ void __launch_bounds__(BT_MAX_THREADS)
crf_backtrace_kernel(const float* __restrict__ final_,
                     const signed char* __restrict__ tb,
                     float* __restrict__ score, int* __restrict__ path, int T,
                     int B) {
  extern __shared__ unsigned char stage[];  // blockDim.x * SEG_PAD states
  __shared__ Map warp_map[BT_MAX_THREADS / WARP];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int nwarp = blockDim.x / WARP;
  const float* f = final_ + (size_t)b * NS;
  float best = f[0];
  int x = 0;  // x_{c1}, the state the chunk's last step leads from
#pragma unroll
  for (int s = 1; s < NS; ++s) {
    if (f[s] > best) {
      best = f[s];
      x = s;
    }
  }
  int* pb = path + (size_t)b * (T + 1);
  if (tid == 0) {
    score[b] = best;
    pb[T] = x;
  }
  const int chunk = blockDim.x * SEG;
  for (int c1 = T; c1 > 0; c1 -= chunk) {
    const int c0 = max(c1 - chunk, 0);
    const int s0 = c0 + tid * SEG;
    const int n = min(max(c1 - s0, 0), SEG);
    // This lane's maps as selectors, all loaded before any is used (steps
    // past its own are the identity; their loads stay in bounds).
    unsigned sel[SEG];
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      const signed char* p = tb + (size_t)min(s0 + u, c1 - 1) * NS * B + b;
      unsigned v = 0;
#pragma unroll
      for (int s = 0; s < NS; ++s) v |= (unsigned)__ldg(p + (size_t)s * B) << (4 * s);
      sel[u] = u < n ? v : ID_SEL;
    }
    // g = f_{s0} o ... o f_{s0+SEG-1}: x_{s0} from x_{s0+SEG}.
    Map g = id_map();
#pragma unroll
    for (int u = 0; u < SEG; ++u) g = compose(g, sel[u]);
    g = suffix_compose(g, lane);  // lanes [lane, 32) of this warp
    const Map after_lane = shfl_down(g, 1);
    if (lane == 0) warp_map[warp] = g;
    __syncthreads();
    // Warps [w, nwarp) likewise, over lanes w; then this lane's entry state
    // x_{s0+SEG}: the later warps' map, then the later lanes', applied to x.
    const Map w = suffix_compose(lane < nwarp ? warp_map[lane] : id_map(), lane);
    const Map after_warp{__shfl_sync(FULL, w.lo, min(warp + 1, WARP - 1)),
                         __shfl_sync(FULL, w.hi, min(warp + 1, WARP - 1))};
    int cur = warp + 1 < nwarp ? apply(after_warp, x) : x;
    if (lane + 1 < WARP) cur = apply(after_lane, cur);
    // The walk again, now from a known state, into the stage (a lane's
    // SEG states padded to SEG_PAD bytes: the lanes' stores fall in
    // distinct banks).
    unsigned char* mine = stage + tid * SEG_PAD;
#pragma unroll
    for (int u = SEG - 1; u >= 0; --u) {
      cur = (sel[u] >> (4 * cur)) & 0xf;
      if (u < n) mine[u] = (unsigned char)cur;
    }
    __syncthreads();
    for (int i = tid; i < c1 - c0; i += blockDim.x)
      pb[c0 + i] = stage[(i / SEG) * SEG_PAD + i % SEG];
    x = stage[0];
    __syncthreads();
  }
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

// trans [T, B, 25], scratch a and b [T+1, B, 5] floats each; mode 0: out
// = post [B, T+1, 5] (g unused); mode 1: g [B], out = grad [T, B, 25].
// The walks, then the marginal pass, on `stream`.
int scrappie_crf_fwdbwd(const float* trans, const float* g, float* a,
                        float* b, float* out, int T, int B, int mode,
                        cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  // strides of boundary and row, in entries of five floats
  const int ts = mode == 0 ? 1 : B;
  const int bs = mode == 0 ? T + 1 : 1;
  crf_walk_kernel<<<2 * row_warps(B), WARP, 0, stream>>>(trans, a, b, T, B,
                                                         ts, bs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = mode == 0 ? B * (T + 1) : B * T;
  if (n == 0) return (int)cudaSuccess;
  const int grid = (n + MARGINAL_THREADS - 1) / MARGINAL_THREADS;
  if (mode == 0)
    crf_state_marginals_kernel<<<grid, MARGINAL_THREADS, 0, stream>>>(a, b,
                                                                      out, n);
  else
    crf_edge_marginals_kernel<<<grid, MARGINAL_THREADS, 0, stream>>>(
        trans, a, b, g, out, n, B);
  return (int)cudaGetLastError();
}

int scrappie_crf_backtrace(const float* final_, const signed char* tb,
                           float* score, int* path, int T, int B,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  // a lane for each SEG steps, in whole warps, at most BT_MAX_THREADS
  const int lanes = (T + SEG - 1) / SEG;
  const int threads = min(BT_MAX_THREADS, max(WARP, (lanes + WARP - 1) / WARP * WARP));
  crf_backtrace_kernel<<<B, threads, threads * SEG_PAD, stream>>>(
      final_, tb, score, path, T, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
