// Transducer Viterbi decoding: the forward pass, the forward pass with the
// posterior head fused in (one model, or an ensemble of K), and the
// backtrace. The paths decode with csrc/head.cu's head kernel and the
// forward pass; the two fused kernels are kept, checked and timed, and no
// path launches them.
//
// Replaces, in scrappie_tpu/ops/viterbi.py:
//   _fwd_kernel (with _dp_step and _dp_init)  wrapper viterbi_scores_tm
//   _fused_kernel                             wrapper viterbi_fused_tm
//   _fused_ens_kernel                         wrapper viterbi_fused_ens_tm
//   _bt_kernel                                wrapper viterbi_backtrace_tm
//
// State space: nhist kmer-history states, then the local START and END
// states (nhist + 2 in all). Per block t and history state d:
//   stay   hist[d] + (stay_lp - stay_pen)                      tb -1
//   step   lp[d] + max_r hist[r*nhist/4  + (d>>2)],  r < 4     tb pred
//   skip   lp[d] + max_r hist[r*nhist/16 + (d>>4)] - skip_pen, r < 16
//   slip   lp[d] + max_r hist[r*nhist/64 + (d>>6)] - 2 skip_pen, r < 64
//   start  start_prev + lp[d]                                  tb START
// Candidates contend in that order with a strict `>`; within a predecessor
// group the first maximum (smallest r) wins. START and END stay at
// max(-local_pen, stay_lp); END is entered from the first best history
// state at max(hist) - local_pen. The order of every addition is the
// JAX programs' order, so scores and tracebacks are identical bit for bit
// to the plain twins (the DP only adds and takes maxima).
//
// What bounds them on the H100:
//  * forward: sequential in T. Per step a block reads one log-posterior row
//    (4 KB) and writes a 2 KB int16 traceback row; each predecessor
//    group's maximum is needed by 4, 16 or 64 states. The step's latency
//    (a barrier, the shared-memory reads, the shuffles that merge a group)
//    and the SM's issue rate, not bandwidth, set the time.
//  * fused: as the forward, plus the head: a [S] x [S, nstate] product per
//    row and step. W (394 KB in fp32 at S = 96) does not fit in shared
//    memory, so every step streams it from L2; at one row per block that
//    L2 traffic is the bound. That is why the paths now take the head
//    kernel, which reads W once for 128 rows, and this forward.
//  * fused ensemble: K heads per step, so K times the fused kernel's L2
//    traffic (1.2 MB a step at K = 3), plus four block reductions (the K
//    softmax maxima and sums together, then the maximum and sum of the
//    combined log posterior's renormalisation).
//  * backtrace: one dependent 2-byte load per step and row; latency-bound.
//
// Design: one block per batch row. The forward (viterbi_fwd_kernel) gives
// each thread quads of four consecutive history states, 256 threads at
// nhist = 1024, so several rows share an SM: a quad computes its step
// group's maximum once, the four lanes of a quad share its skip group and
// sixteen lanes a slip group, each reading a quarter of it, merged by
// shuffles. More quads a thread (strided by the thread count) take every
// nhist the JAX package takes: a multiple of 16 (64 with slip), up to what
// the scores' two rows in shared memory (2 nhist floats) and the int16
// traceback (states below 2^15) allow. The fused kernels keep one thread
// per state, 64 <= nhist <= 1024 in whole warps, with dp_step/dp_hist.
// The scores live in shared memory, double buffered, so a step reads the
// previous scores while writing the next ones and needs a single barrier
// (the TPU kernel's one-hot MXU lane expansion is replaced by plain
// shared-memory reads of the predecessors). The START score needs no
// reduction, so every thread carries its own copy. END needs the first
// argmax of the previous scores: each warp reduces (max, index) to a
// parity buffer, and one warp finishes that reduction one step later, off
// the other warps' critical path. The next step's log posteriors (or
// hidden row) are loaded into registers while the current step computes.
// The ensemble kernel stages its K hidden rows [2, K, S] in shared memory
// the same way, keeps each member's logit in a register (K <= MAX_ENS, a
// loop unrolled to that bound), and shares the head's dot products, the
// DP step and the final write with the fused kernel. The backtrace runs
// one thread per row.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float BIG = 1.0e30f;
constexpr int MAX_WARPS = 32;
constexpr int MAX_ENS = 4;  // members of the fused ensemble kernel
constexpr int FWD_THREADS = 512;  // at most, the forward's history threads
constexpr int AHEAD = 3;  // steps of log posteriors the forward loads ahead

struct DpParams {
  float stay_pen;
  float skip_pen;
  float local_pen;
  int use_slip;
};

// First maximum over a predecessor group of n scores {r*q + g}.
__device__ __forceinline__ void group_max(const float* hist, int q, int g,
                                          int n, float& m, int& r) {
  m = hist[g];
  r = 0;
  for (int i = 1; i < n; ++i) {
    const float v = hist[i * q + g];
    if (v > m) {
      m = v;
      r = i;
    }
  }
}

// Warp-wide (max, first index) by butterfly: every lane ends with the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

// One history state's DP update. prev/next are the block's score buffers.
__device__ __forceinline__ void dp_hist(const float* prev, float* next,
                                        short* tb_row, float lpd,
                                        float stay_lp, float start_prev,
                                        const DpParams& p, int nhist, int d) {
  float score = __fadd_rn(prev[d], stay_lp);
  int tb = -1;
  float m;
  int r;
  int q = nhist >> 2;
  group_max(prev, q, d >> 2, 4, m, r);
  float cand = __fadd_rn(lpd, m);
  if (cand > score) {
    score = cand;
    tb = r * q + (d >> 2);
  }
  q = nhist >> 4;
  group_max(prev, q, d >> 4, 16, m, r);
  cand = __fsub_rn(__fadd_rn(lpd, m), p.skip_pen);
  if (cand > score) {
    score = cand;
    tb = r * q + (d >> 4);
  }
  if (p.use_slip) {
    q = nhist >> 6;
    group_max(prev, q, d >> 6, 64, m, r);
    cand = __fsub_rn(__fadd_rn(lpd, m), __fmul_rn(2.0f, p.skip_pen));
    if (cand > score) {
      score = cand;
      tb = r * q + (d >> 6);
    }
  }
  cand = __fadd_rn(start_prev, lpd);
  if (cand > score) {
    score = cand;
    tb = nhist;
  }
  next[d] = score;
  tb_row[d] = (short)tb;
}

// The END-state update of one step from n partial (max, first index)
// pairs of that step's previous scores (the fused kernels: one a warp; the
// forward: one a quad): each lane merges every 32nd, then the warp. All
// lanes keep `end`.
__device__ __forceinline__ void end_update(const float* val, const int* idx,
                                           int n, float local_stay,
                                           const DpParams& p, int nhist,
                                           short* tb_row, float& end) {
  const int lane = threadIdx.x & 31;
  float v = -CUDART_INF_F;
  int i = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    if (val[j] > v || (val[j] == v && idx[j] < i)) {
      v = val[j];
      i = idx[j];
    }
  }
  warp_argmax(v, i);
  const float stay_end = __fadd_rn(end, local_stay);
  const float enter = __fsub_rn(v, p.local_pen);
  const bool better = enter > stay_end;
  end = better ? enter : stay_end;
  if (lane == 0) {
    tb_row[nhist] = (short)nhist;
    tb_row[nhist + 1] = (short)(better ? i : nhist + 1);
  }
}

// Everything of one DP step except the END update: history states, the
// per-warp argmax of the previous scores, and the START score.
__device__ __forceinline__ void dp_step(const float* prev, float* next,
                                        float* wval, int* widx, short* tb_row,
                                        float lpd, float stay_lp, float& start,
                                        const DpParams& p, int nhist) {
  const int d = threadIdx.x;
  float v = prev[d];
  int i = d;
  warp_argmax(v, i);
  if ((d & 31) == 0) {
    wval[d >> 5] = v;
    widx[d >> 5] = i;
  }
  dp_hist(prev, next, tb_row, lpd, stay_lp, start, p, nhist, d);
  start = __fadd_rn(start, fmaxf(-p.local_pen, stay_lp));
}

// One DP step at time t from this step's log posteriors of history state d
// (lpd) and of the stay (lps), then warp 0's END update of step t - 1.
__device__ __forceinline__ void dp_advance(float (&hist)[2][1024],
                                           float (&wval)[2][MAX_WARPS],
                                           int (&widx)[2][MAX_WARPS],
                                           short* tb, int t, int B, float lpd,
                                           float lps, float& start, float& end,
                                           float& local_stay_prev,
                                           const DpParams& p, int nhist) {
  const int cur = t & 1;
  const int nst2 = nhist + 2;
  const float stay_lp = __fsub_rn(lps, p.stay_pen);
  short* tb_row = tb + ((size_t)t * B + blockIdx.x) * nst2;
  dp_step(hist[cur], hist[cur ^ 1], wval[cur], widx[cur], tb_row, lpd,
          stay_lp, start, p, nhist);
  if (threadIdx.x < 32 && t > 0) {
    end_update(wval[cur ^ 1], widx[cur ^ 1], nhist >> 5, local_stay_prev, p,
               nhist, tb_row - (size_t)B * nst2, end);
  }
  local_stay_prev = fmaxf(-p.local_pen, stay_lp);
}

// After the last step: warp 0 finishes the last END update, then the
// block writes the final scores [nhist history | START | END] of its row.
__device__ __forceinline__ void dp_finish(const float* hist, const float* wval,
                                          const int* widx,
                                          float local_stay_prev, float start,
                                          float end, const DpParams& p,
                                          float* final_, short* tb, int T,
                                          int B, int nhist) {
  const int b = blockIdx.x;
  const int d = threadIdx.x;
  const int nst2 = nhist + 2;
  float* f = final_ + (size_t)b * nst2;
  if (T > 0 && d < 32) {
    end_update(wval, widx, nhist >> 5, local_stay_prev, p, nhist,
               tb + ((size_t)(T - 1) * B + b) * nst2, end);
  }
  f[d] = hist[d];
  if (d == 0) {
    f[nhist] = start;
    f[nhist + 1] = end;
  }
}

// (max, first index) over groups of kSpan consecutive lanes (a power of
// two, at most 32): shuffles xor 1, ..., kSpan / 2. Every lane of a group
// ends with the result.
template <int kSpan>
__device__ __forceinline__ void lanes_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 1; off < kSpan; off <<= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

// First maximum of prev[r * q + g] over r in [r0, r0 + 4).
__device__ __forceinline__ void group_max4(const float* prev, int q, int g,
                                           int r0, float& m, int& r) {
  m = prev[r0 * q + g];
  r = r0;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float v = prev[(r0 + i) * q + g];
    if (v > m) {
      m = v;
      r = r0 + i;
    }
  }
}

// lp [T, B, nhist+1] -> final [B, nhist+2], tb [T, B, nhist+2] int16.
// The first nthr threads (whole warps) own, for i < NQ, the quad qd = tid
// + i nthr of history states d = 4 qd + k, k < 4, when qd < nhist / 4.
// A quad's step group is qd itself: its four predecessors are read once.
// Its skip group (qd >> 2) is shared by the four lanes of the quad, each
// reading four of the sixteen predecessors, merged by two shuffles; with
// slip the group (qd >> 4) is shared by sixteen lanes, each reading four
// of 64, merged by four. Merges keep the smaller r on a tie, the first
// maximum. The skip groups cover every history state, so the quads'
// skip maxima (merged over a thread's quads, one pair for each four
// threads) give the first argmax of the previous scores for END; the END
// update of step t - 1 merges them at step t, on one more warp (threads
// nthr .. nthr + 31) that does nothing else. Scores are read and written
// as float4 in shared memory ([2, nhist], double-buffered, one barrier a
// step), the traceback as two 4-byte pairs a quad. Up to two quads a
// thread, the log posteriors of the next AHEAD steps wait in registers.
template <int NQ>
__global__ void __launch_bounds__(FWD_THREADS + 32)
viterbi_fwd_kernel(const float* __restrict__ lp, float* __restrict__ final_,
                   short* __restrict__ tb, int T, int B, int nhist, int nthr,
                   DpParams p) {
  extern __shared__ float4 hist4[];
  __shared__ float qval[2][FWD_THREADS / 4];  // END partials, a quad each
  __shared__ int qidx[2][FWD_THREADS / 4];
  const float* hist = reinterpret_cast<const float*>(hist4);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nq = nhist >> 2;
  const int q16 = nhist >> 4;
  const int q64 = nhist >> 6;
  const int nstate = nhist + 1;
  const int nst2 = nhist + 2;
  const bool dp = tid < nthr;
  const bool end_lanes = tid >= nthr;

  float start = 0.0f;
  float end = -BIG;
  float local_stay_prev = 0.0f;
  for (int i = tid; i < nq; i += blockDim.x)
    hist4[i] = make_float4(-BIG, -BIG, -BIG, -BIG);

  // The log posteriors of steps t .. t + AHEAD - 1 wait in a ring of
  // registers, raw (clamped where used): slot t % AHEAD holds step t, and
  // once step t has read it, it takes step t + AHEAD. The step loop is
  // unrolled by AHEAD, so each slot keeps its registers and no move waits
  // on a load in flight. Above two quads a thread each step reads its own.
  constexpr bool kAhead = NQ <= 2;
  constexpr int KQ = kAhead ? NQ : 1;
  const float* base = lp + (size_t)b * nstate;
  const size_t tstride = (size_t)B * nstate;
  auto load = [&](int tt, float (&lpv)[KQ][4], float& lsv) {
    const float* r = base + (size_t)min(tt, T - 1) * tstride;
    if constexpr (kAhead) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int qd = tid + i * nthr;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          lpv[i][k] = (dp && qd < nq) ? r[4 * qd + k] : 0.0f;
      }
    }
    lsv = r[nhist];
  };
  float ring[AHEAD][KQ][4];
  float ring_s[AHEAD];
  if (T > 0) {
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) load(a, ring[a], ring_s[a]);
  }
  __syncthreads();

  auto step = [&](int t, float (&lpv)[KQ][4], float& lsv) {
    const float* crow = base + (size_t)t * tstride;
    const int cur = t & 1;
    const float* prev = hist + cur * nhist;
    float4* next4 = hist4 + (cur ^ 1) * nq;
    const float stay_lp = __fsub_rn(fmaxf(lsv, -BIG), p.stay_pen);
    short* tb_row = tb + ((size_t)t * B + b) * nst2;
    if (dp) {
      float ev = -CUDART_INF_F;  // this thread's quads' END partial
      int ei = INT_MAX;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int qd = tid + i * nthr;
        const bool live = qd < nq;  // whole quads, and whole slip groups
        float ms = -CUDART_INF_F, mk = -CUDART_INF_F, ml = -CUDART_INF_F;
        int rs = 0, rk = INT_MAX, rl = INT_MAX;
        float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (live) {
          pv = hist4[cur * nq + qd];
          group_max4(prev, nq, qd, 0, ms, rs);
          group_max4(prev, q16, qd >> 2, 4 * (qd & 3), mk, rk);
          if (p.use_slip) group_max4(prev, q64, qd >> 4, 4 * (qd & 15), ml, rl);
        }
        lanes_argmax<4>(mk, rk);
        if (p.use_slip) lanes_argmax<16>(ml, rl);
        if (live) {
          float lv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if constexpr (kAhead) {
              lv[k] = fmaxf(lpv[i][k], -BIG);
            } else {
              lv[k] = fmaxf(crow[4 * qd + k], -BIG);
            }
          }
          const float pd[4] = {pv.x, pv.y, pv.z, pv.w};
          float sc[4];
          short tbv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float score = __fadd_rn(pd[k], stay_lp);
            int from = -1;
            float cand = __fadd_rn(lv[k], ms);
            if (cand > score) {
              score = cand;
              from = rs * nq + qd;
            }
            cand = __fsub_rn(__fadd_rn(lv[k], mk), p.skip_pen);
            if (cand > score) {
              score = cand;
              from = rk * q16 + (qd >> 2);
            }
            if (p.use_slip) {
              cand = __fsub_rn(__fadd_rn(lv[k], ml), __fmul_rn(2.0f, p.skip_pen));
              if (cand > score) {
                score = cand;
                from = rl * q64 + (qd >> 4);
              }
            }
            cand = __fadd_rn(start, lv[k]);
            if (cand > score) {
              score = cand;
              from = nhist;
            }
            sc[k] = score;
            tbv[k] = (short)from;
          }
          next4[qd] = make_float4(sc[0], sc[1], sc[2], sc[3]);
          short2* tb2 = reinterpret_cast<short2*>(tb_row + 4 * qd);
          tb2[0] = make_short2(tbv[0], tbv[1]);
          tb2[1] = make_short2(tbv[2], tbv[3]);
          const int gi = rk * q16 + (qd >> 2);
          if (mk > ev || (mk == ev && gi < ei)) {
            ev = mk;
            ei = gi;
          }
        }
      }
      if ((tid & 3) == 0) {
        qval[cur][tid >> 2] = ev;
        qidx[cur][tid >> 2] = ei;
      }
    }
    load(t + AHEAD, lpv, lsv);
    start = __fadd_rn(start, fmaxf(-p.local_pen, stay_lp));
    if (end_lanes && t > 0) {
      end_update(qval[cur ^ 1], qidx[cur ^ 1], nthr >> 2, local_stay_prev, p,
                 nhist, tb_row - (size_t)B * nst2, end);
    }
    local_stay_prev = fmaxf(-p.local_pen, stay_lp);
    __syncthreads();
  };
  for (int t0 = 0; t0 < T; t0 += AHEAD) {
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      if (t0 + a < T) step(t0 + a, ring[a], ring_s[a]);
    }
  }
  if (T > 0 && end_lanes) {
    end_update(qval[(T - 1) & 1], qidx[(T - 1) & 1], nthr >> 2,
               local_stay_prev, p, nhist,
               tb + ((size_t)(T - 1) * B + b) * nst2, end);
  }
  float* f = final_ + (size_t)b * nst2;
  for (int d = tid; d < nhist; d += blockDim.x) f[d] = hist[(T & 1) * nhist + d];
  if (end_lanes && lane == 0) {
    f[nhist] = start;
    f[nhist + 1] = end;
  }
}

template <int NQ>
int launch_fwd(const float* lp, float* final_, short* tb, int T, int B,
               int nhist, const DpParams& p, int nthr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)nhist;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_fwd_kernel<NQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_fwd_kernel<NQ><<<B, nthr + 32, smem, stream>>>(lp, final_, tb, T, B,
                                                         nhist, nthr, p);
  return (int)cudaGetLastError();
}

// Block-wide maximum of the nwarp per-warp values: every thread gets it.
__device__ __forceinline__ float block_max_of(const float* w, int nwarp) {
  float m = w[0];
  for (int i = 1; i < nwarp; ++i) m = fmaxf(m, w[i]);
  return m;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Row (t, blockIdx.x) of a time-major [T, B, S] input, times hscale, into
// shared memory.
__device__ __forceinline__ void stage_row(float* dst, const float* h, int t,
                                          int B, int S, float hscale) {
  const float* src = h + ((size_t)t * B + blockIdx.x) * S;
  for (int k = threadIdx.x; k < S; k += blockDim.x)
    dst[k] = __fmul_rn(src[k], hscale);
}

// The head's logit of history state d from a scaled hidden row hs:
// (hs @ W[:, d] + bd) / tempb.
__device__ __forceinline__ float head_logit(const float* hs,
                                            const float* __restrict__ W,
                                            int S, int nstate, int d, float bd,
                                            float tempb) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < S; ++k) acc = fmaf(hs[k], __ldg(W + (size_t)k * nstate + d), acc);
  return __fdiv_rn(__fadd_rn(acc, bd), tempb);
}

// The stay logit, computed by one warp (lane-strided partial sums, then a
// butterfly): every lane of the warp gets it.
__device__ __forceinline__ float head_stay_logit(const float* hs,
                                                 const float* __restrict__ W,
                                                 int S, int nstate, float bstay,
                                                 float tempb) {
  const int nhist = nstate - 1;
  float part = 0.0f;
  for (int k = threadIdx.x & 31; k < S; k += 32)
    part = fmaf(hs[k], __ldg(W + (size_t)k * nstate + nhist), part);
  return __fdiv_rn(__fadd_rn(warp_sum(part), bstay), tempb);
}

// robustlog of a softmax probability e / sum: log(c0 + c1 * e / sum).
__device__ __forceinline__ float robust_logp(float e, float sum, float c0,
                                             float c1) {
  return logf(__fadd_rn(c0, __fmul_rn(c1, __fdiv_rn(e, sum))));
}

// h [T, B, S], W [S, nstate], bvec [nstate] -> final, tb as the forward.
// Per step: y = ((h * hscale) @ W + b) / tempb, softmax over nstate,
// lp = log(c0 + c1 * p), then the forward's DP step.
__global__ void __launch_bounds__(1024)
viterbi_fused_kernel(const float* __restrict__ h, const float* __restrict__ W,
                     const float* __restrict__ bvec, float* __restrict__ final_,
                     short* __restrict__ tb, int T, int B, int S, int nhist,
                     float hscale, float tempb, float c0, float c1,
                     DpParams p) {
  __shared__ float hist[2][1024];
  __shared__ float wval[2][MAX_WARPS];
  __shared__ int widx[2][MAX_WARPS];
  __shared__ float wred[2][MAX_WARPS];
  __shared__ float y_stay;
  extern __shared__ float s_h[];  // [2, S] scaled hidden row, double-buffered
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int nwarp = nhist >> 5;
  const int nstate = nhist + 1;

  hist[0][d] = -BIG;
  float start = 0.0f;
  float end = -BIG;
  float local_stay_prev = 0.0f;
  const float bd = bvec[d];
  const float bstay = bvec[nhist];
  if (T > 0) stage_row(s_h, h, 0, B, S, hscale);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* hs = s_h + cur * S;
    // Prefetch the next hidden row into the other buffer; it was last read
    // in the previous step's head, before this step's first barrier.
    if (t + 1 < T) stage_row(s_h + (cur ^ 1) * S, h, t + 1, B, S, hscale);
    // Head: logit of history state d, and warp 0 the stay logit.
    const float y = head_logit(hs, W, S, nstate, d, bd, tempb);
    float ys = -CUDART_INF_F;
    if (warp == 0) {
      ys = head_stay_logit(hs, W, S, nstate, bstay, tempb);
      if (lane == 0) y_stay = ys;
    }
    // Softmax maximum over all nstate logits.
    float m = warp_max(fmaxf(y, ys));
    if (lane == 0) wred[0][warp] = m;
    __syncthreads();
    m = block_max_of(wred[0], nwarp);
    const float ystay = y_stay;
    const float e = expf(__fsub_rn(y, m));
    const float s = warp_sum(e);
    if (lane == 0) wred[1][warp] = s;
    __syncthreads();
    const float e_stay = expf(__fsub_rn(ystay, m));
    float sum = e_stay;
    for (int i = 0; i < nwarp; ++i) sum = __fadd_rn(sum, wred[1][i]);
    dp_advance(hist, wval, widx, tb, t, B, robust_logp(e, sum, c0, c1),
               robust_logp(e_stay, sum, c0, c1), start, end, local_stay_prev,
               p, nhist);
    // No barrier here: the next step's head touches neither hist nor the
    // warp buffers before its first barrier, and its writes to wred[0]
    // follow this step's last read of it (before the second barrier).
  }
  __syncthreads();
  dp_finish(hist[T & 1], wval[(T - 1) & 1], widx[(T - 1) & 1], local_stay_prev,
            start, end, p, final_, tb, T, B, nhist);
}

// h [K, T, B, S], W [K, S, nstate], bvec [K, nstate], weights [K] -> final,
// tb as the forward, K <= MAX_ENS. Per step, for each member k in order,
// its head as the fused kernel's: lp_k = log(c0 + c1 * softmax_k) * w_k,
// summed in member order into acc; then acc is renormalised over the
// nstate states, lp = acc - (mx + log sum exp(acc - mx)) with mx its
// maximum, and the forward's DP step runs on lp. Four barriers a step: the
// K softmax maxima, the K softmax sums, the renormalisation's maximum and
// its sum, each through its own per-warp buffer.
__global__ void __launch_bounds__(1024)
viterbi_fused_ens_kernel(const float* __restrict__ h,
                         const float* __restrict__ W,
                         const float* __restrict__ bvec,
                         const float* __restrict__ weights,
                         float* __restrict__ final_, short* __restrict__ tb,
                         int K, int T, int B, int S, int nhist, float hscale,
                         float tempb, float c0, float c1, DpParams p) {
  __shared__ float hist[2][1024];
  __shared__ float wval[2][MAX_WARPS];
  __shared__ int widx[2][MAX_WARPS];
  __shared__ float wmax[MAX_ENS][MAX_WARPS];  // each member's softmax maximum
  __shared__ float wsum[MAX_ENS][MAX_WARPS];  // each member's softmax sum
  __shared__ float wnorm[2][MAX_WARPS];       // the renormalisation's max, sum
  __shared__ float y_stay[MAX_ENS];
  extern __shared__ float s_h[];  // [2, K, S] scaled hidden rows
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int nwarp = nhist >> 5;
  const int nstate = nhist + 1;
  const size_t hstride = (size_t)T * B * S;  // one member's h
  const size_t wstride = (size_t)S * nstate;  // one member's W

  hist[0][d] = -BIG;
  float start = 0.0f;
  float end = -BIG;
  float local_stay_prev = 0.0f;
  if (T > 0) {
    for (int k = 0; k < K; ++k)
      stage_row(s_h + k * S, h + k * hstride, 0, B, S, hscale);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* hs = s_h + cur * K * S;
    // The next step's rows, into the buffer last read before this step's
    // first barrier (as the fused kernel does).
    if (t + 1 < T) {
      for (int k = 0; k < K; ++k)
        stage_row(s_h + ((cur ^ 1) * K + k) * S, h + k * hstride, t + 1, B,
                  S, hscale);
    }
    float y[MAX_ENS], e[MAX_ENS], e_stay[MAX_ENS];
#pragma unroll
    for (int k = 0; k < MAX_ENS; ++k) {
      if (k < K) {
        const float* Wk = W + k * wstride;
        const float* bk = bvec + (size_t)k * nstate;
        y[k] = head_logit(hs + k * S, Wk, S, nstate, d, __ldg(bk + d), tempb);
        float ys = -CUDART_INF_F;
        if (warp == 0) {
          ys = head_stay_logit(hs + k * S, Wk, S, nstate, __ldg(bk + nhist),
                               tempb);
          if (lane == 0) y_stay[k] = ys;
        }
        const float m = warp_max(fmaxf(y[k], ys));
        if (lane == 0) wmax[k][warp] = m;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_ENS; ++k) {
      if (k < K) {
        const float m = block_max_of(wmax[k], nwarp);
        e[k] = expf(__fsub_rn(y[k], m));
        e_stay[k] = expf(__fsub_rn(y_stay[k], m));
        const float s = warp_sum(e[k]);
        if (lane == 0) wsum[k][warp] = s;
      }
    }
    __syncthreads();
    float acc = 0.0f;
    float acc_stay = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_ENS; ++k) {
      if (k < K) {
        float sum = e_stay[k];
        for (int i = 0; i < nwarp; ++i) sum = __fadd_rn(sum, wsum[k][i]);
        const float wk = __ldg(weights + k);
        const float lk = __fmul_rn(robust_logp(e[k], sum, c0, c1), wk);
        const float ls = __fmul_rn(robust_logp(e_stay[k], sum, c0, c1), wk);
        acc = k ? __fadd_rn(acc, lk) : lk;
        acc_stay = k ? __fadd_rn(acc_stay, ls) : ls;
      }
    }
    // Renormalise over the nstate states.
    const float m = warp_max(fmaxf(acc, acc_stay));
    if (lane == 0) wnorm[0][warp] = m;
    __syncthreads();
    const float mx = block_max_of(wnorm[0], nwarp);
    const float s = warp_sum(expf(__fsub_rn(acc, mx)));
    if (lane == 0) wnorm[1][warp] = s;
    __syncthreads();
    float total = expf(__fsub_rn(acc_stay, mx));
    for (int i = 0; i < nwarp; ++i) total = __fadd_rn(total, wnorm[1][i]);
    const float lse = __fadd_rn(mx, logf(total));
    dp_advance(hist, wval, widx, tb, t, B, __fsub_rn(acc, lse),
               __fsub_rn(acc_stay, lse), start, end, local_stay_prev, p,
               nhist);
    // No barrier here, as in the fused kernel: every shared buffer the next
    // step writes before its first barrier was last read before this
    // step's last one.
  }
  __syncthreads();
  dp_finish(hist[T & 1], wval[(T - 1) & 1], widx[(T - 1) & 1], local_stay_prev,
            start, end, p, final_, tb, T, B, nhist);
}

// final [B, nst2], tb [T, B, nst2] int16 -> score [B], path [B, T+1] int32.
__global__ void viterbi_backtrace_kernel(const float* __restrict__ final_,
                                         const short* __restrict__ tb,
                                         float* __restrict__ score,
                                         int* __restrict__ path, int T, int B,
                                         int nst2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* f = final_ + (size_t)b * nst2;
  int cur = 0;
  float best = f[0];
  for (int i = 1; i < nst2; ++i) {
    if (f[i] > best) {
      best = f[i];
      cur = i;
    }
  }
  score[b] = best;
  int* pb = path + (size_t)b * (T + 1);
  for (int t = T - 1; t >= 0; --t) {
    const int state = tb[((size_t)t * B + b) * nst2 + cur];
    pb[t + 1] = state >= 0 ? cur : -1;
    if (state >= 0) cur = state;
  }
  pb[0] = cur;
  // Leading START and trailing END runs become stays (-1).
  const int start_state = nst2 - 2;
  const int end_state = nst2 - 1;
  for (int i = 0; i <= T && pb[i] == start_state; ++i) pb[i] = -1;
  for (int i = T; i >= 0 && pb[i] == end_state; --i) pb[i] = -1;
}

}  // namespace

extern "C" {

// The forward kernel on nthr DP threads (whole warps, at most 512) with nq
// quads a thread (1, 2, 4, 8 or 16; ops/viterbi.py:forward_launch picks
// them), and one more warp for the END state.
int scrappie_viterbi_fwd(const float* lp, float* final_, short* tb, int T,
                         int B, int nhist, float stay_pen, float skip_pen,
                         float local_pen, int use_slip, int nthr, int nq,
                         cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (nthr < 32 || nthr > FWD_THREADS || nthr % 32 || (long)4 * nthr * nq < nhist ||
      nhist % 16 || (use_slip && nhist % 64))
    return (int)cudaErrorInvalidValue;
  const DpParams p{stay_pen, skip_pen, local_pen, use_slip};
  auto go = [&](auto fn) { return fn(lp, final_, tb, T, B, nhist, p, nthr, stream); };
  switch (nq) {
    case 1: return go(launch_fwd<1>);
    case 2: return go(launch_fwd<2>);
    case 4: return go(launch_fwd<4>);
    case 8: return go(launch_fwd<8>);
    case 16: return go(launch_fwd<16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

int scrappie_viterbi_fused(const float* h, const float* W, const float* bvec,
                           float* final_, short* tb, int T, int B, int S,
                           int nhist, float hscale, float tempb, float c0,
                           float c1, float stay_pen, float skip_pen,
                           float local_pen, int use_slip,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  const DpParams p{stay_pen, skip_pen, local_pen, use_slip};
  const size_t smem = sizeof(float) * 2 * (size_t)S;
  viterbi_fused_kernel<<<B, nhist, smem, stream>>>(
      h, W, bvec, final_, tb, T, B, S, nhist, hscale, tempb, c0, c1, p);
  return (int)cudaGetLastError();
}

int scrappie_viterbi_fused_ens(const float* h, const float* W,
                               const float* bvec, const float* weights,
                               float* final_, short* tb, int K, int T, int B,
                               int S, int nhist, float hscale, float tempb,
                               float c0, float c1, float stay_pen,
                               float skip_pen, float local_pen, int use_slip,
                               cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (K < 1 || K > MAX_ENS) return (int)cudaErrorInvalidValue;
  const DpParams p{stay_pen, skip_pen, local_pen, use_slip};
  const size_t smem = sizeof(float) * 2 * (size_t)K * S;
  viterbi_fused_ens_kernel<<<B, nhist, smem, stream>>>(
      h, W, bvec, weights, final_, tb, K, T, B, S, nhist, hscale, tempb, c0,
      c1, p);
  return (int)cudaGetLastError();
}

int scrappie_viterbi_backtrace(const float* final_, const short* tb,
                               float* score, int* path, int T, int B, int nst2,
                               cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  const int threads = 64;
  viterbi_backtrace_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      final_, tb, score, path, T, B, nst2);
  return (int)cudaGetLastError();
}

}  // extern "C"
