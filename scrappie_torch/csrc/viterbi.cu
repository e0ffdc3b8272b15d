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
//  * backtrace (replaces _bt_kernel): the kernel it replaced, one thread a
//    row, made one dependent 2-byte load a step from a traceback of
//    T B (nhist+2) 2 bytes (263 MB at T = 2000, B = 64, beyond the 50 MB
//    L2): about 420, 760 and 360 cycles a step at B = 8, 64 and at a
//    stitch bucket, 4 rows of 12 500 (H100); without its path stores,
//    3-13% less. Now nothing on the walk's chain leaves shared memory.
//    One block a row streams the row's traceback rows t = T-1 down through
//    a ring in shared memory, as the TPU kernel streams [CT, Bt, nhist]
//    blocks through VMEM: one bulk copy (cp.async.bulk, the TMA unit) a
//    row, issued by a copier warp, full and empty mbarriers a chunk of
//    rows. A row starts only 4-byte aligned (2 (nhist+2) bytes = 4 mod
//    16) and bulk copies need 16: the slot takes the row's 16-byte blocks
//    from its start rounded down to its end rounded up, and the walker
//    reads it at (start & 15); only the blocks past tb's two ends are
//    copied two bytes at a time. A step is a shared-memory load, a compare
//    and a select (the next row's address for a move and for a stay are
//    computed aside): about 60 cycles, and the ring supplies a 2 KB row
//    about every 100 (one SM's bulk copies reach about 20 B a cycle,
//    whether from L2 or DRAM; 16-, 64- or 128-byte alignment alike, and a
//    cp.async ring from four warps supplies half that). So a row takes
//    about 100 cycles a step on its SM whatever B, and at small B (a stitch
//    bucket, the fast engine's 8 rows) most SMs idle. There the walk is
//    also split in time: segment k of a row maps each state entering it to
//    the state leaving it (a block walks all nhist + 2 states at once, 224
//    threads holding up to 16 each in registers), and the walk's block for
//    segment k starts from the first argmax taken through the later
//    segments' maps. The leading START and trailing END runs are then
//    found by a third kernel's reductions over the path (first entry not
//    START, last not END); in one pass the walker tracks them as it goes
//    (the trailing run is written as stays while every entry from T down
//    is END; the lowest entry that is not START bounds the leading run,
//    which the block blanks at the end). The first argmax of the finals is
//    a block reduction (strict >, smallest index on ties). Path entries
//    are staged in shared memory (int16) and the copier warp writes each
//    chunk's out, contiguous.
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
// DP step and the final write with the fused kernel.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float BIG = 1.0e30f;
constexpr int MAX_WARPS = 32;
constexpr int MAX_ENS = 4;  // members of the fused ensemble kernel
constexpr int FWD_THREADS = 512;  // at most, the forward's history threads
constexpr int AHEAD = 3;  // steps of log posteriors the forward loads ahead
// The backtrace: four warps a block (warp 0 walks, warp 1 copies, a lane a
// row, all four take the first argmax); a ring of chunks of traceback
// rows, about BT_RING_BYTES, at most BT_MAX_SMEM with the path stage.
constexpr int BT_THREADS = 128;
// The segments' maps kernel: warp 0 copies, the others walk up to 16
// states a thread (nst2 <= 16 * (BT_MAPS_THREADS - 32)).
constexpr int BT_MAPS_THREADS = 256;
constexpr int BT_MAX_NBUF = 6;
constexpr int BT_MAX_CHUNK = 16;
constexpr int BT_RING_BYTES = 192 * 1024;
constexpr size_t BT_MAX_SMEM = 232448 - 1024;  // less the static arrays

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Adds `bytes` to the transfer the barrier's current phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the TMA unit; completion is counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A ring slot: a row's 2 nst2 bytes from their start rounded down to 16
// bytes (at most 14 before it) to their end rounded up.
__host__ __device__ __forceinline__ int bt_slot_bytes(int nst2) {
  return (2 * nst2 + 14 + 15) / 16 * 16;
}

__device__ __forceinline__ const char* align16_down(const char* p) {
  return reinterpret_cast<const char*>((uintptr_t)p & ~(uintptr_t)15);
}

__device__ __forceinline__ const char* align16_up(const char* p) {
  return reinterpret_cast<const char*>(((uintptr_t)p + 15) & ~(uintptr_t)15);
}

// Segment k of K of a row's T steps: rows [t0, t1), L = ceil(T / K) rows
// each but the last.
__device__ __forceinline__ void bt_segment(int T, int K, int k, int& t0,
                                           int& t1) {
  const int L = (T + K - 1) / K;
  t0 = min(k * L, T);
  t1 = min(t0 + L, T);
}

// Byte (start % 16) of slot r holds row t's first entry.
__device__ __forceinline__ int bt_row_offset(const short* tb, int t, int B,
                                             int b, int nst2) {
  return (int)((uintptr_t)(tb + ((size_t)t * B + b) * nst2) & 15);
}

// The path entries t + 1 of chunk c's rows t = t1-1 - c ch - r, from the
// walker's stage to pb, contiguous (lane r writes row r's).
__device__ __forceinline__ void bt_flush(int* pb, const short* staged, int t1,
                                         int t0, int ch, int nbuf, int c,
                                         int lane) {
  if (lane < min(ch, t1 - t0 - c * ch))
    pb[t1 - c * ch - lane] = staged[(c % nbuf) * ch + lane];
}

// The copier warp. Chunk c of the rows t = t1-1 down to t0 goes into
// buffer c % nbuf once its walkers have released the chunk before it there
// (whose path entries, when pb is given, are then written out): lane r
// copies row t = t1-1 - c ch - r into slot (c % nbuf) ch + r. A slot holds
// its row's 16-byte blocks, from the row's start rounded down: one bulk
// copy. The bytes of a block that reaches outside tb (only at its two ends)
// are copied two at a time, then fenced from the bulk copies that may
// write the slot later. Last, the path entries of the final chunks.
__device__ void bt_copier(unsigned char* ring, const short* staged,
                          uint64_t* full, uint64_t* empty, const short* tb,
                          int* pb, int T, int B, int b, int t1, int t0,
                          int nst2, int ch, int nbuf, int lane) {
  const char* lo = reinterpret_cast<const char*>(tb);
  const char* hi = lo + (size_t)T * B * nst2 * sizeof(short);
  const int slot_bytes = bt_slot_bytes(nst2);
  const int nch = (t1 - t0 + ch - 1) / ch;
  for (int c = 0; c < nch; ++c) {
    const int buf = c % nbuf;
    if (c >= nbuf) {
      mbar_wait(&empty[buf], (c / nbuf - 1) & 1);
      if (pb) bt_flush(pb, staged, t1, t0, ch, nbuf, c - nbuf, lane);
    }
    const int t = t1 - 1 - c * ch - lane;
    if (lane < ch && t >= t0) {
      const char* gs = lo + ((size_t)t * B + b) * nst2 * sizeof(short);
      const char* ge = gs + nst2 * sizeof(short);
      const char* a0 = align16_down(gs);
      const char* x0 = a0 > lo ? a0 : align16_up(lo);  // bulk copy [x0, x1)
      const char* x1 = align16_up(ge) < hi ? align16_up(ge) : align16_down(hi);
      unsigned char* slot = ring + (size_t)(buf * ch + lane) * slot_bytes;
      if (gs < x0 || x1 < ge) {
        for (const char* p = gs; p < ge && p < x0; p += 2)
          *reinterpret_cast<short*>(slot + (p - a0)) =
              *reinterpret_cast<const short*>(p);
        for (const char* p = x1 > gs ? x1 : gs; p < ge; p += 2)
          *reinterpret_cast<short*>(slot + (p - a0)) =
              *reinterpret_cast<const short*>(p);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      if (x1 > x0) {
        mbar_expect(&full[buf], (unsigned)(x1 - x0));
        bulk_copy(slot + (x0 - a0), x0, (unsigned)(x1 - x0), &full[buf]);
      }
    }
    __syncwarp();  // every row's bytes counted before the phase can end
    if (lane == 0) mbar_arrive(&full[buf]);
  }
  if (!pb) return;
  for (int c = max(nch - nbuf, 0); c < nch; ++c) {
    mbar_wait(&empty[c % nbuf], (c / nbuf) & 1);
    bt_flush(pb, staged, t1, t0, ch, nbuf, c, lane);
  }
}

__device__ __forceinline__ void bt_init_barriers(uint64_t* full,
                                                 uint64_t* empty, int nbuf,
                                                 unsigned walkers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbuf; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], walkers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The first argmax of the finals, on every thread of the block: each
// thread over its strided share, then the warps (the smaller index wins a
// tie), then the block. Ends with a barrier, which also publishes the
// mbarriers' initialisation.
__device__ __forceinline__ int bt_first_argmax(const float* f, int nst2,
                                               float& best) {
  __shared__ float warp_v[BT_THREADS / 32];
  __shared__ int warp_i[BT_THREADS / 32];
  float v = -CUDART_INF_F;
  int x = INT_MAX;
  for (int i = threadIdx.x; i < nst2; i += BT_THREADS) {
    const float fi = f[i];
    if (x == INT_MAX || fi > v) {
      v = fi;
      x = i;
    }
  }
  warp_argmax(v, x);
  if (threadIdx.x % 32 == 0) {
    warp_v[threadIdx.x / 32] = v;
    warp_i[threadIdx.x / 32] = x;
  }
  __syncthreads();
  v = warp_v[0];
  x = warp_i[0];
  for (int w = 1; w < BT_THREADS / 32; ++w) {
    if (warp_v[w] > v || (warp_v[w] == v && warp_i[w] < x)) {
      v = warp_v[w];
      x = warp_i[w];
    }
  }
  best = v;
  return x;
}

// The walk: final [B, nst2], tb [T, B, nst2] int16 -> score [B], path
// [B, T+1] int32. Block (b, k) walks segment k of row b (K = gridDim.y),
// its rows t = t1-1 down to t0 streaming through a ring of nbuf chunks of
// ch rows in shared memory: warp 1 issues a chunk's bulk copies (a lane a
// row) as soon as lane 0 of warp 0, the walker, has released the buffer,
// one full and one empty mbarrier a buffer; warp 1 writes each walked
// chunk's path entries out, contiguous. With one segment (kSeg false) the walker
// starts from the first argmax of the finals and writes the leading START
// and trailing END runs as stays; with several, from the later segments'
// maps applied to it, and viterbi_bt_runs_kernel rewrites the runs.
template <bool kSeg>
__global__ void __launch_bounds__(BT_THREADS)
viterbi_backtrace_kernel(const float* __restrict__ final_,
                         const short* __restrict__ tb,
                         const short* __restrict__ maps,
                         float* __restrict__ score, int* __restrict__ path,
                         int T, int B, int nst2, int ch, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[BT_MAX_NBUF], empty[BT_MAX_NBUF];
  __shared__ int lead_end;
  const int b = blockIdx.x, k = blockIdx.y, K = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot_bytes = bt_slot_bytes(nst2);
  unsigned char* ring = smem;
  short* staged = reinterpret_cast<short*>(ring + (size_t)nbuf * ch * slot_bytes);
  int t0, t1;
  bt_segment(T, K, k, t0, t1);
  int* pb = path + (size_t)b * (T + 1);
  bt_init_barriers(full, empty, nbuf, 1);
  float best;
  const int x = bt_first_argmax(final_ + (size_t)b * nst2, nst2, best);
  if (warp >= 2) return;
  if (warp == 1) {
    bt_copier(ring, staged, full, empty, tb, pb, T, B, b, t1, t0, nst2, ch,
              nbuf, lane);
  } else if (lane == 0) {
    if (k == K - 1) score[b] = best;
    const int start_state = nst2 - 2, end_state = nst2 - 1;
    const int row_step = (int)(((size_t)B * nst2 * sizeof(short)) & 15);
    int cur = x;
    if (kSeg)  // the state entering row t1 - 1
      for (int j = K - 1; j > k; --j) cur = maps[((size_t)b * K + j) * nst2 + cur];
    // One segment: whether every path entry so far (from T down) is END
    // (the trailing run, written as -1), and the lowest entry that is not
    // START (the leading run lies below it).
    bool trailing = true;
    int lowest = T + 1;
    const int nch = (t1 - t0 + ch - 1) / ch;
    for (int c = 0; c < nch; ++c) {
      const int buf = c % nbuf;
      mbar_wait(&full[buf], (c / nbuf) & 1);
      // `at` is the byte of shared memory the step reads, tb[t, b, cur]. A
      // step's chain is that load, a compare and a select between the next
      // row's entry for the state read and for cur (a stay), both
      // computed aside.
      const int top = t1 - 1 - c * ch;
      int off = bt_row_offset(tb, top, B, b, nst2);
      int row = buf * ch * slot_bytes + off;
      int at = row + 2 * cur;
      short* out = staged + buf * ch;
      const int rows = min(ch, t1 - t0 - c * ch);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int state = *reinterpret_cast<const short*>(smem + at);
        const int next_off = (off - row_step) & 15;
        const int next = row + slot_bytes + next_off - off;
        const bool emit = state >= 0;
        const int val = emit ? cur : -1;
        if (!kSeg) {
          trailing = trailing && val == end_state;
          lowest = val != start_state ? top - r + 1 : lowest;
        }
        out[r] = (short)(!kSeg && trailing ? -1 : val);
        at = emit ? next + 2 * state : next + 2 * cur;
        cur = emit ? state : cur;
        row = next;
        off = next_off;
      }
      mbar_arrive(&empty[buf]);
    }
    if (k == 0) {
      if (!kSeg) {
        trailing = trailing && cur == end_state;
        if (cur != start_state) lowest = 0;
        lead_end = lowest;
      }
      pb[0] = !kSeg && trailing ? -1 : cur;
    }
  }
  if (kSeg) return;
  // Warps 0 and 1: every entry is written; then the leading START run,
  // [0, lead_end), becomes stays (-1).
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
  if (warp == 0)
    for (int i = lane; i < lead_end; i += 32) pb[i] = -1;
}

// The maps of the segments: block (b, k) walks segment k of row b from
// every state s at once, maps[b, k, s] = the state entering row t0 - 1
// (the path's entry t0) from state s entering row t1 - 1. Warp 0 copies
// as in the walk; the other warps walk, thread w the states w + i WALKERS
// (i < SPT) in registers, row by row, and release a buffer warp by warp.
template <int SPT>
__global__ void __launch_bounds__(BT_MAPS_THREADS)
viterbi_bt_maps_kernel(const short* __restrict__ tb, short* __restrict__ maps,
                       int T, int B, int nst2, int ch, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[BT_MAX_NBUF], empty[BT_MAX_NBUF];
  constexpr int WALKERS = BT_MAPS_THREADS - 32;
  const int b = blockIdx.x, k = blockIdx.y, K = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot_bytes = bt_slot_bytes(nst2);
  int t0, t1;
  bt_segment(T, K, k, t0, t1);
  bt_init_barriers(full, empty, nbuf, WALKERS / 32);
  __syncthreads();
  if (warp == 0) {
    bt_copier(smem, nullptr, full, empty, tb, nullptr, T, B, b, t1, t0, nst2,
              ch, nbuf, lane);
    return;
  }
  const int w = threadIdx.x - 32;
  int x[SPT];  // past nst2, a repeat of the last state, not stored
#pragma unroll
  for (int i = 0; i < SPT; ++i) x[i] = min(w + i * WALKERS, nst2 - 1);
  const int row_step = (int)(((size_t)B * nst2 * sizeof(short)) & 15);
  const int nch = (t1 - t0 + ch - 1) / ch;
  for (int c = 0; c < nch; ++c) {
    const int buf = c % nbuf;
    mbar_wait(&full[buf], (c / nbuf) & 1);
    int off = bt_row_offset(tb, t1 - 1 - c * ch, B, b, nst2);
    const unsigned char* slot = smem + (size_t)buf * ch * slot_bytes;
    const int rows = min(ch, t1 - t0 - c * ch);
    for (int r = 0; r < rows; ++r) {
      const short* row = reinterpret_cast<const short*>(slot + off);
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int state = row[x[i]];
        x[i] = state >= 0 ? state : x[i];
      }
      slot += slot_bytes;
      off = (off - row_step) & 15;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[buf]);
  }
  short* out = maps + ((size_t)b * K + k) * nst2;
#pragma unroll
  for (int i = 0; i < SPT; ++i)
    if (w + i * WALKERS < nst2) out[w + i * WALKERS] = (short)x[i];
}

// After the segmented walk: row b's leading START run, [0, the first entry
// that is not START), and trailing END run, (the last that is not END, T],
// become stays (-1).
__global__ void __launch_bounds__(256)
viterbi_bt_runs_kernel(int* __restrict__ path, int T, int nst2) {
  __shared__ int lead, trail;
  int* pb = path + (size_t)blockIdx.x * (T + 1);
  if (threadIdx.x == 0) {
    lead = T + 1;
    trail = -1;
  }
  __syncthreads();
  int my_lead = T + 1, my_trail = -1;
  for (int i = threadIdx.x; i <= T; i += blockDim.x) {
    const int v = pb[i];
    if (v != nst2 - 2) my_lead = min(my_lead, i);
    if (v != nst2 - 1) my_trail = max(my_trail, i);
  }
  my_lead = __reduce_min_sync(0xffffffffu, my_lead);
  my_trail = __reduce_max_sync(0xffffffffu, my_trail);
  if (threadIdx.x % 32 == 0) {
    atomicMin(&lead, my_lead);
    atomicMax(&trail, my_trail);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < lead; i += blockDim.x) pb[i] = -1;
  for (int i = trail + 1 + threadIdx.x; i <= T; i += blockDim.x) pb[i] = -1;
}

// The ring for rows of nst2 states, with `reserve` bytes of shared memory
// beside it: nbuf chunks of ch rows in about BT_RING_BYTES, up to
// BT_MAX_CHUNK rows a chunk, at least three chunks, up to BT_MAX_NBUF.
// Rows too long for three there take one a chunk, three (or two) as fit
// BT_MAX_SMEM. ch = 0 if two do not fit. Returns the shared memory bytes.
size_t bt_ring(int nst2, size_t reserve, int& ch, int& nbuf) {
  const size_t slot = bt_slot_bytes(nst2) + sizeof(short);
  size_t rows = BT_RING_BYTES / slot;
  if (rows < 3 && BT_MAX_SMEM > reserve) rows = (BT_MAX_SMEM - reserve) / slot;
  if (rows < 2 || reserve >= BT_MAX_SMEM) {
    ch = nbuf = 0;
    return 0;
  }
  ch = (int)(rows / 3 < 1 ? 1 : (rows / 3 < BT_MAX_CHUNK ? rows / 3 : BT_MAX_CHUNK));
  nbuf = (int)(rows / ch < BT_MAX_NBUF ? rows / ch : BT_MAX_NBUF);
  return (size_t)nbuf * ch * slot + reserve;
}

template <class Kernel>
cudaError_t bt_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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

// The backtrace, each row's walk in K segments: K = 1, one block a row;
// K > 1, the maps kernel (maps: [B, K, nst2] int16 scratch), the walk and
// the runs kernel (ops/viterbi.py:backtrace_segments picks K).
int scrappie_viterbi_backtrace(const float* final_, const short* tb,
                               float* score, int* path, short* maps, int T,
                               int B, int nst2, int K, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (nst2 < 1 || K < 1 || K > 65535 || (K > 1 && !maps))
    return (int)cudaErrorInvalidValue;
  int ch, nbuf;
  const size_t smem = bt_ring(nst2, 0, ch, nbuf);
  if (ch == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (K == 1) {
    if ((err = bt_smem(viterbi_backtrace_kernel<false>, smem))) return (int)err;
    viterbi_backtrace_kernel<false><<<dim3(B, 1), BT_THREADS, smem, stream>>>(
        final_, tb, nullptr, score, path, T, B, nst2, ch, nbuf);
    return (int)cudaGetLastError();
  }
  int mch, mnbuf;
  const size_t msmem = bt_ring(nst2, 0, mch, mnbuf);
  const int spt = (nst2 + BT_MAPS_THREADS - 33) / (BT_MAPS_THREADS - 32);
  auto maps_kernel = spt <= 1   ? viterbi_bt_maps_kernel<1>
                     : spt <= 2 ? viterbi_bt_maps_kernel<2>
                     : spt <= 4 ? viterbi_bt_maps_kernel<4>
                     : spt <= 8 ? viterbi_bt_maps_kernel<8>
                                : viterbi_bt_maps_kernel<16>;
  if (spt > 16) return (int)cudaErrorInvalidValue;
  if ((err = bt_smem(maps_kernel, msmem))) return (int)err;
  maps_kernel<<<dim3(B, K), BT_MAPS_THREADS, msmem, stream>>>(
      tb, maps, T, B, nst2, mch, mnbuf);
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = bt_smem(viterbi_backtrace_kernel<true>, smem))) return (int)err;
  viterbi_backtrace_kernel<true><<<dim3(B, K), BT_THREADS, smem, stream>>>(
      final_, tb, maps, score, path, T, B, nst2, ch, nbuf);
  if ((err = cudaGetLastError())) return (int)err;
  viterbi_bt_runs_kernel<<<B, 256, 0, stream>>>(path, T, nst2);
  return (int)cudaGetLastError();
}

}  // extern "C"
