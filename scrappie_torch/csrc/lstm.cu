// The recurrence of one peephole-LSTM layer, over inputs projected before
// (csrc/project.cu writes x @ iW + b for every step and row).
//
// Replaces: scrappie_tpu/ops/lstm.py:_lstm_kernel (wrapper lstm_layer_tm,
// pallas_call at :131), with the projection kernel. Per time step, for one
// batch row:
//
//   xF = (x[t] @ iW + b) + h @ sW                        [4S], this order
//   c  = sigmoid(xF[2S:3S] + c * p_forget) * c
//      + sigmoid(xF[S:2S] + c * p_in) * tanh(xF[:S])
//   h  = sigmoid(xF[3S:] + c * p_out) * tanh(c)          (c is the new c)
//
// with h = c = 0 before the first step; `reverse` walks time backwards.
// Gates are [cell-in | input | forget | output], peep [input | forget |
// output].
//
// What bounds it on the H100: the recurrence is sequential in T, so one
// row's time is T times the latency of one step: a length-S dot product
// per thread, two block barriers and the gate nonlinearities. The
// arithmetic, 2 S 4S flops per row and step, is far below that latency.
// What must not happen is to stream sW from L2 at every step.
//
// Design: one block per batch row and one thread per gate column (4S
// threads). sW stays in dynamic shared memory for the whole scan (147 456 B
// at S = 96), beside h, c and the [4S] gate values. Thread j takes its dot
// product h @ sW[:, j] (four partial sums, to shorten the chain of
// dependent FMAs), adds xproj[t, b, j] (loaded one step ahead into a
// register) and applies its gate's nonlinearity; after a barrier S threads
// update c and h. Exactly T steps run: there is no time padding and no lane
// padding.
//
// Big-S mode (template switch kGlobal): where sW does not fit in shared
// memory or 4S exceeds the 1024 threads of a block, sW is read from global
// memory (it stays in L2: 1.3 MB at S = 288) and each thread walks the gate
// columns j = tid, tid + blockDim, ...; xproj is read in the step that uses
// it. Same arithmetic in the same order.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// Gate column j's peephole weight (0 for the cell-in and output gates).
__device__ __forceinline__ float gate_peep(const float* __restrict__ peep,
                                           int S, int j) {
  const int gate = j / S;
  return (gate == 1 || gate == 2) ? __ldg(peep + (gate - 1) * S + j - gate * S)
                                  : 0.0f;
}

// Gate column j's value for this step, from its projected input xcur and
// its peephole weight p_gate.
__device__ __forceinline__ float lstm_gate(const float* w, const float* s_h,
                                           const float* s_c, float p_gate,
                                           float xcur, int S, int j) {
  const int S4 = 4 * S;
  const int gate = j / S;  // 0 cell-in, 1 input, 2 forget, 3 output
  const int u = j - gate * S;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= S; k += 4) {
    a0 = fmaf(s_h[k], w[k * S4 + j], a0);
    a1 = fmaf(s_h[k + 1], w[(k + 1) * S4 + j], a1);
    a2 = fmaf(s_h[k + 2], w[(k + 2) * S4 + j], a2);
    a3 = fmaf(s_h[k + 3], w[(k + 3) * S4 + j], a3);
  }
  for (; k < S; ++k) a0 = fmaf(s_h[k], w[k * S4 + j], a0);
  const float xf = __fadd_rn(xcur, __fadd_rn(__fadd_rn(a0, a1),
                                             __fadd_rn(a2, a3)));
  if (gate == 0) return tanhf(xf);
  if (gate == 3) return xf;  // the output gate waits for the new c
  return sigmoid_f32(__fadd_rn(xf, __fmul_rn(s_c[u], p_gate)));
}

// xproj [T, B, 4S], sW [S, 4S], peep [3S] -> y [T, B, S].
template <bool kGlobal>
__global__ void __launch_bounds__(1024)
lstm_recurrence_kernel(const float* __restrict__ xproj,
                       const float* __restrict__ sW,
                       const float* __restrict__ peep, float* __restrict__ y,
                       int T, int B, int S, int reverse) {
  extern __shared__ float smem[];
  const int S4 = 4 * S;
  float* s_h = smem;       // [S]
  float* s_c = s_h + S;    // [S]
  float* s_g = s_c + S;    // [4S] gate values of this step
  float* s_sW = s_g + S4;  // [S, 4S], on-chip mode
  const float* w = kGlobal ? sW : s_sW;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (!kGlobal) {
    for (int i = tid; i < S * S4; i += blockDim.x) s_sW[i] = sW[i];
  }
  for (int u = tid; u < S; u += blockDim.x) {
    s_h[u] = 0.0f;
    s_c[u] = 0.0f;
  }
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  // On-chip mode: blockDim.x == 4S, thread tid owns column tid and keeps
  // its peephole weights in registers.
  float xnext = kGlobal ? 0.0f : xproj[((size_t)t0 * B + b) * S4 + tid];
  const float p_mine = kGlobal ? 0.0f : gate_peep(peep, S, tid);
  const float p_out_mine = !kGlobal && tid < S ? __ldg(peep + 2 * S + tid) : 0.0f;
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    if (kGlobal) {
      const float* xrow = xproj + ((size_t)t * B + b) * S4;
      for (int j = tid; j < S4; j += blockDim.x)
        s_g[j] = lstm_gate(w, s_h, s_c, gate_peep(peep, S, j), xrow[j], S, j);
    } else {
      const float xcur = xnext;
      if (n + 1 < T) xnext = xproj[((size_t)(t + dt) * B + b) * S4 + tid];
      s_g[tid] = lstm_gate(w, s_h, s_c, p_mine, xcur, S, tid);
    }
    __syncthreads();

    for (int u = tid; u < S; u += blockDim.x) {
      const float p_out = kGlobal ? __ldg(peep + 2 * S + u) : p_out_mine;
      const float c_new = __fadd_rn(__fmul_rn(s_g[2 * S + u], s_c[u]),
                                    __fmul_rn(s_g[S + u], s_g[u]));
      const float o = sigmoid_f32(__fadd_rn(s_g[3 * S + u],
                                            __fmul_rn(c_new, p_out)));
      const float h = __fmul_rn(o, tanhf(c_new));
      s_c[u] = c_new;
      s_h[u] = h;
      y[((size_t)t * B + b) * S + u] = h;
    }
    __syncthreads();
  }
}

template <bool kGlobal>
int launch(const float* xproj, const float* sW, const float* peep, float* y,
           int T, int B, int S, int reverse, int threads, size_t smem,
           cudaStream_t stream) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel<kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_kernel<kGlobal><<<B, threads, smem, stream>>>(
      xproj, sW, peep, y, T, B, S, reverse);
  return (int)cudaGetLastError();
}

// Dynamic shared memory each mode needs for size S: sW, h, c and the gate
// values on chip; h, c and the gate values alone in the big-S mode.
size_t smem_bytes(int S, int global) {
  return sizeof(float) * ((global ? 0 : (size_t)4 * S * S) + 6 * (size_t)S);
}

}  // namespace

extern "C" {

// xproj [T, B, 4S], sW [S, 4S], peep [3S] -> y [T, B, S]; all fp32,
// contiguous, on the current device. global = 0: sW in shared memory, 4S
// threads (4S <= 1024); global = 1: the big-S mode. Returns a cudaError_t.
int scrappie_lstm_recurrence(const float* xproj, const float* sW,
                             const float* peep, float* y, int T, int B, int S,
                             int reverse, int global, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, global);
  if (!global)
    return launch<false>(xproj, sW, peep, y, T, B, S, reverse, 4 * S, smem,
                         stream);
  const int threads = 4 * S < 1024 ? ((4 * S + 31) / 32) * 32 : 1024;
  return launch<true>(xproj, sW, peep, y, T, B, S, reverse, threads, smem,
                      stream);
}

}  // extern "C"
