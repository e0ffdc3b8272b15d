// One peephole-LSTM layer with the input projection.
//
// Replaces: scrappie_tpu/ops/lstm.py:_lstm_kernel (wrapper lstm_layer_tm,
// pallas_call at :131). Per time step, for one batch row:
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
// arithmetic, 2 (C + S) 4S flops per row and step (19.3 GFLOP for a layer
// at C = S = 96, T = 2048, B = 64: 0.29 ms at the fp32 peak), is far below
// that latency. What must not happen is to stream sW from L2 at every
// step.
//
// Design: two kernels. The GRU kernel's layout (all weights in shared
// memory, gru.cu) does not fit: iW and sW are 294 912 B at C = S = 96,
// more than the 232 448 B a block may use.
//   1. lstm_project_kernel: xproj = x @ iW + b for all T*B rows at once, a
//      plain tiled fp32 product (64 x 64 output tiles, 16-deep slices of
//      x and iW in shared memory, 4 x 4 outputs per thread, FMA in order
//      of k, then the bias), into a [T, B, 4S] scratch the wrapper
//      allocates (201 MB at T = 2048, B = 64).
//   2. lstm_recurrence_kernel: one block per batch row and one thread per
//      gate column (4S threads). sW stays in dynamic shared memory for the
//      whole scan (147 456 B at S = 96), beside h, c and the [4S] gate
//      values. Thread j takes its dot product h @ sW[:, j] (four partial
//      sums, to shorten the chain of dependent FMAs), adds xproj[t, b, j]
//      (loaded one step ahead into a register) and applies its gate's
//      nonlinearity; after a barrier S threads update c and h. Exactly T
//      steps run: there is no time padding and no lane padding.
// Why this design: it is the simplest one that keeps sW on chip for the
// whole scan, the one thing the bound above asks for, and it mirrors the
// GRU kernel's one-thread-per-gate-column step. The projection is part of
// the TPU kernel's body, so it is a kernel of its own here rather than a
// library GEMM. Faster layouts (iW beside sW for C = 12, several rows per
// block, a 2-CTA cluster splitting the gate columns) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kProjectThreads = 256;  // 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// out [M, N] = x [M, K] @ W [K, N] + bias [N]; all row-major.
__global__ void lstm_project_kernel(const float* __restrict__ x,
                                    const float* __restrict__ W,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, int M, int K,
                                    int N) {
  __shared__ float s_x[kTileK][kTileM];
  __shared__ float s_w[kTileK][kTileN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kTileM;
  const int col0 = blockIdx.y * kTileN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTileM * kTileK; i += kProjectThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int gr = row0 + r, gk = k0 + kk;
      s_x[kk][r] = (gr < M && gk < K) ? x[(size_t)gr * K + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < kTileK * kTileN; i += kProjectThreads) {
      const int kk = i / kTileN, c = i % kTileN;
      const int gk = k0 + kk, gc = col0 + c;
      s_w[kk][c] = (gk < K && gc < N) ? W[(size_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
    const int kend = min(kTileK, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_x[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = s_w[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) out[(size_t)r * N + c] = __fadd_rn(acc[i][j], bias[c]);
    }
  }
}

// xproj [T, B, 4S], sW [S, 4S], peep [3S] -> y [T, B, S].
__global__ void lstm_recurrence_kernel(const float* __restrict__ xproj,
                                       const float* __restrict__ sW,
                                       const float* __restrict__ peep,
                                       float* __restrict__ y, int T, int B,
                                       int S, int reverse) {
  extern __shared__ float smem[];
  const int S4 = 4 * S;
  float* s_sW = smem;          // [S, 4S]
  float* s_h = s_sW + S * S4;  // [S]
  float* s_c = s_h + S;        // [S]
  float* s_g = s_c + S;        // [4S] gate values of this step

  const int b = blockIdx.x;
  const int j = threadIdx.x;  // gate column; blockDim.x == 4S
  const int gate = j / S;     // 0 cell-in, 1 input, 2 forget, 3 output
  const int u = j - gate * S;
  for (int i = j; i < S * S4; i += blockDim.x) s_sW[i] = sW[i];
  if (j < S) {
    s_h[j] = 0.0f;
    s_c[j] = 0.0f;
  }
  const float p_gate = (gate == 1 || gate == 2) ? peep[(gate - 1) * S + u] : 0.0f;
  const float p_out = j < S ? peep[2 * S + j] : 0.0f;
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  float xnext = xproj[((size_t)t0 * B + b) * S4 + j];
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    const float xcur = xnext;
    if (n + 1 < T) xnext = xproj[((size_t)(t + dt) * B + b) * S4 + j];

    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int k = 0;
#pragma unroll 4
    for (; k + 4 <= S; k += 4) {
      a0 = fmaf(s_h[k], s_sW[k * S4 + j], a0);
      a1 = fmaf(s_h[k + 1], s_sW[(k + 1) * S4 + j], a1);
      a2 = fmaf(s_h[k + 2], s_sW[(k + 2) * S4 + j], a2);
      a3 = fmaf(s_h[k + 3], s_sW[(k + 3) * S4 + j], a3);
    }
    for (; k < S; ++k) a0 = fmaf(s_h[k], s_sW[k * S4 + j], a0);
    const float xf = __fadd_rn(xcur, __fadd_rn(__fadd_rn(a0, a1),
                                               __fadd_rn(a2, a3)));
    float g;
    if (gate == 0) {
      g = tanhf(xf);
    } else if (gate < 3) {
      g = sigmoid_f32(__fadd_rn(xf, __fmul_rn(s_c[u], p_gate)));
    } else {
      g = xf;  // the output gate waits for the new c
    }
    s_g[j] = g;
    __syncthreads();

    if (j < S) {
      const float c_new = __fadd_rn(__fmul_rn(s_g[2 * S + j], s_c[j]),
                                    __fmul_rn(s_g[S + j], s_g[j]));
      const float o = sigmoid_f32(__fadd_rn(s_g[3 * S + j],
                                            __fmul_rn(c_new, p_out)));
      const float h = __fmul_rn(o, tanhf(c_new));
      s_c[j] = c_new;
      s_h[j] = h;
      y[((size_t)t * B + b) * S + j] = h;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the recurrence kernel needs for size S.
size_t scrappie_lstm_smem_bytes(int S) {
  return sizeof(float) * ((size_t)4 * S * S + 6 * (size_t)S);
}

// x [M, K], iW [K, N], b [N] -> out [M, N]; all fp32, contiguous, on the
// current device. Returns a cudaError_t.
int scrappie_lstm_project(const float* x, const float* iW, const float* b,
                          float* out, int M, int K, int N,
                          cudaStream_t stream) {
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  lstm_project_kernel<<<grid, kProjectThreads, 0, stream>>>(x, iW, b, out, M,
                                                            K, N);
  return (int)cudaGetLastError();
}

// xproj [T, B, 4S], sW [S, 4S], peep [3S] -> y [T, B, S]; all fp32,
// contiguous, on the current device. Returns a cudaError_t.
int scrappie_lstm_recurrence(const float* xproj, const float* sW,
                             const float* peep, float* y, int T, int B, int S,
                             int reverse, cudaStream_t stream) {
  const size_t smem = scrappie_lstm_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_kernel<<<B, 4 * S, smem, stream>>>(xproj, sW, peep, y, T, B,
                                                     S, reverse);
  return (int)cudaGetLastError();
}

}  // extern "C"
