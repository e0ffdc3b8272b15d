// One GRU layer with the input projection inside the kernel, and (a mode of
// the same kernel) the GRU recurrence alone over inputs projected before.
//
// Replaces, in scrappie_tpu/ops/gru.py:
//   _gru_fused_kernel  wrapper gru_layer_fused_tm  (projecting mode)
//   _gru_kernel        wrapper gru_tm_padded       (recurrence mode: xin is
//                      read from a [T, B, 3S] input instead of computed)
// Per time step, for one batch row:
//
//   xin  = x[t] @ iW + b
//   z, r = sigmoid(xin[:2S] + h @ sW)
//   hbar = tanh(xin[2S:] + (r * h) @ sW2)
//   h    = z * h + (1 - z) * hbar
//
// with h = 0 before the first step; `reverse` walks time backwards.
//
// What bounds it on the H100: the recurrence is sequential in T, so one
// row's time is T times the latency of one step: two dependent length-S
// (or C) dot products per thread, two block barriers and a global load.
// The arithmetic is small (about 3S(C + S) multiply-adds per row and step);
// what must not happen is to stream the weights from L2 every step (221 KB
// in fp32 at C = S = 96, 442 MB per 2000-step row).
//
// Design: one block per batch row and one thread per gate column (3S
// threads). iW, sW and sW2 are copied once into dynamic shared memory and
// stay there for the whole scan (224 KB of the 227 KB a block may use at
// C = S = 96); h, r*h, z and a double-buffered input row sit beside them.
// Thread j accumulates column j of x@iW and, for j < 2S, of h@sW, reading
// weights along a row so neighbouring threads touch neighbouring words.
// The next step's input row is loaded into a register while the current
// step computes, which keeps the global-load latency off the critical
// path. Exactly T steps run: there is no time padding and no lane padding.
// The recurrence mode keeps only sW and sW2 resident (109 KB at S = 96) and
// reads thread j's gate input x[t, b, j] a step ahead into a register; the
// step after that is the projecting mode's, in the same order of additions.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// PROJECT: x [T, B, C], xin = x[t] @ iW + b in the kernel. Otherwise x is
// [T, B, 3S] already projected (C = 0; iW and bias are not read).
template <bool PROJECT>
__global__ void gru_layer_kernel(const float* __restrict__ x,
                                 const float* __restrict__ iW,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ sW,
                                 const float* __restrict__ sW2,
                                 float* __restrict__ y, int T, int B, int C,
                                 int S, int reverse) {
  extern __shared__ float smem[];
  const int S2 = 2 * S;
  const int S3 = 3 * S;
  float* s_sW = smem;             // [S, 2S]
  float* s_sW2 = s_sW + S * S2;   // [S, S]
  float* s_h = s_sW2 + S * S;     // [S]
  float* s_rh = s_h + S;          // [S] r * h
  float* s_z = s_rh + S;          // [S]
  float* s_iW = s_z + S;          // [C, 3S], projecting mode
  float* s_x = s_iW + C * S3;     // [2, C] input row, double-buffered

  const int b = blockIdx.x;
  const int j = threadIdx.x;  // gate column; blockDim.x == 3S >= C
  for (int i = j; i < S * S2; i += blockDim.x) s_sW[i] = sW[i];
  for (int i = j; i < S * S; i += blockDim.x) s_sW2[i] = sW2[i];
  if (j < S) s_h[j] = 0.0f;
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  float bj = 0.0f;
  float xin = 0.0f;
  if (PROJECT) {
    for (int i = j; i < C * S3; i += blockDim.x) s_iW[i] = iW[i];
    bj = bias[j];
    if (j < C) s_x[j] = x[((size_t)t0 * B + b) * C + j];
  } else {
    xin = x[((size_t)t0 * B + b) * S3 + j];
  }
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    const bool more = n + 1 < T;
    float xnext = 0.0f;
    if (PROJECT) {
      const float* xs = s_x + (n & 1) * C;
      if (j < C && more) xnext = x[((size_t)(t + dt) * B + b) * C + j];
      float acc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) acc = fmaf(xs[c], s_iW[c * S3 + j], acc);
      xin = __fadd_rn(acc, bj);
    } else if (more) {
      xnext = x[((size_t)(t + dt) * B + b) * S3 + j];
    }
    if (j < S2) {
      float rec = 0.0f;
#pragma unroll 8
      for (int k = 0; k < S; ++k) rec = fmaf(s_h[k], s_sW[k * S2 + j], rec);
      const float g = sigmoid_f32(__fadd_rn(xin, rec));
      if (j < S) {
        s_z[j] = g;
      } else {
        s_rh[j - S] = __fmul_rn(g, s_h[j - S]);
      }
    }
    if (PROJECT && j < C && more) s_x[((n + 1) & 1) * C + j] = xnext;
    __syncthreads();

    if (j >= S2) {
      const int k0 = j - S2;
      float acc2 = 0.0f;
#pragma unroll 8
      for (int k = 0; k < S; ++k) acc2 = fmaf(s_rh[k], s_sW2[k * S + k0], acc2);
      const float hbar = tanhf(__fadd_rn(xin, acc2));
      const float z = s_z[k0];
      const float hn = __fadd_rn(__fmul_rn(z, s_h[k0]),
                                 __fmul_rn(__fsub_rn(1.0f, z), hbar));
      s_h[k0] = hn;
      y[((size_t)t * B + b) * S + k0] = hn;
    }
    if (!PROJECT) xin = xnext;
    __syncthreads();
  }
}

template <bool PROJECT>
int launch(const float* x, const float* iW, const float* b, const float* sW,
           const float* sW2, float* y, int T, int B, int C, int S,
           int reverse, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_layer_kernel<PROJECT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_layer_kernel<PROJECT><<<B, 3 * S, smem, stream>>>(x, iW, b, sW, sW2, y,
                                                       T, B, C, S, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for input width C and size S
// (C = 0: the recurrence mode).
size_t scrappie_gru_smem_bytes(int C, int S) {
  return sizeof(float) *
         ((size_t)C * 3 * S + (size_t)3 * S * S + 2 * (size_t)C + 3 * (size_t)S);
}

// x [T, B, C], iW [C, 3S], b [3S], sW [S, 2S], sW2 [S, S] -> y [T, B, S];
// all fp32, contiguous, on the current device. Returns a cudaError_t.
int scrappie_gru_layer(const float* x, const float* iW, const float* b,
                       const float* sW, const float* sW2, float* y, int T,
                       int B, int C, int S, int reverse, cudaStream_t stream) {
  return launch<true>(x, iW, b, sW, sW2, y, T, B, C, S, reverse,
                      scrappie_gru_smem_bytes(C, S), stream);
}

// x [T, B, 3S] projected, sW [S, 2S], sW2 [S, S] -> y [T, B, S]; as above.
int scrappie_gru_recurrence(const float* x, const float* sW, const float* sW2,
                            float* y, int T, int B, int S, int reverse,
                            cudaStream_t stream) {
  return launch<false>(x, nullptr, nullptr, sW, sW2, y, T, B, 0, S, reverse,
                       scrappie_gru_smem_bytes(0, S), stream);
}

}  // extern "C"
