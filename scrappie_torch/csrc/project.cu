// The input projection of a recurrent layer, out = x @ W + b, for all rows
// of a time-major [T, B, C] input at once. The GRU (ops/gru.py) and the
// peephole LSTM (ops/lstm.py) share it: each runs it, then its recurrence
// kernel over the projected [T, B, 3S] or [T, B, 4S] scratch.
//
// Replaces the projection inside the bodies of scrappie_tpu/ops/gru.py:
// _gru_fused_kernel and scrappie_tpu/ops/lstm.py:_lstm_kernel (the TPU
// kernels compute x @ iW + b per time block before their recurrence).
//
// What bounds it on the H100: 2 M K N flops (7.1 GFLOP for the GRU at
// M = T B = 128 000, K = 96, N = 288: 0.11 ms at the 67 TFLOP/s fp32 peak)
// and M (K + N) fp32 moved (197 MB: 0.06 ms); exact fp32, no tensor cores.
//
// Design: a plain tiled product. 64 x 64 output tiles, 16-deep slices of x
// and W in shared memory, 4 x 4 outputs per thread (256 threads); each
// output is a chain of FMAs in the order of k, then the bias. Rows and
// columns past the edge are masked, so any M, K, N is taken.
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each

// out [M, N] = x [M, K] @ W [K, N] + bias [N]; all row-major.
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ x, const float* __restrict__ W,
               const float* __restrict__ bias, float* __restrict__ out, int M,
               int K, int N) {
  __shared__ float s_x[kTileK][kTileM];
  __shared__ float s_w[kTileK][kTileN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kTileM;
  const int col0 = blockIdx.y * kTileN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int gr = row0 + r, gk = k0 + kk;
      s_x[kk][r] = (gr < M && gk < K) ? x[(size_t)gr * K + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < kTileK * kTileN; i += kThreads) {
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

}  // namespace

extern "C" {

// x [M, K], W [K, N], b [N] -> out [M, N]; all fp32, contiguous, on the
// current device. Returns a cudaError_t.
int scrappie_project(const float* x, const float* W, const float* b,
                     float* out, int M, int K, int N, cudaStream_t stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  project_kernel<<<grid, kThreads, 0, stream>>>(x, W, b, out, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
