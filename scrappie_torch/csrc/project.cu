// The input projection of a recurrent layer, out = x @ W + b, for all rows
// of a time-major [T, B, C] input at once. The GRU (ops/gru.py) and the
// peephole LSTM (ops/lstm.py) share it: each runs it, then its recurrence
// kernel over the projected [T, B, 3S] or [T, B, 4S] scratch (the LSTM's
// bidirectional stages project against both layers' weights at once,
// [T, B, 8S]).
//
// Replaces the projection inside the bodies of scrappie_tpu/ops/gru.py:
// _gru_fused_kernel and scrappie_tpu/ops/lstm.py:_lstm_kernel (the TPU
// kernels compute x @ iW + b per time block before their recurrence).
//
// What bounds it on the H100: 2 M K N flops (7.1 GFLOP for the GRU at
// M = T B = 128 000, K = 96, N = 288: 0.11 ms at the 67 TFLOP/s fp32 peak)
// and M (K + N) fp32 moved (197 MB: 0.06 ms); exact fp32, no tensor cores.
// At K = 12 (the events network's first stage) the output's bytes bound it.
// Within an SM the limit is shared memory: it hands 128 bytes a cycle to
// the registers, a float4 load of a warp takes 4 of those cycles even when
// its lanes share addresses, and the SM issues 4 warp FMAs a cycle. So a
// thread's tile must reuse each loaded value often: 8 rows by 8 columns
// needs the shared pipe all the time the FMAs run, 8 rows by 12 columns
// 83% of it (on an H100 at the GRU shape, B = 64: 0.24 and 0.23 ms).
//
// Design: a block computes 128 x 96 output tiles (96 divides every N the
// models use: 288, 384 and 768) with 128 threads, 8 rows (ty + 16 i) by 12
// columns (4 tx .. 4 tx + 3, + 32, + 64) a thread, two blocks an SM. K <=
// 96 on every model, so one slice holds a tile's whole depth: the 128 rows
// of x (row-major, as they lie in memory, the stride padded so that
// neighbouring rows fall in different banks) and the tile's 96 columns of W
// (k-major, as they lie in memory), copied by 16-byte cp.async. For each
// 4-deep step of k a thread reads its 8 rows of x as float4 (4 k each) and,
// for each k, its 12 columns of W as three float4: 20 shared loads for 384
// FMAs, without bank conflicts (a warp covers 4 rows and 32 neighbouring
// columns). Each output is a chain of FMAs in the order of k, then the bias
// (__fadd_rn); the tile is stored as float4.
//
// project_pipe_kernel (K <= 96, 16-byte path) is persistent: block b keeps
// column tile b % ntn of W in shared memory and walks row tiles. The x tile
// is split at half its depth; once every thread has read the first half of
// tile t, the first half of tile t + 1 is copied in while the second half
// of tile t is multiplied, and the second half of t + 1 while the first
// half of t + 1 is, so the copies overlap the FMAs with one x buffer (0.21
// ms against 0.23 for one tile a block, same shape). project_kernel, one tile a
// block, takes the rest: K > 96 (it loops over 96-deep slices), and K or N
// not a multiple of 4 or a pointer not 16-byte aligned (4-byte copies and
// stores). Rows, columns and depth past the edge are zero-filled by
// cp.async and masked at the store, so any M, K, N is taken.
//
// Precision (template kRound, rounding.cuh): in 'default' and 'bf16' each
// thread rounds, in shared memory, the elements of x and W it copied
// itself, once its copies have landed and before the barrier that hands
// them to the other threads (W once a block, each x element once a column
// tile); the FMAs are those of 'highest'.
#include <cstdint>
#include <cuda_runtime.h>

#include "rounding.cuh"

namespace {

constexpr int kBM = 128;        // rows of a tile
constexpr int kBN = 96;         // columns of a tile
constexpr int kKS = 96;         // depth of a slice in shared memory
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kStep = 32;       // between a thread's column quads
constexpr int kQuads = 3;       // a thread's column quads (12 columns)

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Row stride of the x tile for a slice of depth ks4 (a multiple of 4): at
// least ks4 + 4 and never a multiple of 32 floats, so rows r and r + 1 of
// a float4 load fall in different banks.
__host__ __device__ __forceinline__ int x_stride(int ks4) {
  const int s = ks4 + 4;
  return (s / 4) % 8 == 0 ? s + 4 : s;
}

// Depth of the slices, padded to 4.
__host__ __device__ __forceinline__ int slice_depth(int K) {
  return K < kKS ? (K + 3) / 4 * 4 : kKS;
}

// The thread's column group tx (0..7) and row group ty (0..15): a warp
// covers 8 column groups of 4 row groups.
__device__ __forceinline__ int col_group() { return threadIdx.x & 7; }
__device__ __forceinline__ int row_group() { return threadIdx.x >> 3; }

// acc += x rows (ty + 16 i) @ W columns over the 4-deep steps [q0, q1) of
// the slice: xr = s_x + ty * xs, wc = s_w + 4 tx.
__device__ __forceinline__ void tile_fma(float (&acc)[8][4 * kQuads],
                                         const float* xr, const float* wc,
                                         int xs, int q0, int q1) {
#pragma unroll 2
  for (int q = q0; q < q1; ++q) {
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xr + 16 * i * xs + 4 * q);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = wc + (4 * q + kk) * kBN;
      float4 wv[kQuads];
#pragma unroll
      for (int h = 0; h < kQuads; ++h)
        wv[h] = *reinterpret_cast<const float4*>(wk + h * kStep);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y
                      : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int h = 0; h < kQuads; ++h) {
          acc[i][4 * h] = fmaf(a, wv[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(a, wv[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(a, wv[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(a, wv[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// out[rows, cols] = acc + bias for the thread's outputs of the tile at
// (row0, col0); acc is zeroed for the next tile.
template <bool kVec>
__device__ __forceinline__ void tile_store(float (&acc)[8][4 * kQuads],
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int row0,
                                           int col0, int M, int N) {
  const int tx = col_group(), ty = row_group();
  float bv[4 * kQuads];
#pragma unroll
  for (int h = 0; h < kQuads; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + h * kStep + 4 * tx + j;
      bv[4 * h + j] = c < N ? __ldg(bias + c) : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + 16 * i;
    float* orow = out + (size_t)r * N;
#pragma unroll
    for (int h = 0; h < kQuads; ++h) {
      const int c = col0 + h * kStep + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = __fadd_rn(acc[i][4 * h + j], bv[4 * h + j]);
        acc[i][4 * h + j] = 0.0f;
      }
      if (r >= M) continue;
      if (kVec) {
        if (c < N)
          *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) orow[c + j] = v[j];
      }
    }
  }
}

// Copy the 4-deep steps [q0, q1) of the x rows of the tile at row0 (slice
// at k0) into s_x by 16-byte cp.async; rows past M are zero-filled.
__device__ __forceinline__ void load_x16(float* s_x, const float* __restrict__ x,
                                         int row0, int k0, int q0, int q1,
                                         int xs, int M, int K) {
  const int nq = q1 - q0;
  for (int i = threadIdx.x; i < kBM * nq; i += kThreads) {
    const int r = i / nq, q = q0 + i - r * nq;
    const int gr = row0 + r;
    cp_async16(s_x + r * xs + 4 * q, x + (size_t)min(gr, M - 1) * K + k0 + 4 * q,
               gr < M ? 16 : 0);
  }
}

// Round in place the x entries load_x16 copied for this thread (the same
// steps [q0, q1) of the tile's rows), after its copies have landed.
template <int kRound>
__device__ __forceinline__ void round_x16(float* s_x, int q0, int q1, int xs) {
  if constexpr (kRound != 0) {
    const int nq = q1 - q0;
    for (int i = threadIdx.x; i < kBM * nq; i += kThreads) {
      const int r = i / nq, q = q0 + i - r * nq;
      float4* v = reinterpret_cast<float4*>(s_x + r * xs + 4 * q);
      *v = round_operand4<kRound>(*v);
    }
  }
}

// Round in place the W entries load_w16 copied for this thread (kn rows).
template <int kRound>
__device__ __forceinline__ void round_w16(float* s_w, int kn) {
  if constexpr (kRound != 0) {
    for (int i = threadIdx.x; i < kn * (kBN / 4); i += kThreads) {
      float4* v = reinterpret_cast<float4*>(s_w + 4 * i);
      *v = make_float4(round_weight<kRound>(v->x), round_weight<kRound>(v->y),
                       round_weight<kRound>(v->z), round_weight<kRound>(v->w));
    }
  }
}

// Copy kn rows of W from k0, the tile's kBN columns at col0, into s_w by
// 16-byte cp.async; columns past N are zero-filled.
__device__ __forceinline__ void load_w16(float* s_w, const float* __restrict__ W,
                                         int col0, int k0, int kn, int N) {
  for (int i = threadIdx.x; i < kn * (kBN / 4); i += kThreads) {
    const int kk = i / (kBN / 4), q = i - kk * (kBN / 4);
    const int gc = col0 + 4 * q;
    cp_async16(s_w + kk * kBN + 4 * q, W + (size_t)(k0 + kk) * N + min(gc, N - 4),
               gc < N ? 16 : 0);
  }
}

// out [M, N] = x [M, K] @ W [K, N] + bias [N]; all row-major. One tile a
// block. kVec: K and N multiples of 4 and x, W, out 16-byte aligned.
template <bool kVec, int kRound>
__global__ void __launch_bounds__(kThreads, 2)
project_kernel(const float* __restrict__ x, const float* __restrict__ W,
               const float* __restrict__ bias, float* __restrict__ out, int M,
               int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int ks4 = slice_depth(K);
  const int xs = x_stride(ks4);
  float* s_x = smem;              // [kBM][xs]
  float* s_w = smem + kBM * xs;   // [ks4][kBN]
  const int ntn = (N + kBN - 1) / kBN;
  const int row0 = (blockIdx.x / ntn) * kBM;
  const int col0 = (blockIdx.x % ntn) * kBN;

  float acc[8][4 * kQuads];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kQuads; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKS) {
    const int kn = min(kKS, K - k0);   // depth of this slice
    const int kq = (kn + 3) / 4;       // its 4-deep steps
    if (k0 > 0) __syncthreads();       // the last slice has been read
    if (kVec) {
      load_x16(s_x, x, row0, k0, 0, kq, xs, M, K);
      load_w16(s_w, W, col0, k0, kn, N);
    } else {
      for (int i = threadIdx.x; i < kBM * 4 * kq; i += kThreads) {
        const int r = i / (4 * kq), kk = i - r * 4 * kq;
        const int gr = row0 + r, gk = k0 + kk;
        const bool in = gr < M && gk < K;
        cp_async4(s_x + r * xs + kk,
                  x + (in ? (size_t)gr * K + gk : 0), in ? 4 : 0);
      }
      for (int i = threadIdx.x; i < 4 * kq * kBN; i += kThreads) {
        const int kk = i / kBN, c = i - kk * kBN;
        const int gk = k0 + kk, gc = col0 + c;
        const bool in = gk < K && gc < N;
        cp_async4(s_w + kk * kBN + c,
                  W + (in ? (size_t)gk * N + gc : 0), in ? 4 : 0);
      }
    }
    cp_async_wait_all();
    if (kVec) {
      round_x16<kRound>(s_x, 0, kq, xs);
      round_w16<kRound>(s_w, kn);
    } else if (kRound != 0) {
      for (int i = threadIdx.x; i < kBM * 4 * kq; i += kThreads) {
        float* v = s_x + (i / (4 * kq)) * xs + i % (4 * kq);
        *v = round_operand<kRound>(*v);
      }
      for (int i = threadIdx.x; i < 4 * kq * kBN; i += kThreads)
        s_w[i] = round_weight<kRound>(s_w[i]);
    }
    __syncthreads();
    tile_fma(acc, s_x + row_group() * xs, s_w + 4 * col_group(), xs, 0, kq);
  }
  tile_store<kVec>(acc, bias, out, row0, col0, M, N);
}

// The persistent form (K <= kKS, the 16-byte path): block b keeps column
// tile b % ntn of W and walks the row tiles b / ntn, b / ntn + per, ...,
// with per = gridDim.x / ntn blocks on each column tile.
template <int kRound>
__global__ void __launch_bounds__(kThreads, 2)
project_pipe_kernel(const float* __restrict__ x, const float* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int kq = K / 4;
  const int qh = (kq + 1) / 2;  // the first half's 4-deep steps
  const int xs = x_stride(K);
  float* s_x = smem;              // [kBM][xs]
  float* s_w = smem + kBM * xs;   // [K][kBN]
  const int ntn = (N + kBN - 1) / kBN;
  const int ntm = (M + kBM - 1) / kBM;
  const int per = gridDim.x / ntn;
  const int col0 = (blockIdx.x % ntn) * kBN;
  const float* xr = s_x + row_group() * xs;
  const float* wc = s_w + 4 * col_group();

  float acc[8][4 * kQuads];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kQuads; ++j) acc[i][j] = 0.0f;

  int mt = blockIdx.x / ntn;
  load_w16(s_w, W, col0, 0, K, N);
  load_x16(s_x, x, mt * kBM, 0, 0, kq, xs, M, K);
  cp_async_wait_all();
  round_w16<kRound>(s_w, K);
  round_x16<kRound>(s_x, 0, kq, xs);  // this thread's copies of the first tile
  const int mt0 = mt;
  __syncthreads();
  for (; mt < ntm; mt += per) {
    const int next = mt + per;
    tile_fma(acc, xr, wc, xs, 0, qh);
    cp_async_wait_all();  // the second half of this tile has landed
    if (mt != mt0) round_x16<kRound>(s_x, qh, kq, xs);
    __syncthreads();      // ... for all, and every thread read the first
    if (next < ntm) load_x16(s_x, x, next * kBM, 0, 0, qh, xs, M, K);
    tile_fma(acc, xr, wc, xs, qh, kq);
    tile_store<true>(acc, bias, out, mt * kBM, col0, M, N);
    cp_async_wait_all();  // the first half of the next tile has landed
    if (next < ntm) round_x16<kRound>(s_x, 0, qh, xs);
    __syncthreads();      // ... for all, and every thread read the second
    if (next < ntm) load_x16(s_x, x, next * kBM, 0, qh, kq, xs, M, K);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kVec, int kRound>
int launch(const float* x, const float* W, const float* b, float* out, int M,
           int K, int N, cudaStream_t stream) {
  const int ks4 = slice_depth(K);
  const size_t smem = sizeof(float) * ((size_t)kBM * x_stride(ks4) + (size_t)ks4 * kBN);
  cudaError_t err = allow_smem(project_kernel<kVec, kRound>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  project_kernel<kVec, kRound><<<(unsigned)tiles, kThreads, smem, stream>>>(
      x, W, b, out, M, K, N);
  return (int)cudaGetLastError();
}

template <int kRound>
int launch_pipe(const float* x, const float* W, const float* b, float* out,
                int M, int K, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBM * x_stride(K) + (size_t)K * kBN);
  cudaError_t err = allow_smem(project_pipe_kernel<kRound>, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ntn = (N + kBN - 1) / kBN;
  const int ntm = (M + kBM - 1) / kBM;
  // Two blocks an SM, the row tiles spread evenly over each column tile's.
  int per = 2 * sms / ntn;
  if (per > ntm) per = ntm;
  if (per < 1) per = 1;
  const int rounds = (ntm + per - 1) / per;
  per = (ntm + rounds - 1) / rounds;
  project_pipe_kernel<kRound><<<per * ntn, kThreads, smem, stream>>>(
      x, W, b, out, M, K, N);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x [M, K], W [K, N], b [N] -> out [M, N]; all fp32, contiguous, on the
// current device; rounding 0, 1 or 2 (none, TF32, bfloat16 operands).
// Returns a cudaError_t.
int scrappie_project(const float* x, const float* W, const float* b,
                     float* out, int M, int K, int N, int rounding,
                     cudaStream_t stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(W) && aligned16(out))
      return 0 < K && K <= kKS ? launch_pipe<R>(x, W, b, out, M, K, N, stream)
                               : launch<true, R>(x, W, b, out, M, K, N, stream);
    return launch<false, R>(x, W, b, out, M, K, N, stream);
  });
}

}  // extern "C"
