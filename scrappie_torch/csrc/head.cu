// The transducer head for all T*B rows at once: one model's log posterior,
// or the combined log posterior of an ensemble of K models. The Viterbi
// forward kernel (csrc/viterbi.cu) then decodes it.
//
// Replaces the head inside scrappie_tpu/ops/viterbi.py:_fused_kernel (one
// model) and _fused_ens_kernel (K models); with viterbi_fwd_kernel it is
// the port's route for both (the fused kernels of csrc/viterbi.cu stay,
// checked and timed, with no path launching them). Per row and member k:
//
//   y_k   = ((h_k * hscale) @ W_k + b_k) / tempb          [nstate]
//   lp_k  = log(c0 + c1 * softmax(y_k))                    (robustlog)
//
// One model writes lp_1. K members write their combination, the weighted
// sum in member order renormalised by its log-sum-exp:
//
//   acc = sum_k w_k lp_k;   lp = acc - (mx + log sum exp(acc - mx)),
//   mx = max(acc)
//
// What bounds it on the H100: per member 2 M S nstate flops (25.2 GFLOP at
// M = T B = 128 000, S = 96, nstate = 1025: 0.38 ms at the 67 TFLOP/s fp32
// peak, exact fp32 without tensor cores) against writing the fp32 posterior
// (525 MB: 0.16 ms at 3.35 TB/s): bound by operations. The fused kernels
// it replaces streamed all of W (394 KB) from L2 for every row and step.
//
// Design: each block owns RT = 128 whole rows across all nstate columns, so
// the softmax's maximum and sum and the renormalisation are reductions
// inside the block. The block's scaled h rows stay in shared memory
// (transposed, [S][RT]); W streams through shared memory in slices of
// KT = 32 rows by NT = 128 columns, double-buffered with cp.async, so each
// slice serves 128 rows (W's L2 traffic is 394 KB x M / 128 = 394 MB at
// M = 128 000, below the posterior's own write). 256 threads, each with an
// 8 x 8 tile of outputs; every output is a chain of FMAs in the order of
// k. One pass over W per member writes the member's logits and keeps each
// row's running maximum and sum of exponentials (an online softmax,
// combined across the 16 threads of a row by warp shuffles). Then each
// thread reads back only what it wrote: one model turns its logits into
// lp in place; K members write their logits to a scratch y [M, nstate]
// the wrapper allocates (a second posterior's memory) and add w_k lp_k to
// the sum in lp; two last sweeps take each row's log-sum-exp of the sum
// and subtract it from every entry. Two blocks of 256 threads share an SM
// (at most 128 registers a thread).
// Recomputing the product in a second pass per member, with no scratch,
// took 14.5 ms at K = 3, T = 2000, B = 64 on an H100, against the plain
// twin's 13.6 ms.
//
// Precision (template kRound, rounding.cuh): in 'default' and 'bf16' the
// scaled rows h * hscale are rounded where they are staged (the scale
// before the rounding, as softmax_with_temperature scales x before its
// product), and each thread rounds the W entries it copied into a slice
// once they have landed, before the barrier that hands the slice on.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "rounding.cuh"

namespace {

constexpr int RT = 128;      // rows a block owns
constexpr int NT = 128;      // columns of a W slice
constexpr int KT = 32;       // rows of a W slice
constexpr int HP = RT + 4;   // padded row of the transposed h tile
constexpr int THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Add value v to a running (maximum m, sum s of exp(. - m)).
__device__ __forceinline__ void online_add(float& m, float& s, float v) {
  if (v > m) {
    s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, v))), 1.0f);
    m = v;
  } else {
    s = __fadd_rn(s, expf(__fsub_rn(v, m)));
  }
}

// Merge the running (m, s) of the 16 threads of a row (lanes with the same
// ty, tx = lane % 16); every one of them gets the row's.
__device__ __forceinline__ void row_merge(float& m, float& s) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off);
    const float s2 = __shfl_xor_sync(FULL, s, off);
    const float mo = fmaxf(m, m2);
    const float a = m == -CUDART_INF_F ? 0.0f : __fmul_rn(s, expf(__fsub_rn(m, mo)));
    const float b = m2 == -CUDART_INF_F ? 0.0f : __fmul_rn(s2, expf(__fsub_rn(m2, mo)));
    s = __fadd_rn(a, b);
    m = mo;
  }
}

// Column of output j (0..7) of thread tx within a tile.
__device__ __forceinline__ int tile_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// Issue the cp.async copies of W slice `slice` (tile slice / nks, rows
// (slice % nks) * KT ...) into dst [KT][NT]; zeros past S and nstate.
__device__ __forceinline__ void load_slice(float* dst,
                                           const float* __restrict__ W,
                                           int slice, int nks, int S,
                                           int nstate) {
  const int c0 = (slice / nks) * NT;
  const int k0 = (slice % nks) * KT;
  for (int i = threadIdx.x; i < KT * NT; i += THREADS) {
    const int kk = i / NT, c = i % NT;
    const int gk = k0 + kk, gc = c0 + c;
    if (gk < S && gc < nstate) {
      cp_async4(dst + i, W + (size_t)gk * nstate + gc);
    } else {
      dst[i] = 0.0f;
    }
  }
  cp_async_commit();
}

// One pass over all of W for the block's rows: acc = hs @ W slice by
// slice, and at the end of each column tile epi(tile, acc) with the tile's
// 8 x 8 outputs of this thread, then acc = 0.
template <int kRound, typename Epilogue>
__device__ __forceinline__ void gemm_pass(const float* s_h, float* s_w,
                                          const float* __restrict__ W, int S,
                                          int nstate, Epilogue epi) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int nks = (S + KT - 1) / KT;
  const int nslice = ((nstate + NT - 1) / NT) * nks;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_slice(s_w, W, 0, nks, S, nstate);
  for (int s = 0; s < nslice; ++s) {
    if (s + 1 < nslice) {
      load_slice(s_w + ((s + 1) & 1) * KT * NT, W, s + 1, nks, S, nstate);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (kRound != 0) {  // this thread's entries of slice s
      float* own = s_w + (s & 1) * KT * NT;
      for (int i = threadIdx.x; i < KT * NT; i += THREADS)
        own[i] = round_weight<kRound>(own[i]);
    }
    __syncthreads();
    const float* ws = s_w + (s & 1) * KT * NT;
    const float* hs = s_h + (size_t)(s % nks) * KT * HP;
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(hs + kk * HP + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(hs + kk * HP + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * NT + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + kk * NT + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s % nks == nks - 1) {
      epi(s / nks, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    __syncthreads();
  }
}

// fn(i, index) for each entry of an [M, nstate] array this thread owns in
// every column tile (row row0 + ty * 8 + i of the block, its 8 columns of
// the tile): the entries it writes in a pass's epilogue.
template <typename Fn>
__device__ __forceinline__ void for_own_entries(int M, int nstate, int row0,
                                                int tx, int ty, Fn fn) {
  const int ntile = (nstate + NT - 1) / NT;
  for (int tile = 0; tile < ntile; ++tile) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ty * 8 + i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile * NT + tile_col(tx, j);
        if (c < nstate) fn(i, (size_t)r * nstate + c);
      }
    }
  }
}

// h [K, M, S], W [K, S, nstate], bvec [K, nstate], weights [K] (kCombine)
// -> lp [M, nstate]; kCombine: y [M, nstate] holds each member's logits in
// turn. Dynamic shared memory: h tile [SPAD][HP], W slices [2][KT][NT],
// SPAD = S rounded up to KT.
template <bool kCombine, int kRound>
__global__ void __launch_bounds__(THREADS, 2)
head_kernel(const float* __restrict__ h, const float* __restrict__ W,
            const float* __restrict__ bvec, const float* __restrict__ weights,
            float* __restrict__ lp, float* __restrict__ y, int K, int M, int S,
            int nstate, float hscale, float tempb, float c0, float c1) {
  extern __shared__ __align__(16) float smem[];
  const int spad = (S + KT - 1) / KT * KT;
  float* s_h = smem;
  float* s_w = s_h + (size_t)spad * HP;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * RT;

  for (int k = 0; k < K; ++k) {
    const float* hk = h + (size_t)k * M * S;
    const float* Wk = W + (size_t)k * S * nstate;
    const float* bk = bvec + (size_t)k * nstate;
    const float wk = kCombine ? weights[k] : 1.0f;
    // Stage this member's scaled rows; the last reads of the previous
    // member's were before the pass's trailing barrier, and the next
    // pass's first barrier orders these writes before any read.
    for (int i = threadIdx.x; i < RT * spad; i += THREADS) {
      const int r = i / spad, kk = i % spad;
      const int gr = row0 + r;
      s_h[kk * HP + r] = (gr < M && kk < S)
                             ? round_operand<kRound>(
                                   __fmul_rn(hk[(size_t)gr * S + kk], hscale))
                             : 0.0f;
    }

    // The pass over W: each row's logits, written to lp (one model) or y
    // (K members), and its softmax maximum and sum.
    float* logits = kCombine ? y : lp;
    float sm[8], ss[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sm[i] = -CUDART_INF_F;
      ss[i] = 0.0f;
    }
    gemm_pass<kRound>(s_h, s_w, Wk, S, nstate, [&](int tile, float (&acc)[8][8]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile * NT + tile_col(tx, j);
        if (c >= nstate) continue;
        const float bc = __ldg(bk + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = __fdiv_rn(__fadd_rn(acc[i][j], bc), tempb);
          online_add(sm[i], ss[i], v);
          const int r = row0 + ty * 8 + i;
          if (r < M) logits[(size_t)r * nstate + c] = v;
        }
      }
    });
#pragma unroll
    for (int i = 0; i < 8; ++i) row_merge(sm[i], ss[i]);

    // The logits, read back by the thread that wrote them, become lp (one
    // model), or w_k lp_k is added to the sum in lp (K members).
    for_own_entries(M, nstate, row0, tx, ty, [&](int i, size_t idx) {
      const float e = expf(__fsub_rn(logits[idx], sm[i]));
      const float l = logf(__fadd_rn(c0, __fmul_rn(c1, __fdiv_rn(e, ss[i]))));
      if (!kCombine) {
        lp[idx] = l;
        return;
      }
      const float lk = __fmul_rn(l, wk);
      lp[idx] = k == 0 ? lk : __fadd_rn(lp[idx], lk);
    });
    if (!kCombine) return;
  }
  // The renormalisation: each row's log-sum-exp of the sum, then every
  // entry less it. (Kept out of the members' loop, the running maximum and
  // sum hold no registers through the passes over W.)
  float cm[8], cs[8], lse[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cm[i] = -CUDART_INF_F;
    cs[i] = 0.0f;
  }
  for_own_entries(M, nstate, row0, tx, ty,
                  [&](int i, size_t idx) { online_add(cm[i], cs[i], lp[idx]); });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row_merge(cm[i], cs[i]);
    lse[i] = __fadd_rn(cm[i], logf(cs[i]));
  }
  for_own_entries(M, nstate, row0, tx, ty, [&](int i, size_t idx) {
    lp[idx] = __fsub_rn(lp[idx], lse[i]);
  });
}

template <bool kCombine, int kRound>
int launch(const float* h, const float* W, const float* bvec,
           const float* weights, float* lp, float* y, int K, int M, int S,
           int nstate, float hscale, float tempb, float c0, float c1,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      head_kernel<kCombine, kRound>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_kernel<kCombine, kRound><<<(M + RT - 1) / RT, THREADS, smem, stream>>>(
      h, W, bvec, weights, lp, y, K, M, S, nstate, hscale, tempb, c0, c1);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the head kernel needs for hidden size S
// (ops/viterbi.head_smem_bytes).
size_t smem_bytes(int S) {
  const size_t spad = (size_t)(S + KT - 1) / KT * KT;
  return sizeof(float) * (spad * HP + 2 * (size_t)KT * NT);
}

}  // namespace

extern "C" {

// h [K, M, S], W [K, S, nstate], bvec [K, nstate], weights [K] -> lp
// [M, nstate], with y [M, nstate] a scratch for the members' logits; all
// fp32, contiguous, on the current device. weights null: one model (K must
// be 1), no combination, y unused. rounding 0, 1 or 2: none, TF32 or
// bfloat16 operands. Returns a cudaError_t.
int scrappie_head(const float* h, const float* W, const float* bvec,
                  const float* weights, float* lp, float* y, int K, int M,
                  int S, int nstate, float hscale, float tempb, float c0,
                  float c1, int rounding, cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if (K < 1 || (weights == nullptr && K != 1) ||
      (weights != nullptr && y == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S);
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (weights == nullptr)
      return launch<false, R>(h, W, bvec, weights, lp, y, K, M, S, nstate,
                              hscale, tempb, c0, c1, smem, stream);
    return launch<true, R>(h, W, bvec, weights, lp, y, K, M, S, nstate,
                           hscale, tempb, c0, c1, smem, stream);
  });
}

}  // extern "C"
