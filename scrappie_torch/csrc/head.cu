// The transducer head for all M = T*B rows at once: one model's log
// posterior, or the combined log posterior of an ensemble of K models. The
// Viterbi forward kernel (csrc/viterbi.cu) then decodes it.
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
// What bounds it on the H100: per member 2 M S nstate operations (25.2
// GFLOP at M = 128 000, S = 96, nstate = 1025: 0.38 ms at the 67 TFLOP/s
// fp32 peak in 'highest', which keeps exact fp32 FMAs on the CUDA cores;
// 0.05 ms at TF32's 495 and 0.025 ms at bf16's 989 TFLOP/s on the tensor
// cores) against writing the fp32 posterior once (525 MB: 0.16 ms at 3.35
// TB/s). 'highest' is bound by operations, 'default' and 'bf16' by the
// posterior's write and the softmax's exp and log of every entry. In
// practice (timed with edited copies of this kernel, PERF.md) no part of
// a job overlaps another: the time is the product's, the softmax's, the
// exchange's and the stores' added up, and the fp32 product, whose 4 x 17 tile a thread
// reads 21 operands from shared memory for 68 FMAs, is the largest.
//
// Design: a cluster of CL = ceil(nstate / NC) CTAs (8 at 1025 states)
// splits a row's columns, NC = 136 states a CTA (8 x 128 is one short of
// 1025), and walks tiles of RT = 64 rows, persistent (as many clusters as
// fit at once, each taking tiles cluster, cluster + nclusters, ...; at
// M = 16 000, 250 tiles, every cluster the card holds has work). Two CTAs
// share an SM (105 KB of shared memory each at S = 96). The operands come
// in by bulk copies of the TMA unit, completing on mbarriers: a tile's h
// rows are read once for the whole cluster, each CTA copying an eighth of
// them multicast into every CTA's stage (each CTA copying all of them was
// slower); W and the bias reach the kernel as an image of
// each CTA's slice (ops/viterbi.head_image, made once per weight tensor),
// one bulk copy a slice, which stays in shared memory across all the
// CTA's tiles for one model (W read from L2 once per CTA) and is reloaded
// for each tile and member of K members while the previous softmax runs
// (K M / RT slices of 418 KB a cluster: 2.5 GB at K = 3, M = 128 000).
// Each warp owns 16 rows by the CTA's 136 states and keeps its logits in
// registers: nothing but the posterior reaches device memory, and each
// entry is written once. A row's softmax needs the whole row: each CTA
// reduces its states' maximum and sum of exponentials by warp shuffles
// (no per-entry branch), writes one pair a row to shared memory, and
// after a cluster barrier every CTA reads the others' pairs through
// distributed shared memory (a double-buffered pair array, so one barrier
// an exchange suffices). K members add w_k lp_k into registers, and a
// last exchange takes the sum's log-sum-exp. The epilogue multiplies each
// entry by a row's exp(m_cta - m) / sum, one IEEE division a row, in
// place of torch's exp(y - m) / sum (two more roundings of p), and takes
// exp and log by ex2.approx and lg2.approx (__expf, __logf): lp within
// about 1e-6 of the twin's, as the sums' order already leaves it. A warp
// stores 4 rows of 8 consecutive states an instruction (lp's rows of 1025
// floats allow no wider aligned store); staging each row's slice in
// shared memory for TMA bulk stores of its 16-byte-aligned middle took
// the same time (the write of the posterior, not the store instructions,
// costs what the stores cost).
//
// The product: 'highest' (kRound 0) runs fp32 FMAs, each thread 4 rows by
// 17 states (its states lane % 8 + 8 j), W's image with its columns
// permuted within groups of 32 so that a thread's states are one 16-byte
// load (8 rows a thread, 25 operands for 136 FMAs, was slower with half
// the warps). 'default' (kRound 1) and 'bf16' (kRound 2) run mma.sync on
// the tensor cores, TF32 m16n8k8 and bf16 m16n8k16, with the product
// transposed (states are the 16 rows of an mma tile, the tile's rows its
// 8 columns). The operands are rounded as before (rounding.cuh): the
// scaled rows h * hscale by round_operand where a stage lands, W by
// round_weight where its slice lands; the products of rounded operands
// are exact, so kernel and twin differ only in the order of the sums.
//
// Widths: the resident mode above needs S a multiple of 4 and h 16-byte
// aligned (16-byte rows for the bulk copies) and its two h stages and the
// whole W slice in shared memory (S <= 208). Any other S >= 1 (the GRU's
// 352 and the LSTM's 288 among them) runs the streamed mode (kStream):
// one h stage and a W chunk of KC = 128 rows, refilled by plain loads for
// each chunk of the depth (W read from L2 once per tile and member), the
// product going on in the order of k as in one pass; the rest is the
// same. Either mode takes at most 8 x 136 = 1088 states (a cluster of at
// most 8 CTAs; every transducer head of the registry has 1025).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "rounding.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RT = 64;             // rows of a tile
constexpr int NC = 136;            // states of a CTA's slice (17 groups of 8)
constexpr int MAX_CLUSTER = 8;     // CTAs a cluster: nstate <= 1088
constexpr int WARPS = RT / 16;     // each warp 16 rows of the tile
constexpr int THREADS = 32 * WARPS;
constexpr int CTAS_PER_SM = 2;     // one CTA's product beside another's softmax
constexpr int KC = 128;            // depth of a chunk where W and h stream
constexpr unsigned FULL = 0xffffffffu;

// Depth of the product: S rounded up to 16 (zeros past S).
__host__ __device__ constexpr int k_extent(int S) { return (S + 15) / 16 * 16; }

// Row pitch of the h stage: at least k_extent, 4 mod 32, so that the rows
// a warp reads at one k fall on distinct banks.
__host__ __device__ constexpr int h_pitch(int S) {
  return k_extent(S) % 32 == 0 ? k_extent(S) + 4 : k_extent(S) + 20;
}

// A thread's rows and states of its CTA's tile: 4 rows (ri) by NJ states
// (j); the 8 lanes holding a row are lane bits SHIFT .. SHIFT + 2.
template <int kRound>
struct Layout {  // FMA: lane = 8 ry + cx; rows ry + 4 ri, states cx + 8 j
  static constexpr int NJ = 17;
  static constexpr int SHIFT = 0;
  __device__ static int row(int warp, int lane, int ri) {
    return 16 * warp + (lane >> 3) + 4 * ri;
  }
  __device__ static int state(int lane, int j) { return (lane & 7) + 8 * j; }
};

// mma: g = lane / 4, q = lane % 4; ri = 2 nt + parity, rows 8 nt + 2 q +
// parity; j = 2 mt + half, states 16 mt + 8 half + g (9 tiles of 16
// states, the last half of the last past NC).
struct MmaLayout {
  static constexpr int NJ = 18;
  static constexpr int SHIFT = 2;
  __device__ static int row(int warp, int lane, int ri) {
    return 16 * warp + 8 * (ri >> 1) + 2 * (lane & 3) + (ri & 1);
  }
  __device__ static int state(int lane, int j) {
    return 16 * (j >> 1) + 8 * (j & 1) + (lane >> 2);
  }
};
template <>
struct Layout<1> : MmaLayout {};
template <>
struct Layout<2> : MmaLayout {};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// The one arrival of a barrier's phase, which also expects `bytes` more
// from the bulk copies that complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// A bulk copy by the TMA unit of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global src to shared dst, completing on bar; with
// a mask of more than one CTA, into the same offsets of each CTA of the
// cluster in it, each completing on its own bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          uint16_t mask) {
  if (mask == 1)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
}

// Orders this thread's writes to shared memory before later bulk copies
// into the same buffers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t f2u(float x) { return __float_as_uint(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // exact: rounded
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// v[ri][j] = sum_k hs[row(ri)][k] ws[k][state(j)] over the warp's 16 rows,
// fp32 FMAs in the order of k; with acc added to v (the next chunk of k).
__device__ __forceinline__ void gemm_fma(const float* hs, const float* ws,
                                         int sk, int sp, bool acc,
                                         float (&v)[4][17]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cx = lane & 7;
  if (!acc)
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int j = 0; j < 17; ++j) v[ri][j] = 0.0f;
  const float* hr = hs + Layout<0>::row(warp, lane, 0) * sp;
#pragma unroll 2
  for (int k = 0; k < sk; k += 4) {
    float4 a[4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
      a[ri] = *reinterpret_cast<const float4*>(hr + 4 * ri * sp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = ws + (k + kk) * NC;
      float b[17];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(wr + 32 * g + 4 * cx);
        b[4 * g] = t.x;  // states 32 g + cx + 8 e: j = 4 g + e
        b[4 * g + 1] = t.y;
        b[4 * g + 2] = t.z;
        b[4 * g + 3] = t.w;
      }
      b[16] = wr[128 + cx];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const float ak = kk == 0 ? a[ri].x : kk == 1 ? a[ri].y
                         : kk == 2 ? a[ri].z : a[ri].w;
#pragma unroll
        for (int j = 0; j < 17; ++j) v[ri][j] = fmaf(ak, b[j], v[ri][j]);
      }
    }
  }
}

// The same product on the tensor cores, transposed: D[state][row] =
// W^T[state][k] h^T[k][row], 9 m16 tiles of states by 2 n8 tiles of the
// warp's rows; TF32 m16n8k8 (kRound 1) or bf16 m16n8k16 (kRound 2); with
// acc added to v.
template <int kRound>
__device__ __forceinline__ void gemm_mma(const float* hs, const float* ws,
                                         int sk, int sp, bool acc,
                                         float (&v)[4][18]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  float c[9][2][4];
#pragma unroll
  for (int mt = 0; mt < 9; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      c[mt][nt][0] = acc ? v[2 * nt][2 * mt] : 0.0f;
      c[mt][nt][1] = acc ? v[2 * nt + 1][2 * mt] : 0.0f;
      c[mt][nt][2] = acc ? v[2 * nt][2 * mt + 1] : 0.0f;
      c[mt][nt][3] = acc ? v[2 * nt + 1][2 * mt + 1] : 0.0f;
    }
  const float* hr[2] = {hs + (16 * warp + g) * sp, hs + (16 * warp + 8 + g) * sp};
  if constexpr (kRound == 1) {
#pragma unroll 2
    for (int k0 = 0; k0 < sk; k0 += 8) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        b[nt][0] = f2u(hr[nt][k0 + q]);
        b[nt][1] = f2u(hr[nt][k0 + q + 4]);
      }
      const float* w0 = ws + (k0 + q) * NC + g;
      const float* w1 = ws + (k0 + q + 4) * NC + g;
#pragma unroll
      for (int mt = 0; mt < 9; ++mt) {
        const uint32_t a0 = f2u(w0[16 * mt]), a2 = f2u(w1[16 * mt]);
        const uint32_t a1 = mt < 8 ? f2u(w0[16 * mt + 8]) : 0u;
        const uint32_t a3 = mt < 8 ? f2u(w1[16 * mt + 8]) : 0u;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_tf32(c[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  } else {
#pragma unroll 2
    for (int k0 = 0; k0 < sk; k0 += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 lo = *reinterpret_cast<const float2*>(hr[nt] + k0 + 2 * q);
        const float2 hi = *reinterpret_cast<const float2*>(hr[nt] + k0 + 2 * q + 8);
        b[nt][0] = pack_bf16(lo.x, lo.y);
        b[nt][1] = pack_bf16(hi.x, hi.y);
      }
      const float* w0 = ws + (k0 + 2 * q) * NC + g;   // rows k, k + 1
      const float* w8 = ws + (k0 + 2 * q + 8) * NC + g;  // rows k + 8, k + 9
#pragma unroll
      for (int mt = 0; mt < 9; ++mt) {
        const int s = 16 * mt;
        const uint32_t a0 = pack_bf16(w0[s], w0[NC + s]);
        const uint32_t a2 = pack_bf16(w8[s], w8[NC + s]);
        const uint32_t a1 = mt < 8 ? pack_bf16(w0[s + 8], w0[NC + s + 8]) : 0u;
        const uint32_t a3 = mt < 8 ? pack_bf16(w8[s + 8], w8[NC + s + 8]) : 0u;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(c[mt][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  }
  // c0: (state 16 mt + g, row 8 nt + 2 q), c1: row + 1, c2: state + 8, c3
#pragma unroll
  for (int mt = 0; mt < 9; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      v[2 * nt][2 * mt] = c[mt][nt][0];
      v[2 * nt + 1][2 * mt] = c[mt][nt][1];
      v[2 * nt][2 * mt + 1] = c[mt][nt][2];
      v[2 * nt + 1][2 * mt + 1] = c[mt][nt][3];
    }
}

template <int kRound>
__device__ __forceinline__ void gemm(const float* hs, const float* ws, int sk,
                                     int sp, bool acc,
                                     float (&v)[4][Layout<kRound>::NJ]) {
  if constexpr (kRound == 0)
    gemm_fma(hs, ws, sk, sp, acc, v);
  else
    gemm_mma<kRound>(hs, ws, sk, sp, acc, v);
}

// Reduce over the 8 lanes that hold a row: the maximum, or the sum (both
// commutative at each step, so every lane ends with the same bits).
template <int SHIFT>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off << SHIFT));
  return x;
}

template <int SHIFT>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, off << SHIFT));
  return x;
}

// Each row's maximum m over the CTA's states (invalid ones hold -inf) and
// sum s of exp(x - m), by ex2.approx (__expf: relative error about 1e-6 at
// the arguments that count, below the product's own rounding); with
// kStore the exponentials replace x.
template <int kRound, bool kStore>
__device__ __forceinline__ void cta_row_stats(
    float (&x)[4][Layout<kRound>::NJ], float (&m)[4], float (&s)[4]) {
  using L = Layout<kRound>;
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    float mx = x[ri][0];
#pragma unroll
    for (int j = 1; j < L::NJ; ++j) mx = fmaxf(mx, x[ri][j]);
    m[ri] = row_max<L::SHIFT>(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < L::NJ; ++j) {
      const float e = __expf(__fsub_rn(x[ri][j], m[ri]));
      sum = __fadd_rn(sum, e);
      if (kStore) x[ri][j] = e;
    }
    s[ri] = row_sum<L::SHIFT>(sum);
  }
}

// Merge a partial (m2, s2) into (m, s); commutative, -inf an empty part.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mo = fmaxf(m, m2);
  const float a = m == -CUDART_INF_F ? 0.0f : __fmul_rn(s, expf(__fsub_rn(m, mo)));
  const float b = m2 == -CUDART_INF_F ? 0.0f : __fmul_rn(s2, expf(__fsub_rn(m2, mo)));
  s = __fadd_rn(a, b);
  m = mo;
}

// The rows' (maximum, sum) over the cluster from each CTA's (m, s): pairs
// to buf [RT][2] (a lane of each row writes one of its rows), a cluster
// barrier, then row lane l reads CTA l's pairs and the 8 lanes merge them.
template <int kRound>
__device__ __forceinline__ void exchange(cg::cluster_group& cluster, float* buf,
                                         int ncl, const float (&m)[4],
                                         const float (&s)[4], float (&mo)[4],
                                         float (&so)[4]) {
  using L = Layout<kRound>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rl = (lane >> L::SHIFT) & 7;
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
    if (rl == ri)
      *reinterpret_cast<float2*>(buf + 2 * L::row(warp, lane, ri)) =
          make_float2(m[ri], s[ri]);
  cluster.sync();
  const float* peer = rl < ncl ? cluster.map_shared_rank(buf, rl) : nullptr;
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    float2 t = make_float2(-CUDART_INF_F, 0.0f);
    if (peer) t = *reinterpret_cast<const float2*>(peer + 2 * L::row(warp, lane, ri));
    float mm = t.x, ss = t.y;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float m2 = __shfl_xor_sync(FULL, mm, off << L::SHIFT);
      const float s2 = __shfl_xor_sync(FULL, ss, off << L::SHIFT);
      merge(mm, ss, m2, s2);
    }
    mo[ri] = mm;
    so[ri] = ss;
  }
}

// h [K, M, S], wimg [K, ncl, sk + 1, NC] (each CTA's W slice as it lies
// in shared memory, then its bias row, ops/viterbi.head_weight_image:
// zeros past S and nstate, W's columns in the FMA path's order), weights
// [K] (kCombine) -> lp [M, nstate]. Grid: nclusters clusters of ncl CTAs.
// Resident (!kStream; S a multiple of 4, h 16-byte aligned): dynamic
// shared memory (smem_bytes) holds h stages [2][RT][sp], the W slice and
// bias [sk + 1][NC], row pairs [2][RT][2], and three mbarriers (the h
// stages', W's). Streamed (kStream): one h stage [RT][h_pitch(KC)] and a
// W chunk [KC][NC], refilled by plain loads for each KC of the depth.
template <int kRound, bool kCombine, bool kStream>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
head_kernel(const float* __restrict__ h, const float* __restrict__ wimg,
            const float* __restrict__ weights,
            float* __restrict__ lp, int K, int M, int S, int nstate,
            float hscale, float tempb, float c0, float c1) {
  using L = Layout<kRound>;
  constexpr int NJ = L::NJ;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / ncl, nclusters = gridDim.x / ncl;
  const int sk = k_extent(S), sp = kStream ? h_pitch(KC) : h_pitch(S);
  float* hs = smem;
  float* ws = hs + (kStream ? 1 : 2) * RT * sp;
  float* pairs = ws + (kStream ? KC : sk + 1) * NC;
  uint64_t* bars = reinterpret_cast<uint64_t*>(pairs + 4 * RT);
  const int col0 = rank * NC;
  const int ncols = min(NC, nstate - col0);
  const int ntiles = (M + RT - 1) / RT;
  const int njobs = cid < ntiles ? ((ntiles - 1 - cid) / nclusters + 1) * K : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool divide = tempb != 1.0f;
  const bool fix_h = kRound != 0 || hscale != 1.0f;
  const uint16_t everyone = (uint16_t)((1u << ncl) - 1);
  const unsigned wbytes = sizeof(float) * (sk + 1) * NC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's barriers ready before any copy lands

  // Job j: tile cid + (j / K) nclusters, member j % K, h stage j % 2. The
  // tile's rows come in once for the whole cluster: each CTA copies the
  // rows rank, rank + ncl, ... multicast to every CTA, and each expects
  // all of them; rows past M and the depth past S are zeros.
  auto tile_rows = [&](int job) {
    const int row0 = (cid + (job / K) * nclusters) * RT;
    return min(RT, M - row0);
  };
  auto issue_h = [&](int job) {
    const int st = job & 1, k = job % K;
    const int row0 = (cid + (job / K) * nclusters) * RT, rows = tile_rows(job);
    float* dst = hs + st * RT * sp;
    if (threadIdx.x == 0) mbar_expect(&bars[st], sizeof(float) * rows * S);
    if (warp == 0)
      for (int r = rank + ncl * lane; r < rows; r += 32 * ncl)
        bulk_copy(dst + r * sp, h + ((size_t)k * M + row0 + r) * S,
                  sizeof(float) * S, &bars[st], everyone);
    for (int i = threadIdx.x; i < RT * (sk - S); i += THREADS)
      dst[(i / (sk - S)) * sp + S + i % (sk - S)] = 0.0f;
    for (int i = threadIdx.x; i < (RT - rows) * S; i += THREADS)
      dst[(rows + i / S) * sp + i % S] = 0.0f;
  };
  // The CTA's W slice of the job's member: one bulk copy of its image.
  auto issue_w = [&](int job) {
    if (threadIdx.x != 0) return;
    mbar_expect(&bars[2], wbytes);
    bulk_copy(ws, wimg + ((size_t)(job % K) * ncl + rank) * (sk + 1) * NC,
              wbytes, &bars[2], 1);
  };

  int ex = 0;  // exchanges so far: the parity of the pair buffer
  float comb[4][NJ];
  if (!kStream && njobs > 0) {
    issue_w(0);
    issue_h(0);
  }
  for (int job = 0; job < njobs; ++job) {
    const int tile = cid + (job / K) * nclusters, k = job % K;
    float v[4][NJ];
    const float* bias;  // the CTA's bias slice: in shared or global memory
    if constexpr (kStream) {
      // Each KC of the depth in turn: the tile's rows and the W slice's
      // rows, scaled and rounded as they land, zeros past S and M; the
      // product goes on in the order of k, as in one pass.
      const int rows = tile_rows(job);
      const float* hk = h + ((size_t)k * M + (size_t)tile * RT) * S;
      const float* wk = wimg + ((size_t)k * ncl + rank) * (sk + 1) * NC;
      for (int k0 = 0; k0 < sk; k0 += KC) {
        const int kc = min(KC, sk - k0);
        __syncthreads();  // the last chunk's product is done with hs, ws
        for (int i = threadIdx.x; i < RT * kc; i += THREADS) {
          const int r = i / kc, c = i % kc;
          hs[r * sp + c] = r < rows && k0 + c < S
                               ? round_operand<kRound>(__fmul_rn(
                                     hk[(size_t)r * S + k0 + c], hscale))
                               : 0.0f;
        }
        const float4* src = reinterpret_cast<const float4*>(wk + (size_t)k0 * NC);
        for (int i = threadIdx.x; i < kc * NC / 4; i += THREADS) {
          float4 t = src[i];
          t.x = round_weight<kRound>(t.x);
          t.y = round_weight<kRound>(t.y);
          t.z = round_weight<kRound>(t.z);
          t.w = round_weight<kRound>(t.w);
          reinterpret_cast<float4*>(ws)[i] = t;
        }
        __syncthreads();
        gemm<kRound>(hs, ws, kc, sp, k0 > 0, v);
      }
      bias = wk + (size_t)sk * NC;
    } else {
      // In flight: h and W of this job, issued during the last job's
      // softmax (or before the loop).
      const bool new_w = kCombine || job == 0;
      mbar_wait(&bars[job & 1], (job >> 1) & 1);
      if (new_w) mbar_wait(&bars[2], job & 1);
      // Scale and round the rows (and the new slice) where they landed;
      // the fence orders these writes before later copies into the
      // buffers.
      float* hst = hs + (job & 1) * RT * sp;
      if (fix_h)
        for (int r = warp; r < tile_rows(job); r += WARPS)
          for (int c = lane; c < S; c += 32)
            hst[r * sp + c] = round_operand<kRound>(__fmul_rn(hst[r * sp + c], hscale));
      if (kRound != 0 && new_w)
        for (int i = threadIdx.x; i < S * NC; i += THREADS)
          ws[i] = round_weight<kRound>(ws[i]);
      fence_proxy_async();
      __syncthreads();
      gemm<kRound>(hst, ws, sk, sp, false, v);
      bias = ws + sk * NC;
    }

    // Logits: (acc + b) / tempb, -inf past the slice's states.
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int s = L::state(lane, j);
      const bool ok = s < ncols;
      const float bc = ok ? bias[s] : 0.0f;
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const float y = __fadd_rn(v[ri][j], bc);
        v[ri][j] = !ok ? -CUDART_INF_F : divide ? __fdiv_rn(y, tempb) : y;
      }
    }
    float pm[4], ps[4], gm[4], gs[4];
    cta_row_stats<kRound, true>(v, pm, ps);
    exchange<kRound>(cluster, pairs + (ex++ & 1) * 2 * RT, ncl, pm, ps, gm, gs);
    // Every warp of the cluster is past this job's product: the next
    // job's rows come into the other stage, and K members' next W slice,
    // while this job's softmax runs.
    if (!kStream && job + 1 < njobs) {
      issue_h(job + 1);
      if (kCombine) issue_w(job + 1);
    }
    // p = exp(y - m_cta) * exp(m_cta - m) / sum; lp = log(c0 + c1 p).
    const float wk = kCombine ? weights[k] : 1.0f;
    const int row0 = tile * RT;
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const float rs = __fdiv_rn(expf(__fsub_rn(pm[ri], gm[ri])), gs[ri]);
      const int r = row0 + L::row(warp, lane, ri);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float l =  // lg2.approx: within 2e-7 absolute
            __logf(__fadd_rn(c0, __fmul_rn(c1, __fmul_rn(v[ri][j], rs))));
        if constexpr (kCombine) {
          const float lk = __fmul_rn(l, wk);
          comb[ri][j] = k == 0 ? lk : __fadd_rn(comb[ri][j], lk);
        } else {
          const int s = L::state(lane, j);
          if (r < M && s < ncols) lp[(size_t)r * nstate + col0 + s] = l;
        }
      }
    }
    if constexpr (kCombine) {
      if (k == K - 1) {  // the renormalisation, then the one write
        float x[4][NJ];
#pragma unroll
        for (int ri = 0; ri < 4; ++ri)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            x[ri][j] = L::state(lane, j) < ncols ? comb[ri][j] : -CUDART_INF_F;
        cta_row_stats<kRound, false>(x, pm, ps);
        exchange<kRound>(cluster, pairs + (ex++ & 1) * 2 * RT, ncl, pm, ps, gm, gs);
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          const float lse = __fadd_rn(gm[ri], logf(gs[ri]));
          const int r = row0 + L::row(warp, lane, ri);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int s = L::state(lane, j);
            if (r < M && s < ncols)
              lp[(size_t)r * nstate + col0 + s] = __fsub_rn(comb[ri][j], lse);
          }
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer may read its pairs
}

// Dynamic shared memory of the kernel for hidden size S, resident or
// streamed (ops/viterbi.head_smem_bytes).
size_t smem_bytes(int S, bool streamed) {
  const size_t stage = streamed ? RT * h_pitch(KC) : 2 * RT * h_pitch(S);
  const size_t wrows = streamed ? KC : k_extent(S) + 1;
  return sizeof(float) * (stage + wrows * NC + 4 * RT) + 3 * sizeof(uint64_t);
}

template <int kRound, bool kCombine, bool kStream>
cudaError_t head_config(int nstate, int S, int nclusters,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(S, kStream);
  const int ncl = (nstate + NC - 1) / NC;
  cudaError_t err = cudaFuncSetAttribute(head_kernel<kRound, kCombine, kStream>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ncl * nclusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename F>
int with_instance(int rounding, bool combine, bool streamed, F f) {
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const auto rc = std::integral_constant<int, R>{};
    if (streamed)
      return combine ? f(rc, std::true_type{}, std::true_type{})
                     : f(rc, std::false_type{}, std::true_type{});
    return combine ? f(rc, std::true_type{}, std::false_type{})
                   : f(rc, std::false_type{}, std::false_type{});
  });
}

// The resident kernel copies h's rows in 16-byte units and must hold the
// whole W slice and two h stages; the streamed one takes any S >= 1.
bool valid_shape(int nstate, int S, bool streamed) {
  return nstate >= 1 && nstate <= MAX_CLUSTER * NC && S >= 1 &&
         (streamed || (S % 4 == 0 && smem_bytes(S, false) <= 232448));
}

}  // namespace

extern "C" {

// Clusters of the head kernel that fit on the current device at once (the
// wrapper launches min(that, tiles)), or minus a cudaError_t.
int scrappie_head_max_clusters(int nstate, int S, int combine, int rounding,
                               int streamed) {
  if (!valid_shape(nstate, S, streamed != 0)) return -(int)cudaErrorInvalidValue;
  return with_instance(rounding, combine != 0, streamed != 0, [&](auto r, auto c,
                                                                auto st) {
    constexpr int R = decltype(r)::value;
    constexpr bool C = decltype(c)::value, St = decltype(st)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = head_config<R, C, St>(nstate, S, 1, cfg, attr, nullptr);
    if (err != cudaSuccess) return -(int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, head_kernel<R, C, St>, &cfg);
    return err == cudaSuccess ? n : -(int)err;
  });
}

// h [K, M, S], wimg [K, ceil(nstate / 136), k_extent(S) + 1, 136] (the
// W slices' and biases' image, ops/viterbi.head_weight_image), weights [K]
// -> lp [M, nstate]; all fp32, contiguous, on the current device, wimg
// 16-byte aligned; streamed 0 (resident: h 16-byte aligned and S a
// multiple of 4 whose stages fit) or 1 (ops/viterbi.head_streams).
// weights null: one model (K must be 1), no combination. nclusters
// clusters of ceil(nstate / 136) CTAs (ops/viterbi.head_launch). rounding
// 0, 1 or 2: none, TF32 or bfloat16 operands. Returns a cudaError_t.
int scrappie_head(const float* h, const float* wimg, const float* weights,
                  float* lp, int K, int M, int S,
                  int nstate, float hscale, float tempb, float c0, float c1,
                  int nclusters, int rounding, int streamed,
                  cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if (K < 1 || (weights == nullptr && K != 1) || nclusters < 1 ||
      !valid_shape(nstate, S, streamed != 0) ||
      (!streamed && reinterpret_cast<uintptr_t>(h) % 16 != 0) ||
      reinterpret_cast<uintptr_t>(wimg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return with_instance(rounding, weights != nullptr, streamed != 0, [&](auto r, auto c,
                                                                      auto st) {
    constexpr int R = decltype(r)::value;
    constexpr bool C = decltype(c)::value, St = decltype(st)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err = head_config<R, C, St>(nstate, S, nclusters, cfg, attr, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, head_kernel<R, C, St>, h, wimg, weights, lp,
                             K, M, S, nstate, hscale, tempb, c0, c1);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  });
}

}  // extern "C"
