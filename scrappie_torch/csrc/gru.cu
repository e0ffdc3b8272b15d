// The GRU recurrence over inputs projected before (csrc/project.cu writes
// x @ iW + b for every step and row), and the superseded GRU layer kernel
// that projects inside its step loop.
//
// Replaces, in scrappie_tpu/ops/gru.py:
//   _gru_fused_kernel  wrapper gru_layer_fused_tm: the projection kernel,
//                      then gru_recurrence_kernel (gru_layer_kernel, the
//                      first port, is kept and timed; no path launches it)
//   _gru_kernel        wrapper gru_tm_padded: gru_recurrence_kernel
// and, with no TPU kernel of its own, the VJP XLA derives for the lax.scan
// of scrappie_tpu/nn/rnn.py:gru when the JAX trainer differentiates it:
// gru_recurrence_bwd_kernel (wrapper ops/gru.gru_walk, the walk of
// gru_tm_backward; its note is beside it).
// Per time step, for one batch row:
//
//   xin  = x[t] @ iW + b                     (the projection, [3S])
//   z, r = sigmoid(xin[:2S] + h @ sW)
//   hbar = tanh(xin[2S:] + (r * h) @ sW2)
//   h    = z * h + (1 - z) * hbar
//
// with h = 0 before the first step; `reverse` walks time backwards.
//
// What bounds it on the H100: the recurrence is sequential in T, so one
// row's time is T times the latency of one step: two dependent matrix-vector
// products (h @ sW, then (r * h) @ sW2), a barrier after each, and the
// gates. The arithmetic is small (3 S^2 multiply-adds per row and step); the
// weights (27 648 floats at S = 96) must stay on chip, and the step's
// latency is set by how many dependent instructions and shared-memory
// transactions each thread issues between the barriers.
//
// Design (gru_recurrence_kernel): one block per batch row, weights in
// registers. Thread j < 2S holds z/r column j of sW whole (LA = 1 lane a
// column, REG_MAX_S = 96 rows); each of the S candidate columns is split
// over LB = 2 lanes of 48 rows of sW2 (2S threads, 192 at S = 96; 144
// weights a thread, no spill). A step: every lane reads its slice of h
// from shared memory as float4 broadcasts, takes its partial dot product
// (four independent FMA chains), and the lanes of a column add theirs by
// a warp shuffle; the column's first lane adds the projected input and
// writes z or r * h to shared memory. Barrier. The same for (r * h) @ sW2,
// then the first lane of candidate column k writes h[k] to shared memory
// and to y. Barrier. No weight is read from memory inside the step loop.
// The projected input of the next RING steps is in flight by cp.async into
// a ring in shared memory, each column's first lane copying and reading
// back its own entries, so the load needs no barrier of its own. S <= 96.
// Why this split: on an H100, at S = 96 and T = 2000, 4 / 8 lanes a
// column (768 threads) took 2.39 ms, 2 / 4 lanes 1.78 ms and 1 / 2 lanes
// 1.33 ms (B = 8 and 64): fewer lanes mean fewer shuffles and fewer
// warps for each barrier, and 24-deep FMA chains still hide their latency.
//
// Big-S mode (template switch kGlobal): for S > 96 lanes of GLA = 4 (z/r)
// and GLB = 8 (candidate) walk the columns in turn (1024 threads) and read
// sW and sW2 from global memory, where they stay in L2 (1.5 MB at S =
// 352), and the projected input in the step that uses it. Same arithmetic.
//
// Big-S walk (gru_walk_global_kernel, S > 96): the backward walk's weights
// read from global memory, where they stay in L2, one block of 1024
// threads a row, three barriers a step: a thread a unit k takes dh, da_z
// and da_h and keeps the gates' factors in shared memory; then lanes of
// BGL = 8 an output take da_h @ sW2^T and da_z @ sW_z^T from the weights'
// rows (sW2[k, :] and sW[k, :S], contiguous) and da_r; then da_r @ sW_r^T
// and the carry. The same arithmetic as gru_recurrence_bwd_kernel's, the
// sums in another order. A simple kernel: it runs only above the shipped
// models' S = 96.
//
// Precision (template kRound of gru_recurrence_kernel, rounding.cuh): in
// 'default' and 'bf16' the weights are rounded once, where they are loaded
// into registers (the big-S mode rounds each weight it reads from L2), and
// the two activations where they are formed: r * h when it is written to
// shared memory, and h into a rounded copy beside it (the gates read the
// unrounded h), so a step does the same FMAs as in 'highest'. The two
// walks take the same kRound (the forward's, nn/config.grad_rounding):
// the weights rounded where they are loaded (or read, big-S); in 'default'
// (1) the cotangents da_z, da_r and da_h rounded to TF32 where they are
// written to shared memory, which only the products read (da gets them
// unrounded); in 'bf16' (2) each product's result rounded to bfloat16
// before it enters the step, drh = R(da_h @ sW2^T) (so da_r and the carry
// take the rounded drh) and R(da_z @ sW_z^T + da_r @ sW_r^T).
//
// The superseded gru_layer_kernel: one block per row and one thread per
// gate column (3S threads); iW, sW and sW2 in shared memory (224 KB at
// C = S = 96) and the 96-term projection of each step inside the loop.
#include <cuda_runtime.h>

#include "rounding.cuh"

namespace {

constexpr int REG_MAX_S = 96;  // the largest S whose weights stay in registers
constexpr int LA = 1;          // lanes of a z/r column, on chip
constexpr int LB = 2;          // lanes of a candidate column, on chip
constexpr int GLA = 4;         // lanes of a z/r column, big-S mode
constexpr int GLB = 8;         // lanes of a candidate column, big-S mode
constexpr int RING = 4;        // steps of projected input in flight
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// Sum over the L lanes of an aligned lane group; every lane gets it.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Partial dot product of one lane: vec[k0 .. k0 + N) against w[0 .. N),
// with vec in shared memory (16-byte aligned at k0) and w in registers.
template <int N>
__device__ __forceinline__ float lane_dot(const float* vec, const float (&w)[N]) {
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = v4[i];
    a0 = fmaf(v.x, w[4 * i], a0);
    a1 = fmaf(v.y, w[4 * i + 1], a1);
    a2 = fmaf(v.z, w[4 * i + 2], a2);
    a3 = fmaf(v.w, w[4 * i + 3], a3);
  }
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

// Partial dot product of one lane in the big-S mode: vec[k] * W[k, col]
// for k in [k0, min(k0 + n, S)), W row-major with ncol columns, each
// weight rounded as it is read.
template <int kRound>
__device__ __forceinline__ float lane_dot_global(const float* vec,
                                                 const float* __restrict__ W,
                                                 int ncol, int col, int k0,
                                                 int n, int S) {
  float a0 = 0.0f, a1 = 0.0f;
  const int kend = min(k0 + n, S);
  int k = k0;
  for (; k + 2 <= kend; k += 2) {
    a0 = fmaf(vec[k], round_weight<kRound>(__ldg(W + (size_t)k * ncol + col)),
              a0);
    a1 = fmaf(vec[k + 1],
              round_weight<kRound>(__ldg(W + (size_t)(k + 1) * ncol + col)), a1);
  }
  if (k < kend)
    a0 = fmaf(vec[k], round_weight<kRound>(__ldg(W + (size_t)k * ncol + col)),
              a0);
  return __fadd_rn(a0, a1);
}

// The copy and the wait are compiler barriers for memory ("memory"
// clobber), so that no read of a ring slot moves across the wait and no copy
// into a slot moves above the reads of its old values.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x [T, B, 3S] projected, sW [S, 2S], sW2 [S, S] -> y [T, B, S].
// kLA (kLB) lanes share a z/r (candidate) column, each holding
// REG_MAX_S / kLA (REG_MAX_S / kLB) of its weights in registers; the big-S
// mode (kGlobal) reads them from global memory instead. Shared memory: h
// [SP], r * h [SP], z [SP], h rounded [SP] (kRound only),
// SP = max(S, REG_MAX_S), the tails past S zero; on chip also a ring of
// RING projected input rows [RING][3S].
template <bool kGlobal, int kLA, int kLB, int kRound>
__global__ void __launch_bounds__(kGlobal ? 1024 : kLB * REG_MAX_S)
gru_recurrence_kernel(const float* __restrict__ x, const float* __restrict__ sW,
                      const float* __restrict__ sW2, float* __restrict__ y,
                      int T, int B, int S, int reverse) {
  constexpr int kRowsA = REG_MAX_S / kLA;  // rows of sW a lane holds
  constexpr int kRowsB = REG_MAX_S / kLB;  // rows of sW2 a lane holds
  extern __shared__ __align__(16) float smem[];
  const int SP = max(S, REG_MAX_S);
  float* s_h = smem;
  float* s_rh = s_h + SP;
  float* s_z = s_rh + SP;
  float* s_hr = s_z + SP;  // h rounded, the products' operand
  float* s_x = s_hr + SP;  // on chip: [RING][3S]
  const float* s_hd = kRound ? s_hr : s_h;  // what the products read
  const int S2 = 2 * S;
  const int S3 = 3 * S;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int la = tid % kLA;  // lane within a z/r column's group
  const int lb = tid % kLB;  // lane within a candidate column's group
  const int ga = tid / kLA;  // z/r column (on-chip mode)
  const int gb = tid / kLB;  // candidate column (on-chip mode)
  // Big-S mode: the rows of a lane, a multiple of 4.
  const int na = kGlobal ? ((S + kLA - 1) / kLA + 3) / 4 * 4 : kRowsA;
  const int nb = kGlobal ? ((S + kLB - 1) / kLB + 3) / 4 * 4 : kRowsB;

  for (int k = tid; k < SP; k += blockDim.x) {
    s_h[k] = 0.0f;
    s_rh[k] = 0.0f;
    s_hr[k] = 0.0f;
  }
  float wa[kGlobal ? 1 : kRowsA];
  float wb[kGlobal ? 1 : kRowsB];
  if (!kGlobal) {
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const int k = la * kRowsA + i;
      wa[i] = (ga < S2 && k < S) ? round_weight<kRound>(sW[(size_t)k * S2 + ga])
                                 : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      const int k = lb * kRowsB + i;
      wb[i] = (gb < S && k < S) ? round_weight<kRound>(sW2[(size_t)k * S + gb])
                                : 0.0f;
    }
  }
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  // On chip, the first lane of each column copies its projected input RING
  // steps ahead into the ring (cp.async) and reads it back itself, so no
  // barrier and no register waits on the load.
  const bool ownA = !kGlobal && la == 0 && ga < S2;
  const bool ownB = !kGlobal && lb == 0 && gb < S;
  auto fetch = [&](int n) {
    if (n < T) {
      const float* row = x + ((size_t)(t0 + n * dt) * B + b) * S3;
      float* slot = s_x + (n % RING) * S3;
      if (ownA) cp_async4(slot + ga, row + ga);
      if (ownB) cp_async4(slot + S2 + gb, row + S2 + gb);
    }
    cp_async_commit();
  };
  if (!kGlobal) {
    for (int n = 0; n < RING; ++n) fetch(n);
  }
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    const float* xrow = x + ((size_t)t * B + b) * S3;
    float xa = 0.0f, xb = 0.0f;
    if (!kGlobal) {
      cp_async_wait<RING - 1>();  // this thread's copies of step n
      const float* slot = s_x + (n % RING) * S3;
      if (ownA) xa = slot[ga];
      if (ownB) xb = slot[S2 + gb];
    }

    // z and r: h @ sW, one column per group of kLA lanes.
    if (kGlobal) {
      const int ngroup = blockDim.x / kLA;
      for (int j0 = 0; j0 < S2; j0 += ngroup) {
        const int j = j0 + tid / kLA;
        const float part = j < S2 ? lane_dot_global<kRound>(s_hd, sW, S2, j,
                                                            la * na, na, S)
                                  : 0.0f;
        const float rec = group_sum<kLA>(part);
        if (la == 0 && j < S2) {
          const float g = sigmoid_f32(__fadd_rn(xrow[j], rec));
          if (j < S) s_z[j] = g;
          else s_rh[j - S] = round_operand<kRound>(__fmul_rn(g, s_h[j - S]));
        }
      }
    } else {
      const float rec = group_sum<kLA>(lane_dot(s_hd + la * kRowsA, wa));
      if (ownA) {
        const float g = sigmoid_f32(__fadd_rn(xa, rec));
        if (ga < S) s_z[ga] = g;
        else s_rh[ga - S] = round_operand<kRound>(__fmul_rn(g, s_h[ga - S]));
      }
    }
    __syncthreads();

    // hbar = tanh(xin + (r * h) @ sW2), one column per group of kLB lanes,
    // then h.
    if (kGlobal) {
      const int ngroup = blockDim.x / kLB;
      for (int k0 = 0; k0 < S; k0 += ngroup) {
        const int k = k0 + tid / kLB;
        const float part = k < S ? lane_dot_global<kRound>(s_rh, sW2, S, k,
                                                           lb * nb, nb, S)
                                 : 0.0f;
        const float acc = group_sum<kLB>(part);
        if (lb == 0 && k < S) {
          const float hbar = tanhf(__fadd_rn(xrow[S2 + k], acc));
          const float z = s_z[k];
          const float hn = __fadd_rn(__fmul_rn(z, s_h[k]),
                                     __fmul_rn(__fsub_rn(1.0f, z), hbar));
          s_h[k] = hn;
          if (kRound) s_hr[k] = round_operand<kRound>(hn);
          y[((size_t)t * B + b) * S + k] = hn;
        }
      }
    } else {
      const float acc = group_sum<kLB>(lane_dot(s_rh + lb * kRowsB, wb));
      if (ownB) {
        const float hbar = tanhf(__fadd_rn(xb, acc));
        const float z = s_z[gb];
        const float hn = __fadd_rn(__fmul_rn(z, s_h[gb]),
                                   __fmul_rn(__fsub_rn(1.0f, z), hbar));
        s_h[gb] = hn;
        if (kRound) s_hr[gb] = round_operand<kRound>(hn);
        y[((size_t)t * B + b) * S + gb] = hn;
      }
      // Refill this step's slot (its values were consumed above).
      fetch(n + RING);
    }
    __syncthreads();
  }
}

// The recurrence's backward walk: gates [T, B, 3S] = (z | r | hbar) and
// h_prev [T, B, S] (h at the step before in the forward's order, 0 at its
// first step) of the forward, gh [T, B, S] the gradient of its output ->
// da [T, B, 3S] = (da_z | da_r | da_h), the gradient of the pre-activations
// (= of the projected input). dh is carried opposite to the forward's
// direction; per step, for one batch row:
//
//   dh   = carry + gh[t]
//   da_z = dh * c_z,  c_z = (h_prev - hbar) * z * (1 - z)
//   da_h = dh * c_h,  c_h = (1 - z) * (1 - hbar^2)
//   drh  = da_h @ sW2^T                         (d(r * h_prev))
//   da_r = drh * c_r, c_r = h_prev * r * (1 - r)
//   carry = dh * z + drh * r + da_z @ sW_z^T + da_r @ sW_r^T
//
// (sW = [sW_z | sW_r]); c_z, c_h and c_r do not depend on the carry.
//
// What bounded the walk this design replaced (2S threads, a thread an output and
// row half: a row half of sW2 and the whole z or r row of sW, the gates'
// arithmetic on the carried chain, five plain loads RING steps ahead and
// three plain stores a step), by timing probes that leave one part out
// (PERF.md section 6): its global memory
// accesses first, then the products' shared-memory reads. bar.sync waits
// until each thread's earlier memory accesses are performed (PTX ISA), so
// a load issued before a barrier is waited for there however many steps
// ahead it was issued; a cp.async copy is not. Design: the step's five
// inputs are copied by cp.async into a ring in shared memory RING steps
// ahead, each thread its own column, and a thread waits only for its own
// copies (cp.async.wait_group). Each thread holds a 4 x 12 tile (4
// outputs k, 12 rows j) of each of the three matrices, 144 weights in
// registers as before, so it reads only its 12 rows of each vector (three
// float4 a matrix, 8 distinct float4 a warp instruction, conflict-free): a
// quarter of the bytes. The 8 row groups of an output group are lanes of
// one warp; their partial sums are reduced by a reduce-scatter of shuffles
// (4 a matrix: xor 4 on pairs of outputs, xor 2, xor 1), after which lanes
// q and q^1 of the group both hold the whole sum of output k = 4 (tid / 8)
// + (q >> 1). The products that need only dh (da_h @ sW2^T and da_z @
// sW_z^T) run together before the second barrier, leaving after it only
// da_r @ sW_r^T, and the gates' factors c_z, c_h, c_r are taken off the
// chain, which is dh -> one multiply -> shared memory -> barrier -> two
// products -> one multiply -> barrier -> one product -> the carry. Two
// barriers a step remain: every output needs every output of the step's
// previous product. The stores of da stay plain stores (the lane pair
// splits them: one writes da_h and s_ah, the other da_z and s_az; then
// s_ar and da_r). They cost about a fifth of the step (1.19 against 0.96
// ms at T = 2000, B = 64 without them, on an H100), but every other way
// the probes tried was no faster: after the barriers, as float4 rows from
// shared memory, staged and written by bulk copies a step or 8 steps at a
// time, or with L2-only or streaming cache hints. 192 threads for any
// S <= 96 (tiles past S hold zeros).
constexpr int BW_OUT = 4;                       // outputs a thread
constexpr int BW_ROWS = 12;                     // rows of each matrix a thread
constexpr int BW_GROUP = REG_MAX_S / BW_ROWS;   // lanes of an output group
constexpr int BW_THREADS = REG_MAX_S / BW_OUT * BW_GROUP;
static_assert(BW_GROUP == 8, "the reduce-scatter's xor 4, 2, 1");

// The 4 outputs' partial sums of the 8 lanes of a group -> the whole sum of
// output q >> 1 (q the lane in the group), in lanes q and q^1 alike.
__device__ __forceinline__ float reduce_scatter(const float (&p)[BW_OUT],
                                                int q) {
  const bool hi = q & 4;
  const float s0 = __fadd_rn(hi ? p[2] : p[0],
                             __shfl_xor_sync(FULL, hi ? p[0] : p[2], 4));
  const float s1 = __fadd_rn(hi ? p[3] : p[1],
                             __shfl_xor_sync(FULL, hi ? p[1] : p[3], 4));
  const bool mid = q & 2;
  const float t = __fadd_rn(mid ? s1 : s0,
                            __shfl_xor_sync(FULL, mid ? s0 : s1, 2));
  return __fadd_rn(t, __shfl_xor_sync(FULL, t, 1));
}

// p[i] += sum over the thread's 12 rows of vec[j] * w[i][j], vec in shared
// memory (16-byte aligned), one FMA chain an output.
__device__ __forceinline__ void tile_dot(float (&p)[BW_OUT], const float* vec,
                                         const float (&w)[BW_OUT][BW_ROWS]) {
  const float4* v4 = reinterpret_cast<const float4*>(vec);
#pragma unroll
  for (int c = 0; c < BW_ROWS / 4; ++c) {
    const float4 v = v4[c];
#pragma unroll
    for (int i = 0; i < BW_OUT; ++i) {
      p[i] = fmaf(v.x, w[i][4 * c], p[i]);
      p[i] = fmaf(v.y, w[i][4 * c + 1], p[i]);
      p[i] = fmaf(v.z, w[i][4 * c + 2], p[i]);
      p[i] = fmaf(v.w, w[i][4 * c + 3], p[i]);
    }
  }
}

template <int kRound>
__global__ void __launch_bounds__(BW_THREADS)
gru_recurrence_bwd_kernel(const float* __restrict__ gates,
                          const float* __restrict__ h_prev,
                          const float* __restrict__ gh,
                          const float* __restrict__ sW,
                          const float* __restrict__ sW2,
                          float* __restrict__ da, int T, int B, int S,
                          int reverse) {
  __shared__ __align__(16) float s_az[REG_MAX_S];
  __shared__ __align__(16) float s_ah[REG_MAX_S];
  __shared__ __align__(16) float s_ar[REG_MAX_S];
  __shared__ float s_in[RING][5][BW_THREADS];  // the inputs' ring
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int q = tid % BW_GROUP;          // row group: rows 12q .. 12q + 11
  const int k0 = tid / BW_GROUP * BW_OUT;  // the group's outputs k0 .. k0 + 3
  const int k = k0 + (q >> 1);           // the output this lane ends with
  const bool live = k < S;
  const bool odd = q & 1;
  const int S3 = 3 * S;
  for (int i = tid; i < REG_MAX_S; i += BW_THREADS) {
    s_az[i] = 0.0f;
    s_ah[i] = 0.0f;
    s_ar[i] = 0.0f;
  }
  float w2[BW_OUT][BW_ROWS], wz[BW_OUT][BW_ROWS], wr[BW_OUT][BW_ROWS];
#pragma unroll
  for (int i = 0; i < BW_OUT; ++i) {
#pragma unroll
    for (int jj = 0; jj < BW_ROWS; ++jj) {
      const int ki = k0 + i, j = q * BW_ROWS + jj;
      const bool in = ki < S && j < S;
      w2[i][jj] = in ? round_weight<kRound>(sW2[(size_t)ki * S + j]) : 0.0f;
      wz[i][jj] = in ? round_weight<kRound>(sW[(size_t)ki * 2 * S + j]) : 0.0f;
      wr[i][jj] = in ? round_weight<kRound>(sW[(size_t)ki * 2 * S + S + j])
                     : 0.0f;
    }
  }
  // step n at t = reverse ? n : T-1-n (the forward's steps backwards)
  auto step_t = [&](int n) { return reverse ? n : T - 1 - n; };
  const int kc = min(k, S - 1);
  // This thread's five inputs of step n (z, r, hbar, h_prev, gh of output
  // k), copied by cp.async into its own column of slot n % RING.
  auto fetch = [&](int u, int n) {
    const size_t row = (size_t)step_t(min(n, T - 1)) * B + b;
    cp_async4(&s_in[u][0][tid], gates + row * S3 + kc);
    cp_async4(&s_in[u][1][tid], gates + row * S3 + S + kc);
    cp_async4(&s_in[u][2][tid], gates + row * S3 + 2 * S + kc);
    cp_async4(&s_in[u][3][tid], h_prev + row * S + kc);
    cp_async4(&s_in[u][4][tid], gh + row * S + kc);
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < RING; ++u) fetch(u, u);
  __syncthreads();  // the zeros before any step's writes
  float carry = 0.0f;
  for (int n0 = 0; n0 < T; n0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int n = n0 + u;
      if (n >= T) break;  // uniform across the block
      const size_t row = (size_t)step_t(n) * B + b;
      cp_async_wait<RING - 1>();  // this thread's copies of step n
      const float z = s_in[u][0][tid], r = s_in[u][1][tid];
      const float hb = s_in[u][2][tid], hp = s_in[u][3][tid];
      const float one_z = __fsub_rn(1.0f, z);
      const float cz = __fmul_rn(__fmul_rn(__fsub_rn(hp, hb), z), one_z);
      const float ch = __fmul_rn(one_z, __fsub_rn(1.0f, __fmul_rn(hb, hb)));
      const float cr = __fmul_rn(__fmul_rn(hp, r), __fsub_rn(1.0f, r));
      const float dh = __fadd_rn(carry, s_in[u][4][tid]);
      fetch(u, n + RING);
      if (live) {
        if (odd) {
          const float az = __fmul_rn(dh, cz);
          s_az[k] = round_cotangent<kRound>(az);
          da[row * S3 + k] = az;
        } else {
          const float ah = __fmul_rn(dh, ch);
          s_ah[k] = round_cotangent<kRound>(ah);
          da[row * S3 + 2 * S + k] = ah;
        }
      }
      __syncthreads();
      float p2[BW_OUT] = {0.0f, 0.0f, 0.0f, 0.0f};
      float pz[BW_OUT] = {0.0f, 0.0f, 0.0f, 0.0f};
      tile_dot(p2, s_ah + q * BW_ROWS, w2);
      tile_dot(pz, s_az + q * BW_ROWS, wz);
      const float drh = round_result<kRound>(reduce_scatter(p2, q));
      const float recz = reduce_scatter(pz, q);
      const float ar = __fmul_rn(drh, cr);
      if (live) {
        if (odd) da[row * S3 + S + k] = ar;
        else s_ar[k] = round_cotangent<kRound>(ar);
      }
      __syncthreads();
      float pr[BW_OUT] = {0.0f, 0.0f, 0.0f, 0.0f};
      tile_dot(pr, s_ar + q * BW_ROWS, wr);
      const float recr = reduce_scatter(pr, q);
      carry = __fadd_rn(__fadd_rn(__fmul_rn(dh, z), __fmul_rn(drh, r)),
                        round_result<kRound>(__fadd_rn(recz, recr)));
    }
  }
}

constexpr int BGL = 8;  // lanes of an output in the big-S walk

// Partial dot product of one lane of BGL: vec[j] * W[k, col0 + j] for
// j = la, la + BGL, ... < S, vec in shared memory, W's row k contiguous,
// each weight rounded as it is read.
template <int kRound>
__device__ __forceinline__ float row_dot(const float* vec,
                                         const float* __restrict__ wrow,
                                         int la, int S) {
  float a0 = 0.0f, a1 = 0.0f;
  int j = la;
  for (; j + BGL < S; j += 2 * BGL) {
    a0 = fmaf(vec[j], round_weight<kRound>(__ldg(wrow + j)), a0);
    a1 = fmaf(vec[j + BGL], round_weight<kRound>(__ldg(wrow + j + BGL)), a1);
  }
  if (j < S) a0 = fmaf(vec[j], round_weight<kRound>(__ldg(wrow + j)), a0);
  return __fadd_rn(a0, a1);
}

// The walk with its weights in global memory: gru_recurrence_bwd_kernel's
// arguments, any S (shared memory: 10 S floats).
template <int kRound>
__global__ void __launch_bounds__(1024)
gru_walk_global_kernel(const float* __restrict__ gates,
                       const float* __restrict__ h_prev,
                       const float* __restrict__ gh,
                       const float* __restrict__ sW,
                       const float* __restrict__ sW2, float* __restrict__ da,
                       int T, int B, int S, int reverse) {
  extern __shared__ float sm[];
  float* s_carry = sm;
  float* s_dh = s_carry + S;
  float* s_z = s_dh + S;
  float* s_r = s_z + S;
  float* s_cr = s_r + S;
  float* s_az = s_cr + S;
  float* s_ah = s_az + S;
  float* s_ar = s_ah + S;
  float* s_part = s_ar + S;
  float* s_recz = s_part + S;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int la = tid % BGL, ngroup = nt / BGL;
  const int S2 = 2 * S, S3 = 3 * S;
  for (int k = tid; k < S; k += nt) s_carry[k] = 0.0f;
  __syncthreads();
  for (int n = 0; n < T; ++n) {
    const int t = reverse ? n : T - 1 - n;
    const size_t row = (size_t)t * B + b;
    for (int k = tid; k < S; k += nt) {
      const float z = gates[row * S3 + k], r = gates[row * S3 + S + k];
      const float hb = gates[row * S3 + S2 + k], hp = h_prev[row * S + k];
      const float one_z = __fsub_rn(1.0f, z);
      const float cz = __fmul_rn(__fmul_rn(__fsub_rn(hp, hb), z), one_z);
      const float ch = __fmul_rn(one_z, __fsub_rn(1.0f, __fmul_rn(hb, hb)));
      const float cr = __fmul_rn(__fmul_rn(hp, r), __fsub_rn(1.0f, r));
      const float dh = __fadd_rn(s_carry[k], gh[row * S + k]);
      const float az = __fmul_rn(dh, cz), ah = __fmul_rn(dh, ch);
      s_az[k] = round_cotangent<kRound>(az);
      s_ah[k] = round_cotangent<kRound>(ah);
      da[row * S3 + k] = az;
      da[row * S3 + S2 + k] = ah;
      s_dh[k] = dh;
      s_z[k] = z;
      s_r[k] = r;
      s_cr[k] = cr;
    }
    __syncthreads();
    for (int k0 = 0; k0 < S; k0 += ngroup) {
      const int k = k0 + tid / BGL;
      const bool live = k < S;
      const float p2 = round_result<kRound>(group_sum<BGL>(
          live ? row_dot<kRound>(s_ah, sW2 + (size_t)k * S, la, S) : 0.0f));
      const float pz = group_sum<BGL>(
          live ? row_dot<kRound>(s_az, sW + (size_t)k * S2, la, S) : 0.0f);
      if (live && la == 0) {
        const float ar = __fmul_rn(p2, s_cr[k]);
        s_ar[k] = round_cotangent<kRound>(ar);
        da[row * S3 + S + k] = ar;
        s_part[k] = __fadd_rn(__fmul_rn(s_dh[k], s_z[k]), __fmul_rn(p2, s_r[k]));
        s_recz[k] = pz;
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < S; k0 += ngroup) {
      const int k = k0 + tid / BGL;
      const bool live = k < S;
      const float pr = group_sum<BGL>(
          live ? row_dot<kRound>(s_ar, sW + (size_t)k * S2 + S, la, S) : 0.0f);
      if (live && la == 0)
        s_carry[k] = __fadd_rn(s_part[k],
                               round_result<kRound>(__fadd_rn(s_recz[k], pr)));
    }
    __syncthreads();
  }
}

// The superseded layer kernel: x [T, B, C], xin = x[t] @ iW + b computed in
// the step loop by thread j for its gate column j (blockDim.x == 3S >= C).
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
  float* s_iW = s_z + S;          // [C, 3S]
  float* s_x = s_iW + C * S3;     // [2, C] input row, double-buffered

  const int b = blockIdx.x;
  const int j = threadIdx.x;  // gate column
  for (int i = j; i < S * S2; i += blockDim.x) s_sW[i] = sW[i];
  for (int i = j; i < S * S; i += blockDim.x) s_sW2[i] = sW2[i];
  for (int i = j; i < C * S3; i += blockDim.x) s_iW[i] = iW[i];
  if (j < S) s_h[j] = 0.0f;
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  const float bj = bias[j];
  if (j < C) s_x[j] = x[((size_t)t0 * B + b) * C + j];
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    const bool more = n + 1 < T;
    const float* xs = s_x + (n & 1) * C;
    float xnext = 0.0f;
    if (j < C && more) xnext = x[((size_t)(t + dt) * B + b) * C + j];
    float acc = 0.0f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) acc = fmaf(xs[c], s_iW[c * S3 + j], acc);
    const float xin = __fadd_rn(acc, bj);
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
    if (j < C && more) s_x[((n + 1) & 1) * C + j] = xnext;
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
    __syncthreads();
  }
}

template <bool kGlobal, int kLA, int kLB, int kRound>
int launch_recurrence(const float* x, const float* sW, const float* sW2,
                      float* y, int T, int B, int S, int reverse, int threads,
                      cudaStream_t stream) {
  const size_t sp = S > REG_MAX_S ? S : REG_MAX_S;
  const size_t smem = sizeof(float) * (4 * sp + (kGlobal ? 0 : RING * 3 * (size_t)S));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_recurrence_kernel<kGlobal, kLA, kLB, kRound>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gru_recurrence_kernel<kGlobal, kLA, kLB, kRound><<<B, threads, smem, stream>>>(
      x, sW, sW2, y, T, B, S, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the superseded layer kernel needs for input width
// C and size S.
size_t scrappie_gru_smem_bytes(int C, int S) {
  return sizeof(float) *
         ((size_t)C * 3 * S + (size_t)3 * S * S + 2 * (size_t)C + 3 * (size_t)S);
}

// The superseded layer kernel: x [T, B, C], iW [C, 3S], b [3S], sW [S, 2S],
// sW2 [S, S] -> y [T, B, S]; all fp32, contiguous, on the current device.
// Returns a cudaError_t.
int scrappie_gru_layer(const float* x, const float* iW, const float* b,
                       const float* sW, const float* sW2, float* y, int T,
                       int B, int C, int S, int reverse, cudaStream_t stream) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  const size_t smem = scrappie_gru_smem_bytes(C, S);
  cudaError_t err = cudaFuncSetAttribute(
      gru_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_layer_kernel<<<B, 3 * S, smem, stream>>>(x, iW, b, sW, sW2, y, T, B, C,
                                               S, reverse);
  return (int)cudaGetLastError();
}

// x [T, B, 3S] projected, sW [S, 2S], sW2 [S, S] -> y [T, B, S]; all fp32,
// contiguous, on the current device. global = 0: weights in registers
// (S <= REG_MAX_S, which ops/gru.py names REGISTER_MAX_S); global = 1: the
// big-S mode. rounding 0, 1 or 2: none, TF32 or bfloat16 operands.
// Returns a cudaError_t.
int scrappie_gru_recurrence(const float* x, const float* sW, const float* sW2,
                            float* y, int T, int B, int S, int reverse,
                            int global, int rounding, cudaStream_t stream) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  if (!global && S > REG_MAX_S) return (int)cudaErrorInvalidValue;
  // LA threads per z/r column, LB per candidate column: 2S either way.
  static_assert(LA * 2 == LB, "one thread count serves both products");
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (global)
      return launch_recurrence<true, GLA, GLB, R>(x, sW, sW2, y, T, B, S,
                                                  reverse, 1024, stream);
    return launch_recurrence<false, LA, LB, R>(x, sW, sW2, y, T, B, S, reverse,
                                               ((LB * S + 31) / 32) * 32, stream);
  });
}

// The recurrence's backward walk: gates [T, B, 3S] (z | r | hbar), h_prev
// [T, B, S], gh [T, B, S], sW [S, 2S], sW2 [S, S] -> da [T, B, 3S]; all
// fp32, contiguous, on the current device. global = 0: the weights in
// registers, S <= REG_MAX_S; global = 1: the big-S walk. rounding 0, 1 or
// 2: the forward's (none, TF32 or bfloat16 operands), the backward's
// products rounded as rounding.cuh's round_cotangent and round_result
// say. Returns a cudaError_t.
int scrappie_gru_recurrence_bwd(const float* gates, const float* h_prev,
                                const float* gh, const float* sW,
                                const float* sW2, float* da, int T, int B,
                                int S, int reverse, int global, int rounding,
                                cudaStream_t stream) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  if (!global && S > REG_MAX_S) return (int)cudaErrorInvalidValue;
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (global) {
      const size_t smem = sizeof(float) * 10 * (size_t)S;
      cudaError_t err = cudaFuncSetAttribute(
          gru_walk_global_kernel<R>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      gru_walk_global_kernel<R><<<B, 1024, smem, stream>>>(
          gates, h_prev, gh, sW, sW2, da, T, B, S, reverse);
      return (int)cudaGetLastError();
    }
    gru_recurrence_bwd_kernel<R><<<B, BW_THREADS, 0, stream>>>(
        gates, h_prev, gh, sW, sW2, da, T, B, S, reverse);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
