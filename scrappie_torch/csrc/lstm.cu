// The recurrence of the peephole-LSTM layers, over inputs projected before
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
// per gate column, the gate nonlinearities and one block barrier. The
// arithmetic, 2 S 4S flops per row and step, is far below that latency,
// but the SM must issue it: 4S S / 32 warp FMAs a step (288 cycles of
// issue at S = 96), and shared memory hands only 128 bytes a cycle to the
// registers, so every thread reading all of h would take 4S S / 32 cycles
// as well. What must not happen is to read sW from memory at every step.
//
// Design (lstm_recurrence_kernel): one block per batch row and direction,
// sW in registers, 4S threads. The four lanes of a quad hold unit u's four
// gate columns (g S + u, g = 0..3), lane l rows l QROWS .. l QROWS + QROWS
// - 1 of them (QROWS = 24; 96 registers, zero past S), so a lane reads
// only its QROWS entries of h (float4 broadcasts) and takes four partial
// dot products, two FMA chains each; a transpose-reduce over the quad (3
// shuffles) leaves gate l's sum in lane l, which adds its projected input.
// Every lane then takes one sigmoid, of 2 xf for the cell-in gate (tanh(x)
// = 2 sigmoid(2x) - 1) and of xf + c p for the input and forget gates, so
// the warp runs one path and not a tanh and a sigmoid in turn; 4 shuffles
// give each lane the unit's gates, c is updated in every lane of the quad
// (it stays in registers), and one more sigmoid path gives lane 0 the
// output gate and lane 1 tanh(c), which a shuffle hands to lane 0. Lane 0
// writes h[u] to a double-buffered h in shared memory and to y; then the
// block's single barrier. The projected input of the next RING steps is in
// flight by cp.async into a ring in shared memory, each lane copying and
// reading back its own entry, so the load needs no barrier of its own.
// Both layers of a bidirectional stage run in one launch: blockIdx.y picks
// the direction, its weights, its output and its columns of the [T, B, 8S]
// projection (forward, then backward); a single layer launches a grid of
// B. On an H100 at T = 2048 and S = 96 (B = 8 and 64) one thread a column
// reading all of h took 1.71 ms a layer, the quad with a tanh and a sigmoid
// path 1.52 ms, and this design 1.33 ms.
//
// Big-S mode (lstm_global_kernel): for S > 96 sW is read from global
// memory (it stays in L2: 1.3 MB at S = 288), the threads walk the gate
// columns j = tid, tid + blockDim, ..., and the projected input is read in
// the step that uses it; h, c and the gate values sit in shared memory, with
// two barriers a step; its gates take tanhf and sigmoid_f32 in the
// twin's order. One layer a launch, or both directions of a stage (grid
// B x 2, as the register kernel's pair), and a training mode (kTrain, the
// planes as below).
//
// Training (template kTrain): the same kernel also writes, for every step,
// the planes the backward walk reads: c, tanh(c) and the activated gates
// g = tanh(a_c), i, f, o, each a [T, B, S] array a direction, stored by
// lane 0 of each quad beside h (lane 0 holds every one of them after the
// step's shuffles); ops/lstm.py launches it only when a gradient is
// wanted, and its h is the inference launch's bit for bit. Plane m lies m
// coff floats past each direction's y, so its address is h's plus a
// multiple of a kernel parameter and takes no register of its own: a
// pointer of its own, or a store in another lane than h's, spilled (the
// kernel is at its 168 registers a thread).
//
// Backward (lstm_recurrence_bwd_kernel): the VJP of the lax.scan of
// scrappie_tpu/nn/rnn.py:80 (lstm), which has no TPU kernel: XLA
// differentiates the scan when the JAX trainer takes its gradient. Per
// step, in the reverse of the forward's order, for one row
// (ops/lstm.lstm_walk_plain is the same loop), with the forward's planes
// and the gradient gh of its output:
//
//   dh    = carry_h + gh[t]
//   dc    = carry_c + dh Bc
//   da    = [dc G | dc I | dc F | dh A]          (da_c | da_i | da_f | da_o)
//   carry_c = dc K
//   carry_h = da @ sW^T                                 (4S -> S)
//
// whose six coefficients do not depend on the carry:
//
//   A = tanh(c) o (1 - o),  Bc = o (1 - tanh(c)^2) + A p_out,
//   F = c_prev f (1 - f),   I = g i (1 - i),  G = i (1 - g^2),
//   K = f + F p_f + I p_in                            (c_prev 0 at the first)
//
// and the peephole gradient's terms, summed over steps: da_i c_prev, da_f
// c_prev and da_o c.
//
// What bounds it: as the forward, the latency of a step, whose chain is
// the product da @ sW^T (4 S^2 multiply-adds, 36 864 at S = 96) behind one
// barrier, and the SM's issue of that product and of everything else a
// step does. Design: 384 threads, each holding a 4 x 24 tile of sW^T in
// registers (4 outputs k, 24 of the 4S rows; the 16 row groups of an
// output group are half a warp), so a thread reads only its 24 entries of
// da (six float4, from a layout padded so that a warp's reads spread over
// the banks), two accumulators an output, and a reduce-scatter of
// shuffles (xor 8, 4, 2, 1) leaves output k's sum in the four lanes of a
// quad. Lane r of the quad takes gate r of unit k. The chain of a step is
// then three operations (dh, dc, lane r's da), a store to a double-buffered
// da in shared memory and the block's one barrier; everything else is off
// it, after the barrier, beside the product: the lane's da to global
// memory, the copies of a later step's inputs (the five planes at
// the step, c at the step before and gh, by 16-byte cp.async into a ring
// in shared memory BW_RING steps ahead, each thread waiting only for its
// own copies before the barrier that publishes them), and the next step's
// six coefficients, formed in registers from the ring by every lane of
// the quad. Each lane keeps its dpeep term's sum in a double and writes one
// partial a row and direction; ops/lstm.py sums the rows' partials (no
// atomics: the same result every run). sW^T's tile is read from a copy of
// sW padded to S = 96, so that its 96 loads are fixed offsets from one
// address (bounds tests on each spilled). Both directions of a stage run
// in one launch (blockIdx.y), each writing its 4S columns of a [T, B, 8S]
// da, the pair projection's layout.
//
// Big-S walk (lstm_walk_cluster_kernel, 96 < S <= 384): the register
// walk spread over a thread-block cluster a row and direction, because one
// SM's registers hold sW^T (4 S^2 weights) only up to S = 96. CTA c of
// the cluster owns the units [c S / n, (c + 1) S / n) and keeps sW's rows
// of them (sW^T's columns) in registers: a warp sums OUT units (4, or 2
// above S = 160), lane l holding their rows l ROWS .. l ROWS + ROWS - 1
// (ROWS = 4S / 32 rounded up to 4, above 20 to 8; 12 warps a CTA at the
// most; n = 4 CTAs up to S = 160, 8 up to 192, 16 above: cluster_layout).
// At most 64 or 80 of a lane's weights stay in registers (more spilled at
// the 168 registers a thread that 12 warps leave), the rest of its tile
// (4 rows a lane at S = 129-160, 24 at S = 321-384) in shared memory, read
// beside da each step. The chain of
// a step is the register walk's three operations on the carry, then each
// lane writes its da entry (rounded by round_cotangent) into the da
// buffer of its share of the cluster's CTAs by distributed shared memory
// (a unit's gate sits in 8 or 16 lanes after the reduce-scatter, which
// split the n stores), one cluster barrier (arrive.release, wait.acquire;
// da double-buffered by the step's parity, so one barrier a step orders
// both the writes and the next step's overwrite), and the product of the
// whole da by the CTA's tile, a reduce-scatter of shuffles over the warp
// (xor 16, 8, 4, 2, 1) and carry_h = round_result of it. Between the
// arrive and the wait: da to global memory and the copies of a later
// step's inputs (the CTA's units' planes and gh, 4-byte cp.async into a
// ring CL_RING steps ahead); after the wait, beside the product, the next
// step's coefficients. Rows and directions: a cluster each (grid n B x
// ndir); clusters beyond what the card holds at once run in later waves.
// dpeep: each unit's CTA writes its partial a row and direction (a double
// sum), which ops/lstm.py sums over the rows (no atomics). Above S = 384
// (lstm_walk_global_kernel, a mode chosen by S alone,
// ops/lstm.walk_mode): sW read from global memory (L2), one block of 1024
// threads a row and direction, two barriers a step: a thread a unit takes
// the step's arithmetic from the planes in global memory and keeps
// carry_c, its dpeep sums and da in shared memory; then lanes of 8 an
// output take da @ sW^T from sW's rows (contiguous).
//
// Precision (template kRound, rounding.cuh): in 'default' and 'bf16' sW
// is rounded once, where it is loaded into registers (on the integer
// bits, round_weight_bits: the training mode spilled with a cvt there;
// the big-S modes round each weight they read from L2), and h where it is
// written to
// shared memory, which only the product reads (y gets the unrounded h).
// The training forward is the same template in its training mode, so its
// h is the inference launch's bit for bit in each mode. The walks take the
// forward's kRound (nn/config.grad_rounding): sW^T rounded where it is
// loaded (or read, big-S); in 'default' (1) da rounded to TF32 where it is
// written to shared memory, which only the product reads (da in global
// memory and the dpeep sums take it unrounded); in 'bf16' (2) the
// product's result, carry_h = R(da @ sW^T), rounded to bfloat16.
#include <cuda_runtime.h>

#include <cstddef>

#include "rounding.cuh"

namespace {

constexpr int REG_MAX_S = 96;  // the largest S whose sW stays in registers
constexpr int QROWS = REG_MAX_S / 4;  // rows of sW a lane holds
constexpr int RING = 4;        // steps of projected input in flight
constexpr unsigned FULL = 0xffffffffu;

// 1 / (1 + exp(-x)); __frcp_rn gives the value __fdiv_rn(1, .) gives.
__device__ __forceinline__ float sigmoid_f32(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}

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

// One direction's operands.
struct Dir {
  const float* sW;    // [S, 4S]
  const float* peep;  // [3S]
  float* y;           // [T, B, S]
  int reverse;
};

// xproj [T, B, xcols] -> y [T, B, S] for direction blockIdx.y, whose 4S
// gate columns start at column 4S * blockIdx.y of xproj. blockDim.x = 4S
// rounded up to a warp; S <= REG_MAX_S. Shared memory: h [2][REG_MAX_S]
// (the tail past S zero), a ring of RING projected rows [RING][4S].
// kTrain: also the planes the backward walk reads, c, tanh(c) and the
// activated gates g, i, f, o of every step, plane m (1 .. 6) at d.y + m coff.
template <bool kTrain, int kRound>
__global__ void __launch_bounds__(4 * REG_MAX_S, 1)
lstm_recurrence_kernel(const float* __restrict__ xproj, int xcols, Dir d0,
                       Dir d1, int T, int B, int S, long long coff) {
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;                  // [2][REG_MAX_S]
  float* s_x = s_h + 2 * REG_MAX_S;   // [RING][4S]
  const Dir d = blockIdx.y ? d1 : d0;
  const int S4 = 4 * S;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int u = tid >> 2;   // unit
  const int g = tid & 3;    // rows g QROWS .. of the dot; then gate g
  const bool live = u < S;
  const int col = g * S + u;

  float w[4][QROWS];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < QROWS; ++i) {
      const int k = g * QROWS + i;
      w[j][i] = (live && k < S)
                    ? round_weight_bits<kRound>(__ldg(d.sW + (size_t)k * S4 + j * S + u))
                    : 0.0f;
    }
  const float p_gate =
      live && (g == 1 || g == 2) ? __ldg(d.peep + (g - 1) * S + u) : 0.0f;
  const float p_out = live ? __ldg(d.peep + 2 * S + u) : 0.0f;
  for (int k = tid; k < 2 * REG_MAX_S; k += blockDim.x) s_h[k] = 0.0f;

  const int t0 = d.reverse ? T - 1 : 0;
  const int dt = d.reverse ? -1 : 1;
  const float* xcol = xproj + (size_t)S4 * blockIdx.y + col;
  auto fetch = [&](int n) {
    if (live && n < T)
      cp_async4(s_x + (n % RING) * S4 + tid,
                xcol + ((size_t)(t0 + n * dt) * B + b) * xcols);
    cp_async_commit();
  };
  for (int n = 0; n < RING; ++n) fetch(n);
  float c = 0.0f;
  __syncthreads();

  const int quad = lane & ~3;
  const bool hi = g & 2, odd = g & 1;
  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    cp_async_wait<RING - 1>();  // this thread's copy of step n
    const float xcur = live ? s_x[(n % RING) * S4 + tid] : 0.0f;
    const float4* h4 =
        reinterpret_cast<const float4*>(s_h + (n & 1) * REG_MAX_S + g * QROWS);
    float p[4], p2[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = p2[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < QROWS / 4; ++i) {
      const float4 v = h4[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = fmaf(v.x, w[j][4 * i], p[j]);
        p2[j] = fmaf(v.y, w[j][4 * i + 1], p2[j]);
        p[j] = fmaf(v.z, w[j][4 * i + 2], p[j]);
        p2[j] = fmaf(v.w, w[j][4 * i + 3], p2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __fadd_rn(p[j], p2[j]);
    // Lanes with g & 2 keep gates 2, 3, the others 0, 1; then g & 1 picks.
    const float s0 = __shfl_xor_sync(FULL, hi ? p[0] : p[2], 2);
    const float s1 = __shfl_xor_sync(FULL, hi ? p[1] : p[3], 2);
    const float q0 = __fadd_rn(hi ? p[2] : p[0], s0);
    const float q1 = __fadd_rn(hi ? p[3] : p[1], s1);
    const float r = __shfl_xor_sync(FULL, odd ? q0 : q1, 1);
    const float xf = __fadd_rn(xcur, __fadd_rn(odd ? q1 : q0, r));
    // One sigmoid path for every lane: tanh(x) = 2 sigmoid(2x) - 1 for
    // the cell-in gate; the output gate keeps xf for the new c.
    const float sg = sigmoid_f32(g == 0 ? __fmul_rn(2.0f, xf)
                                        : __fadd_rn(xf, __fmul_rn(c, p_gate)));
    const float a = g == 0 ? fmaf(2.0f, sg, -1.0f) : g == 3 ? xf : sg;
    const float cell = __shfl_sync(FULL, a, quad);
    const float in = __shfl_sync(FULL, a, quad + 1);
    const float forget = __shfl_sync(FULL, a, quad + 2);
    const float xo = __shfl_sync(FULL, a, quad + 3);
    c = __fadd_rn(__fmul_rn(forget, c), __fmul_rn(in, cell));
    // Lane 0 the output gate, lane 1 tanh(c), on one sigmoid path.
    const float so = sigmoid_f32(g == 0 ? __fadd_rn(xo, __fmul_rn(c, p_out))
                                        : __fmul_rn(2.0f, c));
    const float tc = fmaf(2.0f, __shfl_sync(FULL, so, quad + 1), -1.0f);
    if (g == 0 && live) {
      const float h = __fmul_rn(so, tc);
      s_h[((n + 1) & 1) * REG_MAX_S + u] = round_operand<kRound>(h);
      float* yt = d.y + ((size_t)t * B + b) * S + u;
      *yt = h;
      if (kTrain) {
        yt[coff] = c;
        yt[2 * coff] = tc;
        yt[3 * coff] = cell;
        yt[4 * coff] = in;
        yt[5 * coff] = forget;
        yt[6 * coff] = so;
      }
    }
    fetch(n + RING);  // refill the slot read above
    __syncthreads();
  }
}

// Gate column j's peephole weight (0 for the cell-in and output gates).
__device__ __forceinline__ float gate_peep(const float* __restrict__ peep,
                                           int S, int j) {
  const int gate = j / S;
  return (gate == 1 || gate == 2) ? __ldg(peep + (gate - 1) * S + j - gate * S)
                                  : 0.0f;
}

// Big-S mode: gate column j's value for this step, sW read from global
// memory (each weight rounded as it is read).
template <int kRound>
__device__ __forceinline__ float global_gate(const float* __restrict__ sW,
                                             const float* s_h, const float* s_c,
                                             float p_gate, float xcur, int S,
                                             int j) {
  const int S4 = 4 * S;
  const int gate = j / S;
  const int u = j - gate * S;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int k = 0;
#pragma unroll 4
  for (; k + 4 <= S; k += 4) {
    a0 = fmaf(s_h[k], round_weight<kRound>(__ldg(sW + (size_t)k * S4 + j)), a0);
    a1 = fmaf(s_h[k + 1],
              round_weight<kRound>(__ldg(sW + (size_t)(k + 1) * S4 + j)), a1);
    a2 = fmaf(s_h[k + 2],
              round_weight<kRound>(__ldg(sW + (size_t)(k + 2) * S4 + j)), a2);
    a3 = fmaf(s_h[k + 3],
              round_weight<kRound>(__ldg(sW + (size_t)(k + 3) * S4 + j)), a3);
  }
  for (; k < S; ++k)
    a0 = fmaf(s_h[k], round_weight<kRound>(__ldg(sW + (size_t)k * S4 + j)), a0);
  const float xf = __fadd_rn(xcur, __fadd_rn(__fadd_rn(a0, a1),
                                             __fadd_rn(a2, a3)));
  if (gate == 0) return tanhf(xf);
  if (gate == 3) return xf;  // the output gate waits for the new c
  return sigmoid_f32(__fadd_rn(xf, __fmul_rn(s_c[u], p_gate)));
}

// Big-S mode: xproj [T, B, xcols] -> y [T, B, S] for direction blockIdx.y,
// whose 4S gate columns start at column 4S * blockIdx.y; kTrain: also c
// and the four activated gates, planes 1 .. 5 at d.y + m coff. Shared
// memory: h [S] (rounded in kRound), c [S], the gate values [4S].
template <bool kTrain, int kRound>
__global__ void __launch_bounds__(1024)
lstm_global_kernel(const float* __restrict__ xproj, int xcols, Dir d0,
                   Dir d1, int T, int B, int S, long long coff) {
  extern __shared__ float smem[];
  const Dir d = blockIdx.y ? d1 : d0;
  const float* __restrict__ sW = d.sW;
  const float* __restrict__ peep = d.peep;
  float* __restrict__ y = d.y;
  const int reverse = d.reverse;
  const int S4 = 4 * S;
  float* s_h = smem;     // [S]
  float* s_c = s_h + S;  // [S]
  float* s_g = s_c + S;  // [4S] gate values of this step
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int u = tid; u < S; u += blockDim.x) {
    s_h[u] = 0.0f;
    s_c[u] = 0.0f;
  }
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = t0 + n * dt;
    const float* xrow =
        xproj + ((size_t)t * B + b) * xcols + (size_t)S4 * blockIdx.y;
    for (int j = tid; j < S4; j += blockDim.x)
      s_g[j] = global_gate<kRound>(sW, s_h, s_c, gate_peep(peep, S, j), xrow[j],
                                   S, j);
    __syncthreads();

    for (int u = tid; u < S; u += blockDim.x) {
      const float p_out = __ldg(peep + 2 * S + u);
      const float c_new = __fadd_rn(__fmul_rn(s_g[2 * S + u], s_c[u]),
                                    __fmul_rn(s_g[S + u], s_g[u]));
      const float o = sigmoid_f32(__fadd_rn(s_g[3 * S + u],
                                            __fmul_rn(c_new, p_out)));
      const float tc = tanhf(c_new);
      const float h = __fmul_rn(o, tc);
      s_c[u] = c_new;
      s_h[u] = round_operand<kRound>(h);
      float* yt = y + ((size_t)t * B + b) * S + u;
      *yt = h;
      if (kTrain) {
        yt[coff] = c_new;
        yt[2 * coff] = tc;
        yt[3 * coff] = s_g[u];
        yt[4 * coff] = s_g[S + u];
        yt[5 * coff] = s_g[2 * S + u];
        yt[6 * coff] = o;
      }
    }
    __syncthreads();
  }
}

// The register kernel over ndir directions (grid B x ndir).
template <bool kTrain, int kRound = 0>
int launch_registers(const float* xproj, int xcols, Dir d0, Dir d1, int ndir,
                     int T, int B, int S, cudaStream_t stream,
                     long long coff = 0) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  if (S < 1 || S > REG_MAX_S) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * REG_MAX_S + (size_t)RING * 4 * S);
  const int threads = (4 * S + 31) / 32 * 32;
  lstm_recurrence_kernel<kTrain, kRound><<<dim3(B, ndir), threads, smem, stream>>>(
      xproj, xcols, d0, d1, T, B, S, coff);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

constexpr int BW_OUT = 4;                          // outputs a thread
constexpr int BW_ROWS = 24;                        // rows of da a thread
constexpr int BW_GROUP = 4 * REG_MAX_S / BW_ROWS;  // lanes of an output group
constexpr int BW_THREADS = REG_MAX_S / BW_OUT * BW_GROUP;
constexpr int BW_RING = 4;                         // steps in the inputs' ring
constexpr int BW_PLANE = REG_MAX_S + 8;            // a ring plane, padded
constexpr int BW_UNROLL = 2;                       // steps a loop iteration
// da in shared memory: row j (gate j / 96's unit j % 96) at j + 4 (j / 24),
// so that the float4 reads of a warp's 16 row groups (24 rows each) fall
// in 8 bank groups (2 wavefronts) and not 4 (4 wavefronts)
constexpr int BW_DA = 4 * REG_MAX_S + 4 * (4 * REG_MAX_S / BW_ROWS);
__device__ constexpr int da_at(int j) { return j + 4 * (j / BW_ROWS); }
static_assert(BW_GROUP == 16, "the reduce-scatter's xor 8, 4, 2, 1");
static_assert(BW_THREADS == 384, "a 4 x 24 tile of sW^T a thread");
static_assert((BW_RING & (BW_RING - 1)) == 0 && BW_RING >= 3, "the ring");

// cp.async.wait_group with a compiler barrier for memory, so that no read
// of a ring slot moves across the wait and no copy into a slot moves above
// the reads of its old values.
template <int N>
__device__ __forceinline__ void cp_async_wait_mem() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One direction's operands of the backward walk.
struct BwdDir {
  const float* c;      // [T, B, S]; the forward's next planes at c + m poff
  const float* gh;     // [T, B, S]
  const float* sW;     // [S, 4S]
  const float* peep;   // [3S]
  int reverse;         // the forward's direction
};

// The 4 outputs' partial sums of the 16 lanes of a group -> the whole sum
// of output q >> 2 (q the lane in the group) in the four lanes of its quad.
__device__ __forceinline__ float reduce_scatter16(const float (&p)[BW_OUT],
                                                  int q) {
  const bool hi = q & 8;
  const float s0 = __fadd_rn(hi ? p[2] : p[0],
                             __shfl_xor_sync(FULL, hi ? p[0] : p[2], 8));
  const float s1 = __fadd_rn(hi ? p[3] : p[1],
                             __shfl_xor_sync(FULL, hi ? p[1] : p[3], 8));
  const bool mid = q & 4;
  float t = __fadd_rn(mid ? s1 : s0, __shfl_xor_sync(FULL, mid ? s0 : s1, 4));
  t = __fadd_rn(t, __shfl_xor_sync(FULL, t, 2));
  return __fadd_rn(t, __shfl_xor_sync(FULL, t, 1));
}

// The walk step's six coefficients (csrc header), from the forward's
// tanh(c) and activated gates g, i, f, o at the step and its c_prev.
struct LstmCoef {
  float G, I, F, A, Bc, K;
};

__device__ __forceinline__ LstmCoef lstm_coef(float tc, float g, float i,
                                              float f, float o, float cp,
                                              float p_in, float p_f,
                                              float p_out) {
  LstmCoef k;
  k.G = i * (1.0f - g * g);
  k.I = g * i * (1.0f - i);
  k.F = cp * f * (1.0f - f);
  k.A = tc * o * (1.0f - o);
  k.Bc = o * (1.0f - tc * tc) + k.A * p_out;
  k.K = f + k.F * p_f + k.I * p_in;
  return k;
}

// What the chain of a walk step needs in one lane (gate r of unit k): gh,
// Bc, K, its gate's coefficient x (G, I, F or A for r = 0 .. 3) and the
// factor of its dpeep term pc (c_prev for r = 1, 2; c for r = 3; 0 for 0).
struct WalkStep {
  float gh, bc, kk, x, pc;
};

// cp.async of VEC (4 or 1) floats, zero-filled when nbytes = 0; with
// cp_async_wait_mem, a compiler barrier for memory.
template <int VEC>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src,
                                             int nbytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(nbytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(nbytes)
                 : "memory");
}

// The forward's planes of direction blockIdx.y (c at d.c, then tanh(c)
// and the gates g, i, f, o, poff floats apart) and gh -> its 4S columns of
// da [T, B, dcols] (column 4S blockIdx.y on) and its dpeep partials,
// [ndir, B, 3S] (this row's sums over time of da_i c_prev, da_f c_prev
// and da_o c). blockDim.x = BW_THREADS; S <= REG_MAX_S; d.sW padded to
// [REG_MAX_S, 4, REG_MAX_S] with zeros (sW itself at S = REG_MAX_S). A
// step's plane rows come by cp.async copies of VEC floats: 4 where S and
// poff are multiples of 4 and the planes and gh 16-byte aligned, else 1.
template <int VEC, int kRound>
__global__ void __launch_bounds__(BW_THREADS, 1)
lstm_recurrence_bwd_kernel(BwdDir d0, BwdDir d1, long long poff,
                           float* __restrict__ da, int dcols,
                           float* __restrict__ dpeep, int T, int B, int S) {
  constexpr int NG = 5;       // planes tanh(c), g, i, f, o
  constexpr int NP = NG + 2;  // and c at the walk's next step, gh
  __shared__ __align__(16) float s_da[2][BW_DA];  // row j at j + 4 (j / 24)
  __shared__ __align__(16) float s_in[BW_RING][NP][BW_PLANE];  // the ring
  __shared__ float s_peep[3][REG_MAX_S];  // not in registers: they spilled
  const BwdDir d = blockIdx.y ? d1 : d0;
  const int S4 = 4 * S;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int q = tid % BW_GROUP;            // rows 24q .. 24q + 23 of da
  const int k0 = tid / BW_GROUP * BW_OUT;  // the group's outputs k0 .. k0 + 3
  const int k = k0 + (q >> 2);             // the unit this lane ends with
  const int r = q & 3;                     // the gate it writes
  const bool live = k < S;
  const int kc = min(k, S - 1);
  // sW^T's tile (rows k0 .. k0 + 3 of sW, its padded columns 24q ..
  // 24q + 23): fixed offsets from one address, no bounds to test
  float w[BW_OUT][BW_ROWS];
  const float* wtile = d.sW + (size_t)k0 * 4 * REG_MAX_S + q * BW_ROWS;
#pragma unroll
  for (int i = 0; i < BW_OUT; ++i)
#pragma unroll
    for (int jj = 0; jj < BW_ROWS; ++jj)
      w[i][jj] = round_weight<kRound>(__ldg(wtile + i * 4 * REG_MAX_S + jj));
  for (int i = tid; i < 2 * BW_DA; i += BW_THREADS)
    (&s_da[0][0])[i] = 0.0f;
  for (int i = tid; i < 3 * REG_MAX_S; i += BW_THREADS) {
    const int g = i / REG_MAX_S, u = i % REG_MAX_S;
    s_peep[g][u] = u < S ? __ldg(d.peep + g * S + u) : 0.0f;
  }
  // Walk step n is the forward's step t = reverse ? n : T-1-n; the
  // forward's step before it, t + ws, is the walk's next step.
  const int ws = d.reverse ? 1 : -1;
  const int t0 = d.reverse ? 0 : T - 1;
  // This thread's copies of a step, at most NE: copy e = tid + i
  // BW_THREADS is plane e / (S / VEC)'s floats VEC (e % (S / VEC)) on, its
  // source at the forward's step 0 and its slot offset (-1: none). Plane
  // p < NG is the forward's plane p + 1 past c, NG c at the walk's next
  // step (zero-filled at the walk's last, the forward's first), NG + 1 gh.
  constexpr int NE = (NP * REG_MAX_S / VEC + BW_THREADS - 1) / BW_THREADS;
  const float* src[NE];
  int dst[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int e = tid + i * BW_THREADS, sv = S / VEC;
    const int p = e / sv, unit = e % sv * VEC;
    dst[i] = e < NP * sv ? p * BW_PLANE + unit : -1;
    src[i] = (p < NG ? d.c + (p + 1) * poff : p == NG ? d.c : d.gh) +
             (p == NG ? (ptrdiff_t)ws * B * S : 0) + (size_t)b * S + unit;
  }
  // Copies step n's inputs into its ring slot (none past the walk's end).
  auto fetch = [&](int n) {
    float* slot = &s_in[n & (BW_RING - 1)][0][0];
    const ptrdiff_t row = (ptrdiff_t)(t0 + ws * n) * B * S;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      if (dst[i] >= 0 && n < T) {
        const bool none = n == T - 1 && dst[i] >= NG * BW_PLANE &&
                          dst[i] < (NG + 1) * BW_PLANE;
        cp_async_vec<VEC>(slot + dst[i], src[i] + (none ? 0 : row),
                          none ? 0 : 4 * VEC);
      }
    }
    cp_async_commit();
  };
  // Step n's chain inputs from the ring (its copies waited for), c the
  // forward's c at step n.
  auto coefficients = [&](int n, float c) -> WalkStep {
    const float* in = &s_in[n & (BW_RING - 1)][0][0] + kc;
    const float cp = in[NG * BW_PLANE];
    const LstmCoef co =
        lstm_coef(in[0], in[BW_PLANE], in[2 * BW_PLANE], in[3 * BW_PLANE],
                  in[4 * BW_PLANE], cp, s_peep[0][kc], s_peep[1][kc],
                  s_peep[2][kc]);
    WalkStep s;
    s.gh = in[(NG + 1) * BW_PLANE];
    s.x = r == 0 ? co.G : r == 1 ? co.I : r == 2 ? co.F : co.A;
    s.bc = co.Bc;
    s.kk = co.K;
    s.pc = r == 0 ? 0.0f : r == 3 ? c : cp;
    return s;
  };
#pragma unroll
  for (int n = 0; n < BW_RING - 1; ++n) fetch(n);
  cp_async_wait_mem<BW_RING - 2>();  // step 0's copies
  __syncthreads();  // and the zeros, before any step's writes
  WalkStep cur = coefficients(0, __ldg(d.c + ((size_t)t0 * B + b) * S + kc));
  float c_now = s_in[0][NG][kc];  // c at the walk's next step
  float carry_h = 0.0f, carry_c = 0.0f;
  double dp = 0.0;
  float* dout = da + (size_t)S4 * blockIdx.y + ((size_t)t0 * B + b) * dcols +
                r * S + kc;
#pragma unroll 1
  for (int n0 = 0; n0 < T; n0 += BW_UNROLL) {
#pragma unroll
    for (int u = 0; u < BW_UNROLL; ++u) {
      const int n = n0 + u;
      if (n >= T) break;  // uniform across the block
      const float dh = __fadd_rn(carry_h, cur.gh);
      const float dc = fmaf(dh, cur.bc, carry_c);
      const float mine = __fmul_rn(r == 3 ? dh : dc, cur.x);
      float* buf = s_da[u & 1];
      if (live) buf[da_at(r * REG_MAX_S + k)] = round_cotangent<kRound>(mine);
      carry_c = __fmul_rn(dc, cur.kk);
      dp = fma((double)mine, (double)cur.pc, dp);
      cp_async_wait_mem<BW_RING - 3>();  // this thread's copies of n + 1
      __syncthreads();
      fetch(n + BW_RING - 1);  // into the slot of step n - 1
      if (live) *dout = mine;
      dout += (ptrdiff_t)ws * B * dcols;
      float p[BW_OUT], p2[BW_OUT];
#pragma unroll
      for (int i = 0; i < BW_OUT; ++i) p[i] = p2[i] = 0.0f;
      const float4* v4 =
          reinterpret_cast<const float4*>(buf + da_at(q * BW_ROWS));
#pragma unroll
      for (int cc = 0; cc < BW_ROWS / 4; ++cc) {
        const float4 v = v4[cc];
#pragma unroll
        for (int i = 0; i < BW_OUT; ++i) {
          p[i] = fmaf(v.x, w[i][4 * cc], p[i]);
          p2[i] = fmaf(v.y, w[i][4 * cc + 1], p2[i]);
          p[i] = fmaf(v.z, w[i][4 * cc + 2], p[i]);
          p2[i] = fmaf(v.w, w[i][4 * cc + 3], p2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < BW_OUT; ++i) p[i] = __fadd_rn(p[i], p2[i]);
      // (past the walk's end from a stale slot, and unused)
      cur = coefficients(n + 1, c_now);
      c_now = s_in[(n + 1) & (BW_RING - 1)][NG][kc];
      carry_h = round_result<kRound>(reduce_scatter16(p, q));
    }
  }
  cp_async_wait_mem<0>();
  if (live && r > 0)
    dpeep[((size_t)blockIdx.y * B + b) * 3 * S + (r - 1) * S + k] = (float)dp;
}

constexpr int WGL = 8;  // lanes of an output in the big-S walk

// As lstm_recurrence_bwd_kernel (the gates' planes), sW read from global
// memory; any S (shared memory: 9S floats: carry_h [S], carry_c [S], the
// dpeep sums [3S], da [4S]).
template <int kRound>
__global__ void __launch_bounds__(1024)
lstm_walk_global_kernel(BwdDir d0, BwdDir d1, long long poff,
                        float* __restrict__ da, int dcols,
                        float* __restrict__ dpeep, int T, int B, int S) {
  extern __shared__ float sm[];
  const BwdDir d = blockIdx.y ? d1 : d0;
  const int S4 = 4 * S;
  float* s_ch = sm;
  float* s_cc = s_ch + S;
  float* s_dp = s_cc + S;
  float* s_da = s_dp + 3 * S;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int la = tid % WGL, ngroup = nt / WGL;
  float* dcol = da + (size_t)S4 * blockIdx.y;
  for (int u = tid; u < S; u += nt) {
    s_ch[u] = 0.0f;
    s_cc[u] = 0.0f;
    s_dp[u] = s_dp[S + u] = s_dp[2 * S + u] = 0.0f;
  }
  __syncthreads();
  for (int n = 0; n < T; ++n) {
    const int t = d.reverse ? n : T - 1 - n;
    const int tp = d.reverse ? t + 1 : t - 1;  // the forward's step before
    const bool has = tp >= 0 && tp < T;
    const size_t row = (size_t)t * B + b;
    for (int u = tid; u < S; u += nt) {
      const float* pl = d.c + row * S + u;
      const float c = pl[0];
      const float cp = has ? d.c[((size_t)tp * B + b) * S + u] : 0.0f;
      const LstmCoef k = lstm_coef(
          pl[poff], pl[2 * poff], pl[3 * poff], pl[4 * poff], pl[5 * poff], cp,
          __ldg(d.peep + u), __ldg(d.peep + S + u), __ldg(d.peep + 2 * S + u));
      const float dh = __fadd_rn(s_ch[u], d.gh[row * S + u]);
      const float dc = fmaf(dh, k.Bc, s_cc[u]);
      const float a[4] = {__fmul_rn(dc, k.G), __fmul_rn(dc, k.I),
                          __fmul_rn(dc, k.F), __fmul_rn(dh, k.A)};
      s_cc[u] = __fmul_rn(dc, k.K);
      s_dp[u] = fmaf(a[1], cp, s_dp[u]);
      s_dp[S + u] = fmaf(a[2], cp, s_dp[S + u]);
      s_dp[2 * S + u] = fmaf(a[3], c, s_dp[2 * S + u]);
      float* out = dcol + row * dcols;
      for (int r = 0; r < 4; ++r) {
        s_da[r * S + u] = round_cotangent<kRound>(a[r]);
        out[r * S + u] = a[r];
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < S; k0 += ngroup) {
      const int k = k0 + tid / WGL;
      float a0 = 0.0f, a1 = 0.0f;
      if (k < S) {
        const float* wrow = d.sW + (size_t)k * S4;
        int j = la;
        for (; j + WGL < S4; j += 2 * WGL) {
          a0 = fmaf(s_da[j], round_weight<kRound>(__ldg(wrow + j)), a0);
          a1 = fmaf(s_da[j + WGL], round_weight<kRound>(__ldg(wrow + j + WGL)),
                    a1);
        }
        if (j < S4)
          a0 = fmaf(s_da[j], round_weight<kRound>(__ldg(wrow + j)), a0);
      }
      float v = __fadd_rn(a0, a1);
#pragma unroll
      for (int o = WGL / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (k < S && la == 0) s_ch[k] = round_result<kRound>(v);
    }
    __syncthreads();
  }
  for (int u = tid; u < S; u += nt)
    for (int r = 0; r < 3; ++r)
      dpeep[((size_t)blockIdx.y * B + b) * 3 * S + r * S + u] =
          s_dp[r * S + u];
}

// ------------------------------------------------------------ cluster walk

constexpr int CL_MAX_WARPS = 12;    // warps of a CTA
constexpr int CL_MAX_CTAS = 16;     // CTAs of a cluster (16: non-portable)
constexpr int CL_MAX_ROWS = 48;     // rows of da a lane (S up to 384)
constexpr int CL_RING = 4;          // steps in the inputs' ring
constexpr int CL_PLANES = 7;        // tanh(c), g, i, f, o, c at the next step, gh
constexpr int CL_MAX_UNITS = 4 * CL_MAX_WARPS;  // units a CTA owns, at most
constexpr int CL_MAX_PEERS = 4;     // CTAs a lane writes its da entry to
static_assert((CL_RING & (CL_RING - 1)) == 0 && CL_RING >= 3, "the ring");

// Outputs (units) a warp sums: 4 while a lane's rows of da are at most 20,
// else 2. A lane's tile of sW^T (OUT x ROWS) stays in registers up to 64
// weights (4 units) or 80 (2 units); a larger tile keeps 16 rows (4 units)
// or 24 (2 units) there and the rest in shared memory (more spilled at the
// kernel's 168 registers a thread, which also hold a lane's da loads).
template <int ROWS>
__host__ __device__ constexpr int cl_out() {
  return ROWS <= 20 ? 4 : 2;
}

template <int ROWS>
__host__ __device__ constexpr int cl_reg_rows() {
  return ROWS * cl_out<ROWS>() <= (cl_out<ROWS>() == 4 ? 64 : 80)
             ? ROWS
             : (cl_out<ROWS>() == 4 ? 16 : 24);
}

// The cluster walk's layout of size S (ops/lstm.walk_cluster_layout): rows
// of da a lane (4S over the warp's 32 lanes, rounded up to 4 up to 20,
// else to 8), the cluster's CTAs (the fewest that keep a CTA's units
// within CL_MAX_WARPS warps) and a CTA's warps. False above CL_MAX_ROWS
// rows.
bool cluster_layout(int S, int& ncta, int& warps, int& rows) {
  rows = (4 * S + 31) / 32;
  rows = rows <= 20 ? (rows + 3) / 4 * 4 : (rows + 7) / 8 * 8;
  if (rows > CL_MAX_ROWS) return false;
  const int out = rows <= 20 ? 4 : 2;
  for (ncta = 2; ncta <= CL_MAX_CTAS; ncta *= 2) {
    const int units = (S + ncta - 1) / ncta;
    warps = (units + out - 1) / out;
    if (warps <= CL_MAX_WARPS) return true;
  }
  return false;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// A shared-memory address of this CTA -> the same address in CTA `rank`
// of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The big-S walk on a cluster of ncta CTAs a row and direction (grid ncta
// B x ndir; cluster_layout): CTA c owns the units [c S / ncta, (c + 1) S /
// ncta) and holds sW's rows of them (sW^T's columns) in registers, a warp
// OUT units, lane l of the warp rows l ROWS .. l ROWS + ROWS - 1 of sW^T
// (zero past 4S), so a warp's reduce-scatter leaves unit o's carry_h in
// its 32 / OUT lanes o 32 / OUT .., of which lane r (mod 4) takes gate r.
// Each step a lane writes its da entry into the da buffers of its share
// of the cluster's CTAs (distributed shared memory, double-buffered by the
// step's parity), then one cluster barrier; the product reads the whole
// da from its own CTA's buffer. The planes and gh of the CTA's units come
// by 4-byte cp.async into a ring CL_RING steps ahead. dpeep: a partial a
// unit, row and direction, written once by the unit's CTA.
template <int ROWS, int kRound>
__global__ void __launch_bounds__(32 * CL_MAX_WARPS, 1)
lstm_walk_cluster_kernel(BwdDir d0, BwdDir d1, long long poff,
                         float* __restrict__ da, int dcols,
                         float* __restrict__ dpeep, int T, int B, int S,
                         int ncta) {
  constexpr int OUT = cl_out<ROWS>();
  constexpr int RR = cl_reg_rows<ROWS>();  // rows of the tile in registers
  constexpr int SR = ROWS - RR;            // and in shared memory
  constexpr int LPO = 32 / OUT;     // lanes an output's sum ends in
  constexpr int COPIES = LPO / 4;   // lanes holding each gate of a unit
  constexpr int DA = 32 * (ROWS + 4);  // a da buffer: row j at da_at(j)
  constexpr int NG = 5;             // planes tanh(c), g, i, f, o
  __shared__ __align__(16) float s_da[2][DA];
  __shared__ __align__(16) float s_in[CL_RING][CL_PLANES][CL_MAX_UNITS];
  // dynamic: the tile's rows past RR, float4 c of output o of thread t at
  // (c OUT + o) blockDim.x + t
  extern __shared__ float4 s_w[];
  // da row j (gate j / S of unit j % S) at j + 4 (j / ROWS): a lane's ROWS
  // rows are contiguous and the lanes' float4 reads fall in 8 bank groups
  auto da_at = [](int j) { return j + 4 * (j / ROWS); };
  const BwdDir d = blockIdx.y ? d1 : d0;
  const int S4 = 4 * S;
  const int rank = (int)cluster_rank();
  const int b = blockIdx.x / ncta;
  const int first = rank * S / ncta;
  const int units = (rank + 1) * S / ncta - first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = warp * OUT + lane / LPO;  // the unit this lane ends with
  const int r = lane & 3;                 // the gate it writes
  const int copy = (lane % LPO) >> 2;     // which of the unit's COPIES
  const bool live = u < units;
  const int uc = min(u, units - 1);
  const int k = first + uc;
  // sW^T's tile: sW's rows of the warp's units, columns lane ROWS ..
  float w[OUT][RR];
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int ku = warp * OUT + o;
    const bool ok = ku < units;
    const float* row = d.sW + (size_t)(first + (ok ? ku : 0)) * S4 + lane * ROWS;
    auto weight = [&](int i) {
      return ok && lane * ROWS + i < S4 ? round_weight<kRound>(__ldg(row + i))
                                        : 0.0f;
    };
#pragma unroll
    for (int i = 0; i < RR; ++i) w[o][i] = weight(i);
#pragma unroll 1
    for (int c = 0; c < SR / 4; ++c)
      s_w[(c * OUT + o) * blockDim.x + tid] =
          make_float4(weight(RR + 4 * c), weight(RR + 4 * c + 1),
                      weight(RR + 4 * c + 2), weight(RR + 4 * c + 3));
  }
  for (int i = tid; i < 2 * DA; i += blockDim.x) (&s_da[0][0])[i] = 0.0f;
  const float p_in = __ldg(d.peep + k);
  const float p_f = __ldg(d.peep + S + k);
  const float p_out = __ldg(d.peep + 2 * S + k);
  // Walk step n is the forward's step t = reverse ? n : T-1-n; the
  // forward's step before it, t + ws, is the walk's next step.
  const int ws = d.reverse ? 1 : -1;
  const int t0 = d.reverse ? 0 : T - 1;
  // This thread's copy of a step: plane p of unit e % units (e = tid), p <
  // NG the forward's plane p + 1 past c, NG c at the walk's next step
  // (zero-filled at the walk's last), NG + 1 gh.
  const int cp_plane = tid / units, cp_unit = tid % units;
  const bool copies = tid < CL_PLANES * units;
  const float* src =
      (cp_plane < NG ? d.c + (cp_plane + 1) * poff
                     : cp_plane == NG ? d.c + (ptrdiff_t)ws * B * S : d.gh) +
      (size_t)b * S + first + cp_unit;
  auto fetch = [&](int n) {
    if (copies && n < T) {
      const bool none = n == T - 1 && cp_plane == NG;
      cp_async_vec<1>(&s_in[n & (CL_RING - 1)][cp_plane][cp_unit],
                      src + (none ? 0 : (ptrdiff_t)(t0 + ws * n) * B * S),
                      none ? 0 : 4);
    }
    cp_async_commit();
  };
  auto coefficients = [&](int n, float c) -> WalkStep {
    const float(*in)[CL_MAX_UNITS] = s_in[n & (CL_RING - 1)];
    const float cp = in[NG][uc];
    const LstmCoef co = lstm_coef(in[0][uc], in[1][uc], in[2][uc], in[3][uc],
                                  in[4][uc], cp, p_in, p_f, p_out);
    WalkStep st;
    st.gh = in[NG + 1][uc];
    st.x = r == 0 ? co.G : r == 1 ? co.I : r == 2 ? co.F : co.A;
    st.bc = co.Bc;
    st.kk = co.K;
    st.pc = r == 0 ? 0.0f : r == 3 ? c : cp;
    return st;
  };
  // this lane's da entry in the CTAs it writes: ranks copy, copy + COPIES, ..
  const unsigned mine_at =
      (unsigned)__cvta_generic_to_shared(&s_da[0][0]) + 4u * da_at(r * S + k);
  unsigned peer[CL_MAX_PEERS];
#pragma unroll
  for (int q = 0; q < CL_MAX_PEERS; ++q) {
    const int p = copy + q * COPIES;
    peer[q] = p < ncta ? map_rank(mine_at, p) : 0u;
  }
#pragma unroll
  for (int n = 0; n < CL_RING - 1; ++n) fetch(n);
  cp_async_wait_mem<CL_RING - 2>();  // step 0's copies
  cluster_arrive();  // and every CTA's zeros, before any peer writes them
  cluster_wait();
  WalkStep cur = coefficients(0, __ldg(d.c + ((size_t)t0 * B + b) * S + k));
  float c_now = s_in[0][NG][uc];  // c at the walk's next step
  float carry_h = 0.0f, carry_c = 0.0f;
  double dp = 0.0;
  float* dout = da + (size_t)S4 * blockIdx.y + ((size_t)t0 * B + b) * dcols +
                r * S + k;
  const float4* v4 = reinterpret_cast<const float4*>(&s_da[0][da_at(lane * ROWS)]);
#pragma unroll 1
  for (int n = 0; n < T; ++n) {
    const int par = n & 1;
    const float dh = __fadd_rn(carry_h, cur.gh);
    const float dc = fmaf(dh, cur.bc, carry_c);
    const float mine = __fmul_rn(r == 3 ? dh : dc, cur.x);
    if (live) {
      const float v = round_cotangent<kRound>(mine);
#pragma unroll
      for (int q = 0; q < CL_MAX_PEERS; ++q)
        if (copy + q * COPIES < ncta) st_cluster(peer[q] + 4u * DA * par, v);
    }
    carry_c = __fmul_rn(dc, cur.kk);
    dp = fma((double)mine, (double)cur.pc, dp);
    cp_async_wait_mem<CL_RING - 3>();  // this thread's copies of n + 1
    cluster_arrive();
    if (live && copy == 0) *dout = mine;
    dout += (ptrdiff_t)ws * B * dcols;
    fetch(n + CL_RING - 1);  // into the slot of step n - 1
    cluster_wait();
    float p[OUT], p2[OUT];
#pragma unroll
    for (int o = 0; o < OUT; ++o) p[o] = p2[o] = 0.0f;
    const float4* vb = v4 + par * (DA / 4);
#pragma unroll
    for (int cc = 0; cc < RR / 4; ++cc) {
      const float4 v = vb[cc];
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        p[o] = fmaf(v.x, w[o][4 * cc], p[o]);
        p2[o] = fmaf(v.y, w[o][4 * cc + 1], p2[o]);
        p[o] = fmaf(v.z, w[o][4 * cc + 2], p[o]);
        p2[o] = fmaf(v.w, w[o][4 * cc + 3], p2[o]);
      }
    }
    // (one float4 of da and OUT of the tile at a time: unrolled, their
    // loads all went ahead of the FMAs and spilled)
#pragma unroll 1
    for (int cc = 0; cc < SR / 4; ++cc) {
      const float4 v = vb[RR / 4 + cc];
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        const float4 x = s_w[(cc * OUT + o) * blockDim.x + tid];
        p[o] = fmaf(v.x, x.x, p[o]);
        p2[o] = fmaf(v.y, x.y, p2[o]);
        p[o] = fmaf(v.z, x.z, p[o]);
        p2[o] = fmaf(v.w, x.w, p2[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < OUT; ++o) p[o] = __fadd_rn(p[o], p2[o]);
    // the reduce-scatter: output lane / LPO's sum in its LPO lanes
    float t;
    if constexpr (OUT == 4) {
      const bool h16 = lane & 16, h8 = lane & 8;
      const float s0 = __fadd_rn(h16 ? p[2] : p[0],
                                 __shfl_xor_sync(FULL, h16 ? p[0] : p[2], 16));
      const float s1 = __fadd_rn(h16 ? p[3] : p[1],
                                 __shfl_xor_sync(FULL, h16 ? p[1] : p[3], 16));
      t = __fadd_rn(h8 ? s1 : s0, __shfl_xor_sync(FULL, h8 ? s0 : s1, 8));
    } else {
      const bool h16 = lane & 16;
      t = __fadd_rn(h16 ? p[1] : p[0], __shfl_xor_sync(FULL, h16 ? p[0] : p[1], 16));
      t = __fadd_rn(t, __shfl_xor_sync(FULL, t, 8));
    }
    t = __fadd_rn(t, __shfl_xor_sync(FULL, t, 4));
    t = __fadd_rn(t, __shfl_xor_sync(FULL, t, 2));
    t = __fadd_rn(t, __shfl_xor_sync(FULL, t, 1));
    // (past the walk's end from a stale slot, and unused)
    cur = coefficients(n + 1, c_now);
    c_now = s_in[(n + 1) & (CL_RING - 1)][NG][uc];
    carry_h = round_result<kRound>(t);
  }
  cp_async_wait_mem<0>();
  if (live && copy == 0 && r > 0)
    dpeep[((size_t)blockIdx.y * B + b) * 3 * S + (r - 1) * S + k] = (float)dp;
}

template <int ROWS, int kRound>
int launch_cluster(BwdDir e0, BwdDir e1, long long poff, float* da, int dcols,
                   float* dpeep, int ndir, int T, int B, int S, int ncta,
                   int warps, cudaStream_t stream) {
  auto kernel = lstm_walk_cluster_kernel<ROWS, kRound>;
  constexpr int SR = ROWS - cl_reg_rows<ROWS>();
  const int smem = SR / 4 * cl_out<ROWS>() * 32 * warps * (int)sizeof(float4);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (ncta > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ncta * B, ndir);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, e0, e1, poff, da,
                                             dcols, dpeep, T, B, S, ncta);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The big-S forward over ndir directions (grid B x ndir).
template <bool kTrain, int kRound = 0>
int launch_global(const float* xproj, int xcols, Dir d0, Dir d1, int ndir,
                  int T, int B, int S, cudaStream_t stream,
                  long long coff = 0) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * 6 * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_global_kernel<kTrain, kRound>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 4 * S < 1024 ? ((4 * S + 31) / 32) * 32 : 1024;
  lstm_global_kernel<kTrain, kRound><<<dim3(B, ndir), threads, smem, stream>>>(
      xproj, xcols, d0, d1, T, B, S, coff);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xproj [T, B, 4S], sW [S, 4S], peep [3S] -> y [T, B, S]; all fp32,
// contiguous, on the current device. global = 0: sW in registers (S <=
// REG_MAX_S, which ops/lstm.py names REGISTER_MAX_S); global = 1: the
// big-S mode. rounding 0, 1 or 2: none, TF32 or bfloat16 operands.
// Returns a cudaError_t.
int scrappie_lstm_recurrence(const float* xproj, const float* sW,
                             const float* peep, float* y, int T, int B, int S,
                             int reverse, int global, int rounding,
                             cudaStream_t stream) {
  const Dir d{sW, peep, y, reverse};
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (!global)
      return launch_registers<false, R>(xproj, 4 * S, d, d, 1, T, B, S, stream);
    return launch_global<false, R>(xproj, 4 * S, d, d, 1, T, B, S, stream);
  });
}

// Both directions of a stage in one launch: xproj [T, B, 8S] (the forward
// layer's 4S gate columns, then the backward one's), sW_f, sW_b [S, 4S],
// peep_f, peep_b [3S] -> y_f, y_b [T, B, S], the forward layer walking time
// forwards, the backward one backwards; S <= REG_MAX_S; rounding as
// scrappie_lstm_recurrence's. Returns a cudaError_t.
int scrappie_lstm_pair(const float* xproj, const float* sW_f,
                       const float* peep_f, float* y_f, const float* sW_b,
                       const float* peep_b, float* y_b, int T, int B, int S,
                       int rounding, cudaStream_t stream) {
  return with_rounding(rounding, [&](auto r) {
    return launch_registers<false, decltype(r)::value>(
        xproj, 8 * S, Dir{sW_f, peep_f, y_f, 0}, Dir{sW_b, peep_b, y_b, 1}, 2,
        T, B, S, stream);
  });
}

// The training mode of scrappie_lstm_pair: also writes c_f, c_b and the
// directions' other planes [T, B, S], tanh(c) and the activated gates g,
// i, f, o, plane m at y + m (c - y), which must be the same for both
// directions. global = 0: sW in registers (S <= REG_MAX_S); global = 1:
// the big-S kernel. rounding as scrappie_lstm_recurrence's. Returns a
// cudaError_t.
int scrappie_lstm_pair_train(const float* xproj, const float* sW_f,
                             const float* peep_f, float* y_f, float* c_f,
                             const float* sW_b, const float* peep_b,
                             float* y_b, float* c_b, int T, int B, int S,
                             int global, int rounding, cudaStream_t stream) {
  if (c_f - y_f != c_b - y_b) return (int)cudaErrorInvalidValue;
  const Dir df{sW_f, peep_f, y_f, 0}, db{sW_b, peep_b, y_b, 1};
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (global)
      return launch_global<true, R>(xproj, 8 * S, df, db, 2, T, B, S, stream,
                                    c_f - y_f);
    return launch_registers<true, R>(xproj, 8 * S, df, db, 2, T, B, S, stream,
                                     c_f - y_f);
  });
}

// The backward walk of ndir (1 or 2) directions in one launch: for
// direction d, c [T, B, S] and the forward's next planes at c + m poff
// (tanh(c), g, i, f, o), gh [T, B, S], sW [S, 4S], peep [3S] and the
// forward's direction -> columns 4S d .. 4S d + 4S - 1 of da [T, B, dcols]
// and dpeep [ndir, B, 3S], each row's sums over time of da_i c_prev, da_f
// c_prev and da_o c; all fp32, each plane contiguous, on the current
// device. global = 0: sW in registers, S <= REG_MAX_S, sW0 and sW1 padded
// to [REG_MAX_S, 4, REG_MAX_S] with zeros; global = 1: the cluster walk,
// REG_MAX_S < S <= 8 CL_MAX_ROWS (cluster_layout); global = 2: the big-S
// walk from L2, any S whose 9S floats fit a block's shared memory.
// rounding 0, 1 or 2: the forward's (none, TF32 or bfloat16 operands), the
// carry's product rounded as rounding.cuh's round_cotangent and
// round_result say. Returns a cudaError_t.
int scrappie_lstm_recurrence_bwd(const float* c0, const float* gh0,
                                 const float* sW0, const float* peep0,
                                 int reverse0, const float* c1,
                                 const float* gh1, const float* sW1,
                                 const float* peep1, int reverse1,
                                 long long poff, float* da, int dcols,
                                 float* dpeep, int ndir, int T, int B, int S,
                                 int global, int rounding,
                                 cudaStream_t stream) {
  if (T == 0 || B == 0) return (int)cudaSuccess;
  if (S < 1 || ndir < 1 || ndir > 2 || dcols < 4 * S * ndir ||
      global < 0 || global > 2 || (!global && S > REG_MAX_S))
    return (int)cudaErrorInvalidValue;
  const BwdDir e0{c0, gh0, sW0, peep0, reverse0};
  const BwdDir e1{c1, gh1, sW1, peep1, reverse1};
  const dim3 grid(B, ndir);
  const auto aligned = [](const void* p) { return (size_t)p % 16 == 0; };
  const bool vec4 = S % 4 == 0 && poff % 4 == 0 && aligned(c0) &&
                    aligned(c1) && aligned(gh0) && aligned(gh1);
  int ncta = 0, warps = 0, rows = 0;
  if (global == 1 && (S <= REG_MAX_S || !cluster_layout(S, ncta, warps, rows)))
    return (int)cudaErrorInvalidValue;
  return with_rounding(rounding, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (global == 1) {
      auto go = [&](auto fn) {
        return fn(e0, e1, poff, da, dcols, dpeep, ndir, T, B, S, ncta, warps,
                  stream);
      };
      switch (rows) {
        case 16: return go(launch_cluster<16, R>);
        case 20: return go(launch_cluster<20, R>);
        case 24: return go(launch_cluster<24, R>);
        case 32: return go(launch_cluster<32, R>);
        case 40: return go(launch_cluster<40, R>);
        case 48: return go(launch_cluster<48, R>);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    if (global) {
      const size_t smem = sizeof(float) * 9 * (size_t)S;
      cudaError_t err = cudaFuncSetAttribute(
          lstm_walk_global_kernel<R>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      lstm_walk_global_kernel<R><<<grid, 1024, smem, stream>>>(
          e0, e1, poff, da, dcols, dpeep, T, B, S);
    } else if (vec4) {
      lstm_recurrence_bwd_kernel<4, R><<<grid, BW_THREADS, 0, stream>>>(
          e0, e1, poff, da, dcols, dpeep, T, B, S);
    } else {
      lstm_recurrence_bwd_kernel<1, R><<<grid, BW_THREADS, 0, stream>>>(
          e0, e1, poff, da, dcols, dpeep, T, B, S);
    }
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
