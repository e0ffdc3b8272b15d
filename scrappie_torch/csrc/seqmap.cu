// Posterior-to-sequence mapping: the DP over the blocks of one read's log
// posterior against a reference's kmer states, Viterbi (with a move byte a
// state) or forward (log-sum-exp); the walk of the Viterbi moves back to the
// path; and the same DP restricted to a band.
//
// Replaces scrappie_tpu/ops/seqmap.py:_seqmap_kernel: seqmap_kernel
// (wrapper map_to_sequence_tm, scrappie_torch/ops/seqmap.py), whose order
// of operations the lax.scan program of
// scrappie_tpu/decode/mapping.py:_map_dense gives. States: the seqlen
// reference positions, then the local START (seqlen) and END (seqlen + 1).
// Per block t, with stay_lp = lp[t, nst-1] and emit[pos] =
// lp[t, seqstates[pos]]:
//   position pos, candidates in this order:
//     stay   (prev[pos] - stay_pen) + stay_lp                 move 0
//     step   prev[pos-1] + emit[pos]                           move 1
//     skip   (prev[pos-2] - skip_pen) + emit[pos]              move 2
//     entry  (pos = 0 only) prev[START] + emit[0]              move 3
//   START    prev[START] + local_stay                          move 0
//   END      prev[END] + local_stay, then the exit
//            prev[seqlen-1] - local_pen                        move 2
// with local_stay = max(-local_pen, stay_lp) (Viterbi) or
// logaddexp(-local_pen, stay_lp) (forward). A state's predecessor is its
// index less its move, or START for move 3, which gives back JAX's int32
// traceback, its -1 and -2 (a step or skip into position 0 or 1 that won
// on a -inf posterior) included. Out-of-range predecessors are -1e30, as in
// the scan. Viterbi takes a candidate only if strictly greater; the forward
// variant combines by jnp.logaddexp's formula (-inf with -inf stays -inf).
// Every addition is an explicit __fadd_rn/__fsub_rn in the scan's order,
// so the Viterbi scores and moves are identical bit for bit to the plain
// twin (ops/seqmap.py:map_to_sequence_plain). As in the scan, and unlike
// the Pallas kernel, -inf log posteriors are not clamped.
//
// What bounds it on the H100: latency. The DP is sequential in the blocks
// (about 12 000 for a 60 000-sample read at stride 5) and each block needs
// the previous block's scores; a block's work (seqlen + 2 states, each a
// gather of its kmer's posterior and a few adds and compares) fits one SM.
// Its traffic, the posterior rows (4 nst bytes a block) and the moves
// (seqlen + 2 bytes a block), is small.
//
// Design: one block per call (one read, as in JAX). Thread i owns the run
// of R consecutive states from i R (R = 4, 8 or 16, the forward variant
// also 6 or 12 for more threads; ops/seqmap.seqmap_layout): their scores
// and kmer indices stay in registers, a step
// updates the run from its end down so that pos-1 and pos-2 are still the
// previous block's, the run's two left neighbours come from the lane below
// by shuffle and from the warp below through shared memory (double-buffered
// by the parity of the block), and the run's R move bytes go out as one
// store (a warp's stores are contiguous; the rows of `moves` are padded to
// 16 bytes). START's score is a scalar recurrence every thread keeps (the
// entry at position 0 reads it); END sits at the end of the last run, whose
// pos-2 is seqlen-1, its exit's source. The posterior rows come through a
// ring of RING rows in shared memory, copied RING - 1 blocks ahead by
// 16-byte cp.async pieces of the 16-byte-aligned span around the row (a row
// of 1025 floats is 4100 bytes and starts at any multiple of 4 bytes; a
// piece that would leave the tensor is copied a float at a time). A bulk
// TMA copy of the span would read up to 12 bytes past the tensor's end, and
// every thread takes part in the block's one barrier a step anyway. The
// emissions are a shared-memory gather (random banks) at the end of the
// block before, after the run's arithmetic. One __syncthreads a step: it
// orders the ring and the edge exchange. Above 16 * 1024 states (a reference of
// more than 16 382 bases) the scores live in a global scratch [2, ld]
// instead, read and written a float4 run at a time (kGlobal), which takes
// any length.
//
// seqmap_walk_kernel follows the moves back from the final state (the
// host walk of scrappie_tpu/decode/mapping.py:map_to_sequence_viterbi,
// with its quirks: the last position only if its final beats END's
// strictly, START and END written as -1, a state of -1 or -2 read as
// column seqlen + 1 or seqlen, move 3 to START, and a walk in START
// staying there, since the DP writes START's move as 0). What bounds it:
// latency. A block's move decides which byte of the next (earlier) row to
// read, and a walk that reads the plane itself waits a device-memory round
// trip a block; the bound, a byte a block and the path, is 0.00002 ms.
// The floor of this design is a block's chain: a shared-memory load of its
// byte and one add.
//
// Design (csrc/dtw.cu's walk, with one kind of state): three warps, one
// walking, two copying. Going back, the column falls by 0, 1 or 2 a block
// (about seqlen / T = 0.5 on a read) until an entry to START or a step
// below column 0. A window holds WALK_ROWS rows of the WALK_PIECES 16-byte
// pieces from walk_lo(col) (ops/seqmap.walk_window): every column the walk
// can reach from col in 2 WALK_ROWS rows. At a window's first row the
// walker asks the copier warps, through a named barrier, for the next
// window anchored at its column then; they fill the other buffer (cp.async)
// while the walk goes on and signal through a second barrier, which the
// walker waits for at the window's end. So stays, steps and skips never
// leave the windows, and a window never misses the walk. They go
// WALK_BATCH rows a check: each row's byte is loaded at the column the
// byte before leads to, so the chain is the load and an add, and one test
// of the batch's bytes (an entry, or any byte above 2) and of its last
// column (below the window: a state below 0) follows; such a batch is
// walked a row at a time. An entry, a state below 0 and any byte no DP
// writes take an exact step as the host walk takes it; START ends the walk
// (the rest is -1), and any other state (END, after a step below column
// 0) loads a window anchored there on the walker. The windows' rows are
// 16-byte aligned (the rows of `moves` are padded to 16 bytes).
//
// The banded DP (no TPU kernel: the lax.scan of
// scrappie_tpu/decode/mapping.py:_map_banded; wrapper map_banded_tm, twin
// map_banded_plain in scrappie_torch/ops/seqmap.py) runs over blocks 1 to
// T-1 after the caller's block 0: a window of `width` scores at positions
// low[t] + w slides along the sequence. Per block, in the scan's order,
// comb(comb(stay, step), skip) from the previous window shifted by
// d = low[t] - low[t-1] (lax.dynamic_slice's clamp), the entry at w = 0
// while low[t] == 0, the in-band mask, then START and END (the exit reads
// position seqlen-1 in the previous window). comb is fmaxf (Viterbi) or
// logaddexp. The kernels take low and high on the card and derive the
// shift, the entry flag, the mask and the exit's offset themselves.
//
// What bounds it on the H100: latency. A block's work is a few hundred
// adds; its bytes (the band's emissions, about 0.4 KB a block at width
// 101) are a 0.0015 ms bound for a whole read. Per block the chain is one
// shared-memory load of the previous window, the candidates' subtraction
// and add, two maxima and the mask's select, then the store (Viterbi,
// about 80 cycles); the forward puts two dependent logaddexps in place of
// the maxima (about 250 cycles). On one warp the issue of the K offsets'
// instructions adds to that.
//
// Narrow bands, up to BAND_WARP_MAX offsets (ops/seqmap.banded_layout,
// the warp mode), run as two launches counted as one call:
// banded_gather_kernel spreads over the card and gathers, for every block,
// the band's emissions, the stay and entry emissions and the bounds into
// one plane row [T, stride] (stride = width rounded up to 4, then 4 header
// words: 0.4 KB a block at width 101, where the posterior row is 4.1 KB);
// then seqmap_banded_warp_kernel walks the blocks on one warp. A lane
// holds the offsets lane, lane + 32, ... (K of them, a template) with
// their emissions in registers; the window is double-buffered in the
// warp's shared memory between guards of -1e30 (width floats before it,
// 32 K after it: a slice start clamped to 2 width puts lane 31's last
// offset's read at width + 32 K - 1, and 32 K >= width), so that every
// shifted read is one unconditional load within the allocation whatever
// the shift is. The step has no branch
// to reconverge: every lane computes and stores all K offsets (past the
// band, -1e30 into the guard), reads the whole previous window before it
// stores (so the K chains overlap), and the forward's logaddexp takes the
// hardware's ex2 and lg2 and a select for its NaN case, in place of expf
// and log1pf, whose special-case branch cost more than the whole step
// (held to FORWARD_RTOL). The plane's rows come through a ring of BAND_DEPTH
// rows, BAND_BATCH rows a bulk copy by the TMA unit counted on an
// mbarrier, about 24 blocks ahead (cp.async groups could keep only 8 rows
// in flight), so no load of the plane, of the bounds or of seqstates sits
// on the chain: the bounds of block t+1 are in registers before block t
// ends. START, END and the exit are computed by every lane, off the
// window's chain. Wider bands take the block mode, seqmap_banded_kernel:
// one block, a thread a window offset (offsets tid, tid + threads, ...;
// any width), the posterior rows and the bounds through the ring of RING
// rows, the window double-buffered in shared memory, or in a global
// scratch when 2 width floats do not fit; one __syncthreads a block. It
// combines by the warp mode's logaddexp_sel too, so that a forward call
// has one formula at every width.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float BIG = 1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int WARP = 32;
constexpr int RING = 8;       // posterior rows in the shared-memory ring
constexpr int WALK_ROWS = 128;                // rows a walk window holds
constexpr int WALK_FALL = 4 * WALK_ROWS - 2;  // columns a walk falls in two
constexpr int WALK_PIECES = 33;  // 16-byte pieces that enclose WALK_FALL + 1
constexpr int WALK_PITCH = 16 * WALK_PIECES;  // bytes of a window's row
constexpr int WALK_BATCH = 8;                 // rows a check
constexpr int WALK_PAD = 2048;  // bytes before the windows: 8 x 255 below
constexpr int WALK_COPIERS = 2;               // warps copying windows
constexpr int WALK_THREADS = WARP * (1 + WALK_COPIERS);
static_assert(WALK_PIECES == (WALK_FALL + 15) / 16 + 1,
              "a window's pieces hold its fall at any alignment");
constexpr int GLOBAL_RUN = 4; // states a thread in the global-memory mode
constexpr int BAND_WARP_MAX = 256; // widest band of the warp mode: 8 a lane
constexpr int BAND_DEPTH = 32;     // plane rows in the warp mode's ring
constexpr int BAND_BATCH = 8;      // plane rows a bulk copy of the ring
constexpr int BAND_HEADER = 4;     // stay, entry, low, high after a plane row
constexpr int GATHER_THREADS = 256;

struct SeqmapParams {
  float stay_pen;
  float skip_pen;
  float local_pen;
};

// jnp.logaddexp's formula.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float delta = __fsub_rn(a, b);
  if (isnan(delta)) return __fadd_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(delta))));
}

template <bool kViterbi>
__device__ __forceinline__ void contend(float& cur, int& move, float cand,
                                        int cmove) {
  if (kViterbi) {
    if (cand > cur) {
      cur = cand;
      move = cmove;
    }
  } else {
    cur = logaddexp(cur, cand);
  }
}

// jnp.logaddexp's formula without a branch, for the banded kernels' step:
// the NaN case by a select, and log1p(exp(-|a - b|)) by the hardware's
// ex2 and lg2 (an absolute error of a few 1e-7 a combination, where
// log1pf's special-case branch alone costs the step more than its
// arithmetic; held to FORWARD_RTOL on the card).
__device__ __forceinline__ float logaddexp_sel(float a, float b) {
  const float delta = __fsub_rn(a, b);
  const float r = __fadd_rn(fmaxf(a, b), __logf(1.0f + __expf(-fabsf(delta))));
  return isnan(delta) ? __fadd_rn(a, b) : r;
}

template <bool kViterbi>
__device__ __forceinline__ float comb_sel(float a, float b) {
  return kViterbi ? fmaxf(a, b) : logaddexp_sel(a, b);
}

// Floats of a ring slot: a row and the 16-byte-aligned span around it.
__host__ __device__ __forceinline__ int slot_floats(int nst) {
  return (nst + 3 + 3) & ~3;
}

// The ring of posterior rows: row t lies in slot t % RING at float offset
// row_offset(t) (the row's start within its 16-byte-aligned span).
struct RowRing {
  const float* lp;
  int T, nst, slot;

  __device__ __forceinline__ int row_offset(int t) const {
    return (int)((reinterpret_cast<uintptr_t>(lp + (size_t)t * nst) & 15) >> 2);
  }

  __device__ __forceinline__ const float* row(const float* ring, int t) const {
    return ring + (t % RING) * slot + row_offset(t);
  }

  // Start copying row t (if t < T) into its slot, and with it `nextra` ints
  // of `extra` + t * nextra into ints + (t % RING) * nextra; every thread
  // commits a group, empty past the end, so that the groups stay in step
  // with t.
  __device__ __forceinline__ void stage(float* ring, int t, int tid,
                                        int nthreads, const int* extra = nullptr,
                                        int* ints = nullptr, int nextra = 0) const {
    if (t < T) {
      const int off = row_offset(t);
      const float* span = lp + (size_t)t * nst - off;
      float* dst = ring + (t % RING) * slot;
      const uintptr_t first = reinterpret_cast<uintptr_t>(lp);
      const uintptr_t last = reinterpret_cast<uintptr_t>(lp + (size_t)T * nst);
      const int pieces = (off + nst + 3) >> 2;
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(span);
      const bool inside = a0 >= first && a0 + 16 * pieces <= last;
      for (int c = tid; c < pieces; c += nthreads) {
        const float* src = span + 4 * c;
        const uintptr_t a = reinterpret_cast<uintptr_t>(src);
        if (inside || (a >= first && a + 16 <= last)) {
          __pipeline_memcpy_async(dst + 4 * c, src, 16);
        } else {
          for (int k = 0; k < 4; ++k) {
            const uintptr_t ak = a + 4 * k;
            if (ak >= first && ak < last)
              __pipeline_memcpy_async(dst + 4 * c + k, src + k, 4);
          }
        }
      }
      if (tid < nextra)
        __pipeline_memcpy_async(ints + (t % RING) * nextra + tid,
                                extra + (size_t)tid * T + t, 4);
    }
    __pipeline_commit();
  }
};

// One block's update of a run of R states from base: s holds the previous
// block's scores and gets the new ones; e holds the emissions of the run's
// positions; nb1 and nb2 are the previous scores of states base-1 and
// base-2 (-BIG below 0). Runs from the end down, so that s[i-1] and s[i-2]
// are still the previous block's when state i reads them. Returns the
// moves, a byte a state (state base + i in byte i). local_stay is read
// only by a run that holds START or END, pstart only by the run of
// position 0.
template <bool kViterbi, int R>
__device__ __forceinline__ void update_run(float (&s)[R], const float (&e)[R],
                                           float nb1, float nb2, float stay_lp,
                                           float local_stay, float pstart,
                                           int base, int seqlen,
                                           const SeqmapParams& p,
                                           uint32_t (&moves)[(R + 3) / 4]) {
#pragma unroll
  for (int j = 0; j < (R + 3) / 4; ++j) moves[j] = 0;
  if (base + R <= seqlen) {  // positions only
#pragma unroll
    for (int i = R - 1; i >= 0; --i) {
      const float step = i >= 1 ? s[i - 1] : nb1;
      const float skip = i >= 2 ? s[i - 2] : (i == 1 ? nb1 : nb2);
      float cur = __fadd_rn(__fsub_rn(s[i], p.stay_pen), stay_lp);
      int move = 0;
      contend<kViterbi>(cur, move, __fadd_rn(step, e[i]), 1);
      contend<kViterbi>(cur, move,
                        __fadd_rn(__fsub_rn(skip, p.skip_pen), e[i]), 2);
      if (i == 0 && base == 0)
        contend<kViterbi>(cur, move, __fadd_rn(pstart, e[i]), 3);
      s[i] = cur;
      moves[i / 4] |= (uint32_t)move << (8 * (i % 4));
    }
    return;
  }
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {
    const int g = base + i;
    const float skip = i >= 2 ? s[i - 2] : (i == 1 ? nb1 : nb2);
    float cur = s[i];
    int move = 0;
    if (g < seqlen) {
      const float step = i >= 1 ? s[i - 1] : nb1;
      cur = __fadd_rn(__fsub_rn(s[i], p.stay_pen), stay_lp);
      contend<kViterbi>(cur, move, __fadd_rn(step, e[i]), 1);
      contend<kViterbi>(cur, move,
                        __fadd_rn(__fsub_rn(skip, p.skip_pen), e[i]), 2);
      if (g == 0) contend<kViterbi>(cur, move, __fadd_rn(pstart, e[i]), 3);
    } else if (g == seqlen) {
      cur = __fadd_rn(s[i], local_stay);
    } else if (g == seqlen + 1) {
      cur = __fadd_rn(s[i], local_stay);
      contend<kViterbi>(cur, move, __fsub_rn(skip, p.local_pen), 2);
    }
    s[i] = cur;
    moves[i / 4] |= (uint32_t)move << (8 * (i % 4));
  }
}

// A run's kmer indices, two 16-bit halves a register (nst is far below
// 65 536: RING rows of it fit shared memory).
template <int R>
struct Kmers {
  uint32_t k[R / 2];

  __device__ __forceinline__ void load(const int* __restrict__ seqstates,
                                       int base, int seqlen) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int g = base + 2 * i;
      k[i] = (g < seqlen ? (uint32_t)__ldg(seqstates + g) : 0u) |
             (g + 1 < seqlen ? (uint32_t)__ldg(seqstates + g + 1) << 16 : 0u);
    }
  }

  __device__ __forceinline__ int operator[](int i) const {
    return (k[i / 2] >> (16 * (i % 2))) & 0xffff;
  }
};

template <int R>
__device__ __forceinline__ void gather(float (&e)[R], const Kmers<R>& kmer,
                                       const float* row) {
#pragma unroll
  for (int i = 0; i < R; ++i) e[i] = row[kmer[i]];
}

template <int R>
__device__ __forceinline__ void store_moves(uint8_t* dst,
                                            const uint32_t (&m)[(R + 3) / 4]) {
  if constexpr (R == 4) {
    *reinterpret_cast<uint32_t*>(dst) = m[0];
  } else if constexpr (R == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(m[0], m[1]);
  } else {
    static_assert(R == 16, "Viterbi runs of 4, 8 or 16 states");
    *reinterpret_cast<uint4*>(dst) = make_uint4(m[0], m[1], m[2], m[3]);
  }
}

__device__ __forceinline__ float local_stay_of(bool viterbi, float local_pen,
                                               float stay_lp) {
  return viterbi ? fmaxf(-local_pen, stay_lp) : logaddexp(-local_pen, stay_lp);
}

// lp [T, nst]; seqstates [seqlen] -> final [seqlen+2], moves [T, ld] uint8
// (Viterbi with a path; may be null; bytes from seqlen + 2 on are 0).
// Dynamic shared memory: the ring, then the warps' edges [2][32] float2.
// kGlobal: the scores live in scratch [2, ld], runs of GLOBAL_RUN = 4.
template <bool kViterbi, int R, bool kGlobal>
__global__ void __launch_bounds__(MAX_THREADS)
seqmap_kernel(const float* __restrict__ lp, const int* __restrict__ seqstates,
              float* scratch, float* __restrict__ final_,
              uint8_t* __restrict__ moves, int T, int nst, int seqlen, int ld,
              SeqmapParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & (WARP - 1);
  const int warp = tid / WARP;
  const int n = seqlen + 2;
  const RowRing ring{lp, T, nst, slot_floats(nst)};
  float* rows = smem;
  float2* edge = reinterpret_cast<float2*>(smem + RING * ring.slot);
  const int base = tid * R;
  float s[R];
  Kmers<R> kmer;
  float e[R];
  uint32_t mv[(R + 3) / 4];
  float pstart = 0.0f;

  if constexpr (kGlobal) {
    static_assert(R == 4, "a float4 run");
    for (int g = tid; g < ld; g += nthreads) scratch[g] = g == seqlen ? 0.0f : -BIG;
    for (int t = 0; t < RING - 1; ++t) ring.stage(rows, t, tid, nthreads);
    for (int t = 0; t < T; ++t) {
      __pipeline_wait_prior(RING - 2);
      // Row t is staged and block t-1's scores are written; every thread
      // is done with row t-1, whose slot now takes row t + RING - 1.
      __syncthreads();
      ring.stage(rows, t + RING - 1, tid, nthreads);
      const float* row = ring.row(rows, t);
      const float stay_lp = row[nst - 1];
      const float local_stay = local_stay_of(kViterbi, p.local_pen, stay_lp);
      const float* prev = scratch + (t & 1) * ld;
      float* next = scratch + ((t + 1) & 1) * ld;
      for (int b = base; b < ld; b += nthreads * R) {
        const float4 v = *reinterpret_cast<const float4*>(prev + b);
        s[0] = v.x;
        s[1] = v.y;
        s[2] = v.z;
        s[3] = v.w;
        kmer.load(seqstates, b, seqlen);
        gather<R>(e, kmer, row);
        update_run<kViterbi, R>(s, e, b >= 1 ? prev[b - 1] : -BIG,
                                b >= 2 ? prev[b - 2] : -BIG, stay_lp,
                                local_stay, pstart, b, seqlen, p, mv);
        *reinterpret_cast<float4*>(next + b) = make_float4(s[0], s[1], s[2], s[3]);
        if (kViterbi && moves != nullptr)
          store_moves<R>(moves + (size_t)t * ld + b, mv);
      }
      pstart = __fadd_rn(pstart, local_stay);
    }
    __syncthreads();
    const float* last = scratch + (T & 1) * ld;
    for (int g = tid; g < n; g += nthreads) final_[g] = last[g];
    return;
  }

  for (int t = 0; t < RING - 1; ++t) ring.stage(rows, t, tid, nthreads);
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = base + i == seqlen ? 0.0f : -BIG;
  kmer.load(seqstates, base, seqlen);
  if (lane == WARP - 1) edge[warp] = make_float2(s[R - 2], s[R - 1]);
  // Before the barrier that ends block t-1, rows t and t+1 are staged; a
  // block's emissions are gathered at the end of the block before, when
  // the run's arithmetic is done.
  __pipeline_wait_prior(RING - 3);
  __syncthreads();
  gather<R>(e, kmer, ring.row(rows, 0));
  float stay_lp = ring.row(rows, 0)[nst - 1];
  // Only the runs of position 0 (the entry reads START's score) and of
  // START and END need the local states' stay, a logaddexp in the forward
  // variant.
  const bool local_run = base == 0 || base + R > seqlen;
  for (int t = 0; t < T; ++t) {
    const float local_stay =
        local_run ? local_stay_of(kViterbi, p.local_pen, stay_lp) : 0.0f;
    float nb1 = __shfl_up_sync(FULL, s[R - 1], 1);
    float nb2 = __shfl_up_sync(FULL, s[R - 2], 1);
    if (lane == 0) {
      const float2 left = warp > 0 ? edge[(t & 1) * WARP + warp - 1]
                                   : make_float2(-BIG, -BIG);
      nb2 = left.x;
      nb1 = left.y;
    }
    update_run<kViterbi, R>(s, e, nb1, nb2, stay_lp, local_stay, pstart, base,
                            seqlen, p, mv);
    pstart = __fadd_rn(pstart, local_stay);
    if (lane == WARP - 1)
      edge[((t + 1) & 1) * WARP + warp] = make_float2(s[R - 2], s[R - 1]);
    if constexpr (kViterbi) {
      if (moves != nullptr && base < ld)
        store_moves<R>(moves + (size_t)t * ld + base, mv);
    }
    if (t + 1 < T) {
      const float* row = ring.row(rows, t + 1);
      gather<R>(e, kmer, row);
      stay_lp = row[nst - 1];
    }
    // Row t-1's slot, last read before the barrier that ended block t-2,
    // takes row t + RING - 1.
    ring.stage(rows, t + RING - 1, tid, nthreads);
    __pipeline_wait_prior(RING - 3);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (base + i < n) final_[base + i] = s[i];
}

// The walk's window of columns anchored at column col: the 16-byte pieces
// from walk_lo(col) on, at most WALK_PIECES and none past the row's ld
// bytes, hold every column the walk can read in the WALK_ROWS rows from
// col's row and in the WALK_ROWS rows after them (a fall of at most 2 a
// row: down to col - WALK_FALL).
__device__ __forceinline__ int walk_lo(int col) {
  return max(col - WALK_FALL, 0) & ~15;
}

// The named barriers between the walking warp and the copying warps: a
// request (the walker arrives, the copiers wait) and its copy done (the
// copiers arrive, the walker waits).
constexpr int BAR_REQUEST = 1;
constexpr int BAR_DONE = 2;

__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WALK_THREADS) : "memory");
}

__device__ __forceinline__ void bar_signal(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WALK_THREADS) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u8(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Rows top, top - 1, ... (WALK_ROWS of them, none below row 1) of the
// moves' bytes [lo, lo + 16 pieces) into the window w [WALK_ROWS]
// [WALK_PITCH], by cp.async from threads id = 0 .. nthreads - 1, each
// waiting for its own copies.
__device__ __forceinline__ void copy_window(uint8_t* w,
                                            const uint8_t* __restrict__ moves,
                                            int top, int lo, int ld, int id,
                                            int nthreads) {
  const int pieces = min(WALK_PIECES, (ld - lo) >> 4);
  const int rows = min(WALK_ROWS, top);
  for (int e = id; e < rows * pieces; e += nthreads) {
    const int r = e / pieces, c = e - r * pieces;
    __pipeline_memcpy_async(w + r * WALK_PITCH + 16 * c,
                            moves + (size_t)(top - r) * ld + lo + 16 * c, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The Viterbi path from the final scores and the moves (see the header):
// warp 0 walks, warps 1 .. WALK_COPIERS copy the next window. Dynamic
// shared memory: WALK_PAD bytes, two windows [WALK_ROWS][WALK_PITCH], then
// WALK_PITCH bytes (walk_smem_bytes).
__global__ void __launch_bounds__(WALK_THREADS)
seqmap_walk_kernel(const float* __restrict__ final_,
                   const uint8_t* __restrict__ moves, int* __restrict__ path,
                   int T, int seqlen, int ld) {
  extern __shared__ __align__(16) uint8_t wsm[];
  __shared__ int req_top, req_lo, req_buf;  // the copiers' request
  uint8_t* win = wsm + WALK_PAD;
  const int lane = threadIdx.x & 31;
  const int n = seqlen + 2;
  const int START = seqlen;
  const int END = seqlen + 1;
  if (threadIdx.x >= WARP) {  // the copiers: each request's window, then done
    for (;;) {
      bar_wait(BAR_REQUEST);
      const int top = req_top;
      if (top < 0) return;
      copy_window(win + req_buf * WALK_ROWS * WALK_PITCH, moves, top, req_lo,
                  ld, threadIdx.x - WARP, WALK_THREADS - WARP);
      bar_signal(BAR_DONE);
    }
  }
  // warp 0, the walker: every lane walks (the same values), lane 0 writes
  auto shown = [&](int st) { return st >= START ? -1 : st; };
  bool pending = false;  // a request whose done is not yet waited for
  auto request = [&](int top, int lo, int b) {
    if (pending) bar_wait(BAR_DONE);
    if (lane == 0) {
      req_top = top;
      req_lo = lo;
      req_buf = b;
    }
    __syncwarp();
    bar_signal(BAR_REQUEST);
    pending = top >= 0;
  };
  int col = final_[seqlen - 1] > final_[END] ? seqlen - 1 : END;
  if (lane == 0) path[T - 1] = shown(col);
  int s = T - 1;  // path[s] is written; row s's byte at col gives path[s-1]
  const unsigned base = (unsigned)__cvta_generic_to_shared(win);
  int buf = 0, top = 0, lo = 0, next_lo = 0;
  bool fresh = true;  // the walk needs a window anchored at col, at row s
  while (s > 0) {
    if (fresh) {  // loaded by the walker, which waits for it
      top = s;
      lo = walk_lo(col);
      __syncwarp();
      copy_window(win + buf * WALK_ROWS * WALK_PITCH, moves, top, lo, ld, lane,
                  WARP);
      __syncwarp();
      fresh = false;
    }
    // the next window, anchored at the walk's column now, into the other
    // buffer by the copiers while this one is walked
    if (top - WALK_ROWS >= 1) {
      next_lo = walk_lo(col);
      request(top - WALK_ROWS, next_lo, buf ^ 1);
    }
    const int rows = min(WALK_ROWS, top);  // rows top .. top - rows + 1
    int i = top - s;                       // the window's row of row s
    int L = col - lo;
    const unsigned rows0 = base + (unsigned)(buf * WALK_ROWS * WALK_PITCH);
    unsigned a = rows0 + (unsigned)(i * WALK_PITCH + L);  // row i's byte at L
    uint32_t b = ld_shared_u8(a);
    int* out = path + s - 1;  // where the next state goes
    // Stays, steps and skips, WALK_BATCH rows a check: each row's byte is
    // loaded at the column the byte before leads to (the chain is the load
    // and one add), then one test of the batch's bytes and of its last
    // column: a batch with a byte above 2 (an entry) or a column below the
    // window (a state below 0) is walked a row at a time. A rejected
    // batch's loads stay within the pads around the windows.
    while (i + WALK_BATCH <= rows) {
      uint32_t bb[WALK_BATCH + 1];
      unsigned ak = a;
      bb[0] = b;
#pragma unroll
      for (int k = 1; k <= WALK_BATCH; ++k) {
        ak = ak + WALK_PITCH - bb[k - 1];
        bb[k] = ld_shared_u8(ak);
      }
      uint32_t top_byte = 0;
      int fall = 0;
#pragma unroll
      for (int k = 0; k < WALK_BATCH; ++k) {
        top_byte = max(top_byte, bb[k]);
        fall += (int)bb[k];
      }
      if ((top_byte > 2) | (L - fall < 0)) break;
      if (lane == 0) {
        int c = lo + L;
#pragma unroll
        for (int k = 0; k < WALK_BATCH; ++k) {
          c -= (int)bb[k];
          out[-k] = shown(c);
        }
      }
      out -= WALK_BATCH;
      s -= WALK_BATCH;
      i += WALK_BATCH;
      L -= fall;
      a = ak;
      b = bb[WALK_BATCH];
    }
    bool exact = false;
    while (i < rows) {
      const int Ln = L - (int)b;
      if ((b > 2) | (Ln < 0)) {
        exact = true;
        break;
      }
      if (lane == 0) *out = shown(lo + Ln);
      --out;
      --s;
      ++i;
      L = Ln;
      a += WALK_PITCH - b;
      if (i < rows) b = ld_shared_u8(a);
    }
    col = lo + L;
    if (exact) {
      // the step as the host walk takes it: an entry goes to START, a
      // state below 0 is read as column n + state
      const int st = b == 3 ? START : col - (int)b;
      --s;
      if (lane == 0) path[s] = shown(st);
      col = st < 0 ? st + n : st;
      if (col == START) {  // START's predecessor is START (the DP's move 0)
        for (int k = lane; k < s; k += WARP) path[k] = -1;
        break;
      }
      col = min(max(col, 0), n - 1);  // (only a byte no DP writes leaves it)
      fresh = true;
      continue;
    }
    if (s == 0) break;
    // the window's end: the copiers' window holds row s and column col
    bar_wait(BAR_DONE);
    pending = false;
    buf ^= 1;
    top = s;
    lo = next_lo;
  }
  request(-1, 0, 0);  // the copiers leave
}

// lp [T, nst]; seqstates [seqlen]; bands [2, T] int32 (low, then high);
// init [width] (block 0's window) -> out [width + 1]: the last block's
// window, then END's score. Dynamic shared memory: the ring, the ring's
// bounds [RING][2] ints, then (kShared) the window [2, width]; else the
// window lives in scratch [2, width].
template <bool kViterbi, bool kShared>
__global__ void __launch_bounds__(MAX_THREADS)
seqmap_banded_kernel(const float* __restrict__ lp,
                     const int* __restrict__ seqstates,
                     const int* __restrict__ bands,
                     const float* __restrict__ init, float* scratch,
                     float* __restrict__ out, int T, int nst, int seqlen,
                     int width, SeqmapParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const RowRing ring{lp, T, nst, slot_floats(nst)};
  float* rows = smem;
  int* bounds = reinterpret_cast<int*>(smem + RING * ring.slot);
  float* win = kShared ? smem + RING * ring.slot + 2 * RING : scratch;

  for (int w = tid; w < width; w += nthreads) win[w] = init[w];
  for (int t = 1; t < RING; ++t)
    ring.stage(rows, t, tid, nthreads, bands, bounds, 2);
  const int seq0 = __ldg(seqstates);
  int lo_prev = __ldg(bands);
  int hi_prev = __ldg(bands + T);
  // Carries after block 0: START stayed once; END is reached only by the
  // direct start->end transition, which the reference allows in the
  // first block alone.
  float start = comb_sel<kViterbi>(-p.local_pen, __ldg(lp + nst - 1));
  float end = -p.local_pen;
  for (int t = 1; t < T; ++t) {
    __pipeline_wait_prior(RING - 2);
    __syncthreads();
    ring.stage(rows, t + RING - 1, tid, nthreads, bands, bounds, 2);
    const float* row = ring.row(rows, t);
    const int lo = bounds[(t % RING) * 2];
    const int hi = bounds[(t % RING) * 2 + 1];
    const float* prev = win + ((t - 1) & 1) * width;
    float* next = win + (t & 1) * width;
    const float stay_lp = row[nst - 1];
    const float local_stay = comb_sel<kViterbi>(-p.local_pen, stay_lp);
    const float entry = __fadd_rn(start, row[seq0]);
    // new[w] reads old offset w + d - by, the slice's start clamped as
    // lax.dynamic_slice clamps it into [0, 2 width] of the padded window
    const int d = lo - lo_prev;
    const int sh0 = min(max(width + d, 0), 2 * width) - width;
    const int sh1 = min(max(width + d - 1, 0), 2 * width) - width;
    const int sh2 = min(max(width + d - 2, 0), 2 * width) - width;
    auto old = [&](int i) {
      return i >= 0 && i < width ? prev[i] : -BIG;
    };
    for (int w = tid; w < width; w += nthreads) {
      const int pos = min(max(lo + w, 0), seqlen - 1);
      const float emit = row[__ldg(seqstates + pos)];
      const float stay_c = __fadd_rn(__fsub_rn(old(sh0 + w), p.stay_pen), stay_lp);
      const float step_c = __fadd_rn(old(sh1 + w), emit);
      const float skip_c = __fadd_rn(__fsub_rn(old(sh2 + w), p.skip_pen), emit);
      float cur = comb_sel<kViterbi>(comb_sel<kViterbi>(stay_c, step_c), skip_c);
      if (w == 0 && lo == 0) cur = comb_sel<kViterbi>(cur, entry);
      next[w] = lo + w < hi ? cur : -BIG;
    }
    if (tid == 0) {
      const float exit_src =
          lo_prev <= seqlen - 1 && seqlen - 1 < hi_prev
              ? prev[min(max(seqlen - 1 - lo_prev, 0), width - 1)]
              : -BIG;
      end = comb_sel<kViterbi>(__fadd_rn(end, local_stay),
                           __fsub_rn(exit_src, p.local_pen));
    }
    start = __fadd_rn(start, local_stay);
    lo_prev = lo;
    hi_prev = hi;
  }
  __syncthreads();
  const float* last = win + ((T - 1) & 1) * width;
  for (int w = tid; w < width; w += nthreads) out[w] = last[w];
  if (tid == 0) out[width] = end;
}

// lp [T, nst]; seqstates [seqlen]; bands [2, T] -> plane [T, stride]: row
// t holds lp[t, seqstates[clamp(low[t] + w)]] for w < width, -1e30 up to
// stride - BAND_HEADER, then stay_lp, lp[t, seqstates[0]], low[t] and
// high[t] (int bits).
__global__ void __launch_bounds__(GATHER_THREADS)
banded_gather_kernel(const float* __restrict__ lp,
                     const int* __restrict__ seqstates,
                     const int* __restrict__ bands, float* __restrict__ plane,
                     int T, int nst, int seqlen, int width, int stride) {
  const size_t total = (size_t)T * stride;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(i / stride);
    const int w = (int)(i - (size_t)t * stride);
    const float* row = lp + (size_t)t * nst;
    const int lo = __ldg(bands + t);
    float v = -BIG;
    if (w < width) {
      v = __ldg(row + __ldg(seqstates + min(max(lo + w, 0), seqlen - 1)));
    } else if (w == stride - BAND_HEADER) {
      v = __ldg(row + nst - 1);
    } else if (w == stride - BAND_HEADER + 1) {
      v = __ldg(row + __ldg(seqstates));
    } else if (w == stride - BAND_HEADER + 2) {
      v = __int_as_float(lo);
    } else if (w == stride - BAND_HEADER + 3) {
      v = __int_as_float(__ldg(bands + T + t));
    }
    plane[i] = v;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Wait for the phase of parity `parity` of the mbarrier, if `live`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity,
                                          bool live) {
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "@!q bra DONE;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity), "r"((int)live)
      : "memory");
}

// If `live`: bytes (a multiple of 16) from global src to shared dst, both
// 16-byte aligned, by the TMA unit, counted on bar with one arrival.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          bool live) {
  asm volatile(
      "{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %4, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      "}\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "r"((int)live)
      : "memory");
}

// The banded DP on one warp over the gathered plane [T, stride]; init
// [width] (block 0's window) -> out [width + 1]. Lane l owns the offsets
// l + 32 k, k < K. Dynamic shared memory: the ring [BAND_DEPTH, stride],
// filled BAND_BATCH rows at a time (rows t to t + BAND_BATCH - 1 for t a
// multiple of BAND_BATCH are contiguous in the plane and in the ring: one
// bulk copy by the TMA unit, counted on the batch's mbarrier), two windows
// of 2 width + 32 K floats, each [guard | window | guard], then the
// mbarriers. A block's step has no branch: every lane computes all K
// offsets (the guards keep every shifted read in bounds) and stores them
// all, an offset at or past width into the trailing guard, which it leaves
// -1e30 (no band reaches that far); the batches' copies and waits branch
// on the block's index alone, once every BAND_BATCH blocks.
template <bool kViterbi, int K>
__global__ void __launch_bounds__(WARP)
seqmap_banded_warp_kernel(const float* __restrict__ plane,
                          const float* __restrict__ init,
                          float* __restrict__ out, int T, int seqlen,
                          int width, int stride, SeqmapParams p) {
  constexpr int NBATCH = BAND_DEPTH / BAND_BATCH;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  float* ring = smem;
  const int span = 2 * width + WARP * K;  // a window and its guards
  float* guarded = smem + BAND_DEPTH * stride;
  uint64_t* full = reinterpret_cast<uint64_t*>(guarded + 2 * span);
  for (int i = lane; i < 2 * span; i += WARP) guarded[i] = -BIG;
  if (lane == 0) {
    for (int c = 0; c < NBATCH; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(full + c)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // window b starts at guarded + b span + width
  for (int w = lane; w < width; w += WARP) guarded[width + w] = init[w];
  // batch c: rows [c BAND_BATCH, (c + 1) BAND_BATCH) of the plane, into
  // ring slots from (c % NBATCH) BAND_BATCH, completing its mbarrier's
  // phase c / NBATCH
  auto stage = [&](int c) {
    const int t0 = c * BAND_BATCH;
    const int rows = min(BAND_BATCH, T - t0);
    bulk_copy(ring + (c % NBATCH) * BAND_BATCH * stride, plane + (size_t)t0 * stride,
              4u * rows * stride, full + c % NBATCH, lane == 0 && rows > 0);
  };
  auto ready = [&](int c) {
    mbar_wait(full + c % NBATCH, (c / NBATCH) & 1, c * BAND_BATCH < T);
  };
  for (int c = 0; c < NBATCH; ++c) stage(c);
  const float4 h0 = *reinterpret_cast<const float4*>(plane + stride - BAND_HEADER);
  int lo_prev = __float_as_int(h0.z);
  int hi_prev = __float_as_int(h0.w);
  // Carries after block 0: START stayed once; END is reached only by the
  // direct start->end transition, which the reference allows in the
  // first block alone.
  float start = comb_sel<kViterbi>(-p.local_pen, h0.x);
  float end = -p.local_pen;
  ready(0);
  // the emissions of row t and the header of row t + 1 are in registers
  // when block t starts
  float em[K];
  auto emissions = [&](int t) {
    const float* row = ring + (t % BAND_DEPTH) * stride + lane;
#pragma unroll
    for (int k = 0; k < K; ++k) em[k] = row[WARP * k];
  };
  auto header = [&](int t) {
    return *reinterpret_cast<const float4*>(ring + (t % BAND_DEPTH) * stride +
                                            stride - BAND_HEADER);
  };
  emissions(1);
  float4 hdr = header(1);
  float4 hdr_next = header(2);
  const int exit_pos = seqlen - 1;
  for (int t = 1; t < T; ++t) {
    const float* prev = guarded + ((t - 1) & 1) * span + width;
    float* next = guarded + (t & 1) * span + width + lane;
    const float stay_lp = hdr.x;
    const int lo = __float_as_int(hdr.z);
    const int hi = __float_as_int(hdr.w);
    // new[w] reads old offset w + d - by, the slice's start clamped as
    // lax.dynamic_slice clamps it into [0, 2 width] of the padded window;
    // the guards hold -1e30 wherever that lands outside the window
    const int d = lo - lo_prev;
    const float* p0 = prev + min(max(width + d, 0), 2 * width) - width + lane;
    const float* p1 = prev + min(max(width + d - 1, 0), 2 * width) - width + lane;
    const float* p2 = prev + min(max(width + d - 2, 0), 2 * width) - width + lane;
    const float local_stay = comb_sel<kViterbi>(-p.local_pen, stay_lp);
    const float entry = __fadd_rn(start, hdr.y);
    const int valid = hi - lo - lane;  // offset lane + 32 k is in band below it
    // every read of the previous window before any store to the next
    // (the compiler cannot tell them apart), so the K offsets' chains
    // overlap
    float a0[K], a1[K], a2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a0[k] = p0[WARP * k];
      a1[k] = p1[WARP * k];
      a2[k] = p2[WARP * k];
    }
    const float exit_src = prev[min(max(exit_pos - lo_prev, 0), width - 1)];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float stay_c = __fadd_rn(__fsub_rn(a0[k], p.stay_pen), stay_lp);
      const float step_c = __fadd_rn(a1[k], em[k]);
      const float skip_c = __fadd_rn(__fsub_rn(a2[k], p.skip_pen), em[k]);
      float cur = comb_sel<kViterbi>(comb_sel<kViterbi>(stay_c, step_c), skip_c);
      if (k == 0) {
        const float with_entry = comb_sel<kViterbi>(cur, entry);
        cur = lane == 0 && lo == 0 ? with_entry : cur;
      }
      a0[k] = WARP * k < valid ? cur : -BIG;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) next[WARP * k] = a0[k];
    const bool exit_in = lo_prev <= exit_pos && exit_pos < hi_prev;
    end = comb_sel<kViterbi>(__fadd_rn(end, local_stay),
                             __fsub_rn(exit_in ? exit_src : -BIG, p.local_pen));
    start = __fadd_rn(start, local_stay);
    lo_prev = lo;
    hi_prev = hi;
    __syncwarp();
    // Rows up to t are read: when t ends a batch, its slots take the batch
    // NBATCH later. Row t + 2's header is read next: when it starts a
    // batch, wait for that batch.
    if ((t + 1) % BAND_BATCH == 0) stage((t + 1) / BAND_BATCH - 1 + NBATCH);
    if ((t + 2) % BAND_BATCH == 0) ready((t + 2) / BAND_BATCH);
    emissions(t + 1);
    hdr = hdr_next;
    hdr_next = header(t + 2);
  }
  const float* last = guarded + ((T - 1) & 1) * span + width;
  for (int w = lane; w < width; w += WARP) out[w] = last[w];
  if (lane == 0) out[width] = end;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kViterbi, int R, bool kGlobal>
cudaError_t launch(const float* lp, const int* seqstates, float* scratch,
                   float* final_, uint8_t* moves, int T, int nst, int seqlen,
                   int ld, int threads, SeqmapParams p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * RING * slot_floats(nst) +
                      sizeof(float2) * 2 * WARP;
  auto kernel = seqmap_kernel<kViterbi, R, kGlobal>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, threads, smem, stream>>>(lp, seqstates, scratch, final_, moves,
                                       T, nst, seqlen, ld, p);
  return cudaGetLastError();
}

template <bool kViterbi, bool kShared>
cudaError_t launch_banded(const float* lp, const int* seqstates,
                          const int* bands, const float* init, float* scratch,
                          float* out, int T, int nst, int seqlen, int width,
                          int threads, SeqmapParams p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * RING * slot_floats(nst) +
                      sizeof(int) * 2 * RING +
                      (kShared ? sizeof(float) * 2 * (size_t)width : 0);
  auto kernel = seqmap_banded_kernel<kViterbi, kShared>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, threads, smem, stream>>>(lp, seqstates, bands, init, scratch,
                                       out, T, nst, seqlen, width, p);
  return cudaGetLastError();
}

// The warp mode: the gather over the card, then the DP on one warp.
template <bool kViterbi, int K>
cudaError_t launch_banded_warp(const float* lp, const int* seqstates,
                               const int* bands, const float* init,
                               float* plane, float* out, int T, int nst,
                               int seqlen, int width, SeqmapParams p,
                               cudaStream_t stream) {
  const int stride = ((width + 3) & ~3) + BAND_HEADER;
  const size_t total = (size_t)T * stride;
  const size_t need = (total + GATHER_THREADS - 1) / GATHER_THREADS;
  const int blocks = (int)(need < 2048 ? need : 2048);
  banded_gather_kernel<<<blocks, GATHER_THREADS, 0, stream>>>(
      lp, seqstates, bands, plane, T, nst, seqlen, width, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t span = 2 * (size_t)width + WARP * K;
  const size_t smem = sizeof(float) * ((size_t)BAND_DEPTH * stride + 2 * span) +
                      sizeof(uint64_t) * (BAND_DEPTH / BAND_BATCH);
  auto kernel = seqmap_banded_warp_kernel<kViterbi, K>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, WARP, smem, stream>>>(plane, init, out, T, seqlen, width, stride, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// run: states a thread (Viterbi 4, 8, 16, forward also 6, 12, in
// registers; GLOBAL_RUN with global); threads: a multiple of 32, at most
// 1024 (ops/seqmap.seqmap_layout).
int scrappie_seqmap(const float* lp, const int* seqstates, float* scratch,
                    float* final_, uint8_t* moves, int T, int nst, int seqlen,
                    int ld, float stay_pen, float skip_pen, float local_pen,
                    int viterbi, int run, int threads, int global,
                    cudaStream_t stream) {
  const SeqmapParams p{stay_pen, skip_pen, local_pen};
  auto go = [&](auto fn) {
    return (int)fn(lp, seqstates, scratch, final_, moves, T, nst, seqlen, ld,
                   threads, p, stream);
  };
  if (global) {
    if (run != GLOBAL_RUN) return (int)cudaErrorInvalidValue;
    return viterbi ? go(launch<true, GLOBAL_RUN, true>)
                   : go(launch<false, GLOBAL_RUN, true>);
  }
  switch (run * 2 + (viterbi ? 1 : 0)) {
    case 9: return go(launch<true, 4, false>);
    case 8: return go(launch<false, 4, false>);
    case 17: return go(launch<true, 8, false>);
    case 16: return go(launch<false, 8, false>);
    case 33: return go(launch<true, 16, false>);
    case 32: return go(launch<false, 16, false>);
    case 12: return go(launch<false, 6, false>);
    case 24: return go(launch<false, 12, false>);
    default: return (int)cudaErrorInvalidValue;
  }
}

int scrappie_seqmap_walk(const float* final_, const uint8_t* moves, int* path,
                         int T, int seqlen, int ld, cudaStream_t stream) {
  if (T == 0) return (int)cudaSuccess;
  const int smem = WALK_PAD + 2 * WALK_ROWS * WALK_PITCH + WALK_PITCH;
  const cudaError_t err = cudaFuncSetAttribute(
      seqmap_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  seqmap_walk_kernel<<<1, WALK_THREADS, smem, stream>>>(final_, moves, path, T,
                                                        seqlen, ld);
  return (int)cudaGetLastError();
}

// per_lane > 0: the warp mode (offsets a lane 1, 2, 4 or 8, width at
// most 32 per_lane), with plane [T, stride] its gathered emissions; else
// the block mode on `threads` threads, the window in shared memory or in
// scratch [2, width].
int scrappie_seqmap_banded(const float* lp, const int* seqstates,
                           const int* bands, const float* init, float* scratch,
                           float* plane, float* out, int T, int nst,
                           int seqlen, int width, float stay_pen,
                           float skip_pen, float local_pen, int viterbi,
                           int threads, int shared, int per_lane,
                           cudaStream_t stream) {
  const SeqmapParams p{stay_pen, skip_pen, local_pen};
  if (per_lane > 0) {
    if (width > WARP * per_lane || width > BAND_WARP_MAX)
      return (int)cudaErrorInvalidValue;
    auto warp = [&](auto fn) {
      return (int)fn(lp, seqstates, bands, init, plane, out, T, nst, seqlen,
                     width, p, stream);
    };
    switch (per_lane * 2 + (viterbi ? 1 : 0)) {
      case 3: return warp(launch_banded_warp<true, 1>);
      case 2: return warp(launch_banded_warp<false, 1>);
      case 5: return warp(launch_banded_warp<true, 2>);
      case 4: return warp(launch_banded_warp<false, 2>);
      case 9: return warp(launch_banded_warp<true, 4>);
      case 8: return warp(launch_banded_warp<false, 4>);
      case 17: return warp(launch_banded_warp<true, 8>);
      case 16: return warp(launch_banded_warp<false, 8>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  auto go = [&](auto fn) {
    return (int)fn(lp, seqstates, bands, init, scratch, out, T, nst, seqlen,
                   width, threads, p, stream);
  };
  if (viterbi) {
    return shared ? go(launch_banded<true, true>) : go(launch_banded<true, false>);
  }
  return shared ? go(launch_banded<false, true>) : go(launch_banded<false, false>);
}

}  // extern "C"
