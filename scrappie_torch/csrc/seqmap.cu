// Posterior-to-sequence mapping: the DP over the blocks of one read's log
// posterior against a reference's kmer states, Viterbi (with an int32
// traceback) or forward (log-sum-exp).
//
// Replaces scrappie_tpu/ops/seqmap.py:_seqmap_kernel (wrapper
// map_to_sequence_tm, scrappie_torch/ops/seqmap.py), whose lax.scan
// program scrappie_tpu/decode/mapping.py:_map_dense gives the order of
// operations. States: the seqlen reference positions, then the local START
// (seqlen) and END (seqlen + 1). Per block t, with stay_lp = lp[t, nst-1]
// and emit[pos] = lp[t, seqstates[pos]]:
//   position pos, candidates in this order:
//     stay   (prev[pos] - stay_pen) + stay_lp                 tb pos
//     step   prev[pos-1] + emit[pos]                           tb pos-1
//     skip   (prev[pos-2] - skip_pen) + emit[pos]              tb pos-2
//     entry  (pos = 0 only) prev[START] + emit[0]              tb START
//   START    prev[START] + local_stay                          tb START
//   END      prev[END] + local_stay, then the exit
//            prev[seqlen-1] - local_pen                        tb seqlen-1
// with local_stay = max(-local_pen, stay_lp) (Viterbi) or
// logaddexp(-local_pen, stay_lp) (forward). Out-of-range predecessors are
// -1e30, as in the scan. Viterbi takes a candidate only if strictly
// greater; the forward variant combines by jnp.logaddexp's formula
// (-inf with -inf stays -inf). Every addition is an explicit
// __fadd_rn/__fsub_rn in the scan's order, so the Viterbi scores and
// traceback are identical bit for bit to the plain twin
// (ops/seqmap.py:map_to_sequence_plain). As in the scan, and unlike the
// Pallas kernel, -inf log posteriors are not clamped.
//
// What bounds it on the H100: latency. The DP is sequential in the blocks
// (about 12 000 for a 60 000-sample read at stride 5) and each block needs
// the previous block's scores; the work per block (seqlen + 2 states of a
// few adds and compares) fits one SM. The traceback, 4 (seqlen + 2) bytes
// per block, and the posterior rows (4 nst bytes per block) are the only
// traffic.
//
// Design: one block of 1024 threads per call (one read, as in JAX); thread
// i owns the states pos = i, i + 1024, ..., so a warp writes 32 consecutive
// traceback entries. The scores live in shared memory, double-buffered
// ([2][seqlen+2] floats, up to SEQMAP_MAX_SHARED_SEQLEN = 28 029 positions
// at nst = 1025), or for longer references in a global scratch of the same
// layout (the template switch kShared; block-local, so the barrier orders
// it too). Each block's posterior row is staged in shared memory by
// cp.async one block ahead (the copy overlaps the block before), so the
// kmer lookup lp[t, seqstates[pos]] is a
// shared-memory read: the TPU kernel's one-hot MXU gather (_expand), its
// lane rolls, 128-lane padding and time padding are gone (exactly T
// steps). One __syncthreads per block: START, END and position seqlen-1
// are read by every thread from the previous scores, so no reduction is
// needed.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1.0e30f;
constexpr int THREADS = 1024;

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
__device__ __forceinline__ void contend(float& cur, int& tb, float cand,
                                        int ctb) {
  if (kViterbi) {
    if (cand > cur) {
      cur = cand;
      tb = ctb;
    }
  } else {
    cur = logaddexp(cur, cand);
  }
}

// Start copying posterior row t into buf; every thread commits a group,
// empty past the end, so the groups stay in step with t.
__device__ __forceinline__ void stage_row(float* buf,
                                          const float* __restrict__ lp, int t,
                                          int T, int nst) {
  if (t < T) {
    const float* src = lp + (size_t)t * nst;
    for (int i = threadIdx.x; i < nst; i += THREADS)
      __pipeline_memcpy_async(buf + i, src + i, sizeof(float));
  }
  __pipeline_commit();
}

// lp [T, nst]; seqstates [seqlen] -> final [seqlen+2], tb [T, seqlen+2]
// int32 (Viterbi with a path; may be null). Dynamic shared memory: two
// posterior rows, then (kShared) the scores [2, seqlen+2]; else the scores
// live in scratch [2, seqlen+2].
template <bool kViterbi, bool kShared>
__global__ void __launch_bounds__(THREADS)
seqmap_kernel(const float* __restrict__ lp, const int* __restrict__ seqstates,
              float* scratch, float* __restrict__ final_,
              int* __restrict__ tb, int T, int nst, int seqlen,
              SeqmapParams p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int n = seqlen + 2;
  const int START = seqlen;
  const int END = seqlen + 1;
  float* rows = smem;
  float* state = kShared ? smem + 2 * nst : scratch;

  for (int s = tid; s < n; s += THREADS) state[s] = s == START ? 0.0f : -BIG;
  stage_row(rows, lp, 0, T, nst);

  for (int t = 0; t < T; ++t) {
    __pipeline_wait_prior(0);
    // Row t is staged and block t-1's scores are written; every thread is
    // done with row t-1, whose buffer now takes row t+1 while block t runs.
    __syncthreads();
    stage_row(rows + ((t + 1) & 1) * nst, lp, t + 1, T, nst);
    const float* row = rows + (t & 1) * nst;
    const float* prev = state + (t & 1) * n;
    float* next = state + ((t + 1) & 1) * n;
    int* tbrow = tb == nullptr ? nullptr : tb + (size_t)t * n;
    const float stay_lp = row[nst - 1];
    const float local_stay = kViterbi ? fmaxf(-p.local_pen, stay_lp)
                                      : logaddexp(-p.local_pen, stay_lp);
    const float pstart = prev[START];

    for (int pos = tid; pos < n; pos += THREADS) {
      float cur;
      int tbv;
      if (pos < seqlen) {
        const float emit = row[__ldg(seqstates + pos)];
        cur = __fadd_rn(__fsub_rn(prev[pos], p.stay_pen), stay_lp);
        tbv = pos;
        contend<kViterbi>(cur, tbv,
                          __fadd_rn(pos >= 1 ? prev[pos - 1] : -BIG, emit),
                          pos - 1);
        contend<kViterbi>(
            cur, tbv,
            __fadd_rn(__fsub_rn(pos >= 2 ? prev[pos - 2] : -BIG, p.skip_pen),
                      emit),
            pos - 2);
        if (pos == 0) contend<kViterbi>(cur, tbv, __fadd_rn(pstart, emit), START);
      } else if (pos == START) {
        cur = __fadd_rn(pstart, local_stay);
        tbv = START;
      } else {
        cur = __fadd_rn(prev[END], local_stay);
        tbv = END;
        contend<kViterbi>(cur, tbv, __fsub_rn(prev[seqlen - 1], p.local_pen),
                          seqlen - 1);
      }
      next[pos] = cur;
      if (tbrow != nullptr) tbrow[pos] = tbv;
    }
  }
  __syncthreads();
  const float* last = state + (T & 1) * n;
  for (int s = tid; s < n; s += THREADS) final_[s] = last[s];
}

template <bool kViterbi, bool kShared>
cudaError_t launch(const float* lp, const int* seqstates, float* scratch,
                   float* final_, int* tb, int T, int nst, int seqlen,
                   SeqmapParams p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)nst + (kShared ? 2 * (size_t)(seqlen + 2) : 0));
  const cudaError_t err = cudaFuncSetAttribute(
      seqmap_kernel<kViterbi, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  seqmap_kernel<kViterbi, kShared><<<1, THREADS, smem, stream>>>(
      lp, seqstates, scratch, final_, tb, T, nst, seqlen, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int scrappie_seqmap(const float* lp, const int* seqstates, float* scratch,
                    float* final_, int* tb, int T, int nst, int seqlen,
                    float stay_pen, float skip_pen, float local_pen,
                    int viterbi, int shared, cudaStream_t stream) {
  const SeqmapParams p{stay_pen, skip_pen, local_pen};
  auto go = [&](auto fn) {
    return (int)fn(lp, seqstates, scratch, final_, tb, T, nst, seqlen, p,
                   stream);
  };
  if (viterbi) {
    return shared ? go(launch<true, true>) : go(launch<true, false>);
  }
  return shared ? go(launch<false, true>) : go(launch<false, false>);
}

}  // extern "C"
