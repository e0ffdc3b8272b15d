"""Signal-to-squiggle alignment: the DP forward pass over raw samples.

Counterpart of scrappie_tpu/ops/dtw.py (squiggle_match_tm, the Pallas
kernel _dtw_kernel) and of the lax.scan program
scrappie_tpu/decode/dtw.py:_squiggle_match, whose order of operations and
tie rules the plain twin copies step for step. States: the forward states
[start | npos positions | end] (nfstate = npos + 2), then npos back states.
Per sample x and forward state st, candidates contend in the order

  stay   f[st] + stay_pen[st]                              tb st
  step   f[st-1] + move_pen[st-1]                          tb st-1
  skip   (f[st-2] + move_pen[st-2]) - skip_pen             tb st-2
  start  f[0] + start_jump[st]                             tb 0
  end    max over all st' of f[st'] + end_jump[st'] into the end state,
         from its first argmax
  back   b[st-2] + log(1/2), for 2 <= st <= npos           tb nfstate+st-2

and per back state j: stay b[j] + log(1/2), then f[j+2] + log(prob_back)
for j < npos-1 (tb j+2). Viterbi takes a candidate by strict `>`; the
forward variant combines them by jnp.logaddexp's formula and the end jump
by jax.nn.logsumexp's. Positions then add the floored Laplace emission
max(-minscore, (-|x - loc| / scale - logscale) - log 2); start and end
pay local_pen. Out-of-range candidates are -1e30, as in the scan.

The start and end jump vectors are built once, here, for both the kernel
and the twin: in float64 and rounded to float32, which is the fused
multiply-add that XLA's CPU backend makes of `move_pen - local_pen * k`.
`scales` is an input, so callers hand both versions one exp(logscales).

The Viterbi traceback is a byte a state, the winning candidate (forward
states: 0 stay, 1 step, 2 skip, 3 start, 4 end, 5 back; back states: 0
stay, 1 move back), plus end_src [T] int32, the end jump's first argmax at
every sample: `moves_to_states` rebuilds JAX's int32 traceback from them,
and `dtw_walk` follows them back from the final state to the path.

On a CUDA tensor `squiggle_match_tm` launches the kernel of csrc/dtw.cu: a
cluster of DTW_CLUSTER CTAs, each holding its share of the states in
shared memory (`cluster_layout`), for squiggles up to
DTW_MAX_SHARED_NPOS positions; above that, a shape limit and not a
fallback, one block with the states in global memory. On a CPU tensor it
runs `squiggle_match_plain`. Outputs: final [2*npos+2] f32 and, for
Viterbi, moves [T, 2*npos+2] uint8 and end_src [T] int32 (None for the
forward variant). There is no lane or time padding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from scrappie_torch import ops

LARGE = 1.0e30
LOG_HALF = float(np.float32(np.log(0.5)))
LOG2 = float(np.float32(np.log(2.0)))
#: Samples whose emissions the twin computes at once.
EMIT_BLOCK = 256
#: Move bytes of the forward states' candidates, and the back states'.
STAY, STEP, SKIP, START, END, BACK = range(6)
MOVE_BACK = 1
#: CTAs of the cluster one read runs on (csrc/dtw.cu allows 1 to 16; above
#: 8 the size is non-portable, and a card that cannot place it refuses the
#: launch), threads a CTA at most, and the states a thread may own.
DTW_CLUSTER = 16
DTW_THREADS_MAX = 512
DTW_SPTS = (1, 2, 4)
#: Bytes of static shared memory the cluster kernel keeps for the end
#: jump's partials: (max, sum, index) of up to 16 x 16 warps, two slots.
RED_BYTES = 2 * 3 * 4 * 16 * (DTW_THREADS_MAX // 32)


class ClusterLayout(NamedTuple):
    """One read's states on a cluster: ncta CTAs of `threads` threads; CTA c
    owns the forward states [c per, min((c+1) per, npos+2)) and their
    positions' back states, `spt` consecutive states a thread."""
    ncta: int
    per: int
    spt: int
    threads: int


def cluster_capacity(cluster: int = DTW_CLUSTER) -> int:
    """The most positions a cluster of `cluster` CTAs holds."""
    return cluster * DTW_THREADS_MAX * DTW_SPTS[-1] - 2


#: Largest npos whose states the kernel keeps in a cluster's shared memory.
DTW_MAX_SHARED_NPOS = cluster_capacity()


def cluster_layout(npos: int, cluster: int = DTW_CLUSTER) -> ClusterLayout:
    """The states of one read on at most `cluster` CTAs: one CTA while its
    npos + 2 forward states fit DTW_THREADS_MAX threads at one a thread
    (the kernel then needs only the block's barrier a sample, and on the
    H100 a single CTA was faster there and not beyond); else `cluster`
    CTAs, each owning at least two forward states (its right neighbour's
    halo) and a multiple of the states a thread owns, so no thread
    straddles two CTAs, with the fewest states a thread that fit
    DTW_THREADS_MAX threads. Raises above the cluster's capacity
    (DTW_MAX_SHARED_NPOS at DTW_CLUSTER)."""
    if not 1 <= cluster <= 16:
        raise ValueError(f"a cluster has 1 to 16 CTAs, got {cluster}")
    if npos > cluster_capacity(cluster):
        raise ValueError(
            f"npos={npos} exceeds the shared-memory limit of a {cluster}-CTA "
            f"cluster, {cluster_capacity(cluster)} positions "
            f"(DTW_MAX_SHARED_NPOS = {DTW_MAX_SHARED_NPOS} at DTW_CLUSTER = "
            f"{DTW_CLUSTER}); the global-state kernel takes it")
    nf = npos + 2
    per = max(2, -(-nf // cluster)) if nf > DTW_THREADS_MAX else nf
    spt = next(s for s in DTW_SPTS if -(-per // s) <= DTW_THREADS_MAX)
    per = -(-per // spt) * spt
    threads = -(-(per // spt) // 32) * 32
    return ClusterLayout(-(-nf // per), per, spt, threads)


def shared_state_bytes(npos: int, cluster: int = DTW_CLUSTER) -> int:
    """Dynamic shared memory of a CTA of the cluster kernel: its forward
    and back scores with their halos and f[0], double-buffered, over the
    span of its threads' states."""
    lay = cluster_layout(npos, cluster)
    return 4 * 2 * (2 * lay.threads * lay.spt + 5)


def move_back_penalty(prob_back: float) -> float:
    """log(prob_back) in float32; -inf for prob_back = 0, which leaves the
    back states unreachable, as in the scan."""
    with np.errstate(divide="ignore"):
        return float(np.log(np.float32(prob_back)))


def jumps(move_pen: torch.Tensor, local_pen: float):
    """(start_jump, end_jump) [npos+2] float32 on move_pen's device:
    start_jump[st] = move_pen[0] - local_pen * (st-1) for 2 <= st <= npos,
    end_jump[st] = move_pen[st] - local_pen * (npos-st) for 1 <= st < npos,
    -1e30 elsewhere."""
    nf = move_pen.shape[0]
    npos = nf - 2
    mp = move_pen.detach().cpu().double()
    lp = float(np.float32(local_pen))
    sj = torch.full((nf,), -LARGE, dtype=torch.float64)
    ej = torch.full((nf,), -LARGE, dtype=torch.float64)
    if npos > 1:
        k = torch.arange(1, npos, dtype=torch.float64)
        sj[2:nf - 1] = mp[0] - lp * k
        ej[1:npos] = mp[1:npos] - lp * k.flip(0)
    return (sj.float().to(move_pen.device), ej.float().to(move_pen.device))


def _check(sig, locs, scales, logscales, move_pen, stay_pen) -> None:
    npos = locs.shape[0]
    if sig.dim() != 1 or locs.dim() != 1 or npos < 1:
        raise ValueError(f"sig must be [T] and locs [npos >= 1], got "
                         f"{tuple(sig.shape)} and {tuple(locs.shape)}")
    for name, t, n in (("scales", scales, npos), ("logscales", logscales, npos),
                       ("move_pen", move_pen, npos + 2),
                       ("stay_pen", stay_pen, npos + 2)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected ({n},)")


def check_dtw_input(sig, locs, scales, logscales, move_pen, stay_pen) -> None:
    """Raise unless the inputs are what the kernel takes: contiguous
    float32 sig [T], locs/scales/logscales [npos], move/stay_pen [npos+2]."""
    _check(sig, locs, scales, logscales, move_pen, stay_pen)
    npos = locs.shape[0]
    ops.check_kernel_input("sig", sig, tuple(sig.shape))
    for name, t, n in (("locs", locs, npos), ("scales", scales, npos),
                       ("logscales", logscales, npos),
                       ("move_pen", move_pen, npos + 2),
                       ("stay_pen", stay_pen, npos + 2)):
        ops.check_kernel_input(name, t, (n,))


def emissions(x, locs, scales, logscales, minscore: float):
    """Floored Laplace log emissions [len(x), npos]:
    max(-minscore, (-|x - loc| / scale - logscale) - log 2)."""
    e = (-(x[:, None] - locs).abs()) / scales - logscales - LOG2
    return torch.maximum(e, e.new_tensor(-minscore))


def squiggle_match_plain(sig, locs, scales, logscales, move_pen, stay_pen,
                         prob_back, local_pen, skip_pen, minscore,
                         viterbi: bool = True):
    """Plain twin of the kernel (the scan of decode/dtw.py): sig [T] ->
    (final [2*npos+2], moves [T, 2*npos+2] uint8, end_src [T] int32), the
    last two None for the forward variant. For Viterbi the candidates of a
    state are stacked in the scan's order and the first maximum is taken,
    which is what its chain of strict `>` takes; its index is the move."""
    _check(sig, locs, scales, logscales, move_pen, stay_pen)
    T, npos = sig.shape[0], locs.shape[0]
    nf = npos + 2
    dev = sig.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    mbp, skip, local = f32(move_back_penalty(prob_back)), f32(skip_pen), f32(local_pen)
    sj, ej = jumps(move_pen, local_pen)
    # forward candidates: stay, step, skip, start, end, from back; back
    # candidates: stay, move back. Entries no move reaches stay -1e30
    # (-inf for the end row, which only the end state takes).
    cf = torch.full((6, nf), -LARGE, dtype=torch.float32, device=dev)
    cf[END] = -float("inf")
    cb = torch.full((2, npos), -LARGE, dtype=torch.float32, device=dev)

    f = torch.full((nf,), -LARGE, dtype=torch.float32, device=dev)
    f[0] = 0.0
    b = torch.full((npos,), -LARGE, dtype=torch.float32, device=dev)
    moves = (torch.empty((T, nf + npos), dtype=torch.uint8, device=dev)
             if viterbi else None)
    end_src = torch.empty(T, dtype=torch.int32, device=dev) if viterbi else None

    for t0 in range(0, T, EMIT_BLOCK):
        em_blk = emissions(sig[t0:t0 + EMIT_BLOCK], locs, scales, logscales,
                           minscore)
        for i in range(em_blk.shape[0]):
            torch.add(f, stay_pen, out=cf[STAY])
            torch.add(f[:-1], move_pen[:-1], out=cf[STEP, 1:])
            torch.sub(f[:-2] + move_pen[:-2], skip, out=cf[SKIP, 2:])
            torch.add(f[0], sj, out=cf[START])
            torch.add(b[:npos - 1], LOG_HALF, out=cf[BACK, 2:nf - 1])
            torch.add(b, LOG_HALF, out=cb[STAY])
            torch.add(f[2:nf - 1], mbp, out=cb[MOVE_BACK, :npos - 1])
            ev = f + ej
            if viterbi:
                # torch.max along a dimension returns the first maximum
                endc, esrc = ev.max(0)
                cf[END, nf - 1] = endc
                newf, kf = cf.max(0)
                newb, kb = cb.max(0)
                moves[t0 + i, :nf] = kf
                moves[t0 + i, nf:] = kb
                end_src[t0 + i] = esrc
            else:
                newf = cf[STAY]
                for k in (STEP, SKIP, START):
                    newf = ops.logaddexp(newf, cf[k])
                newf = newf.clone()
                newf[nf - 1] = ops.logaddexp(newf[nf - 1], ops.logsumexp(ev))
                newf = ops.logaddexp(newf, cf[BACK])
                newb = ops.logaddexp(cb[STAY], cb[MOVE_BACK])
            em = em_blk[i]
            newf[1:npos + 1] += em
            newf[::nf - 1] -= local
            f, b = newf, newb + em
    return torch.cat([f, b]), moves, end_src


def moves_to_states(moves, end_src):
    """The int32 state traceback [T, 2*npos+2] of the JAX package (each
    state's predecessor) from the moves [T, 2*npos+2] and end_src [T]."""
    T, nstate = moves.shape
    nf = (nstate + 2) // 2
    st = torch.arange(nf, dtype=torch.int32, device=moves.device)
    j = torch.arange(nstate - nf, dtype=torch.int32, device=moves.device)
    fwd = torch.stack([st, st - 1, st - 2, torch.zeros_like(st), st,
                       st + nf - 2])
    bwd = torch.stack([j + nf, j + 2])
    k = moves.long()
    states = torch.cat([fwd.gather(0, k[:, :nf]), bwd.gather(0, k[:, nf:])], 1)
    states[:, :nf] = torch.where(k[:, :nf] == END, end_src[:, None], states[:, :nf])
    return states


def dtw_walk_plain(final, moves, end_src):
    """Plain twin of the walk kernel, on the host: the last position's
    state if its final score beats the end state's, else the end state;
    then each earlier sample's state from the move that entered the later
    one. Returns path [T] int32 on final's device."""
    T, nstate = moves.shape
    nf = (nstate + 2) // 2
    fin = final.cpu().numpy()
    mv = moves.cpu().numpy()
    src = end_src.cpu().numpy()
    path = np.zeros(T, dtype=np.int32)
    if T == 0:
        return torch.from_numpy(path).to(final.device)
    cur = nf - 2 if fin[nf - 2] > fin[nf - 1] else nf - 1
    path[-1] = cur
    for s in range(T - 1, 0, -1):
        k = mv[s, cur]
        if cur >= nf:  # a back state: stay, or move back from cur - nf + 2
            cur = cur if k == STAY else cur - nf + 2
        elif k == STEP:
            cur -= 1
        elif k == SKIP:
            cur -= 2
        elif k == START:
            cur = 0
        elif k == END:
            cur = int(src[s])
        elif k == BACK:
            cur += nf - 2
        path[s - 1] = cur
    return torch.from_numpy(path).to(final.device)


def dtw_walk(final, moves, end_src):
    """The Viterbi path [T] int32 of a squiggle match from its final scores
    [2*npos+2], moves [T, 2*npos+2] uint8 and end_src [T] int32: on a CUDA
    tensor the walk kernel of csrc/dtw.cu, which leaves the traceback on
    the card, else `dtw_walk_plain`."""
    if not ops.on_cuda(final, moves, end_src):
        return dtw_walk_plain(final, moves, end_src)
    from scrappie_torch.ops import _build

    T, nstate = moves.shape
    ops.check_kernel_input("final", final, (nstate,))
    ops.check_kernel_input("moves", moves, (T, nstate), torch.uint8)
    ops.check_kernel_input("end_src", end_src, (T,), torch.int32)
    path = torch.empty(T, dtype=torch.int32, device=final.device)
    with torch.cuda.device(final.device):
        err = _build.library().scrappie_dtw_walk(
            final.data_ptr(), moves.data_ptr(), end_src.data_ptr(),
            path.data_ptr(), T, (nstate - 2) // 2,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "dtw_walk")
    ops.LAUNCHES["dtw_walk"] += 1
    return path


def squiggle_match_tm(sig, locs, scales, logscales, move_pen, stay_pen,
                      prob_back, local_pen, skip_pen, minscore,
                      viterbi: bool = True, global_state: bool | None = None,
                      cluster: int | None = None):
    """The squiggle-match DP of one read: sig [T] normalised samples;
    locs/scales/logscales [npos] (scales = exp(logscales)); move/stay_pen
    [npos+2] -> (final [2*npos+2], moves [T, 2*npos+2] uint8, end_src [T]
    int32; the last two None for the forward variant), states numbered as
    in decode/dtw.py. The kernel runs on a cluster of `cluster` CTAs
    (default DTW_CLUSTER) up to that cluster's capacity, and on one block
    with its states in global memory above it: a dispatch on the shape.
    global_state forces the global (True) or the cluster (False) kernel."""
    if not ops.on_cuda(sig, locs, scales, logscales, move_pen, stay_pen):
        return squiggle_match_plain(sig, locs, scales, logscales, move_pen,
                                    stay_pen, prob_back, local_pen, skip_pen,
                                    minscore, viterbi)
    from scrappie_torch.ops import _build

    check_dtw_input(sig, locs, scales, logscales, move_pen, stay_pen)
    T, npos = sig.shape[0], locs.shape[0]
    nstate = 2 * npos + 2
    cluster = DTW_CLUSTER if cluster is None else cluster
    if global_state is None:
        global_state = npos > cluster_capacity(cluster)
    lay = ClusterLayout(0, 0, 0, 0) if global_state else cluster_layout(npos, cluster)
    dev = sig.device
    sj, ej = jumps(move_pen, local_pen)
    final = torch.empty(nstate, dtype=torch.float32, device=dev)
    moves = (torch.empty((T, nstate), dtype=torch.uint8, device=dev)
             if viterbi else None)
    end_src = torch.empty(T, dtype=torch.int32, device=dev) if viterbi else None
    scratch = (torch.empty(2 * nstate, dtype=torch.float32, device=dev)
               if global_state else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _build.library().scrappie_dtw(
            sig.data_ptr(), locs.data_ptr(), scales.data_ptr(),
            logscales.data_ptr(), move_pen.data_ptr(), stay_pen.data_ptr(),
            sj.data_ptr(), ej.data_ptr(), ptr(scratch), final.data_ptr(),
            ptr(moves), ptr(end_src), T, npos, ops.f32(skip_pen),
            ops.f32(local_pen), ops.f32(minscore), move_back_penalty(prob_back),
            int(viterbi), lay.ncta, lay.threads, lay.per, lay.spt,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "dtw")
    ops.LAUNCHES["dtw"] += 1
    return final, moves, end_src


def max_active_clusters(npos: int, cluster: int = DTW_CLUSTER,
                        viterbi: bool = True) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel at npos
    positions: how many such clusters the card holds at once (0: none)."""
    from scrappie_torch.ops import _build

    lay = cluster_layout(npos, cluster)
    n = _build.library().scrappie_dtw_max_clusters(int(viterbi), lay.ncta,
                                                   lay.threads, lay.per, lay.spt)
    if n < 0:
        _build.check(-n, "dtw max active clusters")
    return n
