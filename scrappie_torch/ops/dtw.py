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

On a CUDA tensor `squiggle_match_tm` launches the kernel of csrc/dtw.cu
(state in shared memory up to DTW_MAX_SHARED_NPOS positions, in global
memory above); on a CPU tensor it runs `squiggle_match_plain`. Outputs:
final [2*npos+2] f32 and, for Viterbi, a traceback [T, 2*npos+2] int32
(None for the forward variant). There is no lane or time padding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from scrappie_torch import ops

LARGE = 1.0e30
LOG_HALF = float(np.float32(np.log(0.5)))
LOG2 = float(np.float32(np.log(2.0)))
#: Samples whose emissions the twin computes at once.
EMIT_BLOCK = 256
#: Bytes of static shared memory the kernel keeps for its reductions.
_RED_BYTES = 1024


def shared_state_bytes(npos: int) -> int:
    """Dynamic shared memory of the kernel's shared-state variant: the
    forward and back scores, double-buffered."""
    return 4 * 2 * (2 * npos + 2)


#: Largest npos whose state the kernel keeps in shared memory.
DTW_MAX_SHARED_NPOS = ((ops.MAX_SMEM_BYTES - _RED_BYTES) // 8 - 2) // 2


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
    (final [2*npos+2], tb [T, 2*npos+2] int32 or None). For Viterbi the
    candidates of a state are stacked in the scan's order and the first
    maximum is taken, which is what its chain of strict `>` takes."""
    _check(sig, locs, scales, logscales, move_pen, stay_pen)
    T, npos = sig.shape[0], locs.shape[0]
    nf = npos + 2
    dev = sig.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    mbp, skip, local = f32(move_back_penalty(prob_back)), f32(skip_pen), f32(local_pen)
    sj, ej = jumps(move_pen, local_pen)
    lanes = torch.arange(nf, dtype=torch.int32, device=dev)
    back = torch.arange(npos, dtype=torch.int32, device=dev)
    # forward candidates: stay, step, skip, start, end, from back; back
    # candidates: stay, move back. Entries no move reaches stay -1e30
    # (-inf for the end row, which only the end state takes).
    cf = torch.full((6, nf), -LARGE, dtype=torch.float32, device=dev)
    cf[4] = -float("inf")
    cb = torch.full((2, npos), -LARGE, dtype=torch.float32, device=dev)
    tb_f = torch.stack([lanes, lanes - 1, lanes - 2, torch.zeros_like(lanes),
                        lanes, lanes + nf - 2])
    tb_b = torch.stack([back + nf, back + 2])

    f = torch.full((nf,), -LARGE, dtype=torch.float32, device=dev)
    f[0] = 0.0
    b = torch.full((npos,), -LARGE, dtype=torch.float32, device=dev)
    tb = (torch.empty((T, nf + npos), dtype=torch.int32, device=dev)
          if viterbi else None)

    for t0 in range(0, T, EMIT_BLOCK):
        em_blk = emissions(sig[t0:t0 + EMIT_BLOCK], locs, scales, logscales,
                           minscore)
        for i in range(em_blk.shape[0]):
            torch.add(f, stay_pen, out=cf[0])
            torch.add(f[:-1], move_pen[:-1], out=cf[1, 1:])
            torch.sub(f[:-2] + move_pen[:-2], skip, out=cf[2, 2:])
            torch.add(f[0], sj, out=cf[3])
            torch.add(b[:npos - 1], LOG_HALF, out=cf[5, 2:nf - 1])
            torch.add(b, LOG_HALF, out=cb[0])
            torch.add(f[2:nf - 1], mbp, out=cb[1, :npos - 1])
            ev = f + ej
            if viterbi:
                # torch.max along a dimension returns the first maximum
                endc, esrc = ev.max(0)
                cf[4, nf - 1] = endc
                tb_f[4, nf - 1] = esrc
                newf, kf = cf.max(0)
                newb, kb = cb.max(0)
                tb[t0 + i, :nf] = tb_f.gather(0, kf[None])[0]
                tb[t0 + i, nf:] = tb_b.gather(0, kb[None])[0]
            else:
                newf = cf[0]
                for k in (1, 2, 3):
                    newf = ops.logaddexp(newf, cf[k])
                newf = newf.clone()
                newf[nf - 1] = ops.logaddexp(newf[nf - 1], ops.logsumexp(ev))
                newf = ops.logaddexp(newf, cf[5])
                newb = ops.logaddexp(cb[0], cb[1])
            em = em_blk[i]
            newf[1:npos + 1] += em
            newf[::nf - 1] -= local
            f, b = newf, newb + em
    return torch.cat([f, b]), tb


def squiggle_match_tm(sig, locs, scales, logscales, move_pen, stay_pen,
                      prob_back, local_pen, skip_pen, minscore,
                      viterbi: bool = True, global_state: bool | None = None):
    """The squiggle-match DP of one read: sig [T] normalised samples;
    locs/scales/logscales [npos] (scales = exp(logscales)); move/stay_pen
    [npos+2] -> (final [2*npos+2], tb [T, 2*npos+2] int32, or None for the
    forward variant), states numbered as in decode/dtw.py. global_state
    forces the kernel's state into global (True) or shared (False) memory;
    by default it is shared up to DTW_MAX_SHARED_NPOS positions."""
    if not ops.on_cuda(sig, locs, scales, logscales, move_pen, stay_pen):
        return squiggle_match_plain(sig, locs, scales, logscales, move_pen,
                                    stay_pen, prob_back, local_pen, skip_pen,
                                    minscore, viterbi)
    from scrappie_torch.ops import _build

    check_dtw_input(sig, locs, scales, logscales, move_pen, stay_pen)
    T, npos = sig.shape[0], locs.shape[0]
    nstate = 2 * npos + 2
    shared = npos <= DTW_MAX_SHARED_NPOS if global_state is None else not global_state
    if shared and npos > DTW_MAX_SHARED_NPOS:
        raise ValueError(f"npos={npos} does not fit in shared memory "
                         f"(at most {DTW_MAX_SHARED_NPOS})")
    dev = sig.device
    sj, ej = jumps(move_pen, local_pen)
    final = torch.empty(nstate, dtype=torch.float32, device=dev)
    tb = (torch.empty((T, nstate), dtype=torch.int32, device=dev)
          if viterbi else None)
    scratch = (None if shared else
               torch.empty(2 * nstate, dtype=torch.float32, device=dev))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _build.library().scrappie_dtw(
            sig.data_ptr(), locs.data_ptr(), scales.data_ptr(),
            logscales.data_ptr(), move_pen.data_ptr(), stay_pen.data_ptr(),
            sj.data_ptr(), ej.data_ptr(), ptr(scratch), final.data_ptr(),
            ptr(tb), T, npos, ops.f32(skip_pen), ops.f32(local_pen),
            ops.f32(minscore),
            move_back_penalty(prob_back), int(viterbi), int(shared),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "dtw")
    ops.LAUNCHES["dtw"] += 1
    return final, tb
