"""Transducer Viterbi: forward, fused head + forward, and backtrace.

Counterpart of scrappie_tpu/ops/viterbi.py (viterbi_scores_tm,
viterbi_fused_tm, viterbi_backtrace_tm) and of the lax.scan programs in
scrappie_tpu/decode/transducer.py, whose semantics and tie rules the
plain twins here copy step for step:

  * candidates contend in the order stay, step, skip, slip, start-exit,
    each with a strict `>`;
  * within a predecessor group the first maximum wins;
  * END is entered from the first best history state.

On a CUDA tensor each wrapper launches its kernel from csrc/viterbi.cu;
on a CPU tensor it runs its `*_plain` twin. Layouts are time-major, as in
the JAX wrappers: lp [T, B, nhist+1] -> final [B, nhist+2] f32 and a
traceback [T, B, nhist+2] int16.
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn.layers import robustlog, softmax_with_temperature

BIG = 1.0e30


def _check_nhist(nhist: int, use_slip: bool) -> None:
    group = 64 if use_slip else 16
    if nhist % group:
        raise ValueError(f"nhist={nhist} not divisible by {group}")


def viterbi_scores_tm_plain(lp_tm, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                            use_slip: bool = False):
    """Plain twin of the forward kernel (decode/transducer.py's scan)."""
    T, B, nstate = lp_tm.shape
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    START, END = nhist, nhist + 1
    stay_pen, skip_pen, local_pen = map(ops.f32, (stay_pen, skip_pen, local_pen))
    dev = lp_tm.device
    lp_tm = torch.clamp(lp_tm, min=-BIG)

    hist = torch.full((B, nhist), -BIG, dtype=torch.float32, device=dev)
    start = torch.zeros(B, dtype=torch.float32, device=dev)
    end = torch.full((B,), -BIG, dtype=torch.float32, device=dev)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=dev)
    tb[:, :, START] = START
    moves = [(4, None), (16, skip_pen)]
    if use_slip:
        moves.append((64, 2.0 * skip_pen))
    groups = {n: torch.arange(nhist // n, device=dev).repeat_interleave(n)
              for n, _ in moves}

    for t in range(T):
        lph = lp_tm[t, :, :nhist]
        stay_lp = lp_tm[t, :, nhist] - stay_pen
        score = hist + stay_lp[:, None]
        tbt = torch.full((B, nhist), -1, dtype=torch.int64, device=dev)
        for n, pen in moves:
            q = nhist // n
            m, r = ops.first_argmax(hist.view(B, n, q), 1)
            cand = lph + m.repeat_interleave(n, dim=1)
            if pen is not None:
                cand = cand - pen
            pred = r.repeat_interleave(n, dim=1) * q + groups[n]
            upd = cand > score
            score = torch.where(upd, cand, score)
            tbt = torch.where(upd, pred, tbt)
        cand = start[:, None] + lph
        upd = cand > score
        score = torch.where(upd, cand, score)
        tbt = torch.where(upd, START, tbt)

        local_stay = torch.clamp(stay_lp, min=-local_pen)
        end_score = end + local_stay
        m, entb = ops.first_argmax(hist, 1)
        enter = m - local_pen
        better = enter > end_score
        end = torch.where(better, enter, end_score)
        start = start + local_stay
        hist = score
        tb[t, :, :nhist] = tbt
        tb[t, :, END] = torch.where(better, entb, END)
    final = torch.cat([hist, start[:, None], end[:, None]], dim=1)
    return final, tb


def viterbi_backtrace_tm_plain(final, tb_tm):
    """Plain twin of the backtrace kernel: final [B, nhist+2], tb
    [T, B, nhist+2] -> (score [B], path [B, T+1] int32), stay = -1, the
    leading START and trailing END runs transcoded to -1."""
    T, B, nst2 = tb_tm.shape
    START, END = nst2 - 2, nst2 - 1
    score, cur = ops.first_argmax(final, 1)
    path = torch.empty((B, T + 1), dtype=torch.int64, device=final.device)
    for t in range(T - 1, -1, -1):
        state = tb_tm[t].gather(1, cur[:, None])[:, 0].long()
        emit = state >= 0
        path[:, t + 1] = torch.where(emit, cur, -1)
        cur = torch.where(emit, state, cur)
    path[:, 0] = cur
    lead = (path == START).int().cumprod(1).bool()
    trail = (path == END).flip(1).int().cumprod(1).flip(1).bool()
    path = torch.where(lead | trail, -1, path)
    return score, path.int()


def viterbi_fused_tm_plain(h_tm, W, bvec, min_prob=1e-5, tempW=1.0, tempb=1.0,
                           stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                           use_slip: bool = False):
    """Plain twin of the fused kernel: the head (temperature softmax and
    robustlog), then the forward twin."""
    lp = robustlog(softmax_with_temperature(h_tm, W, bvec, tempW, tempb),
                   min_prob)
    return viterbi_scores_tm_plain(lp, stay_pen, skip_pen, local_pen, use_slip)


def viterbi_scores_tm(lp_tm, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                      use_slip: bool = False):
    """Forward Viterbi over time-major log posteriors [T, B, nhist+1] ->
    (final [B, nhist+2] f32, tb [T, B, nhist+2] int16). lp is clamped at
    -1e30, as the JAX kernel does."""
    if not ops.on_cuda(lp_tm):
        return viterbi_scores_tm_plain(lp_tm, stay_pen, skip_pen, local_pen,
                                       use_slip)
    from scrappie_torch.ops import _build

    T, B, nstate = lp_tm.shape
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    _check_kernel_nhist(nhist)
    ops.check_kernel_input("lp", lp_tm, (T, B, nstate))
    final = torch.empty((B, nhist + 2), dtype=torch.float32, device=lp_tm.device)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=lp_tm.device)
    if B == 0:
        return final, tb
    with torch.cuda.device(lp_tm.device):
        err = _build.library().scrappie_viterbi_fwd(
            lp_tm.data_ptr(), final.data_ptr(), tb.data_ptr(), T, B, nhist,
            ops.f32(stay_pen), ops.f32(skip_pen), ops.f32(local_pen), int(use_slip),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_fwd")
    ops.LAUNCHES["viterbi_fwd"] += 1
    return final, tb


def viterbi_backtrace_tm(final, tb_tm):
    """Walk the time-major traceback (ref src/decode.c:58-98): final
    [B, nhist+2], tb [T, B, nhist+2] int16 -> (score [B], path [B, T+1]
    int32)."""
    if not ops.on_cuda(final, tb_tm):
        return viterbi_backtrace_tm_plain(final, tb_tm)
    from scrappie_torch.ops import _build

    T, B, nst2 = tb_tm.shape
    ops.check_kernel_input("final", final, (B, nst2))
    ops.check_kernel_input("tb", tb_tm, (T, B, nst2), torch.int16)
    score = torch.empty(B, dtype=torch.float32, device=final.device)
    path = torch.empty((B, T + 1), dtype=torch.int32, device=final.device)
    if B == 0:
        return score, path
    with torch.cuda.device(final.device):
        err = _build.library().scrappie_viterbi_backtrace(
            final.data_ptr(), tb_tm.data_ptr(), score.data_ptr(),
            path.data_ptr(), T, B, nst2, ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_backtrace")
    ops.LAUNCHES["viterbi_backtrace"] += 1
    return score, path


def viterbi_fused_tm(h_tm, W, bvec, min_prob=1e-5, tempW=1.0, tempb=1.0,
                     stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                     use_slip: bool = False):
    """Posterior head fused into the forward Viterbi: h [T, B, S], W
    [S, nstate], bvec [nstate] -> (final [B, nhist+2], tb [T, B, nhist+2]
    int16). The [T, B, nstate] posterior never reaches device memory."""
    if not ops.on_cuda(h_tm, W, bvec):
        return viterbi_fused_tm_plain(h_tm, W, bvec, min_prob, tempW, tempb,
                                      stay_pen, skip_pen, local_pen, use_slip)
    from scrappie_torch.ops import _build

    T, B, S = h_tm.shape
    nstate = W.shape[1]
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    _check_kernel_nhist(nhist)
    ops.check_kernel_input("h", h_tm, (T, B, S))
    ops.check_kernel_input("W", W, (S, nstate))
    ops.check_kernel_input("bvec", bvec, (nstate,))
    final = torch.empty((B, nhist + 2), dtype=torch.float32, device=h_tm.device)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=h_tm.device)
    if B == 0:
        return final, tb
    with torch.cuda.device(h_tm.device):
        err = _build.library().scrappie_viterbi_fused(
            h_tm.data_ptr(), W.data_ptr(), bvec.data_ptr(), final.data_ptr(),
            tb.data_ptr(), T, B, S, nhist, tempb / tempW, tempb,
            min_prob / nstate, 1.0 - min_prob, ops.f32(stay_pen), ops.f32(skip_pen),
            ops.f32(local_pen), int(use_slip),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_fused")
    ops.LAUNCHES["viterbi_fused"] += 1
    return final, tb


def _check_kernel_nhist(nhist: int) -> None:
    if nhist % 32 or not 64 <= nhist <= 1024:
        raise ValueError(f"the Viterbi kernels take 64 <= nhist <= 1024, a "
                         f"multiple of 32; got nhist={nhist}")
