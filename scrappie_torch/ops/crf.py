"""CRF decoding for the rnnrf head: Viterbi forward, backtrace, and the log
partition function.

Counterpart of scrappie_tpu/ops/crf.py (crf_viterbi_scores_tm,
crf_backtrace_tm, crf_viterbi_kernel), of the lax.scan program
scrappie_tpu/decode/crf.py:_crf_viterbi, whose tie rule the plain twins
copy (for each `to`, the first maximum over `from`, by strict `>`), and of
the partition-function scan of scrappie_tpu/nn/layers.py, which has no TPU
kernel.

On a CUDA tensor each wrapper launches its kernel from csrc/crf.cu; on a
CPU tensor it runs its `*_plain` twin. Layouts: transitions are
time-major, trans [T, B, 25] with entry to*5 + from; the forward gives
final [B, 5] f32 and a traceback [T, 5, B] int8 (the TPU kernel's
[T, 8, B] without its padding rows), the backtrace score [B] and path
[B, T+1] int32. There is no lane, batch or time padding.
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn.layers import crf_partition_function

NS = 5


def _check_trans(trans_tm) -> None:
    if trans_tm.dim() != 3 or trans_tm.shape[2] != NS * NS:
        raise ValueError(f"transitions must be [T, B, {NS * NS}], got "
                         f"{tuple(trans_tm.shape)}")


def check_trans_input(trans_tm) -> None:
    """Raise unless trans is what the forward and partition kernels take:
    contiguous float32 [T, B, 25]."""
    _check_trans(trans_tm)
    ops.check_kernel_input("trans", trans_tm, tuple(trans_tm.shape))


def check_traceback_input(final, tb_tm) -> None:
    """Raise unless (final, tb) is what the backtrace kernel takes:
    contiguous float32 [B, 5] and int8 [T, 5, B]."""
    T, _, B = tb_tm.shape
    ops.check_kernel_input("final", final, (B, NS))
    ops.check_kernel_input("tb", tb_tm, (T, NS, B), torch.int8)


def add_emit_bias(trans, emit_bias: float):
    """trans [..., 25] with `emit_bias` added to the 20 transitions into an
    emitting state (entries to*5 + from with to < 4), as
    scrappie_tpu/decode/crf.py:decode_crf does; a new tensor."""
    if not emit_bias:
        return trans
    bias = torch.zeros(NS * NS, dtype=trans.dtype, device=trans.device)
    bias[: (NS - 1) * NS] = emit_bias
    return trans + bias


def crf_viterbi_scores_tm_plain(trans_tm):
    """Plain twin of the forward kernel: trans [T, B, 25] -> (final [B, 5],
    tb [T, 5, B] int8)."""
    _check_trans(trans_tm)
    T, B, _ = trans_tm.shape
    dev = trans_tm.device
    tmat = trans_tm.reshape(T, B, NS, NS)  # [T, B, to, from]
    prev = torch.zeros((B, NS), dtype=torch.float32, device=dev)
    tb = torch.empty((T, NS, B), dtype=torch.int8, device=dev)
    for t in range(T):
        cand = tmat[t] + prev[:, None, :]
        best = cand[..., 0]
        frm = torch.zeros((B, NS), dtype=torch.int8, device=dev)
        for f in range(1, NS):
            upd = cand[..., f] > best
            best = torch.where(upd, cand[..., f], best)
            frm = torch.where(upd, f, frm)
        prev = best
        tb[t] = frm.T
    return prev.contiguous(), tb


def crf_backtrace_tm_plain(final, tb_tm):
    """Plain twin of the backtrace kernel: final [B, 5], tb [T, 5, B] ->
    (score [B], path [B, T+1] int32), from the first best final state."""
    T, _, B = tb_tm.shape
    score, cur = ops.first_argmax(final, 1)
    rows = torch.arange(B, device=final.device)
    path = torch.empty((B, T + 1), dtype=torch.int64, device=final.device)
    for t in range(T - 1, -1, -1):
        path[:, t + 1] = cur
        cur = tb_tm[t, cur, rows].long()
    path[:, 0] = cur
    return score, path.int()


def crf_partition_tm_plain(trans_tm):
    """Plain twin of the partition kernel: trans [T, B, 25] -> logZ [B]."""
    _check_trans(trans_tm)
    return crf_partition_function(trans_tm.transpose(0, 1))


def crf_viterbi_scores_tm(trans_tm):
    """Forward CRF Viterbi over time-major transitions [T, B, 25] ->
    (final [B, 5] f32, tb [T, 5, B] int8)."""
    if not ops.on_cuda(trans_tm):
        return crf_viterbi_scores_tm_plain(trans_tm)
    from scrappie_torch.ops import _build

    check_trans_input(trans_tm)
    T, B, _ = trans_tm.shape
    final = torch.empty((B, NS), dtype=torch.float32, device=trans_tm.device)
    tb = torch.empty((T, NS, B), dtype=torch.int8, device=trans_tm.device)
    if B == 0:
        return final, tb
    with torch.cuda.device(trans_tm.device):
        err = _build.library().scrappie_crf_fwd(
            trans_tm.data_ptr(), final.data_ptr(), tb.data_ptr(), T, B,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "crf_fwd")
    ops.LAUNCHES["crf_fwd"] += 1
    return final, tb


def crf_backtrace_tm(final, tb_tm):
    """Walk the CRF traceback (ref src/decode.c:877-893): final [B, 5], tb
    [T, 5, B] int8 -> (score [B], path [B, T+1] int32)."""
    if not ops.on_cuda(final, tb_tm):
        return crf_backtrace_tm_plain(final, tb_tm)
    from scrappie_torch.ops import _build

    check_traceback_input(final, tb_tm)
    T, _, B = tb_tm.shape
    score = torch.empty(B, dtype=torch.float32, device=final.device)
    path = torch.empty((B, T + 1), dtype=torch.int32, device=final.device)
    if B == 0:
        return score, path
    with torch.cuda.device(final.device):
        err = _build.library().scrappie_crf_backtrace(
            final.data_ptr(), tb_tm.data_ptr(), score.data_ptr(),
            path.data_ptr(), T, B, ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "crf_backtrace")
    ops.LAUNCHES["crf_backtrace"] += 1
    return score, path


def crf_partition_tm(trans_tm):
    """Log partition function of the linear CRF (ref src/layers.c:835-871)
    over time-major transitions [T, B, 25] -> logZ [B]."""
    if not ops.on_cuda(trans_tm):
        return crf_partition_tm_plain(trans_tm)
    from scrappie_torch.ops import _build

    check_trans_input(trans_tm)
    T, B, _ = trans_tm.shape
    logz = torch.empty(B, dtype=torch.float32, device=trans_tm.device)
    if B == 0:
        return logz
    with torch.cuda.device(trans_tm.device):
        err = _build.library().scrappie_crf_partition(
            trans_tm.data_ptr(), logz.data_ptr(), T, B,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "crf_partition")
    ops.LAUNCHES["crf_partition"] += 1
    return logz


def crf_viterbi_tm(trans_tm):
    """Forward and backtrace: trans [T, B, 25] -> (score [B], path
    [B, T+1] int32); the kernels for a CUDA tensor, the twins for a CPU
    one, with identical results."""
    return crf_backtrace_tm(*crf_viterbi_scores_tm(trans_tm))


def crf_viterbi_kernel(trans):
    """Counterpart of scrappie_tpu/ops/crf.py:crf_viterbi_kernel (and of
    decode/crf.py:_crf_viterbi): batch-major trans [B, T, 25] -> (score
    [B], path [B, T+1] int32)."""
    return crf_viterbi_tm(trans.transpose(0, 1).contiguous())
