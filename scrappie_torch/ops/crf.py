"""CRF decoding for the rnnrf head: Viterbi forward, backtrace, the log
partition function with its gradient, and the forward-backward posterior.

Counterpart of scrappie_tpu/ops/crf.py (crf_viterbi_scores_tm,
crf_backtrace_tm, crf_viterbi_kernel), of the lax.scan program
scrappie_tpu/decode/crf.py:_crf_viterbi, whose tie rule the plain twins
copy (for each `to`, the first maximum over `from`, by strict `>`), and of
the partition-function scan of scrappie_tpu/nn/layers.py, which has no TPU
kernel, and of the scans that have none either: its VJP (CrfPartition's
backward, the edge marginals) and scrappie_tpu/decode/crf.py:_crf_posterior
(crf_posterior_tm, the state marginals), both the same two walks and a
marginal pass (crf_fwdbwd_plain, then crf_state_marginals_plain or
crf_edge_marginals_plain).

On a CUDA tensor each wrapper launches its kernel from csrc/crf.cu; on a
CPU tensor it runs its `*_plain` twin. Layouts: transitions are
time-major, trans [T, B, 25] with entry to*5 + from; the forward gives
final [B, 5] f32 and a traceback [T, 5, B] int8 (the TPU kernel's
[T, 8, B] without its padding rows), the backtrace score [B] and path
[B, T+1] int32, the posterior [B, T+1, 5] and the partition's gradient
[T, B, 25]. There is no lane, batch or time padding.
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


def crf_fwdbwd_plain(trans_tm):
    """The forward and backward log scores of the CRF, each less its
    maximum over the states at every boundary, plain loops over time:
    trans [T, B, 25] -> (a [T+1, B, 5], b [T+1, B, 5]) with alpha_0 =
    beta_T = 0, alpha_{t+1}[to] = lse over `from` of trans[t, to, from] +
    a_t[from], beta_t[from] = lse over `to` of trans[t, to, from] +
    b_{t+1}[to], a_t = alpha_t - max alpha_t, b_t = beta_t - max beta_t.
    The marginals are softmaxes in which these offsets cancel, and the
    normalised scores keep float32 precision where alpha and beta would grow
    with T (the kernels' note in csrc/crf.cu). Plain twin of crf_walk_kernel
    (whose scores differ from these by rounding alone)."""
    _check_trans(trans_tm)
    T, B, _ = trans_tm.shape
    tmat = trans_tm.reshape(T, B, NS, NS)  # [T, B, to, from]
    norm = lambda v: v - v.amax(-1, keepdim=True)
    v = trans_tm.new_zeros((B, NS))
    a = []
    for t in range(T):
        a.append(norm(v))
        v = torch.logsumexp(tmat[t] + a[-1][:, None, :], dim=-1)
    a.append(norm(v))
    b = [trans_tm.new_zeros((B, NS))]
    for t in range(T - 1, -1, -1):
        b.append(norm(torch.logsumexp(tmat[t] + b[-1][:, :, None], dim=-2)))
    return torch.stack(a), torch.stack(b[::-1])


def crf_state_marginals_plain(a, b):
    """Plain twin of the marginal pass of the posterior: the walks' scores
    a, b [T+1, B, 5] -> softmax over the states of a_t + b_t, [B, T+1, 5]."""
    return torch.softmax(a + b, dim=-1).transpose(0, 1).contiguous()


def crf_edge_marginals_plain(trans_tm, a, b, g):
    """Plain twin of the marginal pass of the gradient: trans [T, B, 25],
    the walks' scores a, b [T+1, B, 5], g [B] -> each block's edge
    marginals, the softmax over its 25 (to, from) of a_t[from] +
    (trans[t, to, from] + b_{t+1}[to]), times g[b], [T, B, 25]."""
    T, B, _ = trans_tm.shape
    v = a[:-1, :, None, :] + (trans_tm.reshape(T, B, NS, NS)
                              + b[1:, :, :, None])
    edge = torch.softmax(v.reshape(T, B, NS * NS), dim=-1)
    return edge * g[:, None]


def crf_posterior_tm_plain(trans_tm):
    """Plain twin of the forward-backward kernels' posterior: trans
    [T, B, 25] -> softmax over the states of a_t + b_t, [B, T+1, 5]
    (scrappie_tpu/decode/crf.py:_crf_posterior)."""
    return crf_state_marginals_plain(*crf_fwdbwd_plain(trans_tm))


def crf_partition_grad_tm_plain(trans_tm, g):
    """Plain twin of the forward-backward kernels' gradient: trans
    [T, B, 25], g [B] (the gradient of logZ) -> d logZ / d trans times g,
    [T, B, 25]: each block's edge marginals times g[b]."""
    return crf_edge_marginals_plain(trans_tm, *crf_fwdbwd_plain(trans_tm), g)


def _fwdbwd(trans_tm, g, out, mode: int, name: str):
    """Launch the forward-backward in `mode` into `out`: the two walks at
    once (crf_walk_kernel), then the marginal pass; one C call, counted as
    one launch of `name`."""
    from scrappie_torch.ops import _build

    T, B, _ = trans_tm.shape
    if B == 0:
        return out
    # the walks' scores, in the marginal pass's order: [B, T+1, 5] for the
    # posterior, [T+1, B, 5] for the gradient
    a, b = torch.empty((2, (T + 1) * B * NS), dtype=torch.float32,
                       device=trans_tm.device)
    with torch.cuda.device(trans_tm.device):
        err = _build.library().scrappie_crf_fwdbwd(
            trans_tm.data_ptr(), g.data_ptr() if g is not None else None,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), T, B, mode,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return out


def crf_posterior_tm(trans_tm):
    """Forward-backward state posterior (ref posterior_crf,
    src/decode.c:928-1012) of time-major transitions [T, B, 25] ->
    probabilities [B, T+1, 5], one row per block boundary."""
    if not ops.on_cuda(trans_tm):
        return crf_posterior_tm_plain(trans_tm)
    check_trans_input(trans_tm)
    T, B, _ = trans_tm.shape
    post = torch.empty((B, T + 1, NS), dtype=torch.float32,
                       device=trans_tm.device)
    return _fwdbwd(trans_tm, None, post, 0, "crf_posterior")


def check_partition_grad_input(trans_tm, g) -> None:
    """Raise unless the forward-backward kernels take these inputs for the
    gradient: contiguous float32 trans [T, B, 25] and g [B]."""
    check_trans_input(trans_tm)
    ops.check_kernel_input("g", g, (trans_tm.shape[1],))


def crf_partition_grad_tm(trans_tm, g):
    """The gradient of the log partition function times the incoming one:
    trans [T, B, 25], g [B] -> [T, B, 25], each block's edge marginals
    times g (the VJP of crf_partition_tm)."""
    if not ops.on_cuda(trans_tm, g):
        return crf_partition_grad_tm_plain(trans_tm, g)
    check_partition_grad_input(trans_tm, g)
    grad = torch.empty_like(trans_tm)
    return _fwdbwd(trans_tm, g, grad, 1, "crf_partition_grad")


class CrfPartition(torch.autograd.Function):
    """logZ [B] of time-major transitions [T, B, 25], differentiable: the
    forward is crf_partition_tm (the partition kernel on the card), the
    backward crf_partition_grad_tm (the forward-backward kernel)."""

    @staticmethod
    def forward(ctx, trans_tm):
        ctx.save_for_backward(trans_tm)
        return crf_partition_tm(trans_tm)

    @staticmethod
    def backward(ctx, g):
        (trans_tm,) = ctx.saved_tensors
        return crf_partition_grad_tm(trans_tm, g.contiguous())


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
