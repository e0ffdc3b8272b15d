"""CRF decoding: Viterbi and the forward-backward posterior.

Counterpart of scrappie_tpu/decode/crf.py (behavioural spec: ref
src/decode.c:836-1012). States are {A, C, G, T, blank}; transitions
[T, 25], entry [t, to*5 + from] the energy of moving from -> to at block t
(log-space, globally normalised upstream). The Viterbi decode and the
posterior run the CRF kernels for a CUDA tensor and their plain twins for a
CPU one (ops/crf.py).

impl="assoc" takes the parallel-in-time form instead (scrappie_tpu's
_crf_viterbi_assoc and _crf_posterior_assoc): prefix products of the 5 x 5
transition matrices in the (max, +) or (logsumexp, +) semiring, composed in
log depth by `associative_scan`, which combines the elements in the same
order as jax.lax.associative_scan. It is plain PyTorch on either device:
the JAX package computes it outside any Pallas kernel. Its scores differ
from the sequential scan's by the reassociation of float sums, and its
paths agree except on exact ties.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch import ops
from scrappie_torch.device import float_tensor
from scrappie_torch.ops.crf import add_emit_bias, crf_posterior_tm, crf_viterbi_tm

NBASE = 4


def _check_impl(impl: str | None) -> None:
    if impl not in (None, "scan", "kernel", "assoc"):
        raise ValueError(f"unknown impl {impl!r}")


def associative_scan(fn, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of x along its first axis with the associative
    fn(earlier, later), in log depth: jax.lax.associative_scan's recursion
    (pairs combined, the odd elements scanned by recursion, the even ones
    from them), so the elements are combined in JAX's order. reverse scans
    from the end, and fn then gets (later, earlier), as in JAX."""
    if reverse:
        return _scan(fn, x.flip(0)).flip(0)
    return _scan(fn, x)


def _scan(fn, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if n < 2:
        return x
    odd = _scan(fn, fn(x[0 : n - 1 : 2], x[1::2]))
    even = fn(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    out = torch.empty_like(x)
    out[0::2] = torch.cat([x[:1], even])
    out[1::2] = odd
    return out


def _maxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(b after a)[to, from] = max_k b[to, k] + a[k, from]."""
    return (b[..., :, :, None] + a[..., None, :, :]).amax(-2)


def _logplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(b after a)[to, from] = logsumexp_k b[to, k] + a[k, from]
    (jax.nn.logsumexp's formula)."""
    return ops.logsumexp(b[..., :, :, None] + a[..., None, :, :], -2).squeeze(-2)


def crf_viterbi_assoc_tm(t_tm: torch.Tensor):
    """Parallel-in-time Viterbi: transitions [T, B, 25] -> (score [B], path
    [B, T+1] int32). The alphas are the max-plus prefix products' row
    maxima; each step's backpointers come from them at once; the path from
    the suffix composition of the pointer maps."""
    T, B, nsq = t_tm.shape
    ns = int(round(nsq ** 0.5))
    tmat = t_tm.reshape(T, B, ns, ns)  # [T, B, to, from]
    prefix = associative_scan(_maxplus, tmat)
    alpha = torch.cat([tmat.new_zeros((1, B, ns)), prefix.amax(-1)])  # [T+1, B, to]
    score, last = ops.first_argmax(alpha[T], -1)
    _, bt = ops.first_argmax(tmat + alpha[:T, :, None, :], -1)  # [T, B, to]
    # C_t = bt_t o ... o bt_{T-1}: with reverse, fn(later, earlier)
    maps = associative_scan(lambda g, f: torch.gather(f, -1, g), bt,
                            reverse=True)
    body = torch.gather(maps, -1, last.expand(T, B)[..., None])[..., 0]
    path = torch.cat([body, last[None]]).transpose(0, 1)
    return score, path.to(torch.int32)


def crf_posterior_assoc_tm(t_tm: torch.Tensor) -> torch.Tensor:
    """Parallel-in-time forward-backward: transitions [T, B, 25] ->
    posterior [B, T+1, 5], from the logsumexp prefix and suffix products."""
    T, B, nsq = t_tm.shape
    ns = int(round(nsq ** 0.5))
    tmat = t_tm.reshape(T, B, ns, ns)
    zero = tmat.new_zeros((1, B, ns))
    prefix = associative_scan(_logplus, tmat)
    fwd = torch.cat([zero, ops.logsumexp(prefix, -1).squeeze(-1)])
    suffix = associative_scan(lambda b, a: _logplus(a, b), tmat, reverse=True)
    bwd = torch.cat([ops.logsumexp(suffix, -2).squeeze(-2), zero])
    return torch.softmax(fwd + bwd, dim=-1).transpose(0, 1)


def _batched(trans, device) -> tuple[torch.Tensor, bool]:
    """[T, 25] or [B, T, 25], numpy or a tensor -> ([B, T, 25] float32,
    whether a batch axis was added). numpy goes to `device`, a tensor stays
    on its own."""
    t = float_tensor(trans, device)
    squeeze = t.dim() == 2
    return (t[None] if squeeze else t), squeeze


def decode_crf(trans, impl: str | None = None, emit_bias: float = 0.0,
               device=None):
    """Viterbi decode of CRF transitions (ref decode_crf,
    src/decode.c:836-893): trans [T, 25] or [B, T, 25] -> (score, path
    [.., T+1] int32), as numpy.

    The device decides how it runs: the CUDA kernels for a CUDA tensor, the
    twins for a CPU one; both keep the JAX 'scan' and 'kernel' semantics,
    ties included, so impl None, 'scan' and 'kernel' are one path here.
    impl 'assoc' is the parallel-in-time decode, on the tensor's device.
    emit_bias is added to every transition into an emitting state (to < 4),
    as scrappie_tpu's decode_crf does; negative values call fewer bases."""
    _check_impl(impl)
    t, squeeze = _batched(trans, device)
    t_tm = add_emit_bias(t.transpose(0, 1).contiguous(), emit_bias)
    score, path = (crf_viterbi_assoc_tm if impl == "assoc"
                   else crf_viterbi_tm)(t_tm)
    score, path = score.cpu().numpy(), path.cpu().numpy()
    if squeeze:
        return float(score[0]), path[0]
    return score, path


def posterior_crf(trans, impl: str | None = None, device=None) -> np.ndarray:
    """Forward-backward state posterior (ref posterior_crf,
    src/decode.c:928-1012): trans [T, 25] or [B, T, 25] -> probabilities
    [.., T+1, 5], one row per block boundary, as numpy. numpy input goes to
    `device` (CUDA unless named), a tensor stays on its own: the
    forward-backward kernel runs on the card, its plain twin on the CPU;
    impl 'assoc' the parallel-in-time form on either."""
    _check_impl(impl)
    t, squeeze = _batched(trans, device)
    post = (crf_posterior_assoc_tm if impl == "assoc"
            else crf_posterior_tm)(t.transpose(0, 1).contiguous()).cpu().numpy()
    return post[0] if squeeze else post


def crfpath_to_basecall(path, pos_out: np.ndarray | None = None,
                        npos: int | None = None) -> str:
    """A base for every emitting state of the path (ref crfpath_to_basecall,
    src/decode.c:895-918): states 0..3 emit A/C/G/T, the blank (4) nothing.

    npos: number of leading path entries consumed; by default
    len(path) - 1, since the reference passes npos = nblock for the
    (nblock+1)-entry Viterbi path (ref src/scrappie_raw.c:306). pos_out,
    if given, is filled completely: pos[i] is the index into the basecall
    after block i, and the boundaries past npos carry the last one (the
    reference leaves it zeroed; this is scrappie_tpu's extension)."""
    path = np.asarray(path)
    path = path[: len(path) - 1 if npos is None else npos]
    emit = path < NBASE
    seq = "".join(np.array(list("ACGT"))[path[emit]])
    if pos_out is not None:
        np.cumsum(emit, out=pos_out[: len(path)])
        pos_out[: len(path)] -= 1
        if len(path) and len(pos_out) > len(path):
            pos_out[len(path):] = pos_out[len(path) - 1]
    return seq
