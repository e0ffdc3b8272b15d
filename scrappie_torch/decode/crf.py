"""CRF decoding: Viterbi and the forward-backward posterior.

Counterpart of scrappie_tpu/decode/crf.py (behavioural spec: ref
src/decode.c:836-1012). States are {A, C, G, T, blank}; transitions
[T, 25], entry [t, to*5 + from] the energy of moving from -> to at block t
(log-space, globally normalised upstream). The Viterbi decode and the
posterior run the CRF kernels for a CUDA tensor and their plain twins for a
CPU one (ops/crf.py).
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import float_tensor
from scrappie_torch.ops.crf import add_emit_bias, crf_posterior_tm, crf_viterbi_tm

NBASE = 4

_ASSOC = ("the parallel-in-time associative scan (impl='assoc') is not "
          "ported yet: ROADMAP.md queue 1 item 9")


def _check_impl(impl: str | None) -> None:
    if impl == "assoc":
        raise NotImplementedError(_ASSOC)
    if impl not in (None, "scan", "kernel"):
        raise ValueError(f"unknown impl {impl!r}")


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
    emit_bias is added to every transition into an emitting state (to < 4),
    as scrappie_tpu's decode_crf does; negative values call fewer bases."""
    _check_impl(impl)
    t, squeeze = _batched(trans, device)
    t_tm = add_emit_bias(t.transpose(0, 1).contiguous(), emit_bias)
    score, path = crf_viterbi_tm(t_tm)
    score, path = score.cpu().numpy(), path.cpu().numpy()
    if squeeze:
        return float(score[0]), path[0]
    return score, path


def posterior_crf(trans, impl: str | None = None, device=None) -> np.ndarray:
    """Forward-backward state posterior (ref posterior_crf,
    src/decode.c:928-1012): trans [T, 25] or [B, T, 25] -> probabilities
    [.., T+1, 5], one row per block boundary, as numpy. numpy input goes to
    `device` (CUDA unless named), a tensor stays on its own: the
    forward-backward kernel runs on the card, its plain twin on the CPU."""
    _check_impl(impl)
    t, squeeze = _batched(trans, device)
    post = crf_posterior_tm(t.transpose(0, 1).contiguous()).cpu().numpy()
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
