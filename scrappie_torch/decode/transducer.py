"""Transducer Viterbi decoding.

Counterpart of scrappie_tpu/decode/transducer.py (behavioural spec: ref
src/decode.c:123-365, backtrace :58-98). `viterbi_transducer_scores` and
`viterbi_local_backtrace` are the batch-major views of the plain twins in
ops/viterbi.py; `viterbi_decode_batch` runs the kernels or the twins
according to the device of the tensor it is given. `assemble_events` turns
an events read's path into its bases and annotates its event table.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import float_tensor
from scrappie_torch.post.homopolymer import homopolymer_dwell_correction
from scrappie_torch.post.overlapper import overlapper
from scrappie_torch.ops.viterbi import (
    viterbi_backtrace_tm,
    viterbi_backtrace_tm_plain,
    viterbi_scores_tm,
    viterbi_scores_tm_plain,
)


def viterbi_transducer_scores(logpost, stay_pen=0.0, skip_pen=0.0,
                              local_pen=2.0, use_slip: bool = False):
    """Forward pass, plain: logpost [B, T, nstate] -> (final
    [B, nhist+2], traceback [B, T, nhist+2] int16)."""
    final, tb = viterbi_scores_tm_plain(logpost.transpose(0, 1), stay_pen,
                                        skip_pen, local_pen, use_slip)
    return final, tb.transpose(0, 1)


def viterbi_local_backtrace(final, traceback):
    """Backtrace, plain: traceback [B, T, nhist+2] -> (score [B],
    path [B, T+1] int32)."""
    return viterbi_backtrace_tm_plain(final, traceback.transpose(0, 1))


def viterbi_decode_batch(logpost, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                         use_slip: bool = False):
    """Forward + backtrace for [B, T, nstate] -> (score [B], path
    [B, T+1]): the CUDA kernels for a CUDA tensor, the twins for a CPU
    one. The results are identical."""
    lp_tm = logpost.transpose(0, 1).contiguous()
    final, tb = viterbi_scores_tm(lp_tm, stay_pen, skip_pen, local_pen,
                                  use_slip)
    return viterbi_backtrace_tm(final, tb)


def decode_transducer(logpost, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                      use_slip=False, device=None):
    """Full transducer decode: (score, path). Accepts [T, nstate] or
    [B, T, nstate], as numpy or a tensor; numpy input is decoded on
    `device`, a tensor on its own device."""
    lp = float_tensor(logpost, device)
    squeeze = lp.dim() == 2
    if squeeze:
        lp = lp[None]
    score, path = viterbi_decode_batch(lp, stay_pen, skip_pen, local_pen,
                                       use_slip)
    score, path = score.cpu().numpy(), path.cpu().numpy()
    if squeeze:
        return float(score[0]), path[0]
    return score, path


def assemble_events(et, path, nstate: int, dwell_correction: bool):
    """An events read's bases from its decoded path [nev+1]: the first nev
    entries are stitched (ref src/scrappie_events.c:301) and annotate the
    event table et in place with the decoded state and position (ref
    :307-311); then the optional dwell homopolymer correction (ref
    src/decode.c:645-702). Returns (sequence or None, positions [nev+1])."""
    nev = len(et.active)
    emit = np.asarray(path)[:nev]
    pos = np.zeros(nev + 1, dtype=np.int64)
    seq = overlapper(emit, nstate - 1, pos)
    ev = et.event
    ev["state"][et.start : et.start + nev] = 1 + emit
    ev["pos"][et.start : et.start + nev] = pos[:nev]
    if dwell_correction and seq is not None:
        active = et.active[:nev]
        new = homopolymer_dwell_correction(
            active["length"], active["start"], emit, active["pos"],
            active["state"], nstate, len(seq))
        if new is not None:
            seq = new
    return seq, pos


def argmax_decoder(logpost):
    """Per-block argmax decode (ref src/decode.c:100-121): (score,
    path [T]) with stay encoded as -1."""
    if isinstance(logpost, torch.Tensor):
        logpost = logpost.cpu().numpy()
    lp = np.asarray(logpost)
    nstate = lp.shape[-1]
    imax = lp.argmax(axis=-1)
    score = np.take_along_axis(lp, imax[..., None], axis=-1).sum(axis=(-1, -2))
    path = np.where(imax == nstate - 1, -1, imax)
    return score, path
