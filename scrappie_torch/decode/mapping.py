"""Local-global mapping of a basecall posterior to a reference sequence.

Counterpart of scrappie_tpu/decode/mapping.py (behavioural spec: ref
src/decode.c:1420-1964). States are the seqlen kmer positions plus local
START/END; per block a position can be reached by stay (emit the stay
symbol), step (from pos-1), or skip (from pos-2, penalised), with local
entry and exit.

  * dense: ops/seqmap.py, the CUDA kernel for a CUDA tensor and its plain
    twin for a CPU one; the Viterbi moves stay on the posterior's device,
    where `seqmap_walk` follows them to the path, and only the path and
    two final scores go to the host;
  * banded: the DP restricted to a monotone band, as a fixed-width window
    that slides along the sequence (ops/seqmap.map_banded_tm: a CUDA
    kernel with no TPU counterpart, as JAX runs it as a lax.scan). Block 0
    is computed here, the rest in one call on the posterior's device.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import float_tensor
from scrappie_torch.ops.seqmap import (map_banded_tm, map_to_sequence_tm,
                                       seqmap_walk)

BIG = 1.0e30


def are_bounds_sane(low, high, nblock: int, seqlen: int) -> bool:
    """Band validity checks (ref are_bounds_sane, src/decode.c:1638-1689)."""
    low = np.asarray(low)
    high = np.asarray(high)
    if low.shape[0] != nblock or high.shape[0] != nblock:
        return False
    ok = (
        low[0] == 0
        and high[-1] == seqlen
        and (low <= seqlen).all()
        and (high <= seqlen).all()
        and (low <= high).all()
        and (low[1:] <= high[:-1]).all()   # overlap (step-only allowed)
        and (low[1:] >= low[:-1]).all()    # monotone
        and (high[1:] >= high[:-1]).all()
    )
    return bool(ok)


def _dense(logpost, seq, stay_pen, skip_pen, local_pen, viterbi, want_path,
           device):
    lp = float_tensor(logpost, device)
    seqstates = torch.as_tensor(np.asarray(seq, dtype=np.int32), device=lp.device)
    return map_to_sequence_tm(lp, seqstates, float(stay_pen), float(skip_pen),
                              float(local_pen), viterbi, want_path)


def map_to_sequence_viterbi(logpost, seq, stay_pen=0.0, skip_pen=0.0,
                            local_pen=4.0, want_path: bool = False,
                            device=None):
    """Viterbi map of posterior to sequence (ref src/decode.c:1420-1531).

    Returns score, or (score, path [T]) when want_path (path entries are
    sequence positions, -1 for local states). logpost is numpy, run on
    `device`, or a tensor, run on its own device."""
    final, moves = _dense(logpost, seq, stay_pen, skip_pen, local_pen, True,
                          want_path, device)
    seqlen = len(seq)
    last, end = final[seqlen - 1::2].cpu().numpy()
    score = float(max(last, end))
    if not want_path:
        return score
    return score, seqmap_walk(final, moves, seqlen).cpu().numpy()


def map_to_sequence_forward(logpost, seq, stay_pen=0.0, skip_pen=0.0,
                            local_pen=4.0, device=None):
    """Forward score of posterior-to-sequence map (ref
    src/decode.c:1547-1626)."""
    final, _ = _dense(logpost, seq, stay_pen, skip_pen, local_pen, False,
                      False, device)
    last, end = final[len(seq) - 1::2].cpu().numpy()
    return float(np.logaddexp(last, end))


def banded_inputs(lp, seq, low, high, skip_pen=0.0):
    """The banded DP's inputs on lp's device: seqstates [seqlen] and bands
    [2, T] (low, high) int32, and block 0's window [width] (ref
    src/decode.c:1745-1768: entry at position 0, free step to 1,
    single-skip to 2; window offsets are absolute, low[0] == 0). Seeds
    outside the band are dropped, as the reference never reads them."""
    seq = np.asarray(seq, dtype=np.int64)
    width = int((high - low).max())
    dev = lp.device
    init_win = torch.full((width,), -BIG, dtype=torch.float32, device=dev)
    if high[0] > 0:
        init_win[0] = lp[0, int(seq[0])]
    if width > 1 and len(seq) > 1 and high[0] > 1:
        init_win[1] = lp[0, int(seq[1])]
    if width > 2 and len(seq) > 2 and high[0] > 2:
        init_win[2] = lp[0, int(seq[2])] - float(np.float32(skip_pen))
    return (torch.as_tensor(seq.astype(np.int32), device=dev),
            torch.as_tensor(np.stack([low, high]).astype(np.int32), device=dev),
            init_win)


def map_to_sequence_banded(logpost, seq, low, high, stay_pen=0.0, skip_pen=0.0,
                           local_pen=4.0, viterbi: bool = True, device=None):
    """Banded map of posterior to sequence (ref src/decode.c:1706-1964).

    low/high: per-block inclusive/exclusive position bounds (monotone).
    Returns the score only (like the reference banded variants). The
    reference's first-block semantics are kept (positions 1/2 seeded by a
    free step / a single skip penalty, ref src/decode.c:1750-1760; the
    direct start->end transition only in the first block, ref :1812,
    :1950)."""
    low = np.asarray(low, dtype=np.int64)
    high = np.asarray(high, dtype=np.int64)
    seqlen = len(seq)
    if not are_bounds_sane(low, high, logpost.shape[0], seqlen):
        raise ValueError("banding structure is not valid")
    lp = float_tensor(logpost, device)
    width = int((high - low).max())
    final = map_banded_tm(lp, *banded_inputs(lp, seq, low, high, skip_pen),
                          float(stay_pen), float(skip_pen), float(local_pen),
                          viterbi).cpu().numpy()
    final_win, final_end = final[:width], float(final[width])
    w_last = seqlen - 1 - low[-1]
    last_pos_score = final_win[w_last] if 0 <= w_last < width else -BIG
    if viterbi:
        return float(max(last_pos_score, final_end))
    return float(np.logaddexp(last_pos_score, final_end))
