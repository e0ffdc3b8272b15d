"""Local-global mapping of a basecall posterior to a reference sequence.

Counterpart of scrappie_tpu/decode/mapping.py (behavioural spec: ref
src/decode.c:1420-1964). States are the seqlen kmer positions plus local
START/END; per block a position can be reached by stay (emit the stay
symbol), step (from pos-1), or skip (from pos-2, penalised), with local
entry and exit.

  * dense: ops/seqmap.py, the CUDA kernel for a CUDA tensor and its plain
    twin for a CPU one; the walk of the Viterbi traceback stays on the
    host in numpy, as in the JAX package;
  * banded: the DP restricted to a monotone band, as a fixed-width window
    that slides along the sequence. JAX runs it as a lax.scan with no
    Pallas kernel; here it is plain PyTorch on the posterior's device, a
    loop over blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch import ops
from scrappie_torch.device import float_tensor
from scrappie_torch.ops.seqmap import map_to_sequence_tm

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
    final, tbs = _dense(logpost, seq, stay_pen, skip_pen, local_pen, True,
                        want_path, device)
    final = final.cpu().numpy()
    seqlen = len(seq)
    END = seqlen + 1
    score = float(max(final[seqlen - 1], final[END]))
    if not want_path:
        return score
    tbs = tbs.cpu().numpy()
    T = tbs.shape[0]
    path = np.zeros(T, dtype=np.int32)
    path[T - 1] = seqlen - 1 if final[seqlen - 1] > final[END] else END
    for t in range(T - 1, 0, -1):
        path[t - 1] = tbs[t, path[t]]
    path[(path == seqlen) | (path == END)] = -1
    return score, path


def map_to_sequence_forward(logpost, seq, stay_pen=0.0, skip_pen=0.0,
                            local_pen=4.0, device=None):
    """Forward score of posterior-to-sequence map (ref
    src/decode.c:1547-1626)."""
    final, _ = _dense(logpost, seq, stay_pen, skip_pen, local_pen, False,
                      False, device)
    final = final.cpu().numpy()
    seqlen = len(seq)
    return float(np.logaddexp(final[seqlen - 1], final[seqlen + 1]))


def _map_banded(lp, emit_win, valid_win, delta, entry_ok, stay_pen, skip_pen,
                local_pen, seq0_emit, seqm1_in_band, init_win, width: int,
                viterbi: bool):
    """Windowed banded DP over blocks 1..T-1 (the lax.scan of
    scrappie_tpu/decode/mapping.py:_map_banded, as a loop). Tensors lp,
    emit_win [T-1, width], valid_win [T-1, width], seq0_emit [T-1] and
    init_win [width] lie on one device; delta, entry_ok and seqm1_in_band
    are numpy on the host, so every shift is a slice."""
    dev = lp.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    stay, skip, local = f32(stay_pen), f32(skip_pen), f32(local_pen)
    neg = f32(-BIG)
    negw = neg.expand(width)
    comb = torch.maximum if viterbi else ops.logaddexp

    def shift(padded, d, by):
        """The previous window re-indexed: new[w] is old index w + d - by,
        the start clamped as lax.dynamic_slice clamps it."""
        start = min(max(width + d - by, 0), 2 * width)
        return padded[start:start + width]

    # Carries after block 0 (ref :1745-1768): START stayed once; END is
    # reached only by the direct start->end transition, which the
    # reference allows in the first block alone.
    prev, start, end = init_win, comb(-local, lp[0, -1]), -local
    stay_lps = lp[1:, -1]
    for t in range(emit_win.shape[0]):
        emit, stay_lp, d = emit_win[t], stay_lps[t], int(delta[t])
        padded = torch.cat([negw, prev, negw])
        curr = comb(comb(shift(padded, d, 0) - stay + stay_lp,
                         shift(padded, d, 1) + emit),
                    shift(padded, d, 2) - skip + emit)
        if entry_ok[t]:
            curr[0] = comb(curr[0], start + seq0_emit[t])
        curr = torch.where(valid_win[t], curr, neg)
        local_stay = comb(-local, stay_lp)
        exit_score = (prev[int(seqm1_in_band[t, 1])] if seqm1_in_band[t, 0] > 0
                      else neg) - local
        prev, start, end = curr, start + local_stay, comb(end + local_stay,
                                                          exit_score)
    return prev, end


def map_to_sequence_banded(logpost, seq, low, high, stay_pen=0.0, skip_pen=0.0,
                           local_pen=4.0, viterbi: bool = True, device=None):
    """Banded map of posterior to sequence (ref src/decode.c:1706-1964).

    low/high: per-block inclusive/exclusive position bounds (monotone).
    Returns the score only (like the reference banded variants). The
    reference's first-block semantics are kept (positions 1/2 seeded by a
    free step / a single skip penalty, ref src/decode.c:1750-1760; the
    direct start->end transition only in the first block, ref :1812,
    :1950); seeds outside the band are dropped, as the reference never
    reads them."""
    seq = np.asarray(seq, dtype=np.int64)
    low = np.asarray(low, dtype=np.int64)
    high = np.asarray(high, dtype=np.int64)
    seqlen = len(seq)
    if not are_bounds_sane(low, high, logpost.shape[0], seqlen):
        raise ValueError("banding structure is not valid")
    lp = float_tensor(logpost, device)

    width = int((high - low).max())
    dev = lp.device
    offs = low[:, None] + np.arange(width)[None, :]
    valid = offs < high[:, None]
    offs_c = np.minimum(offs, seqlen - 1)
    emit_win = lp.gather(1, torch.as_tensor(seq[offs_c], device=dev))
    seq0_emit = lp[:, int(seq[0])]
    sm1_mask = (low <= seqlen - 1) & (seqlen - 1 < high)
    # offset of seqlen-1 in the *previous* block's window (exit uses prev)
    prev_low = np.concatenate([[0], low[:-1]])
    prev_mask = np.concatenate([[False], sm1_mask[:-1]])
    sm1 = np.stack([prev_mask.astype(np.int32),
                    np.clip(seqlen - 1 - prev_low, 0, width - 1).astype(np.int32)],
                   axis=1)

    # Block 0 (ref :1745-1768): entry at position 0, free step to 1,
    # single-skip to 2; window offsets are absolute (low[0] == 0).
    init_win = torch.full((width,), -BIG, dtype=torch.float32, device=dev)
    if high[0] > 0:  # like seeds 1/2: an out-of-band seed is never consumed
        init_win[0] = lp[0, int(seq[0])]
    if width > 1 and seqlen > 1 and high[0] > 1:
        init_win[1] = lp[0, int(seq[1])]
    if width > 2 and seqlen > 2 and high[0] > 2:
        init_win[2] = lp[0, int(seq[2])] - float(np.float32(skip_pen))

    final_win, final_end = _map_banded(
        lp, emit_win[1:], torch.as_tensor(valid[1:], device=dev),
        np.diff(low), (low == 0)[1:], stay_pen, skip_pen, local_pen,
        seq0_emit[1:], sm1[1:], init_win, width, viterbi)
    final_win = final_win.cpu().numpy()
    final_end = float(final_end)
    w_last = seqlen - 1 - low[-1]
    last_pos_score = final_win[w_last] if 0 <= w_last < width else -BIG
    if viterbi:
        return float(max(last_pos_score, final_end))
    return float(np.logaddexp(last_pos_score, final_end))
