"""Signal-to-squiggle alignment (DTW-style HMM Viterbi / forward).

Counterpart of scrappie_tpu/decode/dtw.py (behavioural spec: ref
src/decode.c:1016-1401). Aligns raw samples to a predicted squiggle
(per-position current, log sd and -log dwell from the squiggle networks).
States: start, npos sequence positions, end, plus npos "back" states
modelling backward translocation; start and end absorb unmapped signal at
local_pen per sample. The DP runs in ops/dtw.py: the CUDA kernel for a
CUDA tensor, its plain twin for a CPU one. The penalties and the walk of
the Viterbi traceback stay on the host in numpy, as in the JAX package:
the traceback [nsample, 2*npos+2] int32 is copied to the host whole.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import float_tensor
from scrappie_torch.ops.dtw import squiggle_match_tm


def _penalties(params, rate: float, prob_back: float):
    """Per-position move/stay penalties (ref src/decode.c:1081-1098)."""
    dwell_logit = params[:, 2] + np.log(rate)
    mp = (1.0 - prob_back) * (0.5 * (1.0 + np.tanh(dwell_logit / 2.0)))
    move_pen_pos = np.log(mp)
    stay_pen_pos = np.log1p(-mp - prob_back)
    move_pen = np.concatenate([[move_pen_pos.mean()], move_pen_pos, [move_pen_pos.mean()]])
    stay_pen = np.concatenate([[stay_pen_pos.mean()], stay_pen_pos, [stay_pen_pos.mean()]])
    return move_pen.astype(np.float32), stay_pen.astype(np.float32)


def match_inputs(params, rate: float, prob_back: float, device):
    """The DP's per-position inputs from a squiggle params [npos, 3] on
    `device`: (locs, scales, logscales, move_pen, stay_pen), float32. They
    are computed on the host (scales = exp(logscales) with torch on the
    CPU), so a CPU and a CUDA run see the same inputs."""
    params = np.asarray(params, dtype=np.float32)
    with np.errstate(divide="ignore"):
        move_pen, stay_pen = _penalties(params, rate, max(prob_back, 0.0))
    logscales = torch.from_numpy(np.ascontiguousarray(params[:, 1]))
    host = (params[:, 0], params[:, 1], torch.exp(logscales).numpy(), move_pen,
            stay_pen)
    locs, logscales, scales, move_pen, stay_pen = (
        torch.as_tensor(np.ascontiguousarray(a), device=device) for a in host)
    return locs, scales, logscales, move_pen, stay_pen


def _match(signal, params, rate, prob_back, local_pen, skip_pen, minscore,
           viterbi: bool, device):
    """The DP of one read on `device` (a tensor signal: on its own device)."""
    sig = float_tensor(signal, device)
    return squiggle_match_tm(sig, *match_inputs(params, rate, prob_back, sig.device),
                             prob_back, local_pen, skip_pen, minscore, viterbi)


def squiggle_match_viterbi(signal, params, rate=1.0, prob_back=0.0,
                           local_pen=2.0, skip_pen=0.0, minscore=5.0,
                           device=None):
    """Viterbi signal-to-squiggle alignment (ref src/decode.c:1035-1244).

    signal: [nsample] normalised samples (numpy, run on `device`, or a
    tensor, run on its own device); params [npos, 3] untransformed squiggle
    output (current, log sd, -log dwell). Returns (score, path [nsample])
    where path[i] is the squiggle position of sample i (back moves report
    the position; -1 = unmapped under the local model)."""
    prob_back = float(prob_back)
    npos = np.asarray(params).shape[0]
    nfstate = npos + 2
    final, tbs = _match(signal, params, rate,
                        prob_back if prob_back > 0 else 0.0, local_pen,
                        skip_pen, minscore, True, device)
    final = final.cpu().numpy()
    tbs = tbs.cpu().numpy()
    nsample = tbs.shape[0]

    # Final state: last position or end state (ref :1195-1202)
    score = float(max(final[nfstate - 2], final[nfstate - 1]))
    path = np.zeros(nsample, dtype=np.int32)
    path[-1] = nfstate - 2 if final[nfstate - 2] > final[nfstate - 1] else nfstate - 1
    for s in range(nsample - 1, 0, -1):
        path[s - 1] = tbs[s, path[s]]

    # Relabel (ref :1210-1234): leading starts / trailing ends -> -1,
    # back states -> position, fwd states -> position (index - 1).
    smin = 0
    while smin < nsample and path[smin] == 0:
        path[smin] = -1
        smin += 1
    smax = nsample
    while smax > 0 and path[smax - 1] == nfstate - 1:
        path[smax - 1] = -1
        smax -= 1
    seg = path[smin:smax]
    path[smin:smax] = np.where(seg >= nfstate, seg - nfstate, seg - 1)
    return score, path


def squiggle_match_forward(signal, params, rate=1.0, prob_back=0.0,
                           local_pen=2.0, skip_pen=0.0, minscore=5.0,
                           device=None):
    """Forward score of the signal-squiggle alignment (ref
    src/decode.c:1262-1401)."""
    nfstate = np.asarray(params).shape[0] + 2
    final, _ = _match(signal, params, rate, float(prob_back), local_pen,
                      skip_pen, minscore, False, device)
    final = final.cpu().numpy()
    return float(np.logaddexp(final[nfstate - 2], final[nfstate - 1]))
