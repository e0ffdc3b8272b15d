"""The rgrgr fast path: one call from signal chunks to Viterbi paths.

Counterpart of scrappie_tpu/ops/pipeline.py (rgrgr_basecall_fused,
_rgrgr_features_tm, _wire_path): conv and ELU (a library convolution),
one transpose to time-major, the five GRU layers (ops/gru.py), the fused
head + Viterbi forward (ops/viterbi.py) and the backtrace. The
[T, B, 1025] posterior is never written to device memory.
"""

from __future__ import annotations

import torch

from scrappie_torch.nn.layers import conv1d, elu
from scrappie_torch.ops.gru import gru_layer_tm
from scrappie_torch.ops.viterbi import viterbi_backtrace_tm, viterbi_fused_tm
from scrappie_tpu.models.specs import GRU_DIRS

CONV_ACT = {"elu": elu, "tanh": torch.tanh}


def rgrgr_features_tm(params, sig, conv_activation: str = "elu",
                      stride: int = 5):
    """sig [B, T, 1] -> time-major hidden features [nblock, B, S]: conv,
    activation and the five alternating GRU layers (B1 F2 B3 F4 B5)."""
    x = CONV_ACT[conv_activation](
        conv1d(sig, params["conv_W"], params["conv_b"], int(stride)))
    x = x.transpose(0, 1).contiguous()
    for i, d in enumerate(GRU_DIRS, start=1):
        pre = f"gru{d.upper()}{i}"
        x = gru_layer_tm(x, params[f"{pre}_iW"], params[f"{pre}_b"],
                         params[f"{pre}_sW"], params[f"{pre}_sW2"],
                         reverse=(d == "b"))
    return x


def wire_path(path):
    """Cast a decoded path to int16 for the device-to-host copy. Every
    entry is a state index below 2^15 or -1, so the cast is exact."""
    return path.to(torch.int16)


def rgrgr_basecall_fused(params, sig, *, conv_activation: str = "elu",
                         stride: int = 5, min_prob=1e-5, tempW=1.0, tempb=1.0,
                         stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                         use_slip: bool = False):
    """sig [B, T, 1] -> (logscore [B], path [B, nblock+1] int16).

    Matches rgrgr_posterior followed by the transducer decode, within the
    order of the head's fp32 sums."""
    x = rgrgr_features_tm(params, sig, conv_activation, stride)
    final, tb = viterbi_fused_tm(
        x, params["FF_W"], params["FF_b"], min_prob=min_prob, tempW=tempW,
        tempb=tempb, stay_pen=stay_pen, skip_pen=skip_pen, local_pen=local_pen,
        use_slip=use_slip)
    score, path = viterbi_backtrace_tm(final, tb)
    return score, wire_path(path)
