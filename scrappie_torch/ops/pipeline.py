"""The fast paths: one call from signal chunks to Viterbi paths.

Counterpart of scrappie_tpu/ops/pipeline.py:

  * rgrgr (rgrgr_basecall_fused, rgrgr_features_tm): conv and ELU (a
    library convolution), one transpose to time-major, the five GRU layers
    (ops/gru.py), the fused head + Viterbi forward (ops/viterbi.py) and the
    backtrace. The [T, B, 1025] posterior is never written to device
    memory.
  * rnnrf (rnnrf_basecall_fused, the features of rnnrf_transitions_tm):
    the same conv and GRU kernel in five residual layers, then the
    globalnorm head (a matmul and the partition kernel), the emit bias and
    the CRF forward and backtrace kernels (ops/crf.py). The transitions
    stay time-major, [T, B, 25] straight from the head's matmul, as the
    CRF kernels take them.
  * events (events_basecall_fused, events_features_tm): window(3) over the
    event features and one transpose to time-major, two stages of forward
    and backward peephole LSTM layers (ops/lstm.py) combined by
    feedforward2_tanh, then the same fused head + Viterbi forward and
    backtrace as rgrgr, with the FF3 head. Unlike the JAX pipeline there
    is no lane or batch padding.
"""

from __future__ import annotations

import torch

from scrappie_torch.models.specs import GRU_DIRS
from scrappie_torch.nn.layers import (conv1d, elu, feedforward2_tanh,
                                     globalnorm_tm, window)
from scrappie_torch.ops.crf import add_emit_bias, crf_viterbi_tm
from scrappie_torch.ops.gru import gru_layer_tm
from scrappie_torch.ops.lstm import lstm_layer_tm
from scrappie_torch.ops.viterbi import viterbi_backtrace_tm, viterbi_fused_tm

CONV_ACT = {"elu": elu, "tanh": torch.tanh}


def _conv_tm(params, sig, conv_activation: str, stride: int):
    """sig [B, T, 1] -> activated conv features, time-major [nblock, B, C]."""
    x = CONV_ACT[conv_activation](
        conv1d(sig, params["conv_W"], params["conv_b"], int(stride)))
    return x.transpose(0, 1).contiguous()


def _gru(params, x, i: int, d: str):
    pre = f"gru{d.upper()}{i}"
    return gru_layer_tm(x, params[f"{pre}_iW"], params[f"{pre}_b"],
                        params[f"{pre}_sW"], params[f"{pre}_sW2"],
                        reverse=(d == "b"))


def rgrgr_features_tm(params, sig, conv_activation: str = "elu",
                      stride: int = 5):
    """sig [B, T, 1] -> time-major hidden features [nblock, B, S]: conv,
    activation and the five alternating GRU layers (B1 F2 B3 F4 B5)."""
    x = _conv_tm(params, sig, conv_activation, stride)
    for i, d in enumerate(GRU_DIRS, start=1):
        x = _gru(params, x, i, d)
    return x


def rnnrf_features_tm(params, sig, conv_activation: str = "elu",
                      stride: int = 2):
    """sig [B, T, 1] -> time-major features [nblock, B, 96]: conv,
    activation and five residual GRU layers, x = x + gru(x) (ref
    src/networks.c:567-607). The width stays 96 throughout."""
    x = _conv_tm(params, sig, conv_activation, stride)
    for i, d in enumerate(GRU_DIRS, start=1):
        x = x + _gru(params, x, i, d)
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


def rnnrf_basecall_fused(params, sig, *, conv_activation: str = "elu",
                         stride: int = 2, emit_bias: float = 0.0):
    """rnnrf_r94 fast path: sig [B, T, 1] -> (logscore [B], path
    [B, nblock+1] int16 CRF states).

    Matches rnnrf_transitions followed by decode_crf(emit_bias=...) (ref
    src/networks.c:567-615 and src/decode.c:836-894)."""
    x = rnnrf_features_tm(params, sig, conv_activation, stride)
    trans = add_emit_bias(globalnorm_tm(x, params["FF_W"], params["FF_b"]),
                          emit_bias)
    score, path = crf_viterbi_tm(trans)
    return score, wire_path(path)


def events_features_tm(params, feats, winlen: int = 3):
    """feats [B, nevent, 4] -> time-major features below the head
    [nevent, B, 96]: window, then per stage the forward and backward LSTM
    layers on the same input and feedforward2_tanh over their outputs
    (ref src/networks.c:146-194)."""
    x = window(feats, winlen, 1).transpose(0, 1).contiguous()
    for layer in (1, 2):
        h = {d: lstm_layer_tm(x, params[f"lstm{d}{layer}_iW"],
                              params[f"lstm{d}{layer}_b"],
                              params[f"lstm{d}{layer}_sW"],
                              params[f"lstm{d}{layer}_p"], reverse=(d == "B"))
             for d in ("F", "B")}
        x = feedforward2_tanh(h["F"], h["B"], params[f"FF{layer}_Wf"],
                              params[f"FF{layer}_Wb"], params[f"FF{layer}_b"])
    return x


def events_basecall_fused(params, feats, *, winlen: int = 3, min_prob=1e-5,
                          tempW=1.0, tempb=1.0, stay_pen=0.0, skip_pen=0.0,
                          local_pen=2.0, use_slip: bool = False):
    """nanonet events fast path: feats [B, nevent, 4] -> (logscore [B],
    path [B, nevent+1] int16).

    Matches events_posterior followed by the transducer decode, within the
    order of the head's fp32 sums."""
    x = events_features_tm(params, feats, winlen)
    final, tb = viterbi_fused_tm(
        x, params["FF3_W"], params["FF3_b"], min_prob=min_prob, tempW=tempW,
        tempb=tempb, stay_pen=stay_pen, skip_pen=skip_pen, local_pen=local_pen,
        use_slip=use_slip)
    score, path = viterbi_backtrace_tm(final, tb)
    return score, wire_path(path)
