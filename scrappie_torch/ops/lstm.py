"""Peephole-LSTM layer with the input projection, for the events model.

Counterpart of scrappie_tpu/ops/lstm.py:lstm_layer_tm (the Pallas kernel
_lstm_kernel). On a CUDA tensor `lstm_layer_tm` launches the projection
kernel of ops/project.py, which writes x @ iW + b for every step and row
into a [T, B, 4S] scratch tensor, then the recurrence kernel of
csrc/lstm.cu, which walks time with sW resident in shared memory
("lstm_layer"), or, where sW does not fit there or 4S exceeds 1024
threads, read from L2 ("lstm_layer_global"). On a CPU tensor it runs
`lstm_layer_tm_plain`, the projection followed by the loop of nn/rnn.py.
There is no lane, batch or time padding: the output is [T, B, S].
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn.layers import feedforward
from scrappie_torch.nn.rnn import lstm_tm
from scrappie_torch.ops.project import check_project_input, project_tm


def lstm_layer_tm_plain(x_tm, iW, b, sW, peep, reverse: bool = False):
    """Plain twin: x [T, B, C] -> h [T, B, S]."""
    return lstm_tm(feedforward(x_tm, iW, b), sW, peep, reverse)


def lstm_layer_tm(x_tm, iW, b, sW, peep, reverse: bool = False):
    """One peephole-LSTM layer on time-major features: x [T, B, C],
    iW [C, 4S], b [4S], sW [S, 4S], peep [3S] -> h [T, B, S], with
    h0 = c0 = 0."""
    if not ops.on_cuda(x_tm, iW, b, sW, peep):
        return lstm_layer_tm_plain(x_tm, iW, b, sW, peep, reverse)
    check_lstm_input(x_tm, iW, b, sW, peep)
    return lstm_recurrence_cuda(project_tm(x_tm, iW, b), sW, peep, reverse)


def check_lstm_input(x_tm, iW, b, sW, peep) -> None:
    """Raise unless a layer's inputs have the shapes, type and layout the
    two kernels take: the checks of the projection and of
    `lstm_recurrence_cuda`, which hold iW's width to 4S on xproj."""
    _check_weights(sW, peep)
    ops.check_kernel_input("iW", iW, (x_tm.shape[-1], 4 * sW.shape[0]))
    check_project_input(x_tm, iW, b)


def _check_weights(sW, peep) -> None:
    S = sW.shape[0]
    ops.check_kernel_input("sW", sW, (S, 4 * S))
    ops.check_kernel_input("peep", peep, (3 * S,))


def _require_cuda(*tensors) -> None:
    if not ops.on_cuda(*tensors):
        raise ValueError("the LSTM recurrence kernel takes cuda tensors; "
                         "lstm_layer_tm runs the twin for CPU ones")


def lstm_on_chip(S: int) -> bool:
    """Whether the recurrence of size S keeps sW in shared memory (4S
    threads, sW, h, c and the gates within a block's shared memory)."""
    return 4 * S <= 1024 and 4 * (4 * S * S + 6 * S) <= ops.MAX_SMEM_BYTES


def lstm_recurrence_cuda(xproj, sW, peep, reverse: bool = False):
    """The recurrence kernel alone: xproj [T, B, 4S] -> h [T, B, S]. Its
    launch is the one `LAUNCHES["lstm_layer"]` (sW on chip) or
    `LAUNCHES["lstm_layer_global"]` (sW from L2) counts: one per layer."""
    from scrappie_torch.ops import _build

    _require_cuda(xproj, sW, peep)
    _check_weights(sW, peep)
    T, B, _ = xproj.shape
    S = sW.shape[0]
    ops.check_kernel_input("xproj", xproj, (T, B, 4 * S))
    on_chip = lstm_on_chip(S)
    if 4 * 6 * S > ops.MAX_SMEM_BYTES:
        raise ValueError(f"lstm kernel needs 6S floats of shared memory, "
                         f"S={S}; a block may use {ops.MAX_SMEM_BYTES} B")
    y = torch.empty((T, B, S), dtype=torch.float32, device=xproj.device)
    if T == 0 or B == 0:
        return y
    name = "lstm_layer" if on_chip else "lstm_layer_global"
    with torch.cuda.device(xproj.device):
        err = _build.library().scrappie_lstm_recurrence(
            xproj.data_ptr(), sW.data_ptr(), peep.data_ptr(), y.data_ptr(), T,
            B, S, int(reverse), int(not on_chip),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return y
