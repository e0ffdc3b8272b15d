"""Peephole-LSTM layer with the input projection, for the events model.

Counterpart of scrappie_tpu/ops/lstm.py:lstm_layer_tm (the Pallas kernel
_lstm_kernel). On a CUDA tensor `lstm_layer_tm` launches csrc/lstm.cu: a
tiled projection kernel writes x @ iW + b for every step and row into a
[T, B, 4S] scratch tensor, then the recurrence kernel walks time with sW
resident in shared memory. On a CPU tensor it runs `lstm_layer_tm_plain`,
the projection followed by the loop of nn/rnn.py. There is no lane, batch
or time padding: the output is [T, B, S].
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn.layers import feedforward
from scrappie_torch.nn.rnn import lstm_tm


def lstm_layer_tm_plain(x_tm, iW, b, sW, peep, reverse: bool = False):
    """Plain twin: x [T, B, C] -> h [T, B, S]."""
    return lstm_tm(feedforward(x_tm, iW, b), sW, peep, reverse)


def lstm_layer_tm(x_tm, iW, b, sW, peep, reverse: bool = False):
    """One peephole-LSTM layer on time-major features: x [T, B, C],
    iW [C, 4S], b [4S], sW [S, 4S], peep [3S] -> h [T, B, S], with
    h0 = c0 = 0."""
    if not ops.on_cuda(x_tm, iW, b, sW, peep):
        return lstm_layer_tm_plain(x_tm, iW, b, sW, peep, reverse)
    xproj = lstm_project_cuda(x_tm, iW, b)
    return lstm_recurrence_cuda(xproj, sW, peep, reverse)


def check_lstm_input(x_tm, iW, b, sW, peep) -> None:
    """Raise unless a layer's inputs have the shapes, type and layout the
    two kernels take: the checks of `lstm_project_cuda` and
    `lstm_recurrence_cuda`, which hold iW's width to 4S on xproj."""
    _check_weights(sW, peep)
    _check_projection(x_tm, iW, b, 4 * sW.shape[0])


def _check_projection(x_tm, iW, b, N: int) -> None:
    T, B, C = x_tm.shape
    ops.check_kernel_input("x", x_tm, (T, B, C))
    ops.check_kernel_input("iW", iW, (C, N))
    ops.check_kernel_input("b", b, (N,))


def _check_weights(sW, peep) -> None:
    S = sW.shape[0]
    ops.check_kernel_input("sW", sW, (S, 4 * S))
    ops.check_kernel_input("peep", peep, (3 * S,))


def _require_cuda(*tensors) -> None:
    if not ops.on_cuda(*tensors):
        raise ValueError("the LSTM kernels take cuda tensors; "
                         "lstm_layer_tm runs the twin for CPU ones")


def lstm_project_cuda(x_tm, iW, b):
    """The projection kernel alone: x [T, B, C] -> x @ iW + b [T, B, 4S]."""
    from scrappie_torch.ops import _build

    _require_cuda(x_tm, iW, b)
    N = iW.shape[1]
    _check_projection(x_tm, iW, b, N)
    T, B, C = x_tm.shape
    out = torch.empty((T, B, N), dtype=torch.float32, device=x_tm.device)
    if T * B == 0:
        return out
    with torch.cuda.device(x_tm.device):
        err = _build.library().scrappie_lstm_project(
            x_tm.data_ptr(), iW.data_ptr(), b.data_ptr(), out.data_ptr(),
            T * B, C, N, ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "lstm_project")
    return out


def lstm_recurrence_cuda(xproj, sW, peep, reverse: bool = False):
    """The recurrence kernel alone: xproj [T, B, 4S] -> h [T, B, S]. Its
    launch is the one `LAUNCHES["lstm_layer"]` counts: one per layer."""
    from scrappie_torch.ops import _build

    _require_cuda(xproj, sW, peep)
    _check_weights(sW, peep)
    T, B, _ = xproj.shape
    S = sW.shape[0]
    ops.check_kernel_input("xproj", xproj, (T, B, 4 * S))
    if 4 * S > 1024:
        raise ValueError(f"lstm kernel needs 4S <= 1024 threads, got S={S}")
    lib = _build.library()
    smem = lib.scrappie_lstm_smem_bytes(S)
    if smem > ops.MAX_SMEM_BYTES:
        raise ValueError(f"lstm kernel needs {smem} B of shared memory for "
                         f"S={S}; a block may use {ops.MAX_SMEM_BYTES}")
    y = torch.empty((T, B, S), dtype=torch.float32, device=xproj.device)
    if T == 0 or B == 0:
        return y
    with torch.cuda.device(xproj.device):
        err = lib.scrappie_lstm_recurrence(
            xproj.data_ptr(), sW.data_ptr(), peep.data_ptr(), y.data_ptr(), T,
            B, S, int(reverse), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "lstm_recurrence")
    ops.LAUNCHES["lstm_layer"] += 1
    return y
