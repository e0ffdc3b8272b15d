"""Peephole-LSTM layers with the input projection, for the events model.

Counterpart of scrappie_tpu/ops/lstm.py:lstm_layer_tm (the Pallas kernel
_lstm_kernel). On CUDA tensors:

  * `lstm_pair_tm` runs both directions of a bidirectional stage on one
    input: one launch of the projection kernel of ops/project.py against
    the two layers' weights side by side, which writes [T, B, 8S], then
    one launch of the recurrence kernel of csrc/lstm.cu over a grid of
    2B blocks, the forward layer's and the backward one's ("lstm_pair");
  * `lstm_layer_tm` runs one layer: the projection into [T, B, 4S], then
    the same recurrence kernel over B blocks ("lstm_layer").

The recurrence keeps sW in registers for S <= REGISTER_MAX_S; above it the
big-S mode reads sW from L2, one launch per layer ("lstm_layer_global").
On CPU tensors each wrapper runs its plain twin, the projection followed
by the loop of nn/rnn.py. There is no lane, batch or time padding: each
output is [T, B, S].
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn.layers import feedforward
from scrappie_torch.nn.rnn import lstm_tm
from scrappie_torch.ops.project import check_project_input, project_tm

#: The largest S whose recurrence keeps sW in registers (REG_MAX_S in
#: csrc/lstm.cu); above it the big-S mode reads sW from L2.
REGISTER_MAX_S = 96


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


def lstm_pair_tm_plain(x_tm, wF, wB):
    """Plain twin of `lstm_pair_tm`: the two layers one after the other."""
    return (lstm_layer_tm_plain(x_tm, *wF),
            lstm_layer_tm_plain(x_tm, *wB, reverse=True))


def lstm_pair_tm(x_tm, wF, wB):
    """Both layers of a bidirectional stage on one input x [T, B, C]: wF
    and wB are the forward and backward layers' (iW [C, 4S], b [4S],
    sW [S, 4S], peep [3S]) -> (h_F, h_B), each [T, B, S], the forward
    layer walking time forwards and the backward one backwards."""
    if not ops.on_cuda(x_tm, *wF, *wB):
        return lstm_pair_tm_plain(x_tm, wF, wB)
    check_lstm_pair_input(x_tm, wF, wB)
    if not lstm_in_registers(wF[2].shape[0]):
        return lstm_layer_tm(x_tm, *wF), lstm_layer_tm(x_tm, *wB, reverse=True)
    xproj = project_tm(x_tm, torch.cat((wF[0], wB[0]), 1),
                       torch.cat((wF[1], wB[1])))
    return lstm_pair_recurrence_cuda(xproj, *wF[2:], *wB[2:])


def check_lstm_input(x_tm, iW, b, sW, peep) -> None:
    """Raise unless a layer's inputs have the shapes, type and layout the
    two kernels take: the checks of the projection and of
    `lstm_recurrence_cuda`, which hold iW's width to 4S on xproj."""
    _check_weights(sW, peep)
    ops.check_kernel_input("iW", iW, (x_tm.shape[-1], 4 * sW.shape[0]))
    check_project_input(x_tm, iW, b)


def check_lstm_pair_input(x_tm, wF, wB) -> None:
    """Raise unless a stage's inputs are what the pair route takes: each
    layer's inputs as `check_lstm_input` holds them, both layers of one
    size S, and every tensor on x's device."""
    devices = {t.device for t in (x_tm, *wF, *wB)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    for w in (wF, wB):
        check_lstm_input(x_tm, *w)
    if wB[2].shape != wF[2].shape:
        raise ValueError(f"sW: shape {tuple(wB[2].shape)} for the backward "
                         f"layer, {tuple(wF[2].shape)} for the forward one")


def _check_weights(sW, peep) -> None:
    S = sW.shape[0]
    ops.check_kernel_input("sW", sW, (S, 4 * S))
    ops.check_kernel_input("peep", peep, (3 * S,))


def _require_cuda(*tensors) -> None:
    if not ops.on_cuda(*tensors):
        raise ValueError("the LSTM recurrence kernel takes cuda tensors; "
                         "lstm_layer_tm and lstm_pair_tm run the twins for "
                         "CPU ones")


def lstm_in_registers(S: int) -> bool:
    """Whether the recurrence of size S keeps sW in registers (one thread
    per gate column, 4S threads); a larger S runs the big-S mode."""
    return S <= REGISTER_MAX_S


def lstm_recurrence_cuda(xproj, sW, peep, reverse: bool = False):
    """The recurrence kernel alone: xproj [T, B, 4S] -> h [T, B, S]. Its
    launch is the one `LAUNCHES["lstm_layer"]` (sW in registers) or
    `LAUNCHES["lstm_layer_global"]` (sW from L2) counts: one per layer."""
    from scrappie_torch.ops import _build

    _require_cuda(xproj, sW, peep)
    _check_weights(sW, peep)
    T, B, _ = xproj.shape
    S = sW.shape[0]
    ops.check_kernel_input("xproj", xproj, (T, B, 4 * S))
    in_registers = lstm_in_registers(S)
    if 4 * 6 * S > ops.MAX_SMEM_BYTES:
        raise ValueError(f"lstm kernel needs 6S floats of shared memory, "
                         f"S={S}; a block may use {ops.MAX_SMEM_BYTES} B")
    y = torch.empty((T, B, S), dtype=torch.float32, device=xproj.device)
    if T == 0 or B == 0:
        return y
    name = "lstm_layer" if in_registers else "lstm_layer_global"
    with torch.cuda.device(xproj.device):
        err = _build.library().scrappie_lstm_recurrence(
            xproj.data_ptr(), sW.data_ptr(), peep.data_ptr(), y.data_ptr(), T,
            B, S, int(reverse), int(not in_registers),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return y


def lstm_pair_recurrence_cuda(xproj, sW_f, peep_f, sW_b, peep_b):
    """The recurrence kernel over both directions in one launch (counted
    as `LAUNCHES["lstm_pair"]`): xproj [T, B, 8S], the forward layer's 4S
    gate columns then the backward one's -> (h_F, h_B), each [T, B, S];
    S <= REGISTER_MAX_S."""
    from scrappie_torch.ops import _build

    _require_cuda(xproj, sW_f, peep_f, sW_b, peep_b)
    S = sW_f.shape[0]
    for d, sW, peep in (("f", sW_f, peep_f), ("b", sW_b, peep_b)):
        ops.check_kernel_input(f"sW_{d}", sW, (S, 4 * S))
        ops.check_kernel_input(f"peep_{d}", peep, (3 * S,))
    T, B, _ = xproj.shape
    ops.check_kernel_input("xproj", xproj, (T, B, 8 * S))
    if not lstm_in_registers(S):
        raise ValueError(f"the pair route keeps sW in registers, S <= "
                         f"{REGISTER_MAX_S}; got S={S}")
    y = torch.empty((2, T, B, S), dtype=torch.float32, device=xproj.device)
    if T == 0 or B == 0:
        return y[0], y[1]
    with torch.cuda.device(xproj.device):
        err = _build.library().scrappie_lstm_pair(
            xproj.data_ptr(), sW_f.data_ptr(), peep_f.data_ptr(),
            y[0].data_ptr(), sW_b.data_ptr(), peep_b.data_ptr(),
            y[1].data_ptr(), T, B, S, ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "lstm_pair")
    ops.LAUNCHES["lstm_pair"] += 1
    return y[0], y[1]
