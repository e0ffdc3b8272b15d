"""GRU layer with the input projection inside the kernel, and the GRU
recurrence alone.

Counterpart of scrappie_tpu/ops/gru.py:gru_layer_fused_tm / gru_layer_tm
and gru_tm_padded. On a CUDA tensor `gru_layer_tm` and `gru_tm` launch
csrc/gru.cu (the recurrence is a mode of the same kernel); on a CPU tensor
`gru_layer_tm` runs `gru_layer_tm_plain`, the projection followed by the
loop of nn/rnn.py, and `gru_tm` that loop, nn/rnn.gru_tm. There is no lane
or batch padding: the output is [T, B, S].
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn import rnn
from scrappie_torch.nn.layers import feedforward


def gru_layer_tm_plain(x_tm, iW, b, sW, sW2, reverse: bool = False):
    """Plain twin: x [T, B, C] -> h [T, B, S]."""
    return rnn.gru_tm(feedforward(x_tm, iW, b), sW, sW2, reverse)


def gru_layer_tm(x_tm, iW, b, sW, sW2, reverse: bool = False):
    """One GRU layer on time-major features: x [T, B, C], iW [C, 3S],
    b [3S], sW [S, 2S], sW2 [S, S] -> h [T, B, S], h0 = 0."""
    if not ops.on_cuda(x_tm, iW, b, sW, sW2):
        return gru_layer_tm_plain(x_tm, iW, b, sW, sW2, reverse)
    return _gru_layer_cuda(x_tm, iW, b, sW, sW2, reverse)


def _gru_layer_cuda(x_tm, iW, b, sW, sW2, reverse):
    from scrappie_torch.ops import _build

    T, B, C = x_tm.shape
    S = sW2.shape[0]
    ops.check_kernel_input("x", x_tm, (T, B, C))
    ops.check_kernel_input("iW", iW, (C, 3 * S))
    ops.check_kernel_input("b", b, (3 * S,))
    ops.check_kernel_input("sW", sW, (S, 2 * S))
    ops.check_kernel_input("sW2", sW2, (S, S))
    if C > 3 * S or 3 * S > 1024:
        raise ValueError(f"gru kernel needs C <= 3S <= 1024, got C={C} S={S}")
    lib = _build.library()
    smem = lib.scrappie_gru_smem_bytes(C, S)
    if smem > ops.MAX_SMEM_BYTES:
        raise ValueError(f"gru kernel needs {smem} B of shared memory for "
                         f"C={C} S={S}; a block may use {ops.MAX_SMEM_BYTES}")
    y = torch.empty((T, B, S), dtype=torch.float32, device=x_tm.device)
    if T == 0 or B == 0:
        return y
    with torch.cuda.device(x_tm.device):
        err = lib.scrappie_gru_layer(
            x_tm.data_ptr(), iW.data_ptr(), b.data_ptr(), sW.data_ptr(),
            sW2.data_ptr(), y.data_ptr(), T, B, C, S, int(reverse),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "gru_layer")
    ops.LAUNCHES["gru_layer"] += 1
    return y


def gru_tm(x_tm, sW, sW2, reverse: bool = False):
    """The GRU recurrence over projected time-major inputs: x [T, B, 3S]
    (x @ iW + b), sW [S, 2S], sW2 [S, S] -> h [T, B, S], h0 = 0. Its plain
    twin is nn/rnn.gru_tm."""
    if not ops.on_cuda(x_tm, sW, sW2):
        return rnn.gru_tm(x_tm, sW, sW2, reverse)
    from scrappie_torch.ops import _build

    T, B, _ = x_tm.shape
    S = sW2.shape[0]
    ops.check_kernel_input("x", x_tm, (T, B, 3 * S))
    ops.check_kernel_input("sW", sW, (S, 2 * S))
    ops.check_kernel_input("sW2", sW2, (S, S))
    if 3 * S > 1024:
        raise ValueError(f"gru kernel needs 3S <= 1024, got S={S}")
    y = torch.empty((T, B, S), dtype=torch.float32, device=x_tm.device)
    if T == 0 or B == 0:
        return y
    with torch.cuda.device(x_tm.device):
        err = _build.library().scrappie_gru_recurrence(
            x_tm.data_ptr(), sW.data_ptr(), sW2.data_ptr(), y.data_ptr(), T, B,
            S, int(reverse), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "gru_recurrence")
    ops.LAUNCHES["gru_recurrence"] += 1
    return y
