"""GRU layer: the input projection, then the GRU recurrence.

Counterpart of scrappie_tpu/ops/gru.py:gru_layer_fused_tm / gru_layer_tm
and gru_tm_padded. On a CUDA tensor `gru_layer_tm` launches the projection
kernel (ops/project.py) and then `gru_tm`'s recurrence kernel
(csrc/gru.cu): weights in registers for S <= 96, the big-S mode (weights
read from L2) above, each counted under its own name. On a CPU tensor
`gru_layer_tm` runs `gru_layer_tm_plain`, the projection followed by the
loop of nn/rnn.py, and `gru_tm` that loop, nn/rnn.gru_tm. There is no lane
or batch padding: the output is [T, B, S].

`gru_layer_fused_cuda` launches the first port's kernel, which projects
inside its step loop; no path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn import rnn
from scrappie_torch.nn.layers import feedforward
from scrappie_torch.ops.project import check_project_input, project_tm

#: The largest S whose recurrence keeps its weights in registers (REG_MAX_S
#: in csrc/gru.cu); above it the big-S mode reads them from L2.
REGISTER_MAX_S = 96


def gru_layer_tm_plain(x_tm, iW, b, sW, sW2, reverse: bool = False):
    """Plain twin: x [T, B, C] -> h [T, B, S]."""
    return rnn.gru_tm(feedforward(x_tm, iW, b), sW, sW2, reverse)


def gru_layer_tm(x_tm, iW, b, sW, sW2, reverse: bool = False):
    """One GRU layer on time-major features: x [T, B, C], iW [C, 3S],
    b [3S], sW [S, 2S], sW2 [S, S] -> h [T, B, S], h0 = 0."""
    if not ops.on_cuda(x_tm, iW, b, sW, sW2):
        return gru_layer_tm_plain(x_tm, iW, b, sW, sW2, reverse)
    check_gru_layer_input(x_tm, iW, b, sW, sW2)
    return gru_tm(project_tm(x_tm, iW, b), sW, sW2, reverse)


def check_gru_layer_input(x_tm, iW, b, sW, sW2) -> None:
    """Raise unless a layer's inputs have the shapes, type and layout the
    projection and recurrence kernels take: contiguous fp32 x [T, B, C],
    iW [C, 3S], b [3S], sW [S, 2S], sW2 [S, S]."""
    check_gru_weights(sW, sW2)
    ops.check_kernel_input("iW", iW, (x_tm.shape[-1], 3 * sW2.shape[0]))
    check_project_input(x_tm, iW, b)


def check_gru_weights(sW, sW2) -> None:
    """Raise unless the recurrence kernel takes these weights: contiguous
    fp32 sW [S, 2S] and sW2 [S, S]."""
    S = sW2.shape[0]
    ops.check_kernel_input("sW", sW, (S, 2 * S))
    ops.check_kernel_input("sW2", sW2, (S, S))


def check_gru_recurrence_input(x_tm, sW, sW2) -> None:
    """Raise unless the recurrence kernel takes these inputs: the weights
    and a contiguous fp32 x [T, B, 3S]."""
    check_gru_weights(sW, sW2)
    T, B, _ = x_tm.shape
    ops.check_kernel_input("x", x_tm, (T, B, 3 * sW2.shape[0]))


def gru_tm(x_tm, sW, sW2, reverse: bool = False):
    """The GRU recurrence over projected time-major inputs: x [T, B, 3S]
    (x @ iW + b), sW [S, 2S], sW2 [S, S] -> h [T, B, S], h0 = 0. Its plain
    twin is nn/rnn.gru_tm. On the card S <= REGISTER_MAX_S launches the
    kernel with its weights in registers ("gru_recurrence"), a larger S
    its big-S mode ("gru_recurrence_global")."""
    if not ops.on_cuda(x_tm, sW, sW2):
        return rnn.gru_tm(x_tm, sW, sW2, reverse)
    from scrappie_torch.ops import _build

    check_gru_recurrence_input(x_tm, sW, sW2)
    T, B, _ = x_tm.shape
    S = sW2.shape[0]
    big = S > REGISTER_MAX_S
    if big and 3 * S * 4 > ops.MAX_SMEM_BYTES:
        raise ValueError(f"gru recurrence needs 3S floats of shared memory, "
                         f"S={S}; a block may use {ops.MAX_SMEM_BYTES} B")
    y = torch.empty((T, B, S), dtype=torch.float32, device=x_tm.device)
    if T == 0 or B == 0:
        return y
    name = "gru_recurrence_global" if big else "gru_recurrence"
    with torch.cuda.device(x_tm.device):
        err = _build.library().scrappie_gru_recurrence(
            x_tm.data_ptr(), sW.data_ptr(), sW2.data_ptr(), y.data_ptr(), T, B,
            S, int(reverse), int(big), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return y


def gru_layer_fused_cuda(x_tm, iW, b, sW, sW2, reverse: bool = False):
    """The first port's layer kernel, which projects inside its step loop
    (all weights in shared memory, one thread per gate column): CUDA
    tensors only; `gru_layer_tm_plain` is its twin. Kept to be timed
    beside `gru_layer_tm`'s route; no path calls it."""
    from scrappie_torch.ops import _build

    if not ops.on_cuda(x_tm, iW, b, sW, sW2):
        raise ValueError("gru_layer_fused_cuda takes cuda tensors")
    T, B, C = x_tm.shape
    S = sW2.shape[0]
    ops.check_kernel_input("x", x_tm, (T, B, C))
    ops.check_kernel_input("iW", iW, (C, 3 * S))
    ops.check_kernel_input("b", b, (3 * S,))
    check_gru_weights(sW, sW2)
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
