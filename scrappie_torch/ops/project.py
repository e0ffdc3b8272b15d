"""The input projection of a recurrent layer, x @ W + b over every step
and row, which the GRU (ops/gru.py) and the peephole LSTM (ops/lstm.py)
run before their recurrence kernels.

The TPU kernels compute this product in their own bodies
(scrappie_tpu/ops/gru.py:_gru_fused_kernel, ops/lstm.py:_lstm_kernel), so
on a CUDA tensor `project_tm` launches the hand-written tiled fp32 kernel of
csrc/project.cu; on a CPU tensor it runs its plain twin, nn/layers.feedforward
(nn/layers.affine with the CPU's rounding). Both round their operands as
the precision policy asks for the device (nn/config.kernel_rounding: none,
TF32 or bfloat16).
`Project` makes it differentiable: its backward is two plain products
and a sum (torch.matmul), as XLA computes this product's VJP outside any
kernel in the JAX training step, rounded as nn/config.py's docstring sets
out for the forward's mode: in 'bf16' dx and dW each rounded once (dW is
one product over every step and row), in 'default' on the card both
operands of each rounded to TF32 (torch's TF32 matmul under the flags).
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn import config
from scrappie_torch.nn.layers import feedforward


def check_project_input(x_tm, W, b) -> None:
    """Raise unless the projection kernel takes these inputs: contiguous
    fp32 x [T, B, C], W [C, N], b [N]."""
    T, B, C = x_tm.shape
    N = W.shape[-1]
    ops.check_kernel_input("x", x_tm, (T, B, C))
    ops.check_kernel_input("iW", W, (C, N))
    ops.check_kernel_input("b", b, (N,))


def project_tm(x_tm, W, b):
    """x [T, B, C], W [C, N], b [N] -> x @ W + b [T, B, N], the operands
    rounded as the precision policy asks for their device."""
    if not ops.on_cuda(x_tm, W, b):
        return feedforward(x_tm, W, b)
    from scrappie_torch.ops import _build

    check_project_input(x_tm, W, b)
    T, B, C = x_tm.shape
    N = W.shape[1]
    out = torch.empty((T, B, N), dtype=torch.float32, device=x_tm.device)
    if T * B == 0:
        return out
    with torch.cuda.device(x_tm.device):
        err = _build.library().scrappie_project(
            x_tm.data_ptr(), W.data_ptr(), b.data_ptr(), out.data_ptr(),
            T * B, C, N,
            config.rounding_code(config.kernel_rounding(x_tm.device)),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "project")
    ops.LAUNCHES["project"] += 1
    return out


class Project(torch.autograd.Function):
    """project_tm, differentiable: dx = g @ W^T, dW = x^T g and db = the
    sum of g over every step and row, the products rounded for the
    forward's mode and device (nn/config.grad_matmul, weight_grad).
    `parts` > 1: W is that many layers' weights side by side (the LSTM
    pair's), whose dx the reference computes as a product a layer, each
    rounded on its own ('bf16'), then summed."""

    @staticmethod
    def forward(ctx, x_tm, W, b, parts: int = 1):
        ctx.save_for_backward(x_tm, W)
        ctx.rounding = config.kernel_rounding(x_tm.device)
        ctx.parts = parts
        return project_tm(x_tm, W, b)

    @staticmethod
    def backward(ctx, g):
        x_tm, W = ctx.saved_tensors
        if ctx.parts == 1 or config.grad_rounding(ctx.rounding)[1] is None:
            dx = config.grad_matmul(g, W.T, ctx.rounding)
        else:
            n = W.shape[1] // ctx.parts
            dx = sum(config.grad_matmul(g[..., k * n : (k + 1) * n],
                                        W[:, k * n : (k + 1) * n].T,
                                        ctx.rounding)
                     for k in range(ctx.parts))
        dW = config.weight_grad(x_tm, g, ctx.rounding)
        return dx, dW, g.reshape(-1, g.shape[-1]).sum(0), None
