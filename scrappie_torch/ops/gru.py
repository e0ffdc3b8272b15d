"""GRU layer: the input projection, then the GRU recurrence.

Counterpart of scrappie_tpu/ops/gru.py:gru_layer_fused_tm / gru_layer_tm
and gru_tm_padded. `gru_layer_tm` runs the projection and then the
recurrence through their autograd Functions, `Project` and
`GruRecurrence`. On a CUDA tensor their forwards launch the projection kernel (ops/project.py) and then
`gru_tm`'s recurrence kernel (csrc/gru.cu): weights in registers for
S <= 96, the big-S mode (weights read from L2) above, each counted under
its own name. On a CPU tensor they run the plain twins, nn/layers.feedforward
and the loop of nn/rnn.gru_tm, which is `gru_layer_tm_plain`. With grad
off (torch.no_grad, torch.inference_mode) autograd records nothing and the
launches are those of the forwards alone. There is no lane or batch
padding: the output is [T, B, S].

`GruRecurrence`'s backward is `gru_tm_backward`: the gates again from the
saved h by two products over all steps (torch.matmul, as XLA computes them
outside any kernel in the JAX package's VJP of nn/rnn.gru's scan), then
the walk of dh back through time, which on the card is the kernel
gru_recurrence_bwd_kernel (csrc/gru.cu, weights in registers, S <=
REGISTER_MAX_S; counted as "gru_recurrence_bwd") or above that its big-S
mode gru_walk_global_kernel (weights read from L2; counted as
"gru_recurrence_bwd_global"), and on the CPU its plain twin
`gru_walk_plain`, then the weights' gradients by two more products. Every
product of the backward rounds as nn/config.py sets out for the forward's
mode and device (the rounding GruRecurrence keeps from its forward): the
gates from the forward's rounded operands, so that they are the forward
kernel's; in the walk the carry's products, rounded in 'bf16', with TF32
operands in 'default' on the card; in 'bf16' each step's weight gradient
rounded before the sum over the steps (nn/config.weight_grad).

`gru_layer_fused_cuda` launches the first port's kernel, which projects
inside its step loop; no path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.nn import config, rnn
from scrappie_torch.nn.layers import affine
from scrappie_torch.ops.project import Project, check_project_input

#: The largest S whose recurrence keeps its weights in registers (REG_MAX_S
#: in csrc/gru.cu); above it the big-S mode reads them from L2.
REGISTER_MAX_S = 96


def gru_layer_tm_plain(x_tm, iW, b, sW, sW2, reverse: bool = False,
                       rounding=None):
    """Plain twin: x [T, B, C] -> h [T, B, S], the products' operands
    rounded by `rounding` (what gru_layer_tm computes on a CPU tensor in
    the mode of that rounding); autograd through it is the VJP that
    GruRecurrence and Project compute."""
    return rnn.gru_tm(affine(x_tm, iW, b, rounding), sW, sW2, reverse,
                      rounding)


def gru_layer_tm(x_tm, iW, b, sW, sW2, reverse: bool = False):
    """One GRU layer on time-major features: x [T, B, C], iW [C, 3S],
    b [3S], sW [S, 2S], sW2 [S, S] -> h [T, B, S], h0 = 0."""
    if ops.on_cuda(x_tm, iW, b, sW, sW2):
        check_gru_layer_input(x_tm, iW, b, sW, sW2)
    return GruRecurrence.apply(Project.apply(x_tm, iW, b), sW, sW2, reverse)


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
    its big-S mode ("gru_recurrence_global"). Both round the products'
    operands as the precision policy asks for the device."""
    rounding = config.kernel_rounding(x_tm.device)
    if not ops.on_cuda(x_tm, sW, sW2):
        return rnn.gru_tm(x_tm, sW, sW2, reverse, rounding)
    from scrappie_torch.ops import _build

    check_gru_recurrence_input(x_tm, sW, sW2)
    T, B, _ = x_tm.shape
    S = sW2.shape[0]
    big = S > REGISTER_MAX_S
    if big and 4 * S * 4 > ops.MAX_SMEM_BYTES:
        raise ValueError(f"gru recurrence needs 4S floats of shared memory, "
                         f"S={S}; a block may use {ops.MAX_SMEM_BYTES} B")
    y = torch.empty((T, B, S), dtype=torch.float32, device=x_tm.device)
    if T == 0 or B == 0:
        return y
    name = "gru_recurrence_global" if big else "gru_recurrence"
    with torch.cuda.device(x_tm.device):
        err = _build.library().scrappie_gru_recurrence(
            x_tm.data_ptr(), sW.data_ptr(), sW2.data_ptr(), y.data_ptr(), T, B,
            S, int(reverse), int(big), config.rounding_code(rounding),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return y


def backward_inputs(x_tm, h, sW, sW2, reverse: bool = False, rounding=None):
    """What the backward walk reads, from the forward's input x [T, B, 3S]
    and output h [T, B, S]: (h_prev [T, B, S], h at the step before in the
    forward's order and 0 at its first step; gates [T, B, 3S], z | r |
    hbar), two products over every step and row of the operands rounded
    by the forward's `rounding`, round(h_prev) @ round(sW) and
    round(r h_prev) @ round(sW2), so that the gates are the forward's."""
    S = sW2.shape[0]
    zero = h.new_zeros((1, *h.shape[1:]))
    h_prev = (torch.cat([h[1:], zero]) if reverse
              else torch.cat([zero, h[:-1]]))
    zr = torch.sigmoid(x_tm[..., : 2 * S] + config.rmatmul(h_prev, sW, rounding))
    hbar = torch.tanh(x_tm[..., 2 * S :]
                      + config.rmatmul(zr[..., S:] * h_prev, sW2, rounding))
    return h_prev, torch.cat([zr, hbar], dim=-1)


def gru_walk_plain(gates, h_prev, gh, sW, sW2, reverse: bool = False,
                   rounding=None):
    """Plain twin of the backward walk kernel: gates [T, B, 3S] (z | r |
    hbar), h_prev, gh [T, B, S] -> da [T, B, 3S] = (da_z | da_r | da_h),
    the gradient of the pre-activations, carrying dh opposite to the
    forward's direction (the step's formulas in csrc/gru.cu). The carry's
    two products, drh = R(da_h @ sW2_r^T) and R(da[:2S] @ sW_r^T), round
    for the forward's `rounding` (nn/config.grad_matmul): the weights as
    the forward rounded them, in 'bf16' the results, in 'tf32' da too."""
    T, B, _ = gates.shape
    S = sW2.shape[0]
    da = gates.new_empty((T, B, 3 * S))
    carry = gates.new_zeros((B, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        z, r, hb = gates[t, :, :S], gates[t, :, S : 2 * S], gates[t, :, 2 * S :]
        hp = h_prev[t]
        dh = carry + gh[t]
        az = dh * (hp - hb) * z * (1 - z)
        ah = dh * (1 - z) * (1 - hb * hb)
        drh = config.grad_matmul(ah, sW2.T, rounding)
        ar = drh * hp * r * (1 - r)
        da[t, :, :S], da[t, :, S : 2 * S], da[t, :, 2 * S :] = az, ar, ah
        carry = dh * z + drh * r + config.grad_matmul(da[t, :, : 2 * S], sW.T,
                                                      rounding)
    return da


def check_gru_walk_input(gates, h_prev, gh, sW, sW2) -> bool:
    """Raise unless the backward walk kernel takes these inputs: the
    weights and contiguous fp32 gates [T, B, 3S], h_prev and gh [T, B, S];
    return whether they take its big-S mode (S > REGISTER_MAX_S: the
    weights read from L2, 10 S floats of shared memory)."""
    check_gru_weights(sW, sW2)
    T, B, _ = gates.shape
    S = sW2.shape[0]
    big = S > REGISTER_MAX_S
    if big and 10 * S * 4 > ops.MAX_SMEM_BYTES:
        raise ValueError(f"the GRU's big-S backward walk needs 10S floats "
                         f"of shared memory, S = {S}; a block may use "
                         f"{ops.MAX_SMEM_BYTES} B")
    ops.check_kernel_input("gates", gates, (T, B, 3 * S))
    ops.check_kernel_input("h_prev", h_prev, (T, B, S))
    ops.check_kernel_input("gh", gh, (T, B, S))
    return big


def gru_walk(gates, h_prev, gh, sW, sW2, reverse: bool = False,
             rounding=None):
    """The backward walk (gru_walk_plain's arguments and result): on the
    card the kernel gru_recurrence_bwd_kernel, or its big-S mode above
    S = REGISTER_MAX_S, each rounding as its twin for `rounding`."""
    if not ops.on_cuda(gates, h_prev, gh, sW, sW2):
        return gru_walk_plain(gates, h_prev, gh, sW, sW2, reverse, rounding)
    from scrappie_torch.ops import _build

    big = check_gru_walk_input(gates, h_prev, gh, sW, sW2)
    T, B, _ = gates.shape
    S = sW2.shape[0]
    da = torch.empty((T, B, 3 * S), dtype=torch.float32, device=gates.device)
    if T == 0 or B == 0:
        return da
    name = "gru_recurrence_bwd_global" if big else "gru_recurrence_bwd"
    with torch.cuda.device(gates.device):
        err = _build.library().scrappie_gru_recurrence_bwd(
            gates.data_ptr(), h_prev.data_ptr(), gh.data_ptr(), sW.data_ptr(),
            sW2.data_ptr(), da.data_ptr(), T, B, S, int(reverse), int(big),
            config.rounding_code(rounding), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return da


def _weight_grads(da, h_prev, gates, S, rounding=None):
    """(dsW, dsW2) from the walk's da: sum over steps and rows of
    round(h_prev)^T [da_z | da_r] and round(r h_prev)^T da_h, each step's
    product rounded in 'bf16' (nn/config.weight_grad)."""
    rh = gates[..., S : 2 * S] * h_prev
    return (config.weight_grad(h_prev, da[..., : 2 * S], rounding, True),
            config.weight_grad(rh, da[..., 2 * S :], rounding, True))


def gru_tm_backward(x_tm, h, sW, sW2, gh, reverse: bool = False,
                    rounding=None):
    """The VJP of gru_tm: projected input x [T, B, 3S], its output h
    [T, B, S], sW [S, 2S], sW2 [S, S], the output's gradient gh [T, B, S]
    -> (dx [T, B, 3S], dsW [S, 2S], dsW2 [S, S]), each product rounded for
    the forward's `rounding`. The walk through time is the kernel on the
    card, its twin on the CPU; the rest are products."""
    h_prev, gates = backward_inputs(x_tm, h, sW, sW2, reverse, rounding)
    da = gru_walk(gates, h_prev, gh, sW, sW2, reverse, rounding)
    return (da, *_weight_grads(da, h_prev, gates, sW2.shape[0], rounding))


class GruRecurrence(torch.autograd.Function):
    """gru_tm, differentiable: forward the recurrence (the kernel on the
    card, nn/rnn.gru_tm on the CPU), backward gru_tm_backward in the
    forward's rounding."""

    @staticmethod
    def forward(ctx, x_tm, sW, sW2, reverse: bool):
        h = gru_tm(x_tm, sW, sW2, reverse)
        ctx.save_for_backward(x_tm, h, sW, sW2)
        ctx.reverse = reverse
        ctx.rounding = config.kernel_rounding(x_tm.device)
        return h

    @staticmethod
    def backward(ctx, gh):
        x_tm, h, sW, sW2 = ctx.saved_tensors
        dx, dsW, dsW2 = gru_tm_backward(x_tm, h, sW, sW2, gh.contiguous(),
                                        ctx.reverse, ctx.rounding)
        return dx, dsW, dsW2, None


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
