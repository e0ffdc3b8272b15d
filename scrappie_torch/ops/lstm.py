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

Training: when a gradient is wanted (grad mode on and an input that
requires one), `lstm_pair_tm` goes through autograd Functions instead,
`ops/project.Project` and then `LstmPair`. Its forward runs the pair
launch in the recurrence kernel's training mode, which also writes each
direction's planes (c, tanh(c) and the activated gates of every step;
"lstm_pair_train"); inference never launches that mode, and LstmPair
keeps the planes for its backward, not the projected input. `lstm_layer_tm`
has no training route on the card (it raises there when a gradient is
wanted; on the CPU autograd runs through its twin). LstmPair's backward is
`lstm_tm_backward`, which recomputes nothing: the walk of dh and dc back
through time, which on the card is the kernel lstm_recurrence_bwd_kernel
(csrc/lstm.cu, both directions of a stage in one launch, sW in registers,
S <= REGISTER_MAX_S; counted as "lstm_recurrence_bwd") and on the CPU its
plain twin `lstm_walk_plain`, returns da and each row's dpeep partials,
summed here; dsW is one product over h and da offset by a step
(torch.matmul, as XLA computes it outside any kernel in the JAX package's
VJP of nn/rnn.lstm's scan). Above REGISTER_MAX_S the training forward
runs its big-S mode, sW read from L2 ("lstm_pair_train_global"), and the
walk its cluster mode, sW^T spread over the registers of a cluster of CTAs
a row and direction ("lstm_recurrence_bwd_cluster"), up to CLUSTER_MAX_S,
and above it its walk from L2 ("lstm_recurrence_bwd_global"; `walk_mode`).
Training runs in every precision mode:
LstmPair keeps its forward's rounding (nn/config.kernel_rounding), the
training forward rounds as the inference launch does (the same h bit for
bit), the walk's carry R(da @ sW_r^T) rounds as nn/config.grad_matmul
does, and in 'bf16' dsW rounds each step's product before the sum over
the steps (nn/config.weight_grad).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scrappie_torch import ops
from scrappie_torch.nn import config
from scrappie_torch.nn.layers import affine
from scrappie_torch.nn.rnn import lstm_tm
from scrappie_torch.ops.project import Project, check_project_input, project_tm

#: The largest S whose recurrence keeps sW in registers (REG_MAX_S in
#: csrc/lstm.cu); above it the big-S mode reads sW from L2.
REGISTER_MAX_S = 96
#: The backward walk's cluster mode (csrc/lstm.cu lstm_walk_cluster_kernel)
#: above REGISTER_MAX_S: a lane's rows of da at most CLUSTER_MAX_ROWS (4S
#: over a warp's 32 lanes, rounded up), a CTA's warps at most
#: CLUSTER_MAX_WARPS, a cluster's CTAs at most CLUSTER_MAX_CTAS; so S up to
#: CLUSTER_MAX_S. The kernel's launch bounds cap a thread at
#: CLUSTER_MAX_REGISTERS registers, of which a lane's tile of sW^T takes at
#: most 80 (the rest of a larger tile lies in shared memory).
CLUSTER_MAX_ROWS = 48
CLUSTER_MAX_WARPS = 12
CLUSTER_MAX_CTAS = 16
CLUSTER_MAX_S = 8 * CLUSTER_MAX_ROWS
CLUSTER_MAX_REGISTERS = 65536 // (32 * CLUSTER_MAX_WARPS) // 8 * 8


def lstm_layer_tm_plain(x_tm, iW, b, sW, peep, reverse: bool = False,
                        rounding=None):
    """Plain twin: x [T, B, C] -> h [T, B, S], the products' operands
    rounded by `rounding` (None, 'tf32', 'bf16')."""
    return lstm_tm(affine(x_tm, iW, b, rounding), sW, peep, reverse,
                   rounding=rounding)


def wants_grad(*tensors) -> bool:
    """Whether autograd records an operation on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_layer_tm(x_tm, iW, b, sW, peep, reverse: bool = False):
    """One peephole-LSTM layer on time-major features: x [T, B, C],
    iW [C, 4S], b [4S], sW [S, 4S], peep [3S] -> h [T, B, S], with
    h0 = c0 = 0; the products' operands rounded as the precision policy
    asks for the device."""
    if not ops.on_cuda(x_tm, iW, b, sW, peep):
        return lstm_layer_tm_plain(x_tm, iW, b, sW, peep, reverse,
                                   config.kernel_rounding(x_tm.device))
    if wants_grad(x_tm, iW, b, sW, peep):
        raise ValueError("lstm_layer_tm runs inference only on the card; "
                         "train a stage through lstm_pair_tm")
    check_lstm_input(x_tm, iW, b, sW, peep)
    return lstm_recurrence_cuda(project_tm(x_tm, iW, b), sW, peep, reverse)


def lstm_pair_tm_plain(x_tm, wF, wB, rounding=None):
    """Plain twin of `lstm_pair_tm`: the two layers one after the other."""
    return (lstm_layer_tm_plain(x_tm, *wF, rounding=rounding),
            lstm_layer_tm_plain(x_tm, *wB, reverse=True, rounding=rounding))


def lstm_pair_tm(x_tm, wF, wB):
    """Both layers of a bidirectional stage on one input x [T, B, C]: wF
    and wB are the forward and backward layers' (iW [C, 4S], b [4S],
    sW [S, 4S], peep [3S]) -> (h_F, h_B), each [T, B, S], the forward
    layer walking time forwards and the backward one backwards."""
    if wants_grad(x_tm, *wF, *wB):
        if ops.on_cuda(x_tm, *wF, *wB):
            check_lstm_pair_input(x_tm, wF, wB)
            check_walk_size(wF[2].shape[0])
        xproj = Project.apply(x_tm, torch.cat((wF[0], wB[0]), 1),
                              torch.cat((wF[1], wB[1])), 2)
        return LstmPair.apply(xproj, *wF[2:], *wB[2:])
    if not ops.on_cuda(x_tm, *wF, *wB):
        return lstm_pair_tm_plain(x_tm, wF, wB,
                                  config.kernel_rounding(x_tm.device))
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
            config.rounding_code(config.kernel_rounding(xproj.device)),
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
            y[1].data_ptr(), T, B, S,
            config.rounding_code(config.kernel_rounding(xproj.device)),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "lstm_pair")
    ops.LAUNCHES["lstm_pair"] += 1
    return y[0], y[1]


# ------------------------------------------------------------- training

#: The training forward's planes a direction, each [T, B, S], in the order
#: the kernels write them and nn/rnn.lstm_tm(return_planes=True) returns
#: them: the cell state c, tanh(c), then the activated gates g = tanh(a_c),
#: i, f, o.
TRAIN_PLANES = 6


class WalkClusterLayout(NamedTuple):
    ncta: int         # CTAs of a row and direction's cluster
    units: int        # units a CTA owns, at most (CTA c: [c S / ncta, (c+1) S / ncta))
    out: int          # units a warp sums
    warps: int        # warps of a CTA: units / out, rounded up
    rows: int         # rows of da (of sW^T) a lane holds, zero past 4S
    weights: int      # sW^T's weights a lane holds in registers
    shared_rows: int  # rows of its tile a lane keeps in shared memory


def walk_cluster_layout(S: int) -> WalkClusterLayout | None:
    """The cluster walk's layout at size S (csrc/lstm.cu cluster_layout,
    cl_out, cl_reg_rows): rows = 4S / 32 rounded up to 4 up to 20, else
    to 8; a warp sums 4 units while rows <= 20, else 2; a lane's tile in
    registers up to 64 weights (4 units) or 80 (2 units), else its first
    16 or 24 rows there and the rest in shared memory; the fewest CTAs
    (2, 4, 8 or 16) whose units fit CLUSTER_MAX_WARPS warps. None above
    CLUSTER_MAX_ROWS rows."""
    rows = -(-4 * S // 32)
    rows = -(-rows // 4) * 4 if rows <= 20 else -(-rows // 8) * 8
    if rows > CLUSTER_MAX_ROWS:
        return None
    out = 4 if rows <= 20 else 2
    reg_rows = rows if rows * out <= (64 if out == 4 else 80) else 16 if out == 4 else 24
    ncta = 2
    while ncta <= CLUSTER_MAX_CTAS:
        units = -(-S // ncta)
        warps = -(-units // out)
        if warps <= CLUSTER_MAX_WARPS:
            return WalkClusterLayout(ncta, units, out, warps, rows,
                                     out * reg_rows, rows - reg_rows)
        ncta *= 2
    return None


def walk_mode(S: int) -> str:
    """The backward walk's mode, chosen by S alone: "registers" (S <=
    REGISTER_MAX_S, lstm_recurrence_bwd_kernel), "cluster" (up to
    CLUSTER_MAX_S, lstm_walk_cluster_kernel) or "global" (above: sW from
    L2, lstm_walk_global_kernel)."""
    if lstm_in_registers(S):
        return "registers"
    return "cluster" if S <= CLUSTER_MAX_S else "global"


#: The walk's counter and the C entry point's mode code, by walk_mode.
WALK_MODES = {"registers": ("lstm_recurrence_bwd", 0),
              "cluster": ("lstm_recurrence_bwd_cluster", 1),
              "global": ("lstm_recurrence_bwd_global", 2)}


def check_walk_size(S: int) -> bool:
    """Raise unless the training forward and the backward walk take size S;
    return whether they run their big-S modes (S > REGISTER_MAX_S: the
    forward reads sW from L2; the walk runs `walk_mode(S)`, its cluster
    mode up to CLUSTER_MAX_S and sW from L2 above, 9S floats of shared
    memory)."""
    if 4 * 9 * S > ops.MAX_SMEM_BYTES:
        raise ValueError(f"the LSTM's big-S backward walk needs 9S floats "
                         f"of shared memory, S = {S}; a block may use "
                         f"{ops.MAX_SMEM_BYTES} B")
    return not lstm_in_registers(S)


def lstm_pair_train_cuda(xproj, sW_f, peep_f, sW_b, peep_b, rounding=None):
    """The pair launch in its training mode (counted as
    `LAUNCHES["lstm_pair_train"]`, or its big-S mode's as
    "lstm_pair_train_global"), the products' operands rounded by
    `rounding`: xproj [T, B, 8S] -> (h_F, h_B, planes_F, planes_B), h
    [T, B, S] the inference launch's in that rounding bit for bit, planes
    [TRAIN_PLANES, T, B, S] a direction (c, tanh(c), g, i, f, o), each plane
    contiguous and the two directions' planes equally far apart."""
    from scrappie_torch.ops import _build

    _require_cuda(xproj, sW_f, peep_f, sW_b, peep_b)
    S = sW_f.shape[0]
    for d, sW, peep in (("f", sW_f, peep_f), ("b", sW_b, peep_b)):
        ops.check_kernel_input(f"sW_{d}", sW, (S, 4 * S))
        ops.check_kernel_input(f"peep_{d}", peep, (3 * S,))
    big = check_walk_size(S)
    T, B, _ = xproj.shape
    ops.check_kernel_input("xproj", xproj, (T, B, 8 * S))
    out = torch.empty((1 + TRAIN_PLANES, 2, T, B, S), dtype=torch.float32,
                      device=xproj.device)
    if T == 0 or B == 0:
        return out[0, 0], out[0, 1], out[1:, 0], out[1:, 1]
    name = "lstm_pair_train_global" if big else "lstm_pair_train"
    with torch.cuda.device(xproj.device):
        err = _build.library().scrappie_lstm_pair_train(
            xproj.data_ptr(), sW_f.data_ptr(), peep_f.data_ptr(),
            out[0, 0].data_ptr(), out[1, 0].data_ptr(), sW_b.data_ptr(),
            peep_b.data_ptr(), out[0, 1].data_ptr(), out[1, 1].data_ptr(), T,
            B, S, int(big), config.rounding_code(rounding),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return out[0, 0], out[0, 1], out[1:, 0], out[1:, 1]


def _shifted(a, reverse: bool):
    """a at the step before in the forward's order, 0 at its first step."""
    zero = a.new_zeros((1, *a.shape[1:]))
    return torch.cat([a[1:], zero]) if reverse else torch.cat([zero, a[:-1]])


def lstm_walk_plain(planes, gh, sW, peep, reverse: bool = False,
                    rounding=None):
    """Plain twin of the backward walk kernel: the forward's planes
    [TRAIN_PLANES, T, B, S] (c, tanh(c), g, i, f, o) and the output's
    gradient gh [T, B, S] -> (da [T, B, 4S] = (da_c | da_i | da_f | da_o),
    the gradient of the pre-activations (= of the projected input),
    carrying dh and dc opposite to the forward's direction; dpeep [B, 3S],
    each row's sums over time of da_i c_prev, da_f c_prev and da_o c). The
    step's six coefficients (csrc/lstm.cu's header) are formed first, for
    every step; the loop carries only what depends on the carry. The
    carry's product, carry_h = R(da @ sW_r^T), rounds for the forward's
    `rounding` (nn/config.grad_matmul)."""
    c, tc, g, i, f, o = planes
    T, B, S = c.shape
    p_in, p_f, p_out = peep[:S], peep[S : 2 * S], peep[2 * S :]
    c_prev = _shifted(c, reverse)
    A = tc * o * (1 - o)
    Bc = o * (1 - tc * tc) + A * p_out
    F = c_prev * f * (1 - f)
    I = g * i * (1 - i)
    G = i * (1 - g * g)
    K = f + F * p_f + I * p_in
    da = c.new_empty((T, B, 4 * S))
    carry_h = c.new_zeros((B, S))
    carry_c = c.new_zeros((B, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        dh = carry_h + gh[t]
        dc = carry_c + dh * Bc[t]
        da[t] = torch.cat([dc * G[t], dc * I[t], dc * F[t], dh * A[t]], dim=-1)
        carry_c = dc * K[t]
        carry_h = config.grad_matmul(da[t], sW.T, rounding)
    dpeep = torch.cat([(da[..., S : 2 * S] * c_prev).sum(0),
                       (da[..., 2 * S : 3 * S] * c_prev).sum(0),
                       (da[..., 3 * S :] * c).sum(0)], dim=-1)
    return da, dpeep


def check_walk_input(planes, gh, sW, peep) -> bool:
    """Raise unless the backward walk kernel takes these inputs: the
    weights, fp32 planes [TRAIN_PLANES, T, B, S], each plane contiguous,
    and a contiguous gh [T, B, S]; return whether they take its big-S mode
    (`check_walk_size`)."""
    _check_weights(sW, peep)
    S = sW.shape[0]
    big = check_walk_size(S)
    T, B = gh.shape[:2]
    ops.check_kernel_input("planes[0]", planes[0], (T, B, S))
    if planes.shape[0] != TRAIN_PLANES or planes.dtype != torch.float32:
        raise ValueError(f"planes: {TRAIN_PLANES} float32 planes expected, "
                         f"got {tuple(planes.shape)} {planes.dtype}")
    ops.check_kernel_input("gh", gh, (T, B, S))
    return big


def lstm_walk_pair(dirs, rounding=None):
    """The backward walk of one or two layers of a stage in one launch:
    dirs is a sequence of (planes, gh, sW, peep, reverse), one a direction,
    each as `lstm_walk_plain` takes them, the carry's products rounded
    for `rounding` -> (da [T, B, 4S * len(dirs)], the directions' columns
    side by side (the layout of the pair's projection); dpeep [len(dirs),
    B, 3S], each row's partial sums). On the card one launch, counted once
    by `walk_mode(S)`: lstm_recurrence_bwd_kernel over a grid of len(dirs)
    x B blocks ("lstm_recurrence_bwd"); above REGISTER_MAX_S
    lstm_walk_cluster_kernel, a cluster of `walk_cluster_layout(S).ncta`
    CTAs a row and direction ("lstm_recurrence_bwd_cluster"); above
    CLUSTER_MAX_S the walk from L2 ("lstm_recurrence_bwd_global"). The
    directions' planes must lie equally far apart. On the CPU the twin, a
    direction at a time."""
    tensors = [t for d in dirs for t in d[:4]]
    if not ops.on_cuda(*tensors):
        walks = [lstm_walk_plain(*d, rounding) for d in dirs]
        return (torch.cat([w[0] for w in walks], dim=-1),
                torch.stack([w[1] for w in walks]))
    from scrappie_torch.ops import _build

    if not 1 <= len(dirs) <= 2:
        raise ValueError(f"the walk kernel takes one or two directions, "
                         f"got {len(dirs)}")
    T, B, S = dirs[0][1].shape
    for planes, gh, sW, peep, _rev in dirs:
        big = check_walk_input(planes, gh, sW, peep)
        ops.check_kernel_input("gh", gh, (T, B, S))
    poff = dirs[0][0].stride(0)
    if any(d[0].stride(0) != poff for d in dirs):
        raise ValueError("the directions' planes must lie equally far apart")
    n = len(dirs)
    da = torch.empty((T, B, 4 * S * n), dtype=torch.float32,
                     device=gh.device)
    dpeep = torch.empty((n, B, 3 * S), dtype=torch.float32, device=gh.device)
    if T == 0 or B == 0:
        return da, dpeep.zero_()
    d0, d1 = dirs[0], dirs[-1]
    sWs = [d[2] if big else _padded(d[2]) for d in (d0, d1)]
    ptrs = lambda d, sW: (d[0].data_ptr(), d[1].data_ptr(), sW.data_ptr(),
                          d[3].data_ptr(), int(d[4]))
    name, mode = WALK_MODES[walk_mode(S)]
    with torch.cuda.device(da.device):
        err = _build.library().scrappie_lstm_recurrence_bwd(
            *ptrs(d0, sWs[0]), *ptrs(d1, sWs[1]), poff, da.data_ptr(),
            4 * S * n,
            dpeep.data_ptr(), n, T, B, S, mode,
            config.rounding_code(rounding), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, name)
    ops.LAUNCHES[name] += 1
    return da, dpeep


def _padded(sW):
    """sW [S, 4S] as the register walk reads it: [REGISTER_MAX_S, 4,
    REGISTER_MAX_S], zero past S (sW itself at S = REGISTER_MAX_S)."""
    S = sW.shape[0]
    if S == REGISTER_MAX_S:
        return sW
    out = sW.new_zeros((REGISTER_MAX_S, 4, REGISTER_MAX_S))
    out[:S, :, :S] = sW.view(S, 4, S)
    return out


def _dsW(h, da, reverse: bool, rounding=None):
    """dsW [S, 4S], the sum over steps and rows of round(h_prev)^T da: one
    product over views of h and da offset by a step (h_prev is h at the
    forward's step before, 0 at its first step, where it adds nothing); in
    'bf16' each step's product rounded before the sum (nn/config.
    weight_grad)."""
    hp, dn = (h[1:], da[:-1]) if reverse else (h[:-1], da[1:])
    return config.weight_grad(hp, dn, rounding, True)


def lstm_tm_backward(layers, rounding=None):
    """The VJP of one or two LSTM recurrences on their inputs: layers is
    a sequence of (h [T, B, S], planes [TRAIN_PLANES, T, B, S], sW, peep,
    reverse, gh [T, B, S]), one a direction -> (dx [T, B, 4S *
    len(layers)], the directions' columns side by side, [(dsW, dpeep)] a
    direction), the products rounded for the forward's `rounding`. The
    walk through time is one kernel launch on the card, its twin on the
    CPU, and returns dpeep's partials a row, summed here; dsW is one
    product a direction (a product a step, rounded, in 'bf16'). Nothing
    recomputes the gates."""
    da, parts = lstm_walk_pair([
        (planes, gh.contiguous(), sW, peep, reverse)
        for _h, planes, sW, peep, reverse, gh in layers], rounding)
    S4 = 4 * layers[0][2].shape[0]
    return da, [(_dsW(h, da[..., k * S4 : (k + 1) * S4], reverse, rounding),
                 parts[k].sum(0))
                for k, (h, _p, _w, _q, reverse, _g) in enumerate(layers)]


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


class LstmPair(torch.autograd.Function):
    """Both recurrences of a stage, differentiable: xproj [T, B, 8S] (the
    forward layer's 4S columns, then the backward one's), sW_f, peep_f,
    sW_b, peep_b -> (h_F, h_B). Forward: the pair launch in its training
    mode on the card (nn/rnn.lstm_tm a direction on the CPU), which keeps
    each direction's planes (c and the activated gates) for the backward,
    not xproj; backward: lstm_tm_backward, both walks in one launch, in
    the forward's rounding."""

    @staticmethod
    def forward(ctx, xproj, sW_f, peep_f, sW_b, peep_b):
        S4 = 4 * sW_f.shape[0]
        ctx.rounding = rounding = config.kernel_rounding(xproj.device)
        if ops.on_cuda(xproj, sW_f, peep_f, sW_b, peep_b):
            hF, hB, pF, pB = lstm_pair_train_cuda(xproj, sW_f, peep_f, sW_b,
                                                  peep_b, rounding)
        else:
            hF, pF = lstm_tm(xproj[..., :S4], sW_f, peep_f, False,
                             return_planes=True, rounding=rounding)
            hB, pB = lstm_tm(xproj[..., S4:], sW_b, peep_b, True,
                             return_planes=True, rounding=rounding)
        ctx.save_for_backward(hF, hB, pF, pB, sW_f, peep_f, sW_b, peep_b)
        return hF, hB

    @staticmethod
    def backward(ctx, ghF, ghB):
        hF, hB, pF, pB, sW_f, peep_f, sW_b, peep_b = ctx.saved_tensors
        da, ((dsW_f, dp_f), (dsW_b, dp_b)) = lstm_tm_backward([
            (hF, pF, sW_f, peep_f, False, _zeros_if_none(ghF, hF)),
            (hB, pB, sW_b, peep_b, True, _zeros_if_none(ghB, hB))],
            ctx.rounding)
        return da, dsW_f, dp_f, dsW_b, dp_b
