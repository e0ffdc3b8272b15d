"""Layers of the rgrgr, rnnrf, events and squiggle networks as plain
functions on tensors.

Counterpart of scrappie_tpu/nn/layers.py, with its layouts: features are
[..., T, C] and conv weights [winlen, Cin, Cout]. The convolution stays a
library call (`F.conv1d`), as the JAX package leaves it to XLA outside
any kernel. Every product goes through the precision policy
(nn/config.pmatmul, pconv_operands), where the JAX package's goes
through pdot and pconv_operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scrappie_torch.nn.config import pconv_operands, pmatmul, rmatmul


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU activation (ref src/util.h:67-69)."""
    return torch.where(x >= 0, x, torch.expm1(torch.clamp(x, max=0.0)))


def robustlog(x: torch.Tensor, min_prob: float) -> torch.Tensor:
    """log(min_prob/nrow + (1-min_prob)*x) along the last axis
    (ref src/layers.c:79-94)."""
    nrow = x.shape[-1]
    return torch.log(min_prob / nrow + (1.0 - min_prob) * x)


def feedforward(x: torch.Tensor, W, b: torch.Tensor) -> torch.Tensor:
    """Affine map y = x @ W + b (ref affine_map, src/scrappie_matrix.c:323).
    W may be StateShards: the partial products are then summed onto x's
    device before the bias."""
    if isinstance(W, StateShards):
        return state_matmul(x, W) + b
    return pmatmul(x, W) + b


class StateShards:
    """A weight [K, N] split along K (the contraction axis), each part on
    its own device: shards[s] = W[bounds[s][0]:bounds[s][1]] (a mesh's
    'state' axis, placed by parallel/sharding.shard_params); `full`, the
    whole W on the first part's device, or None."""

    def __init__(self, shards, full: torch.Tensor | None = None):
        self.shards = tuple(shards)
        self.full = full
        rows = [0]
        for w in self.shards:
            rows.append(rows[-1] + w.shape[0])
        self.bounds = tuple(zip(rows[:-1], rows[1:]))

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(w.device for w in self.shards)


class _ToStateDevices(torch.autograd.Function):
    """x [..., K] -> its column slices, one on each state device; the
    backward joins the slices' gradients into x's full gradient on x's
    device."""

    @staticmethod
    def forward(ctx, x, devices, bounds):
        ctx.device, ctx.shape, ctx.bounds = x.device, x.shape, bounds
        return tuple(x[..., lo:hi].to(device=dev, copy=True,
                                      memory_format=torch.contiguous_format)
                     for dev, (lo, hi) in zip(devices, bounds))

    @staticmethod
    def backward(ctx, *grads):
        parts = [g.to(ctx.device) if g is not None else
                 torch.zeros(*ctx.shape[:-1], hi - lo, device=ctx.device)
                 for g, (lo, hi) in zip(grads, ctx.bounds)]
        return torch.cat(parts, dim=-1), None, None


class _SumOnto(torch.autograd.Function):
    """Partial products on the state devices -> their sum on `device`,
    added in state order; the backward hands each partial the whole
    gradient on its own device."""

    @staticmethod
    def forward(ctx, device, *partials):
        ctx.devices = [p.device for p in partials]
        out = partials[0].to(device) + partials[1].to(device)
        for p in partials[2:]:
            out = out + p.to(device)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.to(dev) for dev in ctx.devices))


def state_matmul(x: torch.Tensor, w: StateShards) -> torch.Tensor:
    """x @ W with W split along its contraction axis: each part's device
    computes x[..., slice] @ W[slice], and the partials are summed onto x's
    device in part order (row-parallel; the backward gives x its full
    gradient)."""
    xs = _ToStateDevices.apply(x, w.devices, w.bounds)
    return _SumOnto.apply(x.device, *(pmatmul(xi, wi)
                                      for xi, wi in zip(xs, w.shards)))


def affine(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
           rounding: str | None = None) -> torch.Tensor:
    """x @ W + b with both operands rounded by `rounding` (None, 'tf32',
    'bf16'): the projection kernel's plain twin in each mode."""
    return rmatmul(x, W, rounding) + b


def feedforward2_tanh(xf: torch.Tensor, xb: torch.Tensor, Wf: torch.Tensor,
                      Wb: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tanh(xf @ Wf + xb @ Wb + b), in this order of additions: combines
    the outputs of a forward and a backward RNN (ref affine_map2 + tanh,
    src/scrappie_matrix.c:353, src/layers.c:359)."""
    return torch.tanh(pmatmul(xf, Wf) + pmatmul(xb, Wb) + b)


def window(x: torch.Tensor, w: int, stride: int) -> torch.Tensor:
    """Stack w adjacent frames, zero outside the input, subsampled by
    stride: x [..., T, C] -> [..., ceil(T/stride), w*C]. Output column c
    reads frames c*stride - wh + 1 + i for i < w, wh = (w+1)//2, so for
    w = 3 and stride 1 frames c-1, c and c+1 (ref src/layers.c:119-146)."""
    T = x.shape[-2]
    first = (torch.arange(-(-T // stride), device=x.device) * stride
             - (w + 1) // 2 + 1)
    cols = []
    for i in range(w):
        idx = first + i
        valid = ((idx >= 0) & (idx < T))[:, None]
        frames = x.index_select(-2, idx.clamp(0, max(T - 1, 0)))
        cols.append(torch.where(valid, frames, torch.zeros((), dtype=x.dtype)))
    return torch.cat(cols, dim=-1)


def embedding(seq: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Row lookup: seq [..., N] int -> [..., N, width] (ref src/layers.c:97)."""
    return E[seq.long()]


def conv_same_pad(T: int, winlen: int, stride: int) -> tuple[int, int]:
    """Padding of the reference convolution geometry: output column c
    covers input [c*stride - padL, c*stride - padL + winlen), padL =
    (winlen-1)//2, and there are ceil(T/stride) columns
    (ref src/layers.c:159-246)."""
    padL = (winlen - 1) // 2
    ncol = -(-T // stride)
    padR = (ncol - 1) * stride + winlen - padL - T
    return padL, padR


def conv1d(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
           stride: int) -> torch.Tensor:
    """1-D convolution in the reference geometry:
    x [..., T, Cin] -> [..., ceil(T/stride), Cout], W [winlen, Cin, Cout]."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    winlen = W.shape[0]
    padL, padR = conv_same_pad(x.shape[-2], winlen, stride)
    x, W = pconv_operands(x, W)
    xc = F.pad(x.transpose(1, 2), (padL, padR))        # [B, Cin, T + pad]
    out = F.conv1d(xc, W.permute(2, 1, 0), stride=stride)  # [B, Cout, ncol]
    out = out.transpose(1, 2) + b
    return out[0] if squeeze else out


def softmax_with_temperature(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                             tempW: float = 1.0, tempb: float = 1.0) -> torch.Tensor:
    """softmax(((x * tempb/tempW) @ W + b) / tempb), computed as the
    reference does (ref src/layers.c:333-357)."""
    y = feedforward(x * (tempb / tempW), W, b) / tempb
    return torch.softmax(y, dim=-1)


def crf_partition_function(trans: torch.Tensor) -> torch.Tensor:
    """Log partition function of the linear CRF (ref src/layers.c:835-871),
    a loop over time: trans [..., T, nstate^2], entry [t, to*nstate + from]
    the energy of moving from -> to at block t -> logZ [...]. The plain
    twin of the partition kernel (ops/crf.py)."""
    nstate = int(round(trans.shape[-1] ** 0.5))
    if nstate * nstate != trans.shape[-1]:
        raise ValueError(f"last axis {trans.shape[-1]} is not a square")
    tmat = trans.reshape(*trans.shape[:-1], nstate, nstate)  # [..., T, to, from]
    prev = trans.new_zeros((*trans.shape[:-2], nstate))
    for t in range(trans.shape[-2]):
        prev = torch.logsumexp(tmat[..., t, :, :] + prev[..., None, :], dim=-1)
    return torch.logsumexp(prev, dim=-1)


def globalnorm_tm(x_tm: torch.Tensor, W: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Time-major globalnorm: x [T, B, C] -> transitions [T, B, 25], the
    affine map less logZ / T per row. logZ comes from ops/crf.py's
    CrfPartition: the partition kernel for a CUDA tensor, its twin for a
    CPU one; its backward is the forward-backward kernel."""
    from scrappie_torch.ops.crf import CrfPartition

    trans = feedforward(x_tm, W, b)
    logZ = CrfPartition.apply(trans) / trans.shape[0]
    return trans - logZ[:, None]


def globalnorm(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Affine map followed by global CRF normalisation (ref
    src/layers.c:874-889): x [..., T, C] -> [..., T, 25] (one or no leading
    batch axis)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    out = globalnorm_tm(x.transpose(0, 1).contiguous(), W, b).transpose(0, 1)
    return out[0] if squeeze else out
