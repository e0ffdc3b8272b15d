"""Layers of the rgrgr, rnnrf, events and squiggle networks as plain
functions on tensors.

Counterpart of scrappie_tpu/nn/layers.py, with its layouts: features are
[..., T, C] and conv weights [winlen, Cin, Cout]. The convolution stays a
library call (`F.conv1d`), as the JAX package leaves it to XLA outside
any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU activation (ref src/util.h:67-69)."""
    return torch.where(x >= 0, x, torch.expm1(torch.clamp(x, max=0.0)))


def robustlog(x: torch.Tensor, min_prob: float) -> torch.Tensor:
    """log(min_prob/nrow + (1-min_prob)*x) along the last axis
    (ref src/layers.c:79-94)."""
    nrow = x.shape[-1]
    return torch.log(min_prob / nrow + (1.0 - min_prob) * x)


def feedforward(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Affine map y = x @ W + b (ref affine_map, src/scrappie_matrix.c:323)."""
    return torch.matmul(x, W) + b


def feedforward2_tanh(xf: torch.Tensor, xb: torch.Tensor, Wf: torch.Tensor,
                      Wb: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tanh(xf @ Wf + xb @ Wb + b), in this order of additions: combines
    the outputs of a forward and a backward RNN (ref affine_map2 + tanh,
    src/scrappie_matrix.c:353, src/layers.c:359)."""
    return torch.tanh(torch.matmul(xf, Wf) + torch.matmul(xb, Wb) + b)


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
    crf_partition_tm: the partition kernel for a CUDA tensor."""
    from scrappie_torch.ops.crf import crf_partition_tm

    trans = feedforward(x_tm, W, b)
    logZ = crf_partition_tm(trans) / trans.shape[0]
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
