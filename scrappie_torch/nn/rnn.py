"""The GRU and peephole-LSTM recurrences as plain loops over time.

Counterpart of scrappie_tpu/nn/rnn.py:gru, grumod and lstm, and the plain twins of
the GRU and LSTM kernels (ops/gru.py, csrc/gru.cu; ops/lstm.py,
csrc/lstm.cu). GRU gate conventions (scrappie GRU, ref gru_step
src/layers.c:472-527):

  x ........ precomputed iW·x + b, [..., 3S] blocks (z | r | hbar input)
  z, r ..... sigmoid(x[:2S] + h @ sW), sW [S, 2S]
  hbar ..... tanh(x[2S:] + (r*h) @ sW2), sW2 [S, S]
  h' ....... z*h + (1-z)*hbar          (z gates the OLD state)

LSTM (ref lstm_step src/layers.c:777-832): x is the precomputed iW·x + b,
[..., 4S] blocks [cell-in (tanh) | input | forget | output]; peep [3S] =
[input | forget | output] peepholes on c; the output gate's peephole reads
the NEW c; h0 = c0 = 0.

`rounding` (None, 'tf32', 'bf16'; nn/config.round_operand) rounds each
product's operands as the kernels do in that mode: the weights, the
carried h (and the GRU's r * h). ops/gru.py and ops/lstm.py pass the
policy's rounding for the device, as the JAX package's scans round
through pdot. The weights are rounded inside each step, as the JAX
package's step body rounds them: the values are those of a rounding
before the loop, but autograd through a twin then rounds each step's
weight gradient before the sum over the steps ('bf16',
nn/config.weight_grad), as jax.grad of the scan does.
"""

from __future__ import annotations

import torch

from scrappie_torch.nn.config import rmatmul


def gru_tm(x_tm: torch.Tensor, sW: torch.Tensor, sW2: torch.Tensor,
           reverse: bool = False, rounding: str | None = None) -> torch.Tensor:
    """GRU over time-major projected inputs x [T, B, 3S] -> h [T, B, S]."""
    T, B, _ = x_tm.shape
    S = sW2.shape[1]
    h = x_tm.new_zeros((B, S))
    out = x_tm.new_empty((T, B, S))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xt = x_tm[t]
        zr = torch.sigmoid(xt[:, : 2 * S] + rmatmul(h, sW, rounding))
        z = zr[:, :S]
        r = zr[:, S:]
        hbar = torch.tanh(xt[:, 2 * S :] + rmatmul(r * h, sW2, rounding))
        h = z * h + (1 - z) * hbar
        out[t] = h
    return out


def gru(x: torch.Tensor, sW: torch.Tensor, sW2: torch.Tensor,
        reverse: bool = False, rounding: str | None = None) -> torch.Tensor:
    """GRU over projected inputs x [..., T, 3S] -> [..., T, S] (the JAX
    package's batch-major layout)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    out = gru_tm(x.transpose(0, 1), sW, sW2, reverse, rounding).transpose(0, 1)
    return out[0] if squeeze else out


def grumod(x: torch.Tensor, sW: torch.Tensor, reverse: bool = False,
           rounding: str | None = None) -> torch.Tensor:
    """Modified GRU over projected inputs x [..., T, 3S] -> [..., T, S]
    (ref grumod_step src/layers.c:620-671; scrappie_tpu/nn/rnn.py:grumod).
    One recurrent matrix sW [S, 3S]; r gates the recurrent part of the
    candidate's pre-activation, not the state:

        z, r = sigmoid(x[:2S] + (h @ sW)[:2S])
        hbar = tanh(r * (h @ sW)[2S:] + x[2S:])
        h'   = z * h + (1 - z) * hbar

    No model uses it, so it has no kernel."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    x_tm = x.transpose(0, 1)
    T, B, _ = x_tm.shape
    S = sW.shape[0]
    h = x_tm.new_zeros((B, S))
    out = x_tm.new_empty((T, B, S))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xt = x_tm[t]
        rec = rmatmul(h, sW, rounding)
        zr = torch.sigmoid(xt[:, : 2 * S] + rec[:, : 2 * S])
        z = zr[:, :S]
        r = zr[:, S:]
        hbar = torch.tanh(r * rec[:, 2 * S :] + xt[:, 2 * S :])
        h = z * h + (1 - z) * hbar
        out[t] = h
    out = out.transpose(0, 1)
    return out[0] if squeeze else out


def lstm_tm(x_tm: torch.Tensor, sW: torch.Tensor, peep: torch.Tensor,
            reverse: bool = False, return_planes: bool = False,
            rounding: str | None = None):
    """Peephole LSTM over time-major projected inputs x [T, B, 4S] ->
    h [T, B, S]; with return_planes, (h, planes) with planes [6, T, B, S]:
    the cell state c, tanh(c) and the activated gates g = tanh(a_c), i, f,
    o of every step, which the backward walk reads (ops/lstm.py; the planes
    the training forward kernel writes)."""
    T, B, _ = x_tm.shape
    S = sW.shape[0]
    p_in, p_forget, p_out = peep[:S], peep[S : 2 * S], peep[2 * S :]
    h = x_tm.new_zeros((B, S))
    c = x_tm.new_zeros((B, S))
    out = x_tm.new_empty((T, B, S))
    planes = x_tm.new_empty((6, T, B, S)) if return_planes else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xF = x_tm[t] + rmatmul(h, sW, rounding)
        f = torch.sigmoid(xF[:, 2 * S : 3 * S] + c * p_forget)
        i = torch.sigmoid(xF[:, S : 2 * S] + c * p_in)
        g = torch.tanh(xF[:, :S])
        c = f * c + i * g
        o = torch.sigmoid(xF[:, 3 * S :] + c * p_out)
        tc = torch.tanh(c)
        h = o * tc
        out[t] = h
        if return_planes:
            planes[:, t] = torch.stack((c, tc, g, i, f, o))
    return (out, planes) if return_planes else out


def lstm(x: torch.Tensor, sW: torch.Tensor, peep: torch.Tensor,
         reverse: bool = False, rounding: str | None = None) -> torch.Tensor:
    """Peephole LSTM over projected inputs x [..., T, 4S] -> [..., T, S]
    (the JAX package's batch-major layout; scrappie_tpu/nn/rnn.py:lstm)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    out = lstm_tm(x.transpose(0, 1), sW, peep, reverse,
                  rounding=rounding).transpose(0, 1)
    return out[0] if squeeze else out
