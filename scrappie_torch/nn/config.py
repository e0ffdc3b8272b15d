"""The precision policy of the matrix products.

Counterpart of scrappie_tpu/nn/config.py. The reference computes in exact
fp32, so the default is 'highest', which the parity tests hold the port
to. Modes (set_precision, the precision(p) context, the
SCRAPPIE_TORCH_PRECISION environment variable read at import, or the
CLI's --precision):

  'highest'  exact fp32 products everywhere (the default): TF32 off for
             torch's matmuls and cuDNN convolutions, and the kernels
             multiply their fp32 operands as they are.
  'default'  the device's own fast path. On the CPU plain fp32, equal to
             'highest', as the JAX package's is off the TPU. On the card
             TF32: torch's matmul and cuDNN TF32 flags are on while the
             mode holds, and the hand-written kernels round their operands
             to TF32 (cvt.rna.tf32.f32: 10 mantissa bits, ties away from
             zero) before fp32-accumulated FMAs.
  'bf16'     explicit bfloat16 operands on every device: each product's
             operands are rounded to bfloat16 (round to nearest even),
             then multiplied and summed in fp32, TF32 off; the JAX
             package's 'bf16', which reproduces a TPU MXU pass.

Every product of the inference path goes through `pmatmul` or
`pconv_operands`, and the four kernels with products (the projection,
the head, the GRU and LSTM recurrences) take their operand rounding from
`kernel_rounding(device)`. Their plain twins take the rounding as an
argument (`rmatmul`, `round_operand`), so that a kernel and its twin can
be held to each other in each mode. The mode is read when a product
runs.

Training runs in every mode. A backward product of y = a @ W (a the
activation, W the weight, dy the cotangent of y) computes da and dW:

  'highest'  da = dy @ W^T, dW = a^T @ dy in fp32, nothing rounded.
  'bf16'     da = round_bf16(dy @ W_r^T), dW = round_bf16(a_r^T @ dy):
             a_r and W_r are the forward's rounded operands, dy is not
             rounded, and the product is rounded (the VJP of the
             forward's cast, as jax.grad of pdot computes it, and torch's
             ToCopyBackward of `round_operand`). Inside a recurrence each step's dW_t is
             rounded, then the rounded terms are summed over the steps in
             fp32 (`weight_grad`), as the JAX package's scan rounds the
             weights inside its step body; the input projection is one
             product over every step, rounded once. The same on any
             device: the JAX package on the CPU is the reference.
  'default'  on the card both operands of every backward product rounded
             to TF32 and the result not rounded (torch's own TF32 matmuls
             under the flags; the kernels' `round_operand`); on the CPU
             plain fp32, equal to 'highest' bit for bit, as the JAX
             package's 'default' is off the TPU.

`grad_rounding(rounding)` names, for a forward's operand rounding, the
rounding of a backward product's cotangent operand and of its result.
Elementwise terms take no rounding: the peepholes, the bias, the gate
nonlinearities, the CRF partition and the lattices. An autograd Function
keeps the rounding of its forward for its backward, as autograd through
`pmatmul` does. `round_tf32` works on int32 views and has no gradient:
no autograd graph goes through it (`pmatmul` leaves TF32 to torch's
flags; the backward Functions call it on tensors outside any graph).
"""

from __future__ import annotations

import contextlib
import os

import torch

MODES = ("highest", "default", "bf16")
ENV = "SCRAPPIE_TORCH_PRECISION"
#: Operand roundings of a product: none, TF32 or bfloat16.
ROUNDINGS = (None, "tf32", "bf16")

_mode = "highest"


def get_precision() -> str:
    return _mode


def bf16_emulation() -> bool:
    """Is the 'bf16' explicit-rounding mode active?"""
    return _mode == "bf16"


def set_precision(p: str) -> None:
    """p: 'highest' | 'default' | 'bf16' (any case, surrounding spaces
    ignored). Sets torch's TF32 flags to the mode's: on for 'default',
    off otherwise."""
    global _mode
    name = str(p).strip().lower()
    if name not in MODES:
        raise ValueError(f"unknown precision {p!r}; one of {', '.join(MODES)}")
    _mode = name
    tf32 = name == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def precision(p: str):
    """Run the body under mode p, then restore the mode before."""
    old = _mode
    set_precision(p)
    try:
        yield
    finally:
        set_precision(old)


def kernel_rounding(device=None) -> str | None:
    """The operand rounding the mode asks of a product on `device` (a
    torch.device, its name, or None for the CPU): None, 'tf32' or 'bf16'."""
    if _mode == "bf16":
        return "bf16"
    if _mode == "default" and device is not None \
            and torch.device(device).type == "cuda":
        return "tf32"
    return None


def rounding_code(rounding: str | None) -> int:
    """A rounding as the kernels' C entry points take it: 0 none, 1 TF32,
    2 bfloat16."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    return ROUNDINGS.index(rounding)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 as cvt.rna.tf32.f32 rounds them: the
    low 13 mantissa bits rounded half away from zero (a carry may reach
    the exponent, and the largest finite values become infinities), then
    zeroed; Inf and NaN pass through. On int32 views: the formula of the
    kernels' round_weight (csrc/rounding.cuh), bit for bit."""
    bits = x.contiguous().view(torch.int32)
    rounded = torch.bitwise_and(bits + 0x1000, ~0x1FFF)
    finite = torch.bitwise_and(bits, 0x7F800000) != 0x7F800000
    return torch.where(finite, rounded, bits).view(torch.float32)


def round_operand(x: torch.Tensor, rounding: str | None) -> torch.Tensor:
    """x rounded as a product's operand: unchanged (None), to TF32
    ('tf32', fp32 only) or to bfloat16 with round to nearest even ('bf16'),
    in x's own type (fp32; fp64 for the twins' exact references)."""
    if rounding is None:
        return x
    if rounding == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if rounding == "tf32":
        return round_tf32(x)
    raise ValueError(f"unknown rounding {rounding!r}")


def rmatmul(x: torch.Tensor, w: torch.Tensor,
            rounding: str | None) -> torch.Tensor:
    """x @ w with both operands rounded by `rounding` (the twins' product)."""
    return torch.matmul(round_operand(x, rounding), round_operand(w, rounding))


def pmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w under the mode (counterpart of pdot): 'bf16' rounds both
    operands; 'default' leaves TF32 to torch's flags on the card."""
    return rmatmul(x, w, "bf16" if _mode == "bf16" else None)


def pconv_operands(x: torch.Tensor, w: torch.Tensor):
    """A convolution's operands under the mode: rounded to bfloat16 in
    'bf16', else unchanged."""
    if _mode == "bf16":
        return round_operand(x, "bf16"), round_operand(w, "bf16")
    return x, w


def grad_rounding(rounding: str | None) -> tuple[str | None, str | None]:
    """(the cotangent's rounding, the result's rounding) of a backward
    product whose forward rounded its operands by `rounding`
    (kernel_rounding of the device): none for None; TF32 operands and an
    unrounded result for 'tf32'; an unrounded cotangent and a bfloat16
    result for 'bf16'. The forward's own operand enters rounded as the
    forward rounded it."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"unknown rounding {rounding!r}")
    return (rounding, None) if rounding == "tf32" else (None, rounding)


def grad_matmul(cot: torch.Tensor, w: torch.Tensor,
                rounding: str | None) -> torch.Tensor:
    """A backward product cot @ w: cot a cotangent, w the forward's
    operand (transposed as the product needs it), both rounded and the
    result rounded as `grad_rounding(rounding)` says."""
    rc, rr = grad_rounding(rounding)
    return round_operand(torch.matmul(round_operand(cot, rc),
                                      round_operand(w, rounding)), rr)


# Steps a chunk of a per-step weight gradient: a whole read (12 288 steps at
# S = 96) would hold about 0.9 GB of [T, S, 2S] terms at once.
_WEIGHT_GRAD_CHUNK = 512


def weight_grad(a: torch.Tensor, d: torch.Tensor, rounding: str | None,
                per_step: bool = False) -> torch.Tensor:
    """The weight gradient of a product: a [..., K], the forward's operand,
    and d [..., N], the cotangent of the product -> [K, N], the sum over
    every leading axis of a^T d, the operands and the result rounded as
    `grad_matmul` rounds them: one product, rounded once. per_step, for a
    product inside a recurrence (a and d [T, B, .]): with a rounding of
    the result (bf16) each step's [K, N] product is rounded, then the
    steps are summed in fp32, _WEIGHT_GRAD_CHUNK steps at a time
    (torch.bmm)."""
    rc, rr = grad_rounding(rounding)
    a, d = round_operand(a, rounding), round_operand(d, rc)
    if rr is None or not per_step:
        return round_operand(torch.matmul(a.reshape(-1, a.shape[-1]).T,
                                          d.reshape(-1, d.shape[-1])), rr)
    out = a.new_zeros((a.shape[-1], d.shape[-1]))
    chunk = _WEIGHT_GRAD_CHUNK
    for t in range(0, a.shape[0], chunk):
        terms = torch.bmm(a[t : t + chunk].transpose(1, 2), d[t : t + chunk])
        out += round_operand(terms, rr).sum(0)
    return out


set_precision(os.environ.get(ENV) or "highest")
