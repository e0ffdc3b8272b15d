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
runs. Training runs only under 'highest' (`require_highest`).
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
    ('tf32') or to bfloat16 with round to nearest even ('bf16'), in fp32."""
    if rounding is None:
        return x
    if rounding == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
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


def require_highest(what: str) -> None:
    """Raise NotImplementedError unless the mode is 'highest': training
    runs in exact fp32 only (ROADMAP.md queue 1, "Training under
    'default' / 'bf16'")."""
    if _mode != "highest":
        raise NotImplementedError(
            f"{what} runs only under precision 'highest' (now {_mode!r}): the "
            "backward kernels do not round their cotangents as the JAX "
            "package's VJP of the rounding does; see ROADMAP.md queue 1, "
            "\"Training under 'default' / 'bf16'\"")


set_precision(os.environ.get(ENV) or "highest")
