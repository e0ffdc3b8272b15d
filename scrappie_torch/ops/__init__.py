"""Hand-written CUDA kernels for the hot sequential loops, with their twins.

Counterpart of scrappie_tpu/ops. Each wrapper here takes tensors on one
device: on the CPU it runs its plain PyTorch twin (same module), on a
CUDA device it launches its kernel from `csrc/` (built by `_build`) or
raises. It never falls back from one to the other.

`LAUNCHES` counts kernel launches per wrapper. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

#: Dynamic shared memory a block may use on sm_90.
MAX_SMEM_BYTES = 232448

LAUNCHES: dict[str, int] = {
    "gru_layer": 0,
    "viterbi_fwd": 0,
    "viterbi_backtrace": 0,
    "viterbi_fused": 0,
    "crf_fwd": 0,
    "crf_backtrace": 0,
    "crf_partition": 0,
    "lstm_layer": 0,
    "dtw": 0,
    "seqmap": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raises for anything else (mixed or other devices)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {str(dev)!r} (cpu or cuda)")


def check_kernel_input(name: str, t: torch.Tensor, shape: tuple,
                       dtype: torch.dtype = torch.float32) -> None:
    """Raise unless `t` has the shape, dtype and layout a kernel takes."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def f32(v: float) -> float:
    """A Python number as the float32 value the kernels and JAX use."""
    return float(np.float32(v))


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) by jnp.logaddexp's formula, which the kernels
    copy: max(a, b) + log1p(exp(-|a - b|)), and a + b where a - b is NaN
    (two infinities of one sign), so that logaddexp(-inf, -inf) = -inf."""
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-delta.abs())))


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of all of x by jax.nn.logsumexp's formula: the maximum,
    replaced by 0 where it is not finite, is taken out of the sum."""
    m = x.max()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m).sum()) + m


def first_argmax(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, index of its first occurrence) along `dim`: the tie rule of
    the JAX programs' argmax, which the kernels copy."""
    m = x.amax(dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).view(shape)
    first = torch.where(x == m, idx, n).amin(dim)
    return m.squeeze(dim), first
