"""Opt-in debug validation of intermediate tensors.

Counterpart of scrappie_tpu/utils/validate.py. The reference validates
every layer output in debug builds (bounds, finiteness and padding after
each layer: `validate_scrappie_matrix`, ref src/scrappie_matrix.c:138-220,
called from src/layers.c) and compiles it out under NDEBUG.

Set SCRAPPIE_TORCH_VALIDATE=1 (or call `set_enabled(True)`) and
`checked(x, name, lo, hi)` validates a tensor at a layer or stage
boundary; off, it returns x at once. A numpy array or a CPU tensor is
checked at once, and a failure raises ValidationError. A CUDA tensor is
reduced on the card to three numbers (the count of non-finite values,
the minimum and the maximum) without waiting for them; the check is
recorded, and `raise_pending()`, which the engine calls where it copies
results to the host, reads them and raises for any that failed, as the
JAX package's checks inside jit surface there.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

ENV = "SCRAPPIE_TORCH_VALIDATE"

_enabled: bool | None = None
_lock = threading.Lock()
_pending: list[tuple[str, float | None, float | None, tuple, torch.Tensor]] = []


def enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get(ENV, "") not in ("", "0")


def set_enabled(value: bool | None) -> None:
    """Force validation on or off; None restores the environment's say."""
    global _enabled
    _enabled = value


class ValidationError(ValueError):
    pass


def _failure(name: str, nbad: int, size: int, shape, mn: float, mx: float,
             lo, hi) -> str | None:
    if nbad:
        return f"{name}: {nbad}/{size} non-finite values (shape {tuple(shape)})"
    if lo is not None and mn < lo:
        return f"{name}: min {mn:g} < bound {lo:g}"
    if hi is not None and mx > hi:
        return f"{name}: max {mx:g} > bound {hi:g}"
    return None


def raise_pending() -> None:
    """Read the recorded checks of CUDA tensors and raise ValidationError
    for those that failed (all of them in one message); the record is
    cleared either way."""
    global _pending
    with _lock:
        pending, _pending = _pending, []
    msgs = []
    for name, lo, hi, shape, stats in pending:
        nbad, mn, mx = stats.tolist()
        msg = _failure(name, int(nbad), int(np.prod(shape)), shape, mn, mx,
                       lo, hi)
        if msg:
            from scrappie_torch.utils.tracing import log

            log("error", "validation failed", check=name, error=msg)
            msgs.append(msg)
    if msgs:
        raise ValidationError("; ".join(msgs))


def checked(x, name: str, lo: float | None = None, hi: float | None = None):
    """Validate x (finite, and within [lo, hi] where given); returns x
    unchanged. Nothing happens unless validation is enabled."""
    if not enabled():
        return x
    if isinstance(x, torch.Tensor):
        if x.numel() == 0:
            raise ValidationError(f"{name}: empty tensor")
        xd = x.detach()
        if xd.device.type == "cuda":
            stats = torch.stack([(~torch.isfinite(xd)).sum().to(xd.dtype),
                                 xd.min(), xd.max()])
            with _lock:
                _pending.append((name, lo, hi, tuple(x.shape), stats))
            return x
        arr = xd.cpu().numpy()
    else:
        arr = np.asarray(x)
    if arr.size == 0:
        raise ValidationError(f"{name}: empty tensor")
    finite = np.isfinite(arr)
    msg = _failure(name, int((~finite).sum()), arr.size, arr.shape,
                   float(arr.min()), float(arr.max()), lo, hi)
    if msg:
        raise ValidationError(msg)
    return x
