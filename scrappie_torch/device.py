"""Device and precision policy of the port.

Counterpart of the kernel dispatch of scrappie_tpu/ops/__init__.py; the
precision policy itself is nn/config.py (counterpart of
scrappie_tpu/nn/config.py). Its default, 'highest', is exact fp32: the
reference computes in fp32, and the parity tests hold the port to the
JAX package there. PyTorch runs a float32 matmul in full fp32 by default
but a float32 convolution through cuDNN in TF32, so the policy sets both
flags when it is imported: off under 'highest' and 'bf16', on under
'default' (TF32 on the card). SCRAPPIE_TORCH_PRECISION or the CLI's
--precision choose another mode.

There is no backend probing. Every entry point takes a `device`; a CPU
tensor runs the plain PyTorch twins, a CUDA tensor runs the hand-written
kernels, and asking for CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.nn import config  # noqa: F401  (sets the policy's flags)

#: Device the entry points use when the caller names none.
DEFAULT_DEVICE = "cuda"


def as_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve a device argument; raise for CUDA on a machine without it."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch twins")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r} (cpu or cuda)")
    return dev


def float_tensor(x, device=None) -> torch.Tensor:
    """x as a contiguous float32 tensor: a tensor stays on its own device,
    an array (any layout) goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                           device=as_device(device))
