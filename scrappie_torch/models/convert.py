"""Carry the JAX package's parameters over to the port.

The weights are the registry's npz files
(scrappie_tpu/models/registry.py:load_params), so both packages compute
the same function. The registry's layouts are kept: the port's layers
take [winlen, Cin, Cout] conv weights and [in, out] matrices, as the JAX
layers do.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import as_device
from scrappie_tpu.models import registry
from scrappie_tpu.models.specs import RAW_MODELS

#: Model kinds the port runs.
PORTED_KINDS = ("rgrgr", "rnnrf")
#: ROADMAP.md queue-1 item that ports each model kind still missing.
_WAITING_KINDS = {
    "raw": "ROADMAP.md queue 1 item 10 (raw_r94)",
    "events": "ROADMAP.md queue 1 item 12 (events)",
}


def params_from_numpy(params: dict[str, np.ndarray],
                      device=None) -> dict[str, torch.Tensor]:
    """npz parameter dict -> contiguous float32 tensors on `device`."""
    dev = as_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32),
                               device=dev)
            for k, v in params.items()}


def raw_spec(model: str):
    """The registry spec of an rgrgr or rnnrf model; other kinds raise
    NotImplementedError naming the ROADMAP item that ports them."""
    if model not in RAW_MODELS:
        if model == "nanonet_events":
            raise NotImplementedError(
                f"model {model!r} is not ported yet: {_WAITING_KINDS['events']}")
        raise KeyError(f"Model type {model!r} not recognised.")
    spec = RAW_MODELS[model]
    if spec.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"model {model!r} is not ported yet: {_WAITING_KINDS[spec.kind]}")
    return spec
