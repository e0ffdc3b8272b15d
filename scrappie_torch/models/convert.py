"""Carry the JAX package's parameters over to the port.

The weights are the npz files beside the JAX package, read by
models/registry.py, so both packages compute the same function. The
files' layouts are kept: the port's layers take [winlen, Cin, Cout] conv
weights and [in, out] matrices, as the JAX layers do.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import as_device
from scrappie_torch.models.specs import EVENTS_MODEL, RAW_MODELS

#: Model kinds the port runs.
PORTED_KINDS = ("rgrgr", "rnnrf", "events")
#: ROADMAP.md queue-1 item that ports each model kind still missing.
_WAITING_KINDS = {"raw": "ROADMAP.md queue 1 item 10 (raw_r94)"}


def params_from_numpy(params: dict[str, np.ndarray],
                      device=None) -> dict[str, torch.Tensor]:
    """npz parameter dict -> contiguous float32 tensors on `device`."""
    dev = as_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32),
                               device=dev)
            for k, v in params.items()}


def model_spec(model: str):
    """The registry spec of a model the port runs: an rgrgr or rnnrf raw
    model, or the events model. Kinds not ported raise
    NotImplementedError naming the ROADMAP item that ports them."""
    if model == EVENTS_MODEL.name:
        return EVENTS_MODEL
    if model not in RAW_MODELS:
        raise KeyError(f"Model type {model!r} not recognised.")
    spec = RAW_MODELS[model]
    if spec.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"model {model!r} is not ported yet: {_WAITING_KINDS[spec.kind]}")
    return spec


def raw_spec(model: str):
    """The spec of a raw-signal model (model_spec without the events
    model, whose entry point is api.basecall_events)."""
    spec = model_spec(model)
    if spec.kind == "events":
        raise ValueError(f"{model!r} basecalls from events, not raw signal: "
                         "use api.basecall_events or BasecallEngine")
    return spec
