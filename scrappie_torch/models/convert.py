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
from scrappie_torch.models.specs import EVENTS_MODEL, RAW_MODELS, SQUIGGLE_MODELS


def params_from_numpy(params: dict[str, np.ndarray],
                      device=None) -> dict[str, torch.Tensor]:
    """npz parameter dict -> contiguous float32 tensors on `device`:
    normal tensors also under torch.inference_mode, so that what the
    kernels' wrappers derive from them once (ops.derived) stays cached and
    an in-place update is seen."""
    dev = as_device(device)
    with torch.inference_mode(False):
        return {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32),
                                   device=dev)
                for k, v in params.items()}


def model_spec(model: str):
    """The registry spec of a model: a raw model (raw_r94, rgrgr or
    rnnrf), the events model or a squiggle model. The port runs every kind
    of the registry."""
    if model == EVENTS_MODEL.name:
        return EVENTS_MODEL
    if model in SQUIGGLE_MODELS:
        return SQUIGGLE_MODELS[model]
    if model not in RAW_MODELS:
        raise KeyError(f"Model type {model!r} not recognised.")
    return RAW_MODELS[model]


def basecaller_spec(model: str):
    """model_spec of a basecaller: a squiggle model, which predicts signal
    from a sequence, is refused."""
    spec = model_spec(model)
    if spec.kind == "squiggle":
        raise ValueError(f"{model!r} predicts a squiggle from a sequence and "
                         "calls no bases: use api.sequence_to_squiggle")
    return spec


def raw_spec(model: str):
    """The spec of a raw-signal basecaller (basecaller_spec without the
    events model, whose entry point is api.basecall_events)."""
    spec = basecaller_spec(model)
    if spec.kind == "events":
        raise ValueError(f"{model!r} basecalls from events, not raw signal: "
                         "use api.basecall_events or BasecallEngine")
    return spec
