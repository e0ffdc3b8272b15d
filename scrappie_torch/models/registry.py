"""Model weights: the repository's npz files, read by path.

Counterpart of scrappie_tpu/models/registry.py:load_params. The weights
are data beside the JAX package (scrappie_tpu/models/params/<model>.npz);
the port reads those files and imports nothing of that package. A missing
file raises FileNotFoundError: the port never synthesises weights.
"""

from __future__ import annotations

import pathlib

import numpy as np

from scrappie_torch.models.specs import RAW_MODELS

PARAMS_DIR = (pathlib.Path(__file__).resolve().parents[2] / "scrappie_tpu"
              / "models" / "params")

_cache: dict[str, dict[str, np.ndarray]] = {}


def get_model_stride(model: str) -> int:
    """Stride of a raw model (ref get_raw_model_stride, src/networks.c:87-106)."""
    try:
        return RAW_MODELS[model].stride
    except KeyError:
        raise ValueError(f"Invalid model {model!r}") from None


def weights_path(model: str) -> pathlib.Path:
    """The npz file of a model's weights."""
    return PARAMS_DIR / f"{model}.npz"


def load_params(model: str) -> dict[str, np.ndarray]:
    """Load (and cache) the parameter dict of a model by name."""
    if model not in _cache:
        npz = weights_path(model)
        if not npz.exists():
            raise FileNotFoundError(f"no weights for model {model!r}: {npz}")
        with np.load(npz) as z:
            _cache[model] = {k: z[k] for k in z.files}
    return _cache[model]
