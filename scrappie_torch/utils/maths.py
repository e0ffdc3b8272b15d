"""Quantiles, MAD and med/MAD normalisation for the host signal pipeline.

numpy versions that follow the reference semantics exactly (ref:
src/util.{h,c}). A copy of what the port uses of
scrappie_tpu/utils/maths.py.
"""

from __future__ import annotations

import numpy as np


def quantilef(x: np.ndarray, p) -> np.ndarray:
    """Linear-interpolation quantiles, matching ref src/util.c:92-130.

    idx = floor(p * (n-1)); frac weighting between sorted neighbours.
    This is numpy's default ("linear") method.
    """
    x = np.asarray(x, dtype=np.float32)
    return np.quantile(x, np.asarray(p, dtype=np.float64)).astype(np.float32)


def medianf(x: np.ndarray) -> float:
    """Median via linear-interpolated quantile (ref src/util.c:142-146)."""
    return float(quantilef(x, 0.5))


MAD_SCALING_FACTOR = 1.4826


def madf(x: np.ndarray, med: float | None = None) -> float:
    """Median absolute deviation scaled by 1.4826 (ref src/util.c:156-179)."""
    x = np.asarray(x, dtype=np.float32)
    if x.size == 1:
        return 0.0
    if med is None:
        med = medianf(x)
    return float(medianf(np.abs(x - med))) * MAD_SCALING_FACTOR


def medmad_normalise(x: np.ndarray) -> np.ndarray:
    """(x - median) / mad, in float32 (ref src/util.c:190-204)."""
    x = np.asarray(x, dtype=np.float32)
    if x.size == 1:
        return np.zeros_like(x)
    med = medianf(x)
    mad = madf(x, med)
    return ((x - med) / np.float32(mad)).astype(np.float32)

