"""Quantiles, MAD and med/MAD normalisation for the host signal pipeline.

numpy versions that follow the reference semantics exactly (ref:
src/util.{h,c}). A copy of scrappie_tpu/utils/maths.py.
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


def studentise(x: np.ndarray) -> np.ndarray:
    """(x - mean) / std with float64 accumulation (ref src/util.c:216-245).

    The reference uses Kahan summation in double precision; plain float64
    numpy sums are at least as accurate.
    """
    x = np.asarray(x, dtype=np.float32)
    m = x.astype(np.float64).mean()
    v = (x.astype(np.float64) ** 2).mean() - m * m
    sd = np.sqrt(v)
    return ((x - np.float32(m)) / np.float32(sd)).astype(np.float32)


def logsumexp2(x: float, y: float) -> float:
    """Pairwise log-sum-exp (ref src/util.h:162-164)."""
    mx = max(x, y)
    return mx + np.log1p(np.exp(-abs(x - y)))


def loglaplace(x, loc, sc, logsc):
    """Log-density of the Laplace distribution (ref src/util.h:75-77)."""
    return -np.abs(x - loc) / sc - logsc - np.log(2.0)


def plogistic(x):
    """Logistic CDF (ref src/util.h:110-112)."""
    return 0.5 * (1.0 + np.tanh(x / 2.0))
