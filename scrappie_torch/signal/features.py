"""Feature extraction feeding the neural networks.

Behavioural spec: ref src/nnfeatures.c.  Output layout is time-major
[T, nfeature] float32 (the reference stores features as matrix columns).
A copy of scrappie_tpu/signal/features.py.
"""

from __future__ import annotations

import numpy as np

from scrappie_torch.types import EventTable, RawSignal
from scrappie_torch.utils.maths import madf


def feature_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Studentisation statistics (m*rsd, rsd) per feature column
    (float64 accumulation; see studentise_features for semantics)."""
    m = feats.astype(np.float64).mean(axis=0)
    v = (feats.astype(np.float64) ** 2).mean(axis=0) - m * m
    # A (near-)constant column has v <= 0 up to cancellation; the
    # reference's rsqrt emits ±inf features there, which would poison
    # the net.  A zero-variance feature carries no
    # information: studentise it to exactly 0 instead.
    safe = v > 0.0
    rsd = np.where(safe, 1.0 / np.sqrt(np.where(safe, v, 1.0)), 0.0)
    return (m * rsd).astype(np.float32), rsd.astype(np.float32)


def apply_feature_stats(feats: np.ndarray,
                        stats: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    mrsd, rsd = stats
    return (feats * rsd - mrsd).astype(np.float32)


def studentise_features(feats: np.ndarray) -> np.ndarray:
    """Per-feature studentisation across events (float64 accumulation).

    Matches ref src/nnfeatures.c:46-72, except the reference uses an
    *approximate* reciprocal square root (_mm_rsqrt_ps, ~1e-3 relative
    error): we use the exact value, so features agree to ~1e-3 relative.
    """
    return apply_feature_stats(feats, feature_stats(feats))


def nanonet_features_from_events(et: EventTable, normalise: bool = True) -> np.ndarray:
    """4 features per event: mean, stdv, length, |delta mean| (last = 0).

    (ref src/nnfeatures.c:74-99.)
    """
    ev = et.active
    nevent = len(ev)
    feats = np.zeros((nevent, 4), dtype=np.float32)
    feats[:, 0] = ev["mean"]
    feats[:, 1] = ev["stdv"]
    feats[:, 2] = ev["length"]
    feats[:-1, 3] = np.abs(ev["mean"][:-1] - ev["mean"][1:])

    if normalise:
        feats = studentise_features(feats)
    return feats


def features_from_raw(rt: RawSignal) -> np.ndarray:
    """Raw signal as a [T, 1] feature matrix (ref src/nnfeatures.c:102-115)."""
    return rt.trimmed.reshape(-1, 1).astype(np.float32)


def deltasample_features_from_raw(
    rt: RawSignal, shift: float, scale: float, sdthresh: float
) -> np.ndarray:
    """Forward-differenced, shift/scaled, outlier-filtered signal.

    (ref src/nnfeatures.c:118-133)
    """
    sig = rt.trimmed.astype(np.float32)
    sig_mad = madf(sig)
    d = np.zeros_like(sig)
    d[:-1] = sig[1:] - sig[:-1]
    d = (d - np.float32(shift)) / np.float32(scale)
    d[np.abs(d) > sdthresh * sig_mad] = 0.0
    return d.reshape(-1, 1)
