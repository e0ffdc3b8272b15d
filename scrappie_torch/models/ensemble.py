"""Posterior-ensemble validation shared by the engine and the API.

A copy of scrappie_tpu/models/ensemble.py. The combination itself (a
weighted log-domain mean, renormalised per block for transducers) lives
with its callers: the engine's posterior and fused paths, and numpy in
api.basecall_raw.
"""

from __future__ import annotations

import numpy as np

from scrappie_torch.models.specs import RAW_MODELS


def parse_members(s: str | None) -> tuple[str, ...]:
    """Parse a CLI-style comma-separated member list ('' / None = no
    ensemble); shared by every flag surface so the parsing can't
    drift."""
    return tuple(m.strip() for m in (s or "").split(",") if m.strip())


def validate_ensemble(model: str, ensemble: tuple[str, ...],
                      ensemble_weights=None) -> np.ndarray:
    """Validate an ensemble config; return normalised weights
    [1 + len(ensemble)] (primary first, default 3:1:...:1).

    Two model families can ensemble, never mixed: the per-block
    normalised transducers (rgrgr/raw — weighted log-domain posterior
    mean, renormalised per block) and the CRF family (rnnrf — weighted
    mean of the 25 shared transition energies, a log-domain product of
    experts on the state space of ref src/decode.c:836-894; no
    renormalisation, the CRF is globally normalised).  Every member
    must sit on the primary's block grid (same stride and state
    space), and the weights must be positive.
    """
    if ensemble_weights is not None and not ensemble:
        raise ValueError("ensemble_weights given without ensemble members")
    spec = RAW_MODELS.get(model)
    if spec is None or spec.kind not in ("rgrgr", "raw", "rnnrf"):
        kind = spec.kind if spec is not None else model
        raise ValueError("ensemble decoding needs per-block normalised "
                         "transducer posteriors or shared-grid CRF "
                         f"transitions (primary model kind {kind!r})")
    # Families may not mix: transducer posteriors and CRF transition
    # energies live on different state spaces.
    family = ("rnnrf",) if spec.kind == "rnnrf" else ("rgrgr", "raw")
    for m in ensemble:
        if m not in RAW_MODELS:
            raise ValueError(
                f"unknown ensemble member {m!r}; known models: "
                f"{', '.join(sorted(RAW_MODELS))}")
        ms = RAW_MODELS[m]
        if ms.kind not in family or ms.stride != spec.stride \
                or ms.nstate != spec.nstate:
            raise ValueError(
                f"ensemble member {m}: kind/stride/nstate "
                f"({ms.kind}, {ms.stride}, {ms.nstate}) must match the "
                f"primary's family ({'/'.join(family)}, {spec.stride}, "
                f"{spec.nstate}) — the block grids must align")
    if ensemble_weights is None:
        ensemble_weights = (3.0,) + (1.0,) * len(ensemble)
    if len(ensemble_weights) != 1 + len(ensemble):
        raise ValueError("need one weight per model, primary first")
    w = np.asarray(ensemble_weights, np.float64)
    if not np.all(np.isfinite(w)) or np.any(w <= 0):
        raise ValueError(f"ensemble weights must be positive and finite, "
                         f"got {tuple(ensemble_weights)}")
    return w / w.sum()


def fused_config(model: str, ensemble: tuple[str, ...],
                 ensemble_weights=None):
    """(weights [K] f32, kinds, conv_activations) for the fused
    multi-model chunk pipeline (ops/pipeline.ensemble_basecall_fused),
    or None for configs it doesn't cover (no ensemble, or the rnnrf
    family — whose members combine transition energies before their
    own decode).  The engine's fast mode reads it."""
    spec = RAW_MODELS.get(model)
    if not ensemble or spec is None or spec.kind not in ("rgrgr", "raw"):
        return None
    w = validate_ensemble(model, tuple(ensemble),
                          ensemble_weights).astype(np.float32)
    specs = [spec] + [RAW_MODELS[m] for m in ensemble]
    return (w, tuple(s.kind for s in specs),
            tuple(getattr(s, "conv_activation", "elu") for s in specs))
