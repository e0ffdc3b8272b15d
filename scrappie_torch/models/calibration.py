"""Measured real-read decode calibration presets.

The shipped raw models are trained on simulated squiggles, and on the
bundled real reads every one of them calls too many stays (the
sim-trained translocation statistics undercall real signal).  A joint
stay-penalty x skip-penalty grid on the whole-read posterior of both
bundled truth reads (BASELINE.md, "Decode calibration") found a
consistent optimum per model; for the CRF model the working knob is the
additive emit bias instead (temperature is a no-op on CRF Viterbi).

The reference has no such presets — its decode penalties default to 0
and users tune by hand (ref src/scrappie_raw.c:98-121 defaults).  We
keep those exact semantics as the default and expose the measured
optima behind ``--calibration real`` / ``calibration="real"`` so the
numbers in BASELINE.md are one flag away instead of folklore. A copy of
scrappie_tpu/models/calibration.py without its weight-hash checks (it
keeps `weights_sha`, the hash they compare).

The presets are fit to only two reads; the *direction* (positive stay
penalty) is consistent across all models and both reads, the exact
values are point estimates.  Models without a measured grid have no
preset and pass through unchanged.
"""

from __future__ import annotations

#: Reference defaults for every knob a preset may touch.  A preset only
#: fills a knob that still holds its reference default, so an explicit
#: user flag always wins (an explicit flag *equal to* the reference
#: default is indistinguishable and also gets the preset).
REFERENCE_DEFAULTS: dict[str, float] = {
    "stay_pen": 0.0,
    "skip_pen": 0.0,
    "crf_emit_bias": 0.0,
}

#: model -> decode-kwarg overrides, from the BASELINE.md grids
#: (whole-read posterior, reads ch174/ch271; identity at the optimum vs
#: the (0,0) default is quoted in BASELINE.md).  Refit with
#: scripts/calibrate_decode.py whenever shipped weights change — the
#: rnnrf optimum moved from -2.0 to -1.0 when its weights were
#: checkpoint-averaged (round 2), and to -0.5 for the round-3
#: empirical-sim-averaged weights (refit sweep 0/-0.5/-1/-1.5/-2:
#: best -0.5 = 0.6426/0.6288 whole-read).
#: Robustness rule: on reads the grid never saw, a positive skip
#: penalty can collapse the whole call into the decoder's local
#: start/end states (measured on the third bundled read: events
#: (1.5, 0.5) called 88 bases instead of ~1900, rgrgr_r10 (1.0, 0.5)
#: 436 instead of ~2000 — BASELINE.md).  Where a skip>0 grid point was
#: only statistically tied with its skip=0 neighbour, the preset ships
#: the skip=0 point; rgrgr_r94's (0.5, 0.5) is kept because it is
#: well-behaved on that read and strictly best on the truth reads.
REAL_CALIBRATION: dict[str, dict[str, float]] = {
    "rgrgr_r94": {"stay_pen": 0.5, "skip_pen": 0.5},
    "raw_r94": {"stay_pen": 1.0, "skip_pen": 0.0},
    "rgrgr_r941": {"stay_pen": 1.0, "skip_pen": 0.0},
    "rgrgr_r10": {"stay_pen": 1.0, "skip_pen": 0.0},
    # Round-4 whole-region-trained weights: the refit sweep
    # (-0.5..+1.5 on the whole-read lattices) found the reference
    # default emit bias 0.0 already optimal (ch174 best at 0.0, ch271
    # 0.5 tied with 0.0 at two-read resolution) — the whole-region
    # CRF training calibrated the stay/emit balance that the earlier
    # window-trained weights needed -2.0/-1.0/-0.5 to patch.
    "rnnrf_r94": {},
    "nanonet_events": {"stay_pen": 1.0, "skip_pen": 0.0},
}

def weights_sha(model: str) -> str:
    """16-hex sha256 prefix of the model's shipped npz weight file."""
    import hashlib

    from scrappie_torch.models.registry import weights_path

    return hashlib.sha256(weights_path(model).read_bytes()).hexdigest()[:16]


PRESETS = ("reference", "real")

#: Runtime guard for the skip-penalty collapse mode documented above.
#: Short reads (< COLLAPSE_MIN_BLOCKS blocks) are exempt because a
#: legitimately empty call is possible there.
COLLAPSE_MIN_BLOCKS = 50
#: Model-free fallback trigger (round-3 guard): a healthy call emits
#: ~1 base per 2.5-4 blocks, a TOTAL collapse ~0.015 bases/block; 5x
#: below any sane call.
COLLAPSE_BASES_PER_BLOCK = 0.05

#: Per-model bases/block priors: the MINIMUM healthy rate measured
#: across the three bundled reads x (default, real-preset-with-skip-0)
#: decodes (scripts/measure_bases_per_block.py, 2026-08-20; the
#: minimum is always the out-of-distribution ch228 read).  The round-4
#: VERDICT's measured failure — the 3:1:1 ensemble + full (0.5, 0.5)
#: preset PARTIALLY collapsing ch228 to 0.202 bases/block — sits 4x
#: ABOVE the fixed 0.05 trigger but below COLLAPSE_FRACTION of the
#: primary model's prior, so the guard now catches it.  Stride matters
#: (rnnrf's stride 2 halves its rate vs the stride-4/5 models); blocks
#: are detected events for nanonet_events.
EXPECTED_BASES_PER_BLOCK: dict[str, float] = {
    "rgrgr_r94": 0.324,
    "rgrgr_r941": 0.255,
    "rgrgr_r10": 0.260,
    "raw_r94": 0.129,
    "rnnrf_r94": 0.139,
    "nanonet_events": 0.330,
}
#: Trigger below this fraction of the model's expected rate: 0.202 /
#: 0.324 = 0.62 (the measured partial collapse) < 0.7 < 1.0 (every
#: healthy call measured).  A false trigger only costs a warning and
#: one skip_pen=0 re-decode of the flagged read.
COLLAPSE_FRACTION = 0.7


def collapsed(nbases: int, nblock: int, model: str | None = None) -> bool:
    """True when a decode emitted implausibly few bases for its block
    count — the skip_pen>0 collapse signature.

    With a model name, the trigger is COLLAPSE_FRACTION of that
    model's measured healthy bases/block prior (catches the PARTIAL
    ch228 ensemble collapse, VERDICT r4 #3); without one it falls back
    to the absolute total-collapse threshold (BASELINE.md: the events
    preset called 88 bases on ch228 instead of ~1900)."""
    if nblock < COLLAPSE_MIN_BLOCKS:
        return False
    expected = EXPECTED_BASES_PER_BLOCK.get(model or "")
    if expected is not None:
        return nbases < COLLAPSE_FRACTION * expected * nblock
    return nbases < COLLAPSE_BASES_PER_BLOCK * nblock


def preset(model: str, calibration: str = "reference",
           ensemble: tuple[str, ...] = ()) -> dict[str, float]:
    """The decode-kwarg overrides for ``model`` under ``calibration``.

    With ensemble members, any positive skip penalty in the preset is
    dropped to 0: the geometric-mean combination sharpens member
    disagreement and the full (0.5, 0.5) preset measurably
    part-collapses the out-of-distribution bundled read (0.202
    bases/block vs 0.371 at skip 0 — BASELINE.md "Posterior
    ensembling" robustness caveat), while ensemble + (stay, 0) still
    beats every single-model config on the held-out tails.  An
    explicit user skip_pen always wins (apply() only fills reference
    defaults)."""
    if calibration not in PRESETS:
        raise ValueError(
            f"unknown calibration {calibration!r} (choose from {PRESETS})")
    if calibration == "reference":
        return {}
    out = dict(REAL_CALIBRATION.get(model, {}))
    if ensemble and out.get("skip_pen"):
        out["skip_pen"] = 0.0
    return out


def apply(model: str, calibration: str, kwargs: dict,
          ensemble: tuple[str, ...] = ()) -> dict:
    """Fill preset values into ``kwargs`` for knobs left at their
    reference defaults; returns ``kwargs`` (mutated in place)."""
    for key, value in preset(model, calibration, ensemble).items():
        if kwargs.get(key, REFERENCE_DEFAULTS[key]) == REFERENCE_DEFAULTS[key]:
            kwargs[key] = value
    return kwargs
