"""Per-base quality scores from block posteriors (host-side).

A copy of scrappie_tpu/post/quality.py: the reference emits FASTA/SAM with
no qualities (ref src/scrappie_raw.c:317-331), so each emitted base gets a
confidence from the posteriors the decoders already produce:

- transducer models: the emitting block's posterior marginal of that base
  at its kmer position, renormalised over the kmer states (stay mass
  conditioned away); the emission layout is the overlapper's;
- CRF model (rnnrf): the exact per-base state posterior from
  forward-backward (decode/crf.posterior_crf) at each emitting block.

Qualities are Phred+33; the error floor is 1e-6 (cap Q60). QUAL_RECAL
holds the JAX package's measured capped-linear Phred recalibrations
(fitted there on the bundled truth reads), which qual_calibration="real"
applies.
"""

from __future__ import annotations

import numpy as np

from scrappie_torch.post.overlapper import (
    NBASE,
    kmer_len_from_nkmer,
    overlap_lengths,
)

_MIN_ERR = 1e-6  # Phred cap: Q60

#: Measured quality recalibration (Phred space), the JAX package's fit:
#: empirical Q ~= min(a * predicted Q + b, cap), least squares over 4-wide
#: Q bins on the bundled truth reads, capped at the empirical plateau. The
#: raw proxies are monotone but mis-calibrated (rgrgr_r94 predicted Q20-23
#: is empirically Q11.7 there). Opt-in via qual_calibration="real" on the
#: engine and --qual-calibration real on the CLI; the default stream stays
#: the raw proxy.
QUAL_RECAL: dict[str, tuple[float, float, float]] = {
    "rgrgr_r94": (0.283, 5.20, 12.6),
    "rgrgr_r941": (0.274, 6.03, 12.1),
    "rgrgr_r10": (0.212, 5.60, 10.9),
    "raw_r94": (0.268, 6.56, 12.5),
    "rnnrf_r94": (0.293, 5.12, 12.3),
    "nanonet_events": (0.223, 6.27, 13.3),
    # An ensemble configuration has its own fit, keyed "model+member+...",
    # members sorted (their order does not change the posterior). It
    # applies only at its fitted default weights; the engine falls back to
    # the primary model's fit (with a warning) otherwise.
    "rgrgr_r94+rgrgr_r10+rgrgr_r941": (0.295, 5.36, 13.9),
}


def recalibrate_phred(qual: str, model: str) -> str:
    """Apply the measured capped-linear Phred-space recalibration to a
    Phred+33 quality string (KeyError for models without a fit)."""
    a, b, cap = QUAL_RECAL[model]
    q = np.frombuffer(qual.encode("ascii"), np.uint8).astype(np.float64) - 33
    q = np.clip(np.round(np.minimum(a * q + b, cap)), 0, 93).astype(np.uint8)
    return (q + 33).tobytes().decode("ascii")


def phred_string(p_correct: np.ndarray) -> str:
    """Phred+33 encode per-base correctness probabilities."""
    p_err = np.maximum(1.0 - np.asarray(p_correct, dtype=np.float64), _MIN_ERR)
    q = np.clip(np.round(-10.0 * np.log10(p_err)), 0, 93).astype(np.int64)
    return (q + 33).astype(np.uint8).tobytes().decode("ascii")


def transducer_qualities(logpost: np.ndarray, path: np.ndarray) -> str | None:
    """Qualities matching overlapper(path, nstate-1) base for base.

    logpost [nblock, nstate] log-posterior; path is the decoder's
    (nblock+1)-entry Viterbi path (-1 = stay): entry b >= 1 was decoded
    from posterior row b-1, entry 0 is the traceback's initial kmer
    (no posterior row of its own — row 0's marginal is the closest
    proxy).  Returns None when the path emits nothing (overlapper
    parity).
    """
    path = np.asarray(path)
    nonstay = path >= 0
    if not nonstay.any():
        return None
    blocks = np.flatnonzero(nonstay)
    kmers = path[blocks].astype(np.int64)
    nkmer = logpost.shape[1] - 1  # stay = last column
    klen = kmer_len_from_nkmer(nkmer)

    # per-position base marginals of each emitting block's kmer
    # posterior, renormalised over the kmer states: [n, klen, NBASE]
    rows = np.maximum(blocks - 1, 0)
    pk = np.exp(logpost[rows, :nkmer].astype(np.float64))
    pk /= pk.sum(-1, keepdims=True)
    pk = pk.reshape(len(rows), *([NBASE] * klen))
    marg = np.stack(
        [pk.sum(axis=tuple(a for a in range(1, klen + 1) if a != j + 1))
         for j in range(klen)], axis=1)

    # emission layout of post/overlapper._emit_bases: first kmer whole,
    # then the `o` overlap bases (the kmer's last `o` positions) of
    # each following kmer
    counts = np.concatenate([[klen], overlap_lengths(kmers, klen)])
    which = np.repeat(np.arange(len(kmers)), counts)
    starts = np.cumsum(counts) - counts
    within = np.arange(counts.sum()) - starts[which]
    kpos = klen - counts[which] + within
    digits = (kmers[which] >> (2 * (klen - 1 - kpos))) & 3
    return phred_string(marg[which, kpos, digits])


def qualities_from_stream(qstream: np.ndarray, path: np.ndarray) -> str | None:
    """Assemble the Phred string from a fused-pipeline quality stream.

    qstream uint8 [nentry, klen]: per path entry, the Phred+33 code of
    the decoded kmer's base at each kmer position (computed on device
    by ops/pipeline._fused_quality_stream — fast mode's replacement for
    host transducer_qualities, which needs the whole-read posterior).
    path [nentry] with -1 = stay.  Emission layout mirrors
    post/overlapper: the first non-stay entry emits its kmer whole,
    each later one its `o` overlap bases (the kmer's last o positions).
    """
    path = np.asarray(path)
    nonstay = path >= 0
    if not nonstay.any():
        return None
    idx = np.flatnonzero(nonstay)
    kmers = path[idx].astype(np.int64)
    klen = qstream.shape[1]
    counts = np.concatenate([[klen], overlap_lengths(kmers, klen)])
    which = np.repeat(np.arange(len(idx)), counts)
    starts = np.cumsum(counts) - counts
    within = np.arange(counts.sum()) - starts[which]
    kpos = klen - counts[which] + within
    return qstream[idx[which], kpos].tobytes().decode("ascii")


def crf_qualities(posterior: np.ndarray, path: np.ndarray,
                  npos: int | None = None) -> str | None:
    """Qualities matching crfpath_to_basecall(path, npos=npos).

    posterior [nblock+1, nstate] forward-backward probabilities (one
    row per block boundary, decode/crf.posterior_crf); path aligns row
    for row and only its first npos (default len-1) entries emit.
    """
    path = np.asarray(path)[: len(path) - 1 if npos is None else npos]
    emit = np.flatnonzero(path < NBASE)
    if emit.size == 0:
        return None
    return phred_string(posterior[emit, path[emit]])
