"""Empirical simulator fitted to labelled real reads.

Counterpart of scrappie_tpu/train/realsim.py, numpy on the host with the
JAX package's draws in the same order, so one seed gives the same
batches. train/simulate.py generates signal from the squiggle_r94 level
model with iid Laplace noise, but the bundled truth reads are older R9
data whose levels correlate with squiggle_r94 at only ~0.65, whose noise
is strongly AR(1)-autocorrelated (lag-1 ~0.83) and whose speeds span
12-19 samples/base (figures of the JAX package's notes).

This module fits a generative model to labelled reads (train/realdata.py):
  * per-5mer level table, shrunk toward the 3-mer (centre trimer) table
    by observation count;
  * AR(1) noise (phi, sigma) fitted to the level residuals;
  * an empirical per-base dwell pool, resampled with a per-window rate
    factor so models learn speed invariance;
  * slow baseline drift + gain jitter, with medmad renormalisation.

It also augments real windows (gain/offset/extra-noise/time-warp) so
fine-tuning on few reads does not collapse into memorisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from scrappie_torch.models.specs import KMER_LEN
from scrappie_torch.train.realdata import (LabelledRead, crf_labels,
                                           transducer_labels)
from scrappie_torch.train.simulate import _rolling_kmers, window_seqstates


@dataclasses.dataclass
class ReadStats:
    """Per-read noise/dwell/sequence statistics (round 3).

    The global fit pools reads, but the bundled reads differ materially
    (translocation 12-19 samples/base, distinct AR(1) noise); sampling a
    read identity per synthetic window and using ITS statistics teaches
    the model the real per-read correlation structure instead of an
    averaged one that matches neither read.
    """

    phi: float
    sigma: float
    dwell_pool: np.ndarray  # int64 per-base dwells of this read
    bases: np.ndarray       # int64 truth bases (for real-sequence windows)


@dataclasses.dataclass
class EmpiricalModel:
    """Per-kmer levels + noise/dwell statistics fitted to labelled reads."""

    level: np.ndarray       # float32 [4**klen]
    level_sd: np.ndarray    # float32 [4**klen]
    phi: float              # AR(1) coefficient of the residual noise
    sigma: float            # stationary sd of the residual noise
    dwell_pool: np.ndarray  # int64, per-base dwell observations (samples)
    klen: int = KMER_LEN
    read_stats: list | None = None  # list[ReadStats], one per fitted read

    @classmethod
    def fit(cls, reads: list[LabelledRead], klen: int = KMER_LEN,
            min_count: int = 2, shrink: float = 8.0) -> "EmpiricalModel":
        nk = 4 ** klen
        sums = np.zeros(nk)
        sqs = np.zeros(nk)
        cnts = np.zeros(nk)
        tri_sums = np.zeros(64)
        tri_cnts = np.zeros(64)
        resid_pairs = []  # (r[t-1], r[t]) for AR(1) fit
        dwells = []
        for r in reads:
            kmers = _rolling_kmers(r.bases, klen)
            m = r.base_at >= klen - 1
            k_at = kmers[np.clip(r.base_at, 0, len(kmers) - 1)]
            obs = r.norm[m]
            k_m = k_at[m]
            sums += np.bincount(k_m, weights=obs, minlength=nk)
            sqs += np.bincount(k_m, weights=obs * obs, minlength=nk)
            cnts += np.bincount(k_m, minlength=nk)
            # centre trimer of the 5-mer (positions 1..3 of bases)
            tri = (k_m >> 2) & 0x3F
            tri_sums += np.bincount(tri, weights=obs, minlength=64)
            tri_cnts += np.bincount(tri, minlength=64)
            # dwell pool: run lengths of base_at over aligned samples
            # (one entry per read, possibly empty, so per-read stats can
            # index it by read position)
            ba = r.base_at[r.base_at >= 0]
            if len(ba):
                change = np.flatnonzero(np.diff(ba) != 0)
                dwells.append(np.diff(np.concatenate([[-1], change])))
            else:
                dwells.append(np.zeros(0, dtype=np.int64))
        tri_mean = tri_sums / np.maximum(tri_cnts, 1)
        tri_of_k = (np.arange(nk) >> 2) & 0x3F
        k_mean = sums / np.maximum(cnts, 1)
        # shrink the 5-mer mean toward its centre-trimer mean
        w = cnts / (cnts + shrink)
        level = w * k_mean + (1 - w) * tri_mean[tri_of_k]
        level[cnts + tri_cnts[tri_of_k] == 0] = 0.0
        k_var = np.maximum(sqs / np.maximum(cnts, 1) - k_mean ** 2, 1e-4)
        sd_global = float(np.sqrt(np.median(k_var[cnts >= min_count])))
        level_sd = np.where(cnts >= min_count, np.sqrt(k_var), sd_global)

        # AR(1) noise from the MIDDLE samples of long dwells, residual to
        # the per-base mean: this excludes level-table error, alignment
        # error and base-boundary transition samples, which otherwise
        # inflate sigma ~1.6x (measured).  Fitted PER READ (round 3) and
        # pooled for the global numbers.
        ac_num = ac_den = 0.0
        read_stats: list[ReadStats] = []
        for ri, r in enumerate(reads):
            ba = r.base_at
            change = np.flatnonzero(np.diff(ba) != 0) + 1
            bounds = np.concatenate([[0], change, [len(ba)]])
            r_num = r_den = 0.0
            r_resid = []
            for i in range(len(bounds) - 1):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                if ba[lo] < 0 or hi - lo < 7:
                    continue
                mid = r.norm[lo + 2 : hi - 2]
                resid = mid - mid.mean()
                resid_pairs.append(resid)
                r_resid.append(resid)
                r_num += float((resid[:-1] * resid[1:]).sum())
                r_den += float((resid * resid).sum())
            ac_num += r_num
            ac_den += r_den
            r_all = (np.concatenate(r_resid) if r_resid
                     else np.zeros(2, dtype=np.float64))
            r_pool = (dwells[ri] if ri < len(dwells) and len(dwells[ri])
                      else np.full(100, 10, dtype=np.int64))
            read_stats.append(ReadStats(
                float(np.clip(r_num / max(r_den, 1e-9), 0.0, 0.98)),
                float(r_all.std()), np.asarray(r_pool, np.int64),
                np.asarray(r.bases, np.int64)))
        allr = (np.concatenate(resid_pairs) if resid_pairs
                else np.zeros(2, dtype=np.float64))
        phi = float(np.clip(ac_num / max(ac_den, 1e-9), 0.0, 0.98))
        sigma = float(allr.std())
        pool = (np.concatenate(dwells) if dwells
                else np.zeros(0, dtype=np.int64))
        if not len(pool):
            pool = np.full(1000, 10, dtype=np.int64)
        return cls(level.astype(np.float32), level_sd.astype(np.float32),
                   phi, sigma, pool.astype(np.int64), klen, read_stats)


class RealisticSimulator:
    """Signal/label batches from the fitted empirical model.

    Mirrors train/simulate.SquiggleSimulator's batch API so the trainer
    can mix the two sources.
    """

    def __init__(self, model: EmpiricalModel, seed: int = 0,
                 rate_range: tuple[float, float] = (0.7, 1.5),
                 drift_sd: float = 0.12, gain_jitter: float = 0.08,
                 occurrence_jitter: float = 0.28, real_seq_p: float = 0.5,
                 rate_drift: float = 0.12, hetero_sd: bool = True):
        """real_seq_p: probability a window's base sequence is a random
        substring of a fitted read's truth sequence instead of uniform
        random bases — real genomic composition (homopolymers, repeats)
        is far from uniform, and decode errors concentrate there.
        rate_drift: within-window translocation-rate modulation (the
        real reads' speed wanders slowly).  hetero_sd: scale the AR(1)
        noise per sample by the fitted per-kmer sd (heteroscedastic
        pore noise) instead of one global sigma."""
        self.m = model
        self.rng = np.random.default_rng(seed)
        self.rate_range = rate_range
        self.drift_sd = drift_sd
        self.gain_jitter = gain_jitter
        self.occurrence_jitter = occurrence_jitter
        self.real_seq_p = real_seq_p if model.read_stats else 0.0
        self.rate_drift = rate_drift
        self.hetero_sd = hetero_sd
        # per-kmer noise scale relative to the global sigma, clipped so
        # sparse-kmer outliers can't explode a window
        med_sd = float(np.median(model.level_sd)) or 1.0
        self._sd_scale = np.clip(model.level_sd / med_sd, 0.6, 1.9
                                 ).astype(np.float32)

    def _synth(self, nsample: int):
        """One read window: (signal [nsample], base_at [nsample], bases)."""
        m, rng = self.m, self.rng
        # sample a read identity: its noise/dwell stats (and possibly its
        # sequence) shape this window
        rs = None
        if m.read_stats:
            rs = m.read_stats[int(rng.integers(len(m.read_stats)))]
        pool = rs.dwell_pool if rs is not None and len(rs.dwell_pool) \
            else m.dwell_pool
        phi = rs.phi if rs is not None else m.phi
        sigma = rs.sigma if rs is not None else m.sigma
        rate = rng.uniform(*self.rate_range)
        n_bases = int(nsample / (np.mean(pool) * rate)) + m.klen + 24
        if rs is not None and rng.uniform() < self.real_seq_p \
                and len(rs.bases) > n_bases:
            s0 = int(rng.integers(len(rs.bases) - n_bases))
            bases = rs.bases[s0 : s0 + n_bases].copy()
        else:
            bases = rng.integers(0, 4, size=n_bases)
        kmers = _rolling_kmers(bases, m.klen)
        # within-window rate drift: smooth exp-ramp between two rates
        if self.rate_drift > 0:
            r1 = rate * float(np.exp(rng.uniform(-self.rate_drift,
                                                 self.rate_drift)))
            rate_per_base = np.linspace(rate, r1, n_bases)
        else:
            rate_per_base = np.full(n_bases, rate)
        dwells = np.maximum(
            1, np.round(rng.choice(pool, size=n_bases) * rate_per_base)
        ).astype(np.int64)
        base_at = np.repeat(np.arange(n_bases), dwells)
        if len(base_at) < nsample:
            reps = -(-nsample // len(base_at))
            base_at = np.tile(base_at, reps)
        base_at = base_at[:nsample]
        # per-base level: kmer table + independent per-OCCURRENCE jitter
        # (pore-state variation between visits of the same kmer)
        base_lvl = (m.level[kmers]
                    + self.occurrence_jitter * rng.standard_normal(n_bases)
                    ).astype(np.float32)
        sig = base_lvl[base_at]
        # AR(1) noise at the fitted stationary sd: x[t] = sum_k phi^k e[t-k],
        # kernel truncated where phi^k < 1e-3 (exact to ~0.1%)
        innov_sd = sigma * np.sqrt(1.0 - phi ** 2)
        e = rng.standard_normal(nsample) * innov_sd
        ntap = max(1, int(np.ceil(np.log(1e-3) / np.log(max(phi, 1e-6)))))
        kernel = phi ** np.arange(ntap)
        noise = np.convolve(e, kernel)[:nsample]
        if self.hetero_sd:
            # heteroscedastic pore noise: per-kmer sd modulation on top
            # of the read's AR(1) correlation structure
            noise = noise * self._sd_scale[kmers[base_at]]
        sig = sig + noise
        # slow baseline drift: smoothed random walk
        drift = np.cumsum(rng.standard_normal(nsample))
        drift *= self.drift_sd / max(np.abs(drift).max(), 1e-9)
        sig = sig + drift
        sig = sig * (1.0 + self.gain_jitter * rng.standard_normal())
        med = np.median(sig)
        mad = np.median(np.abs(sig - med)) * 1.4826
        sig = (sig - med) / max(mad, 1e-6)
        return sig.astype(np.float32), base_at, bases

    def labelled_batch(self, batch: int, nsample: int, stride: int,
                       klen: int = KMER_LEN):
        nblock = nsample // stride
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        labels = np.full((batch, nblock), -1, dtype=np.int32)
        for b in range(batch):
            sig, base_at, bases = self._synth(nsample)
            sigs[b, :, 0] = sig
            labels[b] = transducer_labels(base_at, bases, stride, klen)
        return sigs, labels

    def seq_batch(self, batch: int, nsample: int, L: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        """(sigs [B,nsample,1], seqstates [B,L]) for the lattice loss."""
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        seqs = np.full((batch, L), -1, dtype=np.int32)
        for b in range(batch):
            sig, base_at, bases = self._synth(nsample)
            sigs[b, :, 0] = sig
            seqs[b] = window_seqstates(base_at, bases, L)
        return sigs, seqs

    def crf_labelled_batch(self, batch: int, nsample: int, stride: int):
        nblock = nsample // stride
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        labels = np.full((batch, nblock), -1, dtype=np.int32)
        for b in range(batch):
            sig, base_at, bases = self._synth(nsample)
            sigs[b, :, 0] = sig
            labels[b] = crf_labels(base_at, bases, stride)
        return sigs, labels


def augment_window(sig: np.ndarray, base_at: np.ndarray, rng,
                   warp_range=(0.85, 1.18), gain_sd=0.06, offset_sd=0.08,
                   noise_sd=0.12) -> tuple[np.ndarray, np.ndarray]:
    """Augment a real window: time-warp + gain/offset + extra noise.

    The warp resamples the signal by a random factor (linear interp) and
    maps the per-sample base index through the same coordinates, so the
    labels stay aligned.
    """
    n = len(sig)
    f = rng.uniform(*warp_range)
    src = np.arange(n) * f
    src = src[src <= n - 1]
    out = np.interp(src, np.arange(n), sig)
    ba = base_at[np.minimum(np.round(src).astype(np.int64), n - 1)]
    out = out * (1.0 + gain_sd * rng.standard_normal())
    out = out + offset_sd * rng.standard_normal()
    if noise_sd > 0:
        out = out + noise_sd * rng.standard_normal(len(out))
    return out.astype(np.float32), ba
