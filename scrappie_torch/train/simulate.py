"""Simulated training data: sequence -> squiggle -> raw signal + labels.

Counterpart of scrappie_tpu/train/simulate.py (SquiggleSimulator: its
simulate_read, simulate_batch, _synth_signal, labelled_batch and
crf_labelled_batch), drawing the same numbers from the same seed in the
same order. The squiggle_r94 network runs on the simulator's device
(models/forward.squiggle_forward); the rest is numpy on the host. Random
DNA is predicted as a squiggle, each base dwells a log-normally perturbed
number of samples, Laplace noise of the predicted sd is added, and each
stride-sized block is labelled as the decoders read it.

Transducer labels: per block, the kmer history ending at the block's last
sample, or the stay class when the base index did not advance since the
previous block (-1, masked, before klen bases of history). CRF labels: the
base newly emitted in the block (0-3), 4 for none, -1 where more than one
base starts.

The lattice losses' batches (seq_batch) carry instead the kmer sequence
each window traverses (window_seqstates, a copy of
scrappie_tpu/train/realdata.py's); the events batches
(events_labelled_batch, detected_events_batch) carry event features
[B, nevent, 4], the latter from the port's own event detector
(signal/events.detect_events) and nanonet features
(signal/features.nanonet_features_from_events) on simulated signal.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.models.forward import SquiggleModel
from scrappie_torch.models.specs import KMER_LEN, NSTATE_TRANSDUCER
from scrappie_torch.signal.events import detect_events
from scrappie_torch.signal.features import nanonet_features_from_events
from scrappie_torch.types import RawSignal


def _rolling_kmers(bases: np.ndarray, klen: int = KMER_LEN) -> np.ndarray:
    """kmers[j] = kmer ending at base j; j < klen-1 = 0 (mask separately).
    A copy of scrappie_tpu/train/realdata.py:_rolling_kmers."""
    seqlen = len(bases)
    kmers = np.zeros(seqlen, dtype=np.int64)
    for j in range(klen):
        kmers[klen - 1 :] += bases[j : seqlen - klen + 1 + j] << (
            2 * (klen - 1 - j))
    return kmers


def window_seqstates(base_at: np.ndarray, bases: np.ndarray, L: int,
                     klen: int = KMER_LEN) -> np.ndarray:
    """Kmer-state sequence [L] covered by a window (-1 padded) for the
    lattice loss: kmers ending at each base the window traverses. A copy of
    scrappie_tpu/train/realdata.py:window_seqstates."""
    valid = base_at[base_at >= 0]
    out = np.full(L, -1, dtype=np.int32)
    if not len(valid):
        return out
    lo = max(int(valid.min()), klen - 1)
    hi = int(valid.max())
    if hi < lo:
        return out
    kmers = _rolling_kmers(bases, klen)
    seq = kmers[lo : hi + 1][:L]
    out[: len(seq)] = seq
    return out


class SquiggleSimulator:
    def __init__(self, squiggle_model: str = "squiggle_r94", seed: int = 0,
                 device=None):
        self.model = SquiggleModel.from_registry(squiggle_model, device)
        self.rng = np.random.default_rng(seed)

    def _squiggle(self, bases: np.ndarray) -> np.ndarray:
        """(current, sd, dwell) per base of int bases [..., L], as numpy."""
        with torch.no_grad():
            seq = torch.as_tensor(bases.astype(np.int32),
                                  device=self.model.device)
            return self.model(seq, transform_units=True).cpu().numpy()

    def simulate_read(self, seqlen: int):
        """Returns (signal [T], bases [L], base_at_sample [T])."""
        rng = self.rng
        bases = rng.integers(0, 4, size=seqlen)
        sq = self._squiggle(bases)
        current, sd, dwell = sq[:, 0], sq[:, 1], sq[:, 2]
        # Per-base dwell: expected samples modulated by log-normal noise
        dwells = np.maximum(
            1, np.round(dwell * np.exp(0.25 * rng.standard_normal(seqlen)))
        ).astype(np.int64)
        base_at_sample = np.repeat(np.arange(seqlen), dwells)
        sig = current[base_at_sample]
        # Laplace current noise with the predicted per-base sd
        noise = rng.laplace(0.0, 1.0, size=len(sig)) * sd[base_at_sample]
        return (sig + noise).astype(np.float32), bases, base_at_sample

    def simulate_batch(self, batch: int, seqlen: int):
        """Batched variant: ONE squiggle forward for all reads.

        Returns (currents [B, L], sds [B, L], dwells [B, L] int, bases [B, L]).
        """
        rng = self.rng
        bases = rng.integers(0, 4, size=(batch, seqlen))
        sq = self._squiggle(bases)
        current, sd, dwell = sq[..., 0], sq[..., 1], sq[..., 2]
        dwells = np.maximum(
            1, np.round(dwell * np.exp(0.25 * rng.standard_normal(dwell.shape)))
        ).astype(np.int64)
        return current, sd, dwells, bases

    def _synth_signal(self, current, sd, dwells, nsample: int):
        """(base_at [nsample], normalised signal [nsample]) for one read."""
        rng = self.rng
        base_at = np.repeat(np.arange(len(dwells)), dwells)
        if len(base_at) < nsample:  # short total dwell: tile to cover
            base_at = np.tile(base_at, -(-nsample // len(base_at)))
        base_at = base_at[:nsample]
        sig = current[base_at]
        sig = sig + rng.laplace(0.0, 1.0, size=nsample) * sd[base_at]
        med = np.median(sig)
        mad = np.median(np.abs(sig - med)) * 1.4826
        return base_at, ((sig - med) / max(mad, 1e-6)).astype(np.float32)

    def labelled_batch(self, batch: int, nsample: int, stride: int,
                       klen: int = KMER_LEN):
        """Fixed-shape batch: signals [B, nsample, 1], labels [B, nblock].

        Stay class = NSTATE-1.  Blocks before klen bases of history get
        label -1 (masked out of the loss).
        """
        nblock = nsample // stride
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        labels = np.full((batch, nblock), -1, dtype=np.int32)
        # Enough bases to cover nsample samples at worst-case short dwells
        seqlen = int(nsample / 3) + klen + 16
        current, sd, dwells, bases = self.simulate_batch(batch, seqlen)
        for b in range(batch):
            base_at, sigs[b, :, 0] = self._synth_signal(
                current[b], sd[b], dwells[b], nsample)
            kmers = _rolling_kmers(bases[b], klen)

            last = base_at[stride - 1 :: stride][:nblock]
            lab = kmers[last]
            prev_last = np.concatenate([[-1], last[:-1]])
            lab = np.where(last == prev_last, NSTATE_TRANSDUCER - 1, lab)
            lab[last < klen - 1] = -1
            labels[b] = lab
        return sigs, labels

    def crf_labelled_batch(self, batch: int, nsample: int, stride: int):
        """Fixed-shape batch with CRF state labels [B, nblock].

        CRF states: 0..3 = the base newly emitted in the block (ACGT),
        4 = blank (no base boundary in the block; the decoder's stay,
        decode/crf.crfpath_to_basecall).  Blocks where more than one
        base starts are ambiguous under the one-emission-per-block CRF
        and are masked with -1.
        """
        nblock = nsample // stride
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        labels = np.full((batch, nblock), -1, dtype=np.int32)
        seqlen = int(nsample / 3) + 16
        current, sd, dwells, bases = self.simulate_batch(batch, seqlen)
        for b in range(batch):
            base_at, sigs[b, :, 0] = self._synth_signal(
                current[b], sd[b], dwells[b], nsample)

            last = base_at[stride - 1 :: stride][:nblock]
            prev_last = np.concatenate([[-1], last[:-1]])
            nnew = last - prev_last
            lab = np.where(nnew == 0, 4, bases[b][np.minimum(last, seqlen - 1)])
            lab[nnew > 1] = -1          # more than one base in the block
            labels[b] = lab
        return sigs, labels

    def seq_batch(self, batch: int, nsample: int, L: int,
                  klen: int = KMER_LEN):
        """(sigs [B,nsample,1], seqstates [B,L]) for the lattice loss
        (train/lattice.py): the kmer sequence each window traverses."""
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        seqs = np.full((batch, L), -1, dtype=np.int32)
        seqlen = int(nsample / 3) + klen + 16
        current, sd, dwells, bases = self.simulate_batch(batch, seqlen)
        for b in range(batch):
            base_at, sigs[b, :, 0] = self._synth_signal(
                current[b], sd[b], dwells[b], nsample)
            seqs[b] = window_seqstates(base_at, bases[b], L, klen)
        return sigs, seqs

    def events_labelled_batch(self, batch: int, nevent: int,
                              split_prob: float = 0.25,
                              klen: int = KMER_LEN):
        """Fixed-shape event batch for the nanonet events net.

        feats [B, nevent, 4] studentised (mean, stdv, length, |dmean|,
        matching signal/features.nanonet_features_from_events); labels
        [B, nevent] = kmer history of the event, stay (NSTATE-1) for
        over-segmented duplicates (an event split in two, probability
        split_prob — the reference's event detector over-segments), -1
        masked before klen bases of history.
        """
        rng = self.rng
        seqlen = nevent + klen + 8
        current, sd, dwells, bases = self.simulate_batch(batch, seqlen)
        feats = np.zeros((batch, nevent, 4), dtype=np.float32)
        labels = np.full((batch, nevent), -1, dtype=np.int32)
        for b in range(batch):
            kmers = _rolling_kmers(bases[b], klen)
            kmers[: klen - 1] = -1
            # event list: one per base, split some into two (stay)
            base_idx = []
            stay = []
            for j in range(seqlen):
                base_idx.append(j)
                stay.append(False)
                if rng.random() < split_prob:
                    base_idx.append(j)
                    stay.append(True)
                if len(base_idx) >= nevent:
                    break
            base_idx = np.array(base_idx[:nevent])
            stay = np.array(stay[:nevent])
            mean = current[b, base_idx] + 0.3 * sd[b, base_idx] * rng.standard_normal(nevent)
            stdv = np.abs(sd[b, base_idx] * (1.0 + 0.3 * rng.standard_normal(nevent)))
            # A split event halves BOTH halves (its successor is the
            # stay): otherwise length would be a giveaway cue real event
            # tables don't have.
            next_stay = np.concatenate([stay[1:], [False]])
            halved = stay | next_stay
            length = dwells[b, base_idx] / 4000.0 * np.where(halved, 0.5, 1.0)
            feats[b, :, 0] = mean
            feats[b, :, 1] = stdv
            feats[b, :, 2] = length
            feats[b, :-1, 3] = np.abs(mean[:-1] - mean[1:])
            m = feats[b].astype(np.float64).mean(axis=0)
            v = (feats[b].astype(np.float64) ** 2).mean(axis=0) - m * m
            rsd = 1.0 / np.sqrt(np.maximum(v, 1e-12))
            feats[b] = ((feats[b] * rsd) - m * rsd).astype(np.float32)
            lab = kmers[base_idx].astype(np.int32)
            lab = np.where(stay, NSTATE_TRANSDUCER - 1, lab)
            lab[kmers[base_idx] < 0] = -1
            labels[b] = lab
        return feats, labels

    def detected_events_batch(self, batch: int, nevent: int,
                              klen: int = KMER_LEN, return_truth: bool = False):
        """Event batch produced by the event detector.

        Simulates raw signal, runs signal/events.detect_events (the
        two-window t-stat detector the events CLI uses), extracts the
        nanonet features from the detected table, and labels each event
        with the kmer at its last sample (stay when the base did not
        advance). With return_truth, also each row's truth sequence: the
        bases from klen - 1 before its first labelled event's base to its
        last's ("" where no event is labelled).
        """
        nsample = nevent * 10  # detector yields roughly one event per ~9 samples
        seqlen = int(nsample / 3) + klen + 16
        current, sd, dwells, bases = self.simulate_batch(batch, seqlen)
        feats = np.zeros((batch, nevent, 4), dtype=np.float32)
        labels = np.full((batch, nevent), -1, dtype=np.int32)
        truths: list[str] = []
        for b in range(batch):
            base_at, sig = self._synth_signal(current[b], sd[b], dwells[b],
                                              nsample)
            et = detect_events(RawSignal(sig))
            ev = et.active
            f = nanonet_features_from_events(et)[:nevent]
            feats[b, : len(f)] = f
            kmers = _rolling_kmers(bases[b], klen)
            last_sample = np.minimum(
                ev["start"].astype(np.int64)
                + ev["length"].astype(np.int64) - 1, nsample - 1)[:nevent]
            ev_base = base_at[last_sample]
            lab = kmers[ev_base].astype(np.int32)
            prev_base = np.concatenate([[-1], ev_base[:-1]])
            lab = np.where(ev_base == prev_base, NSTATE_TRANSDUCER - 1, lab)
            lab[ev_base < klen - 1] = -1
            labels[b, : len(lab)] = lab
            labels[b, len(lab) :] = -1
            if return_truth:
                vb = ev_base[ev_base >= klen - 1]
                if len(vb):
                    lo, hi = int(vb.min()) - (klen - 1), int(vb.max())
                    truths.append("".join("ACGT"[x]
                                          for x in bases[b, lo : hi + 1]))
                else:
                    truths.append("")
        if return_truth:
            return feats, labels, truths
        return feats, labels
