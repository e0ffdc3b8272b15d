"""Real-read training data: truth reads labelled by alignment.

Counterpart of scrappie_tpu/train/realdata.py. The reference ships two
fast5/fa truth pairs (`reads/*_strand.{fast5,fa}`) but no training code.
This module aligns a read's block posterior to its truth sequence with
the local-global posterior-to-sequence map (decode/mapping.py, behavioural
spec ref src/decode.c:1420-1531) and turns the mapped path into per-block
training labels at any model stride, the bootstrap labelling of ONT's
production training pipelines. `label_read` runs the label model's
posterior and the map on the caller's device: on the card the GRU, head
and seqmap kernels. The rest is numpy on the host, the JAX package's code
with its draws in the same order, so the same seed gives the same batches.

Label conventions match train/simulate.py:
  * transducer: kmer history ending at the block's last sample, stay
    when the base did not advance, -1 masked (unaligned / <klen history).
  * CRF: newly emitted base (0-3), 4 = blank, -1 when >1 base starts in
    the block or unaligned.

The bundled truth pairs are read from the directory that the environment
variable SCRAPPIE_TORCH_READS_DIR names (`reads_dir()`; the JAX package
reads a fixed directory, READS_DIR there). Where it is unset or holds no
pair, `bundled_truth_reads` and `load_labelled_reads` return empty lists,
as the JAX package's do without its reads.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import os

import numpy as np
import torch

from scrappie_torch.models.specs import KMER_LEN, NSTATE_TRANSDUCER
from scrappie_torch.train.simulate import _rolling_kmers, window_seqstates

READS_ENV = "SCRAPPIE_TORCH_READS_DIR"

_RC = str.maketrans("ACGT", "TGCA")


def revcomp(seq: str) -> str:
    return seq.translate(_RC)[::-1]


def _bases_to_ints(seq: str) -> np.ndarray:
    lut = np.full(128, -1, dtype=np.int8)
    for i, b in enumerate("ACGT"):
        lut[ord(b)] = i
    return lut[np.frombuffer(seq.encode(), dtype=np.uint8)].astype(np.int64)


@dataclasses.dataclass
class LabelledRead:
    """A normalised real read with a per-sample truth base index."""

    name: str
    norm: np.ndarray          # float32 [nsample], trimmed + medmad normalised
    bases: np.ndarray         # int64 [seqlen] truth bases in signal orientation
    base_at: np.ndarray       # int64 [nsample] truth base index, -1 unaligned
    map_score: float          # per-block mapping score (alignment quality)

    @property
    def nsample(self) -> int:
        return len(self.norm)


def reads_dir() -> str | None:
    """The directory of the bundled truth pairs (SCRAPPIE_TORCH_READS_DIR),
    or None."""
    return os.environ.get(READS_ENV) or None


def bundled_truth_reads() -> list[tuple[str, str, str]]:
    """(name, fast5_path, truth_sequence) for the bundled truth pairs."""
    out = []
    folder = reads_dir()
    if folder is None:
        return out
    for fa in sorted(globlib.glob(f"{globlib.escape(folder)}/*_strand.fa")):
        f5 = fa[:-3] + ".fast5"
        with open(fa) as fh:
            truth = "".join(l.strip() for l in fh if not l.startswith(">"))
        name = fa.split("HG_52221_")[-1].replace("_strand.fa", "")
        out.append((name, f5, truth))
    return out


def label_read(norm: np.ndarray, truth: str, *, label_model: str = "rgrgr_r94",
               params=None, name: str = "", local_pen: float = 4.0,
               device=None) -> LabelledRead:
    """Align a normalised signal to its truth sequence -> per-sample labels.

    Runs the label model's posterior over the whole read, maps it to the
    truth 5-mer sequence (both orientations; keeps the better score) and
    expands the per-block path to a per-sample base index at the model's
    stride granularity. Both run on `device` (CUDA unless named): on the
    card the rgrgr kernels and the seqmap kernel and its walk.
    """
    from scrappie_torch.api import encode_bases
    from scrappie_torch.decode.mapping import map_to_sequence_viterbi
    from scrappie_torch.models import forward, registry
    from scrappie_torch.models.convert import params_from_numpy
    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.device import as_device

    spec = RAW_MODELS[label_model]
    if params is None:
        params = registry.load_params(label_model)
    dev = as_device(device)
    stride = spec.stride
    nuse = (len(norm) // stride) * stride
    sig = torch.as_tensor(np.ascontiguousarray(norm[:nuse], dtype=np.float32),
                          device=dev)[None, :, None]
    with torch.inference_mode():
        lp = forward.rgrgr_posterior(params_from_numpy(params, dev), sig,
                                     conv_activation=spec.conv_activation,
                                     stride=stride, return_log=True)[0]
        lp = lp.contiguous()  # [nblock, 1025]
        best = None
        for orient, seq in (("fwd", truth), ("rc", revcomp(truth))):
            states = encode_bases(seq, KMER_LEN)
            score, path = map_to_sequence_viterbi(
                lp, states, local_pen=local_pen, want_path=True)
            if best is None or score > best[0]:
                best = (score, path, seq, orient)
    score, path, seq, orient = best

    bases = _bases_to_ints(seq)
    # path[t] = kmer position j (kmer ends at base j + klen - 1), -1 local.
    base_of_block = np.where(path >= 0, path + KMER_LEN - 1, -1)
    base_at = np.repeat(base_of_block, stride)
    if len(base_at) < len(norm):
        base_at = np.concatenate(
            [base_at, np.full(len(norm) - len(base_at), -1, dtype=np.int64)])
    aligned = float((path >= 0).mean())
    from scrappie_torch.utils.tracing import log

    log("info", "labelled real read", name=name, orient=orient,
        nblock=len(path), aligned_frac=round(aligned, 4),
        score_per_block=round(score / max(len(path), 1), 4))
    return LabelledRead(name, norm[: len(base_at)].astype(np.float32),
                        bases, base_at, score / max(len(path), 1))


def load_labelled_reads(label_model: str = "rgrgr_r94", params=None,
                        trim_start: int = 200, trim_end: int = 10,
                        device=None) -> list[LabelledRead]:
    """Load, preprocess (engine defaults) and label the bundled truth
    reads (fast5 needs h5py); [] where READS_DIR holds none."""
    from scrappie_torch.io.fast5 import read_raw
    from scrappie_torch.signal.trim import trim_and_segment_raw
    from scrappie_torch.utils.maths import medmad_normalise

    out = []
    for name, f5, truth in bundled_truth_reads():
        rs = read_raw(f5, scale_to_pA=True)
        rt = trim_and_segment_raw(rs, trim_start, trim_end, 100, 0.0)
        norm = medmad_normalise(rt.trimmed)
        out.append(label_read(norm, truth, label_model=label_model,
                              params=params, name=name, device=device))
    return out


def transducer_labels(base_at: np.ndarray, bases: np.ndarray, stride: int,
                      klen: int = KMER_LEN) -> np.ndarray:
    """Per-block transducer labels from a per-sample base index."""
    nblock = len(base_at) // stride
    last = base_at[stride - 1 :: stride][:nblock]
    kmers = _rolling_kmers(bases, klen)
    lab = np.where(last >= 0, kmers[np.clip(last, 0, len(bases) - 1)], -1)
    prev_last = np.concatenate([[-2], last[:-1]])
    lab = np.where((last == prev_last) & (last >= 0),
                   NSTATE_TRANSDUCER - 1, lab)
    lab[(last < klen - 1)] = -1
    return lab.astype(np.int32)


def crf_labels(base_at: np.ndarray, bases: np.ndarray, stride: int
               ) -> np.ndarray:
    """Per-block CRF labels (0-3 new base, 4 blank, -1 masked)."""
    nblock = len(base_at) // stride
    last = base_at[stride - 1 :: stride][:nblock]
    prev_last = np.concatenate([[-2], last[:-1]])
    nnew = last - prev_last
    lab = np.where(nnew == 0, 4, bases[np.clip(last, 0, len(bases) - 1)])
    lab = np.where((nnew > 1) | (last < 0) | (prev_last < -1), -1, lab)
    return lab.astype(np.int32)


class RealReadSampler:
    """Fixed-shape training batches sampled from labelled real reads.

    Each read is split at `holdout_frac` from the end: windows are drawn
    from the head (training region) only; `eval_segment` exposes the
    held-out tail with its truth substring for honest identity eval.
    Window-edge blocks are masked (`edge_mask` blocks each side): their
    labels were computed with whole-read context the windowed model
    cannot see.
    """

    def __init__(self, reads: list[LabelledRead], holdout_frac: float = 0.25,
                 seed: int = 0, edge_mask: int = 12):
        self.reads = reads
        self.holdout_frac = holdout_frac
        self.rng = np.random.default_rng(seed)
        self.edge_mask = edge_mask
        self._train_end = [
            int(r.nsample * (1.0 - holdout_frac)) for r in reads]

    def batch(self, batch: int, nsample: int, stride: int,
              kind: str = "transducer", augment: bool = False
              ) -> tuple[np.ndarray, np.ndarray]:
        labfn = crf_labels if kind == "crf" else transducer_labels
        nblock = nsample // stride
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        labels = np.full((batch, nblock), -1, dtype=np.int32)
        for b in range(batch):
            ridx = int(self.rng.integers(len(self.reads)))
            r = self.reads[ridx]
            hi = self._train_end[ridx] - nsample
            s0 = (int(self.rng.integers(max(hi, 1))) // stride) * stride
            # clamp to the training region: when the read is shorter
            # than nsample + holdout the window must not run into the
            # held-out tail (the unfilled rest stays zero/masked)
            end = min(s0 + nsample, self._train_end[ridx])
            win = r.norm[s0:end]
            ba = r.base_at[s0:end]
            if augment:
                from scrappie_torch.train.realsim import augment_window

                win, ba = augment_window(win, ba, self.rng)
            sigs[b, : len(win), 0] = win
            lab = labfn(ba, r.bases, stride)
            m = self.edge_mask
            if m:
                lab[:m] = -1
                lab[len(lab) - m :] = -1
            labels[b, : len(lab)] = lab
        return sigs, labels

    def seq_batch(self, batch: int, nsample: int, L: int,
                  augment: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(sigs [B,nsample,1], seqstates [B,L]) for the lattice loss."""
        sigs = np.zeros((batch, nsample, 1), dtype=np.float32)
        seqs = np.full((batch, L), -1, dtype=np.int32)
        for b in range(batch):
            ridx = int(self.rng.integers(len(self.reads)))
            r = self.reads[ridx]
            hi = self._train_end[ridx] - nsample
            s0 = int(self.rng.integers(max(hi, 1)))
            end = min(s0 + nsample, self._train_end[ridx])
            win = r.norm[s0:end]
            ba = r.base_at[s0:end]
            if augment:
                from scrappie_torch.train.realsim import augment_window

                win, ba = augment_window(win, ba, self.rng)
            sigs[b, : len(win), 0] = win
            seqs[b] = window_seqstates(ba, r.bases, L)
        return sigs, seqs

    def train_region_reads(self) -> list[LabelledRead]:
        """Copies truncated to the training region (for fitting stats
        without touching the held-out tails)."""
        return [
            dataclasses.replace(r, norm=r.norm[:e], base_at=r.base_at[:e])
            for r, e in zip(self.reads, self._train_end)
        ]

    def eval_segment(self, ridx: int) -> tuple[np.ndarray, str]:
        """(normalised signal tail, truth substring) for held-out eval."""
        r = self.reads[ridx]
        s0 = self._train_end[ridx]
        seg = r.base_at[s0:]
        valid = seg[seg >= 0]
        if not len(valid):
            return r.norm[s0:], ""
        lo, hi = int(valid.min()), int(valid.max())
        truth = "".join("ACGT"[b] for b in r.bases[lo : hi + 1])
        return r.norm[s0:], truth


class RealEventSampler:
    """Fixed-shape event-table batches from labelled real reads.

    The events pipeline analogue of RealReadSampler: each read's events
    come from the REAL two-window t-stat detector
    (signal/events.detect_events, behavioural spec
    ref src/event_detection.c:268-320) run on the normalised signal, and
    each event is labelled with the truth kmer at its last sample.
    Features are studentised over the WHOLE read's event table — the
    same statistics api.basecall_events feeds the network — and windows
    slice the normalised features.  Holdout: events whose last sample
    falls in the read's tail `holdout_frac` are never used for training
    windows.
    """

    def __init__(self, reads: list[LabelledRead], holdout_frac: float = 0.25,
                 seed: int = 0, edge_mask: int = 8, klen: int = KMER_LEN,
                 full_train_names: frozenset[str] = frozenset()):
        """full_train_names: reads whose WHOLE event table is trainable
        (no holdout tail) — e.g. pseudo-labelled reads with no truth to
        hold out (the JAX package's scripts/train_wholeread_transducer.py)."""
        from scrappie_torch.signal.events import detect_events
        from scrappie_torch.signal.features import nanonet_features_from_events
        from scrappie_torch.types import RawSignal

        self.reads = reads
        self.rng = np.random.default_rng(seed)
        self.edge_mask = edge_mask
        self.klen = klen
        self._ev = []
        self._train_nev = []
        for r in reads:
            et = detect_events(RawSignal(r.norm))
            ev = et.active
            feats = nanonet_features_from_events(et, normalise=True)
            last = np.minimum(
                ev["start"].astype(np.int64)
                + ev["length"].astype(np.int64) - 1, len(r.base_at) - 1)
            ev_base = np.where(last >= 0, r.base_at[np.clip(last, 0, None)],
                               -1)
            self._ev.append({
                "feats": feats,
                "ev_base": ev_base.astype(np.int64),
                "kmers": _rolling_kmers(r.bases, klen),
            })
            if r.name in full_train_names:
                self._train_nev.append(len(last))
            else:
                train_end_sample = int(r.nsample * (1.0 - holdout_frac))
                self._train_nev.append(
                    int(np.searchsorted(last, train_end_sample)))

    def _window(self, ridx: int, nevent: int) -> tuple[int, int]:
        """Start index and length of a training window that stays
        inside the read's training region (short regions clamp)."""
        n_train = self._train_nev[ridx]
        hi = n_train - nevent
        e0 = int(self.rng.integers(max(hi, 1))) if hi > 0 else 0
        return e0, min(nevent, n_train - e0)

    def _labels(self, d, e0: int, nevent: int) -> np.ndarray:
        eb = d["ev_base"][e0 : e0 + nevent]
        prev = np.concatenate([[-2], eb[:-1]])
        lab = d["kmers"][np.clip(eb, 0, len(d["kmers"]) - 1)].astype(np.int32)
        lab = np.where((eb == prev) & (eb >= 0), NSTATE_TRANSDUCER - 1, lab)
        lab[(eb < self.klen - 1) | (prev < -1)] = -1
        return lab

    def batch(self, batch: int, nevent: int
              ) -> tuple[np.ndarray, np.ndarray]:
        """(feats [B,nevent,4] read-studentised, labels [B,nevent])."""
        feats = np.zeros((batch, nevent, 4), dtype=np.float32)
        labels = np.full((batch, nevent), -1, dtype=np.int32)
        for b in range(batch):
            ridx = int(self.rng.integers(len(self.reads)))
            d = self._ev[ridx]
            e0, n = self._window(ridx, nevent)
            feats[b, :n] = d["feats"][e0 : e0 + n]
            lab = self._labels(d, e0, n)
            m = self.edge_mask
            if m:
                lab[:m] = -1
                lab[len(lab) - m :] = -1
            labels[b, : len(lab)] = lab
        return feats, labels

    def seq_batch(self, batch: int, nevent: int, L: int
                  ) -> tuple[np.ndarray, np.ndarray]:
        """(feats [B,nevent,4], kmer seqstates [B,L]) for the lattice loss."""
        feats = np.zeros((batch, nevent, 4), dtype=np.float32)
        seqs = np.full((batch, L), -1, dtype=np.int32)
        for b in range(batch):
            ridx = int(self.rng.integers(len(self.reads)))
            d = self._ev[ridx]
            e0, n = self._window(ridx, nevent)
            feats[b, :n] = d["feats"][e0 : e0 + n]
            eb = d["ev_base"][e0 : e0 + n]
            valid = eb[eb >= 0]
            if not len(valid):
                continue
            lo = max(int(valid.min()), self.klen - 1)
            hi_b = int(valid.max())
            if hi_b < lo:
                continue
            seq = d["kmers"][lo : hi_b + 1][:L]
            seqs[b, : len(seq)] = seq
        return feats, seqs

    def eval_events(self, ridx: int, whole: bool = False
                    ) -> tuple[np.ndarray, str]:
        """(feats [n,4], truth substring): the held-out tail, or the
        whole read with whole=True."""
        d = self._ev[ridx]
        e0 = 0 if whole else self._train_nev[ridx]
        feats = d["feats"][e0:]
        eb = d["ev_base"][e0:]
        valid = eb[eb >= 0]
        if not len(valid):
            return feats, ""
        lo, hi = int(valid.min()), int(valid.max())
        truth = "".join(
            "ACGT"[b] for b in self.reads[ridx].bases[lo : hi + 1])
        return feats, truth
