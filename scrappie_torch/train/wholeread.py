"""Whole-region training: one long region a read, with the truth sequence
it covers, the alignment marginalised by the lattice over the whole region.

Counterpart of scrappie_tpu/train/wholeread.py (crf_wholeread_nll,
transducer_wholeread_nll, region_sequence, region_seqstates,
region_event_seqstates, make_wholeread_step,
make_wholeread_transducer_step, HEAD_KEYS, make_head_step). Windows have
two uncertain endpoints every few thousand blocks and inherit the
alignment's jitter; a whole region has two ends in some 20 000 blocks and
no interior label derived from an alignment.

The JAX package bounds the memory of a 30 000-block backward with
chunked_scan, a remat of its lax.scan in `chunk`-step pieces. The port's
lattices (ops/lattice.py, csrc/lattice.cu on the card) do the same: the
forward keeps the maxima, a checkpoint row every `chunk` steps and the
last chunk's rows, and the backward recomputes each chunk's rows from its
checkpoint before it walks them back (11 MB for a transducer region of
30 720 blocks and 7 000 bases at chunk 256, 21 MB for the CRF's, where
every step's scores took 0.86 and 1.72 GB). The recompute repeats the
forward's arithmetic, so the values and gradients are those of any other
chunk bit for bit. The losses raise ValueError unless the region's blocks
are a multiple of `chunk`, as JAX's do (the kernels take a ragged last
chunk), and the region functions trim to a multiple.

The steps are in the port's idiom: step(sig, seq) -> loss, which updates
a FiniteClippedAdam's parameters in place (one read a call, sig
[1, Tsig, 1]; for nanonet_events event features [1, T, 4]).
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.api import encode_bases
from scrappie_torch.models.specs import KMER_LEN
from scrappie_torch.nn.layers import globalnorm
from scrappie_torch.train.lattice import crf_lattice_nll, lattice_forward_batch
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_torch.train.trainer import posterior_fn, value_and_grad_of


def _check_chunk(T: int, chunk: int) -> None:
    if T % chunk:
        raise ValueError(f"T={T} not a multiple of chunk={chunk}")


def crf_wholeread_nll(trans, bases, local_pen: float = 4.0,
                      chunk: int = 256):
    """Sound per-block NLL of `bases` under transitions: trans [B, T, 25]
    (T % chunk == 0), bases [B, L] (-1 right padding) -> scalar, the mean
    over rows of (logZ_local - log P(seq)) / T. The forward-backward keeps
    a checkpoint every `chunk` steps (T / chunk + chunk rows of 2L + 4
    floats a row) and recomputes the rows between them."""
    _check_chunk(trans.shape[1], chunk)
    return (crf_lattice_nll(trans, bases, local_pen, chunk)
            / trans.shape[1]).mean()


def transducer_wholeread_nll(lp, seqstates, stay_pen: float = 0.0,
                             skip_pen: float = 4.0, local_pen: float = 4.0,
                             chunk: int = 256):
    """Whole-region transducer lattice NLL: lp [B, T, S] per-block
    normalised log posteriors (T % chunk == 0), seqstates [B, L] -> scalar,
    the mean over rows of -log P(seq) / T (no partition term: the
    posterior is normalised a block). The forward-backward keeps a
    checkpoint every `chunk` steps (T / chunk + chunk rows of L + 2 floats
    a row) and recomputes the rows between them."""
    _check_chunk(lp.shape[1], chunk)
    logp = lattice_forward_batch(lp, seqstates, stay_pen, skip_pen, local_pen,
                                 chunk)
    return (-logp / lp.shape[1]).mean()


def region_sequence(read, train_end: int, stride: int, chunk: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(signal [Tsig], bases [L]) for a read's training region: any object
    with `norm` (the normalised signal), `base_at` (each sample's base
    index, -1 unaligned), `bases` and `name`. Trims the region so nblock =
    Tsig / stride is a multiple of `chunk`, and takes the truth as the span
    of aligned base indices inside the trimmed region."""
    tsig = (train_end // (stride * chunk)) * stride * chunk
    sig = read.norm[:tsig].astype(np.float32)
    ba = read.base_at[:tsig]
    valid = ba[ba >= 0]
    if not len(valid):
        raise ValueError(f"read {read.name}: no aligned bases in region")
    lo, hi = int(valid.min()), int(valid.max())
    return sig, read.bases[lo : hi + 1].astype(np.int32)


def region_seqstates(read, train_end: int, stride: int, chunk: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(signal [Tsig], kmer states [L-4]) for a transducer training
    region: the kmer-state analogue of region_sequence."""
    sig, bases = region_sequence(read, train_end, stride, chunk)
    seq = "".join("ACGT"[b] for b in bases)
    return sig, np.asarray(encode_bases(seq, KMER_LEN), np.int32)


def region_event_seqstates(sampler, ridx: int, chunk: int
                           ) -> tuple[np.ndarray, np.ndarray]:
    """(event feats [T, 4], kmer states [L]) for an events-model training
    region: any object with `_ev` (per read a dict of "feats", "ev_base"
    and "kmers"), `_train_nev` (each read's training-region event count)
    and `klen`. T is that count trimmed to a multiple of `chunk`; the kmer
    states span the bases aligned to the region's events."""
    d = sampler._ev[ridx]
    nev = (sampler._train_nev[ridx] // chunk) * chunk
    if not nev:
        raise ValueError("training region shorter than one chunk of events")
    feats = d["feats"][:nev].astype(np.float32)
    eb = d["ev_base"][:nev]
    valid = eb[eb >= 0]
    if not len(valid):
        raise ValueError("no aligned bases in events region")
    lo = max(int(valid.min()), sampler.klen - 1)
    hi = int(valid.max())
    if hi < lo:
        raise ValueError("events region spans no full kmer")
    return feats, d["kmers"][lo : hi + 1].astype(np.int32)


def _step(optimizer: FiniteClippedAdam, lfn):
    """step(x, seq) -> loss: lfn(params, x, seq)'s value and gradient on
    the optimiser's device, then one update in place, in the precision
    mode that is set."""

    def train_step(x, seq):
        dev = next(iter(optimizer.params.values())).device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        seq = torch.as_tensor(seq, device=dev).long()
        loss, grads = value_and_grad_of(lfn, optimizer.params, x, seq)
        optimizer.step(grads)
        return loss

    return train_step


def crf_wholeread_loss(model: str, local_pen: float = 4.0, chunk: int = 256):
    """make_wholeread_step's loss, lfn(params, sig, bases)."""
    return lambda p, sig, bases: crf_wholeread_nll(
        posterior_fn(model)(p, sig), bases, local_pen, chunk)


def make_wholeread_step(model: str, optimizer: FiniteClippedAdam,
                        local_pen: float = 4.0, chunk: int = 256):
    """Full-parameter whole-region CRF train step (one read a call):
    step(sig [1, Tsig, 1], bases [1, L]) -> loss."""
    return _step(optimizer, crf_wholeread_loss(model, local_pen, chunk))


def transducer_wholeread_loss(model: str, stay_pen: float = 0.0,
                              skip_pen: float = 4.0, local_pen: float = 4.0,
                              chunk: int = 256):
    """make_wholeread_transducer_step's loss, lfn(params, sig, seqstates)."""
    return lambda p, sig, seq: transducer_wholeread_nll(
        posterior_fn(model)(p, sig), seq, stay_pen, skip_pen, local_pen,
        chunk)


def make_wholeread_transducer_step(model: str, optimizer: FiniteClippedAdam,
                                   stay_pen: float = 0.0,
                                   skip_pen: float = 4.0,
                                   local_pen: float = 4.0, chunk: int = 256):
    """Full-parameter whole-region transducer train step (one read a
    call): step(sig [1, Tsig, 1], seqstates [1, L]) -> loss. Also serves
    nanonet_events, whose posterior is per event: pass event feats
    [1, T, 4] as sig (region_event_seqstates)."""
    return _step(optimizer, transducer_wholeread_loss(
        model, stay_pen, skip_pen, local_pen, chunk))


HEAD_KEYS = ("FF_W", "FF_b")


def head_loss(local_pen: float = 4.0, chunk: int = 256):
    """make_head_step's loss, lfn(head, feats, bases)."""
    return lambda h, feats, bases: crf_wholeread_nll(
        globalnorm(feats, h["FF_W"], h["FF_b"]), bases, local_pen, chunk)


def make_head_step(optimizer: FiniteClippedAdam, local_pen: float = 4.0,
                   chunk: int = 256):
    """Head-only whole-region step on precomputed features: the optimiser
    holds HEAD_KEYS only; step(feats [1, T, 96] from
    models.forward.rnnrf_features under the frozen stack, bases [1, L]) ->
    loss. globalnorm stays in the graph, so the head trains in the
    energies the decoder uses."""
    return _step(optimizer, head_loss(local_pen, chunk))
