"""Alignment-free (CTC-style) sequence lattice losses.

Counterpart of scrappie_tpu/train/lattice.py (lattice_forward_batch,
lattice_loss_fn, crf_lattice_forward_batch, crf_local_partition,
crf_lattice_loss_fn, make_lattice_train_step). Framewise cross-entropy
needs an exact signal-to-sequence alignment; on real-like data the
alignment is itself estimated, and training on it collapses the calls.
These losses marginalise over the alignment instead:

    loss = -(1/nblock) * log P(truth kmer sequence | posterior)

with local START/END states that absorb the uncertain window edges. The
forward-backward of both lattices is ops/lattice.py: a kernel on the card
(csrc/lattice.cu), its plain twins on the CPU. The windows keep every
step's scores (chunk None: their rows are some 20 MB at 8 windows of 800
blocks); train/wholeread.py passes its chunk.

The functions take the JAX package's batch-major layouts (log posteriors
[B, T, S], transitions [B, T, 25]) and hand the ops their time-major
views. `make_lattice_train_step` is in the port's idiom:
step(sig, seqstates) -> loss, which updates a FiniteClippedAdam's
parameters in place, as trainer.make_train_step does.
"""

from __future__ import annotations

import torch

from scrappie_torch.models.specs import RAW_MODELS
from scrappie_torch.ops.lattice import crf_lattice_tm, lattice_forward_tm
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_torch.train.trainer import posterior_fn, value_and_grad_of


def lattice_forward_batch(logpost, seqstates, stay_pen: float = 0.0,
                          skip_pen: float = 4.0, local_pen: float = 4.0,
                          chunk: int | None = None):
    """Batched forward score of sequences under transducer posteriors:
    logpost [B, T, S] log-probabilities (stay class S-1), seqstates [B, L]
    kmer state per position (-1 right padding) -> [B] log P(sequence |
    posterior), local-global. The backward keeps a checkpoint every
    `chunk` steps (None: every step's scores; ops/lattice.py)."""
    return lattice_forward_tm(logpost.transpose(0, 1).contiguous(), seqstates,
                              stay_pen, skip_pen, local_pen, chunk)


def lattice_loss_fn(params, sig, seqstates, model: str, stay_pen=0.0,
                    skip_pen=4.0, local_pen=4.0):
    """-log P(sequence)/nblock averaged over the batch (transducer). Rows
    with no labelled sequence (all -1) are excluded: their score is the
    -1e30 sentinel."""
    lp = posterior_fn(model)(params, sig)  # [B, T, S] log probs
    logp = lattice_forward_batch(lp, seqstates, stay_pen, skip_pen, local_pen)
    valid = (seqstates >= 0).any(dim=1)
    logp = torch.where(valid, logp, 0.0)
    return -(logp / lp.shape[1]).sum() / torch.clamp(valid.sum(), min=1)


def crf_lattice_forward_batch(trans, bases, local_pen: float = 4.0):
    """Batched forward score of base sequences under CRF transitions:
    trans [B, T, 25], bases [B, L] (0-3, -1 right padding) -> [B]
    log P(sequence | transitions)."""
    return crf_lattice_tm(trans.transpose(0, 1).contiguous(), bases,
                          local_pen)[0]


def crf_local_partition(trans, local_pen: float = 4.0):
    """Partition function [B] of the locally-extended CRF lattice over all
    base sequences: trans [B, T, 25]. (The sequence lattice runs beside it
    in the same launch, on an empty sequence.)"""
    empty = torch.full((trans.shape[0], 1), -1, dtype=torch.int32,
                       device=trans.device)
    return crf_lattice_tm(trans.transpose(0, 1).contiguous(), empty,
                          local_pen)[1]


def crf_lattice_nll(trans, bases, local_pen: float = 4.0,
                    chunk: int | None = None):
    """Per row, (logZ_local - log P(bases)) [B] of trans [B, T, 25]: both
    lattices in one forward-backward, a checkpoint every `chunk` steps
    (None: every step's scores)."""
    logp, logz = crf_lattice_tm(trans.transpose(0, 1).contiguous(), bases,
                                local_pen, chunk)
    return logz - logp


def crf_lattice_loss_fn(params, sig, bases, model: str, local_pen=4.0):
    """-log P(sequence)/nblock averaged over the batch (CRF models), P
    normalised over the locally-extended lattice (crf_local_partition), so
    the loss is bounded below by 0. Rows with no sequence are excluded."""
    trans = posterior_fn(model)(params, sig)  # [B, T, 25]
    nll = crf_lattice_nll(trans, bases, local_pen)
    valid = (bases >= 0).any(dim=1)
    nll = torch.where(valid, nll, 0.0)
    return (nll / trans.shape[1]).sum() / torch.clamp(valid.sum(), min=1)


def is_crf(model: str) -> bool:
    return model in RAW_MODELS and RAW_MODELS[model].kind == "rnnrf"


def lattice_loss(model: str, stay_pen=0.0, skip_pen=4.0, local_pen=4.0):
    """The lattice train step's loss, lfn(params, sig, seqstates): kmer
    seqstates [B, L] (-1 padded) for every model kind; CRF models reduce
    them to per-position bases (last base = state % 4) and use the CRF
    lattice."""
    if is_crf(model):
        def lfn(p, sig, seqstates):
            bases = torch.where(seqstates >= 0, seqstates % 4, -1)
            return crf_lattice_loss_fn(p, sig, bases, model, local_pen)
        return lfn
    return lambda p, sig, seqstates: lattice_loss_fn(
        p, sig, seqstates, model, stay_pen, skip_pen, local_pen)


def make_lattice_train_step(model: str, optimizer: FiniteClippedAdam,
                            stay_pen=0.0, skip_pen=4.0, local_pen=4.0):
    """Lattice (alignment-marginal) train step: step(sig, seqstates) ->
    loss, one value_and_grad of lattice_loss and one update of
    optimizer.params in place, in the precision mode that is set."""
    lfn = lattice_loss(model, stay_pen, skip_pen, local_pen)

    def train_step(sig, seqstates):
        dev = next(iter(optimizer.params.values())).device
        sig = torch.as_tensor(sig, dtype=torch.float32, device=dev)
        seqstates = torch.as_tensor(seqstates, device=dev).long()
        loss, grads = value_and_grad_of(lfn, optimizer.params, sig, seqstates)
        optimizer.step(grads)
        return loss

    return train_step
