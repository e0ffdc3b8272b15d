"""Training step for the basecall networks: framewise cross-entropy for
rgrgr, raw_r94 and nanonet_events, the CRF negative log-likelihood for
rnnrf_r94.

Counterpart of scrappie_tpu/train/trainer.py (posterior_fn, loss_fn,
crf_loss_fn, make_train_step, train), without its mesh. The JAX step
traces its lax.scan forward under ops.pallas(False) and lets XLA
differentiate it; here the forward is the inference path itself (conv, the
projection and GRU recurrence kernels, the head, on rnnrf the partition
kernel; on nanonet_events the projection and the LSTM pair), built into a
graph because the parameters require gradients: ops/project.Project,
ops/gru.GruRecurrence, ops/lstm.LstmPair and ops/crf.CrfPartition are
autograd Functions whose backward runs the GRU recurrence's and the LSTM's
backward kernels and the CRF forward-backward kernel on the card (their
plain twins on the CPU), and plain products for the rest. The optimiser is
optax's, written out (train/optim.py). The lattice and whole-read losses
(train/lattice.py, train/wholeread.py) share `value_and_grad_of`.

Parameters cross as the JAX package keeps them, a dict of float32 numpy
arrays by the registry's keys: `train` takes one (or loads the model's
weights) and returns the trained dict, which scrappie_tpu loads as it is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from scrappie_torch.device import as_device
from scrappie_torch.models import forward, registry
from scrappie_torch.models.specs import RAW_MODELS
from scrappie_torch.nn import config
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_torch.train.simulate import SquiggleSimulator

_MESH = ("train(mesh=) is not ported: multi-GPU training comes with "
         "ROADMAP.md queue 1, \"Multi-GPU\"")


def posterior_fn(model: str):
    """The forward a model trains through: params, sig [B, T, 1] -> log
    posterior [B, nblock, nstate] (transducers, min_prob 0), CRF
    transitions [B, nblock, 25] (rnnrf); for nanonet_events params, event
    features [B, nevent, 4] -> log posterior [B, nevent, nstate]."""
    if model == "nanonet_events":
        # A small floor keeps the CE loss finite: the peephole LSTM's
        # cell state is unbounded, and min_prob=0 lets one saturated
        # logit drive log(softmax) to -inf (observed divergence).
        return functools.partial(forward.events_posterior, min_prob=1e-6,
                                 return_log=True)
    spec = RAW_MODELS[model]
    if spec.kind == "rgrgr":
        return functools.partial(
            forward.rgrgr_posterior, conv_activation=spec.conv_activation,
            stride=spec.stride, min_prob=0.0, return_log=True,
        )
    if spec.kind == "raw":
        return functools.partial(forward.raw_posterior, stride=spec.stride,
                                 min_prob=0.0, return_log=True)
    if spec.kind == "rnnrf":
        return functools.partial(forward.rnnrf_transitions,
                                 conv_activation=spec.conv_activation,
                                 stride=spec.stride)
    raise ValueError(f"no trainer for model kind {spec.kind}")


def crf_loss_fn(params, sig, labels, model: str):
    """CRF negative log-likelihood on globally-normalised transitions.

    rnnrf_transitions already subtracts logZ/nblock per block
    (globalnorm, ref src/layers.c:874-889), so the per-path NLL is just
    the negative sum of the labelled transition energies
    trans[t, s_t*5 + s_{t-1}].  Masked blocks (-1) contribute nothing.
    """
    trans = posterior_fn(model)(params, sig)  # [B, nblock, 25]
    ns = 5
    nblock = min(trans.shape[1], labels.shape[1])
    trans = trans[:, :nblock]
    labels = labels[:, :nblock]
    prev = torch.cat([torch.full((labels.shape[0], 1), 4, dtype=labels.dtype,
                                 device=labels.device), labels[:, :-1]], dim=1)
    mask = (labels >= 0) & (prev >= 0)
    safe_l = torch.where(mask, labels, 0)
    safe_p = torch.where(mask, prev, 0)
    idx = (safe_l * ns + safe_p).long()
    energy = torch.gather(trans, -1, idx[..., None])[..., 0]
    return -(energy * mask).sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(params, sig, labels, model: str):
    """Masked framewise cross-entropy on block kmer/stay labels."""
    lp = posterior_fn(model)(params, sig)  # [B, nblock, nstate] log probs
    nblock = min(lp.shape[1], labels.shape[1])
    lp = lp[:, :nblock]
    labels = labels[:, :nblock]
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    ce = -torch.gather(lp, -1, safe[..., None])[..., 0]
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1)


def _loss_for(model: str):
    if model == "nanonet_events":
        return loss_fn
    if model not in RAW_MODELS:
        raise ValueError(f"no trainer for model {model!r}")
    return crf_loss_fn if RAW_MODELS[model].kind == "rnnrf" else loss_fn


def value_and_grad_of(lfn, params: dict[str, torch.Tensor], *args):
    """(loss, {key: gradient}) of lfn(params, *args) at params (tensors on
    one device); args are tensors already on that device. A parameter the
    loss does not read gets a zero gradient, as jax.grad gives it.
    Raises NotImplementedError under a precision other than 'highest'."""
    config.require_highest("training")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = lfn(leaves, *args)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def value_and_grad(model: str, params: dict[str, torch.Tensor], sig, labels):
    """(loss, {key: gradient}) of the model's loss at params (tensors on
    one device) on a batch, sig [B, nsample, 1] (event features
    [B, nevent, 4] for nanonet_events) and labels [B, nblock] (numpy or
    tensors, moved to the parameters' device)."""
    dev = next(iter(params.values())).device
    sig = torch.as_tensor(sig, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    lfn = _loss_for(model)
    return value_and_grad_of(lambda p, s, lab: lfn(p, s, lab, model), params,
                             sig, labels)


def make_train_step(model: str, optimizer: FiniteClippedAdam):
    """step(sig, labels) -> loss: one value_and_grad and one optimiser
    update of optimizer.params, in place."""
    config.require_highest("make_train_step")
    _loss_for(model)

    def train_step(sig, labels):
        loss, grads = value_and_grad(model, optimizer.params, sig, labels)
        optimizer.step(grads)
        return loss

    return train_step


def train(model: str, steps: int = 200, batch: int = 8, nsample: int = 4000,
          lr: float = 2e-3, seed: int = 0, params=None, mesh=None,
          log_every: int = 25, simulator=None, device=None):
    """Fit a model on simulated squiggle reads. Returns (params, losses):
    the trained parameters as a dict of float32 numpy arrays (the JAX
    package's keys and shapes) and each step's loss. nanonet_events trains
    on nsample // 10 events a row that the event detector finds in
    simulated signal (detected_events_batch). `device` defaults to CUDA;
    device="cpu" runs the plain twins. Training runs only under
    precision 'highest'."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    config.require_highest("train")
    _loss_for(model)
    dev = as_device(device)
    if params is None:
        params = registry.load_params(model)
    weights = {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32),
                                  device=dev).clone()
               for k, v in params.items()}
    optimizer = FiniteClippedAdam(weights, lr)
    step_fn = make_train_step(model, optimizer)
    sim = (simulator if simulator is not None
           else SquiggleSimulator(seed=seed, device=dev))
    spec = RAW_MODELS.get(model)  # None for the events model
    if spec is None:
        # Events from the event detector on simulated signal, so the
        # feature statistics match the events CLI pipeline.
        make_batch = lambda b, n, _s: sim.detected_events_batch(b, n // 10)
        stride = None
    else:
        make_batch = (sim.crf_labelled_batch if spec.kind == "rnnrf"
                      else sim.labelled_batch)
        stride = spec.stride
    losses = []
    for i in range(steps):
        sigs, labels = make_batch(batch, nsample, stride)
        loss = float(step_fn(sigs, labels))
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"[train {model}] step {i}: loss {loss:.4f}", flush=True)
    return {k: v.cpu().numpy() for k, v in weights.items()}, losses
