"""Training step for the basecall networks: framewise cross-entropy for
rgrgr, raw_r94 and nanonet_events, the CRF negative log-likelihood for
rnnrf_r94.

Counterpart of scrappie_tpu/train/trainer.py (posterior_fn, loss_fn,
crf_loss_fn, make_train_step, train). The JAX step
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

On a mesh (`train(mesh=)`, JAX trainer.py:108-146; parallel/sharding.py)
the global batch, drawn once from the simulator, is split over the data
devices; each replica runs its loss and backward through the same
autograd Functions on its own device, the output layer's product split
over the row's state devices where the mesh has a 'state' axis
(nn/layers.state_matmul: its backward hands the layers below the full
gradient). `value_and_grad_on_mesh` sums the replicas' gradients onto the
first device in row order, each replica's loss being its masked sum over
the global batch's mask count, so the loss is the global batch's mean;
then one clip on the global norm and one Adam update there, whose weights
every replica takes at the next step. Once parallel/launcher.initialize
has brought up a process group, the data axis spans the processes: each
draws the same global batch from the same seed and keeps its own
contiguous rows, and the mask count, the loss and the gradients are
all_reduce'd over the group before the clip (all_reduce alone: gloo has
no all_gather for CUDA tensors). The run then equals a one-process run
on the same global batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from scrappie_torch.models import forward, registry
from scrappie_torch.models.specs import RAW_MODELS
from scrappie_torch.nn.layers import StateShards
from scrappie_torch.parallel.sharding import (STATE_SHARD_KEYS, resolve_mesh,
                                              shard_params, split_rows)
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_torch.train.simulate import SquiggleSimulator


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


def crf_loss_terms(params, sig, labels, model: str):
    """crf_loss_fn as (sum over the unmasked blocks, their count)."""
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
    return -(energy * mask).sum(), mask.sum()


def crf_loss_fn(params, sig, labels, model: str):
    """CRF negative log-likelihood on globally-normalised transitions.

    rnnrf_transitions already subtracts logZ/nblock per block
    (globalnorm, ref src/layers.c:874-889), so the per-path NLL is just
    the negative sum of the labelled transition energies
    trans[t, s_t*5 + s_{t-1}].  Masked blocks (-1) contribute nothing.
    """
    total, count = crf_loss_terms(params, sig, labels, model)
    return total / torch.clamp(count, min=1)


def loss_terms(params, sig, labels, model: str):
    """loss_fn as (sum over the unmasked blocks, their count)."""
    lp = posterior_fn(model)(params, sig)  # [B, nblock, nstate] log probs
    nblock = min(lp.shape[1], labels.shape[1])
    lp = lp[:, :nblock]
    labels = labels[:, :nblock]
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    ce = -torch.gather(lp, -1, safe[..., None])[..., 0]
    return (ce * mask).sum(), mask.sum()


def loss_fn(params, sig, labels, model: str):
    """Masked framewise cross-entropy on block kmer/stay labels."""
    total, count = loss_terms(params, sig, labels, model)
    return total / torch.clamp(count, min=1)


def _loss_for(model: str):
    if model == "nanonet_events":
        return loss_fn
    if model not in RAW_MODELS:
        raise ValueError(f"no trainer for model {model!r}")
    return crf_loss_fn if RAW_MODELS[model].kind == "rnnrf" else loss_fn


def _terms_for(model: str):
    return {loss_fn: loss_terms, crf_loss_fn: crf_loss_terms}[_loss_for(model)]


def value_and_grad_of(lfn, params: dict[str, torch.Tensor], *args):
    """(loss, {key: gradient}) of lfn(params, *args) at params (tensors on
    one device); args are tensors already on that device. A parameter the
    loss does not read gets a zero gradient, as jax.grad gives it. The
    products round their gradients as the precision mode asks for the
    device (nn/config.py), as jax.grad does under the JAX package's
    mode."""
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


def _group():
    """The process group the data axis spans (launcher.initialize's), or
    None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def process_rows(n: int) -> tuple[int, int]:
    """This process's contiguous rows of a global batch of n rows (all of
    them without a process group)."""
    group = _group()
    if group is None:
        return 0, n
    world, rank = dist.get_world_size(), dist.get_rank()
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{world} processes")
    return n // world * rank, n // world * (rank + 1)


def value_and_grad_on_mesh(model: str, params: dict[str, torch.Tensor], mesh,
                           sig, labels):
    """(loss, {key: gradient}) of the model's loss over a batch on a mesh:
    params are tensors on the mesh's first device; sig and labels are this
    process's rows of the global batch (numpy or tensors). Each data row's
    replica takes its contiguous slice; its loss is its masked sum over
    the global mask count (all_reduce'd over the process group), so the
    losses add up to the global batch's mean. The gradients (a split
    weight's shards joined along its first axis) are summed onto the first
    device in row order, then all_reduce'd over the process group, and so
    is the loss. In 'bf16' each replica rounds its own weight-gradient
    products before they are summed (one device rounds the whole batch's
    product once), so the gradients differ from one device's by bfloat16
    roundings and the losses by what the updates make of them."""
    terms = _terms_for(model)
    dev0 = mesh.devices[0, 0]
    devices = mesh.data_devices
    if len(sig) % len(devices):
        raise ValueError(f"{len(sig)} rows do not split over the mesh's "
                         f"{len(devices)} data devices")
    if not isinstance(sig, torch.Tensor):
        sig = np.asarray(sig, np.float32)
    rows = zip(split_rows(sig, devices), split_rows(labels, devices))
    replicas = shard_params(params, mesh, STATE_SHARD_KEYS, full=False)
    group = _group()
    with torch.enable_grad():
        runs = []
        for (r, x), (_, lab) in rows:
            leaves = {k: _leaves(v) for k, v in replicas[r].items()}
            for t in (t for ts in leaves.values() for t in ts):
                t.requires_grad_(True)
            runs.append((leaves, *terms(replicas[r], x.to(torch.float32),
                                        lab, model)))
        count = torch.stack([c.to(dev0) for _, _, c in runs]).sum()
        count = count.to(torch.float32)
        if group is not None:
            dist.all_reduce(count, group=group)
        count = torch.clamp(count, min=1)
        loss = torch.zeros((), device=dev0)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        for leaves, total, _ in runs:
            part = total / count.to(total.device)
            flat = [t for k in sorted(leaves) for t in leaves[k]]
            got = iter(torch.autograd.grad(part, flat, allow_unused=True))
            for k in sorted(leaves):
                # a parameter the loss does not read gets a zero gradient
                g = [torch.zeros_like(t) if gi is None else gi
                     for gi, t in zip([next(got) for _ in leaves[k]],
                                      leaves[k])]
                grads[k] += torch.cat([gi.to(dev0) for gi in g])
            loss = loss + part.detach().to(dev0)
    if group is not None:
        # every gradient and the loss in one all_reduce
        keys = sorted(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys] + [loss[None]])
        dist.all_reduce(flat, group=group)
        sizes = [grads[k].numel() for k in keys] + [1]
        parts = torch.split(flat, sizes)
        grads = {k: t.view_as(grads[k]) for k, t in zip(keys, parts)}
        loss = parts[-1][0]
    return loss, grads


def _leaves(v) -> tuple[torch.Tensor, ...]:
    """The tensors of a placed parameter: a split weight's shards."""
    return v.shards if isinstance(v, StateShards) else (v,)


def make_train_step(model: str, optimizer: FiniteClippedAdam, mesh=None):
    """step(sig, labels) -> loss: one value_and_grad (on the mesh, with
    value_and_grad_on_mesh, when one is given) and one optimiser update of
    optimizer.params, in place."""
    _loss_for(model)

    def train_step(sig, labels):
        if mesh is None:
            loss, grads = value_and_grad(model, optimizer.params, sig, labels)
        else:
            loss, grads = value_and_grad_on_mesh(model, optimizer.params,
                                                 mesh, sig, labels)
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
    simulated signal (detected_events_batch). `mesh` (parallel/sharding)
    trains data-parallel over its data devices, the output layer split
    over 'state'; `device` pins one device (device="cpu" runs the plain
    twins); with neither, every visible card. Under a process group
    (parallel/launcher.initialize) the batch is the global one, split over
    the processes. Training runs in the precision mode that is set
    (nn/config.py: SCRAPPIE_TORCH_PRECISION or the precision() context)."""
    _loss_for(model)
    mesh = resolve_mesh(device, mesh)
    dev = mesh.devices[0, 0]
    on_mesh = mesh.size > 1 or _group() is not None
    if params is None:
        params = registry.load_params(model)
    weights = {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32),
                                  device=dev).clone()
               for k, v in params.items()}
    optimizer = FiniteClippedAdam(weights, lr)
    step_fn = make_train_step(model, optimizer, mesh if on_mesh else None)
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
    lo, hi = process_rows(batch)
    for i in range(steps):
        sigs, labels = make_batch(batch, nsample, stride)
        loss = float(step_fn(sigs[lo:hi], labels[lo:hi]))
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"[train {model}] step {i}: loss {loss:.4f}", flush=True)
    return {k: v.cpu().numpy() for k, v in weights.items()}, losses
