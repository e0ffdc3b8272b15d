"""Whole-region training on the CPU: the port's whole-read NLLs, region
functions and train steps (scrappie_torch/train/wholeread.py) against
scrappie_tpu/train/wholeread.py on the same seeded inputs.

JAX runs its lattices through chunked_scan (a remat of the scan in
`chunk`-step pieces); the port's forward-backward (ops/lattice.py, here
its plain twins) keeps a checkpoint every `chunk` steps and recomputes the
rows between them, so its values do not depend on the chunk (bit for
bit). Both raise ValueError unless T % chunk == 0.

Tolerances, and why: the NLLs 1e-5 relative and their gradients 5e-5
relative to the largest entry (tests/test_torch_lattice.py's limits for
the same lattices; seen at most 1.2e-5); one train step's loss 1e-5
relative and the parameters within 1e-4 absolute but for at most 1 weight
in 1 000 of a leaf, none off by more than 2 lr (the lattice train step's
rule in tests/test_torch_lattice.py). The region functions are numpy on
both sides and must be equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scrappie_torch.train import wholeread as twr
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_tpu import ops as jops
from scrappie_tpu.models import registry
from scrappie_tpu.models.specs import RAW_MODELS
from scrappie_tpu.train import wholeread as jwr
from scrappie_tpu.train.simulate import SquiggleSimulator as JSim

torch.set_num_threads(1)
VALUE_RTOL = 1e-5
GRAD_RTOL = 5e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
PARAM_OUTLIERS = 1e-3
LR = 1e-3
CHUNK = 16


@pytest.fixture(autouse=True)
def _jax_scan_reference():
    with jops.pallas(False):
        yield


def assert_rel_close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def nll_inputs(kind: str, T: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "crf":
        x = (2.0 * rng.standard_normal((2, T, 25))).astype(np.float32)
        seq = rng.integers(0, 4, size=(2, 20)).astype(np.int32)
    else:
        z = 2.0 * rng.standard_normal((2, T, 1025))
        x = (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)
        seq = rng.integers(0, 1024, size=(2, 20)).astype(np.int32)
    seq[1, 14:] = -1
    return x, seq


def nll_pair(kind: str):
    if kind == "crf":
        return jwr.crf_wholeread_nll, twr.crf_wholeread_nll
    return jwr.transducer_wholeread_nll, twr.transducer_wholeread_nll


@pytest.mark.parametrize("kind", ["crf", "transducer"])
def test_wholeread_nll_matches_jax(kind):
    """crf_wholeread_nll / transducer_wholeread_nll and their gradients
    against JAX's (chunked_scan) at T = 64, chunk 16."""
    x, seq = nll_inputs(kind, 64, seed=1 + len(kind))
    jfn, tfn = nll_pair(kind)
    want, want_g = jax.value_and_grad(
        lambda a: jfn(a, seq, chunk=CHUNK))(jnp.asarray(x))
    leaf = torch.tensor(x, requires_grad=True)
    got = tfn(leaf, torch.tensor(seq), chunk=CHUNK)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=VALUE_RTOL)
    assert_rel_close(leaf.grad, want_g, GRAD_RTOL, kind)


@pytest.mark.parametrize("kind", ["crf", "transducer"])
@pytest.mark.parametrize("chunk", [1, 8, 32, 64])
def test_wholeread_nll_matches_jax_at_each_chunk(kind, chunk):
    """At every chunk (the port recomputing each chunk's rows from its
    checkpoint, JAX's chunked_scan rematerialising each chunk) the NLL and
    its gradient against JAX's at the same chunk, T = 64; and the port's
    equal to its own at chunk = T bit for bit."""
    x, seq = nll_inputs(kind, 64, seed=5 + len(kind))
    jfn, tfn = nll_pair(kind)
    want, want_g = jax.value_and_grad(
        lambda a: jfn(a, seq, chunk=chunk))(jnp.asarray(x))
    got, grads = [], []
    for c in (chunk, 64):
        leaf = torch.tensor(x, requires_grad=True)
        value = tfn(leaf, torch.tensor(seq), chunk=c)
        value.backward()
        got.append(value.detach())
        grads.append(leaf.grad)
    np.testing.assert_allclose(float(got[0]), float(want), rtol=VALUE_RTOL)
    assert_rel_close(grads[0], want_g, GRAD_RTOL, kind)
    assert torch.equal(got[0], got[1])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("kind", ["crf", "transducer"])
def test_wholeread_nll_chunk_rule(kind):
    x, seq = nll_inputs(kind, 40, seed=3)
    jfn, tfn = nll_pair(kind)
    with pytest.raises(ValueError, match="multiple of chunk"):
        jfn(jnp.asarray(x), seq, chunk=CHUNK)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tfn(torch.tensor(x), torch.tensor(seq), chunk=CHUNK)


def simulated_read(seed: int, seqlen: int = 300):
    """A read object with the attributes the region functions read."""
    sig, bases, base_at = JSim(seed=seed).simulate_read(seqlen)
    norm = ((sig - np.median(sig)) / np.std(sig)).astype(np.float32)
    base_at = base_at.copy()
    base_at[:40] = -1  # an unaligned stretch at the start
    return types.SimpleNamespace(norm=norm, base_at=base_at,
                                 bases=bases.astype(np.int64), name="sim")


def events_sampler(seed: int):
    rng = np.random.default_rng(seed)
    ev = []
    for n in (300, 90):
        eb = np.sort(rng.integers(0, n // 2, size=n))
        eb[:7] = -1
        ev.append({"feats": rng.standard_normal((n, 4)),
                   "ev_base": eb,
                   "kmers": rng.integers(0, 1024, size=n // 2)})
    return types.SimpleNamespace(_ev=ev, _train_nev=[250, 90], klen=5)


def test_region_functions_match_jax():
    """region_sequence, region_seqstates and region_event_seqstates on a
    simulated read and a synthetic events sampler: the same arrays, and
    the same refusals."""
    read = simulated_read(seed=4)
    for train_end in (len(read.norm), len(read.norm) // 2):
        for fn in ("region_sequence", "region_seqstates"):
            for stride, chunk in ((5, 16), (2, 32)):
                got = getattr(twr, fn)(read, train_end, stride, chunk)
                want = getattr(jwr, fn)(read, train_end, stride, chunk)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    sampler = events_sampler(seed=5)
    for ridx, chunk in ((0, 16), (0, 64), (1, 16)):
        for a, b in zip(twr.region_event_seqstates(sampler, ridx, chunk),
                        jwr.region_event_seqstates(sampler, ridx, chunk)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    unaligned = types.SimpleNamespace(norm=read.norm,
                                      base_at=np.full_like(read.base_at, -1),
                                      bases=read.bases, name="none")
    for mod in (twr, jwr):
        with pytest.raises(ValueError, match="no aligned bases"):
            mod.region_sequence(unaligned, len(read.norm), 5, 16)
        with pytest.raises(ValueError, match="shorter than one chunk"):
            mod.region_event_seqstates(sampler, 1, 128)


def optax_optimizer(lr):
    return optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr)),
        max_consecutive_errors=25)


def assert_step_matches(ours, jparams, got_loss, want_loss):
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert set(ours.params) == set(jparams)
    for k, w in jparams.items():
        g, w = ours.params[k].numpy(), np.asarray(w)
        off = np.abs(g - w)
        n = int((off > PARAM_ATOL).sum())
        assert n <= np.ceil(PARAM_OUTLIERS * g.size), (k, n, g.size)
        assert off.max() <= 2 * LR, (k, off.max())


def perturbed(model: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(model).items()}


@pytest.mark.parametrize("model", ["rnnrf_r94", "rgrgr_r94", "nanonet_events"])
def test_wholeread_step_matches_jax(model):
    """One full-parameter whole-region step against JAX's: rnnrf_r94
    through make_wholeread_step, rgrgr_r94 and nanonet_events (event
    features) through make_wholeread_transducer_step, on a simulated
    region of 128 blocks (events: 128 synthetic events), chunk 32."""
    chunk = 32
    params = perturbed(model, seed=6)
    if model == "nanonet_events":
        rng = np.random.default_rng(7)
        x = rng.standard_normal((1, 128, 4)).astype(np.float32)
        seq = rng.integers(0, 1024, size=(1, 90)).astype(np.int32)
    else:
        stride = RAW_MODELS[model].stride
        read = simulated_read(seed=8, seqlen=120)
        fn = "region_sequence" if model == "rnnrf_r94" else "region_seqstates"
        sig, seq = getattr(twr, fn)(read, 128 * stride, stride, chunk)
        x, seq = sig[None, :, None], seq[None]
    opt = optax_optimizer(LR)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ours = FiniteClippedAdam({k: torch.tensor(v) for k, v in params.items()},
                             LR)
    if model == "rnnrf_r94":
        jstep = jwr.make_wholeread_step(model, opt, chunk=chunk)
        step = twr.make_wholeread_step(model, ours, chunk=chunk)
    else:
        jstep = jwr.make_wholeread_transducer_step(model, opt, chunk=chunk)
        step = twr.make_wholeread_transducer_step(model, ours, chunk=chunk)
    jparams, _, want_loss = jstep(jparams, opt.init(jparams), x, seq)
    assert_step_matches(ours, jparams, step(x, seq), want_loss)


def test_head_step_moves_only_head_keys():
    """make_head_step on precomputed features: the optimiser holds
    HEAD_KEYS alone, one step equals JAX's, and the rest of the model's
    parameters are not touched."""
    params = perturbed("rnnrf_r94", seed=9)
    rng = np.random.default_rng(10)
    feats = np.tanh(rng.standard_normal((1, 64, 96))).astype(np.float32)
    bases = rng.integers(0, 4, size=(1, 30)).astype(np.int32)
    assert twr.HEAD_KEYS == jwr.HEAD_KEYS
    model = {k: torch.tensor(v) for k, v in params.items()}
    before = {k: v.clone() for k, v in model.items()}
    ours = FiniteClippedAdam({k: model[k] for k in twr.HEAD_KEYS}, LR)
    opt = optax_optimizer(LR)
    head = {k: jnp.asarray(params[k]) for k in jwr.HEAD_KEYS}
    jhead, _, want_loss = jwr.make_head_step(opt, chunk=CHUNK)(
        head, opt.init(head), feats, bases)
    loss = twr.make_head_step(ours, chunk=CHUNK)(feats, bases)
    assert_step_matches(ours, jhead, loss, want_loss)
    for k in model:
        assert torch.equal(model[k], before[k]) == (k not in twr.HEAD_KEYS), k
