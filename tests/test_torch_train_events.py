"""Events training on the CPU: the peephole LSTM's backward, the
nanonet_events loss and trainer, and the simulator's lattice and events
batches, against the JAX package on the same seeded inputs.

The port's plain twins stand in for its CUDA kernels here: the LSTM's
backward walk (ops/lstm.lstm_walk_plain, the twin of
lstm_recurrence_bwd_kernel) and the recurrence that also returns the
planes the walk reads (nn/rnn.lstm_tm(return_planes=True), the twin of the
forward's training mode).
The references are torch.autograd through the plain forward loop, and
jax.grad / jax.value_and_grad of the JAX functions under
jops.pallas(False), as the JAX trainer runs them.

Tolerances, and why:
  * LSTM backward: 1e-5 relative to each gradient's largest entry.
    Float32 sums in another order over T steps; seen at most 3.8e-7
    against JAX and 2.9e-7 against autograd.
  * A stage through LstmPair (its projection of both layers' weights side
    by side) against the inference route (one projection a layer): 1e-6
    absolute (seen 0: the same products, the concatenated weights'
    columns blocked alike).
  * nanonet_events' loss: 1e-5 relative; every parameter's gradient 1e-4
    relative to its largest entry (tests/test_torch_train.py's limits; seen
    at most 2.1e-6, lstmB1_p).
  * Three training steps: tests/test_torch_train.py's rule (losses rtol
    5e-5, the parameters within 1e-4 but for at most 1 weight in 10 000 of
    a leaf, rounded up, none off by more than 2 lr a step).
  * The simulator's batches, with the squiggle network's output handed to
    both (the port's squiggle network differs from JAX's by float noise,
    which moves the event detector's boundaries): labels, seqstates and
    truths equal, features within 1e-6 absolute (seen 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.nn import rnn as trnn
from scrappie_torch.ops import lstm as tlstm
from scrappie_torch.ops.pipeline import events_features_tm, lstm_weights
from scrappie_torch.train import simulate as tsim
from scrappie_torch.train import trainer as tt
from scrappie_tpu import ops as jops
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.nn import rnn as jrnn
from scrappie_tpu.train import simulate as jsim
from scrappie_tpu.train import trainer as jt

torch.set_num_threads(1)
LSTM_RTOL = 1e-5
PAIR_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 5e-5
TRAIN_PARAM_ATOL = 1e-4
TRAIN_PARAM_OUTLIERS = 1e-4
FEAT_ATOL = 1e-6
NSAMPLE, BATCH, LR = 600, 2, 1e-3  # 60 detected events a row
MODEL = "nanonet_events"


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


def lstm_inputs(S: int, T: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, 4 * S)).astype(np.float32)
    sW = (0.3 * rng.standard_normal((S, 4 * S))).astype(np.float32)
    peep = (0.3 * rng.standard_normal(3 * S)).astype(np.float32)
    gh = rng.standard_normal((T, B, S)).astype(np.float32)
    return x, sW, peep, gh


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_twin_matches_autograd(S, reverse):
    """lstm_tm_backward on CPU tensors (the walk's twin on the forward's
    planes, its dpeep partials, the dsW product) against torch.autograd
    through the plain forward loop; the twin's h is the loop's."""
    x, sW, peep, gh = (torch.tensor(a) for a in lstm_inputs(S, 37, 3, seed=S))
    leaves = [t.clone().requires_grad_(True) for t in (x, sW, peep)]
    h = trnn.lstm_tm(*leaves, reverse)
    h.backward(gh)
    h2, planes = trnn.lstm_tm(x, sW, peep, reverse, return_planes=True)
    torch.testing.assert_close(h2, h.detach(), rtol=0, atol=0)
    da, ((dsW, dpeep),) = tlstm.lstm_tm_backward(
        [(h2, planes, sW, peep, reverse, gh)])
    for name, g, leaf in zip(("dx", "dsW", "dpeep"), (da, dsW, dpeep), leaves):
        assert_rel_close(g, leaf.grad, LSTM_RTOL, name)
    assert ops.LAUNCHES["lstm_recurrence_bwd"] == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_recurrence_backward_matches_jax(reverse):
    """lstm_tm_backward of one direction (the CPU's twin walk, as LstmPair
    runs it a direction) against jax.grad of scrappie_tpu.nn.rnn.lstm, on
    <h, gh> at S = 12."""
    x, sW, peep, gh = lstm_inputs(12, 40, 3, seed=20 + reverse)

    def f(x, sW, peep):
        h = jrnn.lstm(jnp.moveaxis(x, 0, 1), sW, peep, reverse)
        return (h * jnp.moveaxis(gh, 0, 1)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(x, sW, peep)
    x, sW, peep, gh = (torch.tensor(a) for a in (x, sW, peep, gh))
    h, planes = trnn.lstm_tm(x, sW, peep, reverse, return_planes=True)
    da, ((dsW, dpeep),) = tlstm.lstm_tm_backward(
        [(h, planes, sW, peep, reverse, gh)])
    for name, w, g in zip(("dx", "dsW", "dpeep"), want, (da, dsW, dpeep)):
        assert_rel_close(g, w, LSTM_RTOL, name)


def stage_weights(C: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)
    return [(f(C, 4 * S, s=C ** -0.5), f(4 * S, s=0.1), f(S, 4 * S, s=0.3),
             f(3 * S, s=0.3)) for _ in "FB"]


def test_lstm_pair_backward_matches_jax():
    """A bidirectional stage through lstm_pair_tm with gradients wanted
    (Project, then LstmPair: one walk over both directions) against
    jax.grad of the JAX stage (each layer's projection, then nn.rnn.lstm
    forwards and backwards), every input's and weight's gradient."""
    T, B, C, S = 30, 2, 6, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, B, C)).astype(np.float32)
    gF, gB = (rng.standard_normal((T, B, S)).astype(np.float32) for _ in "FB")
    wF, wB = stage_weights(C, S, seed=4)

    def f(x, wF, wB):
        xb = jnp.moveaxis(x, 0, 1)
        hF = jrnn.lstm(xb @ wF[0] + wF[1], wF[2], wF[3], False)
        hB = jrnn.lstm(xb @ wB[0] + wB[1], wB[2], wB[3], True)
        return ((hF * jnp.moveaxis(gF, 0, 1)).sum()
                + (hB * jnp.moveaxis(gB, 0, 1)).sum())

    want = jax.grad(f, argnums=(0, 1, 2))(x, wF, wB)
    xt = torch.tensor(x, requires_grad=True)
    tw = [[torch.tensor(a, requires_grad=True) for a in w] for w in (wF, wB)]
    hF, hB = tlstm.lstm_pair_tm(xt, tw[0], tw[1])
    assert type(hF.grad_fn).__name__ == "LstmPairBackward"
    ((hF * torch.tensor(gF)).sum() + (hB * torch.tensor(gB)).sum()).backward()
    assert_rel_close(xt.grad, want[0], LSTM_RTOL, "dx")
    for d, ws, jw in zip("FB", tw, want[1:]):
        for name, t, w in zip(("iW", "b", "sW", "peep"), ws, jw):
            assert_rel_close(t.grad, w, LSTM_RTOL, f"{d} {name}")


def test_lstm_pair_backward_matches_jax_above_the_registers():
    """At S = 160, above the register kernels' S = 96: the training
    forward's and the walk's checks choose the big-S modes, and a
    stage through lstm_pair_tm with gradients wanted (Project, LstmPair)
    matches jax.grad of the JAX stage, every input's and weight's
    gradient."""
    T, B, C, S = 17, 2, 6, 160
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, B, C)).astype(np.float32)
    gF, gB = (rng.standard_normal((T, B, S)).astype(np.float32) for _ in "FB")
    f32 = lambda *shape, s: (s * rng.standard_normal(shape)).astype(np.float32)
    wF, wB = ([f32(C, 4 * S, s=C ** -0.5), f32(4 * S, s=0.1),
               f32(S, 4 * S, s=S ** -0.5), f32(3 * S, s=0.3)] for _ in "FB")

    def f(x, wF, wB):
        xb = jnp.moveaxis(x, 0, 1)
        hF = jrnn.lstm(xb @ wF[0] + wF[1], wF[2], wF[3], False)
        hB = jrnn.lstm(xb @ wB[0] + wB[1], wB[2], wB[3], True)
        return ((hF * jnp.moveaxis(gF, 0, 1)).sum()
                + (hB * jnp.moveaxis(gB, 0, 1)).sum())

    want = jax.grad(f, argnums=(0, 1, 2))(x, wF, wB)
    xt = torch.tensor(x, requires_grad=True)
    tw = [[torch.tensor(a, requires_grad=True) for a in w] for w in (wF, wB)]
    hF, hB = tlstm.lstm_pair_tm(xt, tw[0], tw[1])
    assert type(hF.grad_fn).__name__ == "LstmPairBackward"
    ((hF * torch.tensor(gF)).sum() + (hB * torch.tensor(gB)).sum()).backward()
    assert_rel_close(xt.grad, want[0], LSTM_RTOL, "dx")
    for d, ws, jw in zip("FB", tw, want[1:]):
        for name, t, w in zip(("iW", "b", "sW", "peep"), ws, jw):
            assert_rel_close(t.grad, w, LSTM_RTOL, f"{d} {name}")
    assert tlstm.check_walk_size(S) is True
    assert tlstm.check_walk_size(96) is False
    walk = (torch.zeros((tlstm.TRAIN_PLANES, T, B, S)), torch.zeros((T, B, S)),
            torch.tensor(wF[2]), torch.tensor(wF[3]))
    assert tlstm.check_walk_input(*walk) is True


def test_lstm_builds_a_graph_only_for_gradients():
    """The events network's stages go through Project and LstmPair only
    when a gradient is wanted: under inference_mode autograd records
    nothing, with parameters that require gradients the output carries
    LstmPair's backward, and both give the same features."""
    params = {k: torch.tensor(v) for k, v in registry.load_params(MODEL).items()}
    feats = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 20, 4)).astype(np.float32))
    with torch.inference_mode():
        plain = events_features_tm(params, feats)
    assert plain.grad_fn is None
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = events_features_tm(leaves, feats)
    w = lstm_weights(leaves, "F", 2)
    hF, _ = tlstm.lstm_pair_tm(torch.zeros((5, 2, 96)), w, lstm_weights(leaves, "B", 2))
    assert type(hF.grad_fn).__name__ == "LstmPairBackward"
    torch.testing.assert_close(x.detach(), plain, rtol=0, atol=PAIR_ATOL)
    assert ops.LAUNCHES["lstm_pair_train"] == 0


def perturbed(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(MODEL).items()}


def jax_batches(seed: int, n: int = 1) -> list:
    sim = jsim.SquiggleSimulator(seed=seed)
    return [sim.detected_events_batch(BATCH, NSAMPLE // 10) for _ in range(n)]


def test_events_loss_and_gradients_match_jax():
    """loss_fn on nanonet_events (min_prob 1e-6), its value and every
    parameter's gradient, against jax.value_and_grad of the JAX trainer's
    loss on the same detected-events batch and weights."""
    params = perturbed(seed=6)
    (feats, labels), = jax_batches(seed=7)
    assert (labels >= 0).sum() > 20
    want_loss, want = jax.value_and_grad(jt.loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()}, feats, labels, MODEL)
    assert tt._loss_for(MODEL) is tt.loss_fn
    loss, grads = tt.value_and_grad(
        MODEL, {k: torch.tensor(v) for k, v in params.items()}, feats, labels)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert set(grads) == set(params)
    for k in sorted(params):
        assert_rel_close(grads[k], want[k], GRAD_RTOL, k)


class Replay:
    """A simulator that hands out given event batches in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def detected_events_batch(self, batch, nevent):
        assert (batch, nevent) == (BATCH, NSAMPLE // 10)
        return self.batches.pop(0)


def test_events_train_matches_jax():
    """Three steps of train("nanonet_events", device="cpu") against
    scrappie_tpu.train.trainer.train from the same perturbed weights on the
    same batches: the losses and the returned parameters."""
    params = perturbed(seed=8)
    batches = jax_batches(seed=9, n=3)
    kw = dict(steps=3, batch=BATCH, nsample=NSAMPLE, lr=LR, params=params,
              log_every=0)
    want_params, want_losses = jt.train(MODEL, simulator=Replay(batches), **kw)
    got_params, got_losses = tt.train(MODEL, simulator=Replay(batches),
                                      device="cpu", **kw)
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAIN_LOSS_RTOL)
    assert got_losses[-1] < got_losses[0]
    assert set(got_params) == set(want_params)
    for k, want in want_params.items():
        got = got_params[k]
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        off = np.abs(got - want)
        n = int((off > TRAIN_PARAM_ATOL).sum())
        assert n <= np.ceil(TRAIN_PARAM_OUTLIERS * got.size), (k, n, got.size)
        assert off.max() <= 2 * LR * 3, (k, off.max())


SIM_CALLS = {
    "seq_batch": lambda sim: sim.seq_batch(3, 1000, 80),
    "events_labelled_batch": lambda sim: sim.events_labelled_batch(3, 50),
    "detected_events_batch": lambda sim: sim.detected_events_batch(
        3, 60, return_truth=True),
}


@pytest.mark.parametrize("call", sorted(SIM_CALLS))
def test_simulator_batches_match_jax(call, monkeypatch):
    """The port's seq_batch, events_labelled_batch and
    detected_events_batch against scrappie_tpu's from one seed, twice in a
    row (the random stream must stay in step), the JAX squiggle network's
    output handed to both."""
    ref = jsim.SquiggleSimulator(seed=13)
    port = tsim.SquiggleSimulator(seed=13, device="cpu")
    monkeypatch.setattr(port, "_squiggle", lambda bases: np.asarray(
        jforward.squiggle_forward(ref.params, bases.astype(np.int32),
                                  transform_units=True)))
    for _ in range(2):
        got, want = SIM_CALLS[call](port), SIM_CALLS[call](ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(b, list):
                assert a == b
            elif b.dtype.kind == "f":
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=FEAT_ATOL)
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
