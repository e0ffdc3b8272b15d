"""Training on the CPU: the port's backward passes, losses, optimiser and
trainer against the JAX package on the same seeded inputs.

The port's plain twins stand in for its CUDA kernels here: the GRU
recurrence's backward walk (ops/gru.gru_walk_plain, the twin of
gru_recurrence_bwd_kernel) and the CRF forward-backward
(ops/crf.crf_partition_grad_tm_plain, crf_posterior_tm_plain, the twins of
crf_walk_kernel and its marginal passes). The references are torch.autograd
through the plain forward loops, and jax.grad / jax.value_and_grad of the
JAX functions.

Tolerances, and why:
  * GRU backward: 1e-5 relative to each gradient's largest entry. Float32
    sums in another order over T steps; seen at most 1.2e-6.
  * CRF partition backward: 2e-5 relative to the largest entry. The port
    takes each block's edge marginals as a softmax of max-normalised forward
    and backward scores; JAX differentiates its scan step by step, whose
    float32 error grows with logZ. Seen at most 2.6e-6 against JAX at
    T <= 40, and 1.7e-6 against a float64 reference at T = 300, where JAX
    is off by up to 1.7e-4.
  * Losses and every parameter gradient of the three models: 1e-5 relative
    to the loss, 1e-4 relative to each gradient's largest entry (five GRU
    layers and the CRF's 300 blocks; seen at most 2.1e-5, rnnrf).
  * Three training steps: each loss within rtol 5e-5 (seen 8e-6); the
    parameters within 1e-4 absolute but for at most 1 weight in 10 000 of
    each leaf, rounded up (so at most 1 in a leaf of fewer than 10 000),
    and none off by more than 2 lr a step. Adam's first step moves every
    weight by about lr (1e-3) whatever its gradient's size, so a weight
    whose gradient is within float noise of 0 may move either way (seen: 8
    of 282 265 rnnrf weights beyond 1e-4, at most 2 in a leaf, gruB5_iW's
    27 648, and at most 6.7e-4 off; none of rgrgr_r94's or raw_r94's). A
    leaf updated wrongly as a whole fails the count.
  * The optimiser against optax: 1e-6 relative on parameters and moments
    (the same formulas in float32; torch and XLA may round the reductions
    and powers apart by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.nn import rnn as trnn
from scrappie_torch.ops import crf as tc
from scrappie_torch.ops import gru as tg
from scrappie_torch.ops.project import Project
from scrappie_torch.train import trainer as tt
from scrappie_torch.train import optim
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_tpu import ops as jops
from scrappie_tpu.models import registry
from scrappie_tpu.models.specs import RAW_MODELS
from scrappie_tpu.nn import layers as jl
from scrappie_tpu.nn import rnn as jrnn
from scrappie_tpu.train import trainer as jt
from scrappie_tpu.train.simulate import SquiggleSimulator as JSim

torch.set_num_threads(1)
MODELS = ("rgrgr_r94", "raw_r94", "rnnrf_r94")
GRU_RTOL = 1e-5
CRF_RTOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 5e-5
TRAIN_PARAM_ATOL = 1e-4
TRAIN_PARAM_OUTLIERS = 1e-4   # the share of a leaf allowed past the atol
OPT_RTOL = 1e-6
NSAMPLE, BATCH, LR = 600, 2, 1e-3  # tests/test_models.py's training sizes


def assert_rel_close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def gru_inputs(S: int, T: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, 3 * S)).astype(np.float32)
    sW = (0.3 * rng.standard_normal((S, 2 * S))).astype(np.float32)
    sW2 = (0.3 * rng.standard_normal((S, S))).astype(np.float32)
    gh = rng.standard_normal((T, B, S)).astype(np.float32)
    return x, sW, sW2, gh


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_twin_matches_autograd(S, reverse):
    """gru_tm_backward on CPU tensors (the gates from h, the walk's twin,
    the weight products) against torch.autograd through the plain forward
    loop."""
    x, sW, sW2, gh = (torch.tensor(a) for a in gru_inputs(S, 37, 3, seed=S))
    leaves = [t.clone().requires_grad_(True) for t in (x, sW, sW2)]
    h = trnn.gru_tm(*leaves, reverse)
    h.backward(gh)
    got = tg.gru_tm_backward(x, h.detach(), sW, sW2, gh, reverse)
    for name, g, leaf in zip(("dx", "dsW", "dsW2"), got, leaves):
        assert_rel_close(g, leaf.grad, GRU_RTOL, name)
    assert ops.LAUNCHES["gru_recurrence_bwd"] == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_recurrence_backward_matches_jax(reverse):
    """GruRecurrence's backward (the CPU's twin walk) against jax.grad of
    scrappie_tpu.nn.rnn.gru, on <h, gh> at S = 12."""
    x, sW, sW2, gh = gru_inputs(12, 41, 3, seed=20 + reverse)

    def f(x, sW, sW2):
        h = jrnn.gru(jnp.moveaxis(x, 0, 1), sW, sW2, reverse)
        return (h * jnp.moveaxis(gh, 0, 1)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(x, sW, sW2)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, sW, sW2)]
    (tg.GruRecurrence.apply(*leaves, reverse) * torch.tensor(gh)).sum().backward()
    for name, w, leaf in zip(("dx", "dsW", "dsW2"), want, leaves):
        assert_rel_close(leaf.grad, w, GRU_RTOL, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_recurrence_backward_matches_jax_above_the_registers(reverse):
    """At S = 160, above the register kernels' S = 96: the walk's checks
    choose the big-S mode (no longer raise), and GruRecurrence's backward
    (the CPU's twin walk) matches jax.grad of scrappie_tpu.nn.rnn.gru."""
    S, T, B = 160, 23, 2
    rng = np.random.default_rng(24 + reverse)
    x = rng.standard_normal((T, B, 3 * S)).astype(np.float32)
    sW = (S ** -0.5 * rng.standard_normal((S, 2 * S))).astype(np.float32)
    sW2 = (S ** -0.5 * rng.standard_normal((S, S))).astype(np.float32)
    gh = rng.standard_normal((T, B, S)).astype(np.float32)

    def f(x, sW, sW2):
        h = jrnn.gru(jnp.moveaxis(x, 0, 1), sW, sW2, reverse)
        return (h * jnp.moveaxis(gh, 0, 1)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(x, sW, sW2)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, sW, sW2)]
    (tg.GruRecurrence.apply(*leaves, reverse) * torch.tensor(gh)).sum().backward()
    for name, w, leaf in zip(("dx", "dsW", "dsW2"), want, leaves):
        assert_rel_close(leaf.grad, w, GRU_RTOL, name)
    walk = (torch.zeros((T, B, 3 * S)), torch.zeros((T, B, S)),
            torch.zeros((T, B, S)), torch.tensor(sW), torch.tensor(sW2))
    assert tg.check_gru_walk_input(*walk) is True
    small = (torch.zeros((T, B, 288)), torch.zeros((T, B, 96)),
             torch.zeros((T, B, 96)), torch.zeros((96, 192)),
             torch.zeros((96, 96)))
    assert tg.check_gru_walk_input(*small) is False


def test_gru_layer_builds_a_graph_only_for_gradients():
    """The layer always goes through Project and GruRecurrence: under
    inference_mode autograd records nothing (no grad_fn), with parameters
    that require gradients the output carries GruRecurrence's backward,
    and both give the plain twin's values exactly."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((9, 2, 5)).astype(np.float32))
    iW = torch.tensor((0.3 * rng.standard_normal((5, 24))).astype(np.float32))
    b, sW = torch.zeros(24), torch.zeros(8, 16)
    sW2 = torch.tensor((0.3 * rng.standard_normal((8, 8))).astype(np.float32))
    with torch.inference_mode():
        plain = tg.gru_layer_tm(x, iW, b, sW, sW2)
    assert plain.grad_fn is None
    leaf = iW.clone().requires_grad_(True)
    h = tg.gru_layer_tm(x, leaf, b, sW, sW2)
    assert type(h.grad_fn).__name__ == "GruRecurrenceBackward"
    torch.testing.assert_close(h.detach(), plain, rtol=0, atol=0)
    torch.testing.assert_close(plain, tg.gru_layer_tm_plain(x, iW, b, sW, sW2),
                               rtol=0, atol=0)


def test_project_backward_matches_autograd():
    rng = np.random.default_rng(4)
    x, W, b = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            requires_grad=True)
               for s in ((6, 3, 7), (7, 11), (11,)))
    g = torch.tensor(rng.standard_normal((6, 3, 11)).astype(np.float32))
    Project.apply(x, W, b).backward(g)
    got = [t.grad for t in (x, W, b)]
    refs = [t.detach().clone().requires_grad_(True) for t in (x, W, b)]
    (torch.matmul(refs[0], refs[1]) + refs[2]).backward(g)
    for name, a, r in zip("xWb", got, refs):
        assert_rel_close(a, r.grad, 1e-6, name)


def crf_trans(B: int, T: int, seed: int, scale: float = 2.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, T, 25))).astype(np.float32)


@pytest.mark.parametrize("B,T", [(1, 1), (3, 7), (2, 40)])
def test_crf_partition_backward_matches_jax(B, T):
    """CrfPartition's backward (the edge-marginal twin) against jax.grad of
    nn.layers.crf_partition_function, on <logZ, g>; each block's edge
    marginals sum to 1."""
    tr = crf_trans(B, T, seed=T)
    g = np.random.default_rng(T + 1).standard_normal(B).astype(np.float32)
    want = jax.grad(lambda t: (jl.crf_partition_function(t) * g).sum())(tr)
    leaf = torch.tensor(tr).transpose(0, 1).contiguous().requires_grad_(True)
    logz = tc.CrfPartition.apply(leaf)
    assert type(logz.grad_fn).__name__ == "CrfPartitionBackward"
    torch.testing.assert_close(
        logz.detach(), torch.tensor(np.asarray(jl.crf_partition_function(tr))),
        rtol=1e-6, atol=1e-6)
    (logz * torch.tensor(g)).sum().backward()
    assert_rel_close(leaf.grad.transpose(0, 1), want, CRF_RTOL, "dtrans")
    edge = tc.crf_partition_grad_tm_plain(leaf.detach(), torch.ones(B))
    np.testing.assert_allclose(edge.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("scale", [2.0, 20.0])
def test_crf_partition_backward_keeps_float32_precision(scale):
    """At T = 300 logZ reaches the hundreds (scale 2) or thousands (20),
    where the float32 step-by-step gradient of JAX's scan is off by 2.3e-5
    and 1.7e-4 relative to a float64 reference. The port's edge marginals,
    a softmax of max-normalised scores a block, stay within CRF_RTOL of
    float64 autograd through the plain partition loop (seen 3.9e-7 and
    1.7e-6)."""
    from scrappie_torch.nn.layers import crf_partition_function

    tr = crf_trans(2, 300, seed=300, scale=scale)
    g = np.random.default_rng(301).standard_normal(2).astype(np.float32)
    x64 = torch.tensor(tr, dtype=torch.float64, requires_grad=True)
    (crf_partition_function(x64) * torch.tensor(g, dtype=torch.float64)).sum().backward()
    got = tc.crf_partition_grad_tm_plain(torch.tensor(tr).transpose(0, 1).contiguous(),
                                         torch.tensor(g))
    assert_rel_close(got.transpose(0, 1), x64.grad, CRF_RTOL, "dtrans")


@pytest.mark.parametrize("B,T", [(1, 1), (2, 19), (3, 60)])
def test_crf_posterior_twin_matches_jax(B, T):
    """The forward-backward twin's state posterior against
    scrappie_tpu.decode.crf.posterior_crf (absolute 1e-5, as
    tests/test_torch_crf.py holds it); its rows sum to 1."""
    from scrappie_tpu.decode.crf import posterior_crf

    tr = crf_trans(B, T, seed=100 + T)
    post = tc.crf_posterior_tm_plain(torch.tensor(tr).transpose(0, 1).contiguous())
    np.testing.assert_allclose(post.numpy(), np.asarray(posterior_crf(tr)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(post.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert ops.LAUNCHES["crf_posterior"] == 0


def perturbed(model: str, seed: int) -> dict:
    """The in-repo weights plus 0.05 seeded standard-normal noise."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(model).items()}


def jax_batch(model: str, seed: int, n: int = 1) -> list:
    spec = RAW_MODELS[model]
    sim = JSim(seed=seed)
    make = sim.crf_labelled_batch if spec.kind == "rnnrf" else sim.labelled_batch
    return [make(BATCH, NSAMPLE, spec.stride) for _ in range(n)]


@pytest.fixture(autouse=True)
def _jax_scan_reference():
    # The JAX programs must not dispatch to Pallas themselves.
    with jops.pallas(False):
        yield


@pytest.mark.parametrize("model", MODELS)
def test_loss_and_gradients_match_jax(model):
    """loss_fn (rgrgr_r94, raw_r94) or crf_loss_fn (rnnrf_r94), its value
    and every parameter's gradient, against jax.value_and_grad of the JAX
    trainer's function on the same batch and weights."""
    params = perturbed(model, seed=3)
    (sig, labels), = jax_batch(model, seed=4)
    lfn = jt.crf_loss_fn if RAW_MODELS[model].kind == "rnnrf" else jt.loss_fn
    want_loss, want = jax.value_and_grad(lfn)(
        {k: jnp.asarray(v) for k, v in params.items()}, sig, labels, model)
    ours = {"rnnrf": tt.crf_loss_fn}.get(RAW_MODELS[model].kind, tt.loss_fn)
    assert tt._loss_for(model) is ours
    loss, grads = tt.value_and_grad(
        model, {k: torch.tensor(v) for k, v in params.items()}, sig, labels)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert set(grads) == set(params)
    for k in sorted(params):
        assert_rel_close(grads[k], want[k], GRAD_RTOL, k)


class Replay:
    """A simulator that hands out given batches in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def labelled_batch(self, batch, nsample, stride):
        return self.batches.pop(0)

    crf_labelled_batch = labelled_batch


@pytest.mark.parametrize("model", MODELS)
def test_train_matches_jax(model):
    """Three steps of train(..., device="cpu") against
    scrappie_tpu.train.trainer.train from the same perturbed weights on the
    same simulator batches: the losses, and the returned parameters (the
    JAX package's keys, shapes and dtype)."""
    params = perturbed(model, seed=5)
    batches = jax_batch(model, seed=6, n=3)
    kw = dict(steps=3, batch=BATCH, nsample=NSAMPLE, lr=LR, params=params,
              log_every=0)
    want_params, want_losses = jt.train(model, simulator=Replay(batches), **kw)
    got_params, got_losses = tt.train(model, simulator=Replay(batches),
                                      device="cpu", **kw)
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAIN_LOSS_RTOL)
    assert got_losses[-1] < got_losses[0]
    assert set(got_params) == set(want_params)
    outliers = total = 0
    for k, want in want_params.items():
        got = got_params[k]
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        off = np.abs(got - want)
        n = int((off > TRAIN_PARAM_ATOL).sum())
        assert n <= np.ceil(TRAIN_PARAM_OUTLIERS * got.size), (k, n, got.size)
        assert off.max() <= 2 * LR * 3, (k, off.max())
        outliers += n
        total += got.size
    assert outliers <= TRAIN_PARAM_OUTLIERS * total, (outliers, total)


def test_train_refuses_what_is_not_ported():
    """train(mesh=) trains now (tests/test_torch_mesh_train.py holds it to
    mesh=None for every model): here one step on a (2, 1) CPU mesh gives
    mesh=None's loss within LOSS_RTOL. What is still refused: a mesh that
    is not a sharding.Mesh, a device and a mesh at once, a model with no
    trainer."""
    from scrappie_torch.parallel.sharding import make_mesh

    kw = dict(steps=1, batch=BATCH, nsample=NSAMPLE, lr=LR, log_every=0)
    batches = jax_batch("rgrgr_r94", seed=9)
    _, want = tt.train("rgrgr_r94", simulator=Replay(batches), device="cpu",
                       **kw)
    _, got = tt.train("rgrgr_r94", simulator=Replay(batches),
                      mesh=make_mesh(devices=["cpu"] * 2), **kw)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    with pytest.raises(TypeError, match="Mesh"):
        tt.train("rgrgr_r94", steps=1, mesh=object())
    with pytest.raises(ValueError, match="not both"):
        tt.train("rgrgr_r94", steps=1, mesh=make_mesh(devices=["cpu"]),
                 device="cpu")
    with pytest.raises(ValueError, match="no trainer"):
        tt.make_train_step("squiggle_r94", None)


def optax_optimizer(lr, max_errors):
    return optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr)),
        max_consecutive_errors=max_errors)


# Each case: a sequence of gradient scales; inf puts a non-finite entry in
# that step's gradient. "clip" steps have a global norm above 1. "gives
# up" has one more non-finite step in a row than MAX_CONSECUTIVE_ERRORS
# (25), so its last non-finite step is applied.
OPT_CASES = {
    "small": [0.01, 0.02, 0.005],
    "clip": [0.01, 5.0, 3.0, 0.01],
    "not finite": [0.01, np.inf, 0.02, np.inf, np.inf, 0.01],
    "gives up": [0.01] + [np.inf] * 26 + [0.01],
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """FiniteClippedAdam against optax's apply_if_finite(chain(
    clip_by_global_norm(1.0), adam(lr)), max_consecutive_errors=25): the
    parameters after every step and the state (count, moments, the count
    of consecutive non-finite steps)."""
    max_errors = 25
    assert optim.MAX_CONSECUTIVE_ERRORS == max_errors and optim.MAX_NORM == 1.0
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    opt = optax_optimizer(2e-3, max_errors)
    state = opt.init({k: jnp.asarray(v) for k, v in params.items()})
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    ours = FiniteClippedAdam(tparams, 2e-3)
    for scale in OPT_CASES[case]:
        grads = {k: (rng.standard_normal(s) * (1.0 if np.isinf(scale) else scale)
                     ).astype(np.float32) for k, s in shapes.items()}
        if np.isinf(scale):
            grads["b"][2] = np.inf
        updates, state = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                    state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = ours.step({k: torch.tensor(v) for k, v in grads.items()})
        assert applied == (not np.isinf(scale)
                           or int(state.notfinite_count) > max_errors)
        assert ours.notfinite_count == int(state.notfinite_count)
        inner = state.inner_state[1][0]  # chain(clip, adam): adam's state
        assert ours.count == int(inner.count)
        for k in shapes:
            for got, want in ((tparams[k], jparams[k]), (ours.mu[k], inner.mu[k]),
                              (ours.nu[k], inner.nu[k])):
                got, want = got.numpy(), np.asarray(want)
                if np.isfinite(want).all():
                    assert_rel_close(got, want, OPT_RTOL, k)
                else:
                    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_optimizer_clips_by_optax_rule():
    """Below the norm the gradient passes unchanged, above it becomes
    g / norm * MAX_NORM (not clip_grad_norm_'s max_norm / (norm + 1e-6)):
    seen in the first moment, mu = (1 - B1) * the clipped gradient."""
    for scale in (0.5, 2.0):
        g = torch.full((4,), scale / 2)  # global norm = scale
        p = {"w": torch.zeros(4)}
        opt = FiniteClippedAdam(p, 1.0)
        opt.step({"w": g})
        clipped = g if scale < 1 else (g / scale) * optim.MAX_NORM
        torch.testing.assert_close(opt.mu["w"], (1 - optim.B1) * clipped,
                                   rtol=0, atol=0)


def test_training_hands_the_kernels_their_layout(monkeypatch):
    """On the card the backward kernels (GRU walk, CRF forward-backward)
    and the forward's raise unless their inputs are contiguous and of their
    types; the CPU twins take any layout. So the twins here run those
    checks first, in a training step of each model, and each must be
    reached."""
    seen = set()

    def checked(module, name, check):
        plain = getattr(module, name)

        def run(*args):
            check(*args)
            seen.add(name)
            return plain(*args)
        monkeypatch.setattr(module, name, run)

    checked(tg, "gru_walk_plain", lambda gates, hp, gh, sW, sW2, rev, *_:
            tg.check_gru_walk_input(gates, hp, gh, sW, sW2))
    checked(tc, "crf_partition_grad_tm_plain", tc.check_partition_grad_input)
    checked(tc, "crf_partition_tm_plain", tc.check_trans_input)
    checked(trnn, "gru_tm", lambda x, sW, sW2, rev, *_:
            tg.check_gru_recurrence_input(x, sW, sW2))
    for model in MODELS:
        params = perturbed(model, seed=8)
        (sig, labels), = jax_batch(model, seed=9)
        loss, grads = tt.value_and_grad(
            model, {k: torch.tensor(v) for k, v in params.items()}, sig, labels)
        assert np.isfinite(float(loss))
    assert seen == {"gru_walk_plain", "crf_partition_grad_tm_plain",
                    "crf_partition_tm_plain", "gru_tm"}
