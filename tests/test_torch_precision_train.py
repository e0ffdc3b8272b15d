"""Training under 'default' and 'bf16' on the CPU: the port's backward
passes (the plain twins of its kernels) against the JAX package's VJP
under the same mode, and against torch.autograd through the port's own
rounded twins.

What 'bf16' computes (scrappie_torch/nn/config.py): a product's operands
are rounded to bfloat16; the backward rounds each product's result (the
VJP of the forward's cast), inside a recurrence each step's weight
gradient before the sum over the steps. The port's plain twins round
their weights inside each step, so torch.autograd through a twin is that
VJP; the JAX package's jax.grad of its scan is the same function.

Why two references, and the tolerances:
  * Exact (float64): the port's backward Functions (ops/project.Project,
    ops/gru.GruRecurrence, ops/lstm.LstmPair, the walks' twins,
    nn/config.weight_grad) against torch.autograd through the rounded
    twins, both in float64, where the rounding to bfloat16 of a sum does
    not depend on the order of the sum: every gradient within EXACT_RTOL
    relative L2 (seen below 1e-15), for each layer and each model.
  * The JAX package (float32): two float32 orders of summation round
    alike to bfloat16 until a value falls within an fp32 ulp of a
    bfloat16 rounding boundary; there the two take neighbouring bfloat16
    values, one bfloat16 ulp apart, and in a recurrence the difference is
    carried into every later step and its roundings. Against jax.vjp of
    one layer on the inputs below each layer has its own LAYER_RTOL from
    its own reading (1.7e-7 to 2.4e-4), and a backward that rounds
    nothing lands outside it (3.7e-4 to 2.3e-3 away). The readings hang
    on the inputs: over seeds 0-7 of the same shapes a dense layer reads
    up to 2.4e-4, the LSTM pair 4.1e-4 and the GRU layer 2.5e-3 (a flip
    carried through 40 steps, as far as a backward that rounds nothing),
    so the exactness is the float64 tests' above. A whole model compounds
    this through five recurrent layers: JAX's own bfloat16 loss of one
    read moves by up to 4.5e-3 between a batch of 1 and a batch of 3
    copies (rnnrf_r94, 25 blocks), which only the summation order of its
    products changes, and its gradients by up to 1.3e-2; the port's lie
    as far from JAX's (seen up to 8.2e-4 on the loss and 9.1e-3 on a
    gradient at 2 x 200 samples): MODEL_LOSS_RTOL and MODEL_GRAD_RTOL
    bound that. They would pass a backward that rounds nothing too
    ('highest''s gradients lie 9.9e-3 to 1.7e-2 from JAX's 'bf16' ones),
    so each model's whole gradient must also lie nearer JAX's than
    'highest''s does, and the exact test above carries the models'
    check.
  * At T = 2 one step adds to the weight gradient, so the GRU's and the
    LSTM's dsW are bfloat16 values; at T = 3 two rounded steps are
    summed in fp32 and the GRU's match JAX's within STEP_RTOL.
  * 'default' is plain fp32 on the CPU: a training step equals
    'highest''s bit for bit.
  * train(mesh=) in 'bf16' on a CPU mesh against one device: a replica
    runs its rows in products of other shapes, summed in another order,
    so its bfloat16 roundings part from one device's as the port's part
    from JAX's, and each replica rounds its own weight-gradient products
    before they are summed. The first step's gradient: each leaf within
    MESH_GRAD_RTOL of one device's (seen up to 4.2e-3 on a (2, 2) mesh;
    5.7e-3 over seeds 1, 2 and 7; 1.4e-6 in 'highest'), the whole
    MESH_NEARER times nearer one device's 'bf16' gradient than its
    'highest' one (seen 3.7 and 4.8 times; 2.6 to 6.1 over those seeds);
    a replica's gradient left out moves a leaf by tens of percent. The
    losses of three steps within MODEL_LOSS_RTOL (the first 1.0e-4 apart
    for rgrgr_r94, against 1e-7 in 'highest').
Each test also checks that 'bf16' is live: its result differs from
'highest''s.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch.models import forward as tforward
from scrappie_torch.nn import config
from scrappie_torch.nn import layers as tl
from scrappie_torch.nn import rnn as trnn
from scrappie_torch.ops import gru as tg
from scrappie_torch.ops import lstm as tlstm
from scrappie_torch.ops import pipeline as tpipe
from scrappie_torch.parallel.sharding import make_mesh
from scrappie_torch.train import lattice as tlat
from scrappie_torch.train import trainer as tt
from scrappie_torch.train import wholeread as twr
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_torch.train.simulate import SquiggleSimulator
from scrappie_tpu import ops as jops
from scrappie_tpu.models import registry
from scrappie_tpu.nn import config as jconfig
from scrappie_tpu.nn import layers as jl
from scrappie_tpu.nn import rnn as jrnn
from scrappie_tpu.train import lattice as jlat
from scrappie_tpu.train import trainer as jt
from scrappie_tpu.train import wholeread as jwr

torch.set_num_threads(1)
EXACT_RTOL = 1e-12
# Each layer's limit against jax.vjp on its inputs below, from its largest
# gradient reading (in brackets) with a margin; a backward that rounds
# nothing lies 6.8e-4 (a bias's gradient in the LSTM pair: 3.7e-4) to
# 2.3e-3 away.
LAYER_RTOL = {"gru": 1e-5,                        # (6.3e-7)
              "gru_reverse": 1e-4,                # (5.5e-5)
              "lstm_pair": 2e-4,                  # (6.7e-5)
              "feedforward": 1e-5,                # (1.7e-7)
              "feedforward2_tanh": 2e-4,          # (5.4e-5)
              "conv1d": 1e-5,                     # (2.0e-7)
              "softmax_with_temperature": 5e-4,   # (2.4e-4)
              "globalnorm": 5e-5}                 # (1.3e-5)
STEP_RTOL = 1e-5
MODEL_LOSS_RTOL = 5e-3
MODEL_GRAD_RTOL = 3e-2
MESH_GRAD_RTOL = 1e-2
MESH_NEARER = 2
MODELS = ("rgrgr_r94", "raw_r94", "rnnrf_r94", "nanonet_events")
STRIDES = {"rgrgr_r94": 5, "raw_r94": 4, "rnnrf_r94": 2}
NSAMPLE, BATCH = 200, 2  # short signals: 40 to 100 blocks, 20 events


@pytest.fixture(autouse=True)
def _policies():
    """The JAX scan path (no Pallas), and both packages' modes restored."""
    jold = (jconfig.get_precision(), jconfig.bf16_emulation())
    with jops.pallas(False):
        yield
    config.set_precision("highest")
    jconfig._PRECISION, jconfig._BF16_EMULATE = jold


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def is_bf16(a) -> bool:
    a = torch.as_tensor(np.asarray(a, np.float32))
    return bool(torch.equal(a.to(torch.bfloat16).to(torch.float32), a))


@contextlib.contextmanager
def twin_autograd():
    """The models' recurrent layers and globalnorm as torch.autograd
    through the plain rounded twins, in place of the autograd Functions
    whose backward the port computes itself."""
    mp = pytest.MonkeyPatch()

    def gru(x, iW, b, sW, sW2, reverse=False):
        return tg.gru_layer_tm_plain(x, iW, b, sW, sW2, reverse,
                                     config.kernel_rounding(x.device))

    def lstm_pair(x, wF, wB):
        return tlstm.lstm_pair_tm_plain(x, wF, wB,
                                        config.kernel_rounding(x.device))

    def globalnorm_tm(x_tm, W, b):
        trans = tl.feedforward(x_tm, W, b)
        logZ = tl.crf_partition_function(trans.transpose(0, 1)) / trans.shape[0]
        return trans - logZ[:, None]

    mp.setattr(tpipe, "gru_layer_tm", gru)
    mp.setattr(tpipe, "lstm_pair_tm", lstm_pair)
    mp.setattr(tforward, "globalnorm_tm", globalnorm_tm)
    mp.setattr(tl, "globalnorm_tm", globalnorm_tm)
    try:
        yield
    finally:
        mp.undo()


def torch_vjp(fn, arrays, cot, dtype=torch.float32):
    """fn(*tensors)'s VJP on cot at arrays -> [gradient] (numpy)."""
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, [torch.tensor(c, dtype=dtype) for c in cots])
    return [l.grad.numpy() for l in leaves]


def jax_vjp(fn, arrays, cot):
    """jax.vjp of fn at arrays on cot, under the JAX package's 'bf16'."""
    with jconfig.precision("bf16"):
        _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
        cots = tuple(map(jnp.asarray, cot)) if isinstance(cot, tuple) else jnp.asarray(cot)
        return [np.asarray(g) for g in vjp(cots)]


# ------------------------------------------------------------------ layers


def _f(rng):
    return lambda *s, sc=0.3: (sc * rng.standard_normal(s)).astype(np.float32)


def gru_case(reverse: bool, T: int = 40, seed: int | None = None):
    """A GRU layer (T x 3 rows of 12 features, S = 16; the inputs of
    tests/test_torch_precision.py's forward test): (port fn, twin fn, JAX
    fn, arrays, cotangent)."""
    f = _f(np.random.default_rng(3 + reverse if seed is None else seed))
    f5 = lambda *s, sc=0.5: f(*s, sc=sc)
    arrays = (f5(T, 3, 12, sc=1.0), f5(12, 48), f5(48, sc=0.1), f5(16, 32),
              f5(16, 16))
    cot = f5(T, 3, 16, sc=1.0)
    port = lambda *a: tg.gru_layer_tm(*a, reverse=reverse)
    twin = lambda *a: tg.gru_layer_tm_plain(*a, reverse,
                                            config.kernel_rounding(a[0].device))
    jfn = lambda x, iW, b, sW, sW2: jnp.moveaxis(jrnn.gru(
        jl.feedforward(jnp.moveaxis(x, 0, 1), iW, b), sW, sW2, reverse), 0, 1)
    return port, twin, jfn, arrays, cot


def lstm_case(T: int = 30, seed: int = 6):
    """An LSTM stage (T x 2 rows of 12 features, S = 16; as
    tests/test_torch_precision.py's)."""
    f = _f(np.random.default_rng(seed))
    S = 16
    arrays = (f(T, 2, 12, sc=1.0),
              *(a for _ in "FB" for a in (f(12, 4 * S), f(4 * S, sc=0.1),
                                          f(S, 4 * S), f(3 * S))))
    cot = (f(T, 2, S, sc=1.0), f(T, 2, S, sc=1.0))
    port = lambda x, *w: tlstm.lstm_pair_tm(x, w[:4], w[4:])
    twin = lambda x, *w: tlstm.lstm_pair_tm_plain(
        x, w[:4], w[4:], config.kernel_rounding(x.device))

    def jfn(x, *w):
        xb = jnp.moveaxis(x, 0, 1)
        return tuple(jnp.moveaxis(jrnn.lstm(jl.feedforward(xb, *w[4 * k : 4 * k + 2]),
                                            *w[4 * k + 2 : 4 * k + 4], reverse=bool(k)),
                                  0, 1) for k in (0, 1))
    return port, twin, jfn, arrays, cot


def dense_case(layer: str):
    """tests/test_torch_precision.py's dense layer inputs; the cotangent
    seeded."""
    f = _f(np.random.default_rng(7))
    extra = ()
    if layer == "conv1d":
        arrays, extra, shape = (f(2, 301, 1, sc=1.0), f(19, 1, 96), f(96)), (5,), (2, 61, 96)
    elif layer == "feedforward":
        arrays, shape = (f(2, 50, 96, sc=1.0), f(96, 40), f(40)), (2, 50, 40)
    elif layer == "feedforward2_tanh":
        arrays = (f(2, 50, 96, sc=1.0), f(2, 50, 96, sc=1.0), f(96, 96), f(96, 96), f(96))
        shape = (2, 50, 96)
    elif layer == "softmax_with_temperature":
        arrays = (f(2, 50, 96, sc=1.0), f(96, 1025), f(1025))
        extra, shape = (0.8, 1.2), (2, 50, 1025)
    else:
        arrays, shape = (f(2, 50, 96, sc=1.0), f(96, 25), f(25)), (2, 50, 25)
    cot = f(*shape, sc=1.0)
    port = lambda *a: getattr(tl, layer)(*a, *extra)
    return port, port, lambda *a: getattr(jl, layer)(*a, *extra), arrays, cot


LAYERS = ("gru", "gru_reverse", "lstm_pair", "feedforward", "feedforward2_tanh",
          "conv1d", "softmax_with_temperature", "globalnorm")
DENSE = LAYERS[3:]


def layer_case(name: str):
    if name.startswith("gru"):
        return gru_case(name == "gru_reverse")
    if name == "lstm_pair":
        return lstm_case()
    return dense_case(name)


@contextlib.contextmanager
def unrounded_backward():
    """'bf16''s forward with a backward that rounds nothing: the backward
    Functions' products unrounded (nn/config.grad_rounding), and the casts
    that autograd differentiates passing the cotangent through as it is."""
    rounded = config.round_operand

    def straight_through(x, rounding):
        if rounding is None:
            return x
        return x + (rounded(x.detach(), rounding) - x.detach())

    mp = pytest.MonkeyPatch()
    mp.setattr(config, "grad_rounding", lambda rounding: (None, None))
    mp.setattr(config, "round_operand", straight_through)
    try:
        yield
    finally:
        mp.undo()


@pytest.mark.parametrize("name", LAYERS)
def test_layer_vjp_matches_jax_bf16(name):
    """Each layer's VJP in 'bf16' against jax.vjp under the JAX package's
    'bf16': every gradient within the layer's LAYER_RTOL relative L2; a
    backward that rounds nothing lands outside it in every gradient that
    a rounded product reaches (all but a dense layer's bias); 'bf16' moves
    the gradients from 'highest''s."""
    port, _, jfn, arrays, cot = layer_case(name)
    want = jax_vjp(jfn, arrays, cot)
    with config.precision("bf16"):
        got = torch_vjp(port, arrays, cot)
        with unrounded_backward():
            unrounded = torch_vjp(port, arrays, cot)
    exact = torch_vjp(port, arrays, cot)
    rtol = LAYER_RTOL[name]
    for i, (g, u, w) in enumerate(zip(got, unrounded, want)):
        assert rel_l2(g, w) <= rtol, (name, i, rel_l2(g, w))
        if name in DENSE and dense_bias(name, i):
            continue
        assert rel_l2(u, w) > rtol, (name, i, rel_l2(u, w))
    assert max(rel_l2(g, e) for g, e in zip(got, exact)) > 1e-3  # bf16 is live


def dense_bias(name: str, i: int) -> bool:
    """Is a dense layer's i-th argument its bias (whose gradient is a sum
    of the cotangent, no product)?"""
    return i == (4 if name == "feedforward2_tanh" else 2)


@pytest.mark.parametrize("name", ("gru", "gru_reverse", "lstm_pair"))
def test_layer_backward_is_the_twins_autograd(name):
    """The recurrent layers' backward Functions (Project, GruRecurrence,
    LstmPair: the walks' twins and the per-step weight gradients) in
    float64 against torch.autograd through the rounded twins in float64:
    within EXACT_RTOL, in 'bf16' and in 'highest'."""
    port, twin, _, arrays, cot = layer_case(name)
    got = {}
    for mode in ("bf16", "highest"):
        with config.precision(mode):
            got[mode] = torch_vjp(port, arrays, cot, torch.float64)
            want = torch_vjp(twin, arrays, cot, torch.float64)
        for i, (g, w) in enumerate(zip(got[mode], want)):
            assert rel_l2(g, w) <= EXACT_RTOL, (name, mode, i, rel_l2(g, w))
    assert max(rel_l2(b, e) for b, e in zip(*got.values())) > 1e-3  # bf16 is live


@pytest.mark.parametrize("layer", ["gru", "gru_reverse", "lstm_pair"])
def test_weight_gradient_is_rounded_a_step(layer):
    """At T = 2 one step adds to the recurrent weights' gradient (h is 0
    before the first), so in 'bf16' it is a bfloat16 value; at T = 3 two
    rounded steps are summed in fp32, which no longer is, and the GRU's
    matches JAX's within STEP_RTOL."""
    recurrent = (3, 4) if layer.startswith("gru") else (3, 7)
    for T in (2, 3):
        if layer == "lstm_pair":
            port, _, jfn, arrays, cot = lstm_case(T=T)
        else:
            port, _, jfn, arrays, cot = gru_case(layer == "gru_reverse", T=T)
        with config.precision("bf16"):
            got = torch_vjp(port, arrays, cot)
        exact = torch_vjp(port, arrays, cot)
        for i in recurrent:
            assert is_bf16(got[i]) == (T == 2), (layer, T, i)
            assert not np.array_equal(got[i], exact[i])  # bf16 is live
        if T == 3 and layer != "lstm_pair":
            want = jax_vjp(jfn, arrays, cot)
            for i in recurrent:
                assert rel_l2(got[i], want[i]) <= STEP_RTOL, (layer, i)


@pytest.mark.parametrize("kind,reverse", [("gru", False), ("gru", True),
                                          ("lstm", False), ("lstm", True)])
def test_walk_twin_is_the_vjp_of_the_rounded_twin(kind, reverse):
    """gru_walk_plain and lstm_walk_plain with the 'bf16' rounding (the
    carry's product rounded a step) give the gradient of the recurrence's
    projected input that torch.autograd gives through nn/rnn.gru_tm or
    lstm_tm with that rounding, in float64; without it they do not."""
    rng = np.random.default_rng(11 + reverse)
    T, B, S = 25, 3, 12
    d = lambda *s, sc=1.0: torch.tensor(sc * rng.standard_normal(s), dtype=torch.float64)
    gh = d(T, B, S)
    if kind == "gru":
        x, sW, sW2 = d(T, B, 3 * S), d(S, 2 * S, sc=0.4), d(S, S, sc=0.4)
        leaf = x.clone().requires_grad_(True)
        h = trnn.gru_tm(leaf, sW, sW2, reverse, "bf16")
        h_prev, gates = tg.backward_inputs(x, h.detach(), sW, sW2, reverse, "bf16")
        walk = lambda r: tg.gru_walk_plain(gates, h_prev, gh, sW, sW2, reverse, r)
    else:
        x, sW, peep = d(T, B, 4 * S), d(S, 4 * S, sc=0.4), d(3 * S, sc=0.3)
        leaf = x.clone().requires_grad_(True)
        h = trnn.lstm_tm(leaf, sW, peep, reverse, rounding="bf16")
        _, planes = trnn.lstm_tm(x, sW, peep, reverse, True, "bf16")
        walk = lambda r: tlstm.lstm_walk_plain(planes, gh, sW, peep, reverse, r)[0]
    h.backward(gh)
    assert rel_l2(walk("bf16"), leaf.grad) <= EXACT_RTOL
    assert rel_l2(walk(None), leaf.grad) > 1e-4  # bf16 is live


# ------------------------------------------------------------------ models


def perturbed(model: str, seed: int) -> dict:
    """The in-repo weights plus 0.05 seeded standard-normal noise."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(model).items()}


def model_batch(model: str, seed: int):
    """A short batch drawn once, in 'highest', from the port's simulator
    (the simulator runs squiggle_r94 through its products, so a batch
    drawn under 'bf16' would differ): (sig or event features, labels)."""
    sim = SquiggleSimulator(seed=seed, device="cpu")
    if model == "nanonet_events":
        return sim.detected_events_batch(BATCH, NSAMPLE // 10)
    make = sim.crf_labelled_batch if model == "rnnrf_r94" else sim.labelled_batch
    return make(BATCH, NSAMPLE, STRIDES[model])


def port_value_and_grad(model, params, sig, labels, dtype=torch.float32):
    lfn = tt._loss_for(model)
    loss, grads = tt.value_and_grad_of(
        lambda p, s, lab: lfn(p, s, lab, model),
        {k: torch.tensor(v, dtype=dtype) for k, v in params.items()},
        torch.tensor(sig, dtype=dtype), torch.as_tensor(labels))
    return float(loss), {k: g.numpy() for k, g in grads.items()}


@pytest.mark.parametrize("model", MODELS)
def test_model_backward_is_the_twins_autograd(model):
    """value_and_grad of each model's training loss in 'bf16', in float64:
    the port (its backward Functions) against torch.autograd through the
    rounded twins, the loss and every gradient within EXACT_RTOL; 'bf16'
    moves every model's gradient."""
    params = perturbed(model, seed=3)
    sig, labels = model_batch(model, seed=4)
    with config.precision("bf16"):
        loss, grads = port_value_and_grad(model, params, sig, labels, torch.float64)
        with twin_autograd():
            want_loss, want = port_value_and_grad(model, params, sig, labels,
                                                  torch.float64)
    assert abs(loss - want_loss) <= EXACT_RTOL * abs(want_loss)
    assert set(grads) == set(params)
    for k in sorted(params):
        assert rel_l2(grads[k], want[k]) <= EXACT_RTOL, (k, rel_l2(grads[k], want[k]))
    _, exact = port_value_and_grad(model, params, sig, labels, torch.float64)
    assert max(rel_l2(grads[k], exact[k]) for k in params) > 1e-3  # live


@pytest.mark.parametrize("model", MODELS)
def test_model_value_and_grad_matches_jax_bf16(model):
    """value_and_grad of each model's training loss in 'bf16' (float32, the
    port's CPU path) against jax.value_and_grad of loss_fn / crf_loss_fn
    under the JAX package's 'bf16', on the same batch and weights: the
    loss within MODEL_LOSS_RTOL, each gradient within MODEL_GRAD_RTOL
    relative L2 (the module's doc: the bfloat16 roundings of two summation
    orders part within a few steps), the whole gradient nearer JAX's than
    'highest''s is."""
    params = perturbed(model, seed=3)
    sig, labels = model_batch(model, seed=4)
    lfn = jt.crf_loss_fn if model == "rnnrf_r94" else jt.loss_fn
    with jconfig.precision("bf16"):
        want_loss, want = jax.value_and_grad(lfn)(
            {k: jnp.asarray(v) for k, v in params.items()}, sig, labels, model)
    with config.precision("bf16"):
        loss, grads = port_value_and_grad(model, params, sig, labels)
    assert abs(loss - float(want_loss)) <= MODEL_LOSS_RTOL * abs(float(want_loss))
    for k in sorted(params):
        assert rel_l2(grads[k], want[k]) <= MODEL_GRAD_RTOL, (k, rel_l2(grads[k], want[k]))
    _, exact = port_value_and_grad(model, params, sig, labels)
    assert max(rel_l2(grads[k], exact[k]) for k in params) > 1e-3  # live
    # and the whole gradient lies nearer JAX's 'bf16' one than 'highest''s
    # does (seen 2.4 to 3.8 times nearer)
    flat = lambda g: np.concatenate([np.ravel(g[k]) for k in sorted(params)])
    assert rel_l2(flat(grads), flat(want)) < rel_l2(flat(exact), flat(want))


def lattice_case(model: str):
    """(loss of the port, of JAX, params, x, seq): the lattice window
    loss of rgrgr_r94 and rnnrf_r94 on a short seq_batch window, the
    whole-read losses of rgrgr_r94 (transducer) and rnnrf_r94 (CRF) on a
    region of 64 blocks, chunk 16."""
    kind, name = model.split(":")
    params = perturbed(name, seed=40)
    stride = STRIDES[name]
    sim = SquiggleSimulator(seed=41, device="cpu")
    if kind == "lattice":
        sig, seq = sim.seq_batch(BATCH, NSAMPLE, NSAMPLE // stride)
        if name == "rnnrf_r94":
            seq = np.where(seq >= 0, seq % 4, -1)
            return (lambda p, s, q: tlat.crf_lattice_loss_fn(p, s, q, name),
                    lambda p, s, q: jlat.crf_lattice_loss_fn(p, s, q, name),
                    params, sig, seq)
        return (lambda p, s, q: tlat.lattice_loss_fn(p, s, q, name),
                lambda p, s, q: jlat.lattice_loss_fn(p, s, q, name), params, sig, seq)
    read = _Read(*sim.simulate_read(120))
    fn = "region_sequence" if name == "rnnrf_r94" else "region_seqstates"
    sig, seq = getattr(twr, fn)(read, 64 * stride, stride, 16)
    x, seq = sig[None, :, None], seq[None]
    if name == "rnnrf_r94":
        return (twr.crf_wholeread_loss(name, chunk=16),
                lambda p, s, q: jwr.crf_wholeread_nll(
                    jt.posterior_fn(name)(p, s), q, 4.0, 16), params, x, seq)
    return (twr.transducer_wholeread_loss(name, chunk=16),
            lambda p, s, q: jwr.transducer_wholeread_nll(
                jt.posterior_fn(name)(p, s), q, 0.0, 4.0, 4.0, 16), params, x, seq)


class _Read:
    """A simulated read as the region functions take it: norm, base_at,
    bases."""

    def __init__(self, sig, bases, base_at):
        self.norm = ((sig - np.median(sig)) / np.std(sig)).astype(np.float32)
        self.bases, self.base_at = bases.astype(np.int64), base_at
        self.name = "sim"


LATTICES = ("lattice:rgrgr_r94", "lattice:rnnrf_r94", "wholeread:rgrgr_r94",
            "wholeread:rnnrf_r94")


@pytest.mark.parametrize("case", LATTICES)
def test_lattice_losses_in_bf16(case):
    """The lattice window losses and the whole-read losses in 'bf16': in
    float64 the port against torch.autograd through the rounded twins
    within EXACT_RTOL; in float32 against jax.value_and_grad under the
    JAX package's 'bf16' within MODEL_LOSS_RTOL and MODEL_GRAD_RTOL, and
    nearer JAX's gradient than 'highest''s is; the gradients moved from
    'highest''s."""
    tfn, jfn, params, x, seq = lattice_case(case)
    seq_t = torch.as_tensor(seq).long()

    def ours(dtype=torch.float32):
        loss, grads = tt.value_and_grad_of(
            tfn, {k: torch.tensor(v, dtype=dtype) for k, v in params.items()},
            torch.tensor(x, dtype=dtype), seq_t)
        return float(loss), {k: g.numpy() for k, g in grads.items()}

    with config.precision("bf16"):
        loss64, grads64 = ours(torch.float64)
        with twin_autograd():
            want64_loss, want64 = ours(torch.float64)
        loss, grads = ours()
    assert abs(loss64 - want64_loss) <= EXACT_RTOL * abs(want64_loss)
    for k in params:
        assert rel_l2(grads64[k], want64[k]) <= EXACT_RTOL, k
    with jconfig.precision("bf16"):
        want_loss, want = jax.value_and_grad(jfn)(
            {k: jnp.asarray(v) for k, v in params.items()}, x, seq)
    assert abs(loss - float(want_loss)) <= MODEL_LOSS_RTOL * abs(float(want_loss))
    for k in params:
        assert rel_l2(grads[k], want[k]) <= MODEL_GRAD_RTOL, (k, rel_l2(grads[k], want[k]))
    _, exact = ours()
    assert max(rel_l2(grads[k], exact[k]) for k in params) > 1e-3  # live
    flat = lambda g: np.concatenate([np.ravel(g[k]) for k in sorted(params)])
    # seen 2.0 to 4.6 times nearer JAX's 'bf16' gradient than 'highest''s
    assert rel_l2(flat(grads), flat(want)) < rel_l2(flat(exact), flat(want))


# ------------------------------------------------------- modes and steps


@pytest.mark.parametrize("model", MODELS)
def test_default_training_equals_highest_on_the_cpu(model):
    """'default' is plain fp32 on the CPU: one train step's loss and the
    parameters after it equal 'highest''s bit for bit."""
    params = perturbed(model, seed=5)
    batch = model_batch(model, seed=6)
    out = {}
    for mode in ("highest", "default"):
        with config.precision(mode):
            out[mode] = tt.train(model, steps=1, batch=BATCH, nsample=NSAMPLE,
                                 params=params, log_every=0, device="cpu",
                                 simulator=_Replay([batch]))
    assert out["default"][1] == out["highest"][1]
    for k, v in out["highest"][0].items():
        np.testing.assert_array_equal(out["default"][0][k], v)


class _Replay:
    """A simulator that hands out given batches in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def labelled_batch(self, *_):
        return self.batches.pop(0)

    crf_labelled_batch = detected_events_batch = labelled_batch


@pytest.mark.parametrize("model", ["rgrgr_r94", "nanonet_events"])
def test_train_on_a_mesh_in_bf16_matches_one_device(model):
    """train(mesh=) under 'bf16' on a (2, 2) CPU mesh (the output layer
    split over 'state') against one device: the first step's gradient,
    each leaf within MESH_GRAD_RTOL relative L2 of one device's 'bf16'
    gradient and the whole MESH_NEARER times nearer it than one device's
    'highest' gradient (the module's doc); three steps' losses within
    MODEL_LOSS_RTOL; the losses are not 'highest''s."""
    params = perturbed(model, seed=7)
    data = [model_batch(model, seed=8 + i) for i in range(3)]
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    kw = dict(steps=3, batch=BATCH, nsample=NSAMPLE, lr=1e-3, params=params,
              log_every=0)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    with config.precision("bf16"):
        _, grads = tt.value_and_grad_on_mesh(model, tensors, mesh, *data[0])
        _, one_grads = port_value_and_grad(model, params, *data[0])
        _, one = tt.train(model, simulator=_Replay(data), device="cpu", **kw)
        _, losses = tt.train(model, simulator=_Replay(data), mesh=mesh, **kw)
    _, highest_grads = port_value_and_grad(model, params, *data[0])
    _, exact = tt.train(model, simulator=_Replay(data), device="cpu", **kw)
    grads = {k: g.numpy() for k, g in grads.items()}
    assert set(grads) == set(one_grads)
    for k in sorted(grads):
        assert rel_l2(grads[k], one_grads[k]) <= MESH_GRAD_RTOL, (k, rel_l2(grads[k], one_grads[k]))
    flat = lambda g: np.concatenate([np.ravel(g[k]) for k in sorted(params)])
    assert (MESH_NEARER * rel_l2(flat(grads), flat(one_grads))
            <= rel_l2(flat(grads), flat(highest_grads)))
    np.testing.assert_allclose(losses, one, rtol=MODEL_LOSS_RTOL)
    assert one != exact  # bf16 is live


@pytest.mark.parametrize("mode", ["default", "bf16"])
def test_training_runs_in_every_mode(mode):
    """Every training entry point runs under 'default' and 'bf16' (they
    raised NotImplementedError before): train, make_train_step,
    value_and_grad_of, make_lattice_train_step and the whole-read steps,
    each loss finite."""
    params = perturbed("rnnrf_r94", seed=9)
    sim = SquiggleSimulator(seed=10, device="cpu")
    with config.precision(mode):
        _, losses = tt.train("rgrgr_r94", steps=2, batch=1, nsample=NSAMPLE,
                             log_every=0, device="cpu")
        assert np.isfinite(losses).all()
        opt = lambda: FiniteClippedAdam({k: torch.tensor(v) for k, v in params.items()},
                                        1e-3)
        sig, labels = sim.crf_labelled_batch(1, NSAMPLE, 2)
        assert np.isfinite(float(tt.make_train_step("rnnrf_r94", opt())(sig, labels)))
        sig, seq = sim.seq_batch(1, NSAMPLE, NSAMPLE // 2)
        assert np.isfinite(float(tlat.make_lattice_train_step("rnnrf_r94", opt())(sig, seq)))
        read = _Read(*sim.simulate_read(120))
        sig, bases = twr.region_sequence(read, 64 * 2, 2, 16)
        step = twr.make_wholeread_step("rnnrf_r94", opt(), chunk=16)
        assert np.isfinite(float(step(sig[None, :, None], bases[None])))
        loss, grads = tt.value_and_grad_of(lambda p, x: (p["w"] * x).sum(),
                                           {"w": torch.ones(2)}, torch.ones(2))
        assert float(loss) == 2.0 and torch.equal(grads["w"], torch.ones(2))
