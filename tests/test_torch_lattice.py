"""The lattice losses on the CPU: the port's forward-backward twins
(ops/lattice.py, the plain versions of csrc/lattice.cu's kernels), its
losses and its lattice train step against the JAX package
(scrappie_tpu/train/lattice.py) on the same seeded inputs.

The JAX references run under jops.pallas(False), as the JAX trainer runs
them. JAX's transducer lattice cannot take L = 1 (its skip move's
concatenation changes the carry's shape); the port takes it, and is held
there to JAX's L = 2 with the second position padded, the same lattice.

Tolerances, and why:
  * log P and logZ_local: 1e-5 relative (seen at most 1.1e-7). The port
    normalises each step and sums the maxima in float64, JAX carries the
    raw float32 scores.
  * d/dlogpost and d/dtrans: 5e-5 relative to the largest entry against
    jax.grad (seen at most 1.7e-5, the transducer). The port's gradient is
    a sum of edge posteriors exp(alpha_hat + weight + beta_tilde - m) with
    every term of order 1, added into kmer states in another order; JAX
    differentiates its scan step by step through scores of the order of
    log P, whose float32 rounding is the larger error. Against the same
    twins in float64 the port's float32 gradients stay within 5e-5 at
    T = 300 (seen at most 1.4e-5; JAX's 1.2e-4) and 5e-4 at T = 3 000
    (seen at most 1.8e-4, the CRF; JAX's 7.2e-3 and 1.1e-2), and closer
    than JAX's: each step's posteriors are divided by their sum, which
    cancels the drift common to a step.
  * Rows with no sequence: the port's gradient is exactly 0; JAX's
    gradient of the -1e30 sentinel is the chain of 1/2s of
    logaddexp(-1e30, -1e30), which the losses mask, so those rows are held
    to JAX only through the losses.
  * The losses: 1e-5 relative. Every parameter gradient of rgrgr_r94 and
    rnnrf_r94: 5e-4 relative to its largest entry (seen at most 2.3e-4,
    rgrgr's gruB1_iW). The network's gradient is the lattice's posteriors
    through five GRU layers, and rnnrf's is the difference of logZ_local's
    and log P's, which largely cancel; both the port and JAX are up to
    2.3e-4 and 1.5e-4 from the port run in float64.
  * Three lattice train steps: each loss within rtol 5e-5 and the
    parameters within 1e-4 absolute but for at most 1 weight in 1 000 of a
    leaf, rounded up, and none off by more than 2 lr a step
    (tests/test_torch_train.py's rule at 1 in 10 000: Adam's first step
    moves a weight whose gradient is float noise by about lr either way,
    and these gradients agree to 5e-4, not 1e-4; seen 2 of rnnrf's 9 216
    gruB3_sW2 weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.ops import lattice as tl
from scrappie_torch.ops import crf as tc
from scrappie_torch.train import lattice as tlat
from scrappie_torch.train.optim import FiniteClippedAdam
from scrappie_tpu import ops as jops
from scrappie_tpu.models import registry
from scrappie_tpu.models.specs import RAW_MODELS
from scrappie_tpu.train import lattice as jlat
from scrappie_tpu.train.simulate import SquiggleSimulator as JSim

torch.set_num_threads(1)
VALUE_RTOL = 1e-5
GRAD_RTOL = 5e-5
F64_RTOL = 5e-5
F64_LONG_RTOL = 5e-4
LOSS_RTOL = 1e-5
PARAM_GRAD_RTOL = 5e-4
TRAIN_LOSS_RTOL = 5e-5
TRAIN_PARAM_ATOL = 1e-4
TRAIN_PARAM_OUTLIERS = 1e-3
PENS = (0.3, 4.0, 4.0)  # stay, skip, local: a nonzero stay penalty
NSAMPLE, BATCH, LR = 600, 2, 1e-3


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


def logposts(B, T, S, seed):
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal((B, T, S))
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


# Each case: (B, T, L, padding per row (positions kept; None = all), the
# rows' repeated positions (copy of position 1 into position 3)).
CASES = {
    "padded": (3, 30, 9, [None, 5, 0], False),
    "repeated states": (2, 25, 8, [None, 6], True),
    "L=2": (2, 12, 2, [None, 1], False),
    "L=1": (2, 12, 1, [None, 0], False),
    "no sequence": (2, 10, 4, [0, 0], False),
}


def make_case(name, seed, nstate):
    B, T, L, keep, repeat = CASES[name]
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, nstate, size=(B, L)).astype(np.int32)
    for b, k in enumerate(keep):
        if k is not None:
            seq[b, k:] = -1
    if repeat:
        seq[:, 3] = seq[:, 1]
    return B, T, seq


def jax_view(seq):
    """JAX's transducer lattice takes L >= 2: pad an L = 1 input."""
    if seq.shape[1] > 1:
        return seq
    return np.concatenate([seq, np.full_like(seq, -1)], 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transducer_lattice_matches_jax(case):
    """log P and its gradient against lattice_forward_batch and jax.grad,
    on <log P, g> with g zero on the rows without a sequence; those rows'
    gradient is exactly 0."""
    B, T, seq = make_case(case, seed=len(case), nstate=1024)
    lp = logposts(B, T, 1025, seed=len(case) + 1)
    has = (seq >= 0).any(1)
    g = np.where(has, np.random.default_rng(9).standard_normal(B),
                 0.0).astype(np.float32)
    jseq = jax_view(seq)
    want = np.asarray(jlat.lattice_forward_batch(lp, jseq, *PENS))
    want_g = np.asarray(jax.grad(
        lambda x: (jlat.lattice_forward_batch(x, jseq, *PENS) * g).sum())(lp))
    leaf = torch.tensor(lp, requires_grad=True)
    got = tlat.lattice_forward_batch(leaf, torch.tensor(seq), *PENS)
    assert type(got.grad_fn).__name__ == "TransducerLatticeBackward"
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL)
    (got * torch.tensor(g)).sum().backward()
    if has.any():
        assert_rel_close(leaf.grad[has], want_g[has], GRAD_RTOL, "dlogpost")
    assert not leaf.grad[~has].any()
    assert ops.LAUNCHES["lattice_fwdbwd"] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_crf_lattice_matches_jax(case):
    """log P and logZ_local and the gradient of <log P, gP> + <logZ, gZ>
    against crf_lattice_forward_batch, crf_local_partition and jax.grad."""
    B, T, bases = make_case(case, seed=2 * len(case), nstate=4)
    rng = np.random.default_rng(len(case) + 3)
    tr = (2.0 * rng.standard_normal((B, T, 25))).astype(np.float32)
    has = (bases >= 0).any(1)
    gP = np.where(has, rng.standard_normal(B), 0.0).astype(np.float32)
    gZ = rng.standard_normal(B).astype(np.float32)

    def f(t):
        return ((jlat.crf_lattice_forward_batch(t, bases) * gP).sum()
                + (jlat.crf_local_partition(t) * gZ).sum())

    want_p = np.asarray(jlat.crf_lattice_forward_batch(tr, bases))
    want_z = np.asarray(jlat.crf_local_partition(tr))
    want_g = np.asarray(jax.grad(f)(tr))
    leaf = torch.tensor(tr, requires_grad=True)
    logp, logz = tl.crf_lattice_tm(leaf.transpose(0, 1), torch.tensor(bases))
    np.testing.assert_allclose(logp.detach().numpy(), want_p, rtol=VALUE_RTOL)
    np.testing.assert_allclose(logz.detach().numpy(), want_z, rtol=VALUE_RTOL)
    np.testing.assert_allclose(
        tlat.crf_local_partition(torch.tensor(tr)).numpy(), want_z,
        rtol=VALUE_RTOL)
    ((logp * torch.tensor(gP)).sum() + (logz * torch.tensor(gZ)).sum()).backward()
    assert_rel_close(leaf.grad, want_g, GRAD_RTOL, "dtrans")
    assert ops.LAUNCHES["crf_lattice_fwdbwd"] == 0


@pytest.mark.parametrize("B, T, L, rtol", [(2, 300, 60, F64_RTOL),
                                            (1, 3000, 600, F64_LONG_RTOL)])
def test_lattice_gradients_keep_float32_precision(B, T, L, rtol):
    """At T = 300 and 3 000 both twins' float32 gradients stay within rtol
    of the same twins run in float64, and closer to them than JAX's."""
    rng = np.random.default_rng(30)
    lp = logposts(B, T, 1025, seed=31)
    seq = rng.integers(0, 1024, size=(B, L)).astype(np.int32)
    tr = (2.0 * rng.standard_normal((B, T, 25))).astype(np.float32)
    bases = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.tensor(lp, dtype=dtype, requires_grad=True)
        tlat.lattice_forward_batch(x, torch.tensor(seq), *PENS).sum().backward()
        t = torch.tensor(tr, dtype=dtype, requires_grad=True)
        tlat.crf_lattice_nll(t, torch.tensor(bases)).sum().backward()
        grads[dtype] = (x.grad.double().numpy(), t.grad.double().numpy())
    jax_grads = (
        jax.grad(lambda x: jlat.lattice_forward_batch(x, seq, *PENS).sum())(lp),
        jax.grad(lambda t: (jlat.crf_local_partition(t)
                            - jlat.crf_lattice_forward_batch(t, bases)).sum())(tr))
    for i, name in enumerate(("dlogpost", "dtrans")):
        ref = grads[torch.float64][i]
        err = lambda g: float(np.abs(g - ref).max() / np.abs(ref).max())
        assert err(grads[torch.float32][i]) <= rtol, name
        assert err(grads[torch.float32][i]) < err(np.asarray(jax_grads[i])), name


def perturbed(model: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(model).items()}


def seq_batches(model: str, seed: int, n: int = 1) -> list:
    """JAX's simulator's lattice batches, the last row of each without a
    sequence."""
    sim = JSim(seed=seed)
    L = NSAMPLE // RAW_MODELS[model].stride
    out = []
    for _ in range(n):
        sig, seq = sim.seq_batch(BATCH + 1, NSAMPLE, L)
        seq[-1] = -1
        out.append((sig, seq))
    return out


@pytest.mark.parametrize("model", ["rgrgr_r94", "rnnrf_r94"])
def test_lattice_losses_match_jax(model):
    """lattice_loss_fn (rgrgr_r94) or crf_lattice_loss_fn (rnnrf_r94): the
    value and every parameter's gradient against jax.value_and_grad, on a
    batch with a row without a sequence."""
    params = perturbed(model, seed=40)
    (sig, seq), = seq_batches(model, seed=41)
    crf = RAW_MODELS[model].kind == "rnnrf"
    lab = np.where(seq >= 0, seq % 4, -1) if crf else seq
    jfn = jlat.crf_lattice_loss_fn if crf else jlat.lattice_loss_fn
    tfn = tlat.crf_lattice_loss_fn if crf else tlat.lattice_loss_fn
    want_loss, want = jax.value_and_grad(jfn)(
        {k: jnp.asarray(v) for k, v in params.items()}, sig, lab, model)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss = tfn(leaves, torch.tensor(sig), torch.tensor(lab), model)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    for k in sorted(params):
        assert_rel_close(leaves[k].grad, want[k], PARAM_GRAD_RTOL, k)


def optax_optimizer(lr):
    return optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr)),
        max_consecutive_errors=25)


def assert_params_close(got: dict, want: dict, steps: int):
    for k, w in want.items():
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        w = np.asarray(w)
        assert g.shape == w.shape
        off = np.abs(g - w)
        n = int((off > TRAIN_PARAM_ATOL).sum())
        assert n <= np.ceil(TRAIN_PARAM_OUTLIERS * g.size), (k, n, g.size)
        assert off.max() <= 2 * LR * steps, (k, off.max())


@pytest.mark.parametrize("model", ["rgrgr_r94", "rnnrf_r94"])
def test_lattice_train_step_matches_jax(model):
    """Three make_lattice_train_step steps against JAX's from the same
    perturbed weights on the same seq_batch batches: the losses and the
    parameters."""
    params = perturbed(model, seed=50)
    batches = seq_batches(model, seed=51, n=3)
    opt = optax_optimizer(LR)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    jstep = jlat.make_lattice_train_step(model, opt, *PENS)
    ours = FiniteClippedAdam({k: torch.tensor(v) for k, v in params.items()}, LR)
    step = tlat.make_lattice_train_step(model, ours, *PENS)
    want_losses, got_losses = [], []
    for sig, seq in batches:
        jparams, state, loss = jstep(jparams, state, sig, seq)
        want_losses.append(float(loss))
        got_losses.append(float(step(sig, seq)))
    np.testing.assert_allclose(got_losses, want_losses, rtol=TRAIN_LOSS_RTOL)
    assert_params_close(ours.params, jparams, steps=3)


def test_lattice_training_hands_the_kernels_their_layout(monkeypatch):
    """On the card the lattice kernels raise unless their inputs are
    contiguous and of their types; the CPU twins take any layout. So the
    twins here run the kernels' checks first, in a lattice train step of
    each model kind, and each must be reached."""
    seen = set()

    def checked(name, check):
        plain = getattr(tl, name)

        def run(*args):
            check(*args)
            seen.add(name)
            return plain(*args)
        monkeypatch.setattr(tl, name, run)

    checked("lattice_fwd_plain", lambda lp, seq, *_: tl.check_lattice_input(lp, seq))
    checked("lattice_bwd_plain", lambda lp, seq, *_: tl.check_lattice_input(lp, seq))
    checked("crf_fwd_plain", lambda tr, b, *_: tl.check_crf_lattice_input(tr, b))
    checked("crf_bwd_plain", lambda tr, b, *_: tl.check_crf_lattice_input(tr, b))
    checked("partition_fwd_plain", lambda tr, *_: tc.check_trans_input(tr))
    checked("partition_bwd_plain", lambda tr, *_: tc.check_trans_input(tr))
    for model in ("rgrgr_r94", "rnnrf_r94"):
        params = perturbed(model, seed=60)
        (sig, seq), = seq_batches(model, seed=61)
        step = tlat.make_lattice_train_step(
            model, FiniteClippedAdam({k: torch.tensor(v)
                                      for k, v in params.items()}, LR))
        assert np.isfinite(float(step(sig, seq)))
    assert seen == {"lattice_fwd_plain", "lattice_bwd_plain", "crf_fwd_plain",
                    "crf_bwd_plain", "partition_fwd_plain",
                    "partition_bwd_plain"}


def test_lattice_input_checks():
    lp = torch.zeros((4, 2, 9))
    with pytest.raises(ValueError, match="L >= 1"):
        tl.lattice_forward_tm(lp, torch.zeros((2, 0), dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        tl.check_lattice_input(lp, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tl.check_lattice_input(lp.transpose(0, 1).contiguous().transpose(0, 1),
                               torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="L >= 1"):
        tl.crf_lattice_tm(torch.zeros((4, 2, 25)),
                          torch.zeros((2, 0), dtype=torch.int32))
    with pytest.raises(ValueError, match="state 9"):
        tl.lattice_forward_tm(lp, torch.tensor([[1, 9], [0, -1]]))
    with pytest.raises(ValueError, match="state 4"):
        tl.crf_lattice_tm(torch.zeros((4, 2, 25)), torch.tensor([[0, 4]] * 2))


# Chunked checkpoints (ops/lattice.py): T = 40 steps, chunks that divide it
# and chunks whose last piece is ragged, chunk 1 and chunk = T.
CHUNK_T, CHUNKS = 40, (1, 3, 7, 8, 16, 40)


def chunk_inputs(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "transducer":
        x = torch.tensor(logposts(3, CHUNK_T, 65, seed=seed + 1)).transpose(0, 1)
        seq = rng.integers(0, 64, size=(3, 9)).astype(np.int32)
    else:
        x = torch.tensor((2.0 * rng.standard_normal((CHUNK_T, 3, 25)))
                         .astype(np.float32))
        seq = rng.integers(0, 4, size=(3, 9)).astype(np.int32)
    seq[1, 6:] = -1
    seq[2, 3] = seq[2, 1]
    return x.contiguous(), torch.tensor(seq)


def twin_pair(kind: str, x, seq, chunk):
    """(log P, the kept rows, m, the gradient on a seeded gP) of the kind's
    twins at `chunk`."""
    gP = torch.tensor([1.0, -0.5, 2.0])
    if kind == "transducer":
        logp, ckpt, rows, m = tl.lattice_fwd_plain(x, seq, *PENS, chunk)
        grad = tl.lattice_bwd_plain(x, seq, ckpt, rows, m, gP, *PENS)
    else:
        logp, ckpt, rows, m = tl.crf_fwd_plain(x, seq, 4.0, chunk)
        grad = tl.crf_bwd_plain(x, seq, ckpt, rows, m, gP, 4.0)
    return logp, ckpt, rows, m, grad


@pytest.mark.parametrize("kind", ["transducer", "crf"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_twins_equal_unchunked(kind, chunk):
    """The twins at any chunk (the backward recomputing each chunk's rows
    from its checkpoint with the kept maxima) give log P, m and the
    gradient of chunk = T bit for bit, and their checkpoints are the
    unchunked forward's rows."""
    x, seq = chunk_inputs(kind, seed=70)
    logp0, _, rows0, m0, grad0 = twin_pair(kind, x, seq, None)
    logp, ckpt, rows, m, grad = twin_pair(kind, x, seq, chunk)
    C, n = tl.chunking(CHUNK_T, chunk)
    assert (ckpt.shape[1], rows.shape[1]) == (n + 1, C)
    for c in range(n):
        assert torch.equal(ckpt[:, c], rows0[:, c * C]), c
    lo = (n - 1) * C
    assert torch.equal(rows[:, : CHUNK_T - lo], rows0[:, lo:])
    assert torch.equal(logp, logp0)
    assert torch.equal(m, m0)
    assert torch.equal(grad, grad0)


@pytest.mark.parametrize("kind", ["transducer", "crf"])
def test_lattice_functions_save_the_checkpoints(kind):
    """The autograd Functions save, beside their inputs, the checkpoints
    every chunk steps, the last chunk's rows and the maxima (and the CRF's
    partition, 9 floats a step): O(T / chunk + chunk) rows, not T rows."""
    T, L, chunk = 96, 60, 8
    rng = np.random.default_rng(71)
    if kind == "transducer":
        x = torch.tensor(logposts(1, T, 65, seed=72)[0][:, None], requires_grad=True)
        seq = torch.tensor(rng.integers(0, 64, size=(1, L)).astype(np.int32))
        out = tl.lattice_forward_tm(x, seq, *PENS, chunk=chunk)
        R = L + 2
    else:
        x = torch.tensor((2.0 * rng.standard_normal((T, 1, 25))).astype(np.float32),
                         requires_grad=True)
        seq = torch.tensor(rng.integers(0, 4, size=(1, L)).astype(np.int32))
        out = tl.crf_lattice_tm(x, seq, chunk=chunk)[0]
        R = 2 * L + 4
    saved = out.grad_fn.saved_tensors
    kept = sum(t.numel() for t in saved[2:])
    assert kept <= (T // chunk + 1 + chunk) * R + 10 * (T + 1)
    assert kept < T * R / 3
    assert saved[0] is x or torch.equal(saved[0], x)


LATTICE_CAP = tl.MAX_CLUSTER * tl.MAX_THREADS * tl.PPTS[-1]


@pytest.mark.parametrize("npos", [1, 2, 3, 800, 1024, 1025, 1409, 7000, 7001,
                                  14004, LATTICE_CAP, LATTICE_CAP + 1,
                                  70001, 3 * LATTICE_CAP + 5])
def test_lattice_cluster_layout_owns_each_position_once(npos):
    """cluster_layout (pure Python): every position owned once, by CTA c
    in [c per, (c + 1) per) and thread i at c per + i + k threads (k <
    ppt groups); a CTA for each CLUSTER_PER positions (4 at the
    transducer's window, 6 at the CRF's), 16 at a whole read's and above;
    every CTA but the last owns at least two positions (its right
    neighbour's halo); a thread walks more than one run of positions only
    above LATTICE_CAP, and then runs of max(PPTS) on MAX_THREADS threads
    (the kernels' MULTI instances)."""
    lay = tl.cluster_layout(npos)
    assert 1 <= lay.ncta <= tl.MAX_CLUSTER
    assert lay.threads % 32 == 0 and 32 <= lay.threads <= tl.MAX_THREADS
    assert lay.ppt in tl.PPTS and lay.per >= 2
    assert (lay.ncta - 1) * lay.per < npos <= lay.ncta * lay.per
    assert (lay.groups > 1) == (npos > LATTICE_CAP)
    if lay.groups > 1:
        assert (lay.threads, lay.ppt) == (tl.MAX_THREADS, tl.PPTS[-1])
    assert lay.threads * lay.ppt * (lay.groups - 1) < lay.per
    c, i, k = np.meshgrid(np.arange(lay.ncta), np.arange(lay.threads),
                          np.arange(lay.ppt * lay.groups), indexing="ij")
    pos = c * lay.per + i + k * lay.threads
    owned = pos[(pos < np.minimum((c + 1) * lay.per, npos))]
    assert np.array_equal(np.sort(owned), np.arange(npos))
    assert lay.ncta == min(tl.MAX_CLUSTER, -(-npos // tl.CLUSTER_PER))
    if npos >= 7000:
        assert lay.ncta == tl.MAX_CLUSTER


def test_lattice_cluster_layout_limits():
    """The layouts of the windows, a whole read and a row above what one
    run a thread holds; any row of a position or more has one."""
    assert tl.cluster_layout(800) == tl.Layout(4, 200, 224, 1, 1)
    assert tl.cluster_layout(1409) == tl.Layout(6, 235, 256, 1, 1)
    assert tl.cluster_layout(7001) == tl.Layout(16, 438, 448, 1, 1)
    assert tl.cluster_layout(70001) == tl.Layout(16, 4376, 512, 8, 2)
    with pytest.raises(ValueError, match="a position"):
        tl.cluster_layout(0)


def test_gradient_lists_follow_the_sequences():
    """state_lists gives each kmer state's positions in order; class_lists
    each CTA's ee, es and se posteriors of each transition class, in
    order: the kernels' deterministic gradient sums read them."""
    rng = np.random.default_rng(73)
    seq = rng.integers(0, 9, size=(3, 40)).astype(np.int32)
    seq[1, 25:] = -1
    start, pos = tl.state_lists(torch.tensor(seq), 10)
    for b in range(3):
        for s in range(10):
            got = pos[b, start[b, s] : start[b, s + 1]].tolist()
            assert got == np.flatnonzero(seq[b] == s).tolist()
    bases = rng.integers(0, 4, size=(2, 30)).astype(np.int32)
    bases[1, 20:] = -1
    lay = tl.Layout(3, 11, 32, 1, 1)  # three CTAs, the last one part-full
    start, idx = tl.class_lists(torch.tensor(bases), lay)
    for b in range(2):
        want = {}
        for j in range(31):
            if j > 0 and bases[b, j - 1] < 0:
                continue
            bj = bases[b, j - 1] if j >= 1 else 0
            bjm1 = bases[b, j - 2] if j >= 2 else 0
            c, i = divmod(j, lay.per)
            classes = [(2, 20 + bj)] + ([(0, bj * 5 + bjm1), (1, bj * 5 + 4)]
                                        if j >= 1 else [])
            for kind, cls in classes:
                want.setdefault((c, cls), []).append(kind * lay.per + i)
        for c in range(lay.ncta):
            for cls in range(24):
                got = idx[b, c, start[b, c, cls] : start[b, c, cls + 1]].tolist()
                assert got == sorted(want.get((c, cls), [])), (b, c, cls)
