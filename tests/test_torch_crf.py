"""The port's CRF twins (which the CPU runs in place of csrc/crf.cu)
against the JAX package: the lax.scan program decode/crf._crf_viterbi, the
Pallas kernels of ops/crf.py in interpret mode, and
nn.layers.crf_partition_function.

The Viterbi DP only adds and takes maxima, in the same order and with the
same tie rule (first maximum over `from`), so tracebacks, finals, paths and
scores must be identical. The partition function takes logsumexp over five
terms, whose sum the two libraries may take in another order: it is held to
1e-6. The posterior is the exponential of a difference of two such sums,
each of order T times the transitions, so its probabilities carry their
absolute error: they are held to an absolute 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.decode import crf as tdec
from scrappie_torch.nn import layers as tl
from scrappie_torch.ops import crf as tc
from scrappie_torch.parallel import runner
from scrappie_tpu import ops as jops
from scrappie_tpu.decode import crf as jdec
from scrappie_tpu.nn import layers as jl
from scrappie_tpu.ops import crf as jc

torch.set_num_threads(1)
LSE_TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(1, 1), (3, 1), (5, 17), (2, 40), (9, 33)]
IDS = [f"B{b}-T{t}" for b, t in SHAPES]


@pytest.fixture(autouse=True)
def _jax_scan_reference():
    # The JAX scan programs must not dispatch to Pallas themselves.
    with jops.pallas(False):
        yield


def _trans(B, T, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # a few integer levels: equal candidates at almost every step, so
        # the strict-`>` first-max rule decides most moves
        return rng.integers(-3, 1, (B, T, 25)).astype(np.float32)
    return (2.0 * rng.standard_normal((B, T, 25))).astype(np.float32)


def _tm(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 1, 0)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_and_backtrace_match_scan(shape, ties):
    B, T = shape
    tr = _trans(B, T, seed=B * 100 + T, ties=ties)
    jscore, jpath = jdec._crf_viterbi(jnp.asarray(tr))
    score, path = tc.crf_viterbi_tm(_tm(tr))
    assert path.dtype == torch.int32 and path.shape == (B, T + 1)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    kscore, kpath = tc.crf_viterbi_kernel(torch.from_numpy(tr))
    assert torch.equal(kpath, path) and torch.equal(kscore, score)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_and_backtrace_match_pallas(shape, ties):
    B, T = shape
    tr = _trans(B, T, seed=B * 200 + T, ties=ties)
    # the JAX kernel's layout: [T, 32, B], transitions and batch padded
    jt = jnp.pad(jnp.moveaxis(jnp.asarray(tr), 0, 2),
                 ((0, 0), (0, jc.TR - 25), (0, 128 - B)))
    jfinal, jtb = jc.crf_viterbi_scores_tm(jt, interpret=True)
    jscore, jpath = jc.crf_backtrace_tm(jfinal, jtb, interpret=True)
    ops.reset_launches()
    final, tb = tc.crf_viterbi_scores_tm(_tm(tr))
    score, path = tc.crf_backtrace_tm(final, tb)
    assert ops.LAUNCHES["crf_fwd"] == ops.LAUNCHES["crf_backtrace"] == 0
    assert tb.dtype == torch.int8 and tb.shape == (T, 5, B)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb)[:, :5, :B])
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal)[:5, :B].T)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath)[:B])
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore)[:B])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_partition_matches_jax(shape, ties):
    B, T = shape
    tr = _trans(B, T, seed=B * 300 + T, ties=ties)
    ref = np.asarray(jl.crf_partition_function(jnp.asarray(tr)))
    ops.reset_launches()
    logz = tc.crf_partition_tm(_tm(tr))
    assert ops.LAUNCHES["crf_partition"] == 0
    np.testing.assert_allclose(logz.numpy(), ref, **LSE_TOL)
    np.testing.assert_allclose(tl.crf_partition_function(torch.from_numpy(tr[0])),
                               ref[0], **LSE_TOL)


def _stitch_padded(B, T, npad, seed, ties=False):
    """Seeded transitions whose last npad blocks are the stitch's neutral
    padding: -1e30 into the emitting states, 0 into blank (the block that
    parallel/runner._gather_decode_crf appends)."""
    pad = np.full((B, npad, 25), -1e30, dtype=np.float32)
    pad[..., 20:] = 0.0
    return np.concatenate([_trans(B, T - npad, seed, ties=ties), pad], axis=1)


@pytest.mark.parametrize("ties", [False, True])
def test_twins_match_jax_on_stitch_padding(ties):
    B, T, npad = 2, 1500, 300
    tr = _stitch_padded(B, T, npad, seed=11, ties=ties)
    jscore, jpath = jdec._crf_viterbi(jnp.asarray(tr))
    score, path = tc.crf_viterbi_tm(_tm(tr))
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    # the pad blocks emit nothing: the path stays in blank through them
    assert (path.numpy()[:, T - npad + 1:] == 4).all()
    ref = np.asarray(jl.crf_partition_function(jnp.asarray(tr)))
    np.testing.assert_allclose(tc.crf_partition_tm(_tm(tr)).numpy(), ref, **LSE_TOL)


@pytest.mark.parametrize("ties", [False, True])
def test_forward_matches_pallas_on_stitch_padding(ties):
    # shorter than the scan test: the interpreted kernel takes tens of
    # milliseconds a step
    B, T, npad = 2, 100, 30
    tr = _stitch_padded(B, T, npad, seed=12, ties=ties)
    jt = jnp.pad(jnp.moveaxis(jnp.asarray(tr), 0, 2),
                 ((0, 0), (0, jc.TR - 25), (0, 128 - B)))
    jfinal, jtb = jc.crf_viterbi_scores_tm(jt, interpret=True)
    final, tb = tc.crf_viterbi_scores_tm(_tm(tr))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb)[:, :5, :B])
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal)[:5, :B].T)


def test_globalnorm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (3, 21, 96)).astype(np.float32)
    W = (0.3 * rng.standard_normal((96, 25))).astype(np.float32)
    b = rng.standard_normal(25).astype(np.float32)
    ref = np.asarray(jl.globalnorm(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b)))
    args = [torch.from_numpy(a) for a in (W, b)]
    out = tl.globalnorm(torch.from_numpy(x), *args)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    out1 = tl.globalnorm(torch.from_numpy(x[1]), *args)
    np.testing.assert_allclose(out1.numpy(), ref[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("emit_bias", [0.0, -1.0, 0.7])
@pytest.mark.parametrize("ties", [False, True])
def test_decode_crf_matches_jax(emit_bias, ties):
    tr = _trans(4, 23, seed=7, ties=ties)
    jscore, jpath = jdec.decode_crf(tr, emit_bias=emit_bias)
    score, path = tdec.decode_crf(tr, emit_bias=emit_bias, device="cpu")
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_array_equal(score, jscore)
    s1, p1 = tdec.decode_crf(tr[2], emit_bias=emit_bias, device="cpu")
    js1, jp1 = jdec.decode_crf(tr[2], emit_bias=emit_bias)
    np.testing.assert_array_equal(p1, jp1)
    assert isinstance(s1, float) and s1 == js1


def test_emit_bias_moves_only_transitions_into_emitting_states():
    tr = torch.from_numpy(_trans(2, 5, seed=8))
    out = tc.add_emit_bias(tr, -1.5)
    assert torch.equal(out[..., :20], tr[..., :20] + np.float32(-1.5))
    assert torch.equal(out[..., 20:], tr[..., 20:])
    assert tc.add_emit_bias(tr, 0.0) is tr


ASSOC_SHAPES = [(1, 1), (3, 2), (3, 7), (3, 40), (2, 129)]


@pytest.mark.parametrize("emit_bias", [0.0, -0.5])
@pytest.mark.parametrize("shape", ASSOC_SHAPES,
                         ids=[f"B{b}-T{t}" for b, t in ASSOC_SHAPES])
def test_decode_crf_assoc_matches_jax_assoc_and_the_scan(shape, emit_bias):
    """impl="assoc" (max-plus prefix products in JAX's combining order)
    against JAX's impl="assoc" and against the port's sequential scan, at
    tests/test_ops.py's tolerances: scores rtol 1e-5, paths equal (seeded
    inputs without ties)."""
    tr = _trans(*shape, seed=9 + shape[1])
    score, path = tdec.decode_crf(tr, impl="assoc", emit_bias=emit_bias,
                                  device="cpu")
    jscore, jpath = jdec.decode_crf(tr, impl="assoc", emit_bias=emit_bias)
    sscore, spath = tdec.decode_crf(tr, impl="scan", emit_bias=emit_bias,
                                    device="cpu")
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_array_equal(path, spath)
    np.testing.assert_allclose(score, jscore, rtol=1e-5)
    np.testing.assert_allclose(score, sscore, rtol=1e-5)
    s1, p1 = tdec.decode_crf(tr[0], impl="assoc", emit_bias=emit_bias,
                             device="cpu")
    np.testing.assert_array_equal(p1, path[0])
    assert isinstance(s1, float)


@pytest.mark.parametrize("shape", ASSOC_SHAPES,
                         ids=[f"B{b}-T{t}" for b, t in ASSOC_SHAPES])
def test_posterior_crf_assoc_matches_jax_assoc_and_the_scan(shape):
    """posterior_crf(impl="assoc") (logsumexp prefix and suffix products)
    against JAX's impl="assoc" and the port's sequential forward-backward,
    rtol 1e-4 / atol 1e-6 (tests/test_ops.py)."""
    tr = _trans(*shape, seed=30 + shape[1])
    post = tdec.posterior_crf(tr, impl="assoc", device="cpu")
    np.testing.assert_allclose(post, jdec.posterior_crf(tr, impl="assoc"),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(post, tdec.posterior_crf(tr, device="cpu"),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tdec.posterior_crf(tr[0], impl="assoc",
                                                  device="cpu"), post[0])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_associative_scan_combines_in_jax_order(n):
    """The scan of a non-commutative associative product (small integer
    matrices, exact in float64) gives every prefix, forwards and from the
    end; float32 additions come out equal to jax.lax.associative_scan's bit
    for bit, so the elements are combined in JAX's order."""
    import jax

    rng = np.random.default_rng(n)
    m = torch.from_numpy(rng.integers(-2, 3, (n, 2, 2)).astype(np.float64))
    got = tdec.associative_scan(lambda a, b: b @ a, m)
    want = [m[0]]
    for t in range(1, n):
        want.append(m[t] @ want[-1])
    assert torch.equal(got, torch.stack(want))
    rgot = tdec.associative_scan(lambda b, a: b @ a, m, reverse=True)
    rwant = [m[n - 1]]
    for t in range(n - 2, -1, -1):
        rwant.insert(0, rwant[0] @ m[t])
    assert torch.equal(rgot, torch.stack(rwant))
    x = rng.standard_normal(n).astype(np.float32)
    for reverse in (False, True):
        got = tdec.associative_scan(torch.add, torch.from_numpy(x), reverse)
        ref = jax.lax.associative_scan(jnp.add, jnp.asarray(x), reverse=reverse)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("batched", [False, True])
def test_posterior_crf_matches_jax(batched):
    tr = _trans(3, 19, seed=10)
    tr = tr if batched else tr[1]
    ref = jdec.posterior_crf(tr)
    post = tdec.posterior_crf(tr, device="cpu")
    assert post.shape == ref.shape
    np.testing.assert_allclose(post, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(post.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("npos", [None, 6])
def test_crfpath_to_basecall_matches_jax(npos):
    path = np.array([4, 0, 0, 4, 3, 1, 4, 4, 2, 2, 0], dtype=np.int32)
    pos = np.zeros(len(path), dtype=np.int64)
    jpos = np.zeros(len(path), dtype=np.int64)
    seq = tdec.crfpath_to_basecall(path, pos, npos)
    assert seq == jdec.crfpath_to_basecall(path, jpos, npos)
    np.testing.assert_array_equal(pos, jpos)
    assert tdec.crfpath_to_basecall(path) == "AATCGG"


def test_wrappers_check_the_transition_width():
    with pytest.raises(ValueError, match="25"):
        tc.crf_viterbi_scores_tm(torch.zeros((4, 2, 24)))
    with pytest.raises(ValueError, match="25"):
        tc.crf_partition_tm(torch.zeros((4, 2, 5, 5)))


@pytest.mark.parametrize("T", [1, 7, 40])
@pytest.mark.parametrize("which", ["constant", "identity"])
def test_backtrace_twin_matches_pallas_on_hand_built_maps(which, T):
    # the tracebacks chip_smoke.py also feeds the kernel: every byte 0 (a
    # constant map) and tb[t, s, b] = s (the identity)
    B = 3
    final = np.random.default_rng(T).standard_normal((B, 5)).astype(np.float32)
    if which == "constant":
        tb = np.zeros((T, 5, B), dtype=np.int8)
    else:
        tb = np.ascontiguousarray(np.broadcast_to(
            np.arange(5, dtype=np.int8)[None, :, None], (T, 5, B)))
    score, path = tc.crf_backtrace_tm_plain(torch.from_numpy(final),
                                            torch.from_numpy(tb))
    # the JAX kernel's layout: final [8, B], tb [T, 8, B], B lane-padded
    jf = np.zeros((jc.ROWS, 128), dtype=np.float32)
    jf[:5, :B] = final.T
    jtb = np.zeros((T, jc.ROWS, 128), dtype=np.int8)
    jtb[:, :5, :B] = tb
    jscore, jpath = jc.crf_backtrace_tm(jnp.asarray(jf), jnp.asarray(jtb),
                                        interpret=True)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath)[:B])
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore)[:B])
    first = final.argmax(1)
    expect = (np.zeros((B, T + 1), np.int32) if which == "constant"
              else np.repeat(first[:, None], T + 1, 1))
    expect[:, T] = first
    np.testing.assert_array_equal(path.numpy(), expect)


FWDBWD_CASES = [(B, T) for B in (1, 5) for T in (1, 7, 300)]
FWDBWD_IDS = [f"B{b}-T{t}" for b, t in FWDBWD_CASES]


def _jax64(fn, *arrays):
    """fn of the JAX package run in float64 on float32 data, as numpy. Its
    float32 scans carry unnormalised scores of order T |trans|, whose
    rounding moves a probability by up to 3.5e-5 at T = 300 (2 x standard
    normal transitions); the twins' max-normalised scores stay within
    2.2e-7 of float64 there."""
    import jax

    with jax.enable_x64(True):
        return np.asarray(fn(*(jnp.asarray(a, dtype=jnp.float64)
                               for a in arrays)))


@pytest.mark.parametrize("B,T", FWDBWD_CASES, ids=FWDBWD_IDS)
def test_walks_and_state_marginals_match_jax(B, T):
    """The twins of the forward-backward's passes, as the kernels split
    them: the two walks' scores (crf_fwdbwd_plain: each boundary's scores
    less their maximum, 0 at both ends) and the posterior's marginal pass
    on them, against scrappie_tpu.decode.crf._crf_posterior (absolute
    1e-5; the reference in float64, _jax64)."""
    tr = _trans(B, T, seed=7 * T + B)
    a, b = tc.crf_fwdbwd_plain(_tm(tr))
    assert a.shape == b.shape == (T + 1, B, 5)
    assert torch.equal(a.amax(-1), torch.zeros(T + 1, B))
    assert torch.equal(b.amax(-1), torch.zeros(T + 1, B))
    assert torch.equal(a[0], torch.zeros(B, 5))
    assert torch.equal(b[T], torch.zeros(B, 5))
    post = tc.crf_state_marginals_plain(a, b)
    want = _jax64(jdec._crf_posterior, tr)
    np.testing.assert_allclose(post.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,T", FWDBWD_CASES, ids=FWDBWD_IDS)
def test_walks_and_edge_marginals_match_jax_grad(B, T):
    """The gradient's marginal pass on the walks' scores (each block's 25
    edge marginals, one softmax, times g) against jax.grad of
    nn.layers.crf_partition_function on <logZ, g> (absolute 1e-5 times the
    largest |g|; the reference in float64, _jax64)."""
    import jax

    tr = _trans(B, T, seed=11 * T + B)
    g = np.random.default_rng(T + B).standard_normal(B).astype(np.float32)
    want = _jax64(jax.grad(lambda t, w: (jl.crf_partition_function(t) * w).sum()),
                  tr, g)
    got = tc.crf_edge_marginals_plain(_tm(tr), *tc.crf_fwdbwd_plain(_tm(tr)),
                                      torch.from_numpy(g))
    assert got.shape == (T, B, 25)
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5 * max(1.0, np.abs(g).max()))


def _spy_posterior(monkeypatch) -> list:
    """The shapes of the posterior wrapper's CPU calls, as a list that
    fills as they come."""
    shapes = []
    real = tc.crf_posterior_tm_plain

    def spy(trans_tm):
        shapes.append(tuple(trans_tm.shape))
        return real(trans_tm)
    monkeypatch.setattr(tc, "crf_posterior_tm_plain", spy)
    return shapes


def test_posterior_crf_batch_equals_one_read_calls(monkeypatch):
    """parallel/runner.posterior_crf_batch, the engine's call for all the
    reads of an rnnrf engine call with qualities, on three reads of different
    lengths: in the launches of crf_groups ([300, 2, 25] for the reads of
    300 and 7 blocks, [1, 1, 25] for the read of 1) and, through
    posterior_crf_padded, in one ([300, 3, 25]), each read padded to the
    longest with stitch pad blocks. Each read's rows equal its own
    posterior_crf call exactly and JAX's posterior within 1e-5 (in
    float64, _jax64)."""
    reads = [_trans(1, T, seed=40 + T)[0] for T in (7, 300, 1)]
    shapes = _spy_posterior(monkeypatch)
    batch = runner.posterior_crf_batch(reads, device="cpu")
    assert shapes == [(300, 2, 25), (1, 1, 25)]
    shapes.clear()
    padded = runner.posterior_crf_padded(reads, device="cpu")
    assert shapes == [(300, 3, 25)]
    for r, post, one in zip(reads, batch, padded):
        assert post.shape == (len(r) + 1, 5)
        np.testing.assert_array_equal(post, tdec.posterior_crf(r, device="cpu"))
        np.testing.assert_array_equal(one, post)
        np.testing.assert_allclose(post, _jax64(jdec._crf_posterior, r[None])[0],
                                   rtol=0, atol=1e-5)
    assert runner.posterior_crf_batch([], device="cpu") == []


def test_posterior_crf_batch_bounds_its_padding(monkeypatch):
    """One long read among many short ones: the launches of crf_groups hold
    at most CRF_PAD_RATIO times the reads' blocks (the long read does not
    pad the short ones to its length), each launch is its longest read by
    its reads, every read is in one launch, and each read's rows still
    equal its own posterior_crf call exactly."""
    lengths = [12, 9, 600] + [5 + i % 11 for i in range(30)] + [1]
    reads = [_trans(1, T, seed=70 + i)[0] for i, T in enumerate(lengths)]
    groups = runner.crf_groups(lengths)
    assert sorted(i for g in groups for i in g) == list(range(len(lengths)))
    assert groups[0][0] == 2 and len(groups) < len(lengths)
    shapes = _spy_posterior(monkeypatch)
    batch = runner.posterior_crf_batch(reads, device="cpu")
    assert shapes == [(lengths[g[0]], len(g), 25) for g in groups]
    assert all(T == max(lengths[i] for i in g) for (T, _, _), g in
               zip(shapes, groups))
    assert (sum(T * B for T, B, _ in shapes)
            <= runner.CRF_PAD_RATIO * sum(lengths))
    for r, post in zip(reads, batch):
        np.testing.assert_array_equal(post, tdec.posterior_crf(r, device="cpu"))
    assert runner.crf_groups([]) == []
    assert runner.crf_groups([7, 7, 7]) == [[0, 1, 2]]
