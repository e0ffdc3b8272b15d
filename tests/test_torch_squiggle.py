"""Squiggle prediction and signal-to-squiggle alignment on the CPU: the
port (its plain twins) against the JAX package on the same seeded inputs
and the same in-repo weights, at the published widths (embedding 4 -> 3,
five convolutions of 32 filters with window 9, or 7 for RNA, and the
3-output convolution).

Squiggles are held to rtol = atol = 1e-5 (fp32 convolution sums in another
order; seen: at most 1.2e-4 on dwell values up to 77 after the unit
transform, relative 1.5e-6). The DTW's Viterbi finals and tracebacks are
expected to be identical (the DP only adds and takes maxima in the scan's
order); forward finals are held to rtol 1e-5 and atol 1e-4 (expf/log1pf
in another implementation). Scores end to end: within 1e-4 on the same
squiggle, within the finals' tolerance through the two packages' own
squiggles (seen: 3e-4 on a score of -756); paths identical."""

import contextlib
import io
import re

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from scrappie_torch import api as tapi
from scrappie_torch import ops
from scrappie_torch.cli.main import main as torch_main
from scrappie_torch.decode import dtw as tdtw
from scrappie_torch.models.convert import raw_spec
from scrappie_torch.models.forward import SquiggleModel, load_model
from scrappie_torch.models.forward import squiggle_forward as t_squiggle
from scrappie_torch.nn import layers as tl
from scrappie_torch.ops import dtw as tops
from scrappie_torch.parallel.runner import BasecallEngine
from scrappie_tpu import api as japi
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.decode import dtw as jdtw
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.nn import layers as jl
from scrappie_tpu.ops.dtw import squiggle_match_tm as j_match_tm

torch.set_num_threads(1)
MODELS = ("squiggle_r94", "squiggle_r94_rna", "squiggle_r10")
TOL = dict(rtol=1e-5, atol=1e-5)
FINAL_TOL = dict(rtol=1e-5, atol=1e-4)


def bases(n: int, seed: int) -> str:
    return "".join(np.random.default_rng(seed).choice(list("ACGT"), n))


def dtw_params(npos: int, rng) -> np.ndarray:
    """Untransformed squiggle-like params [npos, 3], as tests/test_ops.py
    draws them."""
    return np.stack([
        rng.standard_normal(npos).astype(np.float32),
        (-0.5 + 0.1 * rng.standard_normal(npos)).astype(np.float32),
        (0.2 * rng.standard_normal(npos)).astype(np.float32),
    ], axis=1)


def simulate(squiggle: np.ndarray, seed: int) -> np.ndarray:
    """A raw read in pA from a rescaled squiggle (current, sd, dwell):
    each base holds round(dwell) samples (at least 1) of current plus
    Gaussian noise of its sd, with 250 samples of open-pore noise at each
    end for the trim."""
    rng = np.random.default_rng(seed)
    n = np.maximum(1, np.rint(squiggle[:, 2])).astype(int)
    level = np.repeat(squiggle[:, 0], n) + rng.normal(0, 1, n.sum()) * np.repeat(
        squiggle[:, 1], n)
    pad = lambda: 150.0 + rng.normal(0.0, 0.3, 250)
    return np.concatenate([pad(), 90.0 + 12.0 * level, pad()]).astype(np.float32)


@pytest.mark.parametrize("shape", [(7,), (3, 11), (0,)])
def test_embedding_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    seq = rng.integers(0, 4, shape).astype(np.int32)
    E = rng.standard_normal((4, 3)).astype(np.float32)
    ref = np.asarray(jl.embedding(jnp.asarray(seq), jnp.asarray(E)))
    out = tl.embedding(torch.from_numpy(seq), torch.from_numpy(E)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("transform", [True, False])
def test_squiggle_forward_matches_jax(model, transform):
    params = registry.load_params(model)
    for i, n in enumerate((50, 123, 200)):
        seq = np.random.default_rng(60 + i).integers(0, 4, n).astype(np.int32)
        ref = np.asarray(jforward.squiggle_forward(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(seq),
            transform_units=transform))
        tparams = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
        out = t_squiggle(tparams, torch.from_numpy(seq),
                         transform_units=transform).numpy()
        assert out.shape == ref.shape == (n, 3)
        np.testing.assert_allclose(out, ref, **TOL)


def test_squiggle_model_loads_the_weights():
    net = load_model("squiggle_r94_rna", "cpu")
    assert isinstance(net, SquiggleModel)
    params = registry.load_params("squiggle_r94_rna")
    assert net.strides == {f"conv{k}_stride": 1 for k in range(1, 7)}
    assert net.params["conv1_W"].shape == (7, 3, 32)
    for k, v in net.params.items():
        np.testing.assert_array_equal(v.numpy(), params[k])
    seq = torch.from_numpy(np.random.default_rng(3).integers(0, 4, 40))
    assert torch.equal(net(seq), t_squiggle({**net.params, **net.strides}, seq))
    with pytest.raises(ValueError, match="squiggle"):
        SquiggleModel.from_registry("rgrgr_r94", "cpu")
    with pytest.raises(ValueError, match="sequence_to_squiggle"):
        raw_spec("squiggle_r94")
    with pytest.raises(ValueError, match="sequence_to_squiggle"):
        BasecallEngine("squiggle_r10", device="cpu")


@pytest.mark.parametrize("model", MODELS)
def test_sequence_to_squiggle_matches_jax(model):
    seq = bases(150, 70).lower()
    for rescale in (False, True):
        ref = japi.sequence_to_squiggle(seq, model=model, rescale=rescale)
        out = tapi.sequence_to_squiggle(seq, model=model, rescale=rescale,
                                        device="cpu")
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(out, ref, **TOL)


def test_sequence_to_squiggle_errors():
    with pytest.raises(ValueError, match="non-ACGT"):
        tapi.sequence_to_squiggle("ACGNT", device="cpu")
    with pytest.raises(KeyError, match="not recognised"):
        tapi.sequence_to_squiggle("ACGT", model="rgrgr_r94", device="cpu")


def _dtw_inputs(npos: int, T: int, prob_back: float, seed: int):
    rng = np.random.default_rng(seed)
    params = dtw_params(npos, rng)
    sig = rng.standard_normal(T).astype(np.float32)
    with np.errstate(divide="ignore"):
        move_pen, stay_pen = jdtw._penalties(params, 1.0, prob_back)
    scales = np.exp(params[:, 1])
    return [np.ascontiguousarray(a) for a in
            (sig, params[:, 0], scales, params[:, 1], move_pen, stay_pen)]


def _tie_inputs(npos: int, T: int, prob_back: float, seed: int):
    """Integer signal and locs, unit scales and one dwell: emissions and
    penalties repeat, so scores and candidates tie everywhere, and the
    first-max rules decide the moves."""
    rng = np.random.default_rng(seed)
    params = np.zeros((npos, 3), np.float32)
    params[:, 0] = rng.integers(-2, 3, npos)
    sig = rng.integers(-2, 3, T).astype(np.float32)
    with np.errstate(divide="ignore"):
        move_pen, stay_pen = jdtw._penalties(params, 1.0, prob_back)
    return [np.ascontiguousarray(a) for a in
            (sig, params[:, 0], np.exp(params[:, 1]), params[:, 1], move_pen,
             stay_pen)]


def _check_dtw_twin(arrays, viterbi, prob_back):
    """The twin's final within FINAL_TOL of the scan's and the Pallas
    kernel's (interpret mode); for Viterbi its moves, through
    moves_to_states, equal to both int32 tracebacks."""
    T, npos = arrays[0].shape[0], arrays[1].shape[0]
    scalars = (prob_back, 2.0, 0.5, 5.0)
    jargs = (*map(jnp.asarray, arrays), *scalars)
    scan_final, scan_tb = jdtw._squiggle_match(*jargs, viterbi)
    pallas_final, pallas_tb = j_match_tm(*jargs, viterbi=viterbi, interpret=True)
    final, moves, end_src = tops.squiggle_match_tm(
        *map(torch.from_numpy, arrays), *scalars, viterbi=viterbi)
    assert final.shape == (2 * npos + 2,)
    for ref in (scan_final, pallas_final):
        np.testing.assert_allclose(final.numpy(), np.asarray(ref), **FINAL_TOL)
    if viterbi:
        assert moves.dtype == torch.uint8 and moves.shape == (T, 2 * npos + 2)
        assert end_src.dtype == torch.int32 and end_src.shape == (T,)
        states = tops.moves_to_states(moves, end_src)
        assert states.dtype == torch.int32
        np.testing.assert_array_equal(states.numpy(), np.asarray(scan_tb))
        np.testing.assert_array_equal(states.numpy(), np.asarray(pallas_tb))
    else:
        assert moves is None and end_src is None


@pytest.mark.parametrize("npos,T", [(20, 37), (15, 40), (60, 400)])
@pytest.mark.parametrize("viterbi", [True, False])
@pytest.mark.parametrize("prob_back", [0.0, 0.1])
def test_dtw_twin_matches_jax(npos, T, viterbi, prob_back):
    _check_dtw_twin(_dtw_inputs(npos, T, prob_back, seed=npos + T), viterbi,
                    prob_back)


@pytest.mark.parametrize("viterbi", [True, False])
@pytest.mark.parametrize("prob_back", [0.0, 0.1])
def test_dtw_twin_matches_jax_on_ties(viterbi, prob_back):
    _check_dtw_twin(_tie_inputs(40, 300, prob_back, seed=41), viterbi, prob_back)


def _walk_states(final: np.ndarray, tb: np.ndarray) -> np.ndarray:
    """The host walk over an int32 state traceback, as scrappie_tpu's
    squiggle_match_viterbi takes it before relabelling."""
    nf = (tb.shape[1] + 2) // 2
    path = np.zeros(tb.shape[0], dtype=np.int32)
    path[-1] = nf - 2 if final[nf - 2] > final[nf - 1] else nf - 1
    for s in range(tb.shape[0] - 1, 0, -1):
        path[s - 1] = tb[s, path[s]]
    return path


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("prob_back", [0.0, 0.1])
def test_dtw_walk_matches_the_walk_over_jax_traceback(ties, prob_back):
    """The walk over (final, moves, end_src) takes the states the walk over
    JAX's int32 traceback takes, sample for sample; relabelled, the path is
    jdtw.squiggle_match_viterbi's."""
    make = _tie_inputs if ties else _dtw_inputs
    arrays = make(50, 500, prob_back, seed=7)
    scalars = (prob_back, 2.0, 0.5, 5.0)
    jfinal, jtb = jdtw._squiggle_match(*map(jnp.asarray, arrays), *scalars, True)
    final, moves, end_src = tops.squiggle_match_tm(
        *map(torch.from_numpy, arrays), *scalars)
    ops.reset_launches()
    path = tops.dtw_walk(final, moves, end_src)
    assert ops.LAUNCHES["dtw_walk"] == 0
    assert path.dtype == torch.int32 and path.shape == (500,)
    want = _walk_states(np.asarray(jfinal), np.asarray(jtb))
    np.testing.assert_array_equal(path.numpy(), want)
    assert len(np.unique(want)) > 20  # the path moves along the squiggle
    params = np.stack([arrays[1], arrays[3], np.zeros_like(arrays[1])], axis=1)
    kw = dict(prob_back=prob_back, local_pen=2.0, skip_pen=0.5, minscore=5.0)
    _, jpath = jdtw.squiggle_match_viterbi(arrays[0], params, **kw)
    _, tpath = tdtw.squiggle_match_viterbi(arrays[0], params, device="cpu", **kw)
    np.testing.assert_array_equal(tpath, jpath)


def _walk_plane(T: int, npos: int, rng):
    """A hand-made DTW traceback: chip_smoke.walk_plane's seeded path (far
    END jumps, runs of skips, back-state excursions, stays longer than the
    kernel's window of 256 samples, a leading START run; the generator the
    card's check uses), its samples' move bytes written into a plane of
    random moves (forward 0-5, back 0-1). Returns (final, moves, end_src,
    path)."""
    final, end_src, path, (rows, states, codes) = chip_smoke.walk_plane(T, npos, rng)
    nf = npos + 2
    moves = np.empty((T, 2 * npos + 2), np.uint8)
    moves[:, :nf] = rng.integers(0, 6, (T, nf))
    moves[:, nf:] = rng.integers(0, 2, (T, npos))
    moves[rows, states] = codes
    return final, moves, end_src, path


@pytest.mark.parametrize("T,npos,offset", [(6000, 600, 0), (6000, 601, 3),
                                           (3000, 40, 5), (2000, 3, 7)])
def test_dtw_walk_follows_hand_made_planes(monkeypatch, T, npos, offset):
    """On hand-made move planes (far END jumps, back-state excursions, runs
    of skips, long stays, a leading START run; one plane a view 3 bytes
    into its buffer), the walk takes the path the plane was made from, as
    does the walk over the int32 traceback that moves_to_states rebuilds;
    relabelled, the port's squiggle_match_viterbi path is the one
    scrappie_tpu's walk takes over that traceback."""
    rng = np.random.default_rng(T + npos)
    final, moves, end_src, want = _walk_plane(T, npos, rng)
    taken = moves[np.arange(1, T), want[1:]]
    # START from the lead on, after one sample's step out of a back state
    assert (taken == 4).sum() >= 5 and (want[:T // 20 - 1] == 0).all()
    if npos >= 40:  # a back-state excursion and a run of skips
        assert (want >= npos + 2).sum() > 0 and (taken == 2).sum() > 0
    flat = torch.zeros(moves.size + offset, dtype=torch.uint8)
    tmoves = flat[offset:].view(moves.shape)
    tmoves.copy_(torch.from_numpy(moves))
    tfinal, tend = torch.from_numpy(final), torch.from_numpy(end_src)
    ops.reset_launches()
    path = tops.dtw_walk(tfinal, tmoves, tend)
    assert ops.LAUNCHES["dtw_walk"] == 0
    np.testing.assert_array_equal(path.numpy(), want)
    tb = tops.moves_to_states(tmoves, tend).numpy()
    np.testing.assert_array_equal(_walk_states(final, tb), want)
    signal = np.zeros(T, np.float32)
    params = np.zeros((npos, 3), np.float32)
    monkeypatch.setattr(jdtw, "_dispatch_match", lambda *a: (final, tb))
    monkeypatch.setattr(tdtw, "_match", lambda *a: (tfinal, tmoves, tend))
    jscore, jpath = jdtw.squiggle_match_viterbi(signal, params)
    tscore, tpath = tdtw.squiggle_match_viterbi(signal, params, device="cpu")
    np.testing.assert_array_equal(tpath, jpath)
    assert tscore == jscore


@pytest.mark.parametrize("cluster", [1, 4, 8, 16])
def test_dtw_cluster_layout_owns_each_state_once(cluster):
    """Every forward state (and with it its position's back state) has one
    owner; each CTA holds at least two states, so the halos (two forward
    states and a back state to the left, one forward state to the right)
    come from its neighbours; a thread's states never straddle two CTAs; a
    read whose states fit one CTA at one a thread takes one CTA; and the
    limit is refused by name."""
    for npos in sorted({1, 2, 5, 17, 100, 510, 511, 2047, 3000, 6000,
                        tops.cluster_capacity(cluster)}):
        if npos > tops.cluster_capacity(cluster):
            continue
        lay = tops.cluster_layout(npos, cluster)
        nf = npos + 2
        assert 1 <= lay.ncta <= cluster and lay.spt in tops.DTW_SPTS
        assert lay.threads % 32 == 0 and lay.threads <= tops.DTW_THREADS_MAX
        assert lay.per >= 2 and lay.per % lay.spt == 0
        assert lay.threads * lay.spt >= lay.per
        owner = np.full(nf, -1)
        for c in range(lay.ncta):
            s0, s1 = c * lay.per, min((c + 1) * lay.per, nf)
            assert s1 - s0 >= (1 if c == lay.ncta - 1 else 2)
            for t in range(lay.threads):
                sts = range(s0 + t * lay.spt, min(s0 + (t + 1) * lay.spt, s1))
                assert all(owner[st] == -1 for st in sts)
                owner[list(sts)] = c
        assert (owner >= 0).all()
        assert (lay.ncta == 1) == (nf <= tops.DTW_THREADS_MAX or cluster == 1)
        if lay.ncta > 1:
            assert lay.spt == min(s for s in tops.DTW_SPTS if -(-max(
                2, -(-nf // cluster)) // s) <= tops.DTW_THREADS_MAX)
        assert tops.shared_state_bytes(npos, cluster) + tops.RED_BYTES <= ops.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="DTW_MAX_SHARED_NPOS"):
        tops.cluster_layout(tops.cluster_capacity(cluster) + 1, cluster)
    with pytest.raises(ValueError, match="1 to 16"):
        tops.cluster_layout(100, 17)


@pytest.mark.parametrize("prob_back", [0.0, 0.1])
def test_squiggle_match_end_to_end_matches_jax(prob_back):
    rng = np.random.default_rng(80)
    params = dtw_params(45, rng)
    sig = rng.standard_normal(300).astype(np.float32)
    kw = dict(prob_back=prob_back, local_pen=2.0, skip_pen=0.5, minscore=5.0,
              rate=1.3)
    jscore, jpath = jdtw.squiggle_match_viterbi(sig, params, **kw)
    score, path = tdtw.squiggle_match_viterbi(sig, params, device="cpu", **kw)
    np.testing.assert_array_equal(path, jpath)
    assert score == pytest.approx(jscore, abs=1e-4)
    fwd = tdtw.squiggle_match_forward(sig, params, device="cpu", **kw)
    assert fwd == pytest.approx(jdtw.squiggle_match_forward(sig, params, **kw),
                                abs=1e-4)
    # a tensor runs on its own device
    tscore, tpath = tdtw.squiggle_match_viterbi(torch.from_numpy(sig), params, **kw)
    assert tscore == score and np.array_equal(tpath, path)


@pytest.mark.parametrize("options", [{}, dict(back_prob=0.1, skip_pen=2.0,
                                              rate=1.2, model="squiggle_r10")])
def test_map_signal_to_squiggle_matches_jax(options):
    seq = bases(120, 90)
    model = options.get("model", "squiggle_r94")
    data = simulate(japi.sequence_to_squiggle(seq, model=model, rescale=True), 91)
    jscore, jpath = japi.map_signal_to_squiggle(data, seq, **options)
    score, path = tapi.map_signal_to_squiggle(data, seq, device="cpu", **options)
    assert path.shape == jpath.shape == data.shape
    np.testing.assert_array_equal(path, jpath)
    # the two squiggles differ by their convolutions' rounding (TOL), which
    # the score sums over every sample: held to the finals' tolerance
    np.testing.assert_allclose(score, jscore, **FINAL_TOL)
    mapped = path[path >= 0]
    assert len(mapped) > 0.8 * (len(data) - 500) and mapped.max() > 100


def test_dtw_launches_nothing_on_the_cpu_and_sizes_its_state():
    ops.reset_launches()
    arrays = [torch.from_numpy(a) for a in _dtw_inputs(10, 20, 0.0, seed=1)]
    final, moves, end_src = tops.squiggle_match_tm(*arrays, 0.0, 2.0, 0.5, 5.0)
    tops.dtw_walk(final, moves, end_src)
    assert ops.LAUNCHES["dtw"] == ops.LAUNCHES["dtw_walk"] == 0
    # a cluster of 16 CTAs of up to 512 threads, 4 states a thread
    assert tops.DTW_MAX_SHARED_NPOS == 32766 == tops.cluster_capacity(16)
    assert tops.shared_state_bytes(tops.DTW_MAX_SHARED_NPOS) + tops.RED_BYTES <= ops.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="DTW_MAX_SHARED_NPOS"):
        tops.shared_state_bytes(tops.DTW_MAX_SHARED_NPOS + 1)


def test_dtw_input_checks():
    sig, locs, scales, logscales, mp, sp = (
        torch.from_numpy(a) for a in _dtw_inputs(10, 20, 0.0, seed=2))
    tops.check_dtw_input(sig, locs, scales, logscales, mp, sp)
    with pytest.raises(ValueError, match="move_pen"):
        tops.check_dtw_input(sig, locs, scales, logscales, mp[:-1], sp)
    with pytest.raises(ValueError, match="contiguous"):
        tops.check_dtw_input(sig, locs, torch.stack([scales, scales], 1)[:, 0],
                             logscales, mp, sp)
    with pytest.raises(ValueError, match="dtype"):
        tops.check_dtw_input(sig.double(), locs, scales, logscales, mp, sp)


def test_api_hands_the_dtw_kernel_its_layout(monkeypatch):
    """On a CUDA tensor the DTW wrapper raises unless its inputs are
    contiguous float32; the twin takes any layout. So the twin here runs the
    kernel's input checks first: every path that reaches it must pass."""
    seen = []
    plain = tops.squiggle_match_plain

    def checked(*args, **kwargs):
        tops.check_dtw_input(*args[:6])
        seen.append(args[0].shape[0])
        return plain(*args, **kwargs)

    monkeypatch.setattr(tops, "squiggle_match_plain", checked)
    seq = bases(60, 95)
    data = simulate(tapi.sequence_to_squiggle(seq, rescale=True, device="cpu"), 96)
    tapi.map_signal_to_squiggle(data, seq, device="cpu")
    params = tapi.sequence_to_squiggle(seq, device="cpu")
    tdtw.squiggle_match_forward(data[300:600], params, device="cpu")
    assert len(seen) == 2


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.sequence_to_squiggle("ACGT")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.map_signal_to_squiggle(np.zeros(500, np.float32), "ACGT")


def _write_fast5(path, data: np.ndarray, read_id: str) -> None:
    digitisation, rng_pa, offset = 8192.0, 1400.0, 10.0
    adc = np.round(data / (rng_pa / digitisation) - offset).astype(np.int16)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_3")
        grp.create_dataset("Signal", data=adc)
        grp.attrs["read_id"] = read_id
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = digitisation
        meta["range"] = rng_pa
        meta["offset"] = offset
        meta["sampling_rate"] = 4000.0


def _run(main, argv) -> str:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    assert code == 0, err.getvalue()
    return out.getvalue()


def assert_same_tsv(ours: str, ref: str) -> None:
    """Same lines and words (split at tabs, blanks and parentheses);
    integer and text words identical, floats within relative 1e-5."""
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b) > 2
    for x, y in zip(a, b):
        wx, wy = (re.split(r"[\s()]+", line) for line in (x, y))
        assert len(wx) == len(wy), (x, y)
        for u, v in zip(wx, wy):
            if u != v:
                assert "." in u and "." in v, (x, y)
                np.testing.assert_allclose(float(u), float(v), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{x!r} {y!r}")


@pytest.mark.parametrize("extra", [[], ["--rescale", "--model", "squiggle_r94_rna",
                                        "--prefix", "p_"]])
def test_cli_squiggle_matches_scrappie_tpu(tmp_path, extra):
    fa = tmp_path / "seqs.fa"
    fa.write_text(f">one first\n{bases(40, 97)}\n{bases(30, 98)}\n>two\n"
                  f"{bases(55, 99)}\n>bad\nACGTNNACGT\n")
    argv = ["squiggle", *extra, str(fa)]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    assert ours.count("pos\tbase") == 2
    assert_same_tsv(ours, ref)


@pytest.mark.parametrize("extra", [[], ["--backprob", "0.1", "--localpen", "3",
                                        "--rate", "1.2"]])
def test_cli_mappy_matches_scrappie_tpu(tmp_path, extra):
    seq = bases(90, 100)
    (tmp_path / "ref.fa").write_text(f">ref\n{seq}\n")
    data = simulate(japi.sequence_to_squiggle(seq, rescale=True), 101)
    _write_fast5(tmp_path / "read.fast5", data, "mappy-read")
    argv = ["mappy", *extra, str(tmp_path / "ref.fa"), str(tmp_path / "read.fast5")]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    assert "score =" in ours.splitlines()[0]
    assert_same_tsv(ours, ref)
