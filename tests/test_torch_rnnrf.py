"""rnnrf_r94 end to end on the CPU: the port (its plain twins) against the
JAX package on the same seeded signals and the same in-repo weights, at
the published widths (conv window 19, stride 2, 96 filters, five residual
GRU layers of 96, 25 CRF transitions).

Transitions are held to rtol 1e-5 and atol 1e-4 (seen: at most 2.3e-5,
on entries up to 63): the fp32 sums of the conv, the GRU and the head are
taken in another order, the residual stack carries the differences of all
five layers into the head's 96-term sums, whatever the size of the entry,
and globalnorm subtracts logZ / T, where logZ (of order T times the
transitions) keeps its relative error, so every entry of a row shares one
shift of a few 1e-6. A path score
is the sum of nblock such transitions and is held to 2e-5 per block (seen:
at most 4.5e-6 per block). Decoded paths, sequences and positions are
expected to be identical; these seeds give identical calls in every
path."""

import contextlib
import io

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import api as tapi
from scrappie_torch.cli.main import main as torch_main
from scrappie_torch.models.convert import params_from_numpy
from scrappie_torch.models.forward import RgrgrModel, RnnrfModel, load_model
from scrappie_torch.models.forward import rnnrf_features as t_features
from scrappie_torch.models.forward import rnnrf_transitions as t_transitions
from scrappie_torch.ops.pipeline import rnnrf_basecall_fused as t_fused
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_tpu import api as japi
from scrappie_tpu import ops as jops
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.ops.pipeline import rnnrf_basecall_fused as j_fused
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal

torch.set_num_threads(1)
MODEL = "rnnrf_r94"
TRANS_TOL = dict(rtol=1e-5, atol=1e-4)
SCORE_TOL_PER_BLOCK = 2e-5


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


def close_score(a: float, b: float, nblock: int) -> bool:
    return abs(a - b) <= SCORE_TOL_PER_BLOCK * nblock


@pytest.fixture(scope="module")
def params_np():
    return registry.load_params(MODEL)


@pytest.fixture(scope="module")
def jparams(params_np):
    return {k: jnp.asarray(v) for k, v in params_np.items()}


def test_weights_load_unchanged(params_np):
    keys = {"conv_W", "conv_b", "FF_W", "FF_b"} | {
        f"gru{d}_{k}" for d in ("B1", "F2", "B3", "F4", "B5")
        for k in ("iW", "b", "sW", "sW2")}
    assert keys == set(params_np)
    net = RnnrfModel.from_registry(device="cpu")
    assert (net.stride, net.conv_activation) == (2, "elu")
    assert net.conv_W.shape == (19, 1, 96) and net.FF_W.shape == (96, 25)
    for k, v in params_np.items():
        np.testing.assert_array_equal(net.params[k].numpy(), v)
    assert isinstance(load_model(MODEL, "cpu"), RnnrfModel)
    with pytest.raises(ValueError, match="rgrgr"):
        RnnrfModel.from_registry("rgrgr_r94", "cpu")
    assert isinstance(load_model("rgrgr_r94", "cpu"), RgrgrModel)


@pytest.mark.parametrize("nsample", [60, 301])
def test_transitions_match_jax_at_full_width(params_np, jparams, nsample):
    sig = np.random.default_rng(nsample).standard_normal(
        (2, nsample, 1)).astype(np.float32)
    with jops.pallas(False):
        ref = np.asarray(jforward.rnnrf_transitions(
            jparams, jnp.asarray(sig), conv_activation="elu", stride=2))
        jfeat = np.asarray(jforward.rnnrf_features(
            jparams, jnp.asarray(sig), conv_activation="elu", stride=2))
    tparams = params_from_numpy(params_np, "cpu")
    out = t_transitions(tparams, torch.from_numpy(sig)).numpy()
    assert out.shape == ref.shape == (2, -(-nsample // 2), 25)
    np.testing.assert_allclose(out, ref, **TRANS_TOL)
    feat = t_features(tparams, torch.from_numpy(sig)).numpy()
    assert feat.shape == jfeat.shape == (2, -(-nsample // 2), 96)
    np.testing.assert_allclose(feat, jfeat, **TRANS_TOL)


def test_model_module_matches_function(params_np):
    model = RnnrfModel.from_registry(MODEL, "cpu")
    sig = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 120, 1)).astype(np.float32))
    expect = t_transitions(params_from_numpy(params_np, "cpu"), sig)
    assert torch.equal(model(sig), expect)
    with pytest.raises(ValueError, match="log"):
        model(sig, return_log=False)


@pytest.mark.parametrize("emit_bias", [0.0, -1.0])
def test_fused_pipeline_matches_jax(params_np, jparams, emit_bias):
    sig = np.random.default_rng(11).standard_normal((3, 120, 1)).astype(np.float32)
    jscore, jpath = j_fused(jparams, jnp.asarray(sig), conv_activation="elu",
                            stride=2, emit_bias=emit_bias)
    score, path = t_fused(params_from_numpy(params_np, "cpu"),
                          torch.from_numpy(sig), emit_bias=emit_bias)
    assert path.dtype == torch.int16 and path.shape == (3, 61)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=0,
                               atol=SCORE_TOL_PER_BLOCK * 60)
    model = RnnrfModel.from_registry(MODEL, "cpu")
    mscore, mpath = model.basecall_fused(torch.from_numpy(sig),
                                         emit_bias=emit_bias)
    assert torch.equal(mpath, path) and torch.equal(mscore, score)


@pytest.mark.parametrize("emit_bias", [0.0, -0.5])
def test_calc_post_and_decode_post_match_jax(emit_bias):
    data = synthetic_signal(1800, seed=7)
    jraw = japi.RawTable(data).trim().scale()
    raw = tapi.RawTable(data).trim().scale()
    jpost = japi.calc_post(jraw, MODEL)
    post = tapi.calc_post(raw, MODEL, device="cpu")
    assert post.shape == jpost.shape and post.shape[1] == 25
    np.testing.assert_allclose(post.data(), jpost.data(), **TRANS_TOL)
    seq, score, pos = tapi.decode_post(post, MODEL, device="cpu",
                                       emit_bias=emit_bias)
    jseq, jscore, jpos = japi.decode_post(jpost, MODEL, emit_bias=emit_bias)
    assert seq and seq == jseq and close_score(score, jscore, post.shape[0])
    np.testing.assert_array_equal(pos, jpos)


def test_calc_post_refuses_linear_space():
    raw = tapi.RawTable(synthetic_signal(800, seed=1)).trim().scale()
    with pytest.raises(ValueError, match="non-log"):
        tapi.calc_post(raw, MODEL, log=False, device="cpu")


@pytest.mark.parametrize("with_base_probs", [False, True])
def test_basecall_raw_matches_jax(with_base_probs):
    for i, n in enumerate((2500, 3300)):
        data = synthetic_signal(n, seed=300 + i)
        jseq, jscore, jpos, jstart, jend, jprobs = japi.basecall_raw(
            data, MODEL, with_base_probs=with_base_probs)
        seq, score, pos, start, end, probs = tapi.basecall_raw(
            data, MODEL, with_base_probs=with_base_probs, device="cpu")
        assert seq and seq == jseq
        assert (start, end) == (jstart, jend)
        np.testing.assert_array_equal(pos, jpos)
        assert close_score(score, jscore, len(pos) - 1)
        if with_base_probs:
            assert probs.shape == jprobs.shape == (len(pos), 5)
            np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-4)
        else:
            assert probs is None and jprobs is None


def test_basecall_raw_passes_the_emit_bias():
    data = synthetic_signal(2800, seed=9)
    jseq, *_ = japi.basecall_raw(data, MODEL, emit_bias=-1.0)
    seq, *_ = tapi.basecall_raw(data, MODEL, emit_bias=-1.0, device="cpu")
    base, *_ = tapi.basecall_raw(data, MODEL, device="cpu")
    assert seq == jseq and len(seq) < len(base)


@pytest.mark.parametrize("mode,homopolymer,emit_bias", [
    ("fast", "nochange", 0.0), ("stitch", "nochange", 0.0),
    ("stitch", "mean", 0.0), ("stitch", None, -0.5)])
def test_engine_matches_jax(mode, homopolymer, emit_bias):
    signals = [RawSignal(synthetic_signal(n, seed=400 + i), uuid=f"r{i}")
               for i, n in enumerate((2600, 3400, 1500))]
    kw = dict(chunk_len=1000, overlap=100, mode=mode)
    call = dict(homopolymer=homopolymer, crf_emit_bias=emit_bias)
    jres = JEngine(MODEL, **kw).basecall_signals(signals, **call)
    tres = TEngine(MODEL, device="cpu", **kw).basecall_signals(signals, **call)
    for j, t in zip(jres, tres):
        assert t.sequence and t.sequence == j.sequence
        assert (t.uuid, t.nblock, t.trim_start, t.trim_end, t.nsample) == \
            (j.uuid, j.nblock, j.trim_start, j.trim_end, j.nsample)
        np.testing.assert_array_equal(t.pos, j.pos)
        assert close_score(t.score, j.score, t.nblock)


@pytest.mark.parametrize("mode", ["fast", "stitch"])
def test_engine_hands_the_crf_kernels_their_layout(monkeypatch, mode):
    """On a CUDA tensor the CRF wrappers raise unless their inputs are
    contiguous and of the kernels' types; the CPU twins take any layout. So
    the twins here run the kernels' input checks first: every path that
    reaches them must already pass."""
    from scrappie_torch.ops import crf as tc

    seen = set()

    def checked(name, check):
        plain = getattr(tc, name)

        def run(*args):
            check(*args)
            seen.add(name)
            return plain(*args)
        monkeypatch.setattr(tc, name, run)

    checked("crf_viterbi_scores_tm_plain", tc.check_trans_input)
    checked("crf_partition_tm_plain", tc.check_trans_input)
    checked("crf_backtrace_tm_plain", tc.check_traceback_input)
    signals = [RawSignal(synthetic_signal(n, seed=500 + i), uuid=f"r{i}")
               for i, n in enumerate((2200, 1400))]
    engine = TEngine(MODEL, device="cpu", chunk_len=1000, overlap=100,
                     mode=mode)
    for emit_bias in (0.0, -0.5):
        res = engine.basecall_signals(signals, crf_emit_bias=emit_bias)
        assert all(r.sequence for r in res)
    assert tapi.basecall_raw(synthetic_signal(1500, seed=502), MODEL,
                             emit_bias=-0.5, device="cpu")[0]
    assert seen == {"crf_viterbi_scores_tm_plain", "crf_partition_tm_plain",
                    "crf_backtrace_tm_plain"}


def _write_fast5(path, n: int, seed: int, read_id: str) -> None:
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    pa = 90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)
    digitisation, rng_pa, offset = 8192.0, 1400.0, 10.0
    adc = np.round(pa / (rng_pa / digitisation) - offset).astype(np.int16)
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


@pytest.mark.parametrize("extra", [[], ["--fast", "--crf-emit-bias", "-0.5"]])
def test_cli_matches_scrappie_tpu(tmp_path, extra):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 3000, seed=6, read_id="5e1f-rnnrf")
    argv = ["raw", "--model", MODEL, "--format", "sam", "--chunk-len", "1000",
            "--overlap", "100", *extra, str(path)]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    assert ours == ref
    assert ours.split("\t")[9]
