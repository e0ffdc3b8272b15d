"""nanonet_events end to end on the CPU: the port (its plain twins) against
the JAX package on the same seeded signals and features and the same
in-repo weights, at the published widths (window 3 over 4 features, two
stages of forward and backward peephole LSTMs of 96, feedforward2_tanh,
1025 states).

The posterior is held to rtol = atol = 1e-5 (fp32 sums in another order;
seen: at most 2e-5 on entries up to 18, relative 1e-6). A path score is
the sum of nevent such entries and is held to rtol 1e-5 and atol 1e-4.
Decoded paths, sequences and event annotations are expected to be
identical; these seeds give identical calls in every path."""

import contextlib
import io
import json

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import api as tapi
from scrappie_torch.cli.main import main as torch_main
from scrappie_torch.models.convert import params_from_numpy, raw_spec
from scrappie_torch.models.forward import EventsModel, RgrgrModel, load_model
from scrappie_torch.models.forward import events_posterior as t_posterior
from scrappie_torch.models.forward import events_posterior_tm as t_posterior_tm
from scrappie_torch.nn import layers as tl
from scrappie_torch.ops.pipeline import events_basecall_fused as t_fused
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_tpu import api as japi
from scrappie_tpu import ops as jops
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.nn import layers as jl
from scrappie_tpu.ops.pipeline import events_basecall_fused as j_fused
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal

torch.set_num_threads(1)
MODEL = "nanonet_events"
TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)
PENALTIES = dict(stay_pen=0.3, skip_pen=1.1, local_pen=4.0, use_slip=True,
                 tempW=1.2, tempb=0.9)


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


def features(B: int, T: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def params_np():
    return registry.load_params(MODEL)


@pytest.fixture(scope="module")
def jparams(params_np):
    return {k: jnp.asarray(v) for k, v in params_np.items()}


@pytest.mark.parametrize("shape,w,stride", [((1, 4), 3, 1), ((7, 4), 3, 1),
                                            ((2, 10, 4), 3, 1), ((2, 10, 3), 4, 2),
                                            ((9, 2), 5, 3), ((0, 4), 3, 1)])
def test_window_matches_jax(shape, w, stride):
    x = np.random.default_rng(len(shape) + w).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jl.window(jnp.asarray(x), w, stride))
    out = tl.window(torch.from_numpy(x), w, stride).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_feedforward2_tanh_matches_jax(params_np):
    rng = np.random.default_rng(4)
    xf, xb = (rng.standard_normal((3, 20, 96)).astype(np.float32) for _ in range(2))
    w = [params_np[f"FF1_{k}"] for k in ("Wf", "Wb", "b")]
    ref = np.asarray(jl.feedforward2_tanh(jnp.asarray(xf), jnp.asarray(xb),
                                          *map(jnp.asarray, w)))
    out = tl.feedforward2_tanh(torch.from_numpy(xf), torch.from_numpy(xb),
                               *map(torch.from_numpy, w)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("return_log", [True, False])
def test_posterior_matches_jax_at_full_width(params_np, jparams, return_log):
    feats = features(2, 50, seed=5)
    kw = dict(return_log=return_log, min_prob=1e-5)
    with jops.pallas(False):
        ref = np.asarray(jforward.events_posterior(jparams, jnp.asarray(feats), **kw))
    ref_tm = np.asarray(jforward.events_posterior_tm(jparams, jnp.asarray(feats), **kw))
    tparams = params_from_numpy(params_np, "cpu")
    out = t_posterior(tparams, torch.from_numpy(feats), **kw).numpy()
    assert out.shape == ref.shape == (2, 50, 1025)
    np.testing.assert_allclose(out, ref, **TOL)
    out_tm = t_posterior_tm(tparams, torch.from_numpy(feats), **kw).numpy()
    assert out_tm.shape == ref_tm.shape == (50, 2, 1025)
    np.testing.assert_allclose(out_tm, ref_tm, **TOL)


def test_model_loads_the_weights_unchanged(params_np):
    net = load_model(MODEL, "cpu")
    assert isinstance(net, EventsModel) and net.winlen == 3
    assert set(net.params) == set(params_np)
    for k, v in params_np.items():
        np.testing.assert_array_equal(net.params[k].numpy(), v)
    feats = torch.from_numpy(features(1, 30, seed=6))
    tparams = params_from_numpy(params_np, "cpu")
    assert torch.equal(net(feats), t_posterior(tparams, feats))
    for a, b in zip(net.basecall_fused(feats), t_fused(tparams, feats)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="events"):
        RgrgrModel.from_registry(MODEL, "cpu")
    with pytest.raises(ValueError, match="basecall_events"):
        raw_spec(MODEL)


@pytest.mark.parametrize("options", [{}, PENALTIES])
def test_fused_pipeline_matches_jax(params_np, jparams, options):
    feats = features(3, 80, seed=7)
    jscore, jpath = j_fused(jparams, jnp.asarray(feats), winlen=3, **options)
    score, path = t_fused(params_from_numpy(params_np, "cpu"),
                          torch.from_numpy(feats), winlen=3, **options)
    assert path.dtype == torch.int16 and path.shape == (3, 81)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **SCORE_TOL)


@pytest.mark.parametrize("options", [
    {}, dict(calibration="real", use_slip=True, dwell_correction=False)])
def test_basecall_events_matches_jax(options):
    for i, n in enumerate((3000, 5500, 8000)):
        data = synthetic_signal(n, seed=800 + i)
        jseq, jscore, jet, jstart, jend = japi.basecall_events(data, **options)
        seq, score, et, start, end = tapi.basecall_events(data, device="cpu",
                                                          **options)
        assert seq and seq == jseq
        assert (start, end, et.start, et.end) == (jstart, jend, jet.start, jet.end)
        np.testing.assert_array_equal(et.event, jet.event)
        np.testing.assert_allclose(score, jscore, **SCORE_TOL)


def test_basecall_events_collapse_guard_redecodes(capfd):
    """A skip penalty that collapses the call (39 bases for 730 events
    here) is decoded again with skip_pen = 0, as in scrappie_tpu."""
    data = synthetic_signal(4000, seed=810)
    seq, *_ = tapi.basecall_events(data, device="cpu", skip_pen=5.0)
    assert "re-decoding with skip_pen=0" in capfd.readouterr().err
    jseq, *_ = japi.basecall_events(data, skip_pen=5.0)
    base, *_ = tapi.basecall_events(data, device="cpu")
    assert base and seq == jseq == base


@pytest.mark.parametrize("mode,homopolymer", [("fast", None), ("stitch", None),
                                              ("stitch", "mean")])
def test_engine_matches_jax(mode, homopolymer):
    signals = [RawSignal(synthetic_signal(n, seed=820 + i), uuid=f"r{i}")
               for i, n in enumerate((3000, 5000, 4200))]
    kw = dict(chunk_len=400, overlap=64, mode=mode)
    jres = JEngine(MODEL, **kw).basecall_signals(signals, homopolymer=homopolymer)
    tres = TEngine(MODEL, device="cpu", **kw).basecall_signals(
        signals, homopolymer=homopolymer)
    for j, t in zip(jres, tres):
        assert t.sequence and t.sequence == j.sequence
        assert (t.uuid, t.nblock, t.trim_start, t.trim_end, t.nsample) == \
            (j.uuid, j.nblock, j.trim_start, j.trim_end, j.nsample)
        np.testing.assert_array_equal(t.pos, j.pos)
        np.testing.assert_array_equal(t.events.event, j.events.event)
        np.testing.assert_allclose(t.score, j.score, **SCORE_TOL)


def test_engine_defaults_count_events():
    engine = TEngine(MODEL, device="cpu")
    assert (engine.chunk_len, engine.overlap) == (2048, 256)
    # per-base qualities are ported: one code a base
    res = engine.basecall_signals([RawSignal(synthetic_signal(3000, 1))],
                                  with_qualities=True,
                                  dwell_correction=False)[0]
    assert res.sequence and len(res.qual) == len(res.sequence)


@pytest.mark.parametrize("mode", ["fast", "stitch"])
def test_engine_hands_the_kernels_their_layout(monkeypatch, mode):
    """On a CUDA tensor the LSTM (the pair route of each stage) and Viterbi
    wrappers raise unless their inputs are contiguous and of the kernels'
    types; the CPU twins take any layout. So the twins here run the
    kernels' input checks first: every path that reaches them must already
    pass."""
    from scrappie_torch import ops
    from scrappie_torch.ops import lstm as tlstm
    from scrappie_torch.ops import viterbi as tv

    seen = set()

    def checked(module, name, check):
        plain = getattr(module, name)

        def run(*args, **kwargs):
            check(*args)
            seen.add(name)
            return plain(*args, **kwargs)
        monkeypatch.setattr(module, name, run)

    def check_head(h, W, bvec, weights=None, *_):
        tv.check_head_input(h, W, bvec, weights)

    def check_scores(lp, *_):
        ops.check_kernel_input("lp", lp, tuple(lp.shape))

    def check_backtrace(final, tb):
        T, B, n = tb.shape
        ops.check_kernel_input("final", final, (B, n))
        ops.check_kernel_input("tb", tb, (T, B, n), torch.int16)

    checked(tlstm, "lstm_layer_tm_plain",
            lambda x, iW, b, sW, peep, *_: tlstm.check_lstm_input(x, iW, b, sW,
                                                                  peep))
    checked(tlstm, "lstm_pair_tm_plain",
            lambda x, wF, wB, *_: tlstm.check_lstm_pair_input(x, wF, wB))
    checked(tv, "head_logpost_tm_plain", check_head)
    checked(tv, "viterbi_scores_tm_plain", check_scores)
    checked(tv, "viterbi_backtrace_tm_plain", check_backtrace)
    signals = [RawSignal(synthetic_signal(n, seed=830 + i), uuid=f"r{i}")
               for i, n in enumerate((3200, 2200))]
    engine = TEngine(MODEL, device="cpu", chunk_len=400, overlap=64, mode=mode)
    assert all(r.sequence for r in engine.basecall_signals(signals))
    assert tapi.basecall_events(synthetic_signal(2500, seed=832), device="cpu")[0]
    expect = {"lstm_pair_tm_plain", "lstm_layer_tm_plain",
              "viterbi_scores_tm_plain", "viterbi_backtrace_tm_plain"}
    if mode == "fast":
        expect.add("head_logpost_tm_plain")
    assert expect <= seen


def _write_fast5(path, n: int, seed: int, read_id: str) -> None:
    pa = synthetic_signal(n, seed)
    digitisation, rng_pa, offset = 8192.0, 1400.0, 10.0
    adc = np.round(pa / (rng_pa / digitisation) - offset).astype(np.int16)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_9")
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


@pytest.mark.parametrize("extra", [["--uuid"], ["--fast", "--format", "sam",
                                                "--no-dwell", "--stay", "0.5"]])
def test_cli_matches_scrappie_tpu(tmp_path, extra):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 4500, seed=840, read_id="7c2e-events")
    argv = ["events", "--chunk-len", "600", "--overlap", "64", *extra, str(path)]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    if "sam" in extra:
        assert ours == ref and ours.split("\t")[9]
        return
    (head, seq), (jhead, jseq) = (text.splitlines() for text in (ours, ref))
    assert seq and seq == jseq
    name, meta = head.split(None, 1)
    jname, jmeta = jhead.split(None, 1)
    assert name == jname == ">7c2e-events"
    meta, jmeta = json.loads(meta), json.loads(jmeta)
    assert meta.pop("normalised_score") == pytest.approx(
        jmeta.pop("normalised_score"), rel=1e-5, abs=1e-6)
    assert meta == jmeta
