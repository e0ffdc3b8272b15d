"""Per-base qualities (FASTQ) of scrappie_torch against scrappie_tpu's, on
the CPU.

  * the fast paths' quality streams (ops/pipeline.quality_stream_tm)
    against scrappie_tpu/ops/pipeline.py's _fused_quality_stream and
    _fused_quality_stream_ens on the same features and paths: rgrgr_r94,
    raw_r94, nanonet_events and the 3:1:1 ensemble;
  * BasecallEngine(with_qualities=True) against the JAX engine: fast and
    stitch mode, events without the dwell correction, rnnrf_r94 stitch,
    qual_calibration="real" (the ensemble's own fit and the fallback to
    the primary's);
  * `--format fastq` against `python -m scrappie_tpu` on a synthetic fast5.

Sequences must be equal; quality strings and streams agree by
utils/seqcompare.quals_agree: the same number of codes, at most 1% of
them differ (at least 2 allowed), none by more than 1. The streams and the
host qualities round float32 and float64 sums, summed in other orders, to
integer Phred codes, so a code at a rounding edge can move by one; the
JAX package's own fast-against-stitch tolerance (tests/test_quality.py,
2% and 2) is the outer limit.
"""

import contextlib
import io

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch.cli.main import main as torch_main
from scrappie_torch.models.forward import load_model
from scrappie_torch.ops import pipeline as tpipe
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_torch.parallel.runner import RawSignal
from scrappie_torch.utils.seqcompare import qual_diffs, quals_agree
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.ops import pipeline as jpipe
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal as JRawSignal

torch.set_num_threads(2)

ENSEMBLE = ("rgrgr_r941", "rgrgr_r10")
GEOMETRY = dict(chunk_len=2000, overlap=400, batch_size=2)
EVENTS_GEOMETRY = dict(chunk_len=256, overlap=64, batch_size=2)
HEAD = dict(min_prob=1e-4, tempW=1.2, tempb=0.9)


def sim_signal(nbase: int, seed: int) -> np.ndarray:
    from scrappie_tpu.train.simulate import SquiggleSimulator

    return np.asarray(SquiggleSimulator(seed=seed).simulate_read(nbase)[0],
                      np.float32)


def assert_stream_close(a: np.ndarray, b: np.ndarray) -> None:
    """Two uint8 Phred+33 streams by quals_agree, row by row."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    for ra, rb in zip(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)):
        sa, sb = ra.tobytes().decode("ascii"), rb.tobytes().decode("ascii")
        assert quals_agree(sa, sb), qual_diffs(sa, sb)


def assert_same_calls(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.sequence == w.sequence and w.sequence
        assert (g.qual is None) == (w.qual is None)
        if w.qual is not None:
            assert len(g.qual) == len(g.sequence)
            assert quals_agree(g.qual, w.qual), qual_diffs(g.qual, w.qual)


# ------------------------------------------------------------ the streams

def _chunks(nsample: int, B: int, seed: int) -> torch.Tensor:
    sig = sim_signal(nsample // 8, seed)[: nsample * B]
    sig = (sig - np.median(sig)) / np.std(sig)
    return torch.from_numpy(np.resize(sig, (B, nsample, 1)).astype(np.float32))


def _check_stream(x, W, b, weights=None, **head):
    """The port's stream and the JAX package's on features x and the port's
    decoded path; returns the port's."""
    lp = tpipe.head_logpost_tm(x, W, b, weights, **head)
    _score, path = tpipe.viterbi_backtrace_tm(*tpipe.viterbi_scores_tm(lp))
    got = tpipe.quality_stream_tm(x, W, b, path, weights, **head).numpy()
    if weights is None:
        want = jpipe._fused_quality_stream(
            jnp.asarray(x.numpy()), jnp.asarray(W.numpy()),
            jnp.asarray(b.numpy()), jnp.asarray(path.numpy()), **head)
    else:
        want = jpipe._fused_quality_stream_ens(
            [jnp.asarray(xk.numpy()) for xk in x],
            [jnp.asarray(Wk.numpy()) for Wk in W],
            [jnp.asarray(bk.numpy()) for bk in b],
            jnp.asarray(weights.numpy()), jnp.asarray(path.numpy()), **head)
    assert_stream_close(got, np.asarray(want))
    assert got.shape == (x.shape[-2], x.shape[-3] + 1, 5)
    return got


@pytest.mark.parametrize("head", [{}, HEAD], ids=["default", "temperatures"])
def test_rgrgr_stream_matches_jax(head):
    net = load_model("rgrgr_r94", "cpu")
    x = tpipe.rgrgr_features_tm(net.params, _chunks(1500, 2, 1))
    _check_stream(x, net.params["FF_W"], net.params["FF_b"], **head)


def test_raw_r94_stream_matches_jax():
    net = load_model("raw_r94", "cpu")
    x = tpipe.raw_features_tm(net.params, _chunks(1200, 2, 2))
    _check_stream(x, net.params["FF3_W"], net.params["FF3_b"])


def test_events_stream_matches_jax():
    net = load_model("nanonet_events", "cpu")
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((2, 300, 4)).astype(np.float32))
    x = tpipe.events_features_tm(net.params, feats)
    _check_stream(x, net.params["FF3_W"], net.params["FF3_b"])


@pytest.mark.parametrize("head", [{}, HEAD], ids=["default", "temperatures"])
def test_ensemble_stream_matches_jax(head):
    from scrappie_torch.models.ensemble import fused_config

    nets = [load_model(m, "cpu") for m in ("rgrgr_r94",) + ENSEMBLE]
    w, kinds, acts = fused_config("rgrgr_r94", ENSEMBLE)
    h, W, b = tpipe.ensemble_features_tm([n.params for n in nets],
                                         _chunks(1500, 2, 4), kinds=kinds,
                                         conv_activations=acts, stride=5)
    _check_stream(h, W, b, torch.from_numpy(w), **head)


def test_fused_paths_return_the_stream():
    """with_qual adds the stream and changes neither score nor path."""
    net = load_model("rgrgr_r94", "cpu")
    sig = _chunks(1500, 2, 5)
    score, path = net.basecall_fused(sig)
    qscore, qpath, qual = net.basecall_fused(sig, with_qual=True)
    assert torch.equal(score, qscore) and torch.equal(path, qpath)
    x = tpipe.rgrgr_features_tm(net.params, sig)
    assert torch.equal(qual, tpipe.quality_stream_tm(
        x, net.params["FF_W"], net.params["FF_b"], path))
    assert qual.dtype == torch.uint8 and qual.shape == (2, 301, 5)


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def reads():
    return [sim_signal(n, s) for n, s in ((350, 5), (320, 6))]


def _both(reads, model, engine_kw=None, **call_kw):
    engine_kw = {**GEOMETRY, **(engine_kw or {})}
    got = TEngine(model, device="cpu", **engine_kw).basecall_signals(
        [RawSignal(r, uuid=f"r{i}") for i, r in enumerate(reads)], **call_kw)
    want = JEngine(model, **engine_kw).basecall_signals(
        [JRawSignal(r, uuid=f"r{i}") for i, r in enumerate(reads)], **call_kw)
    return got, want


@pytest.mark.parametrize("mode,homopolymer", [("fast", None),
                                              ("stitch", "nochange"),
                                              ("stitch", "mean")])
def test_engine_rgrgr_qualities(reads, mode, homopolymer):
    got, want = _both(reads, "rgrgr_r94", dict(mode=mode),
                      with_qualities=True, homopolymer=homopolymer)
    assert_same_calls(got, want)
    plain = TEngine("rgrgr_r94", device="cpu", mode=mode, **GEOMETRY
                    ).basecall_signals([RawSignal(r) for r in reads],
                                       homopolymer=homopolymer)
    # qualities change no call
    assert [p.sequence for p in plain] == [g.sequence for g in got]
    assert all(p.qual is None for p in plain)


def test_engine_raw_r94_fast_qualities(reads):
    got, want = _both(reads[:1], "raw_r94", dict(mode="fast"),
                      with_qualities=True)
    assert_same_calls(got, want)


@pytest.mark.parametrize("mode", ["fast", "stitch"])
def test_engine_events_qualities(reads, mode):
    got, want = _both(reads, "nanonet_events",
                      dict(mode=mode, **EVENTS_GEOMETRY),
                      with_qualities=True, dwell_correction=False)
    assert_same_calls(got, want)


def test_engine_events_dwell_drops_changed_qualities(reads):
    """With the dwell correction, a read whose length it changes loses its
    qualities, as in the JAX engine."""
    got, want = _both(reads, "nanonet_events", EVENTS_GEOMETRY,
                      with_qualities=True)
    for g, w in zip(got, want):
        assert g.sequence == w.sequence
        assert (g.qual is None) == (w.qual is None)


def test_engine_rnnrf_stitch_qualities(reads):
    got, want = _both(reads, "rnnrf_r94", with_qualities=True)
    assert_same_calls(got, want)
    got, want = _both(reads[:1], "rnnrf_r94", with_qualities=True,
                      crf_emit_bias=-0.5)
    assert_same_calls(got, want)


def test_posterior_crf_runs_on_the_named_device(monkeypatch):
    """decode/crf.posterior_crf: numpy input goes to `device`; on the CPU it
    equals scrappie_tpu's (absolute 1e-5, as tests/test_torch_crf.py); CUDA,
    the default, raises where there is none (no fallback to the CPU); a
    tensor stays on its own device."""
    from scrappie_torch.decode import crf as tdec
    from scrappie_tpu.decode import crf as jdec

    tr = (2.0 * np.random.default_rng(13).standard_normal((2, 30, 25))
          ).astype(np.float32)
    want = np.asarray(jdec.posterior_crf(tr))
    np.testing.assert_allclose(tdec.posterior_crf(tr, device="cpu"), want,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdec.posterior_crf(torch.tensor(tr)), want,
                               rtol=0, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tdec.posterior_crf(tr, device=device)


def test_engine_and_api_pass_their_device_to_posterior_crf(reads, monkeypatch):
    """The engine's rnnrf qualities and api.basecall_raw(with_base_probs)
    run the forward-backward on their own device, through the wrapper whose
    CUDA kernels take contiguous float32 [T, B, 25]: the twin here checks
    that input first. The engine makes one call for all the reads of an
    engine call, in the launches of runner.crf_groups (each padded to its
    longest read), the api one for its read."""
    from scrappie_torch import api as tapi
    from scrappie_torch.ops import crf as tc
    from scrappie_torch.parallel import runner

    devices, shapes, inputs = [], [], []
    for module, name in ((runner, "posterior_crf_batch"),
                         (tapi, "posterior_crf")):
        real = getattr(module, name)

        def spy(trans, *args, device=None, _real=real):
            devices.append(device)
            inputs.append(trans)
            return _real(trans, *args, device=device)
        monkeypatch.setattr(module, name, spy)
    twin = tc.crf_posterior_tm_plain

    def checked(trans_tm):
        tc.check_trans_input(trans_tm)
        shapes.append(tuple(trans_tm.shape))
        return twin(trans_tm)
    monkeypatch.setattr(tc, "crf_posterior_tm_plain", checked)
    engine = TEngine("rnnrf_r94", device="cpu", **GEOMETRY)
    res = engine.basecall_signals([RawSignal(r, uuid=f"r{i}")
                                   for i, r in enumerate(reads)],
                                  with_qualities=True)
    assert all(r.qual is not None and len(r.qual) == len(r.sequence)
               for r in res)
    base_probs = tapi.basecall_raw(reads[1], "rnnrf_r94", with_base_probs=True,
                                   device="cpu")[-1]
    assert base_probs.shape[-1] == 5
    assert [torch.device(d) for d in devices] == [torch.device("cpu")] * 2
    nblock = [len(t) for t in inputs[0]]
    assert len(nblock) == len(reads)
    assert shapes[:-1] == [(nblock[g[0]], len(g), 25)
                           for g in runner.crf_groups(nblock)]
    assert shapes[-1][1:] == (1, 25)


def test_engine_rnnrf_fast_has_no_qualities(reads):
    """rnnrf has no fused quality stream: fast mode warns and calls without
    qualities, as the JAX engine does."""
    eng = TEngine("rnnrf_r94", device="cpu", mode="fast", **GEOMETRY)
    signals = [RawSignal(reads[0])]
    got = eng.basecall_signals(signals, with_qualities=True)[0]
    plain = eng.basecall_signals(signals)[0]
    assert got.sequence == plain.sequence and got.sequence
    assert got.qual is None


@pytest.mark.parametrize("mode", ["fast", "stitch"])
@pytest.mark.parametrize("weights", [None, (2.0, 1.0, 1.0)],
                         ids=["fitted", "fallback"])
def test_engine_qual_calibration_real(reads, mode, weights):
    """'real' recalibrates exactly the raw stream: the 3:1:1 ensemble's own
    fit at its default weights, the primary model's fit otherwise."""
    from scrappie_torch.post.quality import recalibrate_phred

    kw = dict(mode=mode, ensemble=ENSEMBLE, ensemble_weights=weights)
    got, want = _both(reads[:1], "rgrgr_r94", dict(kw, qual_calibration="real"),
                      with_qualities=True, homopolymer="nochange")
    assert_same_calls(got, want)
    raw = TEngine("rgrgr_r94", device="cpu", **GEOMETRY, **kw
                  ).basecall_signals([RawSignal(reads[0])], with_qualities=True,
                                     homopolymer="nochange")[0]
    key = "rgrgr_r94+rgrgr_r10+rgrgr_r941" if weights is None else "rgrgr_r94"
    assert got[0].qual == recalibrate_phred(raw.qual, key)


def test_engine_refuses_unknown_qual_calibration():
    with pytest.raises(ValueError, match="unknown qual_calibration"):
        TEngine("rgrgr_r94", device="cpu", qual_calibration="bogus")


# --------------------------------------------------------------- the CLI

def _write_fast5(path, sig: np.ndarray, read_id: str) -> None:
    digitisation, rng_pa, offset = 8192.0, 1400.0, 10.0
    adc = np.round(sig / (rng_pa / digitisation) - offset).astype(np.int16)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_7")
        grp.create_dataset("Signal", data=adc)
        grp.attrs["read_id"] = read_id
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = digitisation
        meta["range"] = rng_pa
        meta["offset"] = offset
        meta["sampling_rate"] = 4000.0


def _run(main, argv, code=0):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        got = main(argv)
    assert got == code, err.getvalue()
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fast5(tmp_path_factory):
    path = tmp_path_factory.mktemp("fq") / "read.fast5"
    _write_fast5(path, sim_signal(350, 9) * 10.0 + 80.0, "5e1f-synthetic")
    return str(path)


def _fastq_records(text):
    lines = text.splitlines()
    assert len(lines) % 4 == 0 and lines
    return [lines[i : i + 4] for i in range(0, len(lines), 4)]


@pytest.mark.parametrize("argv", [
    ["raw"],
    ["raw", "--fast", "--chunk-len", "2000", "--overlap", "400",
     "--qual-calibration", "real"],
    ["events", "--no-dwell"],
], ids=["raw", "raw-fast-real", "events"])
def test_fastq_matches_scrappie_tpu(fast5, argv):
    import json

    tail = ["--format", "fastq", "--uuid", fast5]
    ours = _fastq_records(_run(torch_main, argv[:1] + ["--device", "cpu"]
                               + argv[1:] + tail)[0])
    ref = _fastq_records(_run(tpu_main, argv + tail)[0])
    assert len(ours) == len(ref) == 1
    (head, seq, plus, qual), (jhead, jseq, jplus, jqual) = ours[0], ref[0]
    assert seq and seq == jseq and plus == jplus == "+"
    assert quals_agree(qual, jqual), qual_diffs(qual, jqual)
    name, meta = head.split(None, 1)
    jname, jmeta = jhead.split(None, 1)
    assert name == jname == "@5e1f-synthetic"
    meta, jmeta = json.loads(meta), json.loads(jmeta)
    assert meta.pop("normalised_score") == pytest.approx(
        jmeta.pop("normalised_score"), rel=1e-5, abs=1e-6)
    assert meta == jmeta


def test_sam_carries_qualities(fast5):
    """SAM's QUAL holds the qualities of a FASTQ call."""
    fq = _fastq_records(_run(torch_main, ["raw", "--device", "cpu", "--format",
                                          "fastq", fast5])[0])[0]
    sam = _run(torch_main, ["raw", "--device", "cpu", "--format", "sam",
                            fast5])[0].rstrip("\n").split("\t")
    assert sam[9] == fq[1] and sam[10] == "*"


@pytest.mark.parametrize("argv,message", [
    (["events", "--format", "fastq"], "--no-dwell"),
    (["raw", "--model", "rnnrf_r94", "--fast", "--format", "fastq"],
     "incompatible with --fast"),
])
def test_fastq_refusals(fast5, argv, message):
    _out, err = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:]
                     + [fast5], code=1)
    assert message in err
