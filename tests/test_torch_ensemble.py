"""Posterior ensembles on the CPU: the port (its plain twins) against the
JAX package on the same seeded inputs and the same in-repo weights.

The fused ensemble kernel's twin is held to scrappie_tpu's Pallas kernel
in interpret mode at a small state space (tracebacks equal, finals within
rtol/atol 1e-5: fp32 softmax sums in another order). The fused paths,
the engine in every mode, the API and the CLI are expected to give the
same paths and bases as scrappie_tpu; these seeds do. Scores are held as
in tests/test_torch_rgrgr.py and tests/test_torch_rnnrf.py."""

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
from scrappie_torch.models.convert import params_from_numpy
from scrappie_torch.models.specs import RAW_MODELS
from scrappie_torch.ops import pipeline as tpipe
from scrappie_torch.ops import viterbi as tv
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_tpu import api as japi
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.models import registry
from scrappie_tpu.ops import pipeline as jpipe
from scrappie_tpu.ops.viterbi import viterbi_fused_ens_tm as j_fused_ens
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal

torch.set_num_threads(1)
TRIO = ("rgrgr_r94", "rgrgr_r941", "rgrgr_r10")
MEMBERS = TRIO[1:]
# five members: beyond the fused ensemble kernel's four, as scrappie_tpu
# takes them (repeated members are allowed)
MEMBERS5 = MEMBERS * 2
W311 = np.array([3.0, 1.0, 1.0]) / 5.0
OPTIONS = dict(stay_pen=0.3, skip_pen=1.1, local_pen=4.0, use_slip=True,
               tempW=1.2, tempb=0.9)


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


def _params(model):
    np_params = registry.load_params(model)
    return ({k: jnp.asarray(v) for k, v in np_params.items()},
            params_from_numpy(np_params, "cpu"))


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("options", [{}, OPTIONS], ids=["plain", "options"])
def test_ensemble_twin_matches_pallas_kernel(K, options):
    """viterbi_fused_ens_tm_plain against _fused_ens_kernel (interpret
    mode) at nhist 64, S 16, T 40, B 3; the JAX call gets the inputs
    lane-padded to 128 (zero features, zero head rows), as its own tests
    pad narrower members."""
    rng = np.random.default_rng(10 + K)
    T, B, S, nstate, Sp = 40, 3, 16, 65, 128
    h = rng.standard_normal((K, T, B, S)).astype(np.float32)
    W = (rng.standard_normal((K, S, nstate)) / 2).astype(np.float32)
    b = rng.standard_normal((K, nstate)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, K)
    w = (w / w.sum()).astype(np.float32)
    jfinal, jtb = j_fused_ens(
        jnp.asarray(np.pad(h, ((0, 0), (0, 0), (0, 0), (0, Sp - S)))),
        jnp.asarray(np.pad(W, ((0, 0), (0, Sp - S), (0, 0)))), jnp.asarray(b),
        jnp.asarray(w), interpret=True, **options)
    final, tb = tv.viterbi_fused_ens_tm(*map(torch.from_numpy, (h, W, b, w)),
                                        **options)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-5,
                               atol=1e-5)


def test_ensemble_twin_is_the_combined_posterior_decoded():
    """The twin decodes ensemble_logpost_tm, whose rows are distributions
    again; a single member with weight 1 is the fused twin's posterior up
    to the renormalisation's rounding."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(np.float32))
    W = torch.from_numpy((rng.standard_normal((2, 16, 65)) / 2).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 65)).astype(np.float32))
    w = torch.tensor([0.75, 0.25])
    lp = tv.ensemble_logpost_tm(h, W, b, w)
    np.testing.assert_allclose(lp.exp().sum(-1).numpy(), 1.0, atol=1e-5)
    for a, c in zip(tv.viterbi_fused_ens_tm_plain(h, W, b, w),
                    tv.viterbi_scores_tm_plain(lp)):
        assert torch.equal(a, c)
    solo = tv.ensemble_logpost_tm(h[:1], W[:1], b[:1], torch.ones(1))
    single = torch.log(1e-5 / 65 + (1 - 1e-5) * torch.softmax(h[0] @ W[0] + b[0], -1))
    np.testing.assert_allclose(solo.numpy(), single.numpy(), atol=1e-6)


@pytest.mark.parametrize("members,stride", [(TRIO, 5), (("raw_r94",) * 2, 4)],
                         ids=["rgrgr_3_1_1", "raw_r94_x2"])
def test_fused_ensemble_matches_jax_at_full_width(members, stride):
    """ensemble_basecall_fused at the published widths: paths equal to
    scrappie_tpu's (its Pallas kernels in interpret mode)."""
    w = W311 if len(members) == 3 else np.array([0.5, 0.5])
    sig = np.random.default_rng(3).standard_normal((2, 400, 1)).astype(np.float32)
    params = [_params(m) for m in members]
    kinds = tuple(RAW_MODELS[m].kind for m in members)
    acts = tuple(RAW_MODELS[m].conv_activation for m in members)
    kw = dict(kinds=kinds, conv_activations=acts, stride=stride, stay_pen=0.3,
              skip_pen=0.2)
    jscore, jpath = jpipe.ensemble_basecall_fused([p[0] for p in params], w,
                                                  jnp.asarray(sig), **kw)
    score, path = tpipe.ensemble_basecall_fused([p[1] for p in params], w,
                                                torch.from_numpy(sig), **kw)
    assert path.dtype == torch.int16
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5,
                               atol=2e-4)


@pytest.mark.parametrize("emit_bias", [0.0, -0.5])
def test_rnnrf_fused_ensemble_matches_jax(emit_bias):
    """rnnrf_ensemble_basecall_fused (two members, weights 3:1) against
    scrappie_tpu's; the self-ensemble at 1:1 is the solo fast path."""
    jp, tp = _params("rnnrf_r94")
    sig = np.random.default_rng(11).standard_normal((2, 240, 1)).astype(np.float32)
    w = np.array([0.75, 0.25], np.float32)
    kw = dict(conv_activations=("elu", "elu"), stride=2, emit_bias=emit_bias)
    jscore, jpath = jpipe.rnnrf_ensemble_basecall_fused([jp, jp], w,
                                                        jnp.asarray(sig), **kw)
    score, path = tpipe.rnnrf_ensemble_basecall_fused([tp, tp], w,
                                                      torch.from_numpy(sig), **kw)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=0,
                               atol=2e-5 * 120)
    solo = tpipe.rnnrf_basecall_fused(tp, torch.from_numpy(sig),
                                      emit_bias=emit_bias)
    for a, c in zip(tpipe.rnnrf_ensemble_basecall_fused(
            [tp, tp], [0.5, 0.5], torch.from_numpy(sig), **kw), solo):
        assert torch.equal(a, c)


def _signals(seed, lengths):
    return [RawSignal(synthetic_signal(n, seed=seed + i), uuid=f"r{i}")
            for i, n in enumerate(lengths)]


def _same_calls(jres, tres, score_tol):
    for j, t in zip(jres, tres):
        assert t.sequence and t.sequence == j.sequence
        assert (t.uuid, t.nblock, t.trim_start, t.trim_end, t.nsample) == \
            (j.uuid, j.nblock, j.trim_start, j.trim_end, j.nsample)
        np.testing.assert_array_equal(t.pos, j.pos)
        assert abs(t.score - j.score) <= score_tol(j)


@pytest.mark.parametrize("mode,homopolymer", [("fast", "nochange"),
                                              ("stitch", "nochange"),
                                              ("stitch", "mean")])
def test_engine_ensemble_matches_jax(mode, homopolymer):
    """The rgrgr 3:1:1 ensemble through the engine in fast, device-stitch
    and host-stitch mode."""
    signals = _signals(200, (2600, 3400, 1500))
    kw = dict(chunk_len=2000, overlap=200, mode=mode, ensemble=MEMBERS)
    jres = JEngine(TRIO[0], **kw).basecall_signals(signals, homopolymer=homopolymer)
    tres = TEngine(TRIO[0], device="cpu", **kw).basecall_signals(
        signals, homopolymer=homopolymer)
    _same_calls(jres, tres, lambda j: 1e-5 * abs(j.score) + 1e-3)


@pytest.mark.parametrize("mode", ["fast", "stitch"])
def test_engine_rnnrf_self_ensemble_matches_jax_and_the_solo_model(mode):
    signals = _signals(400, (2600, 1500))
    kw = dict(chunk_len=1000, overlap=100, mode=mode)
    ens = dict(ensemble=("rnnrf_r94",), ensemble_weights=(1.0, 1.0))
    jres = JEngine("rnnrf_r94", **kw, **ens).basecall_signals(signals)
    tres = TEngine("rnnrf_r94", device="cpu", **kw, **ens).basecall_signals(signals)
    _same_calls(jres, tres, lambda j: 2e-5 * j.nblock)
    solo = TEngine("rnnrf_r94", device="cpu", **kw).basecall_signals(signals)
    assert [r.sequence for r in solo] == [r.sequence for r in tres]


def test_engine_posterior_is_the_weighted_combination():
    """The engine's combined posterior: member log posteriors weighted
    3:1:1 in member order, then less their log-sum-exp per block (the
    JAX engine's combination)."""
    eng = TEngine(TRIO[0], device="cpu", ensemble=MEMBERS)
    jeng = JEngine(TRIO[0], ensemble=MEMBERS)
    x = np.random.default_rng(0).standard_normal((2, 200, 1)).astype(np.float32)
    got = eng._posterior(torch.from_numpy(x)).numpy()
    want = np.asarray(jeng._posterior(jeng.params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(ensemble=MEMBERS),
    dict(ensemble=("rgrgr_r10",), ensemble_weights=(3.0, 1.0),
         calibration="real"),
    dict(model="rnnrf_r94", ensemble=("rnnrf_r94",), ensemble_weights=(1, 1),
         with_base_probs=True),
], ids=["rgrgr_3_1_1", "rgrgr_r10_real_preset", "rnnrf_self"])
def test_api_ensemble_matches_jax(kw):
    data = synthetic_signal(3000, seed=5)
    jseq, jscore, jpos, jstart, jend, jprobs = japi.basecall_raw(data, **kw)
    seq, score, pos, start, end, probs = tapi.basecall_raw(data, device="cpu", **kw)
    assert seq and seq == jseq and (start, end) == (jstart, jend)
    np.testing.assert_array_equal(pos, jpos)
    assert abs(score - jscore) <= 2e-5 * len(pos) + 1e-3
    if kw.get("with_base_probs"):
        np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-4)


def test_real_preset_drops_the_skip_penalty_with_members():
    """rgrgr_r94's real preset has skip_pen 0.5; with members it is 0, as
    in scrappie_tpu, so the call equals one with stay_pen 0.5 alone."""
    data = synthetic_signal(2600, seed=8)
    ens = dict(ensemble=MEMBERS, device="cpu")
    real = tapi.basecall_raw(data, calibration="real", **ens)[0]
    assert real == tapi.basecall_raw(data, stay_pen=0.5, skip_pen=0.0, **ens)[0]


def _write_fast5(path, n: int, seed: int, read_id: str) -> None:
    adc = np.round(synthetic_signal(n, seed) / (1400.0 / 8192.0) - 10.0)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_9")
        grp.create_dataset("Signal", data=adc.astype(np.int16))
        grp.attrs["read_id"] = read_id
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = 8192.0
        meta["range"] = 1400.0
        meta["offset"] = 10.0
        meta["sampling_rate"] = 4000.0


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), err.getvalue()

def same_fasta(ours: str, ref: str) -> None:
    """FASTA records with the same names, sequences and header fields; the
    normalised score within relative 1e-5 (fp32 sums in another order)."""
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b) and len(a) % 2 == 0 and a
    for (ha, sa), (hb, sb) in zip(zip(a[::2], a[1::2]), zip(b[::2], b[1::2])):
        assert sa and sa == sb
        name_a, meta_a = ha.split("  ", 1)
        name_b, meta_b = hb.split("  ", 1)
        meta_a, meta_b = json.loads(meta_a), json.loads(meta_b)
        sa_, sb_ = meta_a.pop("normalised_score"), meta_b.pop("normalised_score")
        assert name_a == name_b and meta_a == meta_b
        assert abs(sa_ - sb_) <= 1e-5 * abs(sb_)



@pytest.mark.parametrize("extra", [[], ["--fast", "--ensemble-weights", "2,1,1"]],
                         ids=["stitch", "fast_weights"])
def test_cli_ensemble_fasta_matches_scrappie_tpu(tmp_path, extra):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 3200, seed=6, read_id="5e1f-ensemble")
    argv = ["raw", "--ensemble", "rgrgr_r941,rgrgr_r10", "--chunk-len", "2000",
            "--overlap", "200", *extra, str(path)]
    code, ours, _ = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    jcode, ref, _ = _run(tpu_main, argv)
    assert code == jcode == 0
    same_fasta(ours, ref)


@pytest.mark.parametrize("flags", [["--ensemble-weights", "1,1"],
                                   ["--ensemble", "raw_r94"],
                                   ["--ensemble", "rgrgr_r10",
                                    "--ensemble-weights", "1,-1"]],
                         ids=["weights_alone", "stride_mismatch", "bad_weight"])
def test_cli_refuses_bad_ensembles_as_scrappie_tpu_does(tmp_path, flags):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 1200, seed=7, read_id="r")
    argv = ["raw", *flags, str(path)]
    code, out, err = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    jcode, jout, jerr = _run(tpu_main, argv)
    assert code == jcode == 1 and out == jout == ""
    assert err.strip() == jerr.strip().splitlines()[-1]


def _check_decode_layouts(monkeypatch) -> set:
    """Put the projection, GRU recurrence, head, forward and backtrace
    kernels' input checks in front of their twins; returns the set of the names of the twins that ran."""
    from scrappie_torch import ops
    from scrappie_torch.nn import rnn as trnn
    from scrappie_torch.ops import gru as tgru
    from scrappie_torch.ops import project as tproject

    seen = set()

    def checked(module, name, check):
        plain = getattr(module, name)

        def run(*args, **kwargs):
            check(*args)
            seen.add(name)
            return plain(*args, **kwargs)
        monkeypatch.setattr(module, name, run)

    def check_backtrace(final, tb):
        T, B, n = tb.shape
        ops.check_kernel_input("final", final, (B, n))
        ops.check_kernel_input("tb", tb, (T, B, n), torch.int16)

    checked(tv, "head_logpost_tm_plain",
            lambda h, W, b, w=None, *_: tv.check_head_input(h, W, b, w))
    checked(tv, "viterbi_scores_tm_plain",
            lambda lp, *_: ops.check_kernel_input("lp", lp, tuple(lp.shape)))
    checked(tv, "viterbi_backtrace_tm_plain", check_backtrace)
    checked(tproject, "feedforward", tproject.check_project_input)
    checked(trnn, "gru_tm",
            lambda x, sW, sW2, *_: tgru.check_gru_recurrence_input(x, sW, sW2))
    return seen


TWINS = {"head_logpost_tm_plain", "viterbi_scores_tm_plain",
         "viterbi_backtrace_tm_plain", "feedforward", "gru_tm"}


def test_engine_hands_the_ensemble_kernel_its_layout(monkeypatch):
    """On a CUDA tensor the GRU, head, forward and backtrace wrappers raise
    unless their inputs are contiguous and of the kernels' types; the CPU
    twins take any layout. So the twins here run the kernels' input checks
    first: the engine's fast ensemble path must already pass them."""
    seen = _check_decode_layouts(monkeypatch)
    engine = TEngine(TRIO[0], device="cpu", chunk_len=1000, overlap=100,
                     mode="fast", ensemble=MEMBERS)
    assert all(r.sequence for r in engine.basecall_signals(_signals(700, (2300, 1400))))
    assert seen == TWINS


def test_kernel_input_check_refuses_what_the_kernel_cannot_take():
    h = torch.zeros((5, 3, 2, 16))
    W, b, w = torch.zeros((5, 16, 65)), torch.zeros((5, 65)), torch.ones(5) / 5
    with pytest.raises(ValueError, match="1 to 4 members"):
        tv.check_fused_ens_input(h, W, b, w)
    with pytest.raises(ValueError, match="contiguous"):
        tv.check_fused_ens_input(h[:2].transpose(1, 2), W[:2], b[:2], w[:2])
    with pytest.raises(ValueError, match="nhist"):
        tv.check_fused_ens_input(h[:2], W[:2, :, :40], b[:2, :40], w[:2])
    tv.check_fused_ens_input(h[:3], W[:3], b[:3], w[:3])


def test_head_twin_matches_pallas_ensemble_kernel_at_k5():
    """The paths' route for five members on the CPU, the head twin's
    combined log posterior decoded by the forward twin, against
    scrappie_tpu's _fused_ens_kernel (interpret mode) at nhist 64, S 16,
    T 30, B 3, inputs lane-padded to 128 as in the K = 2, 3 test:
    tracebacks equal, finals within rtol/atol 1e-5."""
    rng = np.random.default_rng(15)
    K, T, B, S, nstate, Sp = 5, 30, 3, 16, 65, 128
    h = rng.standard_normal((K, T, B, S)).astype(np.float32)
    W = (rng.standard_normal((K, S, nstate)) / 2).astype(np.float32)
    b = rng.standard_normal((K, nstate)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, K)
    w = (w / w.sum()).astype(np.float32)
    jfinal, jtb = j_fused_ens(
        jnp.asarray(np.pad(h, ((0, 0), (0, 0), (0, 0), (0, Sp - S)))),
        jnp.asarray(np.pad(W, ((0, 0), (0, Sp - S), (0, 0)))), jnp.asarray(b),
        jnp.asarray(w), interpret=True, **OPTIONS)
    head = {k: OPTIONS[k] for k in ("tempW", "tempb")}
    dp = {k: v for k, v in OPTIONS.items() if k not in head}
    lp = tv.head_logpost_tm(*map(torch.from_numpy, (h, W, b, w)), **head)
    final, tb = tv.viterbi_scores_tm(lp, **dp)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-5,
                               atol=1e-5)


def test_fused_ensemble_of_five_matches_jax():
    """ensemble_basecall_fused with five rgrgr members (3:1:1:1:1) at the
    published widths: paths equal to scrappie_tpu's."""
    members = (TRIO[0],) + MEMBERS5
    w = np.array([3.0, 1, 1, 1, 1]) / 7.0
    sig = np.random.default_rng(5).standard_normal((2, 300, 1)).astype(np.float32)
    params = {m: _params(m) for m in TRIO}
    kw = dict(kinds=("rgrgr",) * 5, conv_activations=("elu",) * 5, stride=5,
              stay_pen=0.3, skip_pen=0.2)
    jscore, jpath = jpipe.ensemble_basecall_fused([params[m][0] for m in members],
                                                  w, jnp.asarray(sig), **kw)
    score, path = tpipe.ensemble_basecall_fused([params[m][1] for m in members], w,
                                                torch.from_numpy(sig), **kw)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5,
                               atol=2e-4)


def test_engine_ensemble_of_five_matches_jax():
    """BasecallEngine("rgrgr_r94", ensemble=MEMBERS5) in fast mode, which
    the fused ensemble kernel (at most four members) could not run."""
    signals = _signals(210, (2600, 1500))
    kw = dict(chunk_len=2000, overlap=200, mode="fast", ensemble=MEMBERS5)
    jres = JEngine(TRIO[0], **kw).basecall_signals(signals)
    tres = TEngine(TRIO[0], device="cpu", **kw).basecall_signals(signals)
    _same_calls(jres, tres, lambda j: 1e-5 * abs(j.score) + 1e-3)


def test_api_ensemble_of_five_matches_jax():
    data = synthetic_signal(2800, seed=9)
    kw = dict(ensemble=MEMBERS5)
    jseq, jscore, jpos, jstart, jend, _ = japi.basecall_raw(data, **kw)
    seq, score, pos, start, end, _ = tapi.basecall_raw(data, device="cpu", **kw)
    assert seq and seq == jseq and (start, end) == (jstart, jend)
    np.testing.assert_array_equal(pos, jpos)
    assert abs(score - jscore) <= 2e-5 * len(pos) + 1e-3


def test_cli_fast_ensemble_of_five_matches_scrappie_tpu(tmp_path):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 3000, seed=12, read_id="5e1f-five")
    argv = ["raw", "--fast", "--ensemble", ",".join(MEMBERS5), "--chunk-len",
            "2000", "--overlap", "200", str(path)]
    code, ours, _ = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    jcode, ref, _ = _run(tpu_main, argv)
    assert code == jcode == 0
    same_fasta(ours, ref)


def test_engine_hands_the_head_kernel_its_layout_at_k5(monkeypatch):
    """The engine's fast path with five members passes the GRU, head,
    forward and backtrace kernels' input checks (in front of the twins)."""
    seen = _check_decode_layouts(monkeypatch)
    engine = TEngine(TRIO[0], device="cpu", chunk_len=1000, overlap=100,
                     mode="fast", ensemble=MEMBERS5)
    assert all(r.sequence for r in engine.basecall_signals(_signals(710, (1900,))))
    assert seen == TWINS


@pytest.mark.parametrize("model", ["rgrgr_r94", "raw_r94"])
def test_engine_hands_the_head_kernel_its_layout(monkeypatch, model):
    """A single transducer's fast path (the main path for rgrgr_r94) passes
    the projection, GRU recurrence, head, forward and backtrace kernels'
    input checks (in front of the twins)."""
    seen = _check_decode_layouts(monkeypatch)
    engine = TEngine(model, device="cpu", chunk_len=1000, overlap=100,
                     mode="fast")
    assert all(r.sequence for r in engine.basecall_signals(_signals(720, (2100,))))
    assert seen == TWINS
