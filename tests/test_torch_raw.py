"""raw_r94 end to end on the CPU, and the GRU recurrence kernel's twin: the
port (its plain twins) against the JAX package on the same seeded inputs
and the same in-repo weights.

raw_r94 at its published widths: conv window 11, stride 4, 96 filters and
tanh, two stages of forward and backward GRU layers of 96 combined by
feedforward2_tanh, the FF3 head over 1025 states. The log posterior is held
to rtol/atol 1e-5 (fp32, sums in another order; seen: at most 1.4e-5 on
entries near -12). Paths and sequences are expected to be identical; these
seeds give identical calls in every path. The GRU recurrence is held to
1e-5, as tests/test_torch_gru.py holds the layer."""

import contextlib
import io
import json

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import api as tapi
from scrappie_torch import ops
from scrappie_torch.cli.main import main as torch_main
from scrappie_torch.models.convert import params_from_numpy
from scrappie_torch.models.forward import RawR94Model, load_model
from scrappie_torch.models.forward import raw_posterior as t_posterior
from scrappie_torch.nn.rnn import gru_tm as gru_tm_twin
from scrappie_torch.ops.gru import gru_tm as t_gru_tm
from scrappie_torch.ops.pipeline import raw_basecall_fused as t_fused
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_tpu import api as japi
from scrappie_tpu import ops as jops
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.ops.gru import gru_tm_padded, pad_gru_params
from scrappie_tpu.ops.pipeline import raw_basecall_fused as j_fused
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal

torch.set_num_threads(1)
MODEL = "raw_r94"
TOL = dict(rtol=1e-5, atol=1e-5)


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


@pytest.fixture(scope="module")
def params_np():
    return registry.load_params(MODEL)


@pytest.fixture(scope="module")
def jparams(params_np):
    return {k: jnp.asarray(v) for k, v in params_np.items()}


def test_weights_load_unchanged(params_np):
    keys = {"conv_W", "conv_b", "FF3_W", "FF3_b"} | {
        f"FF{i}_{k}" for i in (1, 2) for k in ("Wf", "Wb", "b")} | {
        f"gru{d}{i}_{k}" for d in "FB" for i in (1, 2)
        for k in ("iW", "b", "sW", "sW2")}
    assert keys == set(params_np)
    net = RawR94Model.from_registry(device="cpu")
    assert net.stride == 4
    assert net.conv_W.shape == (11, 1, 96) and net.FF3_W.shape == (96, 1025)
    for k, v in params_np.items():
        np.testing.assert_array_equal(net.params[k].numpy(), v)
    assert isinstance(load_model(MODEL, "cpu"), RawR94Model)
    with pytest.raises(ValueError, match="rgrgr"):
        RawR94Model.from_registry("rgrgr_r94", "cpu")


@pytest.mark.parametrize("nsample", [60, 301])
def test_posterior_matches_jax_at_full_width(params_np, jparams, nsample):
    sig = np.random.default_rng(nsample).standard_normal(
        (2, nsample, 1)).astype(np.float32)
    with jops.pallas(False):
        ref = np.asarray(jforward.raw_posterior(jparams, jnp.asarray(sig),
                                                stride=4))
    out = t_posterior(params_from_numpy(params_np, "cpu"),
                      torch.from_numpy(sig)).numpy()
    assert out.shape == ref.shape == (2, -(-nsample // 4), 1025)
    np.testing.assert_allclose(out, ref, **TOL)


def test_model_module_matches_function(params_np):
    model = RawR94Model.from_registry(MODEL, "cpu")
    sig = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 120, 1)).astype(np.float32))
    expect = t_posterior(params_from_numpy(params_np, "cpu"), sig)
    assert torch.equal(model(sig), expect)
    lin = model(sig, return_log=False)
    np.testing.assert_allclose(lin.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("pens", [dict(), dict(stay_pen=0.3, skip_pen=0.6,
                                              local_pen=3.0, use_slip=True)])
def test_fused_pipeline_matches_jax(params_np, jparams, pens):
    sig = np.random.default_rng(7).standard_normal((2, 240, 1)).astype(np.float32)
    jscore, jpath = j_fused(jparams, jnp.asarray(sig), stride=4, **pens)
    score, path = t_fused(params_from_numpy(params_np, "cpu"),
                          torch.from_numpy(sig), **pens)
    assert path.dtype == torch.int16 and path.shape == (2, 61)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5,
                               atol=1e-4)
    model = RawR94Model.from_registry(MODEL, "cpu")
    for a, b in zip(model.basecall_fused(torch.from_numpy(sig), **pens),
                    (score, path)):
        assert torch.equal(a, b)


def test_basecall_raw_matches_jax():
    for i, n in enumerate((2500, 3300)):
        data = synthetic_signal(n, seed=600 + i)
        jseq, jscore, jpos, jstart, jend, _ = japi.basecall_raw(data, MODEL)
        seq, score, pos, start, end, _ = tapi.basecall_raw(data, MODEL,
                                                           device="cpu")
        assert seq and seq == jseq
        assert (start, end) == (jstart, jend)
        np.testing.assert_array_equal(pos, jpos)
        assert abs(score - jscore) <= 1e-5 * abs(jscore) + 1e-3


def test_calc_post_and_decode_post_match_jax():
    data = synthetic_signal(1800, seed=17)
    jraw = japi.RawTable(data).trim().scale()
    raw = tapi.RawTable(data).trim().scale()
    jpost = japi.calc_post(jraw, MODEL)
    post = tapi.calc_post(raw, MODEL, device="cpu")
    assert post.shape == jpost.shape and post.shape[1] == 1025
    np.testing.assert_allclose(post.data(), jpost.data(), **TOL)
    kw = dict(stay_pen=1.0, homopolymer="mean")
    seq, score, _ = tapi.decode_post(post, MODEL, device="cpu", **kw)
    jseq, jscore, _ = japi.decode_post(jpost, MODEL, **kw)
    assert seq and seq == jseq and abs(score - jscore) <= 1e-5 * abs(jscore) + 1e-3


@pytest.mark.parametrize("mode,homopolymer", [("fast", "nochange"),
                                              ("stitch", "nochange"),
                                              ("stitch", "mean")])
def test_engine_matches_jax(mode, homopolymer):
    signals = [RawSignal(synthetic_signal(n, seed=620 + i), uuid=f"r{i}")
               for i, n in enumerate((2600, 3400, 1500))]
    kw = dict(chunk_len=2000, overlap=200, mode=mode)
    jres = JEngine(MODEL, **kw).basecall_signals(signals, homopolymer=homopolymer)
    tres = TEngine(MODEL, device="cpu", **kw).basecall_signals(
        signals, homopolymer=homopolymer)
    for j, t in zip(jres, tres):
        assert t.sequence and t.sequence == j.sequence
        assert (t.uuid, t.nblock, t.trim_start, t.trim_end, t.nsample) == \
            (j.uuid, j.nblock, j.trim_start, j.trim_end, j.nsample)
        np.testing.assert_array_equal(t.pos, j.pos)
        assert abs(t.score - j.score) <= 1e-5 * abs(j.score) + 1e-3


def _write_fast5(path, n: int, seed: int, read_id: str) -> None:
    adc = np.round(synthetic_signal(n, seed) / (1400.0 / 8192.0) - 10.0)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_4")
        grp.create_dataset("Signal", data=adc.astype(np.int16))
        grp.attrs["read_id"] = read_id
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = 8192.0
        meta["range"] = 1400.0
        meta["offset"] = 10.0
        meta["sampling_rate"] = 4000.0


def _run(main, argv) -> str:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    assert code == 0, err.getvalue()
    return out.getvalue()

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



@pytest.mark.parametrize("extra", [[], ["--fast", "--calibration", "real"]])
def test_cli_matches_scrappie_tpu(tmp_path, extra):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 3000, seed=16, read_id="5e1f-raw")
    argv = ["raw", "--model", MODEL, "--chunk-len", "2000", "--overlap", "200",
            *extra, str(path)]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    same_fasta(ours, ref)


def _pad_gates(x, S, Sp):
    """[..., 3S] -> [..., 3Sp]: each gate block zero-padded to Sp lanes."""
    pad = [(0, 0)] * (x.ndim - 1) + [(0, Sp - S)]
    return np.concatenate([np.pad(g, pad) for g in np.split(x, 3, axis=-1)], -1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [16, 13])
def test_gru_recurrence_matches_pallas_kernel(reverse, T):
    """ops/gru.gru_tm (on the CPU: nn/rnn.gru_tm) against gru_tm_padded in
    interpret mode, on inputs lane-padded to 128 per gate block; T = 13 is
    not a multiple of the kernel's 8 time steps per grid step."""
    rng = np.random.default_rng(30 + T)
    B, S = 8, 96
    x = rng.standard_normal((T, B, 3 * S)).astype(np.float32)
    iW = np.zeros((1, 3 * S), np.float32)
    b = np.zeros(3 * S, np.float32)
    sW = (rng.standard_normal((S, 2 * S)) * 0.3).astype(np.float32)
    sW2 = (rng.standard_normal((S, S)) * 0.3).astype(np.float32)
    _, _, sWp, sW2p = pad_gru_params(*map(jnp.asarray, (iW, b, sW, sW2)))
    ref = np.asarray(gru_tm_padded(jnp.asarray(_pad_gates(x, S, 128)), sWp, sW2p,
                                   reverse=reverse, interpret=True))
    assert ref.shape == (T, B, 128)
    ops.reset_launches()
    out = t_gru_tm(*map(torch.from_numpy, (x, sW, sW2)), reverse=reverse)
    assert ops.LAUNCHES["gru_recurrence"] == 0  # a CPU tensor takes the twin
    assert out.shape == (T, B, S)
    np.testing.assert_allclose(out.numpy(), ref[..., :S], **TOL)
    assert torch.equal(out, gru_tm_twin(*map(torch.from_numpy, (x, sW, sW2)),
                                        reverse))
