"""rgrgr_r94 end to end on the CPU: the port (its plain twins) against
the JAX package on the same seeded signals and the same in-repo weights.

The posterior is held to 1e-5 (fp32, sums in another order). Sequences
are expected to be identical; these seeds give identical calls in every
path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import api as tapi
from scrappie_torch.models.convert import params_from_numpy
from scrappie_torch.models.forward import RgrgrModel
from scrappie_torch.models.forward import rgrgr_posterior as t_posterior
from scrappie_torch.ops.pipeline import rgrgr_basecall_fused as t_fused
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_tpu import api as japi
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.ops.pipeline import rgrgr_basecall_fused as j_fused
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal

torch.set_num_threads(1)
MODEL = "rgrgr_r94"


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


@pytest.fixture(scope="module")
def params_np():
    return registry.load_params(MODEL)


@pytest.mark.parametrize("nsample", [60, 301])
def test_posterior_matches_jax_at_full_width(params_np, nsample):
    rng = np.random.default_rng(nsample)
    sig = rng.standard_normal((2, nsample, 1)).astype(np.float32)
    ref = np.asarray(jforward.rgrgr_posterior(
        {k: jnp.asarray(v) for k, v in params_np.items()}, jnp.asarray(sig),
        conv_activation="elu", stride=5))
    out = t_posterior(params_from_numpy(params_np, "cpu"), torch.from_numpy(sig),
                      conv_activation="elu", stride=5).numpy()
    assert out.shape == ref.shape == (2, -(-nsample // 5), 1025)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_model_module_matches_function(params_np):
    model = RgrgrModel.from_registry(MODEL, "cpu")
    sig = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 120, 1)).astype(np.float32))
    expect = t_posterior(params_from_numpy(params_np, "cpu"), sig)
    assert torch.equal(model(sig), expect)


@pytest.mark.parametrize("pens", [dict(), dict(stay_pen=0.3, skip_pen=0.6,
                                              local_pen=3.0, use_slip=True)])
def test_fused_pipeline_matches_jax(params_np, pens):
    sig = np.random.default_rng(7).standard_normal((2, 60, 1)).astype(np.float32)
    jscore, jpath = j_fused({k: jnp.asarray(v) for k, v in params_np.items()},
                            jnp.asarray(sig), conv_activation="elu", stride=5,
                            **pens)
    score, path = t_fused(params_from_numpy(params_np, "cpu"),
                          torch.from_numpy(sig), **pens)
    assert path.dtype == torch.int16
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5,
                               atol=1e-4)


def test_basecall_raw_matches_jax():
    for i, n in enumerate((2500, 3300, 4100)):
        data = synthetic_signal(n, seed=100 + i)
        jseq, jscore, jpos, jstart, jend, _ = japi.basecall_raw(data)
        seq, score, pos, start, end, _ = tapi.basecall_raw(data, device="cpu")
        assert seq and seq == jseq
        assert (start, end) == (jstart, jend)
        np.testing.assert_array_equal(pos, jpos)
        assert abs(score - jscore) <= 1e-5 * abs(jscore) + 1e-3


def test_calc_post_and_decode_post_match_jax():
    data = synthetic_signal(1800, seed=7)
    jraw = japi.RawTable(data).trim().scale()
    raw = tapi.RawTable(data).trim().scale()
    assert (raw.start, raw.end) == (jraw.start, jraw.end)
    jpost = japi.calc_post(jraw, MODEL)
    post = tapi.calc_post(raw, MODEL, device="cpu")
    np.testing.assert_allclose(post.data(), jpost.data(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(post.data(as_numpy=True, sloika=True)[:, 0],
                                  post.data()[:, -1])
    kw = dict(stay_pen=0.1, skip_pen=0.2, homopolymer="mean")
    seq, score, _ = tapi.decode_post(post, MODEL, device="cpu", **kw)
    jseq, jscore, _ = japi.decode_post(jpost, MODEL, **kw)
    assert seq == jseq and abs(score - jscore) <= 1e-5 * abs(jscore) + 1e-3


@pytest.mark.parametrize("model", ["raw_r94", "nanonet_events"])
def test_other_model_kinds_are_not_ported_yet(model):
    """What basecall_raw refuses, as scrappie_tpu does: raw_r94 (stride 4)
    as a member of an rgrgr_r94 (stride 5) ensemble, whose block grids do
    not align (raw_r94 alone is tests/test_torch_raw.py's); the events
    model, which basecalls from events (api.basecall_events), not raw
    signal."""
    data = synthetic_signal(500, 0)
    if model == "raw_r94":
        with pytest.raises(ValueError, match="block grids must align"):
            japi.basecall_raw(data, ensemble=(model,))
        with pytest.raises(ValueError, match="block grids must align"):
            tapi.basecall_raw(data, ensemble=(model,), device="cpu")
    else:
        with pytest.raises(ValueError, match="basecall_events"):
            tapi.basecall_raw(data, model=model, device="cpu")


@pytest.mark.parametrize("mode,homopolymer", [("fast", "nochange"),
                                              ("stitch", "nochange"),
                                              ("stitch", "mean")])
def test_engine_matches_jax(mode, homopolymer):
    signals = [RawSignal(synthetic_signal(n, seed=200 + i), uuid=f"r{i}")
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
