"""The port's precision policy (scrappie_torch/nn/config.py) against the
JAX package's (scrappie_tpu/nn/config.py) on the CPU.

'bf16' rounds each product's operands to bfloat16 and sums in fp32 on any
device, as the JAX package's 'bf16' does; the products of bfloat16
operands are exact in fp32, so the port and the JAX scan path
(ops.pallas(False): the JAX package's Pallas kernels in interpret mode do
not round) differ only in the order of their sums. 'default' is TF32 on
the card and plain fp32 on the CPU, where it must equal 'highest' bit for
bit. The kernels' TF32 rounding (cvt.rna.tf32.f32) is emulated bit for bit
on int32 views by the twins; its bit patterns are checked here against a
rounding computed in exact rationals."""

import fractions
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch.models.convert import params_from_numpy
from scrappie_torch.models.forward import rgrgr_posterior as t_rgrgr_posterior
from scrappie_torch.nn import config
from scrappie_torch.nn import layers as tl
from scrappie_torch.ops.gru import gru_layer_tm
from scrappie_torch.ops.lstm import lstm_pair_tm
from scrappie_tpu import ops as jops
from scrappie_tpu.models import forward as jforward
from scrappie_tpu.models import registry
from scrappie_tpu.nn import config as jconfig
from scrappie_tpu.nn import layers as jl
from scrappie_tpu.nn import rnn as jrnn

torch.set_num_threads(1)
#: Layer outputs in 'bf16' against the JAX scan path in 'bf16': the same
#: rounded operands, fp32 sums in another order (seen: a few 1e-6).
LAYER_TOL = 1e-3


@pytest.fixture(autouse=True)
def _restore_policies():
    jold = (jconfig.get_precision(), jconfig.bf16_emulation())
    yield
    config.set_precision("highest")
    jconfig._PRECISION, jconfig._BF16_EMULATE = jold


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_pmatmul_bf16_matches_manual_cast_and_jax_pdot():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    w = rng.standard_normal((96, 48)).astype(np.float32)
    with config.precision("bf16"):
        assert config.bf16_emulation()
        got = config.pmatmul(_t(x), _t(w)).numpy()
    manual = (_t(x).to(torch.bfloat16).float() @ _t(w).to(torch.bfloat16).float())
    np.testing.assert_array_equal(got, manual.numpy())
    exact = config.pmatmul(_t(x), _t(w)).numpy()
    assert np.abs(exact - got).max() > 0  # the mode is live
    with jconfig.precision("bf16"):
        ref = np.asarray(jconfig.pdot(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_conv_operands_rounded_in_bf16_mode():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((600, 1)).astype(np.float32)
    W = rng.standard_normal((11, 1, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    with config.precision("bf16"):
        got = tl.conv1d(_t(x), _t(W), _t(b), 2).numpy()
        xr, Wr = config.pconv_operands(_t(x), _t(W))
    want = tl.conv1d(_t(_bf16(x)), _t(_bf16(W)), _t(b), 2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(xr.numpy(), _bf16(x))
    np.testing.assert_array_equal(Wr.numpy(), _bf16(W))


def test_precision_context_restores_the_mode_and_the_flags():
    assert config.get_precision() == "highest"
    with config.precision("bf16"):
        with config.precision("default"):
            assert config.get_precision() == "default"
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        assert config.bf16_emulation()
        assert not torch.backends.cuda.matmul.allow_tf32
    assert config.get_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError, match="unknown precision"):
        config.set_precision("fp8")


@pytest.mark.parametrize("mode,cpu,cuda", [
    ("highest", None, None), ("default", None, "tf32"), ("bf16", "bf16", "bf16")])
def test_kernel_rounding_of_each_mode(mode, cpu, cuda):
    with config.precision(mode):
        assert config.kernel_rounding(torch.device("cpu")) == cpu
        assert config.kernel_rounding("cuda") == cuda
        assert config.kernel_rounding("cuda:1") == cuda
    assert [config.rounding_code(r) for r in config.ROUNDINGS] == [0, 1, 2]


@pytest.mark.parametrize("mode", ["default", "bf16", " BF16 "])
def test_env_var_sets_the_mode_at_import(mode):
    env = dict(os.environ, SCRAPPIE_TORCH_PRECISION=mode)
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; from scrappie_torch.nn import config; "
         "print(config.get_precision(), torch.backends.cuda.matmul.allow_tf32)"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    want = mode.strip().lower()
    assert out.stdout.split() == [want, str(want == "default")]


def test_cli_precision_flag_holds_for_the_command(monkeypatch):
    from scrappie_torch.cli import main as cli

    seen = []
    monkeypatch.setitem(cli._COMMANDS, "squiggle",
                        lambda args: seen.append(config.get_precision()) or 0)
    assert cli.main(["squiggle", "--device", "cpu", "--precision", "bf16",
                     "x.fa"]) == 0
    assert cli.main(["squiggle", "--device", "cpu", "x.fa"]) == 0
    assert seen == ["bf16", "highest"]
    assert config.get_precision() == "highest"


def _tf32_exact(v: float) -> float:
    """v rounded to TF32 in exact rationals: 10 mantissa bits, ties away
    from zero, the subnormal range at TF32's exponent floor (-126), and
    past the largest finite TF32 value an infinity."""
    if math.isnan(v) or math.isinf(v) or v == 0.0:
        return v
    mag = fractions.Fraction(abs(v))
    e = max(math.floor(math.log2(abs(v))), -126)
    while fractions.Fraction(2) ** e > mag:
        e -= 1
    while fractions.Fraction(2) ** (e + 1) <= mag:
        e += 1
    e = max(e, -126)
    ulp = fractions.Fraction(2) ** (e - 10)
    q = mag / ulp
    n = math.floor(q)
    if q - n >= fractions.Fraction(1, 2):
        n += 1
    r = n * ulp
    if r >= fractions.Fraction(2) ** 128:
        return math.copysign(math.inf, v)
    return math.copysign(float(r), v)


BITS = [
    0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F801001, 0x3F802000, 0x3F803000,
    0x3FFFF000, 0x3FFFFFFF, 0x407FF000, 0xBF801000, 0xBFFFF000, 0x7F7FFFFF,
    0x7F7FEFFF, 0x7F7FF000, 0xFF7FFFFF, 0x00000001, 0x00001000, 0x00000FFF,
    0x007FF000, 0x007FFFFF, 0x80001000, 0x00000000, 0x80000000, 0x7F800000,
    0xFF800000, 0x7FC00000, 0x7F800001, 0xFFC01234, 0x4049_0FDB, 0x3DCCCCCD,
]


def test_tf32_rounding_on_hand_picked_bit_patterns():
    """Ties (low 13 bits 0x1000) away from zero, one below a tie down, a
    carry through the mantissa into the exponent, the largest finite
    values to infinity, subnormals, signed zeros, infinities and NaNs."""
    bits = np.array(BITS, dtype=np.uint32)
    x = torch.from_numpy(bits.view(np.int32).copy()).view(torch.float32)
    got = config.round_operand(x, "tf32").view(torch.int32).numpy()
    got = got.view(np.uint32)
    for b, g in zip(bits, got):
        v = float(np.array([b], dtype=np.uint32).view(np.float32)[0])
        w = np.float32(_tf32_exact(v))
        if math.isnan(v):
            assert g == b, hex(b)  # NaNs pass through unchanged
            continue
        assert g == np.array([w], np.float32).view(np.uint32)[0], (hex(b), hex(g))
        assert g & 0x1FFF == 0 or not math.isfinite(v)
    assert got[BITS.index(0x3F801000)] == 0x3F802000
    assert got[BITS.index(0x3F800FFF)] == 0x3F800000
    assert got[BITS.index(0x3FFFF000)] == 0x40000000
    assert got[BITS.index(0x7F7FFFFF)] == 0x7F800000


def test_tf32_rounding_on_random_values_matches_exact_rationals():
    rng = np.random.default_rng(5)
    vals = np.concatenate([rng.standard_normal(300) * 10.0 ** rng.integers(-40, 38, 300),
                           rng.standard_normal(100)]).astype(np.float32)
    got = config.round_operand(torch.from_numpy(vals), "tf32").numpy()
    want = np.array([_tf32_exact(float(v)) for v in vals], dtype=np.float32)
    np.testing.assert_array_equal(got, want)


def test_bf16_rounding_is_round_to_nearest_even():
    bits = np.array([0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001], np.uint32)
    x = torch.from_numpy(bits.view(np.int32).copy()).view(torch.float32)
    got = config.round_operand(x, "bf16").view(torch.int32).numpy().view(np.uint32)
    assert list(got) == [0x3F800000, 0x3F820000, 0x3F800000, 0x3F810000]


# ---------------------------------------------------------- layers in bf16


def _jax_bf16(fn):
    with jconfig.precision("bf16"), jops.pallas(False):
        return np.asarray(fn())


def _gru_inputs(seed, T=40, B=3, C=12, S=16):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: (sc * rng.standard_normal(s)).astype(np.float32)
    return f(T, B, C, sc=1.0), f(C, 3 * S), f(3 * S, sc=0.1), f(S, 2 * S), f(S, S)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_bf16_matches_jax_scan(reverse):
    x, iW, b, sW, sW2 = _gru_inputs(3 + reverse)
    with config.precision("bf16"):
        out = gru_layer_tm(*map(_t, (x, iW, b, sW, sW2)), reverse=reverse).numpy()
    ref = _jax_bf16(lambda: jnp.moveaxis(jrnn.gru(
        jl.feedforward(jnp.moveaxis(jnp.asarray(x), 0, 1), jnp.asarray(iW),
                       jnp.asarray(b)),
        jnp.asarray(sW), jnp.asarray(sW2), reverse=reverse), 0, 1))
    np.testing.assert_allclose(out, ref, rtol=0, atol=LAYER_TOL)
    exact = gru_layer_tm(*map(_t, (x, iW, b, sW, sW2)), reverse=reverse).numpy()
    assert np.abs(exact - out).max() > 1e-5  # bf16 is live


def test_lstm_pair_bf16_matches_jax_scan():
    rng = np.random.default_rng(6)
    f = lambda *s, sc=0.3: (sc * rng.standard_normal(s)).astype(np.float32)
    T, B, C, S = 30, 2, 12, 16
    x = f(T, B, C, sc=1.0)
    w = {d: (f(C, 4 * S), f(4 * S, sc=0.1), f(S, 4 * S), f(3 * S)) for d in "FB"}
    with config.precision("bf16"):
        hF, hB = lstm_pair_tm(_t(x), tuple(map(_t, w["F"])), tuple(map(_t, w["B"])))
    xb = jnp.moveaxis(jnp.asarray(x), 0, 1)
    for d, h, rev in (("F", hF, False), ("B", hB, True)):
        iW, b, sW, p = map(jnp.asarray, w[d])
        ref = _jax_bf16(lambda: jnp.moveaxis(jrnn.lstm(
            jl.feedforward(xb, iW, b), sW, p, reverse=rev), 0, 1))
        np.testing.assert_allclose(h.numpy(), ref, rtol=0, atol=LAYER_TOL)


def _dense_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.3: (sc * rng.standard_normal(s)).astype(np.float32)
    return f


@pytest.mark.parametrize("layer", ["conv1d", "feedforward", "feedforward2_tanh",
                                   "softmax_with_temperature", "globalnorm"])
def test_dense_layers_bf16_match_jax_scan(layer):
    f = _dense_inputs(7)
    if layer == "conv1d":
        args = (f(2, 301, 1, sc=1.0), f(19, 1, 96), f(96), 5)
    elif layer == "feedforward":
        args = (f(2, 50, 96, sc=1.0), f(96, 40), f(40))
    elif layer == "feedforward2_tanh":
        args = (f(2, 50, 96, sc=1.0), f(2, 50, 96, sc=1.0), f(96, 96), f(96, 96),
                f(96))
    elif layer == "softmax_with_temperature":
        args = (f(2, 50, 96, sc=1.0), f(96, 1025), f(1025), 0.8, 1.2)
    else:
        args = (f(2, 50, 96, sc=1.0), f(96, 25), f(25))
    conv = lambda a: _t(a) if isinstance(a, np.ndarray) else a
    with config.precision("bf16"):
        out = getattr(tl, layer)(*map(conv, args)).numpy()
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ref = _jax_bf16(lambda: getattr(jl, layer)(*jargs))
    np.testing.assert_allclose(out, ref, rtol=0, atol=LAYER_TOL)


def _simulated_signal(n: int) -> np.ndarray:
    """n samples of a simulated read (squiggle_r94, seed 2), med/MAD
    normalised, [1, n, 1]."""
    from scrappie_torch.train.simulate import SquiggleSimulator

    sig, _, _ = SquiggleSimulator(seed=2, device="cpu").simulate_read(n // 5)
    sig = np.resize(sig, n)
    med = np.median(sig)
    mad = np.median(np.abs(sig - med)) * 1.4826
    return ((sig - med) / mad).astype(np.float32)[None, :, None]


@pytest.fixture(scope="module")
def rgrgr_bf16():
    """rgrgr_r94's log posterior of a 3 000-sample signal in 'bf16', from
    the port (on the CPU) and the JAX scan path, and the port's in
    'highest'."""
    params = registry.load_params("rgrgr_r94")
    sig = _simulated_signal(3000)
    tparams = params_from_numpy(params, "cpu")
    with config.precision("bf16"), torch.inference_mode():
        port = t_rgrgr_posterior(tparams, _t(sig), stride=5).numpy()
    with torch.inference_mode():
        exact = t_rgrgr_posterior(tparams, _t(sig), stride=5).numpy()
    with jconfig.precision("bf16"), jops.pallas(False):
        ref = np.asarray(jforward.rgrgr_posterior(params, jnp.asarray(sig),
                                                  stride=5, return_log=True))
    config.set_precision("highest")
    return port, ref, exact


def test_rgrgr_posterior_bf16_agrees_with_jax_bf16(rgrgr_bf16):
    """At least 99.5% of blocks share their argmax; the decoded calls of
    the two bf16 posteriors are within 1% edits of each other (the fp32
    sums of 600 blocks of five GRU layers in another order)."""
    from scrappie_torch.decode.transducer import decode_transducer
    from scrappie_torch.post.overlapper import overlapper
    from scrappie_torch.utils.seqcompare import edit_distance

    port, ref, exact = rgrgr_bf16
    assert port.shape == ref.shape == (1, 600, 1025)
    agree = float((port.argmax(-1) == ref.argmax(-1)).mean())
    assert agree >= 0.995, agree
    calls = []
    for lp in (port[0], ref[0]):
        _, path = decode_transducer(lp, device="cpu")
        calls.append(overlapper(path, 1024) or "")
    assert len(calls[0]) > 50
    assert edit_distance(*calls) <= 0.01 * max(map(len, calls)), calls
    assert np.abs(port - exact).max() > 0  # bf16 is live


def test_default_on_the_cpu_equals_highest_bit_for_bit(rgrgr_bf16):
    """'default' is plain fp32 on the CPU: the posterior, an engine call of
    each of the four models and a mapping call equal 'highest''s."""
    from scrappie_torch import api as tapi
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.types import RawSignal

    params = registry.load_params("rgrgr_r94")
    sig = _simulated_signal(3000)
    tparams = params_from_numpy(params, "cpu")
    with config.precision("default"), torch.inference_mode():
        lp = t_rgrgr_posterior(tparams, _t(sig), stride=5).numpy()
    np.testing.assert_array_equal(lp, rgrgr_bf16[2])
    rng = np.random.default_rng(9)
    reads = [RawSignal((rng.standard_normal(n) * 10 + 90).astype(np.float32),
                       uuid=f"r{i}") for i, n in enumerate((2600, 1900))]
    for model in ("rgrgr_r94", "raw_r94", "rnnrf_r94", "nanonet_events"):
        engine = BasecallEngine(model, device="cpu", chunk_len=800, overlap=100)
        calls = {}
        for mode in ("highest", "default"):
            with config.precision(mode):
                calls[mode] = [(r.sequence, r.score)
                               for r in engine.basecall_signals(reads)]
        assert calls["default"] == calls["highest"], model
    seq = "ACGTTGCAAGCTAGCTTACG" * 3
    outs = []
    for mode in ("highest", "default"):
        with config.precision(mode):
            outs.append(tapi.sequence_to_squiggle(seq, device="cpu"))
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
