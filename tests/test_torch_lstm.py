"""The peephole-LSTM layer and the bidirectional pair route of the port
(their plain twins, which the CPU runs) against scrappie_tpu: the Pallas
kernel's wrapper ops/lstm.py:lstm_layer_tm (interpret mode on the CPU) and
the lax.scan program, feedforward followed by nn/rnn.py:lstm.

Tolerance rtol = atol = 1e-5: fp32 sums of the projection and of h @ sW
taken in another order, carried through up to 50 steps of the recurrence
(seen: at most a few 1e-7). On the card the CUDA kernel is held to its twin
by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.ops.lstm import (
    check_lstm_input,
    check_lstm_pair_input,
    lstm_in_registers,
    lstm_layer_tm,
    lstm_layer_tm_plain,
    lstm_pair_recurrence_cuda,
    lstm_pair_tm,
    lstm_pair_tm_plain,
    lstm_recurrence_cuda,
)
from scrappie_tpu.nn.layers import feedforward as j_feedforward
from scrappie_tpu.nn.rnn import lstm as j_lstm
from scrappie_tpu.ops.lstm import lstm_layer_tm as j_lstm_layer_tm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(T, B, C, S, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)
    return dict(x=f(T, B, C), iW=f(C, 4 * S, s=0.3), b=f(4 * S, s=0.1),
                sW=f(S, 4 * S, s=0.3), peep=f(3 * S, s=0.3))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("S", [16, 96])
@pytest.mark.parametrize("C", [12, 96])
@pytest.mark.parametrize("T", [1, 9, 50])
def test_lstm_layer_matches_jax(T, C, S, reverse):
    a = _inputs(T, 3, C, S, seed=T + C + S)
    out = lstm_layer_tm(*(torch.from_numpy(a[k]) for k in
                          ("x", "iW", "b", "sW", "peep")), reverse=reverse)
    assert out.shape == (T, 3, S)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    # the Pallas wrapper takes a batch of 8 rows, as its callers pad it
    x8 = jnp.pad(j["x"], ((0, 0), (0, 5), (0, 0)))
    kernel = np.asarray(j_lstm_layer_tm(x8, j["iW"], j["b"], j["sW"],
                                        j["peep"], reverse=reverse))
    np.testing.assert_allclose(out.numpy(), kernel[:, :3, :S], **TOL)
    xproj = j_feedforward(jnp.moveaxis(j["x"], 0, 1), j["iW"], j["b"])
    scan = np.moveaxis(np.asarray(j_lstm(xproj, j["sW"], j["peep"],
                                         reverse=reverse)), 0, 1)
    np.testing.assert_allclose(out.numpy(), scan, **TOL)


def _jax_layer(a, reverse):
    """One direction through the Pallas wrapper and through the scan."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    B = a["x"].shape[1]
    # the Pallas wrapper takes a batch of 8 rows, as its callers pad it
    x8 = jnp.pad(j["x"], ((0, 0), (0, 8 - B), (0, 0)))
    S = a["sW"].shape[0]
    kernel = np.asarray(j_lstm_layer_tm(x8, j["iW"], j["b"], j["sW"],
                                        j["peep"], reverse=reverse))[:, :B, :S]
    xproj = j_feedforward(jnp.moveaxis(j["x"], 0, 1), j["iW"], j["b"])
    scan = np.moveaxis(np.asarray(j_lstm(xproj, j["sW"], j["peep"],
                                         reverse=reverse)), 0, 1)
    return kernel, scan


_LAYER = ("iW", "b", "sW", "peep")


@pytest.mark.parametrize("S", [16, 96])
@pytest.mark.parametrize("C", [12, 96])
@pytest.mark.parametrize("T", [1, 9, 50])
def test_lstm_pair_matches_jax(T, C, S):
    """lstm_pair_tm (on the CPU its twin, the two layers in turn) against
    scrappie_tpu per direction: the forward layer walks time forwards, the
    backward one backwards, on one shared input."""
    fw = _inputs(T, 3, C, S, seed=2 * T + C + S)
    bw = _inputs(T, 3, C, S, seed=2 * T + C + S + 1)
    bw["x"] = fw["x"]
    ops.reset_launches()
    out = lstm_pair_tm(torch.from_numpy(fw["x"]),
                       *(tuple(torch.from_numpy(a[k]) for k in _LAYER)
                         for a in (fw, bw)))
    assert ops.LAUNCHES["lstm_pair"] == ops.LAUNCHES["project"] == 0
    assert len(out) == 2
    for h, a, reverse in zip(out, (fw, bw), (False, True)):
        assert h.shape == (T, 3, S)
        for ref in _jax_layer(a, reverse):
            np.testing.assert_allclose(h.numpy(), ref, **TOL)


def test_pair_input_checks():
    """check_lstm_pair_input holds a stage to what the projection and the
    pair's recurrence launch take: each layer's shapes, types and layout,
    one S for both, one device."""
    a = {k: torch.from_numpy(v) for k, v in _inputs(5, 2, 12, 16).items()}
    wF = tuple(a[k] for k in _LAYER)
    wB = tuple(t.clone() for t in wF)
    check_lstm_pair_input(a["x"], wF, wB)
    small = {k: torch.from_numpy(v) for k, v in _inputs(5, 2, 12, 8).items()}
    bad = {
        "shape": (a["x"], wF, tuple(small[k] for k in _LAYER)),
        "dtype": (a["x"], wF, (wB[0], wB[1].double(), *wB[2:])),
        "contiguous": (a["x"].transpose(0, 1).contiguous().transpose(0, 1),
                       wF, wB),
        "several devices": (a["x"], wF, (wB[0].to("meta"), *wB[1:])),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError, match=what):
            check_lstm_pair_input(*args)
    with pytest.raises(ValueError, match="several devices"):
        lstm_pair_tm(*bad["several devices"])


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    a = {k: torch.from_numpy(v) for k, v in _inputs(7, 2, 12, 16).items()}
    ops.reset_launches()
    for reverse in (False, True):
        assert torch.equal(lstm_layer_tm(*a.values(), reverse=reverse),
                           lstm_layer_tm_plain(*a.values(), reverse=reverse))
    w = tuple(a[k] for k in _LAYER)
    for got, want in zip(lstm_pair_tm(a["x"], w, w),
                         lstm_pair_tm_plain(a["x"], w, w)):
        assert torch.equal(got, want)
    assert ops.LAUNCHES["lstm_layer"] == ops.LAUNCHES["lstm_pair"] == 0


def test_kernel_input_checks():
    a = {k: torch.from_numpy(v) for k, v in _inputs(5, 2, 12, 16).items()}
    check_lstm_input(a["x"], a["iW"], a["b"], a["sW"], a["peep"])
    bad = {
        "iW": ("shape", a["iW"][:, :-1]),
        "b": ("dtype", a["b"].double()),
        "sW": ("shape", a["sW"][:8]),
        "peep": ("shape", a["peep"][:-1]),
        "x": ("contiguous", a["x"].transpose(0, 1).contiguous().transpose(0, 1)),
    }
    for name, (what, value) in bad.items():
        args = dict(a, **{name: value})
        with pytest.raises(ValueError, match=what):
            check_lstm_input(args["x"], args["iW"], args["b"], args["sW"],
                             args["peep"])
    with pytest.raises(ValueError, match="several devices"):
        lstm_layer_tm(a["x"], a["iW"].to("meta"), a["b"], a["sW"], a["peep"])
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_layer_tm(*(t.to("meta") for t in a.values()))


def test_kernel_halves_refuse_cpu_tensors():
    """The recurrence kernel is reached only through CUDA tensors; it never
    runs a twin. (The projection, ops/project.project_tm, is shared with the
    GRU and runs its twin on the CPU: tests/test_torch_gru.py.)"""
    a = {k: torch.from_numpy(v) for k, v in _inputs(5, 2, 12, 16).items()}
    with pytest.raises(ValueError, match="cuda"):
        lstm_recurrence_cuda(torch.zeros(5, 2, 64), a["sW"], a["peep"])
    with pytest.raises(ValueError, match="cuda"):
        lstm_pair_recurrence_cuda(torch.zeros(5, 2, 128), a["sW"], a["peep"],
                                  a["sW"], a["peep"])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("S", [160, 288])
def test_lstm_layer_matches_jax_beyond_shared_memory(S, reverse):
    """The sizes the recurrence kernel takes through its big-S mode (sW
    beyond registers; 288 also beyond 4S <= 1024 threads): the twin
    against scrappie_tpu's scan, tolerance 1e-5."""
    a = _inputs(6, 2, 12, S, seed=S)
    a["sW"] = a["sW"] * np.float32((16 / S) ** 0.5)
    ops.reset_launches()
    out = lstm_layer_tm(*(torch.from_numpy(a[k]) for k in
                          ("x", "iW", "b", "sW", "peep")), reverse=reverse)
    assert ops.LAUNCHES["lstm_layer_global"] == ops.LAUNCHES["project"] == 0
    j = {k: jnp.asarray(v) for k, v in a.items()}
    xproj = j_feedforward(jnp.moveaxis(j["x"], 0, 1), j["iW"], j["b"])
    scan = np.moveaxis(np.asarray(j_lstm(xproj, j["sW"], j["peep"],
                                         reverse=reverse)), 0, 1)
    np.testing.assert_allclose(out.numpy(), scan, **TOL)


def test_recurrence_mode_follows_the_size():
    """sW stays in registers up to the events model's S = 96; the big-S
    mode takes every larger S (97 and 160 would fit 4S threads, 288 not)."""
    assert lstm_in_registers(96) and lstm_in_registers(16)
    assert not any(lstm_in_registers(S) for S in (97, 160, 288))
