"""The port's GRU (the plain twin of csrc/gru.cu, which the CPU runs)
against the JAX package: the Pallas kernel in interpret mode
(scrappie_tpu.ops.gru.gru_layer_tm, lane-padded to 128: the first S lanes
are compared) and the lax.scan program (nn.rnn.gru after feedforward).
Tolerance 1e-5: fp32 on both sides, the sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.nn.rnn import gru as t_gru
from scrappie_torch.ops.gru import gru_layer_tm as t_gru_layer_tm
from scrappie_torch.ops.gru import gru_layer_tm_plain
from scrappie_tpu.nn.layers import feedforward
from scrappie_tpu.nn.rnn import gru as j_gru
from scrappie_tpu.ops.gru import gru_layer_tm as j_gru_layer_tm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(rng, C, S):
    return (rng.standard_normal((C, 3 * S)).astype(np.float32) * 0.3,
            rng.standard_normal(3 * S).astype(np.float32) * 0.1,
            rng.standard_normal((S, 2 * S)).astype(np.float32) * 0.3,
            rng.standard_normal((S, S)).astype(np.float32) * 0.3)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_matches_pallas_kernel(reverse):
    rng = np.random.default_rng(3)
    B, T, C, S = 8, 7, 12, 96
    x = rng.standard_normal((T, B, C)).astype(np.float32)
    w = _weights(rng, C, S)
    ref = np.asarray(j_gru_layer_tm(jnp.asarray(x), *map(jnp.asarray, w),
                                    reverse=reverse))
    assert ref.shape == (T, B, 128)
    ops.reset_launches()
    out = t_gru_layer_tm(*_t(x, *w), reverse=reverse).numpy()
    assert ops.LAUNCHES["gru_layer"] == 0  # a CPU tensor takes the twin
    assert out.shape == (T, B, S)
    np.testing.assert_allclose(out, ref[..., :S], **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T", [(8, 7), (3, 13)])
def test_gru_layer_matches_scan(reverse, B, T):
    rng = np.random.default_rng(5 + B)
    C, S = 12, 96
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = _weights(rng, C, S)
    jw = list(map(jnp.asarray, w))
    ref = np.asarray(j_gru(feedforward(jnp.asarray(x), jw[0], jw[1]), jw[2],
                           jw[3], reverse=reverse))
    x_tm = np.moveaxis(x, 1, 0)
    out = gru_layer_tm_plain(*_t(x_tm, *w), reverse=reverse).numpy()
    np.testing.assert_allclose(np.moveaxis(out, 0, 1), ref, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_nn_rnn_gru_matches_jax(reverse):
    """nn.rnn.gru on projected inputs, batched and unbatched."""
    rng = np.random.default_rng(11)
    S = 16
    xin = rng.standard_normal((2, 9, 3 * S)).astype(np.float32)
    _, _, sW, sW2 = _weights(rng, 1, S)
    ref = np.asarray(j_gru(jnp.asarray(xin), jnp.asarray(sW), jnp.asarray(sW2),
                           reverse=reverse))
    out = t_gru(*_t(xin, sW, sW2), reverse=reverse).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    out1 = t_gru(*_t(xin[1], sW, sW2), reverse=reverse).numpy()
    np.testing.assert_allclose(out1, ref[1], **TOL)


def test_projection_twin_matches_jax_and_launches_nothing():
    """ops/project.project_tm (on the CPU: nn/layers.feedforward, the twin
    of csrc/project.cu) against scrappie_tpu's feedforward, tolerance 1e-5;
    the kernel's input check refuses what it cannot take."""
    from scrappie_torch.ops.project import check_project_input, project_tm

    rng = np.random.default_rng(17)
    x = rng.standard_normal((7, 3, 12)).astype(np.float32)
    W = (rng.standard_normal((12, 48)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    ref = np.asarray(feedforward(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b)))
    ops.reset_launches()
    out = project_tm(*_t(x, W, b))
    assert ops.LAUNCHES["project"] == 0
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    check_project_input(*_t(x, W, b))
    tx, tW, tb = _t(x, W, b)
    with pytest.raises(ValueError, match="contiguous"):
        check_project_input(tx.transpose(0, 1).contiguous().transpose(0, 1), tW, tb)
    with pytest.raises(ValueError, match="shape"):
        check_project_input(tx, tW, tb[:-1])


@pytest.mark.parametrize("T,B,K,N", [(7, 3, 12, 768), (65, 2, 96, 768),
                                     (43, 3, 13, 290)])
def test_projection_twin_matches_jax_at_the_lstm_widths(T, B, K, N):
    """The projection's twin against scrappie_tpu's feedforward where the
    LSTM's pair route runs it (K = 12 and 96 against both directions'
    weights, N = 8S = 768), on M = T B rows that fill no whole 128-row tile
    of the kernel, and at K and N that are not multiples of 4 (the kernel's
    4-byte path); tolerance 1e-5."""
    from scrappie_torch.ops.project import check_project_input, project_tm

    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((T, B, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    assert (T * B) % 128
    ref = np.asarray(feedforward(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b)))
    ops.reset_launches()
    out = project_tm(*_t(x, W, b))
    assert ops.LAUNCHES["project"] == 0
    assert out.shape == (T, B, N)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    check_project_input(*_t(x, W, b))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("S", [160, 352])
def test_gru_layer_matches_scan_beyond_shared_memory(S, reverse):
    """The sizes the GRU kernel takes through its big-S mode (weights beyond
    shared memory; 352 also beyond the first kernel's 3S <= 1024 threads):
    the twin against scrappie_tpu's scan, tolerance 1e-5."""
    rng = np.random.default_rng(S)
    B, T, C = 2, 6, 24
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = [a * np.float32(16 / S) ** 0.5 for a in _weights(rng, C, S)]
    jw = list(map(jnp.asarray, w))
    ref = np.asarray(j_gru(feedforward(jnp.asarray(x), jw[0], jw[1]), jw[2],
                           jw[3], reverse=reverse))
    ops.reset_launches()
    out = t_gru_layer_tm(*_t(np.moveaxis(x, 1, 0), *w), reverse=reverse).numpy()
    assert ops.LAUNCHES["gru_recurrence_global"] == 0
    np.testing.assert_allclose(np.moveaxis(out, 0, 1), ref, **TOL)


def test_gru_kernel_input_checks():
    """check_gru_layer_input holds a layer to what the projection and
    recurrence kernels take; the wrapper picks the big-S mode above
    REGISTER_MAX_S."""
    from scrappie_torch.ops import gru as tgru

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 2, 12)).astype(np.float32))
    iW, b, sW, sW2 = _t(*_weights(rng, 12, 16))
    tgru.check_gru_layer_input(x, iW, b, sW, sW2)
    bad = {"iW": ("shape", iW[:, :-3]), "b": ("dtype", b.double()),
           "sW": ("shape", sW[:8]), "sW2": ("contiguous", sW2.t()),
           "x": ("contiguous", x.transpose(0, 1).contiguous().transpose(0, 1))}
    for name, (what, value) in bad.items():
        args = dict(x_tm=x, iW=iW, b=b, sW=sW, sW2=sW2)
        args["x_tm" if name == "x" else name] = value
        with pytest.raises(ValueError, match=what):
            tgru.check_gru_layer_input(**args)
    assert tgru.REGISTER_MAX_S == 96
    with pytest.raises(ValueError, match="cuda"):
        tgru.gru_layer_fused_cuda(x, iW, b, sW, sW2)
