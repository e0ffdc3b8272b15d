"""scrappie_torch.nn.layers against scrappie_tpu.nn.layers on the same
seeded inputs. Tolerance rtol/atol 1e-5: both compute in fp32, and only
the order of the sums differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch.nn import layers as tl
from scrappie_tpu.nn import layers as jl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("T,stride,winlen,cin,cout", [
    (61, 5, 19, 1, 96),    # rgrgr geometry, odd T
    (37, 2, 19, 1, 16),
    (50, 1, 11, 3, 8),
    (33, 4, 11, 2, 5),
    (7, 5, 19, 1, 4),      # shorter than the window
])
def test_conv1d_matches_jax(T, stride, winlen, cin, cout):
    rng = np.random.default_rng(T + stride)
    x = rng.standard_normal((2, T, cin)).astype(np.float32)
    W = rng.standard_normal((winlen, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(jl.conv1d(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b),
                               stride))
    out = tl.conv1d(_t(x), _t(W), _t(b), stride).numpy()
    assert out.shape == ref.shape == (2, -(-T // stride), cout)
    np.testing.assert_allclose(out, ref, **TOL)


def test_conv1d_unbatched_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((41, 1)).astype(np.float32)
    W = rng.standard_normal((19, 1, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jl.conv1d(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), 5))
    out = tl.conv1d(_t(x), _t(W), _t(b), 5).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("T,winlen,stride", [(10, 19, 5), (11, 11, 4), (3, 3, 1)])
def test_conv_same_pad_matches_jax(T, winlen, stride):
    assert tl.conv_same_pad(T, winlen, stride) == jl.conv_same_pad(T, winlen, stride)


def test_elu_matches_jax():
    x = np.linspace(-20.0, 5.0, 401, dtype=np.float32)
    np.testing.assert_allclose(tl.elu(_t(x)).numpy(),
                               np.asarray(jl.elu(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("min_prob", [1e-5, 1e-6])
def test_robustlog_matches_jax(min_prob):
    rng = np.random.default_rng(2)
    p = rng.dirichlet(np.ones(1025), size=6).astype(np.float32)
    np.testing.assert_allclose(tl.robustlog(_t(p), min_prob).numpy(),
                               np.asarray(jl.robustlog(jnp.asarray(p), min_prob)),
                               **TOL)


def test_feedforward_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 9, 96)).astype(np.float32)
    W = rng.standard_normal((96, 288)).astype(np.float32) / 10
    b = rng.standard_normal(288).astype(np.float32)
    np.testing.assert_allclose(
        tl.feedforward(_t(x), _t(W), _t(b)).numpy(),
        np.asarray(jl.feedforward(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b))),
        **TOL)


@pytest.mark.parametrize("tempW,tempb", [(1.0, 1.0), (0.7, 1.3)])
def test_softmax_with_temperature_matches_jax(tempW, tempb):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 11, 96)).astype(np.float32)
    W = rng.standard_normal((96, 1025)).astype(np.float32)
    b = rng.standard_normal(1025).astype(np.float32)
    ref = np.asarray(jl.softmax_with_temperature(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), tempW, tempb))
    out = tl.softmax_with_temperature(_t(x), _t(W), _t(b), tempW, tempb).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_grumod_matches_jax(reverse, batched):
    """nn/rnn.grumod against scrappie_tpu.nn.rnn.grumod (ref grumod_step,
    src/layers.c:620-671), forward and reverse, within 1e-6: the same fp32
    recurrence, only the order of the sums of h @ sW differs."""
    from scrappie_torch.nn import rnn as trnn
    from scrappie_tpu.nn import rnn as jrnn

    rng = np.random.default_rng(40 + reverse + 2 * batched)
    S, T = 12, 23
    x = rng.standard_normal((3, T, 3 * S) if batched else (T, 3 * S))
    x = x.astype(np.float32)
    sW = (0.3 * rng.standard_normal((S, 3 * S))).astype(np.float32)
    ref = np.asarray(jrnn.grumod(jnp.asarray(x), jnp.asarray(sW), reverse))
    out = trnn.grumod(_t(x), _t(sW), reverse).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
