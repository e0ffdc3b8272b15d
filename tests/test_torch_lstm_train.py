"""The LSTM's training route on the CPU: the forward's planes and the
backward walk that reads them, against the route they replaced and
against the JAX package.

The training forward (nn/rnn.lstm_tm(return_planes=True), the twin of the
recurrence kernel's training mode) hands the walk c, tanh(c) and the
activated gates of every step; the walk (ops/lstm.lstm_walk_plain, the
twin of lstm_recurrence_bwd_kernel) forms the step's six coefficients from
them and returns da and each row's dpeep partials. The references here
are the route before it, kept in this file: the gates recomputed from the
forward's input, h and c by one product (`recomputed_gates`), the walk on
those gates (`walk_on_gates`) and the weight sums (`weight_grads`); and
jax.vjp of scrappie_tpu.nn.rnn.lstm under jops.pallas(False).

Tolerances, and why:
  * planes against the recomputed gates: 1e-6 absolute (the same float32
    operations on the same values but for the product's order over S;
    gates and tanh lie in [-1, 1]).
  * da and dpeep against the old walk: 1e-6 relative to each one's largest
    entry (the coefficients reassociate the step's products: a few ulps).
  * LstmPair against jax.vjp: LSTM_RTOL = 1e-5 relative to each
    gradient's largest entry (float32 sums in another order over T steps,
    as tests/test_torch_train_events.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.nn import rnn as trnn
from scrappie_torch.ops import lstm as tlstm
from scrappie_tpu import ops as jops
from scrappie_tpu.nn import rnn as jrnn

torch.set_num_threads(1)
PLANES_ATOL = 1e-6
WALK_RTOL = 1e-6
LSTM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_scan_reference():
    with jops.pallas(False):
        yield


def assert_rel_close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def lstm_inputs(S: int, T: int, B: int, seed: int, scale: float = 0.3):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.tensor(
        (s * rng.standard_normal(shape)).astype(np.float32))
    return f(T, B, 4 * S), f(S, 4 * S, s=scale), f(3 * S, s=0.3), f(T, B, S)


def shifted(a, reverse: bool):
    zero = a.new_zeros((1, *a.shape[1:]))
    return torch.cat([a[1:], zero]) if reverse else torch.cat([zero, a[:-1]])


def recomputed_gates(x, h, c, sW, peep, reverse):
    """The gates again from the forward's input x [T, B, 4S], its h and c,
    by one product over every step."""
    S = sW.shape[0]
    h_prev, c_prev = shifted(h, reverse), shifted(c, reverse)
    xF = x + torch.matmul(h_prev, sW)
    return torch.cat([
        torch.tanh(xF[..., :S]),
        torch.sigmoid(xF[..., S : 2 * S] + c_prev * peep[:S]),
        torch.sigmoid(xF[..., 2 * S : 3 * S] + c_prev * peep[S : 2 * S]),
        torch.sigmoid(xF[..., 3 * S :] + c * peep[2 * S :])], dim=-1)


def walk_on_gates(gates, c, gh, sW, peep, reverse):
    """The walk as it was, on the recomputed gates: the step's formulas
    carried through whole (csrc/lstm.cu's header before the coefficients)."""
    T, B, _ = gates.shape
    S = sW.shape[0]
    p_in, p_f, p_out = peep[:S], peep[S : 2 * S], peep[2 * S :]
    c_prev = shifted(c, reverse)
    da = gates.new_empty((T, B, 4 * S))
    carry_h = gates.new_zeros((B, S))
    carry_c = gates.new_zeros((B, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        g, i, f, o = gates[t].split(S, dim=-1)
        tc = torch.tanh(c[t])
        dh = carry_h + gh[t]
        da_o = dh * tc * o * (1 - o)
        dc = carry_c + dh * o * (1 - tc * tc) + da_o * p_out
        da_f = dc * c_prev[t] * f * (1 - f)
        da_i = dc * g * i * (1 - i)
        da_c = dc * i * (1 - g * g)
        carry_c = dc * f + da_f * p_f + da_i * p_in
        da[t] = torch.cat([da_c, da_i, da_f, da_o], dim=-1)
        carry_h = torch.matmul(da[t], sW.T)
    return da


def weight_grads(da, h, c, reverse):
    """(dsW, dpeep) from da as the route before summed them."""
    S = c.shape[-1]
    h_prev, c_prev = shifted(h, reverse), shifted(c, reverse)
    dsW = torch.matmul(h_prev.reshape(-1, S).T, da.reshape(-1, 4 * S))
    dpeep = torch.cat([(da[..., S : 2 * S] * c_prev).sum((0, 1)),
                       (da[..., 2 * S : 3 * S] * c_prev).sum((0, 1)),
                       (da[..., 3 * S :] * c).sum((0, 1))])
    return dsW, dpeep


@pytest.mark.parametrize("S", [8, 96])
@pytest.mark.parametrize("reverse", [False, True])
def test_planes_match_recomputed_gates(S, reverse):
    """The training forward's twin returns c, tanh(c) and the gates that
    one product over the forward's input, h and c recomputes."""
    x, sW, peep, _ = lstm_inputs(S, 23, 3, seed=S + reverse)
    h, planes = trnn.lstm_tm(x, sW, peep, reverse, return_planes=True)
    assert planes.shape == (tlstm.TRAIN_PLANES, 23, 3, S)
    torch.testing.assert_close(h, trnn.lstm_tm(x, sW, peep, reverse),
                               rtol=0, atol=0)
    c = planes[0]
    torch.testing.assert_close(planes[1], torch.tanh(c), rtol=0, atol=0)
    gates = recomputed_gates(x, h, c, sW, peep, reverse)
    got = torch.cat(list(planes[2:]), dim=-1)
    np.testing.assert_allclose(got, gates, rtol=0, atol=PLANES_ATOL)


@pytest.mark.parametrize("S", [8, 96])
@pytest.mark.parametrize("reverse", [False, True])
def test_walk_matches_the_walk_on_recomputed_gates(S, reverse):
    """lstm_walk_plain on the planes (the six coefficients first, a
    carry of dh and dc) gives the da of the walk on the recomputed gates,
    and its row partials sum to the dpeep of the old weight sums."""
    x, sW, peep, gh = lstm_inputs(S, 31, 4, seed=40 + S + reverse)
    h, planes = trnn.lstm_tm(x, sW, peep, reverse, return_planes=True)
    gates = recomputed_gates(x, h, planes[0], sW, peep, reverse)
    want = walk_on_gates(gates, planes[0], gh, sW, peep, reverse)
    da, parts = tlstm.lstm_walk_plain(planes, gh, sW, peep, reverse)
    assert parts.shape == (4, 3 * S)
    assert_rel_close(da, want, WALK_RTOL, "da")
    want_dsW, want_dpeep = weight_grads(want, h, planes[0], reverse)
    assert_rel_close(parts.sum(0), want_dpeep, WALK_RTOL, "dpeep")
    (dsW, dpeep), = tlstm.lstm_tm_backward(
        [(h, planes, sW, peep, reverse, gh)])[1]
    assert_rel_close(dsW, want_dsW, WALK_RTOL, "dsW")
    assert_rel_close(dpeep, want_dpeep, WALK_RTOL, "dpeep summed")


def test_walk_pair_returns_partials_a_direction():
    """lstm_walk_pair on CPU tensors: the directions' da side by side and
    their dpeep partials stacked [directions, B, 3S], each the twin's; no
    kernel launched."""
    S, T, B = 8, 9, 2
    dirs = []
    for k, reverse in enumerate((False, True)):
        x, sW, peep, gh = lstm_inputs(S, T, B, seed=60 + k)
        _h, planes = trnn.lstm_tm(x, sW, peep, reverse, return_planes=True)
        dirs.append((planes, gh, sW, peep, reverse))
    da, parts = tlstm.lstm_walk_pair(dirs)
    assert da.shape == (T, B, 8 * S) and parts.shape == (2, B, 3 * S)
    for k, d in enumerate(dirs):
        want_da, want_parts = tlstm.lstm_walk_plain(*d)
        torch.testing.assert_close(da[..., 4 * S * k : 4 * S * (k + 1)],
                                   want_da, rtol=0, atol=0)
        torch.testing.assert_close(parts[k], want_parts, rtol=0, atol=0)
    assert ops.LAUNCHES["lstm_recurrence_bwd"] == 0


@pytest.mark.parametrize("T", [1, 2])
def test_walk_at_one_and_two_steps(T):
    """The walk and dsW's offset views at T = 1 (no step before the first:
    dsW is 0) and T = 2, against torch.autograd through the plain loop."""
    S = 8
    x, sW, peep, gh = lstm_inputs(S, T, 3, seed=70 + T)
    for reverse in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, sW, peep)]
        trnn.lstm_tm(*leaves, reverse).backward(gh)
        h, planes = trnn.lstm_tm(x, sW, peep, reverse, return_planes=True)
        da, ((dsW, dpeep),) = tlstm.lstm_tm_backward(
            [(h, planes, sW, peep, reverse, gh)])
        for name, g, leaf in zip(("dx", "dsW", "dpeep"), (da, dsW, dpeep),
                                 leaves):
            np.testing.assert_allclose(g, leaf.grad, rtol=0, atol=1e-6,
                                       err_msg=name)


def test_padded_weights_for_the_register_walk():
    """The register walk reads sW padded to [96, 4, 96]: sW's gate blocks
    in the corner, zeros elsewhere; sW itself at S = 96."""
    sW = torch.arange(7 * 28, dtype=torch.float32).reshape(7, 28)
    padded = tlstm._padded(sW)
    assert padded.shape == (tlstm.REGISTER_MAX_S, 4, tlstm.REGISTER_MAX_S)
    torch.testing.assert_close(padded[:7, :, :7], sW.view(7, 4, 7))
    assert float(padded.abs().sum()) == float(sW.abs().sum())
    full = torch.ones((96, 384))
    assert tlstm._padded(full) is full


@pytest.mark.parametrize("S", [96, 100, 128])
def test_lstm_pair_matches_jax_vjp(S):
    """LstmPair (the training forward's planes, one walk over both
    directions, dsW by one product a direction, dpeep from the partials):
    dx, dsW and dpeep against jax.vjp of scrappie_tpu.nn.rnn.lstm forwards
    on the first 4S columns and backwards on the others, at S = 96 (the
    register kernels' size), S = 100 (the big-S modes', not a multiple of
    8: the cluster walk's rows end past 4S) and S = 128."""
    T, B = 9, 2
    rng = np.random.default_rng(80 + S)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)
    x = f(T, B, 8 * S)
    wF = (f(S, 4 * S, s=S ** -0.5), f(3 * S, s=0.3))
    wB = (f(S, 4 * S, s=S ** -0.5), f(3 * S, s=0.3))
    gF, gB = f(T, B, S), f(T, B, S)

    def pair(x, sW_f, peep_f, sW_b, peep_b):
        xb = jnp.moveaxis(x, 0, 1)
        return (jrnn.lstm(xb[..., : 4 * S], sW_f, peep_f, False),
                jrnn.lstm(xb[..., 4 * S :], sW_b, peep_b, True))

    _, vjp = jax.vjp(pair, x, *wF, *wB)
    want = vjp((jnp.moveaxis(gF, 0, 1), jnp.moveaxis(gB, 0, 1)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, *wF, *wB)]
    hF, hB = tlstm.LstmPair.apply(*leaves)
    ((hF * torch.tensor(gF)).sum() + (hB * torch.tensor(gB)).sum()).backward()
    names = ("dx", "dsW_f", "dpeep_f", "dsW_b", "dpeep_b")
    for name, leaf, w in zip(names, leaves, want):
        assert_rel_close(leaf.grad, w, LSTM_RTOL, name)


# The cluster walk's static shared memory (csrc/lstm.cu
# lstm_walk_cluster_kernel): two da buffers of 32 (rows + 4) floats and the
# inputs' ring of 4 steps x 7 planes x 48 units; its dynamic shared memory
# holds each thread's rows of its tile past those in registers.
CLUSTER_RING_FLOATS = 4 * 7 * 48


def test_walk_cluster_layout():
    """ops/lstm.walk_cluster_layout at every S from 97 to 400: in the
    cluster mode exactly where walk_mode says it (the big-S sizes up to
    CLUSTER_MAX_S, which check_walk_size sends to the big-S modes); its
    CTAs' slices [c S / ncta, (c + 1) S / ncta) and each CTA's warps own
    each unit once; a warp's lanes hold every one of the 4S rows of sW^T;
    at most 16 CTAs, 12 warps and 80 weights a lane in registers (with the
    kernel's other registers within its launch bounds' cap, at most 255),
    the buffers within a block's static shared memory and the rest of the
    tiles within its dynamic shared memory."""
    for S in range(97, 401):
        check_cluster_layout(S)


def check_cluster_layout(S: int) -> None:
    layout = tlstm.walk_cluster_layout(S)
    assert tlstm.check_walk_size(S) is True
    assert tlstm.walk_mode(S) == ("cluster" if S <= tlstm.CLUSTER_MAX_S else "global")
    assert (layout is not None) == (tlstm.walk_mode(S) == "cluster")
    if layout is None:
        assert 32 * tlstm.CLUSTER_MAX_ROWS < 4 * S
        return
    owners = np.zeros(S, np.int64)
    for c in range(layout.ncta):
        first, last = c * S // layout.ncta, (c + 1) * S // layout.ncta
        assert 1 <= last - first <= layout.units
        owned = [first + w * layout.out + o for w in range(layout.warps)
                 for o in range(layout.out) if w * layout.out + o < last - first]
        assert owned == list(range(first, last))
        owners[first:last] += 1
    assert (owners == 1).all()
    assert 32 * layout.rows >= 4 * S and layout.rows % (4 if layout.rows <= 20 else 8) == 0
    assert 32 * (layout.rows - (4 if layout.rows <= 20 else 8)) < 4 * S
    assert layout.rows <= tlstm.CLUSTER_MAX_ROWS
    assert layout.ncta <= tlstm.CLUSTER_MAX_CTAS == 16
    assert layout.warps <= tlstm.CLUSTER_MAX_WARPS
    assert layout.out * layout.warps >= layout.units
    assert layout.weights + layout.out * layout.shared_rows == layout.out * layout.rows
    assert layout.weights <= 80 and layout.shared_rows % 4 == 0
    assert tlstm.CLUSTER_MAX_REGISTERS <= 255
    assert 32 * tlstm.CLUSTER_MAX_WARPS * tlstm.CLUSTER_MAX_REGISTERS <= 65536
    static = 4 * (2 * 32 * (layout.rows + 4) + CLUSTER_RING_FLOATS)
    dynamic = 4 * layout.out * layout.shared_rows * 32 * layout.warps
    assert static <= 48 * 1024 and static + dynamic <= ops.MAX_SMEM_BYTES
    # the fewest CTAs: half as many would need more warps than a CTA has
    if layout.ncta > 2:
        half = -(-S // (layout.ncta // 2))
        assert -(-half // layout.out) > tlstm.CLUSTER_MAX_WARPS
