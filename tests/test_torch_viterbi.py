"""The port's Viterbi twins (which the CPU runs in place of
csrc/viterbi.cu) against the JAX package: the Pallas kernels in interpret
mode and the lax.scan programs. The DP only adds and takes maxima in the
same order with the same tie rules, so tracebacks and paths must be
identical and final scores within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.decode import transducer as tdec
from scrappie_torch.nn.layers import robustlog, softmax_with_temperature
from scrappie_torch.ops import viterbi as tv
from scrappie_tpu import ops as jops
from scrappie_tpu.decode import transducer as jdec
from scrappie_tpu.ops import viterbi as jv

torch.set_num_threads(1)
FINAL_TOL = dict(rtol=1e-6, atol=1e-6)

# (B, T, nstate, stay_pen, skip_pen, local_pen, use_slip)
CASES = [
    (5, 12, 65, 0.3, 0.7, 2.0, False),
    (5, 12, 65, 0.3, 0.7, 2.0, True),
    (3, 9, 1025, 0.0, 0.0, 2.0, False),
    (3, 7, 1025, 0.2, 0.5, 1.5, True),
]
IDS = [f"B{c[0]}-n{c[2] - 1}-{'slip' if c[6] else 'noslip'}" for c in CASES]


@pytest.fixture(autouse=True)
def _jax_scan_reference():
    # The JAX scan programs must not dispatch to Pallas themselves.
    with jops.pallas(False):
        yield


def _logpost(B, T, nstate, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # a few integer levels: equal candidates everywhere, so the
        # strict-`>` and first-max rules decide most moves
        return rng.integers(-3, 1, (B, T, nstate)).astype(np.float32)
    return (rng.standard_normal((B, T, nstate)) - 3.0).astype(np.float32)


def _tm(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, 0))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_backtrace_match_scan(case, ties):
    B, T, nstate, sp, kp, lp_, slip = case
    lp = _logpost(B, T, nstate, seed=nstate + T, ties=ties)
    jfinal, jtb = jdec.viterbi_transducer_scores(jnp.asarray(lp), sp, kp, lp_, slip)
    jscore, jpath = jdec.viterbi_local_backtrace(jfinal, jtb)
    final, tb = tdec.viterbi_transducer_scores(torch.from_numpy(lp), sp, kp,
                                               lp_, slip)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **FINAL_TOL)
    score, path = tdec.viterbi_local_backtrace(final, tb)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **FINAL_TOL)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_backtrace_match_pallas(case, ties):
    B, T, nstate, sp, kp, lp_, slip = case
    lp_tm = _tm(_logpost(B, T, nstate, seed=2 * nstate + T, ties=ties))
    jfinal, jtb = jv.viterbi_scores_tm(jnp.asarray(lp_tm), sp, kp, lp_, slip,
                                       interpret=True)
    jscore, jpath = jv.viterbi_backtrace_tm(jfinal, jtb, interpret=True)
    ops.reset_launches()
    final, tb = tv.viterbi_scores_tm(torch.from_numpy(lp_tm), sp, kp, lp_, slip)
    score, path = tv.viterbi_backtrace_tm(final, tb)
    assert ops.LAUNCHES["viterbi_fwd"] == ops.LAUNCHES["viterbi_backtrace"] == 0
    assert tb.dtype == torch.int16 and path.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **FINAL_TOL)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **FINAL_TOL)


def test_forward_clamps_minus_infinity_like_the_kernel():
    """viterbi_scores_tm clamps lp at -1e30, as the JAX kernel does."""
    lp = _logpost(2, 8, 65, seed=9)
    lp[:, 3, 5:40] = -np.inf
    lp_tm = _tm(lp)
    jfinal, jtb = jv.viterbi_scores_tm(jnp.asarray(lp_tm), 0.0, 0.4, 2.0,
                                       interpret=True)
    final, tb = tv.viterbi_scores_tm(torch.from_numpy(lp_tm), 0.0, 0.4, 2.0)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **FINAL_TOL)


@pytest.mark.parametrize("pens", [dict(), dict(stay_pen=0.3, skip_pen=0.6,
                                              local_pen=3.0, use_slip=True)])
def test_fused_twin_matches_head_then_decode(pens):
    rng = np.random.default_rng(21)
    T, B, S, nstate = 10, 3, 96, 1025
    h = torch.from_numpy(rng.uniform(-1, 1, (T, B, S)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((S, nstate)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(nstate).astype(np.float32))
    lp = robustlog(softmax_with_temperature(h, W, b), 1e-5)
    final_ref, tb_ref = tv.viterbi_scores_tm(lp, **pens)
    ops.reset_launches()
    final, tb = tv.viterbi_fused_tm(h, W, b, **pens)
    assert ops.LAUNCHES["viterbi_fused"] == 0
    np.testing.assert_array_equal(tb.numpy(), tb_ref.numpy())
    np.testing.assert_allclose(final.numpy(), final_ref.numpy(), **FINAL_TOL)


@pytest.mark.parametrize("temps", [(1.0, 1.0), (0.8, 1.25)])
def test_fused_twin_matches_pallas_fused(temps):
    rng = np.random.default_rng(22)
    T, B, S, nstate = 8, 3, 16, 65
    h = rng.uniform(-1, 1, (T, B, S)).astype(np.float32)
    W = (2.0 * rng.standard_normal((S, nstate))).astype(np.float32)
    b = rng.standard_normal(nstate).astype(np.float32)
    kw = dict(min_prob=1e-5, tempW=temps[0], tempb=temps[1], stay_pen=0.1,
              skip_pen=0.3, local_pen=2.0)
    jfinal, jtb = jv.viterbi_fused_tm(jnp.asarray(h), jnp.asarray(W),
                                      jnp.asarray(b), interpret=True, **kw)
    final, tb = tv.viterbi_fused_tm(torch.from_numpy(h), torch.from_numpy(W),
                                    torch.from_numpy(b), **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                               rtol=1e-5, atol=1e-5)


def test_decode_batch_and_unbatched_decode_match_jax():
    lp = _logpost(3, 11, 1025, seed=31)
    jscore, jpath = jdec.decode_transducer(lp, 0.1, 0.2, 2.0, False)
    score, path = tdec.decode_transducer(lp, 0.1, 0.2, 2.0, False, device="cpu")
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_allclose(score, jscore, **FINAL_TOL)
    s1, p1 = tdec.decode_transducer(lp[1], 0.1, 0.2, 2.0, False, device="cpu")
    js1, jp1 = jdec.decode_transducer(lp[1], 0.1, 0.2, 2.0, False)
    np.testing.assert_array_equal(p1, jp1)
    assert abs(s1 - js1) <= 1e-6 * max(1.0, abs(js1))


def test_argmax_decoder_matches_jax():
    lp = _logpost(2, 13, 65, seed=41)
    lp[0, 4, -1] = 5.0  # a stay
    s, p = tdec.argmax_decoder(lp)
    js, jp = jdec.argmax_decoder(lp)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-6)


# nhist the first kernels refused (64 <= nhist <= 1024, a multiple of 32):
# 80 is not a multiple of 32, 2048 exceeds 1024 (and takes slip).
OTHER_NHIST = [(80, False), (2048, True)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nhist,slip", OTHER_NHIST, ids=["n80", "n2048-slip"])
def test_forward_and_backtrace_match_scan_at_other_nhist(nhist, slip, ties):
    """The forward and backtrace twins (what the kernels are held to on the
    card) against scrappie_tpu's scan programs at state spaces beyond the
    fused kernels' limits: tracebacks and paths identical."""
    B, T = 3, 10
    lp = _logpost(B, T, nhist + 1, seed=nhist + 7, ties=ties)
    jfinal, jtb = jdec.viterbi_transducer_scores(jnp.asarray(lp), 0.2, 0.4, 2.0,
                                                 slip)
    jscore, jpath = jdec.viterbi_local_backtrace(jfinal, jtb)
    ops.reset_launches()
    final, tb = tv.viterbi_scores_tm(torch.from_numpy(_tm(lp)), 0.2, 0.4, 2.0,
                                     slip)
    score, path = tv.viterbi_backtrace_tm(final, tb)
    assert ops.LAUNCHES["viterbi_fwd"] == ops.LAUNCHES["viterbi_backtrace"] == 0
    np.testing.assert_array_equal(tb.transpose(0, 1).numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **FINAL_TOL)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **FINAL_TOL)


def test_forward_kernel_limits_are_the_traceback_and_shared_memory():
    """The forward kernel takes what JAX takes (a multiple of 16, or of 64
    with slip) up to its own limits, each refused by name; the fused
    kernels keep theirs."""
    for nhist in (16, 80, 2048, 16384):
        tv._check_kernel_nhist(nhist)
    with pytest.raises(ValueError, match="int16"):
        tv._check_kernel_nhist(32768)
    with pytest.raises(ValueError, match="shared memory"):
        tv._check_kernel_nhist(32752)
    with pytest.raises(ValueError, match="not divisible by 64"):
        tv.viterbi_scores_tm(torch.zeros((2, 1, 81)), use_slip=True)
    with pytest.raises(ValueError, match="fused"):
        tv._check_fused_nhist(80)


def test_forward_launch_covers_every_nhist_jax_takes():
    """Every nhist the JAX package takes (a multiple of 16) that the kernel
    accepted before its quad layout is still accepted, and has a launch
    shape: whole warps, at most FWD_THREADS_MAX of them, quads a thread
    from FWD_QUADS covering nhist / 4 quads with no idle warp; 256 threads
    of one quad at nhist = 1024."""
    def accepted_before(nhist):  # the int16 traceback, 2 nhist floats
        return nhist + 1 <= tv.MAX_TB_STATE and 8 * nhist <= ops.MAX_SMEM_BYTES

    largest = 0
    for nhist in range(16, 40000, 16):
        if not accepted_before(nhist):
            with pytest.raises(ValueError):
                tv._check_kernel_nhist(nhist)
            continue
        tv._check_kernel_nhist(nhist)
        largest = nhist
        nthr, nq = tv.forward_launch(nhist)
        assert nthr % 32 == 0 and 32 <= nthr <= tv.FWD_THREADS_MAX
        assert nq in tv.FWD_QUADS and 4 * nthr * nq >= nhist
        assert 4 * (nthr - 32) * nq < nhist or nq > 1
        assert nq == 1 or 4 * nthr * (nq // 2) < nhist
    assert largest == 29056
    assert tv.forward_launch(1024) == (256, 1)
    assert tv.forward_launch(2048) == (512, 1)
    assert tv.forward_launch(80) == (32, 1)
    assert tv.forward_launch(29056) == (512, 16)


@pytest.mark.parametrize("temps", [(1.0, 1.0), (0.8, 1.25)])
def test_head_twin_then_forward_matches_pallas_fused(temps):
    """The paths' route on the CPU, the head twin's log posterior decoded by
    the forward twin, against scrappie_tpu's fused kernel (interpret mode):
    tracebacks identical, finals within 1e-5 (fp32 softmax sums in another
    order)."""
    rng = np.random.default_rng(23)
    T, B, S, nstate = 8, 3, 16, 65
    h = rng.uniform(-1, 1, (T, B, S)).astype(np.float32)
    W = (2.0 * rng.standard_normal((S, nstate))).astype(np.float32)
    b = rng.standard_normal(nstate).astype(np.float32)
    head = dict(min_prob=1e-5, tempW=temps[0], tempb=temps[1])
    dp = dict(stay_pen=0.1, skip_pen=0.3, local_pen=2.0)
    jfinal, jtb = jv.viterbi_fused_tm(jnp.asarray(h), jnp.asarray(W),
                                      jnp.asarray(b), interpret=True, **head, **dp)
    ops.reset_launches()
    lp = tv.head_logpost_tm(*map(torch.from_numpy, (h, W, b)), **head)
    final, tb = tv.viterbi_scores_tm(lp, **dp)
    assert ops.LAUNCHES["head"] == 0  # a CPU tensor takes the twin
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                               rtol=1e-5, atol=1e-5)
    fused = tv.viterbi_fused_tm_plain(*map(torch.from_numpy, (h, W, b)), **head,
                                      **dp)
    assert torch.equal(final, fused[0]) and torch.equal(tb, fused[1])


def test_head_input_check_refuses_what_the_kernel_cannot_take():
    h, W, b = torch.zeros((4, 2, 16)), torch.zeros((16, 65)), torch.zeros(65)
    tv.check_head_input(h, W, b)
    tv.check_head_input(h[None].repeat(5, 1, 1, 1), W[None].repeat(5, 1, 1),
                        b[None].repeat(5, 1), torch.ones(5) / 5)
    with pytest.raises(ValueError, match="contiguous"):
        tv.check_head_input(h.transpose(0, 1).contiguous().transpose(0, 1), W, b)
    with pytest.raises(ValueError, match="shape"):
        tv.check_head_input(h, W[:8], b)
    with pytest.raises(ValueError, match="weights"):
        tv.check_head_input(h[None].repeat(2, 1, 1, 1), W[None].repeat(2, 1, 1),
                            b[None].repeat(2, 1), torch.ones(3) / 3)
    # the kernel's clusters hold at most 8 x 136 states; an S whose h
    # stages and W slice do not fit in shared memory (above 208), or that
    # is not a multiple of 4, is taken by its streamed mode
    S = 512
    tv.check_head_input(torch.zeros((2, 2, S)), torch.zeros((S, 65)), b)
    assert tv.head_streams(S)
    with pytest.raises(ValueError, match="states"):
        tv.check_head_input(h, torch.zeros((16, 1089)), torch.zeros(1089))
    tv.check_head_input(torch.zeros((2, 2, 208)), torch.zeros((208, 1088)),
                        torch.zeros(1088))
    assert not tv.head_streams(208)
    tv.check_head_input(torch.zeros((2, 2, 212)), torch.zeros((212, 65)), b)
    tv.check_head_input(torch.zeros((2, 2, 18)), torch.zeros((18, 65)), b)
    assert tv.head_streams(212) and tv.head_streams(18)
    S = 212
    tv.check_head_input(torch.zeros((2, 2, 2, S)), torch.zeros((2, S, 65)),
                        torch.zeros((2, 65)), torch.ones(2) / 2)


def _hand_tracebacks(B, T, nhist, seed):
    """Tracebacks [T, B, nhist+2] int16 and finals [B, nhist+2] built by
    hand, as chip_smoke.py's hand_tracebacks builds them on the card: every
    entry a stay; random moves whose START column is START, best final
    START (a START run over the whole row); random moves, best final END,
    END staying END over the last third and every history state moving to
    START at step T // 3 (leading START and trailing END runs); finals tied
    at 0 and 1."""
    rng = np.random.default_rng(seed)
    nst2 = nhist + 2
    start, end = nhist, nhist + 1
    moves = rng.integers(-1, nhist, (T, B, nst2)).astype(np.int16)
    moves[:, :, start] = start
    final = rng.standard_normal((B, nst2)).astype(np.float32)
    start_final = final.copy()
    start_final[:, start] = 1e3
    runs = moves.copy()
    runs[T // 3, :, :nhist] = start
    runs[2 * T // 3:, :, end] = end
    runs[2 * T // 3 - 1, :, end] = 5
    end_final = final.copy()
    end_final[:, end] = 1e3
    ties = rng.integers(0, 2, (B, nst2)).astype(np.float32)
    return {"all-stay": (final, np.full_like(moves, -1)),
            "start-run": (start_final, moves),
            "start-and-end-runs": (end_final, runs),
            "tied-finals": (ties, moves)}


HAND_CASES = ["all-stay", "start-run", "start-and-end-runs", "tied-finals"]


@pytest.mark.parametrize("case", HAND_CASES)
def test_backtrace_twin_matches_jax_on_hand_built_tracebacks(case):
    B, T, nhist = 3, 21, 64
    final, tb = _hand_tracebacks(B, T, nhist, seed=HAND_CASES.index(case))[case]
    score, path = tv.viterbi_backtrace_tm_plain(torch.from_numpy(final),
                                                torch.from_numpy(tb))
    jscore, jpath = jv.viterbi_backtrace_tm(jnp.asarray(final), jnp.asarray(tb),
                                            interpret=True)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    sscore, spath = jdec.viterbi_local_backtrace(jnp.asarray(final),
                                                 jnp.asarray(np.moveaxis(tb, 1, 0)))
    np.testing.assert_array_equal(path.numpy(), np.asarray(spath))
    np.testing.assert_array_equal(score.numpy(), np.asarray(sscore))
    p = path.numpy()
    if case in ("all-stay", "start-run"):
        assert (p[:, 1:] == -1).all()
    if case == "start-and-end-runs":
        # both runs, a third of the row each, became stays
        assert (p[:, :T // 3 + 1] == -1).all() and (p[:, 2 * T // 3:] == -1).all()


# (T, B, nst2, SMs) -> segments of each row's walk
SEGMENT_CASES = [
    (0, 8, 1026, 132, 1),        # no steps
    (100, 8, 1026, 132, 1),      # under two segments of BT_MIN_SEG steps
    (300, 1, 1026, 132, 4),      # T // BT_MIN_SEG bounds it
    (2000, 8, 1026, 132, 16),    # the fast engine's batch: BT_MAX_SEG
    (12500, 4, 1026, 132, 16),   # a stitch bucket
    (2000, 16, 1026, 132, 8),    # sms // B
    (2000, 17, 1026, 132, 1),    # fewer than BT_MIN_SMS_A_ROW SMs a row
    (2000, 64, 1026, 132, 1),    # the fused path's batch: one pass a row
    (2000, 8, 16 * 224, 132, 16),
    (2000, 8, 16 * 224 + 1, 132, 1),  # more states than the maps kernel holds
    (2000, 0, 1026, 132, 1),     # no rows
]


@pytest.mark.parametrize("T,B,nst2,sms,K", SEGMENT_CASES)
def test_backtrace_segments(T, B, nst2, sms, K):
    assert tv.backtrace_segments(T, B, nst2, sms) == K
    assert tv.BT_MAPS_MAX_STATES == 16 * 224
