"""The head kernel's launch plan and input limits (ops/viterbi.py, the
Python mirror of csrc/head.cu's layout), and the kernel's arithmetic
emulated in numpy at its own granularity (column slices of a cluster's
CTAs, each CTA's maximum and sum of exponentials merged across the
cluster, p = exp(y - m_cta) * exp(m_cta - m) / sum) against the plain twin
and, decoded, against scrappie_tpu's fused ensemble kernel. The kernel
itself runs only on the card (chip_smoke.py phase head_kernel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.models import registry
from scrappie_torch.ops import viterbi as tv
from scrappie_tpu.ops import viterbi as jv

torch.set_num_threads(1)
HEAD_RTOL, HEAD_ATOL = 1e-6, 1e-5  # chip_smoke.py's gate, kernel to twin
H100_CLUSTERS = 30  # clusters of 8 CTAs an H100 holds at once (2 CTAs an SM)
# the shipped models with a transducer head, and its weight's key
TRANSDUCER_HEADS = {"rgrgr_r94": "FF_W", "rgrgr_r941": "FF_W",
                    "rgrgr_r10": "FF_W", "raw_r94": "FF3_W",
                    "nanonet_events": "FF3_W"}


@pytest.mark.parametrize("B, tiles, clusters, per_cluster",
                         [(1, 32, 30, 2), (8, 250, 30, 9), (64, 2000, 30, 67),
                          (256, 8000, 30, 267)])
def test_launch_plan_fills_the_card_from_b8(B, tiles, clusters, per_cluster):
    """T = 2000 blocks of B chunks at 1025 states: clusters of 8 CTAs, 64
    rows a tile, persistent clusters up to what the card holds (two CTAs an
    SM); at B = 8 (M = 16 000) every cluster the card holds has tiles."""
    plan = tv.head_launch(2000 * B, 96, 1025, H100_CLUSTERS)
    assert plan == {"cluster": 8, "tiles": tiles, "clusters": clusters,
                    "blocks": 8 * clusters, "rows_per_tile": 64,
                    "tiles_per_cluster": per_cluster, "streamed": False,
                    "smem_bytes": 105016}


@pytest.mark.parametrize("M, nstate, most, cluster, clusters",
                         [(1, 1025, 30, 8, 1), (129, 1025, 30, 8, 3),
                          (1000, 65, 264, 1, 16), (5000, 25, 264, 1, 79),
                          (5000, 137, 132, 2, 79), (10 ** 6, 1088, 30, 8, 30)])
def test_launch_plan_shapes(M, nstate, most, cluster, clusters):
    plan = tv.head_launch(M, 96, nstate, most)
    assert plan["cluster"] == cluster and plan["clusters"] == clusters
    assert plan["blocks"] == cluster * clusters
    assert plan["tiles"] == -(-M // tv.HEAD_RT)
    assert plan["tiles_per_cluster"] * clusters >= plan["tiles"]
    assert (plan["tiles_per_cluster"] - 1) * clusters < plan["tiles"]
    assert (cluster - 1) * tv.HEAD_NC < nstate <= cluster * tv.HEAD_NC


def test_smem_mirror():
    """head_smem_bytes mirrors csrc/head.cu's smem_bytes: two h stages of
    64 rows at a pitch 4 mod 32, the W slice of 136 states and its bias
    row, the rows' pairs double-buffered, three mbarriers; at S = 96 two
    CTAs share an SM's 228 KB."""
    assert [tv.head_k_extent(S) for S in (1, 16, 17, 96, 100, 128)] == \
        [16, 16, 32, 96, 112, 128]
    assert [tv.head_pitch(S) for S in (1, 32, 96, 100, 128)] == \
        [36, 36, 100, 132, 132]
    assert all(tv.head_pitch(S) % 32 == 4 for S in range(1, 300))
    assert tv.head_smem_bytes(96) == 4 * (2 * 64 * 100 + 97 * 136 + 256) + 24
    assert 2 * (tv.head_smem_bytes(96) + 1024) <= 228 * 1024
    assert tv.head_smem_bytes(208) <= ops.MAX_SMEM_BYTES < tv.head_smem_bytes(209)
    # streamed: one stage of 128 columns and a W chunk of 128 rows, any S
    streamed = 4 * (64 * 132 + 128 * 136 + 256) + 24
    assert {tv.head_smem_bytes(S, True) for S in (1, 96, 209, 352, 4096)} == {streamed}
    assert 2 * (streamed + 1024) <= 228 * 1024


@pytest.mark.parametrize("S, aligned, streamed",
                         [(96, True, False), (208, True, False), (4, True, False),
                          (96, False, True), (18, True, True), (1, True, True),
                          (209, True, True), (212, True, True), (288, True, True),
                          (352, True, True), (512, True, True)])
def test_streamed_mode_takes_what_the_resident_cannot(S, aligned, streamed):
    """The resident mode needs S a multiple of 4, h 16-byte aligned and its
    stages in shared memory (S <= 208); any other S runs streamed, and the
    launch plan says which mode and how much shared memory."""
    assert tv.head_streams(S, aligned) == streamed
    plan = tv.head_launch(16000, S, 1025, H100_CLUSTERS, streamed)
    assert plan["streamed"] == streamed
    assert plan["smem_bytes"] == tv.head_smem_bytes(S, streamed) <= ops.MAX_SMEM_BYTES


@pytest.mark.parametrize("model", sorted(TRANSDUCER_HEADS))
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
def test_check_head_input_takes_every_shipped_head(model, K):
    """Every shipped transducer head (S = 96, 1025 states) passes the
    kernel's input check alone (K = 1, no weights) and as K members, and
    its shared memory leaves room for two CTAs an SM."""
    W = torch.from_numpy(registry.load_params(model)[TRANSDUCER_HEADS[model]])
    S, nstate = W.shape
    assert (S, nstate) == (96, 1025)
    h = torch.zeros((7, 3, S))
    b = torch.zeros(nstate)
    assert 2 * (tv.head_smem_bytes(S) + 1024) <= 228 * 1024
    if K == 1:
        tv.check_head_input(h, W, b)
    tv.check_head_input(h[None].repeat(K, 1, 1, 1), W[None].repeat(K, 1, 1),
                        b[None].repeat(K, 1), torch.ones(K) / K)


@pytest.mark.parametrize("S, nstate, combine, what",
                         [(96, 1089, False, "states"), (96, 1089, True, "states"),
                          (16, 0, False, "states"), (0, 65, False, "S >= 1"),
                          (0, 65, True, "S >= 1")])
def test_check_head_input_limits(S, nstate, combine, what):
    h, W, b = torch.zeros((4, 2, S)), torch.zeros((S, nstate)), torch.zeros(nstate)
    args = ((h[None].repeat(2, 1, 1, 1), W[None].repeat(2, 1, 1),
             b[None].repeat(2, 1), torch.ones(2) / 2) if combine else (h, W, b))
    with pytest.raises(ValueError, match=what):
        tv.check_head_input(*args)


@pytest.mark.parametrize("S, nstate, combine", [(208, 1088, False), (208, 1088, True),
                                                (4, 1, True), (8, 137, False),
                                                (212, 1025, False), (212, 1025, True),
                                                (18, 65, False), (6, 65, True),
                                                (288, 1025, False), (352, 1025, True)])
def test_check_head_input_edges_taken(S, nstate, combine):
    """The resident mode's edges, and widths only the streamed mode takes
    (the big-S GRU's 352 and LSTM's 288 among them)."""
    h, W, b = torch.zeros((4, 2, S)), torch.zeros((S, nstate)), torch.zeros(nstate)
    if combine:
        tv.check_head_input(h[None], W[None], b[None], torch.ones(1))
    else:
        tv.check_head_input(h, W, b)


def test_column_order_puts_a_threads_states_in_one_load():
    """head_column_order mirrors csrc/head.cu's fp32 path: thread cx (of
    8) reads states cx + 8 j; its j = 4 g + e (e < 4) lie at columns
    32 g + 4 cx + e, one 16-byte load a group, and j = 16 at 128 + cx."""
    order = tv.head_column_order()
    assert sorted(order) == list(range(tv.HEAD_NC))
    for cx in range(8):
        for j in range(17):
            col = 32 * (j // 4) + 4 * cx + j % 4 if j < 16 else 128 + cx
            assert order[col] == cx + 8 * j


@pytest.mark.parametrize("K, S, nstate, fp32_order",
                         [(1, 96, 1025, True), (3, 96, 1025, False),
                          (2, 8, 300, True), (1, 20, 65, False)])
def test_weight_image_holds_the_heads(K, S, nstate, fp32_order):
    """head_weight_image: each CTA's slice as shared memory holds it, W's
    rows (zeros to k_extent), then the bias row; undone, it gives back W
    and bvec exactly, and the twin on them the same log posterior."""
    rng = np.random.default_rng(K * S + nstate)
    W = torch.from_numpy(rng.standard_normal((K, S, nstate)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, nstate)).astype(np.float32))
    img = tv.head_weight_image(W, b, fp32_order)
    ncl, sk = -(-nstate // tv.HEAD_NC), tv.head_k_extent(S)
    assert img.shape == (K, ncl, sk + 1, tv.HEAD_NC) and img.is_contiguous()
    rows = img[:, :, :sk]
    if fp32_order:  # undo the column order
        order = torch.tensor(tv.head_column_order())
        rows = torch.empty_like(rows).index_copy_(3, order, rows)
    Wb = rows.permute(0, 2, 1, 3).reshape(K, sk, ncl * tv.HEAD_NC)
    bb = img[:, :, sk].reshape(K, ncl * tv.HEAD_NC)
    assert torch.equal(Wb[:, :S, :nstate], W) and not Wb[:, S:].any()
    assert not Wb[:, :, nstate:].any() and not bb[:, nstate:].any()
    assert torch.equal(bb[:, :nstate], b)
    h = torch.from_numpy(rng.uniform(-1, 1, (K, 5, 2, S)).astype(np.float32))
    w = torch.ones(K) / K
    assert torch.equal(tv.head_logpost_tm_plain(h, Wb[:, :S, :nstate].contiguous(),
                                                bb[:, :nstate].contiguous(), w),
                       tv.head_logpost_tm_plain(h, W, b, w))


def test_weight_image_is_made_once_per_weight_tensor():
    """head_image caches the image while W and bvec live unchanged: the
    same tensor on every call, a new one after an in-place change, and
    the cache entry goes with the weights."""
    import gc

    W, b = torch.randn(96, 1025), torch.randn(1025)
    first = tv.head_image(W, b, True)
    assert tv.head_image(W, b, True) is first
    assert tv.head_image(W, b, False) is not first  # the mma paths' order
    assert torch.equal(tv.head_image(W, b, True)[0, :, 96],
                       tv.head_weight_image(W[None], b[None], True)[0, :, 96])
    with torch.no_grad():
        W.add_(1.0)
    again = tv.head_image(W, b, True)
    assert again is not first
    assert torch.equal(again, tv.head_weight_image(W[None], b[None], True))
    before = len(ops._DERIVED)
    del W, b, first, again
    gc.collect()
    assert len(ops._DERIVED) == before - 2
    # a member's head taken anew from the stacked heads each call
    W3, b3 = torch.randn(3, 96, 1025), torch.randn(3, 1025)
    assert tv.head_image(W3[1], b3[1], True) is tv.head_image(W3[1], b3[1], True)
    assert torch.equal(tv.head_image(W3[1], b3[1], True),
                       tv.head_weight_image(W3[1:2], b3[1:2], True))
    assert tv.head_image(W3[0], b3[0], True) is not tv.head_image(W3[1], b3[1], True)


def test_weight_image_of_inference_tensors_is_made_each_call():
    """An inference tensor keeps no version counter: its image is never
    cached, so an in-place change inside inference mode is seen; a value
    derived from normal tensors under inference mode is a normal tensor,
    so what is derived from it is cached in turn."""
    with torch.inference_mode():
        W, b = torch.randn(96, 1025), torch.randn(1025)
        before = len(ops._DERIVED)
        first = tv.head_image(W, b, True)
        assert len(ops._DERIVED) == before
        W.add_(1.0)  # allowed on an inference tensor inside inference mode
        again = tv.head_image(W, b, True)
        assert torch.equal(again, tv.head_weight_image(W[None], b[None], True))
        assert not torch.equal(again, first)
        lp = tv.head_logpost_tm(torch.randn(5, 2, 96), W, b)
    Wn, bn = torch.randn(2, 96, 1025), torch.randn(2, 1025)
    with torch.inference_mode():
        stacked = ops.derived("test stack", (Wn, bn), lambda: Wn * 2.0)
        assert not stacked.is_inference()
        assert ops.derived("test stack", (Wn, bn), lambda: Wn * 3.0) is stacked
        assert tv.head_image(stacked, bn, True) is tv.head_image(stacked, bn, True)
    assert torch.isfinite(lp).all()


def test_loaded_weights_are_normal_tensors_under_inference_mode():
    """The port's loaders place weights as normal tensors even inside
    inference mode, so the head's image of a loaded model is cached and
    an in-place update of its weights is seen."""
    from scrappie_torch.models.forward import load_model
    from scrappie_torch.parallel import sharding

    with torch.inference_mode():
        net = load_model("rgrgr_r94", "cpu")
        W, b = net.params["FF_W"], net.params["FF_b"]
        assert not W.is_inference() and not b.is_inference()
        image = tv.head_image(W, b, True)
        assert tv.head_image(W, b, True) is image
        # a normal tensor's in-place change inside inference mode bumps its
        # version (a copy: on the CPU W shares the registry's cached array)
        with torch.inference_mode(False):
            Wc = W.clone()
        image = tv.head_image(Wc, b, True)
        Wc.mul_(0.5)
        assert tv.head_image(Wc, b, True) is not image
        assert torch.equal(tv.head_image(Wc, b, True),
                           tv.head_weight_image(Wc[None], b[None], True))
        placed = sharding._place(np.ones((3, 4), np.float32), torch.device("cpu"))
        assert not placed.is_inference()


def _pair_merge(m1, s1, m2, s2):
    """csrc/head.cu's merge: commutative, -inf an empty part."""
    mo = np.maximum(m1, m2)
    with np.errstate(invalid="ignore"):
        a = np.where(m1 == -np.inf, 0, s1 * np.exp(m1 - mo))
        b = np.where(m2 == -np.inf, 0, s2 * np.exp(m2 - mo))
    return mo, (a + b).astype(np.float32)


def _cluster_stats(y):
    """The kernel's row statistics of y [M, nstate]: each CTA's slice of
    HEAD_NC states gives (max, sum of exp(y - max)); the pairs of up to 8
    CTAs merge in the butterfly of the 8 lanes of a row. Returns the CTAs'
    maxima [M, ncl], their exponentials and the rows' (m, s)."""
    M, nstate = y.shape
    ncl = -(-nstate // tv.HEAD_NC)
    pad = np.full((M, 8 * tv.HEAD_NC), -np.inf, np.float32)
    pad[:, :nstate] = y
    parts = pad.reshape(M, 8, tv.HEAD_NC)
    pm = parts.max(-1)
    with np.errstate(invalid="ignore"):
        e = np.where(parts == -np.inf, 0, np.exp(parts - pm[..., None])).astype(np.float32)
    ps = e.sum(-1, dtype=np.float32)
    pm[:, ncl:], ps[:, ncl:] = -np.inf, 0
    m, s = pm, ps
    for off in (1, 2, 4):
        idx = np.arange(8) ^ off
        m, s = _pair_merge(m, s, m[:, idx], s[:, idx])
    return pm, e, m[:, 0], s[:, 0]


def _emulate_head(h, W, b, weights, min_prob, tempW, tempb):
    """csrc/head.cu's arithmetic in float32: h [K, M, S] ... -> lp."""
    K, M, S = h.shape
    nstate = W.shape[-1]
    c0, c1 = np.float32(min_prob / nstate), np.float32(1.0 - min_prob)
    acc = None
    for k in range(K):
        y = ((h[k] * np.float32(tempb / tempW)) @ W[k] + b[k]) / np.float32(tempb)
        pm, e, m, s = _cluster_stats(y.astype(np.float32))
        rs = (np.exp(pm - m[:, None]) / s[:, None]).astype(np.float32)
        p = (e * rs[..., None]).reshape(M, -1)[:, :nstate]
        lk = np.log(c0 + c1 * p)
        if weights is None:
            return lk
        lk = lk * weights[k]
        acc = lk if acc is None else acc + lk
    _, _, m, s = _cluster_stats(acc)
    return acc - (m + np.log(s))[:, None]


@pytest.mark.parametrize("K, M, nstate, temps",
                         [(None, 300, 1025, (1.0, 1.0)), (None, 130, 65, (1.2, 0.9)),
                          (3, 257, 1025, (1.0, 1.0)), (5, 140, 300, (0.8, 1.25))])
def test_emulated_kernel_matches_twin(K, M, nstate, temps):
    """The kernel's order of the softmax (a CTA's max and sum, merged over
    the cluster; p from the CTA's exponential) against the plain twin,
    within chip_smoke.py's HEAD_RTOL / HEAD_ATOL."""
    rng = np.random.default_rng(M + nstate)
    S = 16
    k = 1 if K is None else K
    h = np.tanh(2 * rng.standard_normal((k, M, S))).astype(np.float32)
    W = (2.0 * rng.standard_normal((k, S, nstate))).astype(np.float32)
    b = rng.standard_normal((k, nstate)).astype(np.float32)
    w = None if K is None else (rng.uniform(0.5, 2, K) / 3).astype(np.float32)
    w = None if w is None else (w / w.sum()).astype(np.float32)
    head = dict(min_prob=1e-5, tempW=temps[0], tempb=temps[1])
    got = _emulate_head(h, W, b, w, **head)
    if K is None:
        want = tv.head_logpost_tm(*map(torch.from_numpy, (h[0], W[0], b[0])), **head)
    else:
        want = tv.head_logpost_tm(*map(torch.from_numpy, (h[:, :, None], W, b, w)),
                                  **head)[:, 0]
    want = want.numpy()
    np.testing.assert_allclose(got, want, rtol=HEAD_RTOL, atol=HEAD_ATOL)


def test_emulated_kernel_decodes_as_jax_ensemble_kernel():
    """The same emulation for three members at T = 20, B = 3 (M = 60),
    nhist 64, decoded by the forward twin, against scrappie_tpu's
    _fused_ens_kernel (interpret mode; inputs lane-padded to S = 128 as in
    tests/test_torch_ensemble.py): tracebacks equal, finals within 1e-5."""
    rng = np.random.default_rng(7)
    K, T, B, S, nstate, Sp = 3, 20, 3, 16, 65, 128
    h = rng.standard_normal((K, T, B, S)).astype(np.float32)
    W = (rng.standard_normal((K, S, nstate)) / 2).astype(np.float32)
    b = rng.standard_normal((K, nstate)).astype(np.float32)
    w = np.array([0.6, 0.2, 0.2], np.float32)
    head = dict(min_prob=1e-5, tempW=1.2, tempb=0.9)
    dp = dict(stay_pen=0.3, skip_pen=1.1, local_pen=4.0, use_slip=True)
    jfinal, jtb = jv.viterbi_fused_ens_tm(
        jnp.asarray(np.pad(h, ((0, 0), (0, 0), (0, 0), (0, Sp - S)))),
        jnp.asarray(np.pad(W, ((0, 0), (0, Sp - S), (0, 0)))), jnp.asarray(b),
        jnp.asarray(w), interpret=True, **head, **dp)
    lp = _emulate_head(h.reshape(K, T * B, S), W, b, w, **head)
    final, tb = tv.viterbi_scores_tm(torch.from_numpy(lp.reshape(T, B, nstate)), **dp)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-5,
                               atol=1e-5)
