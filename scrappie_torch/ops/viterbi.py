"""Transducer Viterbi: the head, forward, fused head + forward (one model
or an ensemble), and backtrace.

Counterpart of scrappie_tpu/ops/viterbi.py (viterbi_scores_tm,
viterbi_fused_tm, viterbi_fused_ens_tm, viterbi_backtrace_tm) and of the
lax.scan programs in
scrappie_tpu/decode/transducer.py, whose semantics and tie rules the
plain twins here copy step for step:

  * candidates contend in the order stay, step, skip, slip, start-exit,
    each with a strict `>`;
  * within a predecessor group the first maximum wins;
  * END is entered from the first best history state.

On a CUDA tensor each wrapper launches its kernel from csrc/viterbi.cu
(the head: csrc/head.cu); on a CPU tensor it runs its `*_plain` twin.
Layouts are time-major, as in the JAX wrappers: lp [T, B, nhist+1] ->
final [B, nhist+2] f32 and a traceback [T, B, nhist+2] int16.

The fast paths (ops/pipeline.py) decode with `head_logpost_tm`, which
writes the [T, B, nstate] log posterior of one model or of K combined, and
`viterbi_scores_tm`. The fused kernels, `viterbi_fused_tm` and
`viterbi_fused_ens_tm`, compute the same in one kernel without the
posterior in device memory; they are kept and no path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scrappie_torch import ops
from scrappie_torch.nn import config
from scrappie_torch.nn.layers import affine, robustlog, softmax_with_temperature

BIG = 1.0e30
#: The most members the fused ensemble kernel takes (MAX_ENS in
#: csrc/viterbi.cu). No path needs it: the head kernel combines any number.
MAX_ENS = 4
#: Traceback entries are int16, so every state index (up to nhist + 1) is
#: below 2^15.
MAX_TB_STATE = 2**15 - 1
#: csrc/head.cu's layout: a cluster of ceil(nstate / HEAD_NC) CTAs, at
#: most HEAD_MAX_CLUSTER, splits a row's states, HEAD_NC a CTA, and walks
#: tiles of HEAD_RT rows; HEAD_THREADS threads a CTA, a warp 16 rows; the
#: streamed mode takes the depth HEAD_KC at a time.
HEAD_RT, HEAD_NC, HEAD_MAX_CLUSTER, HEAD_THREADS = 64, 136, 8, 128
HEAD_KC = 128
#: csrc/viterbi.cu's forward: at most FWD_THREADS_MAX history threads a
#: block (whole warps), each owning FWD_QUADS[i] quads of four states,
#: and one more warp that does the END state alone.
FWD_THREADS_MAX = 512
FWD_QUADS = (1, 2, 4, 8, 16)
#: csrc/viterbi.cu's backtrace splits a row's walk in time only while the
#: rows leave at least BT_MIN_SMS_A_ROW SMs a row and the segments' maps
#: kernel holds a row's states (BT_MAPS_MAX_STATES: 16 a thread on 224
#: threads), into at most BT_MAX_SEG segments of at least BT_MIN_SEG steps.
BT_MIN_SMS_A_ROW = 8
BT_MIN_SEG = 64
BT_MAX_SEG = 16
BT_MAPS_MAX_STATES = 16 * 224


def _check_nhist(nhist: int, use_slip: bool) -> None:
    group = 64 if use_slip else 16
    if nhist % group:
        raise ValueError(f"nhist={nhist} not divisible by {group}")


def viterbi_scores_tm_plain(lp_tm, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                            use_slip: bool = False):
    """Plain twin of the forward kernel (decode/transducer.py's scan)."""
    T, B, nstate = lp_tm.shape
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    START, END = nhist, nhist + 1
    stay_pen, skip_pen, local_pen = map(ops.f32, (stay_pen, skip_pen, local_pen))
    dev = lp_tm.device
    lp_tm = torch.clamp(lp_tm, min=-BIG)

    hist = torch.full((B, nhist), -BIG, dtype=torch.float32, device=dev)
    start = torch.zeros(B, dtype=torch.float32, device=dev)
    end = torch.full((B,), -BIG, dtype=torch.float32, device=dev)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=dev)
    tb[:, :, START] = START
    moves = [(4, None), (16, skip_pen)]
    if use_slip:
        moves.append((64, 2.0 * skip_pen))
    groups = {n: torch.arange(nhist // n, device=dev).repeat_interleave(n)
              for n, _ in moves}

    for t in range(T):
        lph = lp_tm[t, :, :nhist]
        stay_lp = lp_tm[t, :, nhist] - stay_pen
        score = hist + stay_lp[:, None]
        tbt = torch.full((B, nhist), -1, dtype=torch.int64, device=dev)
        for n, pen in moves:
            q = nhist // n
            m, r = ops.first_argmax(hist.view(B, n, q), 1)
            cand = lph + m.repeat_interleave(n, dim=1)
            if pen is not None:
                cand = cand - pen
            pred = r.repeat_interleave(n, dim=1) * q + groups[n]
            upd = cand > score
            score = torch.where(upd, cand, score)
            tbt = torch.where(upd, pred, tbt)
        cand = start[:, None] + lph
        upd = cand > score
        score = torch.where(upd, cand, score)
        tbt = torch.where(upd, START, tbt)

        local_stay = torch.clamp(stay_lp, min=-local_pen)
        end_score = end + local_stay
        m, entb = ops.first_argmax(hist, 1)
        enter = m - local_pen
        better = enter > end_score
        end = torch.where(better, enter, end_score)
        start = start + local_stay
        hist = score
        tb[t, :, :nhist] = tbt
        tb[t, :, END] = torch.where(better, entb, END)
    final = torch.cat([hist, start[:, None], end[:, None]], dim=1)
    return final, tb


def viterbi_backtrace_tm_plain(final, tb_tm):
    """Plain twin of the backtrace kernel: final [B, nhist+2], tb
    [T, B, nhist+2] -> (score [B], path [B, T+1] int32), stay = -1, the
    leading START and trailing END runs transcoded to -1."""
    T, B, nst2 = tb_tm.shape
    START, END = nst2 - 2, nst2 - 1
    score, cur = ops.first_argmax(final, 1)
    path = torch.empty((B, T + 1), dtype=torch.int64, device=final.device)
    for t in range(T - 1, -1, -1):
        state = tb_tm[t].gather(1, cur[:, None])[:, 0].long()
        emit = state >= 0
        path[:, t + 1] = torch.where(emit, cur, -1)
        cur = torch.where(emit, state, cur)
    path[:, 0] = cur
    lead = (path == START).int().cumprod(1).bool()
    trail = (path == END).flip(1).int().cumprod(1).flip(1).bool()
    path = torch.where(lead | trail, -1, path)
    return score, path.int()


def viterbi_fused_tm_plain(h_tm, W, bvec, min_prob=1e-5, tempW=1.0, tempb=1.0,
                           stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                           use_slip: bool = False):
    """Plain twin of the fused kernel: the head (temperature softmax and
    robustlog), then the forward twin."""
    lp = robustlog(softmax_with_temperature(h_tm, W, bvec, tempW, tempb),
                   min_prob)
    return viterbi_scores_tm_plain(lp, stay_pen, skip_pen, local_pen, use_slip)


def head_softmax(h_tm, W, bvec, tempW=1.0, tempb=1.0, rounding=None):
    """softmax_with_temperature with its product's operands rounded by
    `rounding` (None, 'tf32', 'bf16'), the scaled h before its rounding:
    the head kernel's softmax in each mode."""
    y = affine(h_tm * (tempb / tempW), W, bvec, rounding) / tempb
    return torch.softmax(y, dim=-1)


def ensemble_logpost_tm(h_tm, W, bvec, weights, min_prob=1e-5, tempW=1.0,
                        tempb=1.0, rounding=None):
    """The combined log posterior of K transducer heads: h [K, T, B, S],
    W [K, S, nstate], bvec [K, nstate], weights [K] -> [T, B, nstate],
    sum_k w_k robustlog(softmax_k) in member order, renormalised per block
    by its log-sum-exp (scrappie_tpu's _fused_ens_kernel)."""
    acc = None
    for k in range(h_tm.shape[0]):
        lk = robustlog(head_softmax(h_tm[k], W[k], bvec[k], tempW, tempb,
                                    rounding), min_prob) * weights[k]
        acc = lk if acc is None else acc + lk
    mx = acc.amax(-1, keepdim=True)
    return acc - (mx + torch.log(torch.exp(acc - mx).sum(-1, keepdim=True)))


def viterbi_fused_ens_tm_plain(h_tm, W, bvec, weights, min_prob=1e-5,
                               tempW=1.0, tempb=1.0, stay_pen=0.0, skip_pen=0.0,
                               local_pen=2.0, use_slip: bool = False):
    """Plain twin of the fused ensemble kernel: the combined log posterior,
    then the forward twin."""
    lp = ensemble_logpost_tm(h_tm, W, bvec, weights, min_prob, tempW, tempb)
    return viterbi_scores_tm_plain(lp, stay_pen, skip_pen, local_pen, use_slip)


def head_logpost_tm_plain(h_tm, W, bvec, weights=None, min_prob=1e-5,
                          tempW=1.0, tempb=1.0, rounding=None):
    """Plain twin of the head kernel: one model's log posterior (weights
    None; h [T, B, S], W [S, nstate], bvec [nstate]), robustlog of the
    temperature softmax, or K members' combined, ensemble_logpost_tm; the
    product's operands rounded by `rounding` (None, 'tf32', 'bf16')."""
    if weights is None:
        return robustlog(head_softmax(h_tm, W, bvec, tempW, tempb, rounding),
                         min_prob)
    return ensemble_logpost_tm(h_tm, W, bvec, weights, min_prob, tempW, tempb,
                               rounding)


def head_k_extent(S: int) -> int:
    """Depth of the head kernel's product: S rounded up to 16."""
    return -(-S // 16) * 16


def head_pitch(S: int) -> int:
    """Row pitch (floats) of the head kernel's h stage: at least
    head_k_extent(S) and 4 mod 32, so that a warp's rows fall on distinct
    banks."""
    sk = head_k_extent(S)
    return sk + 4 if sk % 32 == 0 else sk + 20


def head_smem_bytes(S: int, streamed: bool = False) -> int:
    """Dynamic shared memory a CTA of the head kernel needs for hidden size
    S. Resident: two stages of a tile's h rows [HEAD_RT][pitch], the W
    slice and its bias [k_extent + 1][HEAD_NC], the rows' (max, sum)
    pairs, double-buffered, and three mbarriers of 8 bytes (105 016 B at
    S = 96: two CTAs an SM). Streamed: one stage of HEAD_KC columns and a
    W chunk [HEAD_KC][HEAD_NC] in place of the first two, whatever S."""
    if streamed:
        stage, wrows = HEAD_RT * head_pitch(HEAD_KC), HEAD_KC
    else:
        stage, wrows = 2 * HEAD_RT * head_pitch(S), head_k_extent(S) + 1
    return 4 * (stage + wrows * HEAD_NC + 4 * HEAD_RT) + 24


def head_streams(S: int, h_aligned: bool = True) -> bool:
    """Whether the head kernel runs its streamed mode: S not a multiple of
    4 or h not 16-byte aligned (its rows cannot be bulk copies), or the
    resident stages too large for shared memory (S above 208)."""
    return (S % 4 != 0 or not h_aligned
            or head_smem_bytes(S) > ops.MAX_SMEM_BYTES)


def head_column_order() -> list[int]:
    """The state at each column of a CTA's W slice in the head kernel's
    fp32 path: each group of 32 permuted so that thread cx's states cx +
    8 e (e < 4) are one 16-byte load; the last 8 in order."""
    order = list(range(HEAD_NC))
    for c in range(128):
        order[(c & ~31) + 4 * (c & 7) + ((c >> 3) & 3)] = c
    return order


@functools.lru_cache(maxsize=None)
def _column_order(device: torch.device) -> torch.Tensor:
    return torch.tensor(head_column_order(), device=device)


def head_weight_image(W, bvec, fp32_order: bool):
    """W [K, S, nstate] and bvec [K, nstate] as the head kernel's CTAs hold
    their slices in shared memory: [K, ceil(nstate / HEAD_NC),
    head_k_extent(S) + 1, HEAD_NC], W's rows then the bias, zeros past S
    and nstate, W's columns in head_column_order for the fp32 path
    ('highest'), so that each slice is one bulk copy."""
    K, S, nstate = W.shape
    ncl, sk = -(-nstate // HEAD_NC), head_k_extent(S)
    img = W.new_zeros((K, sk + 1, ncl * HEAD_NC))
    img[:, :S, :nstate] = W
    img[:, sk, :nstate] = bvec
    img = img.view(K, sk + 1, ncl, HEAD_NC).transpose(1, 2).contiguous()
    if fp32_order:
        img[:, :, :sk] = img[:, :, :sk, _column_order(W.device)]
    return img


def head_image(W, bvec, fp32_order: bool):
    """head_weight_image of one model's W [S, nstate], bvec [nstate] or K
    members' [K, S, nstate], [K, nstate], made once while W and bvec live
    unchanged and cached (ops.derived): once per weight tensor, not per
    call. Weights that are inference tensors keep no version to check, so
    their image is made anew each call (the port's loaders place weights
    as normal tensors, models/convert.params_from_numpy)."""
    one = W.dim() == 2
    return ops.derived(f"head image {fp32_order}", (W, bvec),
                       lambda: head_weight_image(W[None] if one else W,
                                                 bvec[None] if one else bvec,
                                                 fp32_order))


def head_launch(M: int, S: int, nstate: int, max_clusters: int,
                streamed: bool = False) -> dict:
    """The head kernel's launch for M rows of nstate states on a card that
    holds max_clusters of its clusters at once (head_max_clusters): CTAs a
    cluster, row tiles, clusters launched (persistent: at most one a tile),
    CTAs, rows a tile, the most tiles a cluster takes in turn, the mode
    and a CTA's dynamic shared memory."""
    tiles = -(-M // HEAD_RT)
    cluster = -(-nstate // HEAD_NC)
    clusters = max(1, min(max_clusters, tiles))
    return {"cluster": cluster, "tiles": tiles, "clusters": clusters,
            "blocks": cluster * clusters, "rows_per_tile": HEAD_RT,
            "tiles_per_cluster": -(-tiles // clusters), "streamed": streamed,
            "smem_bytes": head_smem_bytes(S, streamed)}


@functools.lru_cache(maxsize=None)
def head_max_clusters(device: int, nstate: int, S: int, combine: bool,
                      rounding: int, streamed: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters of the head kernel's instance on CUDA
    device `device`: how many of its clusters the card holds at once."""
    from scrappie_torch.ops import _build

    with torch.cuda.device(device):
        n = _build.library().scrappie_head_max_clusters(nstate, S, int(combine),
                                                        rounding, int(streamed))
    if n < 0:
        _build.check(-n, "head max active clusters")
    if n == 0:
        raise RuntimeError(f"the head kernel's clusters of {-(-nstate // HEAD_NC)} "
                           f"CTAs do not fit on device {device}")
    return n


def check_head_input(h_tm, W, bvec, weights=None) -> None:
    """Raise unless the head kernel takes these inputs: contiguous fp32 h
    [T, B, S], W [S, nstate], bvec [nstate] for one model, or h [K, T, B, S],
    W [K, S, nstate], bvec [K, nstate] and weights [K] for K >= 1 members;
    at most HEAD_MAX_CLUSTER * HEAD_NC = 1088 states (a cluster's CTAs).
    Any S >= 1 and any alignment of h: what the resident mode cannot take
    runs streamed (head_streams)."""
    combine = weights is not None
    if not combine:
        h_tm, W, bvec = h_tm[None], W[None], bvec[None]
    K, T, B, S = h_tm.shape
    nstate = W.shape[-1]
    if K < 1:
        raise ValueError("the head kernel takes at least one member")
    ops.check_kernel_input("h", h_tm, (K, T, B, S))
    ops.check_kernel_input("W", W, (K, S, nstate))
    ops.check_kernel_input("bvec", bvec, (K, nstate))
    if combine:
        ops.check_kernel_input("weights", weights, (K,))
    most = HEAD_MAX_CLUSTER * HEAD_NC
    if not 1 <= nstate <= most:
        raise ValueError(f"the head kernel takes 1 to {most} states (a cluster "
                         f"of at most {HEAD_MAX_CLUSTER} CTAs of {HEAD_NC}); "
                         f"got nstate={nstate}")
    if S < 1:
        raise ValueError(f"the head kernel needs S >= 1 (S={S})")


def head_logpost_tm(h_tm, W, bvec, weights=None, min_prob=1e-5, tempW=1.0,
                    tempb=1.0):
    """The transducer head over all T * B rows: h [T, B, S], W
    [S, nstate], bvec [nstate] -> robustlog(softmax_with_temperature)
    [T, B, nstate]; or, with weights [K] (normalised), h [K, T, B, S],
    W [K, S, nstate], bvec [K, nstate] -> the members' combined log
    posterior, ensemble_logpost_tm, for any K. The wrapper allocates the
    posterior (525 MB at T = 2000, B = 64, 1025 states), which the kernel
    writes once, and nothing else a call: the kernel reads W and bvec from
    their slices' image (head_image, made once per weight tensor). The
    product's operands are rounded as the precision policy asks for the
    device (nn/config.kernel_rounding)."""
    on_card = (ops.on_cuda(h_tm, W, bvec) if weights is None
               else ops.on_cuda(h_tm, W, bvec, weights))
    rounding = config.kernel_rounding(h_tm.device)
    if not on_card:
        return head_logpost_tm_plain(h_tm, W, bvec, weights, min_prob, tempW,
                                     tempb, rounding)
    from scrappie_torch.ops import _build

    check_head_input(h_tm, W, bvec, weights)
    T, B, S = h_tm.shape[-3:]
    K = 1 if weights is None else h_tm.shape[0]
    nstate = W.shape[-1]
    lp = torch.empty((T, B, nstate), dtype=torch.float32, device=h_tm.device)
    if T * B == 0:
        return lp
    code = config.rounding_code(rounding)
    combine = weights is not None
    device = h_tm.device.index if h_tm.device.index is not None \
        else torch.cuda.current_device()
    streamed = head_streams(S, h_tm.data_ptr() % 16 == 0)
    plan = head_launch(T * B, S, nstate,
                       head_max_clusters(device, nstate, S, combine, code, streamed),
                       streamed)
    image = head_image(W, bvec, fp32_order=rounding is None)
    with torch.cuda.device(h_tm.device):
        err = _build.library().scrappie_head(
            h_tm.data_ptr(), image.data_ptr(),
            None if weights is None else weights.data_ptr(), lp.data_ptr(), K,
            T * B, S, nstate, tempb / tempW, tempb, min_prob / nstate,
            1.0 - min_prob, plan["clusters"], code, int(streamed),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "head")
    ops.LAUNCHES["head"] += 1
    return lp


def check_fused_ens_input(h_tm, W, bvec, weights) -> None:
    """Raise unless the fused ensemble kernel takes these inputs: 1 <= K <=
    MAX_ENS members, contiguous fp32 h [K, T, B, S], W [K, S, nstate], bvec
    [K, nstate] and weights [K], and a state space the fused kernels take.
    No path needs it since the head kernel and the forward kernel decode
    ensembles of any size; viterbi_fused_ens_tm is kept to be timed."""
    K, T, B, S = h_tm.shape
    if not 1 <= K <= MAX_ENS:
        raise ValueError(f"the fused ensemble kernel takes 1 to {MAX_ENS} "
                         f"members, got {K}")
    nstate = W.shape[-1]
    _check_fused_nhist(nstate - 1)
    ops.check_kernel_input("h", h_tm, (K, T, B, S))
    ops.check_kernel_input("W", W, (K, S, nstate))
    ops.check_kernel_input("bvec", bvec, (K, nstate))
    ops.check_kernel_input("weights", weights, (K,))


def forward_launch(nhist: int) -> tuple[int, int]:
    """(history threads a block, quads a thread) of the forward kernel: the
    nhist / 4 quads on the fewest whole warps up to FWD_THREADS_MAX (256
    threads at nhist = 1024), with the fewest quads a thread in FWD_QUADS
    that cover them. (On the H100, 128 threads with twice the quads, and
    END on warp 0 in place of its own warp, were slower at every shape
    timed: PERF.md.)"""
    quads = nhist // 4
    threads = min(FWD_THREADS_MAX, -(-quads // 32) * 32)
    need = -(-quads // threads)
    nq = next((q for q in FWD_QUADS if q >= need), None)
    if nq is None:
        raise ValueError(f"nhist={nhist} needs {need} quads a thread on "
                         f"{threads} threads; the kernel takes up to "
                         f"{FWD_QUADS[-1]}")
    return threads, nq


def viterbi_scores_tm(lp_tm, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                      use_slip: bool = False):
    """Forward Viterbi over time-major log posteriors [T, B, nhist+1] ->
    (final [B, nhist+2] f32, tb [T, B, nhist+2] int16). lp is clamped at
    -1e30, as the JAX kernel does."""
    if not ops.on_cuda(lp_tm):
        return viterbi_scores_tm_plain(lp_tm, stay_pen, skip_pen, local_pen,
                                       use_slip)
    from scrappie_torch.ops import _build

    T, B, nstate = lp_tm.shape
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    _check_kernel_nhist(nhist)
    ops.check_kernel_input("lp", lp_tm, (T, B, nstate))
    nthr, nq = forward_launch(nhist)
    final = torch.empty((B, nhist + 2), dtype=torch.float32, device=lp_tm.device)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=lp_tm.device)
    if B == 0:
        return final, tb
    with torch.cuda.device(lp_tm.device):
        err = _build.library().scrappie_viterbi_fwd(
            lp_tm.data_ptr(), final.data_ptr(), tb.data_ptr(), T, B, nhist,
            ops.f32(stay_pen), ops.f32(skip_pen), ops.f32(local_pen), int(use_slip),
            nthr, nq, ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_fwd")
    ops.LAUNCHES["viterbi_fwd"] += 1
    return final, tb


def viterbi_scores_batch(logpost, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                         use_slip: bool = False):
    """Batch-major convenience wrapper: logpost [B, T, nstate] (a tensor
    or an array) -> (final [B, nhist+2], tb [B, T, nhist+2]), the layout of
    decode/transducer.viterbi_transducer_scores; the kernel for a CUDA
    tensor (scrappie_tpu/ops/viterbi.py:viterbi_scores_batch)."""
    lp = torch.as_tensor(logpost, dtype=torch.float32)
    final, tb = viterbi_scores_tm(lp.transpose(0, 1).contiguous(), stay_pen,
                                  skip_pen, local_pen, use_slip)
    return final, tb.transpose(0, 1)


def backtrace_segments(T: int, B: int, nst2: int, sms: int) -> int:
    """Segments the backtrace kernel cuts each row's walk into, for B rows
    of T steps and nst2 states on a card of `sms` SMs: 1 (one block a row
    streams the row's whole traceback) unless the rows leave at least
    BT_MIN_SMS_A_ROW SMs a row and nst2 <= BT_MAPS_MAX_STATES; then one for
    each SM a row, sms // B, at most BT_MAX_SEG and T // BT_MIN_SEG."""
    per_row = sms // B if B else 0
    if per_row < BT_MIN_SMS_A_ROW or nst2 > BT_MAPS_MAX_STATES:
        return 1
    return max(1, min(per_row, BT_MAX_SEG, T // BT_MIN_SEG))


def viterbi_backtrace_tm(final, tb_tm):
    """Walk the time-major traceback (ref src/decode.c:58-98): final
    [B, nhist+2], tb [T, B, nhist+2] int16 -> (score [B], path [B, T+1]
    int32). On the card, with K = backtrace_segments(...) > 1, the wrapper
    allocates the segments' maps [B, K, nhist+2] int16 as scratch; the
    caching allocator hands that memory on only to later work on this
    stream."""
    if not ops.on_cuda(final, tb_tm):
        return viterbi_backtrace_tm_plain(final, tb_tm)
    from scrappie_torch.ops import _build

    T, B, nst2 = tb_tm.shape
    ops.check_kernel_input("final", final, (B, nst2))
    ops.check_kernel_input("tb", tb_tm, (T, B, nst2), torch.int16)
    score = torch.empty(B, dtype=torch.float32, device=final.device)
    path = torch.empty((B, T + 1), dtype=torch.int32, device=final.device)
    if B == 0:
        return score, path
    sms = torch.cuda.get_device_properties(final.device).multi_processor_count
    K = backtrace_segments(T, B, nst2, sms)
    maps = (torch.empty((B, K, nst2), dtype=torch.int16, device=final.device)
            if K > 1 else None)
    with torch.cuda.device(final.device):
        err = _build.library().scrappie_viterbi_backtrace(
            final.data_ptr(), tb_tm.data_ptr(), score.data_ptr(),
            path.data_ptr(), None if maps is None else maps.data_ptr(), T, B,
            nst2, K, ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_backtrace")
    ops.LAUNCHES["viterbi_backtrace"] += 1
    return score, path


def viterbi_fused_tm(h_tm, W, bvec, min_prob=1e-5, tempW=1.0, tempb=1.0,
                     stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                     use_slip: bool = False):
    """Posterior head fused into the forward Viterbi: h [T, B, S], W
    [S, nstate], bvec [nstate] -> (final [B, nhist+2], tb [T, B, nhist+2]
    int16). The [T, B, nstate] posterior never reaches device memory."""
    if not ops.on_cuda(h_tm, W, bvec):
        return viterbi_fused_tm_plain(h_tm, W, bvec, min_prob, tempW, tempb,
                                      stay_pen, skip_pen, local_pen, use_slip)
    from scrappie_torch.ops import _build

    T, B, S = h_tm.shape
    nstate = W.shape[1]
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    _check_fused_nhist(nhist)
    ops.check_kernel_input("h", h_tm, (T, B, S))
    ops.check_kernel_input("W", W, (S, nstate))
    ops.check_kernel_input("bvec", bvec, (nstate,))
    final = torch.empty((B, nhist + 2), dtype=torch.float32, device=h_tm.device)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=h_tm.device)
    if B == 0:
        return final, tb
    with torch.cuda.device(h_tm.device):
        err = _build.library().scrappie_viterbi_fused(
            h_tm.data_ptr(), W.data_ptr(), bvec.data_ptr(), final.data_ptr(),
            tb.data_ptr(), T, B, S, nhist, tempb / tempW, tempb,
            min_prob / nstate, 1.0 - min_prob, ops.f32(stay_pen), ops.f32(skip_pen),
            ops.f32(local_pen), int(use_slip),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_fused")
    ops.LAUNCHES["viterbi_fused"] += 1
    return final, tb


def viterbi_fused_ens_tm(h_tm, W, bvec, weights, min_prob=1e-5, tempW=1.0,
                         tempb=1.0, stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                         use_slip: bool = False):
    """K posterior heads combined and fused into the forward Viterbi: h
    [K, T, B, S] (each member's hidden features), W [K, S, nstate], bvec
    [K, nstate], weights [K] (normalised) -> (final [B, nhist+2], tb
    [T, B, nhist+2] int16) over ensemble_logpost_tm. Neither the members'
    nor the combined [T, B, nstate] posterior reaches device memory."""
    if not ops.on_cuda(h_tm, W, bvec, weights):
        return viterbi_fused_ens_tm_plain(h_tm, W, bvec, weights, min_prob,
                                          tempW, tempb, stay_pen, skip_pen,
                                          local_pen, use_slip)
    from scrappie_torch.ops import _build

    K, T, B, S = h_tm.shape
    nstate = W.shape[-1]
    nhist = nstate - 1
    _check_nhist(nhist, use_slip)
    check_fused_ens_input(h_tm, W, bvec, weights)
    final = torch.empty((B, nhist + 2), dtype=torch.float32, device=h_tm.device)
    tb = torch.empty((T, B, nhist + 2), dtype=torch.int16, device=h_tm.device)
    if B == 0:
        return final, tb
    with torch.cuda.device(h_tm.device):
        err = _build.library().scrappie_viterbi_fused_ens(
            h_tm.data_ptr(), W.data_ptr(), bvec.data_ptr(), weights.data_ptr(),
            final.data_ptr(), tb.data_ptr(), K, T, B, S, nhist, tempb / tempW,
            tempb, min_prob / nstate, 1.0 - min_prob, ops.f32(stay_pen),
            ops.f32(skip_pen), ops.f32(local_pen), int(use_slip),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "viterbi_fused_ens")
    ops.LAUNCHES["viterbi_fused_ens"] += 1
    return final, tb


def _check_kernel_nhist(nhist: int) -> None:
    """The forward kernel's own limits, beyond the divisibility of
    _check_nhist: the int16 traceback and the scores' two rows in shared
    memory."""
    if nhist + 1 > MAX_TB_STATE:
        raise ValueError(f"the Viterbi traceback is int16: states up to "
                         f"nhist + 1 = {nhist + 1} exceed {MAX_TB_STATE}")
    if 2 * 4 * nhist > ops.MAX_SMEM_BYTES:
        raise ValueError(f"the Viterbi forward kernel keeps 2 nhist scores in "
                         f"shared memory: {8 * nhist} B for nhist={nhist}; a "
                         f"block may use {ops.MAX_SMEM_BYTES}")


def _check_fused_nhist(nhist: int) -> None:
    if nhist % 32 or not 64 <= nhist <= 1024:
        raise ValueError(f"the fused Viterbi kernels take 64 <= nhist <= 1024, "
                         f"a multiple of 32; got nhist={nhist}")
