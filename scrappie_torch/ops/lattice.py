"""The forward-backward of the alignment-free lattice losses: the
transducer lattice, and the CRF sequence lattice with its local partition.

Counterpart of the lax.scans of scrappie_tpu/train/lattice.py
(_lattice_forward_impl, _crf_lattice_forward_impl,
_crf_local_partition_impl), which have no TPU kernel: the JAX trainer
lets XLA differentiate them. Here each is an autograd Function:

  * `TransducerLattice` (`lattice_forward_tm`): log posteriors lp
    [T, B, S] (stay class S - 1) and kmer states seqstates [B, L] (-1
    padding) -> log P(sequence) [B], local-global: stay, step and skip
    moves, entry from START at position 0, exit to END from each row's
    last valid position, START and END staying at
    logaddexp(-local_pen, stay) a block;
  * `CrfLattice` (`crf_lattice_tm`): CRF transitions trans [T, B, 25]
    (entry to*5 + from) and bases [B, L] (0-3, -1 padding) -> (log P
    [B], the sequence lattice of emit and '-' states over L + 1 positions
    with START and END; logZ_local [B], the seven-state partition of the
    same START/END-extended lattice over all sequences).

On a CUDA tensor the forward launches the kernel of csrc/lattice.cu in
its forward mode (lattice_fwdbwd_kernel, crf_lattice_fwdbwd_kernel), which
writes log P and the forward scores of every step; the backward launches
the same kernel in its backward mode, which walks the backward scores and
writes the gradient. Each launch is counted ("lattice_fwdbwd",
"crf_lattice_fwdbwd"). On a CPU tensor both run their plain twins here:
the forward loop (`*_fwd_plain`) and an explicit backward loop
(`*_bwd_plain`), the same arithmetic a step for all rows at once.

Both keep float32 precision over long reads by normalising each step:
the stored row r_t is the step's scores relative to a_{t-1}, the sum of
the earlier steps' maxima m, so alpha_hat_t = r_t - m_t (max 0) and
log P = sum(m) (in float64) + the final logaddexp. The backward carries
beta_tilde_t = beta_t + a_t - log P, which obeys the same recursion less
m_t a step, so an edge's posterior is exp(alpha_hat_{t-1} + weight +
beta_tilde_t - m_t): no two large numbers are subtracted. The gradient
of log P with respect to an input entry is the sum of the posteriors of
the edges that read it (the transducer: step, skip and START entry into
a position read its kmer state's entry, positions that share a state
summing into it; stays, and START's and END's local stays times
exp(stay - local_stay), read the stay class; the CRF: each edge its
transition class). Each step's posteriors are divided by their sum over
every edge of the step, END's exits included, which is 1 in exact
arithmetic: float32 rounding drifts the forward and backward scores
apart by a few ulps a step, an error common to the step's edges that
grows with the steps left (about 2-3% of the gradient at a 30 720-step
whole read without the division), and the division cancels it (the
local partition's seven states drift too little to need it). Rows
whose log P is the -1e30 sentinel (no labelled
sequence, or one the row cannot traverse) get a zero gradient; the
losses exclude them, as JAX excludes them. The scores are -1e30, never
-inf, where JAX's are.
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops
from scrappie_torch.ops import logaddexp as lae
from scrappie_torch.ops import logsumexp

#: The sentinel score of an unreachable state (train/lattice.py's -BIG).
NEG = -1.0e30
NS = 5  # CRF states: A, C, G, T, '-'
#: The CRF backward's copies of its 25 gradient classes (NCOPY in
#: csrc/lattice.cu), which share its shared memory with the score rows.
CRF_COPIES = 32


def _sentinel(like, *shape):
    return like.new_full(shape, NEG)


def _impossible(fin):
    """Rows whose final score is the sentinel: no path reaches the end."""
    return fin < 0.5 * NEG


def check_seq(seq, nstate: int, name: str = "seqstates") -> None:
    """Raise unless seq is [B, L], L >= 1, of states below nstate (-1
    padding): the kernels gather a row's entry of each state."""
    if seq.dim() != 2 or seq.shape[1] < 1:
        raise ValueError(f"{name} must be [B, L] with L >= 1, got "
                         f"{tuple(seq.shape)}")
    if seq.numel() and int(seq.max()) >= nstate:
        raise ValueError(f"{name}: state {int(seq.max())}, the states are "
                         f"0 .. {nstate - 1} and -1")


# ---------------------------------------------------------------- transducer

def _transducer_setup(lp, seq):
    valid = seq >= 0
    safe = torch.where(valid, seq, 0).long()
    lastpos = torch.clamp(valid.sum(1) - 1, min=0)
    return valid, safe, lastpos


def _shift(x, k: int):
    """x [B, L] moved k positions right, the first k the sentinel."""
    return torch.cat([_sentinel(x, x.shape[0], k), x], 1)[:, : x.shape[1]]


def _unshift(x, k: int):
    """x [B, L] moved k positions left, the last k the sentinel."""
    return torch.cat([x, _sentinel(x, x.shape[0], k)], 1)[:, k:]


def lattice_fwd_plain(lp, seq, stay_pen: float, skip_pen: float,
                      local_pen: float):
    """Plain twin of the transducer kernel's forward mode: lp [T, B, S],
    seq [B, L] -> (logP [B], alpha [B, T+1, L+2] (the rows r_t:
    positions, START, END), m [B, T+1])."""
    T, B, S = lp.shape
    L = seq.shape[1]
    valid, safe, lastpos = _transducer_setup(lp, seq)
    alpha = lp.new_empty((B, T + 1, L + 2))
    m = lp.new_zeros((B, T + 1))
    row = _sentinel(lp, B, L + 2)
    row[:, L] = 0.0
    alpha[:, 0] = row
    for t in range(T):
        lpt = lp[t]
        prev = row - m[:, t, None]
        pos, start, end = prev[:, :L], prev[:, L], prev[:, L + 1]
        emit = torch.where(valid, torch.gather(lpt, 1, safe), NEG)
        stay_lp = lpt[:, S - 1]
        stay_c = pos - stay_pen + stay_lp[:, None]
        step_c = _shift(pos, 1) + emit
        skip_c = _shift(pos, 2) - skip_pen + emit
        cur = lae(lae(stay_c, step_c), skip_c)
        cur0 = lae(cur[:, :1], start[:, None] + emit[:, :1])
        cur = torch.where(valid, torch.cat([cur0, cur[:, 1:]], 1), NEG)
        local_stay = lae(torch.full_like(stay_lp, -local_pen), stay_lp)
        exit_c = torch.gather(pos, 1, lastpos[:, None])[:, 0] - local_pen
        row = torch.cat([cur, (start + local_stay)[:, None],
                         lae(end + local_stay, exit_c)[:, None]], 1)
        alpha[:, t + 1] = row
        m[:, t + 1] = row.amax(1)
    fin = _transducer_final(alpha[:, T] - m[:, T, None], lastpos, L)
    return (m.double().sum(1) + fin.double()).float(), alpha, m


def _transducer_final(ahat, lastpos, L: int):
    return lae(torch.gather(ahat, 1, lastpos[:, None])[:, 0], ahat[:, L + 1])


def lattice_bwd_plain(lp, seq, alpha, m, gP, stay_pen: float,
                      skip_pen: float, local_pen: float):
    """Plain twin of the transducer kernel's backward mode: the forward's
    alpha and m, gP [B] the gradient of log P -> d/dlp [T, B, S]."""
    T, B, S = lp.shape
    L = seq.shape[1]
    valid, safe, lastpos = _transducer_setup(lp, seq)
    grad = torch.zeros_like(lp)
    fin = _transducer_final(alpha[:, T] - m[:, T, None], lastpos, L)
    impossible = _impossible(fin)
    rows = torch.arange(B, device=lp.device)
    bt = _sentinel(lp, B, L)
    bt[rows, lastpos] = -fin
    bt = torch.where(valid, bt, NEG)
    bstart, bend = _sentinel(lp, B), -fin
    neg_local = torch.full((B,), -local_pen, dtype=lp.dtype, device=lp.device)
    for t in range(T, 0, -1):
        lpt = lp[t - 1]
        stay_lp = lpt[:, S - 1]
        mt = m[:, t, None]
        prev = alpha[:, t - 1] - m[:, t - 1, None]
        pos, start, end = prev[:, :L], prev[:, L], prev[:, L + 1]
        u = torch.where(valid, torch.gather(lpt, 1, safe), NEG) + bt
        local_stay = lae(neg_local, stay_lp)
        inc = lae(_shift(pos, 1), _shift(pos, 2) - skip_pen)
        inc = torch.cat([lae(inc[:, :1], start[:, None]), inc[:, 1:]], 1)
        emit_post = torch.where(valid, torch.exp(inc + u - mt), 0.0)
        stay_post = torch.exp(pos - stay_pen + stay_lp[:, None] + bt - mt)
        ends = (torch.exp(start + local_stay + bstart - mt[:, 0])
                + torch.exp(end + local_stay + bend - mt[:, 0]))
        exit_post = torch.exp(torch.gather(pos, 1, lastpos[:, None])[:, 0]
                              - local_pen + bend - mt[:, 0])
        total = emit_post.sum(1) + stay_post.sum(1) + ends + exit_post
        g = torch.zeros((B, S), dtype=lp.dtype, device=lp.device)
        g.scatter_add_(1, safe, emit_post)
        g[:, S - 1] += stay_post.sum(1) + ends * torch.exp(stay_lp - local_stay)
        grad[t - 1] = g * torch.where(impossible, 0.0, gP / total)[:, None]
        nb = lae(lae(bt - stay_pen + stay_lp[:, None], _unshift(u, 1)),
                 _unshift(u, 2) - skip_pen)
        last = torch.gather(nb, 1, lastpos[:, None])[:, 0]
        nb = nb.scatter(1, lastpos[:, None],
                        lae(last, -local_pen + bend)[:, None])
        bt = torch.where(valid, nb - mt, NEG)
        bstart = lae(local_stay + bstart, u[:, 0]) - mt[:, 0]
        bend = local_stay + bend - mt[:, 0]
    return grad


def check_lattice_input(lp, seq) -> None:
    """Raise unless the transducer kernel takes these inputs: contiguous
    float32 lp [T, B, S] and int32 seq [B, L], L >= 1."""
    T, B, S = lp.shape
    check_seq(seq, S)
    ops.check_kernel_input("logpost", lp, (T, B, S))
    ops.check_kernel_input("seqstates", seq, (B, seq.shape[1]), torch.int32)


def _scratch(B: int, nrow: int, extra: int, device, global_rows: bool):
    """None where a block's score rows (nrow floats) fit in shared memory
    beside its extra floats there, else the global scratch array [B, nrow]
    they live in instead; global_rows puts them there at any size (to check
    that mode at a size whose rows would fit)."""
    if not global_rows and 4 * (nrow + extra) + 1024 <= ops.MAX_SMEM_BYTES:
        return None
    return torch.empty((B, nrow), dtype=torch.float32, device=device)


def lattice_fwd_cuda(lp, seq, stay_pen: float, skip_pen: float,
                     local_pen: float, global_rows: bool = False):
    """The transducer kernel's forward mode: lattice_fwd_plain's arguments
    and result (global_rows: see `_scratch`)."""
    check_lattice_input(lp, seq)
    T, B, S = lp.shape
    L = seq.shape[1]
    dev = lp.device
    alpha = torch.empty((B, T + 1, L + 2), dtype=torch.float32, device=dev)
    m = torch.empty((B, T + 1), dtype=torch.float32, device=dev)
    logp = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = _scratch(B, 2 * (L + 2), 0, dev, global_rows)
    _launch_transducer(0, lp, seq, alpha, m, logp, None, None, scratch,
                       stay_pen, skip_pen, local_pen)
    return logp, alpha, m


def lattice_bwd_cuda(lp, seq, alpha, m, gP, stay_pen: float, skip_pen: float,
                     local_pen: float, global_rows: bool = False):
    """The transducer kernel's backward mode: lattice_bwd_plain's
    arguments and result (global_rows: see `_scratch`)."""
    check_lattice_input(lp, seq)
    T, B, S = lp.shape
    L = seq.shape[1]
    ops.check_kernel_input("alpha", alpha, (B, T + 1, L + 2))
    ops.check_kernel_input("m", m, (B, T + 1))
    ops.check_kernel_input("gP", gP, (B,))
    grad = torch.empty_like(lp)
    scratch = _scratch(B, 3 * L + 2, 2 * S, lp.device, global_rows)
    _launch_transducer(1, lp, seq, alpha, m, None, gP, grad, scratch,
                       stay_pen, skip_pen, local_pen)
    return grad


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_transducer(mode, lp, seq, alpha, m, logp, gP, grad, scratch,
                       stay_pen, skip_pen, local_pen):
    from scrappie_torch.ops import _build

    T, B, S = lp.shape
    if B == 0:
        return
    with torch.cuda.device(lp.device):
        err = _build.library().scrappie_lattice(
            mode, lp.data_ptr(), seq.data_ptr(), alpha.data_ptr(), m.data_ptr(),
            _ptr(logp), _ptr(gP), _ptr(grad), _ptr(scratch), T, B, S,
            seq.shape[1], ops.f32(stay_pen), ops.f32(skip_pen),
            ops.f32(local_pen), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "lattice_fwdbwd")
    ops.LAUNCHES["lattice_fwdbwd"] += 1


class TransducerLattice(torch.autograd.Function):
    """lp [T, B, S], seqstates [B, L] -> log P [B], differentiable in lp."""

    @staticmethod
    def forward(ctx, lp, seq, stay_pen, skip_pen, local_pen):
        pens = (stay_pen, skip_pen, local_pen)
        if ops.on_cuda(lp, seq):
            logp, alpha, m = lattice_fwd_cuda(lp, seq, *pens)
        else:
            logp, alpha, m = lattice_fwd_plain(lp, seq, *pens)
        ctx.save_for_backward(lp, seq, alpha, m)
        ctx.pens = pens
        return logp

    @staticmethod
    def backward(ctx, gP):
        lp, seq, alpha, m = ctx.saved_tensors
        if ops.on_cuda(lp, seq):
            grad = lattice_bwd_cuda(lp, seq, alpha, m, gP.contiguous(),
                                    *ctx.pens)
        else:
            grad = lattice_bwd_plain(lp, seq, alpha, m, gP, *ctx.pens)
        return grad, None, None, None, None


def lattice_forward_tm(lp, seqstates, stay_pen: float = 0.0,
                       skip_pen: float = 4.0, local_pen: float = 4.0):
    """log P(sequence | posterior) [B], local-global, of kmer states
    seqstates [B, L] (-1 right padding) under log posteriors lp [T, B, S]
    (time-major; stay class S - 1): train/lattice.py's
    lattice_forward_batch, differentiable in lp."""
    check_seq(seqstates, lp.shape[-1])
    seq = seqstates.to(device=lp.device, dtype=torch.int32).contiguous()
    return TransducerLattice.apply(lp, seq, float(stay_pen), float(skip_pen),
                                   float(local_pen))


# ----------------------------------------------------------------------- CRF

def _crf_setup(bases):
    """Per position j = 0..L (bases emitted): whether it is valid and the
    indices of its ee, es and se transitions, as train/lattice.py takes
    them; and each row's count of valid bases."""
    B, L = bases.shape
    valid = bases >= 0
    safe = torch.where(valid, bases, 0).long()
    zero = torch.zeros((B, 1), dtype=torch.long, device=bases.device)
    b_j = torch.cat([zero, safe], 1)
    b_jm1 = torch.cat([zero, zero, safe[:, :-1]], 1)
    jvalid = torch.cat([torch.ones_like(valid[:, :1]), valid], 1)
    return (jvalid, b_j * NS + b_jm1, b_j * NS + 4, 4 * NS + b_j,
            valid.sum(1))


def crf_fwd_plain(trans, bases, local_pen: float):
    """Plain twin of the CRF kernel's forward mode, the sequence lattice:
    trans [T, B, 25], bases [B, L] -> (logP [B], alpha [B, T+1, 2L+4]
    (rows r_t: emit states 0..L, '-' states 0..L, START, END), m
    [B, T+1])."""
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    jvalid, idx_ee, idx_es, idx_se, seqlen = _crf_setup(bases)
    alpha = trans.new_empty((B, T + 1, 2 * J + 2))
    m = trans.new_zeros((B, T + 1))
    row = _sentinel(trans, B, 2 * J + 2)
    row[:, 2 * J] = 0.0
    alpha[:, 0] = row
    sl = seqlen[:, None]
    for t in range(T):
        tr = trans[t]
        prev = row - m[:, t, None]
        a_e, a_s = prev[:, :J], prev[:, J : 2 * J]
        start, end = prev[:, 2 * J], prev[:, 2 * J + 1]
        ee, es = torch.gather(tr, 1, idx_ee), torch.gather(tr, 1, idx_es)
        se, ss = torch.gather(tr, 1, idx_se), tr[:, 4 * NS + 4]
        new_e = lae(_shift(a_e, 1) + ee, _shift(a_s, 1) + es)
        new_e1 = lae(new_e[:, 1:2], start[:, None] + es[:, 1:2])
        new_e = torch.cat([new_e[:, :1], new_e1, new_e[:, 2:]], 1)
        new_s = lae(a_e + se, a_s + ss[:, None])
        local_stay = lae(torch.full_like(ss, -local_pen), ss)
        exit_c = lae(torch.gather(a_e, 1, sl)[:, 0],
                     torch.gather(a_s, 1, sl)[:, 0]) - local_pen
        row = torch.cat([torch.where(jvalid, new_e, NEG),
                         torch.where(jvalid, new_s, NEG),
                         (start + local_stay)[:, None],
                         lae(end + local_stay, exit_c)[:, None]], 1)
        alpha[:, t + 1] = row
        m[:, t + 1] = row.amax(1)
    fin = _crf_final(alpha[:, T] - m[:, T, None], seqlen, J)
    return (m.double().sum(1) + fin.double()).float(), alpha, m


def _crf_final(ahat, seqlen, J: int):
    sl = seqlen[:, None]
    return lae(lae(torch.gather(ahat[:, :J], 1, sl)[:, 0],
                   torch.gather(ahat[:, J : 2 * J], 1, sl)[:, 0]),
               ahat[:, 2 * J + 1])


def crf_bwd_plain(trans, bases, alpha, m, gP, local_pen: float):
    """Plain twin of the CRF kernel's backward mode for the sequence
    lattice: the forward's alpha and m, gP [B] -> d(log P)/dtrans * gP
    [T, B, 25]."""
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    jvalid, idx_ee, idx_es, idx_se, seqlen = _crf_setup(bases)
    grad = torch.zeros_like(trans)
    fin = _crf_final(alpha[:, T] - m[:, T, None], seqlen, J)
    impossible = _impossible(fin)
    rows = torch.arange(B, device=trans.device)
    be = _sentinel(trans, B, J)
    be[rows, seqlen] = -fin
    bs = be.clone()
    bstart, bend = _sentinel(trans, B), -fin
    neg_local = torch.full((B,), -local_pen, dtype=trans.dtype,
                           device=trans.device)
    for t in range(T, 0, -1):
        tr = trans[t - 1]
        mt = m[:, t, None]
        prev = alpha[:, t - 1] - m[:, t - 1, None]
        a_e, a_s = prev[:, :J], prev[:, J : 2 * J]
        start, end = prev[:, 2 * J], prev[:, 2 * J + 1]
        ee, es = torch.gather(tr, 1, idx_ee), torch.gather(tr, 1, idx_es)
        se, ss = torch.gather(tr, 1, idx_se), tr[:, 4 * NS + 4]
        local_stay = lae(neg_local, ss)
        p_ee = torch.exp(_shift(a_e, 1) + ee + be - mt)
        p_es = torch.exp(_shift(a_s, 1) + es + be - mt)
        entry = torch.exp(start + es[:, 1] + be[:, 1] - mt[:, 0])
        p_es = torch.cat([p_es[:, :1], p_es[:, 1:2] + entry[:, None],
                          p_es[:, 2:]], 1)
        p_se = torch.exp(a_e + se + bs - mt)
        p_ss = torch.exp(a_s + ss[:, None] + bs - mt)
        ends = (torch.exp(start + local_stay + bstart - mt[:, 0])
                + torch.exp(end + local_stay + bend - mt[:, 0]))
        sl = seqlen[:, None]
        exit_post = (torch.exp(torch.gather(a_e, 1, sl)[:, 0] - local_pen + bend
                               - mt[:, 0])
                     + torch.exp(torch.gather(a_s, 1, sl)[:, 0] - local_pen + bend
                                 - mt[:, 0]))
        total = ((p_ee + p_es + p_se + p_ss)[:, 1:].sum(1) + (p_se + p_ss)[:, 0]
                 + ends + exit_post)
        g = torch.zeros((B, NS * NS), dtype=trans.dtype, device=trans.device)
        for idx, post in ((idx_ee, p_ee), (idx_es, p_es), (idx_se, p_se)):
            g.scatter_add_(1, idx, post)
        g[:, 4 * NS + 4] += p_ss.sum(1) + ends * torch.exp(ss - local_stay)
        grad[t - 1] = g * torch.where(impossible, 0.0, gP / total)[:, None]
        ue, us = ee + be, es + be
        exit_b = (-local_pen + bend)[:, None]
        nbe = lae(_unshift(ue, 1), se + bs)
        nbs = lae(_unshift(us, 1), ss[:, None] + bs)
        nbe = nbe.scatter(1, sl, lae(torch.gather(nbe, 1, sl), exit_b))
        nbs = nbs.scatter(1, sl, lae(torch.gather(nbs, 1, sl), exit_b))
        be = torch.where(jvalid, nbe - mt, NEG)
        bs = torch.where(jvalid, nbs - mt, NEG)
        bstart = lae(local_stay + bstart, us[:, 1]) - mt[:, 0]
        bend = local_stay + bend - mt[:, 0]
    return grad


def _lse5(x):
    return logsumexp(x, -1)[..., 0]


def partition_fwd_plain(trans, local_pen: float):
    """Plain twin of the CRF kernel's local partition (its second block a
    row): trans [T, B, 25] -> (logZ [B], z [B, T+1, 8] (rows: the five
    states, START, END, unused), zm [B, T+1])."""
    T, B, _ = trans.shape
    z = _sentinel(trans, B, T + 1, 8)
    zm = trans.new_zeros((B, T + 1))
    row = _sentinel(trans, B, 7)
    row[:, 5] = 0.0
    z[:, 0, :7] = row
    for t in range(T):
        tr = trans[t]
        tmat = tr.reshape(B, NS, NS)  # [B, to, from]
        prev = row - zm[:, t, None]
        z5, start, end = prev[:, :5], prev[:, 5], prev[:, 6]
        new5 = logsumexp(tmat + z5[:, None, :], -1)[..., 0]
        new4 = lae(new5[:, :4], start[:, None] + tmat[:, :4, 4])
        ss = tr[:, 4 * NS + 4]
        local_stay = lae(torch.full_like(ss, -local_pen), ss)
        exit_c = _lse5(z5) - local_pen
        row = torch.cat([new4, new5[:, 4:], (start + local_stay)[:, None],
                         lae(end + local_stay, exit_c)[:, None]], 1)
        z[:, t + 1, :7] = row
        zm[:, t + 1] = row.amax(1)
    zh = z[:, T, :7] - zm[:, T, None]
    fin = lae(_lse5(zh[:, :5]), zh[:, 6])
    return (zm.double().sum(1) + fin.double()).float(), z, zm


def partition_bwd_plain(trans, z, zm, gZ, local_pen: float):
    """Plain twin of the local partition's backward: z and zm of its
    forward, gZ [B] -> d(logZ)/dtrans * gZ [T, B, 25]."""
    T, B, _ = trans.shape
    grad = torch.zeros_like(trans)
    zh = z[:, T, :7] - zm[:, T, None]
    fin = lae(_lse5(zh[:, :5]), zh[:, 6])
    b5 = (-fin)[:, None].expand(B, 5).clone()
    bstart, bend = _sentinel(trans, B), -fin
    neg_local = torch.full((B,), -local_pen, dtype=trans.dtype,
                           device=trans.device)
    for t in range(T, 0, -1):
        tr = trans[t - 1]
        tmat = tr.reshape(B, NS, NS)
        mt = zm[:, t, None]
        prev = z[:, t - 1, :7] - zm[:, t - 1, None]
        z5, start, end = prev[:, :5], prev[:, 5], prev[:, 6]
        ss = tr[:, 4 * NS + 4]
        local_stay = lae(neg_local, ss)
        post = torch.exp(z5[:, None, :] + tmat + b5[:, :, None] - mt[..., None])
        entry = torch.exp(start[:, None] + tmat[:, :4, 4] + b5[:, :4]
                          - mt)
        post[:, :4, 4] += entry
        ends = (torch.exp(start + local_stay + bstart - mt[:, 0])
                + torch.exp(end + local_stay + bend - mt[:, 0]))
        post[:, 4, 4] += ends * torch.exp(ss - local_stay)
        grad[t - 1] = post.reshape(B, NS * NS) * gZ[:, None]
        n5 = logsumexp(tmat + b5[:, :, None], 1)[:, 0]
        n5 = lae(n5, (-local_pen + bend)[:, None]) - mt
        into = tmat[:, :4, 4] + b5[:, :4]
        bstart = lae(local_stay + bstart, _lse5(into)) - mt[:, 0]
        bend = local_stay + bend - mt[:, 0]
        b5 = n5
    return grad


def check_crf_lattice_input(trans, bases) -> None:
    """Raise unless the CRF kernel takes these inputs: contiguous float32
    trans [T, B, 25] and int32 bases [B, L], L >= 1."""
    T, B, _ = trans.shape
    check_seq(bases, NS - 1, "bases")
    ops.check_kernel_input("trans", trans, (T, B, NS * NS))
    ops.check_kernel_input("bases", bases, (B, bases.shape[1]), torch.int32)


def _launch_crf(mode, trans, bases, alpha, m, z, zm, out, gP, gZ, grads,
                scratch, local_pen):
    from scrappie_torch.ops import _build

    T, B, _ = trans.shape
    if B == 0:
        return
    with torch.cuda.device(trans.device):
        err = _build.library().scrappie_crf_lattice(
            mode, trans.data_ptr(), bases.data_ptr(), alpha.data_ptr(),
            m.data_ptr(), z.data_ptr(), zm.data_ptr(), _ptr(out), _ptr(gP),
            _ptr(gZ), _ptr(grads), _ptr(scratch), T, B, bases.shape[1],
            ops.f32(local_pen), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "crf_lattice_fwdbwd")
    ops.LAUNCHES["crf_lattice_fwdbwd"] += 1


def crf_lattice_fwd_cuda(trans, bases, local_pen: float,
                         global_rows: bool = False):
    """The CRF kernel's forward mode, both lattices in one launch ->
    (logP [B], logZ [B], alpha, m, z, zm) as the twins give them
    (global_rows: see `_scratch`)."""
    check_crf_lattice_input(trans, bases)
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    dev = trans.device
    alpha = torch.empty((B, T + 1, 2 * J + 2), dtype=torch.float32, device=dev)
    m = torch.empty((B, T + 1), dtype=torch.float32, device=dev)
    z = torch.empty((B, T + 1, 8), dtype=torch.float32, device=dev)
    zm = torch.empty((B, T + 1), dtype=torch.float32, device=dev)
    out = torch.empty((2, B), dtype=torch.float32, device=dev)
    scratch = _scratch(B, 2 * (2 * J + 2), 0, dev, global_rows)
    _launch_crf(0, trans, bases, alpha, m, z, zm, out, None, None, None,
                scratch, local_pen)
    return out[0], out[1], alpha, m, z, zm


def crf_lattice_bwd_cuda(trans, bases, alpha, m, z, zm, gP, gZ,
                         local_pen: float, global_rows: bool = False):
    """The CRF kernel's backward mode -> d(gP log P + gZ logZ)/dtrans
    [T, B, 25] (the lattice's and the partition's rows in one launch, two
    arrays, summed; global_rows: see `_scratch`)."""
    check_crf_lattice_input(trans, bases)
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    for name, t, shape in (("alpha", alpha, (B, T + 1, 2 * J + 2)),
                           ("m", m, (B, T + 1)), ("z", z, (B, T + 1, 8)),
                           ("zm", zm, (B, T + 1)), ("gP", gP, (B,)),
                           ("gZ", gZ, (B,))):
        ops.check_kernel_input(name, t, shape)
    grads = torch.empty((2, T, B, NS * NS), dtype=torch.float32,
                        device=trans.device)
    scratch = _scratch(B, 2 * J + 2 * (2 * J + 1), 2 * CRF_COPIES * NS * NS,
                       trans.device, global_rows)
    _launch_crf(1, trans, bases, alpha, m, z, zm, None, gP, gZ, grads, scratch,
                local_pen)
    return grads[0] + grads[1]


class CrfLattice(torch.autograd.Function):
    """trans [T, B, 25], bases [B, L] -> (log P [B], logZ_local [B]),
    differentiable in trans."""

    @staticmethod
    def forward(ctx, trans, bases, local_pen):
        if ops.on_cuda(trans, bases):
            logp, logz, *saved = crf_lattice_fwd_cuda(trans, bases, local_pen)
        else:
            logp, alpha, m = crf_fwd_plain(trans, bases, local_pen)
            logz, z, zm = partition_fwd_plain(trans, local_pen)
            saved = (alpha, m, z, zm)
        ctx.save_for_backward(trans, bases, *saved)
        ctx.local_pen = local_pen
        return logp, logz

    @staticmethod
    def backward(ctx, gP, gZ):
        trans, bases, alpha, m, z, zm = ctx.saved_tensors
        B = trans.shape[1]
        gP = trans.new_zeros(B) if gP is None else gP.contiguous()
        gZ = trans.new_zeros(B) if gZ is None else gZ.contiguous()
        if ops.on_cuda(trans, bases):
            grad = crf_lattice_bwd_cuda(trans, bases, alpha, m, z, zm, gP, gZ,
                                        ctx.local_pen)
        else:
            grad = (crf_bwd_plain(trans, bases, alpha, m, gP, ctx.local_pen)
                    + partition_bwd_plain(trans, z, zm, gZ, ctx.local_pen))
        return grad, None, None


def crf_lattice_tm(trans, bases, local_pen: float = 4.0):
    """(log P(bases | trans) [B], logZ_local [B]) of base sequences bases
    [B, L] (0-3, -1 right padding) under CRF transitions trans [T, B, 25]
    (time-major): train/lattice.py's crf_lattice_forward_batch and
    crf_local_partition, one forward-backward, differentiable in trans."""
    check_seq(bases, NS - 1, "bases")
    b = bases.to(device=trans.device, dtype=torch.int32).contiguous()
    return CrfLattice.apply(trans, b, float(local_pen))
