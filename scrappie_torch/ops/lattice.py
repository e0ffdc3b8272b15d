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
writes log P and the checkpoints below; the backward launches the same
kernel in its backward mode, which recomputes the rows between
checkpoints, walks the backward scores and writes the gradient. Each
launch is counted ("lattice_fwdbwd", "crf_lattice_fwdbwd"). On a CPU
tensor both run their plain twins here: the forward loop (`*_fwd_plain`)
and an explicit backward loop (`*_bwd_plain`), the same arithmetic a step
for all rows at once.

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

Memory: checkpoints every `chunk` steps, as JAX's whole-read losses bound
theirs with chunked_scan (a remat in `chunk`-step pieces). The forward
keeps every step's maximum m [B, T+1], the rows r_t at t = 0, chunk,
2 chunk, ... and r_T (`ckpt` [B, n + 1, R], n = ceil(T / chunk)), and the
rows of the last chunk, which the backward walks first (`rows`
[B, chunk, R]); nothing else. The backward walks the chunks from last to
first: each chunk's rows are recomputed from its checkpoint by the
forward's own arithmetic with the kept m (no maximum is taken again), so
they are the forward's bit for bit, and the gradient at any chunk is the
gradient at chunk = T bit for bit. chunk = None (or T) keeps every row
and recomputes none: the windows' losses. A last chunk shorter than
`chunk` is allowed. At a whole read of 30 720 steps and 7 000 bases,
chunk 256 keeps 11 MB (transducer) and 21 MB (CRF) where every row took
0.86 and 1.72 GB.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scrappie_torch import ops
from scrappie_torch.ops import logaddexp as lae
from scrappie_torch.ops import logsumexp

#: The sentinel score of an unreachable state (train/lattice.py's -BIG).
NEG = -1.0e30
NS = 5  # CRF states: A, C, G, T, '-'
NCLASS = NS * NS
#: The most CTAs of a row's cluster (MAX_CLUSTER in csrc/lattice.cu), and
#: the positions (the transducer's sequence positions, the CRF's L + 1) a
#: CTA aims at: on an H100 a window of 800 positions ran faster on 4 CTAs
#: than on one, and a whole read of 7 000 on 16 than on 8.
MAX_CLUSTER = 16
CLUSTER_PER = 256
#: A CTA's threads at most (MAX_THREADS in csrc/lattice.cu: 128 registers
#: a thread, no spill).
MAX_THREADS = 512
#: The positions a run of a thread may hold (PPT in csrc/lattice.cu).
PPTS = (1, 2, 4, 8)


def _sentinel(like, *shape):
    return like.new_full(shape, NEG)


def _impossible(fin):
    """Rows whose final score is the sentinel: no path reaches the end."""
    return fin < 0.5 * NEG


def check_seq(seq, nstate: int, name: str = "seqstates",
              values: bool = True) -> None:
    """Raise unless seq is [B, L], L >= 1, and (values) of states below
    nstate (-1 padding): the kernels gather a row's entry of each state.
    The values' check waits for the card when seq lies there."""
    if seq.dim() != 2 or seq.shape[1] < 1:
        raise ValueError(f"{name} must be [B, L] with L >= 1, got "
                         f"{tuple(seq.shape)}")
    if values and seq.numel() and int(seq.max()) >= nstate:
        raise ValueError(f"{name}: state {int(seq.max())}, the states are "
                         f"0 .. {nstate - 1} and -1")


def chunking(T: int, chunk: int | None) -> tuple[int, int]:
    """(C, n): the steps a chunk (chunk, or T for None, at least 1 and at
    most T) and the chunks, ceil(T / C) and at least 1. The forward keeps
    the rows at 0, C, 2C, ..., (n - 1) C and T, and the rows of the last
    chunk, (n - 1) C .. T - 1."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    C = max(1, min(T if chunk is None else chunk, T))
    return C, max(1, -(-T // C))


def _keep(ckpt, rows, t: int, row, T: int, C: int, n: int) -> None:
    """Row t of the forward into the checkpoints and the last chunk's rows."""
    if t % C == 0 and t // C < n:
        ckpt[:, t // C] = row
    if (n - 1) * C <= t < T:
        rows[:, t - (n - 1) * C] = row
    if t == T:
        ckpt[:, n] = row


def _chunk_rows(step, ckpt, rows, m, T: int):
    """For c = n-1 .. 0: (lo, hi, block), block[:, t - lo] the forward's
    row t for lo <= t < hi; the last chunk's are the kept rows, the others
    recomputed from their checkpoint by `step(prev, m_prev, t)` (row t
    from row t - 1), as the kernel's backward does."""
    C, n = rows.shape[1], ckpt.shape[1] - 1
    for c in range(n - 1, -1, -1):
        lo, hi = c * C, min(c * C + C, T)
        if c == n - 1:
            yield lo, hi, rows
            continue
        block = torch.empty_like(rows)
        block[:, 0] = ckpt[:, c]
        for t in range(lo + 1, hi):
            block[:, t - lo] = step(block[:, t - 1 - lo], m[:, t - 1], t)
        yield lo, hi, block


# ------------------------------------------------------------------- layout

class Layout(NamedTuple):
    """A row's positions on its cluster of CTAs: CTA c owns positions
    [c per, min((c + 1) per, npos)), thread i of it the positions
    c per + i + k threads for k < ppt groups: `groups` runs of ppt
    positions, which it walks in turn each step (more than one only above
    MAX_CLUSTER x MAX_THREADS x max(PPTS) positions)."""
    ncta: int
    per: int
    threads: int
    ppt: int
    groups: int


def cluster_layout(npos: int) -> Layout:
    """The layout of a row of npos positions: min(MAX_CLUSTER, ceil(npos /
    CLUSTER_PER)) CTAs, every CTA owning at least two positions (its right
    neighbour's halo); a CTA has at most MAX_THREADS threads, a multiple of
    32, and a thread the fewest positions of PPTS that fit, or above that
    max(PPTS) positions in each of as many runs as the CTA's positions
    need."""
    if npos < 1:
        raise ValueError(f"a row needs a position, got {npos}")
    cluster = min(MAX_CLUSTER, -(-npos // CLUSTER_PER))
    per = max(2, -(-npos // cluster))
    ncta = -(-npos // per)
    run = MAX_THREADS * PPTS[-1]
    if per > run:
        return Layout(ncta, per, MAX_THREADS, PPTS[-1], -(-per // run))
    ppt = next(p for p in PPTS if p * MAX_THREADS >= per)
    threads = -(-(-(-per // ppt)) // 32) * 32
    return Layout(ncta, per, threads, ppt, 1)


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


def _transducer_step(prev, mprev, lpt, valid, safe, lastpos, stay_pen: float,
                     skip_pen: float, local_pen: float):
    """The forward's row r_t [B, L+2] from r_{t-1} and m_{t-1}."""
    L, S = valid.shape[1], lpt.shape[1]
    p = prev - mprev[:, None]
    pos, start, end = p[:, :L], p[:, L], p[:, L + 1]
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
    return torch.cat([cur, (start + local_stay)[:, None],
                      lae(end + local_stay, exit_c)[:, None]], 1)


def lattice_fwd_plain(lp, seq, stay_pen: float, skip_pen: float,
                      local_pen: float, chunk: int | None = None):
    """Plain twin of the transducer kernel's forward mode: lp [T, B, S],
    seq [B, L] -> (logP [B], ckpt [B, n+1, L+2], rows [B, C, L+2], m
    [B, T+1]) (`chunking`; a row r_t: positions, START, END)."""
    T, B, S = lp.shape
    L = seq.shape[1]
    C, n = chunking(T, chunk)
    setup = _transducer_setup(lp, seq)
    ckpt = lp.new_empty((B, n + 1, L + 2))
    rows = lp.new_full((B, C, L + 2), NEG)
    m = lp.new_zeros((B, T + 1))
    row = _sentinel(lp, B, L + 2)
    row[:, L] = 0.0
    _keep(ckpt, rows, 0, row, T, C, n)
    for t in range(T):
        row = _transducer_step(row, m[:, t], lp[t], *setup, stay_pen,
                               skip_pen, local_pen)
        m[:, t + 1] = row.amax(1)
        _keep(ckpt, rows, t + 1, row, T, C, n)
    fin = _transducer_final(ckpt[:, n] - m[:, T, None], setup[2], L)
    return (m.double().sum(1) + fin.double()).float(), ckpt, rows, m


def _transducer_final(ahat, lastpos, L: int):
    return lae(torch.gather(ahat, 1, lastpos[:, None])[:, 0], ahat[:, L + 1])


def lattice_bwd_plain(lp, seq, ckpt, rows, m, gP, stay_pen: float,
                      skip_pen: float, local_pen: float):
    """Plain twin of the transducer kernel's backward mode: the forward's
    ckpt, rows and m, gP [B] the gradient of log P -> d/dlp [T, B, S]; a
    chunk's rows recomputed from its checkpoint, as the kernel does."""
    T, B, S = lp.shape
    L = seq.shape[1]
    n = ckpt.shape[1] - 1
    valid, safe, lastpos = setup = _transducer_setup(lp, seq)
    pens = (stay_pen, skip_pen, local_pen)
    grad = torch.zeros_like(lp)
    fin = _transducer_final(ckpt[:, n] - m[:, T, None], lastpos, L)
    impossible = _impossible(fin)
    rows_b = torch.arange(B, device=lp.device)
    bt = _sentinel(lp, B, L)
    bt[rows_b, lastpos] = -fin
    bt = torch.where(valid, bt, NEG)
    bstart, bend = _sentinel(lp, B), -fin
    neg_local = torch.full((B,), -local_pen, dtype=lp.dtype, device=lp.device)
    step = lambda prev, mp, t: _transducer_step(prev, mp, lp[t - 1], *setup,
                                                *pens)
    for lo, hi, block in _chunk_rows(step, ckpt, rows, m, T):
        for t in range(hi, lo, -1):
            lpt = lp[t - 1]
            stay_lp = lpt[:, S - 1]
            mt = m[:, t, None]
            prev = block[:, t - 1 - lo] - m[:, t - 1, None]
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
            g[:, S - 1] += (stay_post.sum(1)
                            + ends * torch.exp(stay_lp - local_stay))
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


def check_lattice_input(lp, seq, values: bool = True) -> None:
    """Raise unless the transducer kernel takes these inputs: contiguous
    float32 lp [T, B, S] and int32 seq [B, L], L >= 1, of states below S
    (values: checked here)."""
    T, B, S = lp.shape
    check_seq(seq, S, values=values)
    ops.check_kernel_input("logpost", lp, (T, B, S))
    ops.check_kernel_input("seqstates", seq, (B, seq.shape[1]), torch.int32)


def state_lists(seq, S: int):
    """The positions of each kmer state of each row, for the backward's
    gradient: (start [B, S+1], pos [B, L]) int32, the row's positions of
    state s at pos[b, start[b, s] : start[b, s+1]] in increasing order
    (padding after them all)."""
    key = torch.where(seq >= 0, seq.long(), S)
    pos = torch.sort(key, dim=1, stable=True).indices
    counts = torch.zeros((seq.shape[0], S + 1), dtype=torch.long,
                         device=seq.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    start = torch.cat([counts.new_zeros((seq.shape[0], 1)),
                       counts[:, :S].cumsum(1)], 1)
    return start.int().contiguous(), pos.int().contiguous()


def _scratch(kind: int, B: int, lay: Layout, global_rows: bool, device):
    """None where a CTA's per-position arrays (kind 0 the transducer's, 1
    the CRF's) fit in its shared memory, else the global scratch [B, ncta,
    floats] they live in instead; global_rows puts them there at any size
    (to check that mode at a size whose arrays would fit)."""
    from scrappie_torch.ops import _build

    floats = _build.library().scrappie_lattice_floats(kind, lay.per)
    if not global_rows and 4 * floats + 8192 <= ops.MAX_SMEM_BYTES:
        return None
    return torch.empty((B, lay.ncta, floats), dtype=torch.float32,
                       device=device)


def lattice_fwd_cuda(lp, seq, stay_pen: float, skip_pen: float,
                     local_pen: float, chunk: int | None = None,
                     global_rows: bool = False):
    """The transducer kernel's forward mode: lattice_fwd_plain's arguments
    and result (global_rows: see `_scratch`)."""
    check_lattice_input(lp, seq)
    T, B, S = lp.shape
    L = seq.shape[1]
    C, n = chunking(T, chunk)
    dev = lp.device
    ckpt = torch.empty((B, n + 1, L + 2), dtype=torch.float32, device=dev)
    rows = torch.empty((B, C, L + 2), dtype=torch.float32, device=dev)
    m = torch.empty((B, T + 1), dtype=torch.float32, device=dev)
    logp = torch.empty((B,), dtype=torch.float32, device=dev)
    lay = cluster_layout(L)
    _launch_transducer(0, lp, seq, ckpt, rows, m, logp, None, None, None,
                       None, None, None, lay, global_rows,
                       (stay_pen, skip_pen, local_pen))
    return logp, ckpt, rows, m


def lattice_bwd_cuda(lp, seq, ckpt, rows, m, gP, stay_pen: float,
                     skip_pen: float, local_pen: float,
                     global_rows: bool = False, lists=None):
    """The transducer kernel's backward mode: lattice_bwd_plain's
    arguments and result (global_rows: see `_scratch`; lists:
    `state_lists(seq, S)` of a seq the forward checked, or None: taken
    here, and seq's states checked)."""
    checked = lists is not None
    if lists is None:
        lists = state_lists(seq, lp.shape[2])
    check_lattice_input(lp, seq, values=not checked)
    T, B, S = lp.shape
    L = seq.shape[1]
    C, n = rows.shape[1], ckpt.shape[1] - 1
    ops.check_kernel_input("ckpt", ckpt, (B, n + 1, L + 2))
    ops.check_kernel_input("rows", rows, (B, C, L + 2))
    ops.check_kernel_input("m", m, (B, T + 1))
    ops.check_kernel_input("gP", gP, (B,))
    if (C, n) != chunking(T, C):
        raise ValueError(f"rows of {C} steps and {n} checkpoints do not "
                         f"chunk T = {T}")
    dev = lp.device
    lay = cluster_layout(L)
    grad = torch.empty_like(lp)
    work = (torch.empty((B, C, L + 2), dtype=torch.float32, device=dev)
            if n > 1 else None)
    post = torch.empty((B, C, L), dtype=torch.float32, device=dev)
    part = torch.empty((B, C, lay.ncta, 2), dtype=torch.float32, device=dev)
    _launch_transducer(1, lp, seq, ckpt, rows, m, None, gP, grad, work, post,
                       part, lists, lay, global_rows,
                       (stay_pen, skip_pen, local_pen))
    return grad


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_transducer(mode, lp, seq, ckpt, rows, m, logp, gP, grad, work,
                       post, part, lists, lay: Layout, global_rows: bool,
                       pens):
    from scrappie_torch.ops import _build

    T, B, S = lp.shape
    if B == 0:
        return
    with torch.cuda.device(lp.device):
        scratch = _scratch(0, B, lay, global_rows, lp.device)
        start, pos = lists if lists is not None else (None, None)
        err = _build.library().scrappie_lattice(
            mode, lp.data_ptr(), seq.data_ptr(), ckpt.data_ptr(),
            rows.data_ptr(), m.data_ptr(), _ptr(logp), _ptr(gP), _ptr(grad),
            _ptr(work), _ptr(post), _ptr(part), _ptr(start), _ptr(pos),
            _ptr(scratch), T, B, S, seq.shape[1], rows.shape[1], lay.ncta,
            lay.per, lay.threads, lay.ppt, *(ops.f32(p) for p in pens),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "lattice_fwdbwd")
    ops.LAUNCHES["lattice_fwdbwd"] += 1


class TransducerLattice(torch.autograd.Function):
    """lp [T, B, S], seqstates [B, L] -> log P [B], differentiable in lp;
    saves the checkpoints every `chunk` steps and the last chunk's rows."""

    @staticmethod
    def forward(ctx, lp, seq, stay_pen, skip_pen, local_pen, chunk):
        pens = (stay_pen, skip_pen, local_pen)
        lists = ()
        if ops.on_cuda(lp, seq):
            logp, ckpt, rows, m = lattice_fwd_cuda(lp, seq, *pens, chunk)
            # the backward's state lists, queued behind the forward kernel
            lists = state_lists(seq, lp.shape[2])
        else:
            logp, ckpt, rows, m = lattice_fwd_plain(lp, seq, *pens, chunk)
        ctx.save_for_backward(lp, seq, ckpt, rows, m, *lists)
        ctx.pens = pens
        return logp

    @staticmethod
    def backward(ctx, gP):
        lp, seq, ckpt, rows, m, *lists = ctx.saved_tensors
        if ops.on_cuda(lp, seq):
            grad = lattice_bwd_cuda(lp, seq, ckpt, rows, m, gP.contiguous(),
                                    *ctx.pens, lists=lists)
        else:
            grad = lattice_bwd_plain(lp, seq, ckpt, rows, m, gP, *ctx.pens)
        return grad, None, None, None, None, None


def lattice_forward_tm(lp, seqstates, stay_pen: float = 0.0,
                       skip_pen: float = 4.0, local_pen: float = 4.0,
                       chunk: int | None = None):
    """log P(sequence | posterior) [B], local-global, of kmer states
    seqstates [B, L] (-1 right padding) under log posteriors lp [T, B, S]
    (time-major; stay class S - 1): train/lattice.py's
    lattice_forward_batch, differentiable in lp; the backward recomputes
    the rows of each `chunk` steps from a checkpoint (None: keeps them
    all)."""
    # on the card the kernel's wrapper checks the states, once
    check_seq(seqstates, lp.shape[-1], values=lp.device.type == "cpu")
    chunking(lp.shape[0], chunk)
    seq = seqstates.to(device=lp.device, dtype=torch.int32).contiguous()
    return TransducerLattice.apply(lp, seq, float(stay_pen), float(skip_pen),
                                   float(local_pen), chunk)


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


def _crf_step(prev, mprev, tr, jvalid, idx_ee, idx_es, idx_se, seqlen,
              local_pen: float):
    """The CRF forward's row r_t [B, 2J+2] from r_{t-1} and m_{t-1}."""
    J = jvalid.shape[1]
    sl = seqlen[:, None]
    p = prev - mprev[:, None]
    a_e, a_s = p[:, :J], p[:, J : 2 * J]
    start, end = p[:, 2 * J], p[:, 2 * J + 1]
    ee, es = torch.gather(tr, 1, idx_ee), torch.gather(tr, 1, idx_es)
    se, ss = torch.gather(tr, 1, idx_se), tr[:, 4 * NS + 4]
    new_e = lae(_shift(a_e, 1) + ee, _shift(a_s, 1) + es)
    new_e1 = lae(new_e[:, 1:2], start[:, None] + es[:, 1:2])
    new_e = torch.cat([new_e[:, :1], new_e1, new_e[:, 2:]], 1)
    new_s = lae(a_e + se, a_s + ss[:, None])
    local_stay = lae(torch.full_like(ss, -local_pen), ss)
    exit_c = lae(torch.gather(a_e, 1, sl)[:, 0],
                 torch.gather(a_s, 1, sl)[:, 0]) - local_pen
    return torch.cat([torch.where(jvalid, new_e, NEG),
                      torch.where(jvalid, new_s, NEG),
                      (start + local_stay)[:, None],
                      lae(end + local_stay, exit_c)[:, None]], 1)


def crf_fwd_plain(trans, bases, local_pen: float, chunk: int | None = None):
    """Plain twin of the CRF kernel's forward mode, the sequence lattice:
    trans [T, B, 25], bases [B, L] -> (logP [B], ckpt [B, n+1, 2L+4],
    rows [B, C, 2L+4], m [B, T+1]) (`chunking`; a row r_t: emit states
    0..L, '-' states 0..L, START, END)."""
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    C, n = chunking(T, chunk)
    setup = _crf_setup(bases)
    ckpt = trans.new_empty((B, n + 1, 2 * J + 2))
    rows = trans.new_full((B, C, 2 * J + 2), NEG)
    m = trans.new_zeros((B, T + 1))
    row = _sentinel(trans, B, 2 * J + 2)
    row[:, 2 * J] = 0.0
    _keep(ckpt, rows, 0, row, T, C, n)
    for t in range(T):
        row = _crf_step(row, m[:, t], trans[t], *setup, local_pen)
        m[:, t + 1] = row.amax(1)
        _keep(ckpt, rows, t + 1, row, T, C, n)
    fin = _crf_final(ckpt[:, n] - m[:, T, None], setup[4], J)
    return (m.double().sum(1) + fin.double()).float(), ckpt, rows, m


def _crf_final(ahat, seqlen, J: int):
    sl = seqlen[:, None]
    return lae(lae(torch.gather(ahat[:, :J], 1, sl)[:, 0],
                   torch.gather(ahat[:, J : 2 * J], 1, sl)[:, 0]),
               ahat[:, 2 * J + 1])


def crf_bwd_plain(trans, bases, ckpt, rows, m, gP, local_pen: float):
    """Plain twin of the CRF kernel's backward mode for the sequence
    lattice: the forward's ckpt, rows and m, gP [B] -> d(log P)/dtrans * gP
    [T, B, 25]; a chunk's rows recomputed from its checkpoint."""
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    n = ckpt.shape[1] - 1
    jvalid, idx_ee, idx_es, idx_se, seqlen = setup = _crf_setup(bases)
    grad = torch.zeros_like(trans)
    fin = _crf_final(ckpt[:, n] - m[:, T, None], seqlen, J)
    impossible = _impossible(fin)
    rows_b = torch.arange(B, device=trans.device)
    be = _sentinel(trans, B, J)
    be[rows_b, seqlen] = -fin
    bs = be.clone()
    bstart, bend = _sentinel(trans, B), -fin
    neg_local = torch.full((B,), -local_pen, dtype=trans.dtype,
                           device=trans.device)
    sl = seqlen[:, None]
    step = lambda prev, mp, t: _crf_step(prev, mp, trans[t - 1], *setup,
                                         local_pen)
    for lo, hi, block in _chunk_rows(step, ckpt, rows, m, T):
        for t in range(hi, lo, -1):
            tr = trans[t - 1]
            mt = m[:, t, None]
            prev = block[:, t - 1 - lo] - m[:, t - 1, None]
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
            exit_post = (torch.exp(torch.gather(a_e, 1, sl)[:, 0] - local_pen
                                   + bend - mt[:, 0])
                         + torch.exp(torch.gather(a_s, 1, sl)[:, 0] - local_pen
                                     + bend - mt[:, 0]))
            total = ((p_ee + p_es + p_se + p_ss)[:, 1:].sum(1)
                     + (p_se + p_ss)[:, 0] + ends + exit_post)
            g = torch.zeros((B, NCLASS), dtype=trans.dtype, device=trans.device)
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
        grad[t - 1] = post.reshape(B, NCLASS) * gZ[:, None]
        n5 = logsumexp(tmat + b5[:, :, None], 1)[:, 0]
        n5 = lae(n5, (-local_pen + bend)[:, None]) - mt
        into = tmat[:, :4, 4] + b5[:, :4]
        bstart = lae(local_stay + bstart, _lse5(into)) - mt[:, 0]
        bend = local_stay + bend - mt[:, 0]
        b5 = n5
    return grad


def check_crf_lattice_input(trans, bases, values: bool = True) -> None:
    """Raise unless the CRF kernel takes these inputs: contiguous float32
    trans [T, B, 25] and int32 bases [B, L], L >= 1, of bases 0-3 (values:
    checked here)."""
    T, B, _ = trans.shape
    check_seq(bases, NS - 1, "bases", values)
    ops.check_kernel_input("trans", trans, (T, B, NCLASS))
    ops.check_kernel_input("bases", bases, (B, bases.shape[1]), torch.int32)


def class_lists(bases, lay: Layout):
    """The posteriors of each transition class among each CTA's
    positions, for the CRF backward's gradient: (start [B, ncta, 25], idx
    [B, ncta, 3 per]) int32. A CTA's posteriors are ee, es and se of its
    positions, entry k per + i for type k and the CTA's i-th position; those
    of class c (0..23) are idx[b, cta, start[c] : start[c+1]] in increasing
    order (start[24] ends class 23; the positions past a row's bases, and
    j = 0's ee and es, are in no class)."""
    B, L = bases.shape
    J = L + 1
    jvalid, idx_ee, idx_es, idx_se, _ = _crf_setup(bases)
    first = torch.arange(J, device=bases.device) >= 1
    sink = NCLASS - 1
    cls = torch.stack([torch.where(jvalid & first, idx_ee, sink),
                       torch.where(jvalid & first, idx_es, sink),
                       torch.where(jvalid, idx_se, sink)], 1)  # [B, 3, J]
    pad = lay.ncta * lay.per - J
    cls = torch.cat([cls, cls.new_full((B, 3, pad), sink)], 2)
    cls = cls.reshape(B, 3, lay.ncta, lay.per).transpose(1, 2).reshape(
        B, lay.ncta, 3 * lay.per)
    idx = torch.sort(cls, dim=2, stable=True).indices
    counts = torch.zeros((B, lay.ncta, NCLASS), dtype=torch.long,
                         device=bases.device)
    counts.scatter_add_(2, cls, torch.ones_like(cls))
    start = torch.cat([counts.new_zeros((B, lay.ncta, 1)),
                       counts[..., : NCLASS - 1].cumsum(2)], 2)
    return start.int().contiguous(), idx.int().contiguous()


def _launch_crf(mode, trans, bases, ckpt, rows, m, z, zm, out, gP, gZ, grads,
                work, part, lists, lay: Layout, global_rows: bool, local_pen):
    from scrappie_torch.ops import _build

    T, B, _ = trans.shape
    if B == 0:
        return
    with torch.cuda.device(trans.device):
        scratch = _scratch(1, B, lay, global_rows, trans.device)
        start, idx = lists if lists is not None else (None, None)
        err = _build.library().scrappie_crf_lattice(
            mode, trans.data_ptr(), bases.data_ptr(), ckpt.data_ptr(),
            rows.data_ptr(), m.data_ptr(), z.data_ptr(), zm.data_ptr(),
            _ptr(out), _ptr(gP), _ptr(gZ), _ptr(grads), _ptr(work),
            _ptr(part), _ptr(start), _ptr(idx), _ptr(scratch), T, B,
            bases.shape[1], rows.shape[1], lay.ncta, lay.per, lay.threads,
            lay.ppt, ops.f32(local_pen), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "crf_lattice_fwdbwd")
    ops.LAUNCHES["crf_lattice_fwdbwd"] += 1


def crf_lattice_fwd_cuda(trans, bases, local_pen: float,
                         chunk: int | None = None, global_rows: bool = False):
    """The CRF kernel's forward mode, both lattices in one launch ->
    (logP [B], logZ [B], ckpt, rows, m, z, zm) as the twins give them
    (global_rows: see `_scratch`)."""
    check_crf_lattice_input(trans, bases)
    T, B, _ = trans.shape
    J = bases.shape[1] + 1
    C, n = chunking(T, chunk)
    dev = trans.device
    ckpt = torch.empty((B, n + 1, 2 * J + 2), dtype=torch.float32, device=dev)
    rows = torch.empty((B, C, 2 * J + 2), dtype=torch.float32, device=dev)
    m = torch.empty((B, T + 1), dtype=torch.float32, device=dev)
    z = torch.empty((B, T + 1, 8), dtype=torch.float32, device=dev)
    zm = torch.empty((B, T + 1), dtype=torch.float32, device=dev)
    out = torch.empty((2, B), dtype=torch.float32, device=dev)
    _launch_crf(0, trans, bases, ckpt, rows, m, z, zm, out, None, None, None,
                None, None, None, cluster_layout(J), global_rows, local_pen)
    return out[0], out[1], ckpt, rows, m, z, zm


def crf_lattice_bwd_cuda(trans, bases, ckpt, rows, m, z, zm, gP, gZ,
                         local_pen: float, global_rows: bool = False,
                         lists=None):
    """The CRF kernel's backward mode -> d(gP log P + gZ logZ)/dtrans
    [T, B, 25] (the lattice's and the partition's rows in one launch, two
    arrays, summed; global_rows: see `_scratch`; lists: `class_lists` of
    the layout for bases the forward checked, or None: taken here, and the
    bases checked)."""
    J = bases.shape[1] + 1
    lay = cluster_layout(J)
    checked = lists is not None
    if lists is None:
        lists = class_lists(bases, lay)
    check_crf_lattice_input(trans, bases, values=not checked)
    T, B, _ = trans.shape
    C, n = rows.shape[1], ckpt.shape[1] - 1
    for name, t, shape in (("ckpt", ckpt, (B, n + 1, 2 * J + 2)),
                           ("rows", rows, (B, C, 2 * J + 2)),
                           ("m", m, (B, T + 1)), ("z", z, (B, T + 1, 8)),
                           ("zm", zm, (B, T + 1)), ("gP", gP, (B,)),
                           ("gZ", gZ, (B,))):
        ops.check_kernel_input(name, t, shape)
    if (C, n) != chunking(T, C):
        raise ValueError(f"rows of {C} steps and {n} checkpoints do not "
                         f"chunk T = {T}")
    dev = trans.device
    grads = torch.empty((2, T, B, NCLASS), dtype=torch.float32, device=dev)
    work = (torch.empty((B, C, 2 * J + 2), dtype=torch.float32, device=dev)
            if n > 1 else None)
    part = torch.empty((B, C, lay.ncta, NCLASS + 1), dtype=torch.float32,
                       device=dev)
    _launch_crf(1, trans, bases, ckpt, rows, m, z, zm, None, gP, gZ, grads,
                work, part, lists, lay, global_rows, local_pen)
    return grads[0] + grads[1]


class CrfLattice(torch.autograd.Function):
    """trans [T, B, 25], bases [B, L] -> (log P [B], logZ_local [B]),
    differentiable in trans; saves the checkpoints every `chunk` steps,
    the last chunk's rows and the partition's rows."""

    @staticmethod
    def forward(ctx, trans, bases, local_pen, chunk):
        lists = ()
        if ops.on_cuda(trans, bases):
            logp, logz, *saved = crf_lattice_fwd_cuda(trans, bases, local_pen,
                                                      chunk)
            # the backward's class lists, queued behind the forward kernel
            lists = class_lists(bases, cluster_layout(bases.shape[1] + 1))
        else:
            logp, *kept = crf_fwd_plain(trans, bases, local_pen, chunk)
            logz, z, zm = partition_fwd_plain(trans, local_pen)
            saved = (*kept, z, zm)
        ctx.save_for_backward(trans, bases, *saved, *lists)
        ctx.local_pen = local_pen
        return logp, logz

    @staticmethod
    def backward(ctx, gP, gZ):
        trans, bases, ckpt, rows, m, z, zm, *lists = ctx.saved_tensors
        B = trans.shape[1]
        gP = trans.new_zeros(B) if gP is None else gP.contiguous()
        gZ = trans.new_zeros(B) if gZ is None else gZ.contiguous()
        if ops.on_cuda(trans, bases):
            grad = crf_lattice_bwd_cuda(trans, bases, ckpt, rows, m, z, zm, gP,
                                        gZ, ctx.local_pen, lists=lists)
        else:
            grad = (crf_bwd_plain(trans, bases, ckpt, rows, m, gP,
                                  ctx.local_pen)
                    + partition_bwd_plain(trans, z, zm, gZ, ctx.local_pen))
        return grad, None, None, None


def crf_lattice_tm(trans, bases, local_pen: float = 4.0,
                   chunk: int | None = None):
    """(log P(bases | trans) [B], logZ_local [B]) of base sequences bases
    [B, L] (0-3, -1 right padding) under CRF transitions trans [T, B, 25]
    (time-major): train/lattice.py's crf_lattice_forward_batch and
    crf_local_partition, one forward-backward, differentiable in trans;
    the backward recomputes the rows of each `chunk` steps from a
    checkpoint (None: keeps them all)."""
    # on the card the kernel's wrapper checks the bases, once
    check_seq(bases, NS - 1, "bases", values=trans.device.type == "cpu")
    chunking(trans.shape[0], chunk)
    b = bases.to(device=trans.device, dtype=torch.int32).contiguous()
    return CrfLattice.apply(trans, b, float(local_pen), chunk)
