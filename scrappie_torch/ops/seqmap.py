"""Posterior-to-sequence mapping: the DP over the blocks of a posterior,
the walk of its moves, and the banded DP.

Counterpart of scrappie_tpu/ops/seqmap.py (map_to_sequence_tm, the Pallas
kernel _seqmap_kernel) and of the lax.scan programs of
scrappie_tpu/decode/mapping.py, _map_dense and _map_banded, whose order of
operations and tie rules the plain twins copy step for step. States: the
seqlen reference positions, then the local START (seqlen) and END
(seqlen + 1). Per block, with stay_lp = lp[t, nst-1] and emit =
lp[t, seqstates], a position takes, in this order, stay (prev - stay_pen) +
stay_lp, step prev[pos-1] + emit, skip (prev[pos-2] - skip_pen) + emit and,
at position 0, entry prev[START] + emit; START stays at local_stay and END
stays, then takes the exit prev[seqlen-1] - local_pen. Viterbi takes a
candidate by strict `>`; the forward variant combines them by
jnp.logaddexp's formula.

The Viterbi traceback is a move byte a state, `moves` uint8 [T, ld] (ld =
`move_stride(seqlen)`, seqlen + 2 rounded up to 16; the padding is 0):
0 stay, 1 step, 2 skip (END: the exit from seqlen-1), 3 entry (from
START). A state's predecessor is its index less its move, or START for
move 3; `moves_to_traceback` rebuilds JAX's int32 traceback from it, its
-1 and -2 (a step or skip into position 0 or 1 that won on a -inf
posterior) included. `seqmap_walk` follows the moves back to the path on
the card, so only the path and two final scores reach the host.

The Pallas kernel clamps -inf log posteriors to -1e30, only because its
lane gather is a one-hot matmul (0 * inf = NaN). The scans do not clamp,
and neither does the port: every version here is held to the scans.
Robustlog posteriors are finite, so the basecallers' posteriors never see
the difference.

On a CUDA tensor each wrapper launches its kernel of csrc/seqmap.cu
(`map_to_sequence_tm`: scores in registers up to SEQMAP_MAX_REGISTER_SEQLEN
positions, in global memory above; `map_banded_tm`: up to BAND_WARP_MAX
offsets a gather of the band's emissions into a plane, then the DP on one
warp, the window in its shared memory; wider, one block with the window in
shared memory while it fits, in global memory above: `banded_layout`) or
raises; on a CPU tensor it runs its plain twin. There is no lane or time
padding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from scrappie_torch import ops

BIG = 1.0e30
#: Blocks whose emissions the twin gathers at once.
EMIT_BLOCK = 256
#: Posterior rows in the kernels' shared-memory ring.
RING = 8
MAX_THREADS = 1024
#: States a thread holds in registers (the smallest that covers a read's
#: states with at most MAX_THREADS threads), and in the global-memory mode.
#: A Viterbi run's moves go out as one store of 4, 8 or 16 bytes; the
#: forward variant stores none and takes more threads (its logaddexp
#: chains want every warp the block can have).
RUNS = (4, 8, 16)
FORWARD_RUNS = (4, 6, 8, 12, 16)
GLOBAL_RUN = 4
#: Longest reference whose scores the seqmap kernel keeps in registers.
SEQMAP_MAX_REGISTER_SEQLEN = MAX_THREADS * RUNS[-1] - 2
#: The banded kernel's warp mode: offsets a lane (their emissions in
#: registers), so bands up to 32 x 8 offsets; the plane rows in its ring,
#: and a bulk copy's; the words after a plane row's emissions (stay,
#: entry, low, high).
BAND_LANE_RUNS = (1, 2, 4, 8)
BAND_WARP_MAX = 32 * BAND_LANE_RUNS[-1]
BAND_DEPTH = 32
BAND_BATCH = 8
BAND_HEADER = 4
STAY, STEP, SKIP, ENTRY = 0, 1, 2, 3
#: The walk kernel's windows: rows a window holds, the columns the walk can
#: fall across a window and the next (2 a row), the 16-byte pieces of a
#: window's row that hold that fall at any alignment, and the bytes before
#: the two windows (a rejected batch's reads, 8 x 255 below a row).
WALK_ROWS = 128
WALK_FALL = 4 * WALK_ROWS - 2
WALK_PIECES = (WALK_FALL + 15) // 16 + 1
WALK_PITCH = 16 * WALK_PIECES
WALK_PAD = 2048


class SeqmapLayout(NamedTuple):
    run: int            # consecutive states a thread owns
    threads: int        # threads of the one block
    in_registers: bool  # scores in registers, else in a global scratch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def seqmap_layout(seqlen: int, global_state: bool | None = None,
                  viterbi: bool = True) -> SeqmapLayout:
    """The seqmap kernel's layout for a reference of seqlen positions: the
    smallest run of RUNS (FORWARD_RUNS for the forward variant) whose
    threads (a multiple of 32) cover the seqlen + 2 states, scores in
    registers; above SEQMAP_MAX_REGISTER_SEQLEN (or with global_state) runs
    of GLOBAL_RUN on MAX_THREADS threads, scores in global memory."""
    n = seqlen + 2
    if global_state is None:
        global_state = seqlen > SEQMAP_MAX_REGISTER_SEQLEN
    if global_state:
        return SeqmapLayout(GLOBAL_RUN, MAX_THREADS, False)
    if seqlen > SEQMAP_MAX_REGISTER_SEQLEN:
        raise ValueError(f"seqlen={seqlen} does not fit in registers (at most "
                         f"{SEQMAP_MAX_REGISTER_SEQLEN})")
    run = next(r for r in (RUNS if viterbi else FORWARD_RUNS)
               if -(-n // r) <= MAX_THREADS)
    return SeqmapLayout(run, _round_up(-(-n // run), 32), True)


def move_stride(seqlen: int) -> int:
    """Bytes of a row of `moves`: the seqlen + 2 states, rounded up to 16."""
    return _round_up(seqlen + 2, 16)


def ring_bytes(nst: int) -> int:
    """The kernels' ring of RING posterior rows, each slot a row and the
    16-byte-aligned span around it."""
    return 4 * RING * _round_up(nst + 3, 4)


def shared_bytes(nst: int) -> int:
    """Dynamic shared memory of the seqmap kernel: the ring and the warps'
    edges (two float pairs a warp)."""
    return ring_bytes(nst) + 8 * 2 * 32


def walk_window(col: int, ld: int) -> tuple[int, int]:
    """The walk kernel's window anchored at column col of rows of ld
    bytes: (lo, pieces), its bytes [lo, lo + 16 pieces) of each row. lo is
    16-byte aligned and at most col - WALK_FALL (0 at the least), so the
    window holds every column the walk can reach from col in 2 WALK_ROWS
    rows, falling 2 a row at the most (csrc/seqmap.cu walk_lo)."""
    lo = max(col - WALK_FALL, 0) & ~15
    return lo, min(WALK_PIECES, (ld - lo) // 16)


def walk_smem_bytes() -> int:
    """Dynamic shared memory of the walk kernel: WALK_PAD bytes, two
    windows of WALK_ROWS rows of WALK_PITCH bytes, and a row's bytes after
    them (the look-ahead of a batch that ends a window)."""
    return WALK_PAD + 2 * WALK_ROWS * WALK_PITCH + WALK_PITCH


class BandedLayout(NamedTuple):
    threads: int        # 32 in the warp mode, else a thread an offset
    shared: bool        # the window in shared memory, else a global scratch
    per_lane: int       # the warp mode's offsets a lane; 0: the block mode


def plane_stride(width: int) -> int:
    """Floats of a row of the warp mode's plane: the band's emissions,
    rounded up to 16 bytes, then BAND_HEADER words."""
    return _round_up(width, 4) + BAND_HEADER


def band_span(width: int, per_lane: int) -> int:
    """Floats of one of the warp mode's two windows with its guards: width
    before it, and after it 32 per_lane, since a slice start clamped to
    2 width puts lane 31's last offset's read at width + 32 per_lane - 1."""
    return 2 * width + 32 * per_lane


def banded_shared_bytes(nst: int, width: int, shared_window: bool,
                        per_lane: int = 0) -> int:
    """Dynamic shared memory of the banded kernel. The warp mode (per_lane
    > 0): its ring of BAND_DEPTH plane rows, two windows of band_span
    floats and an mbarrier a batch of BAND_BATCH rows. The block mode: the
    ring of RING posterior rows, its bounds (two ints a row) and, with
    shared_window, the window's scores, double-buffered."""
    if per_lane:
        return 4 * (BAND_DEPTH * plane_stride(width) + 2 * band_span(width, per_lane)) \
            + 8 * (BAND_DEPTH // BAND_BATCH)
    return ring_bytes(nst) + 4 * 2 * RING + (8 * width if shared_window else 0)


def max_shared_width(nst: int) -> int:
    """Widest band whose window the banded kernel keeps in shared memory."""
    return (ops.MAX_SMEM_BYTES - banded_shared_bytes(nst, 0, False)) // 8


def banded_layout(nst: int, width: int,
                  global_state: bool | None = None) -> BandedLayout:
    """The banded kernel's launch plan: up to BAND_WARP_MAX offsets one warp,
    each lane the fewest offsets of BAND_LANE_RUNS that cover the band
    (the warp mode); wider, one block of a thread an offset up to
    MAX_THREADS (a multiple of 32), the window in shared memory while it
    fits. global_state=True puts the window in global memory (the block
    mode at any width); False refuses a band whose window does not fit."""
    fits = width <= max_shared_width(nst)
    shared = fits if global_state is None else not global_state
    if shared and not fits:
        raise ValueError(f"width={width} does not fit in shared memory (at "
                         f"most {max_shared_width(nst)} at nst={nst})")
    if shared and width <= BAND_WARP_MAX:
        return BandedLayout(32, True,
                            next(r for r in BAND_LANE_RUNS if 32 * r >= width))
    return BandedLayout(min(MAX_THREADS, _round_up(width, 32)), shared, 0)


def _check(lp, seqstates) -> None:
    if lp.dim() != 2 or seqstates.dim() != 1 or seqstates.shape[0] < 1:
        raise ValueError(f"lp must be [T, nst] and seqstates [seqlen >= 1], "
                         f"got {tuple(lp.shape)} and {tuple(seqstates.shape)}")


def check_seqmap_input(lp, seqstates) -> None:
    """Raise unless the inputs are what the kernels take: contiguous
    float32 lp [T >= 1, nst], int32 seqstates [seqlen], a ring of RING
    posterior rows within shared memory."""
    _check(lp, seqstates)
    ops.check_kernel_input("lp", lp, tuple(lp.shape))
    ops.check_kernel_input("seqstates", seqstates, tuple(seqstates.shape),
                           torch.int32)
    if lp.shape[0] < 1:
        raise ValueError("lp has no blocks")
    if shared_bytes(lp.shape[1]) > ops.MAX_SMEM_BYTES:
        raise ValueError(f"nst={lp.shape[1]}: {RING} posterior rows exceed "
                         "shared memory")


def _check_states(seqstates, nst: int) -> None:
    if not bool(((seqstates >= 0) & (seqstates < nst)).all()):
        raise ValueError(f"seqstates outside [0, {nst})")


def _pens(stay_pen, skip_pen, local_pen, dev):
    return (torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (stay_pen, skip_pen, local_pen))


def map_to_sequence_plain(lp, seqstates, stay_pen=0.0, skip_pen=0.0,
                          local_pen=4.0, viterbi: bool = True,
                          want_path: bool = True):
    """Plain twin of the seqmap kernel (the scan of decode/mapping.py): lp
    [T, nst], seqstates [seqlen] -> (final [seqlen+2], moves [T,
    move_stride(seqlen)] uint8 or None)."""
    _check(lp, seqstates)
    T, nst = lp.shape
    seqlen = seqstates.shape[0]
    START, END = seqlen, seqlen + 1
    dev = lp.device
    stay, skip, local = _pens(stay_pen, skip_pen, local_pen, dev)
    neg2 = torch.tensor(-BIG, dtype=torch.float32, device=dev).expand(2)
    code = lambda v: torch.tensor(v, dtype=torch.uint8, device=dev)
    stay_code = torch.zeros(seqlen, dtype=torch.uint8, device=dev)
    step_code, skip_code, entry_code = code(STEP), code(SKIP), code(ENTRY)
    idx = seqstates.long()

    prev = torch.full((seqlen + 2,), -BIG, dtype=torch.float32, device=dev)
    prev[START] = 0.0
    moves = None
    if viterbi and want_path:
        moves = torch.zeros((T, move_stride(seqlen)), dtype=torch.uint8,
                            device=dev)

    def contend(cur, mv, cand, cmv):
        if not viterbi:
            return ops.logaddexp(cur, cand), None
        upd = cand > cur
        return torch.where(upd, cand, cur), torch.where(upd, cmv, mv)

    for t0 in range(0, T, EMIT_BLOCK):
        blk = lp[t0:t0 + EMIT_BLOCK]
        emit_blk, stay_blk = blk.index_select(1, idx), blk[:, nst - 1]
        for i in range(blk.shape[0]):
            emit, stay_lp = emit_blk[i], stay_blk[i]
            shifted = torch.cat([neg2, prev[:seqlen]])
            cur, mv = prev[:seqlen] - stay + stay_lp, stay_code
            cur, mv = contend(cur, mv, shifted[1:-1] + emit, step_code)
            cur, mv = contend(cur, mv, shifted[:-2] - skip + emit, skip_code)
            entry = prev[START] + emit[0]
            if viterbi:
                upd0 = entry > cur[0]
                cur[0] = torch.where(upd0, entry, cur[0])
                mv = mv.clone()
                mv[0] = torch.where(upd0, entry_code, mv[0])
                local_stay = torch.maximum(-local, stay_lp)
            else:
                cur[0] = ops.logaddexp(cur[0], entry)
                local_stay = ops.logaddexp(-local, stay_lp)
            start_new = prev[START] + local_stay
            end_new = prev[END] + local_stay
            exit_c = prev[seqlen - 1] - local
            if viterbi:
                upd = exit_c > end_new
                end_new = torch.where(upd, exit_c, end_new)
                if moves is not None:
                    moves[t0 + i, :seqlen] = mv
                    moves[t0 + i, END] = torch.where(upd, skip_code, code(STAY))
            else:
                end_new = ops.logaddexp(end_new, exit_c)
            prev = torch.cat([cur, start_new[None], end_new[None]])
    return prev, moves


def moves_to_traceback(moves, seqlen: int):
    """JAX's int32 traceback [T, seqlen+2] (each state's predecessor) from
    the moves [T, move_stride(seqlen)]: the state's index less its move, or
    START for an entry."""
    mv = moves[:, :seqlen + 2].to(torch.int32)
    idx = torch.arange(seqlen + 2, dtype=torch.int32, device=moves.device)
    return torch.where(mv == ENTRY, torch.full_like(mv, seqlen), idx - mv)


def map_to_sequence_tm(lp, seqstates, stay_pen=0.0, skip_pen=0.0,
                       local_pen=4.0, viterbi: bool = True,
                       want_path: bool = True,
                       global_state: bool | None = None):
    """The posterior-to-sequence DP of one read: lp [T, nst] log
    posterior, seqstates [seqlen] int32 kmer state of each reference
    position (in [0, nst-1)) -> (final [seqlen+2], moves [T,
    move_stride(seqlen)] uint8 for Viterbi with want_path, else None).
    global_state forces the kernel's scores into global (True) memory or
    registers (False); by default they stay in registers while they fit."""
    if not ops.on_cuda(lp, seqstates):
        return map_to_sequence_plain(lp, seqstates, stay_pen, skip_pen,
                                     local_pen, viterbi, want_path)
    from scrappie_torch.ops import _build

    check_seqmap_input(lp, seqstates)
    T, nst = lp.shape
    seqlen = seqstates.shape[0]
    _check_states(seqstates, nst)
    layout = seqmap_layout(seqlen, global_state, viterbi)
    dev = lp.device
    ld = move_stride(seqlen)
    final = torch.empty(seqlen + 2, dtype=torch.float32, device=dev)
    moves = (torch.empty((T, ld), dtype=torch.uint8, device=dev)
             if viterbi and want_path else None)
    scratch = (None if layout.in_registers else
               torch.empty(2 * ld, dtype=torch.float32, device=dev))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _build.library().scrappie_seqmap(
            lp.data_ptr(), seqstates.data_ptr(), ptr(scratch), final.data_ptr(),
            ptr(moves), T, nst, seqlen, ld, ops.f32(stay_pen), ops.f32(skip_pen),
            ops.f32(local_pen), int(viterbi), layout.run, layout.threads,
            int(not layout.in_registers), ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "seqmap")
    ops.LAUNCHES["seqmap"] += 1
    return final, moves


def seqmap_walk_plain(final, moves, seqlen: int):
    """Plain twin of the walk kernel: the numpy walk of
    scrappie_tpu/decode/mapping.py:map_to_sequence_viterbi over the
    traceback that `moves_to_traceback` rebuilds (the last position if its
    final beats END's, else END; START and END shown as -1; a state of -1
    or -2 indexes the row as numpy does, from its end). Returns path [T]
    int32 on final's device."""
    tbs = moves_to_traceback(moves, seqlen).cpu().numpy()
    fin = final.cpu().numpy()
    T, END = tbs.shape[0], seqlen + 1
    path = np.zeros(T, dtype=np.int32)
    path[T - 1] = seqlen - 1 if fin[seqlen - 1] > fin[END] else END
    for t in range(T - 1, 0, -1):
        path[t - 1] = tbs[t, path[t]]
    path[(path == seqlen) | (path == END)] = -1
    return torch.from_numpy(path).to(final.device)


def check_walk_input(final, moves, seqlen: int) -> None:
    """Raise unless the inputs are what the walk kernel takes: contiguous
    float32 final [seqlen+2] and uint8 moves [T >= 1, move_stride(seqlen)]
    starting at a multiple of 16 bytes."""
    ops.check_kernel_input("final", final, (seqlen + 2,))
    ops.check_kernel_input("moves", moves, (moves.shape[0], move_stride(seqlen)),
                           torch.uint8)
    if moves.shape[0] < 1 or moves.data_ptr() % 16:
        raise ValueError("moves must hold a block and start at 16 bytes")


def seqmap_walk(final, moves, seqlen: int):
    """The Viterbi path [T] int32 of a posterior map from its final scores
    [seqlen+2] and moves [T, move_stride(seqlen)] uint8: on a CUDA tensor
    the walk kernel of csrc/seqmap.cu, which leaves the moves on the card
    and walks windows of them (`walk_window`) in shared memory, else
    `seqmap_walk_plain`."""
    if not ops.on_cuda(final, moves):
        return seqmap_walk_plain(final, moves, seqlen)
    from scrappie_torch.ops import _build

    check_walk_input(final, moves, seqlen)
    T, ld = moves.shape
    path = torch.empty(T, dtype=torch.int32, device=final.device)
    with torch.cuda.device(final.device):
        err = _build.library().scrappie_seqmap_walk(
            final.data_ptr(), moves.data_ptr(), path.data_ptr(), T, seqlen, ld,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "seqmap_walk")
    ops.LAUNCHES["seqmap_walk"] += 1
    return path


def _check_banded(lp, seqstates, bands, init_win) -> None:
    _check(lp, seqstates)
    T = lp.shape[0]
    if bands.shape != (2, T) or init_win.dim() != 1 or init_win.shape[0] < 1:
        raise ValueError(f"bands must be [2, {T}] and init_win [width >= 1], "
                         f"got {tuple(bands.shape)} and {tuple(init_win.shape)}")


def check_banded_input(lp, seqstates, bands, init_win) -> None:
    """Raise unless the inputs are what the banded kernel takes: contiguous
    float32 lp [T >= 1, nst] and init_win [width], int32 seqstates
    [seqlen] and bands [2, T], and the ring within shared memory."""
    check_seqmap_input(lp, seqstates)
    _check_banded(lp, seqstates, bands, init_win)
    ops.check_kernel_input("bands", bands, tuple(bands.shape), torch.int32)
    ops.check_kernel_input("init_win", init_win, tuple(init_win.shape))


def map_banded_plain(lp, seqstates, bands, init_win, stay_pen=0.0,
                     skip_pen=0.0, local_pen=4.0, viterbi: bool = True):
    """Plain twin of the banded kernel: the windowed DP over blocks 1..T-1
    (the lax.scan of scrappie_tpu/decode/mapping.py:_map_banded, as a
    loop). lp [T, nst], seqstates [seqlen], bands [2, T] (low, high: each
    block's inclusive/exclusive positions), init_win [width] (block 0's
    window) -> [width + 1]: the last block's window, then END's score. The
    band's shifts, masks and exit offsets are taken on the host, so every
    shift is a slice."""
    _check_banded(lp, seqstates, bands, init_win)
    T, nst = lp.shape
    width = init_win.shape[0]
    seqlen = seqstates.shape[0]
    dev = lp.device
    low, high = bands.cpu().numpy().astype(np.int64)
    seq = seqstates.cpu().numpy().astype(np.int64)
    offs = low[:, None] + np.arange(width)[None, :]
    valid = torch.as_tensor(offs < high[:, None], device=dev)
    emit_win = lp.gather(1, torch.as_tensor(seq[np.minimum(offs, seqlen - 1)],
                                            device=dev))
    seq0_emit = lp[:, int(seq[0])]
    # the offset of seqlen-1 in the *previous* block's window (exit uses prev)
    in_band = (low <= seqlen - 1) & (seqlen - 1 < high)
    exit_off = np.clip(seqlen - 1 - low, 0, width - 1)

    stay, skip, local = _pens(stay_pen, skip_pen, local_pen, dev)
    neg = torch.tensor(-BIG, dtype=torch.float32, device=dev)
    negw = neg.expand(width)
    comb = torch.maximum if viterbi else ops.logaddexp

    def shift(padded, d, by):
        """The previous window re-indexed: new[w] is old index w + d - by,
        the start clamped as lax.dynamic_slice clamps it."""
        start = min(max(width + d - by, 0), 2 * width)
        return padded[start:start + width]

    # Carries after block 0 (ref :1745-1768): START stayed once; END is
    # reached only by the direct start->end transition, which the
    # reference allows in the first block alone.
    prev, start, end = init_win, comb(-local, lp[0, -1]), -local
    for t in range(1, T):
        emit, stay_lp, d = emit_win[t], lp[t, -1], int(low[t] - low[t - 1])
        padded = torch.cat([negw, prev, negw])
        curr = comb(comb(shift(padded, d, 0) - stay + stay_lp,
                         shift(padded, d, 1) + emit),
                    shift(padded, d, 2) - skip + emit)
        if low[t] == 0:
            curr[0] = comb(curr[0], start + seq0_emit[t])
        curr = torch.where(valid[t], curr, neg)
        local_stay = comb(-local, stay_lp)
        exit_score = (prev[int(exit_off[t - 1])] if in_band[t - 1]
                      else neg) - local
        prev, start, end = curr, start + local_stay, comb(end + local_stay,
                                                          exit_score)
    return torch.cat([prev, end[None]])


def map_banded_tm(lp, seqstates, bands, init_win, stay_pen=0.0, skip_pen=0.0,
                  local_pen=4.0, viterbi: bool = True,
                  global_state: bool | None = None):
    """The banded DP of one read over blocks 1..T-1 (see
    `map_banded_plain`) -> [width + 1]: on a CUDA tensor the banded kernel
    of csrc/seqmap.cu in the mode of `banded_layout` (the warp mode: the
    gather, then the DP, two launches counted as one call), which takes
    the bands on the card and copies nothing to the host during the DP,
    else the twin. The bands must be sane (decode/mapping.are_bounds_sane).
    global_state forces the kernel's window into global (True) or shared
    (False) memory; by default it is shared while it fits."""
    if not ops.on_cuda(lp, seqstates, bands, init_win):
        return map_banded_plain(lp, seqstates, bands, init_win, stay_pen,
                                skip_pen, local_pen, viterbi)
    from scrappie_torch.ops import _build

    check_banded_input(lp, seqstates, bands, init_win)
    T, nst = lp.shape
    seqlen = seqstates.shape[0]
    width = init_win.shape[0]
    _check_states(seqstates, nst)
    layout = banded_layout(nst, width, global_state)
    dev = lp.device
    out = torch.empty(width + 1, dtype=torch.float32, device=dev)
    scratch = (None if layout.shared else
               torch.empty(2 * width, dtype=torch.float32, device=dev))
    plane = (torch.empty((T, plane_stride(width)), dtype=torch.float32,
                         device=dev) if layout.per_lane else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _build.library().scrappie_seqmap_banded(
            lp.data_ptr(), seqstates.data_ptr(), bands.data_ptr(),
            init_win.data_ptr(), ptr(scratch), ptr(plane), out.data_ptr(), T,
            nst, seqlen, width, ops.f32(stay_pen), ops.f32(skip_pen),
            ops.f32(local_pen), int(viterbi), layout.threads,
            int(layout.shared), layout.per_lane,
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "seqmap_banded")
    ops.LAUNCHES["seqmap_banded"] += 1
    return out
