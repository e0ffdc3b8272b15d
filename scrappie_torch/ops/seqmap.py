"""Posterior-to-sequence mapping: the DP over the blocks of a posterior.

Counterpart of scrappie_tpu/ops/seqmap.py (map_to_sequence_tm, the Pallas
kernel _seqmap_kernel) and of the lax.scan program
scrappie_tpu/decode/mapping.py:_map_dense, whose order of operations and
tie rules the plain twin copies step for step. States: the seqlen
reference positions, then the local START (seqlen) and END (seqlen + 1).
Per block, with stay_lp = lp[t, nst-1] and emit = lp[t, seqstates], a
position takes, in this order, stay (prev - stay_pen) + stay_lp, step
prev[pos-1] + emit, skip (prev[pos-2] - skip_pen) + emit and, at position
0, entry prev[START] + emit; START stays at local_stay and END stays, then
takes the exit prev[seqlen-1] - local_pen. Viterbi takes a candidate by
strict `>`; the forward variant combines them by jnp.logaddexp's formula.

The Pallas kernel clamps -inf log posteriors to -1e30, only because its
lane gather is a one-hot matmul (0 * inf = NaN). The scan does not clamp,
and neither does the port: both versions here are held to the scan.
Robustlog posteriors are finite, so the basecallers' posteriors never see
the difference.

On a CUDA tensor `map_to_sequence_tm` launches the kernel of
csrc/seqmap.cu (scores in shared memory up to SEQMAP_MAX_SHARED_SEQLEN
positions at nst = 1025, in global memory above); on a CPU tensor it runs
`map_to_sequence_plain`. Outputs: final [seqlen+2] f32 and, for Viterbi
with a path, a traceback [T, seqlen+2] int32 (else None). There is no lane
or time padding.
"""

from __future__ import annotations

import ctypes

import torch

from scrappie_torch import ops

BIG = 1.0e30
#: Blocks whose emissions the twin gathers at once.
EMIT_BLOCK = 256


def shared_bytes(nst: int, seqlen: int, shared_state: bool) -> int:
    """Dynamic shared memory of the kernel: two posterior rows, and in the
    shared-state variant the scores, double-buffered."""
    return 4 * (2 * nst + (2 * (seqlen + 2) if shared_state else 0))


def max_shared_seqlen(nst: int) -> int:
    """Largest seqlen whose scores the kernel keeps in shared memory."""
    return (ops.MAX_SMEM_BYTES // 4 - 2 * nst) // 2 - 2


#: max_shared_seqlen of the transducer posterior (1025 states).
SEQMAP_MAX_SHARED_SEQLEN = max_shared_seqlen(1025)


def _check(lp, seqstates) -> None:
    if lp.dim() != 2 or seqstates.dim() != 1 or seqstates.shape[0] < 1:
        raise ValueError(f"lp must be [T, nst] and seqstates [seqlen >= 1], "
                         f"got {tuple(lp.shape)} and {tuple(seqstates.shape)}")


def check_seqmap_input(lp, seqstates) -> None:
    """Raise unless the inputs are what the kernel takes: contiguous
    float32 lp [T, nst], int32 seqstates [seqlen], two rows of nst
    floats within shared memory."""
    _check(lp, seqstates)
    ops.check_kernel_input("lp", lp, tuple(lp.shape))
    ops.check_kernel_input("seqstates", seqstates, tuple(seqstates.shape),
                           torch.int32)
    if shared_bytes(lp.shape[1], 0, False) > ops.MAX_SMEM_BYTES:
        raise ValueError(f"nst={lp.shape[1]}: two posterior rows exceed "
                         "shared memory")


def map_to_sequence_plain(lp, seqstates, stay_pen=0.0, skip_pen=0.0,
                          local_pen=4.0, viterbi: bool = True,
                          want_path: bool = True):
    """Plain twin of the kernel (the scan of decode/mapping.py): lp
    [T, nst], seqstates [seqlen] -> (final [seqlen+2], tb [T, seqlen+2]
    int32 or None)."""
    _check(lp, seqstates)
    T, nst = lp.shape
    seqlen = seqstates.shape[0]
    START, END = seqlen, seqlen + 1
    dev = lp.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    stay, skip, local = f32(stay_pen), f32(skip_pen), f32(local_pen)
    neg2 = f32(-BIG).expand(2)
    pos_idx = torch.arange(seqlen, dtype=torch.int32, device=dev)
    tb_step, tb_skip = pos_idx - 1, pos_idx - 2
    tb_end, tb_exit = (torch.tensor(v, dtype=torch.int32, device=dev)
                       for v in (END, seqlen - 1))
    idx = seqstates.long()

    prev = torch.full((seqlen + 2,), -BIG, dtype=torch.float32, device=dev)
    prev[START] = 0.0
    tb = None
    if viterbi and want_path:
        tb = torch.empty((T, seqlen + 2), dtype=torch.int32, device=dev)
        tb[:, START] = START

    def contend(cur, tbv, cand, ctb):
        if not viterbi:
            return ops.logaddexp(cur, cand), None
        upd = cand > cur
        return torch.where(upd, cand, cur), torch.where(upd, ctb, tbv)

    for t0 in range(0, T, EMIT_BLOCK):
        blk = lp[t0:t0 + EMIT_BLOCK]
        emit_blk, stay_blk = blk.index_select(1, idx), blk[:, nst - 1]
        for i in range(blk.shape[0]):
            emit, stay_lp = emit_blk[i], stay_blk[i]
            shifted = torch.cat([neg2, prev[:seqlen]])
            cur, tbv = prev[:seqlen] - stay + stay_lp, pos_idx
            cur, tbv = contend(cur, tbv, shifted[1:-1] + emit, tb_step)
            cur, tbv = contend(cur, tbv, shifted[:-2] - skip + emit, tb_skip)
            entry = prev[START] + emit[0]
            if viterbi:
                upd0 = entry > cur[0]
                cur[0] = torch.where(upd0, entry, cur[0])
                tbv = tbv.clone()
                tbv[0] = torch.where(upd0, START, tbv[0])
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
                if tb is not None:
                    tb[t0 + i, :seqlen] = tbv
                    tb[t0 + i, END] = torch.where(upd, tb_exit, tb_end)
            else:
                end_new = ops.logaddexp(end_new, exit_c)
            prev = torch.cat([cur, start_new[None], end_new[None]])
    return prev, tb


def map_to_sequence_tm(lp, seqstates, stay_pen=0.0, skip_pen=0.0,
                       local_pen=4.0, viterbi: bool = True,
                       want_path: bool = True,
                       global_state: bool | None = None):
    """The posterior-to-sequence DP of one read: lp [T, nst] log
    posterior, seqstates [seqlen] int32 kmer state of each reference
    position (in [0, nst-1)) -> (final [seqlen+2], tb [T, seqlen+2] int32
    for Viterbi with want_path, else None). global_state forces the
    kernel's scores into global (True) or shared (False) memory; by default
    they are shared while they fit."""
    if not ops.on_cuda(lp, seqstates):
        return map_to_sequence_plain(lp, seqstates, stay_pen, skip_pen,
                                     local_pen, viterbi, want_path)
    from scrappie_torch.ops import _build

    check_seqmap_input(lp, seqstates)
    T, nst = lp.shape
    seqlen = seqstates.shape[0]
    if not bool(((seqstates >= 0) & (seqstates < nst)).all()):
        raise ValueError(f"seqstates outside [0, {nst})")
    fits = seqlen <= max_shared_seqlen(nst)
    shared = fits if global_state is None else not global_state
    if shared and not fits:
        raise ValueError(f"seqlen={seqlen} does not fit in shared memory "
                         f"(at most {max_shared_seqlen(nst)} at nst={nst})")
    dev = lp.device
    final = torch.empty(seqlen + 2, dtype=torch.float32, device=dev)
    tb = (torch.empty((T, seqlen + 2), dtype=torch.int32, device=dev)
          if viterbi and want_path else None)
    scratch = (None if shared else
               torch.empty(2 * (seqlen + 2), dtype=torch.float32, device=dev))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _build.library().scrappie_seqmap(
            lp.data_ptr(), seqstates.data_ptr(), ptr(scratch), final.data_ptr(),
            ptr(tb), T, nst, seqlen, ops.f32(stay_pen), ops.f32(skip_pen),
            ops.f32(local_pen), int(viterbi), int(shared),
            ctypes.c_void_p(ops.stream_handle()))
        _build.check(err, "seqmap")
    ops.LAUNCHES["seqmap"] += 1
    return final, tb
