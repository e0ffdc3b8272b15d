"""Overlap-and-stitch chunking of long reads.

The reference processes each read as one variable-length matrix. Here
reads are cut into fixed-length overlapping chunks, batched through the
network, and the per-block outputs stitched back by keeping each chunk's
interior (the RNN context converges well within half an overlap),
bonito-style. A copy of scrappie_tpu/parallel/chunk.py.

All sample coordinates are kept multiples of the model stride so chunk
blocks align exactly with whole-read blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """How one read of `nsample` samples maps onto fixed-size chunks."""

    nsample: int
    chunk_len: int
    overlap: int
    stride: int
    starts: np.ndarray  # [nchunk] sample offsets, each a multiple of stride

    @property
    def nchunk(self) -> int:
        return len(self.starts)

    @property
    def nblock_total(self) -> int:
        return -(-self.nsample // self.stride)

    @property
    def nblock_chunk(self) -> int:
        return self.chunk_len // self.stride


def plan_chunks(nsample: int, chunk_len: int, overlap: int, stride: int) -> ChunkPlan:
    assert chunk_len % stride == 0 and overlap % stride == 0
    assert overlap < chunk_len
    if nsample <= chunk_len:
        starts = np.array([0], dtype=np.int64)
    else:
        hop = chunk_len - overlap
        starts = list(range(0, nsample - chunk_len, hop))
        # Final chunk is right-aligned, CEIL-stride-aligned so its blocks
        # cover the read's final (possibly partial) block — floor
        # alignment would leave nblock_total-1 unproduced when nsample
        # is not a stride multiple (extract_chunks reflect-pads the few
        # samples that overhang the read).
        last = -((-(nsample - chunk_len)) // stride) * stride
        if not starts or starts[-1] < last:
            starts.append(last)
        starts = np.array(starts, dtype=np.int64)
    return ChunkPlan(nsample, chunk_len, overlap, stride, starts)


def extract_chunks(signal: np.ndarray, plan: ChunkPlan) -> np.ndarray:
    """[nchunk, chunk_len, ...] chunk matrix, reflect-padded at the tail.

    Reflecting the signal (rather than zero padding) keeps the
    backward-RNN context that flows from the pad into the valid region
    statistically plausible; pad blocks are dropped by the stitch.
    `signal` may be 1-D samples or an [n, C] feature matrix (the events
    pipeline chunks per-event feature rows; reflection is along axis 0).
    """
    out = np.zeros((plan.nchunk, plan.chunk_len) + signal.shape[1:],
                   dtype=np.float32)
    for i, s in enumerate(plan.starts):
        seg = signal[s : s + plan.chunk_len]
        out[i, : len(seg)] = seg
        npad = plan.chunk_len - len(seg)
        if npad and len(seg) > 0:
            refl = seg[::-1]
            reps = -(-npad // len(refl))
            out[i, len(seg) :] = np.tile(refl, (reps,) + (1,) * (signal.ndim - 1))[:npad]
    return out


def stitch_blocks(chunk_blocks: np.ndarray, plan: ChunkPlan) -> np.ndarray:
    """Stitch per-chunk block outputs [nchunk, nblock_chunk, C] into
    [nblock_total, C], keeping each chunk's interior.

    Chunk i keeps global blocks [lo_i, hi_i): boundaries at the midpoint
    of each inter-chunk overlap, so every global block is produced by the
    chunk whose receptive field is most centred on it.
    """
    total = plan.nblock_total
    out = np.zeros((total,) + chunk_blocks.shape[2:], dtype=chunk_blocks.dtype)
    starts_blk = plan.starts // plan.stride
    for i, (lo, hi) in enumerate(chunk_keep_ranges(plan)):
        if hi <= lo:
            continue
        out[lo:hi] = chunk_blocks[i, lo - starts_blk[i] : hi - starts_blk[i]]
    return out


def chunk_keep_ranges(plan: ChunkPlan):
    """Per-chunk kept global block ranges [(lo, hi)), midpoint boundaries —
    the same geometry stitch_blocks uses."""
    s = plan.stride
    total = plan.nblock_total
    starts_blk = plan.starts // s
    nblk = plan.nblock_chunk
    out = []
    for i in range(plan.nchunk):
        lo = 0 if i == 0 else (starts_blk[i] + (starts_blk[i - 1] + nblk - starts_blk[i]) // 2)
        hi = total if i == plan.nchunk - 1 else (
            starts_blk[i + 1] + (starts_blk[i] + nblk - starts_blk[i + 1]) // 2
        )
        lo = max(lo, starts_blk[i])
        hi = min(hi, starts_blk[i] + nblk, total)
        out.append((int(lo), int(hi)))
    return out


def stitch_paths(chunk_paths: np.ndarray, plan: ChunkPlan) -> np.ndarray:
    """Stitch per-chunk Viterbi paths [nchunk, nblock_chunk+1] into a
    whole-read path [nblock_total+1].

    Each chunk was decoded independently (fused chunk-level pipeline);
    its per-block emissions path[1:] are kept over the chunk's interior
    (midpoint boundaries, as stitch_blocks).  This is the bonito-style
    decode-then-stitch mode: junction blocks can differ from the
    whole-read posterior-stitch decode, interiors are identical.
    """
    total = plan.nblock_total
    starts_blk = plan.starts // plan.stride
    # Also stitches per-entry side streams (e.g. the fused quality
    # stream [nchunk, nblock_chunk+1, klen]) with the same geometry.
    # -1 cast as numpy casts it (255 in a uint8 stream), which NumPy 2
    # refuses to do with a Python integer as the fill value
    out = np.full((total + 1,) + chunk_paths.shape[2:],
                  np.asarray(-1).astype(chunk_paths.dtype))
    out[0] = chunk_paths[0, 0]
    for i, (lo, hi) in enumerate(chunk_keep_ranges(plan)):
        if hi <= lo:
            continue
        emit = chunk_paths[i, 1:]
        out[1 + lo : 1 + hi] = emit[lo - starts_blk[i] : hi - starts_blk[i]]
    return out


def neutral_pad_crf(trans: np.ndarray, target_blocks: int) -> np.ndarray:
    """Pad CRF transition blocks so extra blocks are decode-neutral.

    Pad blocks allow only moves INTO the blank state (cost 0): the path
    jumps to blank at the first pad block and stays, emitting nothing
    (crfpath_to_basecall emits only states < 4), and every real state's
    final score is carried into blank unchanged, so the decode over the
    real blocks is unaffected.
    """
    T, nsq = trans.shape
    if T >= target_blocks:
        return trans
    ns = int(round(np.sqrt(nsq)))
    blank = ns - 1
    pad = np.full((target_blocks - T, nsq), -1e30, dtype=trans.dtype)
    pad[:, blank * ns : (blank + 1) * ns] = 0.0  # to-blank from any state
    return np.concatenate([trans, pad], axis=0)


def neutral_pad_logpost(logpost: np.ndarray, target_blocks: int,
                        stay_pen: float = 0.0) -> np.ndarray:
    """Pad a transducer log-posterior so extra blocks are decode-neutral.

    Padding blocks have stay log-prob +stay_pen (so a stay move costs
    exactly 0) and -inf elsewhere; any Viterbi path holds its state for
    free through the padding and the decoded basecall is unchanged.
    """
    T, nstate = logpost.shape
    if T >= target_blocks:
        return logpost
    pad = np.full((target_blocks - T, nstate), -1e30, dtype=logpost.dtype)
    pad[:, -1] = stay_pen
    return np.concatenate([logpost, pad], axis=0)
