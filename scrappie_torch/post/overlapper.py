"""Kmer-path to basecall assembly (host-side).

Behavioural spec: ref src/decode.c:367-509.  A Viterbi path of kmer
states (stay = -1) is stitched into a base sequence: the first kmer is
emitted whole, and each subsequent kmer contributes its last `o` bases,
where `o` is the smallest shift making the old kmer's suffix equal the
new kmer's prefix.

This implementation is vectorised numpy (the reference walks the path
twice with scalar loops). A copy of scrappie_tpu/post/overlapper.py.
"""

from __future__ import annotations

import numpy as np

NBASE = 4
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def kmer_len_from_nkmer(nkmer: int) -> int:
    """1024 -> 5 (ref position_highest_bit, src/decode.c:384-388)."""
    return (int(nkmer).bit_length()) // 2


def overlap_lengths(kmers: np.ndarray, klen: int) -> np.ndarray:
    """Vectorised `overlap` (ref src/decode.c:367-382).

    For each consecutive pair, the smallest o >= 1 with
    prev mod 4^(k-o) == next >> 2o.
    """
    prev = kmers[:-1].astype(np.int64)
    nxt = kmers[1:].astype(np.int64)
    out = np.full(len(prev), klen, dtype=np.int64)
    for o in range(klen - 1, 0, -1):
        match = (prev % (NBASE ** (klen - o))) == (nxt >> (2 * o))
        out[match] = o
    return out


def _emit_bases(kmers: np.ndarray, olaps: np.ndarray, klen: int) -> np.ndarray:
    """Emit the first kmer whole then the last o bases of each following kmer."""
    ks = kmers
    os_ = np.concatenate([[klen], olaps])
    total = int(os_.sum())
    idx = np.repeat(np.arange(len(ks)), os_)
    starts = np.cumsum(os_) - os_
    within = np.arange(total) - starts[idx]
    shift = 2 * (os_[idx] - 1 - within)
    digits = (ks[idx].astype(np.int64) >> shift) & 3
    return BASES[digits]


def overlapper(path: np.ndarray, nkmer: int, pos: np.ndarray | None = None) -> str | None:
    """Stitch a kmer path into a basecall (ref overlapper, src/decode.c:449-509).

    path: int array with -1 = stay.  pos (optional out, len(path)) gets
    the cumulative basecall position per block.
    """
    path = np.asarray(path)
    klen = kmer_len_from_nkmer(nkmer)
    nonstay = path >= 0
    if not nonstay.any():
        return None
    kmers = path[nonstay]
    olaps = overlap_lengths(kmers, klen)
    seq = _emit_bases(kmers, olaps, klen).tobytes().decode()

    if pos is not None:
        # pos[block] = basecall coordinate after processing block
        # (stays copy the previous value; ref src/decode.c:482-498).
        incr = np.zeros(len(path), dtype=np.int64)
        nz = np.flatnonzero(nonstay)
        incr[nz[1:]] = olaps
        np.cumsum(incr, out=pos[: len(path)])
    return seq


def ctc_remove_stays_and_repeats(path: np.ndarray, pos: np.ndarray | None = None) -> str:
    """Decoder for single-base models (ref src/decode.c:414-447)."""
    path = np.asarray(path)
    # A repeated base after intervening stays is NOT re-emitted (prev
    # tracks the last emitted state, not the previous block).
    emit = np.zeros(len(path), dtype=bool)
    prev = -2
    loc = -1
    locs = np.full(len(path), -1, dtype=np.int64)
    for i, s in enumerate(path):
        if s >= 0 and s != prev:
            emit[i] = True
            prev = s
            loc += 1
        locs[i] = loc
    if pos is not None:
        pos[: len(path)] = locs
    return BASES[path[emit] & 3].tobytes().decode()
