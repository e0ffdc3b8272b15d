"""Homopolymer run-length corrections (host-side).

Two independent mechanisms in the reference:

1. Posterior-mean correction for the raw pipeline
   (ref src/homopolymer.c): find ambiguous homopolymer run segments in
   the Viterbi path, recompute the run length as the rounded sum of the
   per-block normalised repeat-state posterior, rewrite the path.

2. Dwell-based correction for the events pipeline
   (ref src/decode.c:511-702): scale accumulated event dwell within a
   homopolymer by the calibrated mean step dwell.

A copy of scrappie_tpu/post/homopolymer.py: `find_runs` and
`dwell_corrected_overlapper` run in the port's C++ library (native/), on
every path and with no fallback; `find_runs_python` and
`dwell_corrected_overlapper_python` are their twins, equal bit for bit
(tests/test_torch_native.py).
"""

from __future__ import annotations

import enum
import math

import numpy as np

from scrappie_torch.native import bindings
from scrappie_torch.post.overlapper import kmer_len_from_nkmer, overlap_lengths

NBASE = 4
STAY = -1


class HomopolymerMode(enum.Enum):
    NOCHANGE = "nochange"
    MEAN = "mean"

    @classmethod
    def parse(cls, s: str) -> "HomopolymerMode":
        try:
            return cls(s)
        except ValueError:
            raise ValueError(f"Invalid homopolymer calculation {s!r}") from None


def repeatblock(base: int, nrep: int) -> int:
    """Kmer index of `base` repeated nrep times (ref scrappie_seq_helpers.c:115-121)."""
    y = 0
    for _ in range(nrep):
        y = y * NBASE + base
    return y


def find_runs(path: np.ndarray, klen: int) -> list[tuple[int, int, int]]:
    """Find ambiguous homopolymer run segments (ref findRuns,
    src/homopolymer.c:67-157), in the port's C++ library: (start, length,
    base) per run, as find_runs_python."""
    return bindings.find_runs(path, klen)


def find_runs_python(path: np.ndarray, klen: int) -> list[tuple[int, int, int]]:
    """find_runs's twin in Python.

    Returns (start, length, base) per run.  A run starts either at the
    first (YYYYY|stay) after an XYYYY block (X != Y), or at the first
    YYYYY following a ZXYYY block (skip entry) possibly after stays.
    """
    path = np.asarray(path)
    n = len(path)
    fkm1 = NBASE ** (klen - 1)
    fkm2 = NBASE ** (klen - 2)
    runs: list[tuple[int, int, int]] = []
    for base in range(NBASE):
        repk = repeatblock(base, klen)
        repkm1 = repeatblock(base, klen - 1)
        repkm2 = repeatblock(base, klen - 2)
        for i in range(1, n - 2):
            p, q = int(path[i - 1]), int(path[i])
            if (p % fkm1 == repkm1 and p != repk and p != STAY
                    and (q == STAY or q == repk)):
                e = i + 1
                while e < n and (path[e] == STAY or path[e] == repk):
                    e += 1
                runs.append((i, e - i, base))
            if (p % fkm2 == repkm2 and p % fkm1 != repkm1 and p != STAY
                    and (q == STAY or q == repk)):
                j = i
                while j < n and path[j] == STAY:
                    j += 1
                if j < n - 1 and path[j] == repk:
                    e = j + 1
                    while e < n and (path[e] == STAY or path[e] == repk):
                        e += 1
                    runs.append((j, e - j, base))
    return runs


def homopolymer_path(logpost: np.ndarray, path: np.ndarray,
                     mode: HomopolymerMode = HomopolymerMode.MEAN) -> np.ndarray:
    """Replace Viterbi homopolymer run lengths with posterior-mean lengths.

    logpost [T, nstate] (log posteriors, stay last); path [T+1] is
    modified in place and returned (ref homopolymer_path,
    src/homopolymer.c:175-235).  Note the path is offset one block from
    the posterior (path[t+1] corresponds to logpost[t]).
    """
    if mode != HomopolymerMode.MEAN:
        return path
    logpost = np.asarray(logpost)
    nstate = logpost.shape[-1]
    staystate = nstate - 1
    klen = kmer_len_from_nkmer(nstate - 1)
    # The reference scans path positions 1..len(logpost)-3 via findRuns on
    # the first `nc` entries of the path.
    runs = find_runs(path[: logpost.shape[0]], klen)
    for start, length, base in runs:
        runstate = repeatblock(base, klen)
        blocks = np.arange(start, start + length)
        psu = np.exp(logpost[blocks - 1, staystate])
        pru = np.exp(logpost[blocks - 1, runstate])
        pr = pru / (pru + psu)
        newn = int(pr.sum() + 0.5)
        nviterbi = int((path[blocks] == runstate).sum())
        if newn != nviterbi:
            path[blocks] = STAY
            path[blocks[:newn]] = runstate
    return path


def is_kmer_homopolymer(kmer: int, klen: int) -> bool:
    b = kmer & 3
    return all(((kmer >> (2 * j)) & 3) == b for j in range(klen))


def calibrated_dwell(hdwell: float, base: int, scale: float, base_adj) -> int:
    """(hdwell - base_adj[base]) / scale rounded half away from zero, as
    C's llround (not Python's banker's rounding; exact, where floor(x +
    0.5) rounds 0.49999999999999994 up)."""
    x = float((hdwell - base_adj[base]) / scale)
    whole = math.floor(abs(x))
    if abs(x) - whole >= 0.5:
        whole += 1
    return whole if x >= 0 else -whole


def dwell_corrected_overlapper(path: np.ndarray, dwell: np.ndarray, nkmer: int,
                               scale: float, base_adj=(0.0, 0.0, 0.0, 0.0)) -> str | None:
    """Overlapper with homopolymer run lengths from accumulated dwell.

    (ref dwell_corrected_overlapper, src/decode.c:516-643).  Within a
    homopolymer (all-same-base kmer), blocks and stays accumulate event
    dwell; on leaving, the emitted run length is dwell/scale instead of
    the path length. Runs in the port's C++ library, as
    dwell_corrected_overlapper_python; dwell is read as float64.
    """
    return bindings.dwell_overlapper(path, dwell, kmer_len_from_nkmer(nkmer),
                                     scale, base_adj)


def dwell_corrected_overlapper_python(path: np.ndarray, dwell: np.ndarray,
                                      nkmer: int, scale: float,
                                      base_adj=(0.0, 0.0, 0.0, 0.0)) -> str | None:
    """dwell_corrected_overlapper's twin in Python: dwell summed in float64
    in path order, as the library sums it."""
    path = np.asarray(path)
    dwell = np.asarray(dwell, np.float64)
    klen = kmer_len_from_nkmer(nkmer)
    nonstay = np.flatnonzero(path >= 0)
    if len(nonstay) == 0:
        return None
    st = nonstay[0]

    out: list[str] = []
    # First kmer emitted whole
    first = int(path[st])
    out.append("".join("ACGT"[(first >> (2 * (klen - 1 - j))) & 3] for j in range(klen)))

    kprev = first
    inhomo = -1
    hdwell = 0.0
    for k in range(st + 1, len(path)):
        s = int(path[k])
        if s < 0:
            if inhomo >= 0:
                hdwell += dwell[k]
            continue
        if s == inhomo:
            hdwell += dwell[k]
            continue
        if inhomo >= 0:
            hlen = calibrated_dwell(hdwell, inhomo & 3, scale, base_adj)
            out.append("ACGT"[inhomo & 3] * max(hlen, 0))
            inhomo = -1
            hdwell = 0.0
        ol = int(overlap_lengths(np.array([kprev, s]), klen)[0])
        out.append("".join("ACGT"[(s >> (2 * (ol - 1 - j))) & 3] for j in range(ol)))
        kprev = s
        if is_kmer_homopolymer(kprev, klen):
            inhomo = kprev
            hdwell += dwell[k]
    if inhomo >= 0:
        hlen = calibrated_dwell(hdwell, inhomo & 3, scale, base_adj)
        out.append("ACGT"[inhomo & 3] * max(hlen, 0))
    return "".join(out)


def homopolymer_dwell_correction(event_lengths: np.ndarray, event_starts: np.ndarray,
                                 path: np.ndarray, pos: np.ndarray,
                                 states: np.ndarray, nstate: int,
                                 basecall_len: int) -> str | None:
    """Dwell correction for the events pipeline.

    (ref homopolymer_dwell_correction, src/decode.c:645-702).  The scale
    is the mean dwell of non-homopolymer step movements, with a prior of
    weight one observation given by total-duration / basecall length.
    """
    nev = len(event_lengths)
    dwell = event_lengths.astype(np.float64)

    # Step-dwell statistics, vectorised over runs of equal pos (the
    # per-event Python loop was 13% of the events engine's end-to-end
    # time, round-5 profile).  A "run" is a maximal stretch of events
    # sharing pos; the reference credits the PREVIOUS run's total
    # dwell as one step observation when the next run advances pos by
    # exactly 1 with a different state (both taken at run starts).
    pos_v = np.asarray(pos[:nev], np.int64)
    states_v = np.asarray(states[:nev], np.int64)
    first = np.empty(nev, bool)
    first[0] = True
    np.not_equal(pos_v[1:], pos_v[:-1], out=first[1:])
    run_id = np.cumsum(first) - 1
    run_dwell = np.bincount(run_id, weights=dwell[:nev])
    run_pos = pos_v[first]
    run_state = states_v[first]
    step = (run_pos[1:] == run_pos[:-1] + 1) & \
           (run_state[1:] != run_state[:-1])
    tot_step_dwell = float(run_dwell[:-1][step].sum())
    nstep = int(step.sum())
    if run_pos[0] == -1 and run_state[0] != -1:
        # the scalar loop's initial (ppos=-2, pstate=-1) state counts a
        # zero-dwell step when the first event sits at pos -1
        nstep += 1

    start_delta = float(event_starts[nev - 1] - event_starts[0])
    prior_scale = (float(event_lengths[nev - 1]) + start_delta) / float(basecall_len)
    homo_scale = (prior_scale + tot_step_dwell) / (1.0 + nstep)
    return dwell_corrected_overlapper(path, dwell, nstate - 1, homo_scale)
