"""Comparing two basecalls of the same read.

The port holds its sequences to the JAX package's, and its CUDA runs to
its CPU runs, by one rule: identical, or, where fp32 sums taken in another
order flip a near-tied decode, at most MAX_EDIT_FRACTION edits per base
of the longer call. Quality strings of the same call are held by
quals_agree.
"""

from __future__ import annotations

MAX_EDIT_FRACTION = 0.005


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (Myers' bit-parallel algorithm, Hyyrö's
    formulation), O(len(a) * len(b) / word) with Python integers as
    bit vectors."""
    if len(a) < len(b):
        a, b = b, a
    m = len(b)
    if m == 0:
        return len(a)
    peq: dict[str, int] = {}
    for i, c in enumerate(b):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in a:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = (ph << 1) | 1
        mh <<= 1
        pv = (mh | ~(xv | ph)) & mask
        mv = ph & xv & mask
    return score


def within_flip_rule(a: str | None, b: str | None,
                     max_fraction: float = MAX_EDIT_FRACTION) -> bool:
    """True if the calls are identical or differ by at most max_fraction
    edits per base of the longer one."""
    if a == b:
        return True
    if not a or not b:
        return False
    return edit_distance(a, b) <= max_fraction * max(len(a), len(b))


#: Two quality strings of one call agree if at most this share of their
#: codes differ (and at least QUAL_MIN_DIFFS may), none by more than
#: QUAL_MAX_STEP: fp32 sums taken in another order move a probability
#: across a Phred rounding edge now and then.
QUAL_MAX_DIFF_FRACTION = 0.01
QUAL_MIN_DIFFS = 2
QUAL_MAX_STEP = 1


def qual_diffs(a: str, b: str) -> tuple[int, int]:
    """(codes that differ, largest difference) of two equally long Phred
    strings."""
    if len(a) != len(b):
        raise ValueError(f"quality strings of {len(a)} and {len(b)} codes")
    diffs = [abs(ord(x) - ord(y)) for x, y in zip(a, b) if x != y]
    return len(diffs), max(diffs, default=0)


def quals_agree(a: str | None, b: str | None) -> bool:
    """True if both are None, or they have the same number of codes and
    differ by the QUAL_* tolerance at most."""
    if a is None or b is None:
        return a is b
    if len(a) != len(b):
        return False
    n, step = qual_diffs(a, b)
    return (step <= QUAL_MAX_STEP
            and n <= max(QUAL_MIN_DIFFS, QUAL_MAX_DIFF_FRACTION * len(a)))
