"""Raw-signal trimming / segmentation (ref: src/scrappie_common.c).

These run host-side in numpy: they are O(n) / O(n log n) on a single
variable-length read and gate what goes to the device. A copy of
scrappie_tpu/signal/trim.py.
"""

from __future__ import annotations

import numpy as np

from scrappie_torch.types import RawSignal
from scrappie_torch.utils.maths import quantilef


def trim_raw_by_mad(rt: RawSignal, chunk_size: int = 100, perc: float = 0.0) -> RawSignal:
    """Trim low-variance ends of the read by thresholding per-chunk MAD.

    Semantics follow ref src/scrappie_common.c:39-73: the signal is cut
    into non-overlapping chunks, a per-chunk MAD is computed, a quantile
    of the MADs is the threshold, and leading/trailing chunks whose MAD
    does not exceed the threshold are trimmed.  The end is truncated to a
    whole number of chunks first (Sloika compatibility).
    """
    assert chunk_size > 1
    assert 0.0 <= perc <= 1.0

    nsample = rt.end - rt.start
    nchunk = nsample // chunk_size
    # Truncate end to a whole number of chunks (matches reference, which
    # sets end = nchunk * chunk_size in absolute coordinates).
    end = nchunk * chunk_size
    start = rt.start

    if nchunk == 0:
        return RawSignal(rt.raw, start=start, end=end, uuid=rt.uuid)

    chunks = rt.raw[rt.start : rt.start + nchunk * chunk_size].reshape(nchunk, chunk_size)
    med = np.quantile(chunks, 0.5, axis=1).astype(np.float32)
    mads = (
        np.quantile(np.abs(chunks - med[:, None]), 0.5, axis=1).astype(np.float32)
        * np.float32(1.4826)
    )
    thresh = float(quantilef(mads, perc))

    for i in range(nchunk):
        if mads[i] > thresh:
            break
        start += chunk_size
    for i in range(nchunk, 0, -1):
        if mads[i - 1] > thresh:
            break
        end -= chunk_size

    return RawSignal(rt.raw, start=start, end=end, uuid=rt.uuid)


def trim_and_segment_raw(
    rt: RawSignal,
    trim_start: int = 200,
    trim_end: int = 10,
    varseg_chunk: int = 100,
    varseg_thresh: float = 0.0,
) -> RawSignal | None:
    """MAD-based segmentation plus fixed start/end trims.

    Semantics follow ref src/scrappie_common.c:5-20.  Returns None when
    the surviving window is empty (reference frees the read).
    """
    rt = trim_raw_by_mad(rt, varseg_chunk, varseg_thresh)

    start = rt.start + trim_start if (rt.n - rt.start) > trim_start else rt.n
    end = rt.end - trim_end if rt.end > trim_end else 0

    if start >= end:
        return None
    return RawSignal(rt.raw, start=start, end=end, uuid=rt.uuid)
