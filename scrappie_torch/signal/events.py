"""Event detection: two-window t-statistic peak detector.

Behavioural spec from ref src/event_detection.c. A copy of
scrappie_tpu/signal/events.py: `detect_events` runs the statistics and the
short/long peak state machine in the port's C++ library (native/), on
every path and with no fallback; the vectorised numpy statistics
(`compute_sum_sumsq`, `compute_tstat`), the Python state machine
(`_peak_detector_python`) and `detect_events_python` are its twins, equal
bit for bit (tests/test_torch_native.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from scrappie_torch.native import bindings
from scrappie_torch.types import EVENT_DTYPE, EventTable, RawSignal


@dataclasses.dataclass(frozen=True)
class EventDetectionParams:
    """Defaults from ref src/event_detection.h:15-21."""

    window_length1: int = 3
    window_length2: int = 6
    threshold1: float = 1.4
    threshold2: float = 9.0
    peak_height: float = 0.2


EVENT_DETECTION_DEFAULTS = EventDetectionParams()


def compute_sum_sumsq(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Length n+1 cumulative sum / sum-of-squares, element i excludes i.

    (ref src/event_detection.c:35-48; float64 accumulation)
    """
    data = np.asarray(data, dtype=np.float32)
    n = len(data)
    sums = np.zeros(n + 1, dtype=np.float64)
    sumsqs = np.zeros(n + 1, dtype=np.float64)
    np.cumsum(data, dtype=np.float64, out=sums[1:])
    np.cumsum(data.astype(np.float64) ** 2, out=sumsqs[1:])
    return sums, sumsqs


def compute_tstat(sums: np.ndarray, sumsqs: np.ndarray, w_length: int) -> np.ndarray:
    """Windowed two-sample t-statistic (ref src/event_detection.c:60-115).

    For position i, compares the w samples before i against the w samples
    after i; boundaries (first/last w positions) are zero.
    """
    d_length = len(sums) - 1
    tstat = np.zeros(d_length, dtype=np.float32)
    if d_length < 2 * w_length or w_length < 2:
        return tstat

    w = w_length
    idx = np.arange(w, d_length - w + 1)
    sum1 = sums[idx] - np.where(idx > w, sums[np.maximum(idx - w, 0)], 0.0)
    sumsq1 = sumsqs[idx] - np.where(idx > w, sumsqs[np.maximum(idx - w, 0)], 0.0)
    sum2 = (sums[idx + w] - sums[idx]).astype(np.float32)
    sumsq2 = (sumsqs[idx + w] - sumsqs[idx]).astype(np.float32)
    wf = np.float32(w)
    mean1 = (sum1 / wf).astype(np.float32)
    mean2 = sum2 / wf
    combined_var = sumsq1.astype(np.float32) / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2
    combined_var = np.maximum(combined_var, np.finfo(np.float32).tiny)
    delta_mean = mean2 - mean1
    tstat[idx] = np.abs(delta_mean) / np.sqrt(combined_var / wf)
    # Note: reference only guarantees i in [w, d_length - w]; idx covers exactly that.
    return tstat


def _peak_detector_python(
    tstat1: np.ndarray,
    tstat2: np.ndarray,
    params: EventDetectionParams,
) -> np.ndarray:
    """Pure-Python port of the short/long peak state machine.

    (ref src/event_detection.c:122-198).  Returns the peak-position array
    in the reference's convention: positions of detected peaks, in order,
    zero-padded to signal length.
    """
    nsample = len(tstat1)
    peaks = np.zeros(nsample, dtype=np.int64)
    peak_count = 0

    # Per-detector state: [signal, threshold, window, masked_to, peak_pos, peak_value, valid]
    class _Det:
        __slots__ = ("signal", "threshold", "window", "masked_to", "peak_pos", "peak_value", "valid")

        def __init__(self, signal, threshold, window):
            self.signal = signal
            self.threshold = threshold
            self.window = window
            self.masked_to = 0
            self.peak_pos = -1
            self.peak_value = np.finfo(np.float32).max
            self.valid = False

    short = _Det(tstat1, params.threshold1, params.window_length1)
    long_ = _Det(tstat2, params.threshold2, params.window_length2)

    for i in range(nsample):
        for det in (short, long_):
            if det.masked_to >= i:
                continue
            current = det.signal[i]
            if det.peak_pos == -1:
                if current < det.peak_value:
                    det.peak_value = current
                elif current - det.peak_value > params.peak_height:
                    det.peak_value = current
                    det.peak_pos = i
            else:
                if current > det.peak_value:
                    det.peak_value = current
                    det.peak_pos = i
                if det is short and det.peak_value > det.threshold:
                    long_.masked_to = det.peak_pos + det.window
                    long_.peak_pos = -1
                    long_.peak_value = np.finfo(np.float32).max
                    long_.valid = False
                if det.peak_value - current > params.peak_height and det.peak_value > det.threshold:
                    det.valid = True
                if det.valid and (i - det.peak_pos) > det.window // 2:
                    peaks[peak_count] = det.peak_pos
                    peak_count += 1
                    det.peak_pos = -1
                    det.peak_value = current
                    det.valid = False

    return peaks


def create_events(peaks: np.ndarray, sums: np.ndarray, sumsqs: np.ndarray, nsample: int) -> EventTable:
    """Convert peak boundaries into an event table (ref src/event_detection.c:234-266).

    Events span [0, peak0), [peak0, peak1), ..., [peak_{k-1}, nsample).
    """
    valid = peaks[(peaks > 0) & (peaks < nsample)]
    bounds = np.concatenate(([0], valid, [nsample])).astype(np.int64)
    starts = bounds[:-1]
    ends = bounds[1:]

    ev = np.zeros(len(starts), dtype=EVENT_DTYPE)
    lengths = (ends - starts).astype(np.float32)
    means = ((sums[ends] - sums[starts]) / lengths).astype(np.float32)
    deltasqr = (sumsqs[ends] - sumsqs[starts]).astype(np.float32)
    var = deltasqr / lengths - means * means
    ev["start"] = starts.astype(np.uint64)
    ev["length"] = lengths
    ev["mean"] = means
    ev["stdv"] = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
    ev["pos"] = -1
    ev["state"] = -1
    return EventTable(ev)


def detect_events(rt: RawSignal, params: EventDetectionParams = EVENT_DETECTION_DEFAULTS) -> EventTable:
    """Full event-detection pipeline (ref src/event_detection.c:268-320),
    in the port's C++ library."""
    data = rt.trimmed
    sums, sumsqs, tstat1, tstat2 = bindings.detect_tstat(
        data, params.window_length1, params.window_length2)
    peaks = bindings.peak_detector(tstat1, tstat2, params.threshold1,
                                   params.threshold2, params.window_length1,
                                   params.window_length2, params.peak_height)
    return create_events(peaks, sums, sumsqs, len(data))


def detect_events_python(rt: RawSignal,
                         params: EventDetectionParams = EVENT_DETECTION_DEFAULTS) -> EventTable:
    """detect_events's twin in numpy and Python."""
    data = rt.trimmed
    sums, sumsqs = compute_sum_sumsq(data)
    tstat1 = compute_tstat(sums, sumsqs, params.window_length1)
    tstat2 = compute_tstat(sums, sumsqs, params.window_length2)
    peaks = _peak_detector_python(tstat1, tstat2, params)
    return create_events(peaks, sums, sumsqs, len(data))
