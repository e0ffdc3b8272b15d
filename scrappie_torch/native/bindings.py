"""ctypes wrappers of the port's host library (src/host_kernels.cpp).

Counterpart of scrappie_tpu/native/bindings.py, with its signatures and
return conventions, apart from the output capacities. The library is built
(native/build.py) and loaded at the first call, so importing this module
costs nothing; a library that cannot be built or loaded raises
RuntimeError, and nothing falls back to the Python twins.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np

from scrappie_torch.native import build as _build

#: The library's return value for an output that would pass its capacity.
OVERFLOW = -2

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

_SIGNATURES = {
    "stpu_peak_detector": (_f32p, _f32p, _i64, ctypes.c_float, ctypes.c_float,
                           _i64, _i64, ctypes.c_float, _i64p, _i64),
    "stpu_detect_tstat": (_f32p, _i64, _i64, _i64, _f64p, _f64p, _f32p, _f32p),
    "stpu_dwell_overlapper": (_i32p, _f64p, _i64, ctypes.c_int, ctypes.c_double,
                              _f64p, ctypes.c_char_p, _i64),
    "stpu_find_runs": (_i32p, _i64, ctypes.c_int, _i64p, _i64p, _i64p, _i64),
}

_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded library, built on the first call. Thread-safe."""
    with _LIBRARY_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    path = _build.build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load the host library {path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _i64
    return lib


def _check(count: int, what: str) -> int:
    if count == OVERFLOW:
        raise ValueError(f"{what}: the output would pass its buffer")
    return count


def detect_tstat(data, window1: int, window2: int):
    """(sums, sumsqs, tstat1, tstat2): the cumulative statistics [n+1] and
    both windowed t-statistics [n] in one pass, bit for bit those of
    signal/events.compute_sum_sumsq and compute_tstat."""
    lib = library()
    data = np.ascontiguousarray(data, np.float32)
    n = len(data)
    sums = np.empty(n + 1, np.float64)
    sumsqs = np.empty(n + 1, np.float64)
    tstat1 = np.empty(n, np.float32)
    tstat2 = np.empty(n, np.float32)
    lib.stpu_detect_tstat(data, n, window1, window2, sums, sumsqs, tstat1,
                          tstat2)
    return sums, sumsqs, tstat1, tstat2


def peak_detector(tstat1, tstat2, threshold1, threshold2, window1, window2,
                  peak_height) -> np.ndarray:
    """Peak positions in firing order, zero-padded to the signal's length
    (the reference's convention), as signal/events._peak_detector_python.
    Each detector fires at most once every two samples, so the two fit in
    the signal's length; the library refuses to write past it all the
    same."""
    lib = library()
    tstat1 = np.ascontiguousarray(tstat1, np.float32)
    tstat2 = np.ascontiguousarray(tstat2, np.float32)
    n = len(tstat1)
    if len(tstat2) != n:
        raise ValueError(f"t-statistics of lengths {n} and {len(tstat2)}")
    out = np.zeros(n, dtype=np.int64)
    _check(lib.stpu_peak_detector(tstat1, tstat2, n, threshold1, threshold2,
                                  window1, window2, peak_height, out, n),
           "peak_detector")
    return out


def dwell_capacity(n: int, klen: int, dwell: np.ndarray, scale: float,
                   base_adj: np.ndarray) -> int:
    """An upper bound on the dwell overlapper's basecall length: klen bases
    for the first entry and each step, and a homopolymer run's rounded
    (dwell - base_adj) / scale for each of at most n runs.

    scrappie_tpu's wrapper leaves out the runs' rounding (up to half a
    base each) and a negative base_adj, so a path of alternating
    homopolymers can write past its buffer there."""
    slack = max(0.0, -float(base_adj.min()))
    runs = (float(np.abs(dwell).sum()) + n * slack) / scale + 0.5 * n
    return klen * (n + 1) + math.ceil(runs) + 64


def _check_klen(klen: int, least: int) -> None:
    if not least <= klen <= 31:  # kmers are packed two bits a base in int64
        raise ValueError(f"kmers of {klen} bases: {least} to 31 are supported")


def dwell_overlapper(path, dwell, klen: int, scale: float,
                     base_adj=(0.0, 0.0, 0.0, 0.0)) -> str | None:
    """The basecall of a kmer path [n] (negative = stay) with homopolymer
    runs as long as their accumulated dwell [n] over scale; None for a path
    of stays only. As post/homopolymer.dwell_corrected_overlapper_python.

    dwell is read as float64. scrappie_tpu's wrapper passes float32, which
    gives the same calls whenever each dwell is a float32 value, as event
    lengths (whole numbers of samples) are. The buffer holds
    `dwell_capacity`'s bound; the library writes nothing past it and a
    longer basecall raises ValueError."""
    _check_klen(klen, 1)
    lib = library()
    path = np.ascontiguousarray(path, np.int32)
    dwell = np.ascontiguousarray(dwell, np.float64)
    base_adj = np.ascontiguousarray(base_adj, np.float64)
    n = len(path)
    if len(dwell) != n or base_adj.shape != (4,):
        raise ValueError(f"path [{n}] needs dwell [{n}] (got "
                         f"{len(dwell)}) and four base_adj")
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"scale must be positive and finite, not {scale}")
    if not (np.isfinite(dwell).all() and np.isfinite(base_adj).all()):
        raise ValueError("dwell and base_adj must be finite")
    capacity = dwell_capacity(n, klen, dwell, scale, base_adj)
    buf = ctypes.create_string_buffer(capacity)
    length = _check(lib.stpu_dwell_overlapper(path, dwell, n, klen, scale,
                                              base_adj, buf, capacity),
                    f"dwell_overlapper (capacity {capacity})")
    if length < 0:
        return None
    return buf.raw[:length].decode()


def find_runs(path, klen: int) -> list[tuple[int, int, int]]:
    """(start, length, base) of each ambiguous homopolymer run of a path,
    as post/homopolymer.find_runs_python. A path position starts at most
    one run for klen >= 3 (the kmer before it names the base), and at most
    one a base for klen = 2."""
    _check_klen(klen, 2)
    lib = library()
    path = np.ascontiguousarray(path, np.int32)
    n = len(path)
    capacity = n if klen >= 3 else 4 * n
    starts = np.zeros(capacity, dtype=np.int64)
    lengths = np.zeros(capacity, dtype=np.int64)
    bases = np.zeros(capacity, dtype=np.int64)
    count = _check(lib.stpu_find_runs(path, n, klen, starts, lengths, bases,
                                      capacity), "find_runs")
    return list(zip(starts[:count].tolist(), lengths[:count].tolist(),
                    bases[:count].tolist()))
