"""Wall-clock accounting per pipeline stage.

Counterpart of scrappie_tpu/utils/tracing.py:Stage, whose spans are JAX
profiler annotations; here each stage is a `torch.profiler.record_function`
span, so it shows in a torch.profiler trace when one is being taken.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Stage:
    """>>> st = Stage()
    >>> with st("posterior"): ...
    >>> st.report()   # {"posterior": {"calls": 1, "seconds": ...}}

    Seconds are host time; a stage that ends in a device-to-host copy
    includes the device work it waited for."""

    def __init__(self):
        self._acc: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._acc.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> dict:
        return {k: {"calls": len(v), "seconds": round(sum(v), 6)}
                for k, v in self._acc.items()}
