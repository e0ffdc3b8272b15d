"""Wall-clock accounting per pipeline stage, and structured logging.

Counterpart of scrappie_tpu/utils/tracing.py:
  * `Stage`, whose spans there are JAX profiler annotations; here each
    stage is a `torch.profiler.record_function` span, so it shows in a
    torch.profiler trace when one is being taken;
  * `log`, a copy: levelled JSON lines on stderr, the level from
    SCRAPPIE_TORCH_LOG (debug|info|warn|error, default warn).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def log(level: str, msg: str, **fields) -> None:
    """Structured log line (JSON) to stderr, filtered by level."""
    threshold = _LEVELS.get(os.environ.get("SCRAPPIE_TORCH_LOG", "warn").lower(), 30)
    if _LEVELS.get(level, 20) < threshold:
        return
    rec = {"ts": round(time.time(), 3), "level": level, "msg": msg}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr)


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
