"""Wall-clock accounting per pipeline stage, and structured logging.

Counterpart of scrappie_tpu/utils/tracing.py:
  * `profile(dir)`, a torch.profiler trace (CPU activity, and CUDA
    activity where there is a card) of everything inside the block,
    written to dir as a Chrome trace (`.json`; chrome://tracing,
    Perfetto);
  * `annotate(name)`, a named span in that trace
    (`torch.profiler.record_function`);
  * `Stage`, host seconds per pipeline stage, each stage an `annotate`
    span;
  * `log`, a copy: levelled JSON lines on stderr, the level from
    SCRAPPIE_TORCH_LOG (debug|info|warn|error, default warn).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
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


@contextlib.contextmanager
def profile(trace_dir):
    """Trace everything inside the block with torch.profiler; on leaving
    it, write the trace into trace_dir (created if need be) as
    `trace.<pid>.<ns>.json` and log its path at level info."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield
    path = out / f"trace.{os.getpid()}.{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    log("info", "profiler trace written", path=str(path))


@contextlib.contextmanager
def annotate(name: str):
    """Named span in the profiler's trace (host, with the device work it
    launches beneath it)."""
    with torch.profiler.record_function(name):
        yield


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
            with annotate(name):
                yield
        finally:
            self._acc.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> dict:
        return {k: {"calls": len(v), "seconds": round(sum(v), 6)}
                for k, v in self._acc.items()}
