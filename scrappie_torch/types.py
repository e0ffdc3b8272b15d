"""Core host-side data structures (ref: src/scrappie_structures.h).

A copy of scrappie_tpu/types.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RawSignal:
    """A raw current trace with an active [start, end) window.

    Mirrors the reference `raw_table` (src/scrappie_structures.h:24-30):
    trimming adjusts start/end without copying the data.
    """

    raw: np.ndarray  # float32 [n]
    start: int = 0
    end: int | None = None
    uuid: str | None = None

    def __post_init__(self):
        self.raw = np.ascontiguousarray(self.raw, dtype=np.float32)
        if self.end is None:
            self.end = len(self.raw)

    @property
    def n(self) -> int:
        return len(self.raw)

    @property
    def trimmed(self) -> np.ndarray:
        return self.raw[self.start : self.end]

    @property
    def empty(self) -> bool:
        return self.start >= self.end


# Structured dtype mirroring the reference `event_t`
# (src/scrappie_structures.h:8-15).  pos/state are filled post-decode.
EVENT_DTYPE = np.dtype(
    [
        ("start", np.uint64),
        ("length", np.float32),
        ("mean", np.float32),
        ("stdv", np.float32),
        ("pos", np.int32),
        ("state", np.int32),
    ]
)


@dataclasses.dataclass
class EventTable:
    """A table of detected events with an active [start, end) window."""

    event: np.ndarray  # EVENT_DTYPE [n]
    start: int = 0
    end: int | None = None

    def __post_init__(self):
        if self.end is None:
            self.end = len(self.event)

    @property
    def n(self) -> int:
        return len(self.event)

    @property
    def active(self) -> np.ndarray:
        return self.event[self.start : self.end]
