"""Model specifications: what the port needs to know of each model.

Graph shapes per ref src/networks.c (see SURVEY.md Appendix A):
  raw_r94    conv+tanh -> (biGRU + FF-tanh) x2 -> softmax_temp
  rgrgr_*    conv(+elu/tanh) -> GRU B1,F2,B3,F4,B5 (FF-linear between)
             -> softmax_temp; 1025 states (4^5 kmers + stay)
  rnnrf_r94  conv+elu -> 5x residual(FF-linear + GRU, alternating dir)
             -> globalnorm CRF (25 transitions over -ACGT)
  events     window(3) over 4 event features -> 2x (biLSTM + FF2-tanh)
             -> softmax_temp
  squiggle_* embedding(4->3) -> conv+tanh -> 4x residual(conv+tanh)
             -> conv(3 outputs: current, log sd, -log dwell)

Strides and state counts follow the documented invariants (rgrgr: stride
5, 1025 states; ref python/test/test_scrappy.py:47-48). Counterpart of
scrappie_tpu/models/specs.py, with only the fields the port reads; the
weights themselves come from models/registry.py. The squiggle models carry
their names only: their widths, windows and strides are in their npz files.
"""

from __future__ import annotations

import dataclasses

NSTATE_TRANSDUCER = 4**5 + 1  # 1024 5-mers + stay
NSTATE_CRF = 5  # -ACGT
GRU_DIRS = ("b", "f", "b", "f", "b")  # rgrgr/rnnrf layer directions B1,F2,B3,F4,B5


@dataclasses.dataclass(frozen=True)
class RawModelSpec:
    name: str
    kind: str  # 'rgrgr' | 'raw' | 'rnnrf'
    stride: int
    conv_activation: str  # 'elu' | 'tanh'
    nstate: int


@dataclasses.dataclass(frozen=True)
class EventsModelSpec:
    name: str = "nanonet_events"
    kind: str = "events"
    winlen: int = 3
    nstate: int = NSTATE_TRANSDUCER
    stride: int = 1  # one block per event (chunk coordinates are events)


@dataclasses.dataclass(frozen=True)
class SquiggleModelSpec:
    name: str
    kind: str = "squiggle"


RAW_MODELS: dict[str, RawModelSpec] = {
    "raw_r94": RawModelSpec("raw_r94", "raw", 4, "tanh", NSTATE_TRANSDUCER),
    "rgrgr_r94": RawModelSpec("rgrgr_r94", "rgrgr", 5, "elu", NSTATE_TRANSDUCER),
    "rgrgr_r941": RawModelSpec("rgrgr_r941", "rgrgr", 5, "elu", NSTATE_TRANSDUCER),
    "rgrgr_r10": RawModelSpec("rgrgr_r10", "rgrgr", 5, "tanh", NSTATE_TRANSDUCER),
    "rnnrf_r94": RawModelSpec("rnnrf_r94", "rnnrf", 2, "elu", NSTATE_CRF**2),
}

SQUIGGLE_MODELS: dict[str, SquiggleModelSpec] = {
    name: SquiggleModelSpec(name)
    for name in ("squiggle_r94", "squiggle_r94_rna", "squiggle_r10")}

EVENTS_MODEL = EventsModelSpec()
