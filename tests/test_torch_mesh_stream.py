"""StreamingBatcher(mesh=) and EventsStreamingBatcher(mesh=) on the CPU:
the counterparts of tests/test_streaming.py::test_batcher_on_device_mesh.
Ready chunks of several channels are split over a (2, 1) mesh
(["cpu"] * 2) and a (2, 2) mesh (["cpu"] * 4; the batchers replicate the
weights and use the data devices, as the JAX batchers do), and every
channel's committed bases must equal its solo stream's, for rgrgr_r94 (the
fused route), raw_r94 (posterior, then the Viterbi twins), rnnrf_r94 (the
CRF route), the 3:1:1 ensemble (the fused ensemble route) and the events
pipeline."""

import numpy as np
import pytest
import torch

from scrappie_torch.parallel import streaming as tstream
from scrappie_torch.parallel import streaming_events as tse
from scrappie_torch.parallel.sharding import make_mesh

torch.set_num_threads(1)
CHUNK, OV = 1500, 300
RAW = [("rgrgr_r94", ()), ("raw_r94", ()), ("rnnrf_r94", ()),
       ("rgrgr_r94", ("rgrgr_r941", "rgrgr_r10"))]


def _sim_read(nbase: int, seed: int) -> np.ndarray:
    from scrappie_torch.train.simulate import SquiggleSimulator

    sig, _, _ = SquiggleSimulator(seed=seed, device="cpu").simulate_read(nbase)
    return np.asarray(sig, np.float32)


SIGS = [_sim_read(700, 23), _sim_read(400, 24)]


def meshes():
    return {"2x1": make_mesh(devices=["cpu"] * 2),
            "2x2": make_mesh(2, 2, devices=["cpu"] * 4)}


def _batched(bat, sigs) -> list[str]:
    """Two channels fed in turn, in halves, then flushed."""
    out = {}
    for i in range(len(sigs)):
        bat.add_stream(i)
        out[i] = ""
    for half in (0, 1):
        for i, sig in enumerate(sigs):
            n = len(sig) // 2
            out[i] += bat.feed(i, sig[:n] if half == 0 else sig[n:])
    return [out[i] + bat.flush(i) for i in range(len(sigs))]


@pytest.mark.parametrize("model,ensemble", RAW,
                         ids=["rgrgr_r94", "raw_r94", "rnnrf_r94", "ens311"])
def test_raw_batcher_on_a_mesh_equals_solo_streams(model, ensemble):
    solos = []
    for sig in SIGS:
        sb = tstream.StreamingBasecaller(model, CHUNK, OV, device="cpu",
                                         ensemble=ensemble)
        sb.feed(sig)
        sb.flush()
        solos.append(sb.sequence)
    for name, mesh in meshes().items():
        bat = tstream.StreamingBatcher(model, CHUNK, OV, batch_size=3,
                                       mesh=mesh, ensemble=ensemble)
        assert bat.batch_size % mesh.shape["data"] == 0 and bat.batch_size == 4
        assert bat.mesh is mesh
        got = _batched(bat, SIGS)
        assert all(got) and got == solos, name


def test_events_batcher_on_a_mesh_equals_solo_streams():
    solos = []
    for sig in SIGS:
        sb = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu")
        sb.feed(sig)
        sb.flush()
        solos.append(sb.sequence)
    for name, mesh in meshes().items():
        bat = tse.EventsStreamingBatcher(CHUNK, OV, batch_size=3, mesh=mesh)
        assert bat.batch_size == 4
        got = _batched(bat, SIGS)
        assert all(got) and got == solos, name


def test_batchers_pin_a_device_or_span_the_cards():
    assert tstream.StreamingBatcher("rgrgr_r94", CHUNK, OV, batch_size=3,
                                    device="cpu").batch_size == 3
    assert tse.EventsStreamingBatcher(CHUNK, OV, device="cpu").mesh.size == 1
    with pytest.raises(ValueError, match="not both"):
        tstream.StreamingBatcher("rgrgr_r94", device="cpu",
                                 mesh=meshes()["2x1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tse.EventsStreamingBatcher(CHUNK, OV)
