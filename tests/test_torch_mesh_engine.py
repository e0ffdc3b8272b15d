"""BasecallEngine(mesh=) on the CPU: a (2, 1) mesh (["cpu"] * 2, data 2)
and a (2, 2) mesh (["cpu"] * 4, data 2 x state 2) against the port's
one-device engine and against scrappie_tpu's BasecallEngine on its
default virtual mesh (8 CPU devices, tests/conftest.py), for every kind
and mode of scrappie_tpu's dryrun_multichip: rgrgr_r94 stitch and fast,
raw_r94 fast, rnnrf_r94 fast, nanonet_events stitch and fast, and the
rgrgr 3:1:1 ensemble stitch and fast.

Each device batch of 4 chunks is split into two slices of 2, one on each
data device's replica; on the (2, 2) mesh the posterior paths also split
the output layer's product over 'state' (a sum of two partial products).
A slice is a smaller batch and a split product sums in another order, so
the gate is equal sequences (and positions, block counts, trims) with
scores within SCORE_RTOL = 1e-5 relative, not bits, against the
one-device port and against scrappie_tpu. rnnrf_r94's scores are held
within CRF_ATOL_A_BLOCK = 2e-5 a block instead, the tolerance at which
the port's one-device engine matches scrappie_tpu (tests/test_torch_rnnrf.py):
a CRF path's score sums every block's energy less logZ / T in float32, and
the batch size alone moves it by more than 1e-5 relative on the CPU (a
read decoded in a batch of 1 rather than 2 on the one-device engine:
1.5e-5, test_rnnrf_scores_move_with_the_batch_alone), which a mesh's
one-row slice is."""

import numpy as np
import pytest
import torch

from scrappie_torch.parallel import runner as trunner
from scrappie_torch.parallel.runner import BasecallEngine as TEngine
from scrappie_torch.parallel.sharding import make_mesh
from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
from scrappie_tpu.types import RawSignal

torch.set_num_threads(1)
SCORE_RTOL = 1e-5
CRF_ATOL_A_BLOCK = 2e-5
MEMBERS = ("rgrgr_r941", "rgrgr_r10")
# dryrun_multichip's kinds and modes (scrappie_tpu's __graft_entry__)
PATHS = [("rgrgr_r94", "stitch", ()), ("rgrgr_r94", "fast", ()),
         ("raw_r94", "fast", ()), ("rnnrf_r94", "fast", ()),
         ("nanonet_events", "stitch", ()), ("nanonet_events", "fast", ()),
         ("rgrgr_r94", "stitch", MEMBERS), ("rgrgr_r94", "fast", MEMBERS)]


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


SIGNALS = [RawSignal(synthetic_signal(n, 30 + i), uuid=f"r{i}")
           for i, n in enumerate((3400, 1500))]


def meshes():
    return {"2x1": make_mesh(devices=["cpu"] * 2),
            "2x2": make_mesh(2, 2, devices=["cpu"] * 4)}


def _kw(model, mode, ensemble):
    events = model == "nanonet_events"
    return dict(chunk_len=256 if events else 1000,
                overlap=64 if events else 200, mode=mode, ensemble=ensemble,
                batch_size=4)


def _same_calls(got, want, crf: bool = False):
    for g, w in zip(got, want, strict=True):
        assert g.sequence and g.sequence == w.sequence
        assert (g.uuid, g.nblock, g.trim_start, g.trim_end, g.nsample) == \
            (w.uuid, w.nblock, w.trim_start, w.trim_end, w.nsample)
        np.testing.assert_array_equal(g.pos, w.pos)
        if crf:
            assert abs(g.score - w.score) <= CRF_ATOL_A_BLOCK * w.nblock
        else:
            assert g.score == pytest.approx(w.score, rel=SCORE_RTOL)


@pytest.mark.parametrize("model,mode,ensemble", PATHS,
                         ids=[f"{m}-{mode}{'-ens' if e else ''}"
                              for m, mode, e in PATHS])
def test_engine_on_a_mesh_matches_one_device_and_jax(model, mode, ensemble):
    kw = _kw(model, mode, ensemble)
    want = JEngine(model, **kw).basecall_signals(SIGNALS)
    one = TEngine(model, device="cpu", **kw).basecall_signals(SIGNALS)
    crf = model == "rnnrf_r94"
    _same_calls(one, want, crf)
    for name, mesh in meshes().items():
        eng = TEngine(model, mesh=mesh, **kw)
        assert eng.batch_size == 4 and len(eng.replicas) == 2, name
        got = eng.basecall_signals(SIGNALS)
        _same_calls(got, one, crf)
        _same_calls(got, want, crf)


def test_rnnrf_scores_move_with_the_batch_alone():
    """Why rnnrf_r94 takes the CRF's tolerance: on one device, the same
    reads decoded in batches of 1 and of 2 give equal calls whose scores
    differ by more than SCORE_RTOL but within CRF_ATOL_A_BLOCK."""
    kw = dict(chunk_len=1000, overlap=200, mode="fast")
    b1, b2 = (TEngine("rnnrf_r94", device="cpu", batch_size=b, **kw
                      ).basecall_signals(SIGNALS) for b in (1, 2))
    _same_calls(b1, b2, crf=True)
    assert any(abs(x.score - y.score) > SCORE_RTOL * abs(y.score)
               for x, y in zip(b1, b2))


def test_state_axis_splits_the_posterior_paths_output_layer():
    """On a (2, 2) mesh each replica keeps its output layer's weight whole
    for the fused paths and split over 'state' for the posterior paths."""
    eng = TEngine("rgrgr_r94", mesh=meshes()["2x2"],
                  ensemble=MEMBERS, batch_size=3)
    assert eng.batch_size == 4
    for nets in eng.replicas:
        assert len(nets) == 3
        for net in nets:
            w = net.state_shards["FF_W"]
            assert w.bounds == ((0, 48), (48, 96))
            assert torch.equal(torch.cat(w.shards), net.params["FF_W"])
            assert net.posterior_params["FF_W"] is w


def test_engine_default_and_pinned_device():
    """device= pins one device; with neither device nor mesh the engine
    spans every visible card (and raises without one)."""
    eng = TEngine("rgrgr_r94", device="cpu", batch_size=3)
    assert eng.mesh.shape == {"data": 1, "state": 1} and eng.batch_size == 3
    with pytest.raises(ValueError, match="not both"):
        TEngine("rgrgr_r94", device="cpu", mesh=meshes()["2x1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TEngine("rgrgr_r94")


def test_stitch_gathers_each_group_once_a_slice(monkeypatch):
    """Each read group's chunk posteriors are gathered onto one data device
    in one call, each data device's slice of a batch copied once (not a
    copy a chunk); the calls equal the one-device engine's."""
    gathered = []
    real = trunner.gather_rows

    def spy(parts, device):
        gathered.append((len(parts), sum(len(p) for p in parts)))
        return real(parts, device)

    monkeypatch.setattr(trunner, "gather_rows", spy)
    kw = dict(chunk_len=600, overlap=100, batch_size=4)
    signals = SIGNALS + [RawSignal(synthetic_signal(1200, 40), uuid="r2")]
    eng = TEngine("rgrgr_r94", mesh=meshes()["2x1"], **kw)
    got = eng.basecall_signals(signals)
    assert len(gathered) >= 2  # several groups, each gathered once
    for parts, rows in gathered:
        # full batches of 4 rows split 2 + 2; the last batch's r rows
        # into one slice (r = 1) or two
        assert parts == 2 * (rows // 4) + min(rows % 4, 2)
    one = TEngine("rgrgr_r94", device="cpu", **kw).basecall_signals(signals)
    _same_calls(got, one)
