"""scrappie_torch/parallel/streaming_events.py against scrappie_tpu's events
streams, on the CPU.

The counterparts of tests/test_streaming_events.py: increment invariance,
fixed, frozen and prefix statistics, short and empty streams, a stalled
opening chunk, the batcher against solo streams, and the neutral padding
rows of the log posterior. Every stream's bases and event count must equal
the JAX package's stream on the same signal; scores are held to 1e-5
relative.
"""

import numpy as np
import pytest
import torch

from scrappie_torch.parallel import streaming_events as tse
from scrappie_tpu.parallel import streaming_events as jse

torch.set_num_threads(2)

CHUNK, OV = 4000, 1000
SCORE_RTOL = 1e-5


def _sim_read(nbase=700, seed=41):
    from scrappie_tpu.train.simulate import SquiggleSimulator

    sig, bases, _ = SquiggleSimulator(seed=seed).simulate_read(nbase)
    truth = "".join("ACGT"[b] for b in bases)
    return np.asarray(sig, np.float32), truth


def _port(sig, step=None, **kw):
    sb = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu", **kw)
    step = step or len(sig)
    for off in range(0, len(sig), step):
        sb.feed(sig[off : off + step])
    sb.flush()
    return sb


def _same_as_jax(sb, sig, **kw):
    want = jse.EventsStreamingBasecaller(CHUNK, OV, **kw)
    want.feed(sig)
    want.flush()
    assert sb.sequence == want.sequence and want.sequence
    assert sb.nevent == want.nevent
    assert sb.score == pytest.approx(want.score, rel=SCORE_RTOL)


def test_events_stream_increment_invariance():
    sig, _ = _sim_read()
    sb1 = _port(sig)
    rng = np.random.default_rng(2)
    sb2 = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu")
    off = 0
    while off < len(sig):
        n = int(rng.integers(1, 1300))
        sb2.feed(sig[off : off + n])
        off += n
    sb2.flush()
    assert sb1.sequence == sb2.sequence and len(sb1.sequence) > 100
    assert np.isclose(sb1.score, sb2.score)
    assert sb1.nevent == sb2.nevent
    _same_as_jax(sb1, sig)


def test_events_stream_fixed_stats():
    """stats_mode='fixed': the caller's statistics; it checks them."""
    from scrappie_torch.signal.events import detect_events
    from scrappie_torch.signal.features import (feature_stats,
                                                nanonet_features_from_events)
    from scrappie_torch.types import RawSignal

    sig, _ = _sim_read(nbase=500, seed=43)
    stats = feature_stats(nanonet_features_from_events(
        detect_events(RawSignal(sig)), normalise=False))
    sb = _port(sig, stats_mode="fixed", feature_stats_override=stats)
    assert len(sb.sequence) > 100
    _same_as_jax(sb, sig, stats_mode="fixed", feature_stats_override=stats)
    with pytest.raises(ValueError):
        tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu",
                                      stats_mode="fixed")


def test_events_stream_short_read():
    sig, _ = _sim_read(nbase=80, seed=45)
    assert len(sig) < CHUNK
    sb = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu")
    assert sb.feed(sig) == ""
    seq = sb.flush()
    assert seq == sb.sequence and len(seq) > 20
    _same_as_jax(sb, sig)


def test_events_stream_empty_and_reuse():
    sb = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu")
    assert sb.flush() == ""
    with pytest.raises(RuntimeError):
        sb.feed(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="overlap"):
        tse.EventsStreamingBasecaller(CHUNK, CHUNK, device="cpu")


def test_events_batcher_matches_solo():
    """Channels through an EventsStreamingBatcher equal solo streams (and
    the JAX package's), exactly."""
    sigs = [_sim_read(nbase=n, seed=s)[0] for n, s in [(600, 51), (750, 52)]]
    solo = [_port(sig).sequence for sig in sigs]
    bat = tse.EventsStreamingBatcher(CHUNK, OV, batch_size=4, device="cpu")
    for i in range(len(sigs)):
        bat.add_stream(i)
    rng = np.random.default_rng(5)
    offs = [0] * len(sigs)
    got = [""] * len(sigs)
    while any(offs[i] < len(sigs[i]) for i in range(len(sigs))):
        i = int(rng.integers(0, len(sigs)))
        if offs[i] >= len(sigs[i]):
            continue
        n = int(rng.integers(300, 2000))
        got[i] += bat.feed(i, sigs[i][offs[i] : offs[i] + n])
        offs[i] += n
    for k, v in bat.poll().items():
        got[k] += v
    for i in range(len(sigs)):
        got[i] += bat.flush(i)
        bat.close_stream(i)
    assert got == solo and all(got)
    assert not bat._streams
    for sig, sb_seq in zip(sigs, got):
        want = jse.EventsStreamingBasecaller(CHUNK, OV)
        want.feed(sig)
        want.flush()
        assert sb_seq == want.sequence


def test_events_batcher_decode_pending():
    sig, _ = _sim_read(nbase=600, seed=53)
    bat = tse.EventsStreamingBatcher(CHUNK, OV, batch_size=8, device="cpu")
    bat.add_stream("c")
    got = bat.feed("c", sig)        # the queue never fills a batch of 8
    bat.decode_pending()            # the poller's hook: decode, keep
    got += bat.collect("c")
    got += bat.flush("c")
    assert got == _port(sig).sequence


@pytest.mark.parametrize("mode", ["prefix", "frozen"])
def test_events_stream_degenerate_first_chunk(mode):
    """A flat (blocked-pore) opening chunk must not poison the
    statistics: frozen mode does not freeze its zero variance, prefix mode
    does not count its one huge event."""
    sig, _ = _sim_read(nbase=1400, seed=47)
    flat = np.full(CHUNK, 42.0, np.float32)
    sb = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu",
                                       stats_mode=mode)
    sb.feed(flat)
    if mode == "frozen":
        assert sb._feat_stats is None
    else:
        assert sb._stats_n == 0
    sb.feed(sig)
    if mode == "frozen":
        assert sb._feat_stats is not None
    else:
        assert sb._stats_n >= 32
    sb.flush()
    assert len(sb.sequence) > 700
    _same_as_jax(sb, np.concatenate([flat, sig]), stats_mode=mode)


@pytest.mark.parametrize("stay_pen", [0.0, 0.7])
def test_neutral_rows_leave_the_real_events_alone(stay_pen):
    """The log posterior's rows past a chunk's events are neutral: the
    decoder's emissions and score are those of a decode of the real rows
    alone."""
    from scrappie_torch.decode.transducer import decode_transducer
    from scrappie_torch.models.forward import events_posterior

    sig, _ = _sim_read(nbase=400, seed=55)
    sb = tse.EventsStreamingBasecaller(CHUNK, OV, device="cpu")
    sb.append_samples(sig)
    _starts, sfeats, nev, _cov = sb._prepare_chunk(0)
    assert 32 < nev < sb.event_bucket
    dec = tse.EventsChunkDecoder("cpu", stay_pen=stay_pen)
    emissions, score = dec(sfeats, nev)
    lp = events_posterior(dec.net.params, torch.from_numpy(sfeats[None]))[0]
    want_score, want_path = decode_transducer(lp[:nev].numpy(),
                                              stay_pen=stay_pen, device="cpu")
    assert len(emissions) == nev
    assert np.array_equal(emissions, want_path[:nev])
    assert score == pytest.approx(want_score, rel=1e-6)


def test_events_stream_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tse.EventsStreamingBasecaller(CHUNK, OV)
    with pytest.raises(RuntimeError, match="cuda"):
        tse.EventsStreamingBatcher(CHUNK, OV)
