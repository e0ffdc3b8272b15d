"""scrappie_torch/parallel/streaming.py against scrappie_tpu's streams, on
the CPU.

The counterparts of tests/test_streaming.py (all but the device-mesh test;
the port runs on one card): increment invariance, the engine's fast mode
on the stream's grid, short and empty streams, trim_start, the prefix and
frozen calibrations, the batcher against solo streams, for rgrgr_r94 (the
fused route), raw_r94 (posterior, then the Viterbi kernels' twins),
rnnrf_r94 (the CRF route) and the 3:1:1 transducer ensemble (the fused
ensemble route). Every stream's bases must equal the JAX package's stream
on the same signal; scores are held to 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from scrappie_torch.parallel import streaming as tstream
from scrappie_tpu.parallel import streaming as jstream

torch.set_num_threads(2)

CHUNK, OV = 2000, 400
SCORE_RTOL = 1e-5


def _sim_read(nbase=600, seed=11):
    from scrappie_tpu.train.simulate import SquiggleSimulator

    sig, bases, _ = SquiggleSimulator(seed=seed).simulate_read(nbase)
    truth = "".join("ACGT"[b] for b in bases)
    return np.asarray(sig, np.float32), truth


def _stream(sig, splits, model="rgrgr_r94", **kw):
    sb = tstream.StreamingBasecaller(model, CHUNK, OV, device="cpu", **kw)
    fed, out = 0, []
    for n in splits:
        out.append(sb.feed(sig[fed : fed + n]))
        fed += n
    assert fed == len(sig)
    out.append(sb.flush())
    return sb, out


def _jax(sig, model="rgrgr_r94", **kw):
    sb = jstream.StreamingBasecaller(model, CHUNK, OV, **kw)
    sb.feed(sig)
    sb.flush()
    return sb


def _same_as_jax(sb, sig, model="rgrgr_r94", **kw):
    want = _jax(sig, model, **kw)
    assert sb.sequence == want.sequence and want.sequence
    assert sb.score == pytest.approx(want.score, rel=SCORE_RTOL)


def test_increment_invariance():
    sig, _ = _sim_read()
    rng = np.random.default_rng(0)
    one, out_one = _stream(sig, [len(sig)])
    splits = []
    left = len(sig)
    while left:
        n = min(left, int(rng.integers(1, 900)))
        splits.append(n)
        left -= n
    many, out_many = _stream(sig, splits)
    assert one.sequence == many.sequence and one.sequence
    assert np.isclose(one.score, many.score)
    # bases are only ever appended
    assert "".join(out_one) == "".join(out_many) == one.sequence
    _same_as_jax(one, sig)


def test_matches_engine_fast_mode():
    """On a length that puts the engine's right-aligned last chunk on the
    stream's grid, the stream equals the engine's fast mode (port and
    JAX) on the same pre-normalised signal."""
    from scrappie_torch.parallel.runner import BasecallEngine, RawSignal
    from scrappie_torch.utils.maths import medmad_normalise
    from scrappie_tpu.parallel.runner import BasecallEngine as JEngine
    from scrappie_tpu.types import RawSignal as JRawSignal

    n = 3 * (CHUNK - OV) + CHUNK
    nbase = 900
    while True:
        sig, _ = _sim_read(nbase=nbase, seed=3)
        if len(sig) >= n:
            break
        nbase += 200
    norm = medmad_normalise(sig[:n])
    kw = dict(trim_start=0, trim_end=0, varseg_thresh=0.0)
    res = BasecallEngine("rgrgr_r94", chunk_len=CHUNK, overlap=OV,
                         batch_size=4, mode="fast", device="cpu"
                         ).basecall_signals([RawSignal(norm, uuid="s")], **kw)[0]
    jres = JEngine("rgrgr_r94", chunk_len=CHUNK, overlap=OV, batch_size=4,
                   mode="fast").basecall_signals([JRawSignal(norm, uuid="s")],
                                                 **kw)[0]
    sb, _ = _stream(norm, [len(norm)], normalise=False)
    assert sb.sequence == res.sequence == jres.sequence and res.sequence


def test_streaming_accuracy_vs_truth():
    from scrappie_torch.utils.seqcompare import edit_distance

    sig, truth = _sim_read(nbase=800, seed=7)
    sb, _ = _stream(sig, [512] * (len(sig) // 512) + [len(sig) % 512])
    ident = 1.0 - edit_distance(sb.sequence, truth) / max(
        len(truth), len(sb.sequence))
    assert ident > 0.85, (ident, len(sb.sequence), len(truth))
    _same_as_jax(sb, sig)


def test_short_read_single_flush():
    sig, _ = _sim_read(nbase=60, seed=5)
    assert len(sig) < CHUNK
    sb = tstream.StreamingBasecaller("rgrgr_r94", CHUNK, OV, device="cpu")
    assert sb.feed(sig) == ""
    seq = sb.flush()
    assert seq == sb.sequence and len(seq) > 10
    _same_as_jax(sb, sig)


def test_empty_stream():
    sb = tstream.StreamingBasecaller("rgrgr_r94", CHUNK, OV, device="cpu")
    assert sb.flush() == ""
    with pytest.raises(RuntimeError):
        sb.feed(np.zeros(5, np.float32))
    with pytest.raises(RuntimeError):
        sb.flush()


def test_bad_geometry_and_models():
    with pytest.raises(ValueError, match="stride"):
        tstream.StreamingBasecaller("rgrgr_r94", 2001, 400, device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        tstream.StreamingBasecaller("rgrgr_r94", 2000, 2000, device="cpu")
    with pytest.raises(ValueError, match="calib_mode"):
        tstream.StreamingBasecaller("rgrgr_r94", CHUNK, OV, device="cpu",
                                    calib_mode="whole")
    with pytest.raises(ValueError, match="events"):
        tstream.StreamingBasecaller("nanonet_events", CHUNK, OV, device="cpu")


def test_batcher_matches_solo_streams():
    """Channels through a StreamingBatcher, fed in interleaved uneven
    slices, equal solo streams (and the JAX package's), exactly."""
    sigs = [_sim_read(nbase=n, seed=s)[0] for n, s in
            [(500, 1), (620, 2), (430, 4)]]
    solo = [_stream(sig, [len(sig)])[0].sequence for sig in sigs]

    bat = tstream.StreamingBatcher("rgrgr_r94", CHUNK, OV, batch_size=4,
                                   device="cpu")
    for i in range(len(sigs)):
        bat.add_stream(i)
    with pytest.raises(KeyError):
        bat.add_stream(0)
    rng = np.random.default_rng(3)
    offs = [0] * len(sigs)
    got = [""] * len(sigs)
    while any(offs[i] < len(sigs[i]) for i in range(len(sigs))):
        i = int(rng.integers(0, len(sigs)))
        if offs[i] >= len(sigs[i]):
            continue
        n = int(rng.integers(200, 1500))
        got[i] += bat.feed(i, sigs[i][offs[i] : offs[i] + n])
        offs[i] += n
    for k, v in bat.poll().items():
        got[k] += v
    for i in range(len(sigs)):
        got[i] += bat.flush(i)
    assert got == solo and all(got)
    assert got == [_jax(sig).sequence for sig in sigs]


def test_batcher_flush_with_queued_chunks():
    """flush() of one channel while others still have queued chunks."""
    sig_a, _ = _sim_read(nbase=500, seed=13)
    sig_b, _ = _sim_read(nbase=500, seed=14)
    bat = tstream.StreamingBatcher("rgrgr_r94", CHUNK, OV, batch_size=8,
                                   device="cpu")
    bat.add_stream("a")
    bat.add_stream("b")
    out_a = bat.feed("a", sig_a)   # queues chunks; a batch of 8 never fills
    out_b = bat.feed("b", sig_b)
    out_a += bat.flush("a")        # decodes a's queued chunks first
    out_b += bat.flush("b")
    assert out_a == _jax(sig_a).sequence
    assert out_b == _jax(sig_b).sequence
    bat.close_stream("a")
    assert "a" not in bat._streams and "b" in bat._streams


def test_crf_streaming():
    sig, _ = _sim_read(nbase=500, seed=9)
    sb1, _ = _stream(sig, [len(sig)], model="rnnrf_r94")
    sb2, _ = _stream(sig, [777] * (len(sig) // 777) + [len(sig) % 777],
                     model="rnnrf_r94")
    assert sb1.sequence == sb2.sequence and len(sb1.sequence) > 50
    want = _jax(sig, "rnnrf_r94")
    assert sb1.sequence == want.sequence


def test_streaming_trim_start():
    """trim_start drops exactly N samples from the head of the stream,
    however the feeds are split."""
    sig, _ = _sim_read(nbase=600, seed=17)
    ref, _ = _stream(sig[150:], [len(sig) - 150])
    tr, _ = _stream(sig, [97] * (len(sig) // 97) + [len(sig) % 97],
                    trim_start=150)
    assert tr.sequence == ref.sequence and tr.sequence
    assert tr.nsample == len(sig) - 150
    _same_as_jax(tr, sig, trim_start=150)


def test_batcher_decode_pending_buffers_bases():
    """decode_pending() (the server poller's hook) decodes the queued
    chunks and leaves the bases in the channel's buffer."""
    sig, _ = _sim_read(nbase=500, seed=19)
    bat = tstream.StreamingBatcher("rgrgr_r94", CHUNK, OV, batch_size=8,
                                   device="cpu")
    bat.add_stream("c")
    got = bat.feed("c", sig)         # queues chunks; a batch never fills
    assert bat._queue
    bat.decode_pending()
    assert not bat._queue
    got += bat.collect("c")
    got += bat.flush("c")
    assert got == _jax(sig).sequence


def test_streaming_ensemble_matches_jax():
    """The 3:1:1 ensemble takes the fused ensemble route, solo and through
    the batcher, and equals the JAX package's combined-posterior stream."""
    sig, _ = _sim_read(nbase=400, seed=33)
    ens = ("rgrgr_r941", "rgrgr_r10")
    solo, _ = _stream(sig, [len(sig)], ensemble=ens)
    bat = tstream.StreamingBatcher("rgrgr_r94", CHUNK, OV, batch_size=2,
                                   ensemble=ens, device="cpu")
    bat.add_stream("a")
    got = bat.feed("a", sig) + bat.flush("a")
    assert got == solo.sequence
    _same_as_jax(solo, sig, ensemble=ens)


def test_rnnrf_self_ensemble_stream_is_the_solo_stream():
    """rnnrf members combine their transitions by weight: a self-ensemble
    at 1:1 decodes the solo model's bases."""
    sig, _ = _sim_read(nbase=300, seed=35)
    solo, _ = _stream(sig, [len(sig)], model="rnnrf_r94")
    ens, _ = _stream(sig, [len(sig)], model="rnnrf_r94",
                     ensemble=("rnnrf_r94",), ensemble_weights=(1, 1))
    assert ens.sequence == solo.sequence and solo.sequence


def test_raw_kind_streaming():
    """raw_r94 (stride 4) streams with increment invariance."""
    sig, _ = _sim_read(nbase=400, seed=31)
    sb1, _ = _stream(sig, [len(sig)], model="raw_r94")
    sb2, _ = _stream(sig, [631] * (len(sig) // 631) + [len(sig) % 631],
                     model="raw_r94")
    assert sb1.sequence == sb2.sequence and len(sb1.sequence) > 50
    _same_as_jax(sb1, sig, "raw_r94")


def test_prefix_calibration_default_and_modes():
    """The default calibration is 'prefix'; both modes are increment
    invariant and equal the JAX streams; compaction bounds the buffer."""
    sig, _ = _sim_read()
    sb, _ = _stream(sig, [len(sig)])
    assert sb.calib_mode == "prefix"
    sb2, _ = _stream(sig, [611] * (len(sig) // 611) + [len(sig) % 611])
    assert sb.sequence == sb2.sequence and sb.sequence

    sb3 = tstream.StreamingBasecaller("rgrgr_r94", CHUNK, OV, device="cpu")
    sb3.feed(sig)
    assert sb3._base_off > 0  # compacted
    assert sum(len(p) for p in sb3._res_parts) == -(-len(sig) // 4)

    fz, _ = _stream(sig, [len(sig)], calib_mode="frozen")
    assert fz._med is not None and fz.sequence
    _same_as_jax(fz, sig, calib_mode="frozen")


def test_solo_stream_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.StreamingBasecaller("rgrgr_r94")
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.StreamingBatcher("rgrgr_r94")
