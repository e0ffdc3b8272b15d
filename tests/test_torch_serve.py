"""scrappie_torch/serve.py against scrappie_tpu/serve.py, on the CPU.

The counterparts of tests/test_serve.py: the dynamic-batching service
against the JAX engine, the TCP server's responses against the JAX
server's on the same reads (whole reads, qualities, model routing), live
raw and events channels against the JAX package's solo streams, fault
isolation and the close-down. Bases must be equal, whole-read scores
within 1e-5 relative (rnnrf_r94's, a sum of near-cancelling CRF
transitions, within 2e-5 a block, as tests/test_torch_rnnrf.py holds
them), qualities within utils/seqcompare.quals_agree (the
same number of codes; at most 1% of them, and at least 2 allowed, differ,
none by more than 1). Every socket has a timeout and every thread
is joined with one, so a hang fails its test.
"""

import contextlib
import json
import socket
import threading

import numpy as np
import pytest
import torch

from scrappie_torch import serve as tserve
from scrappie_tpu import serve as jserve
from scrappie_torch.utils.seqcompare import qual_diffs, quals_agree

torch.set_num_threads(2)

GEOMETRY = dict(chunk_len=2000, overlap=400, batch_size=4)
SCORE_RTOL = 1e-5
CRF_SCORE_TOL_PER_BLOCK = 2e-5
TIMEOUT = 300


@pytest.fixture(scope="module")
def sim_reads():
    from scrappie_tpu.train.simulate import SquiggleSimulator

    sim = SquiggleSimulator(seed=21)
    return [np.asarray(sim.simulate_read(n)[0], np.float32)
            for n in (300, 400, 350, 320)]


@contextlib.contextmanager
def running(server):
    """Serve in a daemon thread; shut down and close every service after."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        t.join(timeout=30)
        assert not t.is_alive()
        server.service.close()
        for svc in server._model_services.values():
            svc.close()
        if server._ss is not None:
            server._ss.close()
        server.server_close()


def port_server(**kw):
    return tserve.make_server(port=0, device="cpu", **kw)


def jax_server(**kw):
    return jserve.make_server(port=0, **kw)


class Client:
    """One connection; rpc() sends a request line and reads its answer."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=TIMEOUT)
        self.sock.settimeout(TIMEOUT)
        self.rfile = self.sock.makefile()

    def rpc(self, obj) -> dict:
        self.sock.sendall((json.dumps(obj) + "\n").encode())
        line = self.rfile.readline()
        assert line, "connection closed"
        return json.loads(line)

    def close(self):
        self.rfile.close()
        self.sock.close()


def in_threads(fn, n: int) -> list:
    """fn(i) for i < n in n threads, each joined with a timeout."""
    out = [None] * n
    errors = []

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
        assert not th.is_alive(), "client thread hung"
    assert not errors, errors
    return out


def whole_reads(port: int, reads, **extra) -> list:
    """Each read as a whole-read request on its own connection, at once."""
    def one(i):
        c = Client(port)
        try:
            return c.rpc({"id": f"r{i}", "signal": reads[i].tolist(), **extra})
        finally:
            c.close()
    return in_threads(one, len(reads))


def assert_same_response(got: dict, want: dict) -> None:
    assert got["id"] == want["id"]
    assert "error" not in got, got
    assert got["sequence"] == want["sequence"] and got["sequence"]
    assert got["nblock"] == want["nblock"]
    assert got["nsample"] == want["nsample"]
    assert got["score"] == pytest.approx(want["score"], rel=SCORE_RTOL)
    assert ("qual" in got) == ("qual" in want)
    if "qual" in want:
        assert quals_agree(got["qual"], want["qual"]), \
            qual_diffs(got["qual"], want["qual"])


def jax_engine(model="rgrgr_r94", **kw):
    from scrappie_tpu.parallel.runner import BasecallEngine

    return BasecallEngine(model, **{**GEOMETRY, **kw})


def test_service_batches_and_matches_engine(sim_reads):
    from scrappie_tpu.types import RawSignal

    want = jax_engine().basecall_signals(
        [RawSignal(r, uuid=f"r{i}") for i, r in enumerate(sim_reads)])
    with tserve.BasecallService("rgrgr_r94", device="cpu", max_wait_ms=300.0,
                                **GEOMETRY) as svc:
        futs = [svc.submit(r, uuid=f"r{i}") for i, r in enumerate(sim_reads)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        # four reads submitted inside the wait window: one or two calls
        assert svc.stats["engine_calls"] <= 2
        assert svc.stats["requests"] == 4
    for g, w in zip(got, want):
        assert g.uuid == w.uuid
        assert g.sequence == w.sequence and g.sequence
        assert g.score == pytest.approx(w.score, rel=SCORE_RTOL)
        assert (g.nblock, g.nsample) == (w.nblock, w.nsample)


def test_service_splits_on_options(sim_reads):
    with tserve.BasecallService("rgrgr_r94", device="cpu", max_wait_ms=300.0,
                                **GEOMETRY) as svc:
        f1 = svc.submit(sim_reads[0], uuid="a")
        f2 = svc.submit(sim_reads[1], uuid="b", local_pen=9.0)
        r1, r2 = f1.result(TIMEOUT), f2.result(TIMEOUT)
        assert svc.stats["engine_calls"] == 2  # two option sets, two calls
    assert r1.sequence and r2.sequence


def test_service_close_fails_queued():
    svc = tserve.BasecallService("rgrgr_r94", device="cpu", **GEOMETRY)
    svc.close()
    assert not svc._worker_thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros(100, np.float32))


def test_service_close_drains_the_queue(sim_reads):
    """Requests still queued when the service closes fail; none hangs."""
    svc = tserve.BasecallService("rgrgr_r94", device="cpu", max_wait_ms=0.0,
                                 **GEOMETRY)
    futs = [svc.submit(r) for r in sim_reads * 3]
    svc.close()
    done = 0
    for f in futs:
        try:
            f.result(timeout=TIMEOUT)
            done += 1
        except RuntimeError as e:
            assert "closed" in str(e)
    assert done < len(futs) or svc.stats["engine_calls"] >= 1


def test_service_poisoned_read_isolated(sim_reads):
    """A bad read batched with good ones fails alone (the engine's per-read
    isolation, ref src/scrappie_raw.c:397-400)."""
    bad = np.full(4000, np.nan, np.float32)
    with tserve.BasecallService("rgrgr_r94", device="cpu", max_wait_ms=300.0,
                                **GEOMETRY) as svc:
        futs = [svc.submit(sim_reads[0], uuid="good0"),
                svc.submit(bad, uuid="bad"),
                svc.submit(sim_reads[1], uuid="good1")]
        good0, badr, good1 = [f.result(timeout=TIMEOUT) for f in futs]
    assert good0.sequence and good1.sequence
    assert badr.sequence is None


def test_tcp_whole_reads_match_the_jax_server(sim_reads):
    """Four concurrent connections; half the requests with qualities."""
    reads = sim_reads
    extra = [{}, {"opts": {"with_qualities": True}}]
    out = {}
    for name, make in (("port", port_server), ("jax", jax_server)):
        with running(make(model="rgrgr_r94", max_wait_ms=200.0,
                          **GEOMETRY)) as port:
            out[name] = [whole_reads(port, reads, **e) for e in extra]
    for got, want in zip(out["port"], out["jax"]):
        for g, w in zip(got, want):
            assert_same_response(g, w)
    assert all("qual" in r for r in out["port"][1])


def test_tcp_base64_signal(sim_reads):
    import base64

    with running(port_server(model="rgrgr_r94", **GEOMETRY)) as port:
        c = Client(port)
        try:
            b64 = base64.b64encode(sim_reads[0].astype("<f4").tobytes()).decode()
            a = c.rpc({"id": "b", "signal_b64": b64})
            b = c.rpc({"id": "l", "signal": sim_reads[0].tolist()})
        finally:
            c.close()
    assert a["sequence"] == b["sequence"] and a["sequence"]


def test_tcp_server_bad_request():
    with running(port_server(model="rgrgr_r94", **GEOMETRY)) as port:
        c = Client(port)
        try:
            resp = c.rpc({"id": "x", "signal": "not-a-list"})
            assert resp["id"] == "x" and "error" in resp
            # the connection survives a bad request
            resp = c.rpc({"id": "y", "op": "nope", "channel": "c"})
            assert resp["id"] == "y" and "unknown op" in resp["error"]
        finally:
            c.close()


def test_tcp_stats_op(sim_reads):
    with running(port_server(model="rgrgr_r94", **GEOMETRY)) as port:
        c = Client(port)
        try:
            c.rpc({"id": "r", "signal": sim_reads[0].tolist()})
            resp = c.rpc({"id": "st", "op": "stats"})
        finally:
            c.close()
    assert resp["id"] == "st"
    assert resp["requests"] == 1
    assert resp["batches"] >= 1 and resp["engine_calls"] >= 1


def test_tcp_model_routing(sim_reads):
    """A request names its model; other models' services are built on
    their first request; an unknown model errors without closing the
    connection."""
    from scrappie_tpu.types import RawSignal

    server = port_server(model="rgrgr_r94", **GEOMETRY)
    with running(server) as port:
        c = Client(port)
        try:
            sig = sim_reads[0].tolist()
            r_def = c.rpc({"id": "d", "signal": sig})
            r_crf = c.rpc({"id": "c", "signal": sig, "model": "rnnrf_r94"})
            r_ev = c.rpc({"id": "e", "signal": sig, "model": "nanonet_events"})
            r_bad = c.rpc({"id": "x", "signal": sig, "model": "nope"})
        finally:
            c.close()
        assert set(server._model_services) == {"rnnrf_r94", "nanonet_events"}
    assert "error" in r_bad and "nope" in r_bad["error"]
    for resp, model, kw in ((r_def, "rgrgr_r94", GEOMETRY),
                            (r_crf, "rnnrf_r94", GEOMETRY),
                            (r_ev, "nanonet_events",
                             {"batch_size": GEOMETRY["batch_size"]})):
        from scrappie_tpu.parallel.runner import BasecallEngine

        want = BasecallEngine(model, **kw).basecall_signals(
            [RawSignal(sim_reads[0], uuid=resp["id"])])[0]
        assert resp["sequence"] == want.sequence and want.sequence
        if model == "rnnrf_r94":
            assert abs(resp["score"] - want.score) <= (
                CRF_SCORE_TOL_PER_BLOCK * want.nblock)
        else:
            assert resp["score"] == pytest.approx(want.score, rel=SCORE_RTOL)
        assert (resp["nblock"], resp["nsample"]) == (want.nblock, want.nsample)
    assert r_def["sequence"] != r_crf["sequence"]


def live(port: int, sig, step: int, pipeline: str = "raw") -> str:
    """Stream sig over one connection in `step`-sample feeds, then flush."""
    c = Client(port)
    try:
        req = {"op": "open", "channel": "c"}
        if pipeline != "raw":
            req["pipeline"] = pipeline
        assert c.rpc(req)["open"]
        bases = ""
        for off in range(0, len(sig), step):
            r = c.rpc({"op": "feed", "channel": "c",
                       "signal": sig[off : off + step].tolist()})
            assert "error" not in r, r
            bases += r["bases"]
        r = c.rpc({"op": "flush", "channel": "c"})
        assert r["final"]
        return bases + r["bases"]
    finally:
        c.close()


def test_tcp_live_channels(sim_reads):
    """Four connections stream a read each; each equals the JAX package's
    solo StreamingBasecaller on the whole signal."""
    from scrappie_tpu.parallel.streaming import StreamingBasecaller

    with running(port_server(model="rgrgr_r94", **GEOMETRY,
                             streaming_kwargs={"poll_ms": 20.0})) as port:
        got = in_threads(lambda i: live(port, sim_reads[i], 1500), 4)
    for sig, g in zip(sim_reads, got):
        solo = StreamingBasecaller("rgrgr_r94", 2000, 400)
        solo.feed(sig)
        solo.flush()
        assert g == solo.sequence and g


def test_tcp_live_events_pipeline(sim_reads):
    """pipeline=events routes to the events batcher, with the server's
    chunk geometry, and equals the JAX package's solo events stream."""
    from scrappie_tpu.parallel.streaming_events import (
        EventsStreamingBasecaller,
    )

    sig = sim_reads[1]
    with running(port_server(model="rgrgr_r94", **GEOMETRY,
                             streaming_kwargs={"poll_ms": 20.0})) as port:
        got = live(port, sig, 1700, pipeline="events")
    solo = EventsStreamingBasecaller(2000, 400)
    solo.feed(sig)
    solo.flush()
    assert got == solo.sequence and got


def test_dropped_connection_discards_its_channels(sim_reads):
    server = port_server(model="rgrgr_r94", **GEOMETRY)
    with running(server) as port:
        c = Client(port)
        assert c.rpc({"op": "open", "channel": "c"})["open"]
        c.rpc({"op": "feed", "channel": "c",
               "signal": sim_reads[0][:2500].tolist()})
        ss = server.streaming_service()
        assert len(ss._route) == 1
        c.close()
        for _ in range(300):
            if not ss._route:
                break
            threading.Event().wait(0.05)
        assert not ss._route and not ss.batcher._streams


def test_service_fast_mode_with_ensemble(sim_reads):
    """mode='fast' serves the fused path, the fused ensemble included:
    the service equals the JAX fast-mode ensemble engine."""
    from scrappie_tpu.types import RawSignal

    kw = dict(chunk_len=4000, overlap=500, batch_size=4,
              ensemble=("rgrgr_r941", "rgrgr_r10"))
    want = jax_engine(mode="fast", **kw).basecall_signals(
        [RawSignal(r, uuid=f"r{i}") for i, r in enumerate(sim_reads)])
    with tserve.BasecallService("rgrgr_r94", mode="fast", device="cpu",
                                max_wait_ms=300.0, **kw) as svc:
        got = [f.result(timeout=TIMEOUT) for f in
               [svc.submit(r, uuid=f"r{i}") for i, r in enumerate(sim_reads)]]
    for g, w in zip(got, want):
        assert g.sequence == w.sequence and g.sequence
        assert g.score == pytest.approx(w.score, rel=SCORE_RTOL)


def test_serve_command(sim_reads):
    """`python -m scrappie_torch serve --device cpu` answers a whole read
    and a stats request, as the JAX server does, and stops when killed."""
    import os
    import pathlib
    import subprocess
    import sys
    import time

    with socket.socket() as probe:  # a free port for the server to bind
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "scrappie_torch", "serve", "--device", "cpu",
         "--port", str(port), "--chunk-len", "2000", "--overlap", "400",
         "--batch", "4"],
        cwd=repo, env={**os.environ, "PYTHONPATH": str(repo)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                c = Client(port)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "the server never listened"
                time.sleep(0.2)
        try:
            got = c.rpc({"id": "r0", "signal": sim_reads[0].tolist()})
            stats = c.rpc({"id": "st", "op": "stats"})
        finally:
            c.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stderr.close()
    with running(jax_server(model="rgrgr_r94", **GEOMETRY)) as jport:
        want = whole_reads(jport, sim_reads[:1])[0]
    assert_same_response(got, want)
    assert stats["requests"] == 1


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from scrappie_torch.cli.main import main as torch_main

    with pytest.raises(RuntimeError, match="cuda"):
        tserve.BasecallService("rgrgr_r94")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.StreamingService("rgrgr_r94")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.make_server(port=0)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["serve", "--port", "0"])
