"""Dynamic-batching basecall serving, and a JSON-lines TCP server.

Counterpart of scrappie_tpu/serve.py, with the same wire protocol. Its
engines and batchers run on a device mesh (parallel/sharding.py): `mesh`,
or the one device `device`, or by default every visible card, as the JAX
server's default mesh. The card's throughput comes from batching, so
`BasecallService` queues incoming reads from many clients and hands groups
of them to one `parallel/runner.BasecallEngine`, waiting at most
`max_wait_ms` for company.

Two surfaces:
  - in-process: `BasecallService.submit(signal) -> concurrent Future`
    (thread-safe; the engine runs on one worker thread);
  - network: `make_server()` / `python -m scrappie_torch serve`,
    newline-delimited JSON over TCP.

Wire protocol (one JSON object a line, UTF-8):
  request  {"id": "...", "signal": [f32, ...]}            or
           {"id": "...", "signal_b64": "<base64 f32 LE>"}
           optional "opts": {basecall_signals keywords: local_pen, ...,
           with_qualities; and "calibration": "real" for the model's
           measured decode preset, models/calibration.py}
           optional "model": "rnnrf_r94", routed to that model's service
           (built on first use; default the server's model)
  response {"id": "...", "sequence": "ACGT...", "score": -12.3,
            "nblock": 123, "nsample": 61500}               or
           {"id": "...", "error": "..."}
           (and "qual", Phred+33, with opts.with_qualities)

Live channels (incremental signal, parallel/streaming.py) use the same
connection with an "op" field; channel names are scoped to their
connection, and ready chunks batch across all connections
(`StreamingService`):
  {"op": "open",  "channel": "c1", "opts": {...}}  -> {"open": true}
  ("pipeline": "events" streams the events pipeline instead,
  parallel/streaming_events.py)
  {"op": "feed",  "channel": "c1", "signal": [...]}-> {"bases": "..."}
  {"op": "flush", "channel": "c1"}                 -> {"bases": "...", "final": true}
A dropped connection discards its unflushed channels.
  {"op": "stats"} -> the default service's counters {requests, batches,
  engine_calls}.

Whole reads from several connections batch together; responses on one
connection come back in request order. A failing request gets an error
response and the connection goes on; a failing engine call fails only its
own requests.

Threads: every service builds the kernel library (ops/_build.library)
before its threads start. Whichever thread launches kernels (the service
worker, the stream poller, the handlers feeding and flushing channels)
decodes under torch.inference_mode, which the engine's basecall_signals
and the streams' decoders (ChunkDecoder.launch, EventsChunkDecoder.launch)
enter, and all of them launch on the device's current stream, so kernels
run in the order they are queued. The streams' state is guarded by
StreamingService's lock.
"""

from __future__ import annotations

import base64
import json
import queue
import socketserver
import threading
import time
from concurrent.futures import Future

import numpy as np

from scrappie_torch.parallel.sharding import resolve_mesh
from scrappie_torch.types import RawSignal
from scrappie_torch.utils.tracing import log


def _prepare(device=None, mesh=None) -> None:
    """Resolve the mesh and, on cards, build and load the kernels now,
    before any service thread can launch one."""
    if resolve_mesh(device, mesh).device_type == "cuda":
        from scrappie_torch.ops import _build

        _build.library()


class BasecallService:
    """Thread-safe dynamic-batching front of a BasecallEngine.

    Requests wait at most `max_wait_ms` for company; a batch holds at most
    `max_batch_reads` reads. Requests with the same decode options share
    an engine call; differing options split the batch (each engine call
    has one option set).
    """

    def __init__(self, model: str = "rgrgr_r94", *, engine=None,
                 max_batch_reads: int = 16, max_wait_ms: float = 25.0,
                 **engine_kwargs):
        if engine is None:
            from scrappie_torch.parallel.runner import BasecallEngine

            _prepare(engine_kwargs.get("device"), engine_kwargs.get("mesh"))
            engine = BasecallEngine(model, **engine_kwargs)
        self.engine = engine
        self.model = engine.model
        self.max_batch_reads = max_batch_reads
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = {"requests": 0, "batches": 0, "engine_calls": 0}
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # serialises submit()'s check-then-enqueue against close() setting
        # the flag, so that no request is queued after both drains; and
        # the request count, which handler threads raise
        self._submit_lock = threading.Lock()
        self._worker_thread = threading.Thread(
            target=self._worker, name="basecall-service", daemon=True)
        self._worker_thread.start()

    # --------------------------------------------------------------- API

    def submit(self, signal, uuid: str | None = None, **opts) -> Future:
        """Queue one read; resolves to a runner.ReadResult.

        A "calibration" option ("reference" or "real") is expanded into
        the model's measured decode preset (models/calibration.py) before
        batching, so that calibrated requests and requests that name the
        same options share an engine call.
        """
        calibration = opts.pop("calibration", "reference")
        if calibration != "reference":
            from scrappie_torch.models import calibration as _calibration

            members = tuple(getattr(self.engine, "ensemble", ()) or ())
            for key, value in _calibration.preset(self.model, calibration,
                                                  members).items():
                opts.setdefault(key, value)
        sig = np.asarray(signal, dtype=np.float32).ravel()
        fut: Future = Future()
        key = tuple(sorted(opts.items()))
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("service is closed")
            self._q.put((sig, uuid, key, opts, fut))
            self.stats["requests"] += 1
        return fut

    def basecall(self, signal, uuid: str | None = None,
                 timeout: float | None = None, **opts):
        """submit() and wait for the result."""
        return self.submit(signal, uuid, **opts).result(timeout)

    def close(self) -> None:
        with self._submit_lock:
            self._stop.set()  # no submit passes the check after this
        self._worker_thread.join(timeout=30)
        # fail what was queued after the worker's own drain: no client
        # waits for ever
        self._drain_failed()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ worker

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch_reads:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            self.stats["batches"] += 1
            # one engine call per distinct option set, in arrival order
            groups: dict[tuple, list] = {}
            for req in batch:
                groups.setdefault(req[2], []).append(req)
            for reqs in groups.values():
                signals = [RawSignal(sig, uuid=uuid) for sig, uuid, *_ in reqs]
                opts = reqs[0][3]
                self.stats["engine_calls"] += 1
                try:
                    results = self.engine.basecall_signals(signals, **opts)
                except Exception as e:  # noqa: BLE001 — fault isolation
                    log("error", "engine call failed", error=repr(e),
                        requests=len(reqs))
                    for *_, fut in reqs:
                        if not fut.cancelled():
                            fut.set_exception(e)
                    continue
                for (*_, fut), res in zip(reqs, results):
                    if not fut.cancelled():
                        fut.set_result(res)
        # drain: fail whatever is still queued, so that no client hangs
        self._drain_failed()

    def _drain_failed(self) -> None:
        while True:
            try:
                *_, fut = self._q.get_nowait()
            except queue.Empty:
                return
            if not fut.cancelled():
                fut.set_exception(RuntimeError("service closed"))


class StreamingService:
    """Thread-safe front of a StreamingBatcher for live channels.

    Many connections feed signal for named channels; the ready chunks of
    all channels batch together. A background poller bounds the decode
    latency of stalled channels (their bases wait in the channel's buffer
    for its next request: the protocol is request and response).
    """

    def __init__(self, model: str = "rgrgr_r94", *, chunk_len: int = 10000,
                 overlap: int = 1000, batch_size: int = 8,
                 poll_ms: float = 50.0, device=None, mesh=None,
                 **stream_kwargs):
        from scrappie_torch.parallel.streaming import StreamingBatcher

        _prepare(device, mesh)
        self.batcher = StreamingBatcher(model, chunk_len, overlap,
                                        batch_size=batch_size, device=device,
                                        mesh=mesh, **stream_kwargs)
        self._chunk_len, self._overlap = chunk_len, overlap
        self._batch_size = batch_size
        self._device, self._mesh = device, mesh
        self._stream_kwargs = dict(stream_kwargs)
        self._events_batcher = None  # built by the first events channel
        self._route: dict = {}       # key -> the batcher that owns it
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poll_s = poll_ms / 1e3
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="stream-poller", daemon=True)
        self._poller.start()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                # decode_pending, not poll(): poll() would collect the
                # bases, and they would never reach the client
                self.batcher.decode_pending()
                if self._events_batcher is not None:
                    self._events_batcher.decode_pending()

    def open(self, key, pipeline: str = "raw", **kwargs) -> None:
        with self._lock:
            if pipeline == "raw":
                bat = self.batcher
            elif pipeline == "events":
                if self._events_batcher is None:
                    from scrappie_torch.parallel.streaming_events import (
                        EventsStreamingBatcher,
                    )

                    # the raw batcher's chunk geometry and decode options;
                    # raw-only options (normalise, calib_samples, ...) have
                    # no events counterpart
                    shared = {k: v for k, v in self._stream_kwargs.items()
                              if k in ("min_prob", "tempW", "tempb",
                                       "stay_pen", "skip_pen", "local_pen",
                                       "use_slip")}
                    self._events_batcher = EventsStreamingBatcher(
                        self._chunk_len, max(self._overlap, 1),
                        batch_size=self._batch_size, device=self._device,
                        mesh=self._mesh, **shared)
                bat = self._events_batcher
            else:
                raise ValueError(f"unknown pipeline {pipeline!r}")
            bat.add_stream(key, **kwargs)
            self._route[key] = bat

    def feed(self, key, samples) -> str:
        with self._lock:
            return self._route[key].feed(key, samples)

    def flush(self, key) -> str:
        with self._lock:
            bat = self._route.pop(key)
            try:
                return bat.flush(key)
            finally:
                bat.close_stream(key)

    def discard(self, key) -> None:
        """Drop a channel without flushing it (its client went away)."""
        with self._lock:
            bat = self._route.pop(key, None)
            if bat is not None:
                bat.close_stream(key)

    def close(self) -> None:
        self._stop.set()
        self._poller.join(timeout=10)


# ------------------------------------------------------------------ TCP

def _req_signal(req) -> np.ndarray:
    if "signal_b64" in req:
        return np.frombuffer(base64.b64decode(req["signal_b64"]),
                             dtype="<f4")
    return np.asarray(req["signal"], dtype=np.float32)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):  # one JSON request a line; responses in order
        my_channels: set = set()
        try:
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                rid = None
                try:
                    req = json.loads(line)
                    rid = req.get("id")
                    op = req.get("op")
                    if op is None:  # a whole read
                        svc = self.server.service_for(req.get("model"))
                        res = svc.basecall(
                            _req_signal(req), uuid=rid, **req.get("opts", {}))
                        resp = {"id": rid, "sequence": res.sequence,
                                "score": (None if res.score != res.score
                                          else res.score),
                                "nblock": res.nblock, "nsample": res.nsample}
                        if res.qual is not None:  # opts.with_qualities
                            resp["qual"] = res.qual
                    elif op == "stats":
                        resp = {"id": rid, **self.server.service.stats}
                    else:  # live channel ops, scoped to this connection
                        chan = req["channel"]
                        key = (self.connection.fileno(), chan)
                        ss = self.server.streaming_service()
                        if op == "open":
                            ss.open(key, pipeline=req.get("pipeline", "raw"),
                                    **req.get("opts", {}))
                            my_channels.add(key)
                            resp = {"id": rid, "channel": chan, "open": True}
                        elif op == "feed":
                            bases = ss.feed(key, _req_signal(req))
                            resp = {"id": rid, "channel": chan,
                                    "bases": bases}
                        elif op == "flush":
                            my_channels.discard(key)
                            bases = ss.flush(key)
                            resp = {"id": rid, "channel": chan,
                                    "bases": bases, "final": True}
                        else:
                            raise ValueError(f"unknown op {op!r}")
                except Exception as e:  # noqa: BLE001 — per-request isolation
                    resp = {"id": rid, "error": str(e)}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
        finally:
            for key in my_channels:  # the client went away mid-stream
                self.server.streaming_service().discard(key)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def streaming_service(self) -> StreamingService:
        """The shared StreamingService, built on first use (live channels
        batch across connections)."""
        with self._ss_lock:
            if self._ss is None:
                self._ss = StreamingService(**self._ss_kwargs)
            return self._ss

    def service_for(self, model: str | None) -> BasecallService:
        """A request's model's service: the default model's is built with
        the server, the others on their first request (each its own engine
        and worker)."""
        if model is None or model == self._default_model:
            return self.service
        from scrappie_torch.models.specs import EVENTS_MODEL, RAW_MODELS

        if model not in RAW_MODELS and model != EVENTS_MODEL.name:
            raise KeyError(f"unknown model {model!r}")
        with self._ss_lock:
            if model not in self._model_services:
                kwargs = dict(self._service_kwargs, model=model)
                # ensemble members fit the default model's block grid; a
                # request routed to another model uses that model alone
                kwargs.pop("ensemble", None)
                kwargs.pop("ensemble_weights", None)
                if model == EVENTS_MODEL.name:
                    # the events engine counts its chunks in events: the
                    # server's sample geometry does not apply
                    kwargs.pop("chunk_len", None)
                    kwargs.pop("overlap", None)
                self._model_services[model] = BasecallService(**kwargs)
            return self._model_services[model]

    def close_services(self) -> None:
        """Close every service the server built or was given."""
        self.service.close()
        for svc in self._model_services.values():
            svc.close()
        if self._ss is not None:
            self._ss.close()


def make_server(host: str = "127.0.0.1", port: int = 0,
                service: BasecallService | None = None,
                streaming_kwargs: dict | None = None, **service_kwargs):
    """Build (but do not start) the TCP server; `.server_address` has the
    bound port. The caller closes the services (`close_services()`)."""
    service = service or BasecallService(**service_kwargs)
    server = _Server((host, port), _Handler)
    server.service = service
    server._default_model = service.model  # also for a given service
    server._service_kwargs = dict(service_kwargs)
    server._model_services = {}
    server._ss = None
    server._ss_lock = threading.Lock()
    ss_kwargs = dict(streaming_kwargs or {})
    ss_kwargs.setdefault("model", service_kwargs.get("model", "rgrgr_r94"))
    for k in ("chunk_len", "overlap", "batch_size", "device", "mesh"):
        if k in service_kwargs:
            ss_kwargs.setdefault(k, service_kwargs[k])
    server._ss_kwargs = ss_kwargs
    return server


def serve(host: str = "127.0.0.1", port: int = 7777, **service_kwargs) -> None:
    """Run the TCP basecall server until interrupted."""
    server = make_server(host, port, **service_kwargs)
    log("info", "serving", host=host, port=server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.close_services()
        server.server_close()
