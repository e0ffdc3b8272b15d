"""Streaming events-pipeline basecalling (live signal -> events -> bases).

Counterpart of scrappie_tpu/parallel/streaming_events.py: the stream of the
reference's `scrappie events` pipeline (detect events, the nanonet biLSTM,
the transducer decode; ref src/scrappie_events.c:271-344) on the raw
stream's fixed sample-chunk geometry, with commits by event start sample
at the overlap midpoints:

  - events are detected per chunk (the t-stat peak detector resets at
    every peak, so interior events match whole-read detection; events
    near a chunk's edges can differ and are never committed);
  - features are studentised with prefix statistics, the running mean
    and variance of the events of every healthy chunk so far (chunk starts
    are fixed stream coordinates, so the output stays
    increment-invariant); `stats_mode="frozen"` freezes the first healthy
    chunk's, `"fixed"` takes them from the caller;
  - per-chunk event counts vary, so the features are reflect-padded to a
    fixed event bucket, and the head's log posterior rows past the chunk's
    events are made neutral (-1e30, `stay_pen` in the stay column) before
    the Viterbi forward and backtrace kernels, so they change nothing;
  - an event is committed once its start sample can no longer fall in a
    later chunk's kept region.

The device half (`EventsChunkDecoder`) runs the events network's LSTM pair
kernels and head on the card (models/forward.events_posterior_tm), then
the neutral rows and the Viterbi kernels; `EventsStreamingBatcher` splits
its batches into row slices over a device mesh's data devices
(parallel/sharding.py; by default every visible card), as
streaming.StreamingBatcher does. The dwell homopolymer correction needs
the whole read and does not apply.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import as_device
from scrappie_torch.models.forward import events_posterior_tm
from scrappie_torch.models.specs import NSTATE_TRANSDUCER
from scrappie_torch.ops.viterbi import viterbi_backtrace_tm, viterbi_scores_tm
from scrappie_torch.parallel.sharding import (load_replicas, make_mesh,
                                              resolve_mesh, round_batch,
                                              split_rows)
from scrappie_torch.parallel.streaming import SampleBufferMixin
from scrappie_torch.post.overlapper import kmer_len_from_nkmer, overlapper
from scrappie_torch.signal.events import EVENT_DETECTION_DEFAULTS, detect_events
from scrappie_torch.signal.features import (
    apply_feature_stats,
    feature_stats,
    nanonet_features_from_events,
)
from scrappie_torch.types import RawSignal
from scrappie_torch.utils.tracing import log


class EventsChunkDecoder:
    """The device half of an events stream: padded features
    [n, event_bucket, 4] and event counts [n] -> per-event emissions
    (each chunk's first nev path entries) and chunk scores, through the
    events network's posterior, the neutral padding rows and the Viterbi
    kernels. launch() dispatches, collect() copies back. On a mesh
    (`mesh`, else the one device `device`, default CUDA) the chunks are
    split into row slices over the data devices."""

    def __init__(self, device=None, *, mesh=None, min_prob: float = 1e-5,
                 tempW: float = 1.0, tempb: float = 1.0, stay_pen: float = 0.0,
                 skip_pen: float = 0.0, local_pen: float = 2.0,
                 use_slip: bool = False):
        self.mesh = (mesh if mesh is not None
                     else make_mesh(devices=[as_device(device)]))
        self.device = self.mesh.devices[0, 0]
        self.nets = load_replicas("nanonet_events", self.mesh, ())
        self.net = self.nets[0]
        self._head = dict(min_prob=float(min_prob), tempW=float(tempW),
                          tempb=float(tempb))
        self._decode = dict(stay_pen=float(stay_pen), skip_pen=float(skip_pen),
                            local_pen=float(local_pen), use_slip=bool(use_slip))

    @torch.inference_mode()
    def launch(self, sfeats: np.ndarray, nevs: list[int]) -> list:
        """Dispatch [n, bucket, 4] features -> each data row's (paths,
        scores, event counts), in row order."""
        feats = np.ascontiguousarray(sfeats, np.float32)
        out, lo = [], 0
        for r, part in split_rows(feats, self.mesh.data_devices):
            out.append(self._launch(self.nets[r], part,
                                    list(nevs[lo:lo + len(part)])))
            lo += len(part)
        return out

    def _launch(self, net, feats, nevs: list[int]):
        lp = events_posterior_tm(net.posterior_params, feats,
                                 winlen=net.winlen,
                                 **self._head)  # [bucket, n, ns]
        ns = lp.shape[-1]
        neutral = torch.full((ns,), -1e30, dtype=lp.dtype, device=lp.device)
        neutral[ns - 1] = self._decode["stay_pen"]
        nev = torch.as_tensor(np.asarray(nevs, np.int64), device=lp.device)
        pad_row = (torch.arange(lp.shape[0], device=lp.device)[:, None]
                   >= nev[None, :])
        lp = torch.where(pad_row[:, :, None], neutral, lp).contiguous()
        scores, paths = viterbi_backtrace_tm(*viterbi_scores_tm(lp,
                                                                **self._decode))
        return paths, scores, nevs

    @staticmethod
    def collect(launched) -> list[tuple[np.ndarray, float]]:
        out = []
        for paths, scores, nevs in launched:
            paths = paths.cpu().numpy()
            scores = scores.cpu().numpy()
            # emission of event i is path entry i (ref src/scrappie_events.c:301)
            out += [(paths[i][: nevs[i]], float(scores[i]))
                    for i in range(len(nevs))]
        return out

    def __call__(self, sfeats: np.ndarray, nev: int):
        """One chunk -> (emissions [nev], score)."""
        return self.collect(self.launch(sfeats[None], [nev]))[0]


class EventsStreamingBasecaller(SampleBufferMixin):
    """Incremental events-pipeline basecaller for one read or channel.

    feed(samples) -> str   newly committed bases (possibly "")
    flush() -> str         process the tail; the stream ends
    .sequence / .score / .nevent

    device: where a solo stream decodes (default "cuda"); events_fn: a
    decoder (padded features, nev) -> (emissions [nev], score), as
    EventsStreamingBatcher passes; without one the stream builds its own
    EventsChunkDecoder on `device`.
    """

    def __init__(self, chunk_len: int = 10000, overlap: int = 2000, *,
                 device=None, event_bucket: int | None = None,
                 trim_start: int = 0, min_prob: float = 1e-5,
                 tempW: float = 1.0, tempb: float = 1.0,
                 stay_pen: float = 0.0, skip_pen: float = 0.0,
                 local_pen: float = 2.0, use_slip: bool = False,
                 stats_mode: str = "prefix", feature_stats_override=None,
                 detection=EVENT_DETECTION_DEFAULTS, events_fn=None):
        if not 0 < overlap < chunk_len:
            raise ValueError("need 0 < overlap < chunk_len")
        self.chunk_len, self.overlap = int(chunk_len), int(overlap)
        self.hop = self.chunk_len - self.overlap
        # about one event every 5-10 samples; a quarter of the samples,
        # rounded up to 256, is a generous ceiling
        self.event_bucket = event_bucket or -(-self.chunk_len // 4 // 256) * 256
        self.detection = detection
        if stats_mode not in ("prefix", "frozen", "fixed"):
            raise ValueError(f"unknown stats_mode {stats_mode!r}")
        if stats_mode == "fixed":
            if feature_stats_override is None:
                raise ValueError(
                    "stats_mode='fixed' needs feature_stats_override="
                    "(mean*rsd, rsd) float32[4] pairs (e.g. from "
                    "signal.features.feature_stats on a calibration read)")
            self._fixed_stats = (
                np.asarray(feature_stats_override[0], np.float32),
                np.asarray(feature_stats_override[1], np.float32))
        self._stats_mode = stats_mode
        self._trim_left = int(trim_start)
        if events_fn is None:
            events_fn = EventsChunkDecoder(
                device, min_prob=min_prob, tempW=tempW, tempb=tempb,
                stay_pen=stay_pen, skip_pen=skip_pen, local_pen=local_pen,
                use_slip=use_slip)
        self._events_fn = events_fn

        # stream state
        self._parts: list[np.ndarray] = []
        self._base_off = 0
        self._nfed = 0
        self._next_start = 0
        self._reserved = 0               # chunks reserved, not committed
        self._committed_hi = 0           # a sample coordinate
        self._last_chunk = None          # (starts, emissions, s, score, nev)
        self._last_kmer: int | None = None
        self._feat_stats = None          # frozen (m*rsd, rsd) float32 [4]
        # prefix mode: running float64 moments of every healthy chunk's
        # events
        self._stats_n = 0
        self._stats_s1 = np.zeros(4, np.float64)
        self._stats_s2 = np.zeros(4, np.float64)
        self._seq_parts: list[str] = []
        self._score = 0.0
        self._nevent = 0
        self._done = False

    # ------------------------------------------------------------- chunk

    def _prepare_chunk(self, start: int):
        """The host half: detect events, studentise, reflect-pad to the
        bucket -> (event starts in stream samples [nev], padded features
        [event_bucket, 4], nev, coverage end).

        The coverage end is `start + chunk_len`, unless the bucket
        overflowed: then it is the first dropped event's start, and the
        commits stop there, so the next chunk detects and emits the rest."""
        x = self._window(start, self.chunk_len)
        et = detect_events(RawSignal(x), self.detection)
        feats = nanonet_features_from_events(et, normalise=False)
        nev = len(feats)
        cov = start + self.chunk_len
        if nev > self.event_bucket:
            cov = start + int(et.active["start"][self.event_bucket])
            log("warn", "event bucket overflow; deferring chunk tail "
                        "to the next chunk", nev=nev,
                bucket=self.event_bucket, coverage_end=cov)
            feats = feats[: self.event_bucket]
            nev = self.event_bucket
        sfeats = apply_feature_stats(feats, self._select_stats(feats, nev))

        # reflect-pad to the bucket: the pad rows look like events and are
        # never committed
        pad = self.event_bucket - nev
        if pad:
            refl = sfeats[::-1]
            reps = -(-pad // max(len(refl), 1))
            sfeats = np.concatenate(
                [sfeats, np.tile(refl, (reps, 1))[:pad]]) if nev else \
                np.zeros((self.event_bucket, 4), np.float32)
        starts = (et.active["start"][:nev].astype(np.int64) + start)
        return starts, np.asarray(sfeats, np.float32), nev, cov

    @staticmethod
    def _chunk_healthy(feats: np.ndarray, nev: int) -> bool:
        """No pathological dwell outlier: a pore stall gives one huge
        event whose length would dominate the statistics."""
        if nev < 1:
            return False
        lens = feats[:nev, 2]
        return float(lens.max()) <= 50.0 * max(float(np.median(lens)), 1.0)

    def _select_stats(self, feats: np.ndarray, nev: int):
        """Studentisation statistics for this chunk's features, a function
        of the signal prefix in every mode:

        'prefix': the running mean and variance of every healthy chunk's
        events so far (events in overlaps counted once a preparation), or
        the chunk's own until they are informative;
        'frozen': the first healthy chunk's (at least 32 events, every
        feature varying), the chunk's own until then;
        'fixed': the caller's."""
        if self._stats_mode == "fixed":
            return self._fixed_stats
        if self._stats_mode == "prefix":
            if nev >= 32 and self._chunk_healthy(feats, nev):
                f64 = feats[:nev].astype(np.float64)
                self._stats_n += nev
                self._stats_s1 += f64.sum(axis=0)
                self._stats_s2 += (f64 * f64).sum(axis=0)
            if self._stats_n >= 32:
                m = self._stats_s1 / self._stats_n
                v = self._stats_s2 / self._stats_n - m * m
                if (v > 0.0).all():
                    rsd = 1.0 / np.sqrt(v)
                    return (m * rsd).astype(np.float32), rsd.astype(np.float32)
            return feature_stats(feats)
        stats = self._feat_stats
        if stats is None:
            stats = feature_stats(feats)
            healthy = (nev >= 32 and bool((stats[1] > 0).all())
                       and self._chunk_healthy(feats, nev))
            if healthy:
                self._feat_stats = stats
        return stats

    def _chunk_events(self, start: int):
        """The whole chunk pipeline: host half, then the device half."""
        starts, sfeats, nev, cov = self._prepare_chunk(start)
        emissions, score = self._events_fn(sfeats, nev)
        return starts, emissions, score, nev, cov

    def _emit(self, seg: np.ndarray) -> str:
        seg = np.asarray(seg)
        nonstay = seg >= 0
        if not nonstay.any():
            return ""
        if self._last_kmer is None:
            out = overlapper(seg, NSTATE_TRANSDUCER - 1) or ""
        else:
            ext = np.concatenate([[self._last_kmer], seg])
            klen = kmer_len_from_nkmer(NSTATE_TRANSDUCER - 1)
            out = (overlapper(ext, NSTATE_TRANSDUCER - 1) or "")[klen:]
        self._last_kmer = int(seg[nonstay][-1])
        return out

    def _commit(self, starts, emissions, lo: int, hi: int, score: float,
                nev: int) -> str:
        """Commit the events whose start sample is in [lo, hi)."""
        sel = (starts >= lo) & (starts < hi)
        n = int(sel.sum())
        self._committed_hi = hi
        if n == 0:
            return ""
        bases = self._emit(emissions[sel])
        self._nevent += n
        self._score += score * n / max(nev, 1)
        if bases:
            self._seq_parts.append(bases)
        return bases

    # ------------------------------------------------------------- public

    @property
    def sequence(self) -> str:
        return "".join(self._seq_parts)

    @property
    def score(self) -> float:
        return self._score

    @property
    def nevent(self) -> int:
        return self._nevent

    def append_samples(self, samples) -> None:
        """Buffer samples without decoding (EventsStreamingBatcher)."""
        if self._done:
            raise RuntimeError("stream already flushed")
        samples = np.asarray(samples, dtype=np.float32).ravel()
        if self._trim_left:
            drop = min(self._trim_left, len(samples))
            samples = samples[drop:]
            self._trim_left -= drop
        if len(samples):
            self._parts.append(samples)
            self._nfed += len(samples)

    def _chunk_ready(self) -> bool:
        return (not self._done
                and self._nfed >= self._next_start + self.chunk_len)

    def _reserve_chunk(self):
        """Claim the next ready chunk: its host half now, its device half
        later; commits follow the reservation order."""
        s = self._next_start
        prep = self._prepare_chunk(s)
        self._next_start += self.hop
        self._reserved += 1
        self._compact()
        return s, prep

    def _commit_chunk(self, s: int, starts, emissions, score: float,
                      nev: int, cov: int | None = None) -> str:
        hi = s + self.hop + self.overlap // 2
        lo = 0 if s == 0 else self._committed_hi
        if cov is not None:  # bucket overflow: leave the dropped tail
            hi = max(min(hi, cov), lo)
        bases = self._commit(starts, np.asarray(emissions), lo, hi,
                             float(score), nev)
        self._last_chunk = (starts, np.asarray(emissions), s, float(score),
                            nev)
        self._reserved -= 1
        return bases

    def feed(self, samples) -> str:
        self.append_samples(samples)
        out: list[str] = []
        while self._chunk_ready():
            s, (starts, sfeats, nev, cov) = self._reserve_chunk()
            emissions, score = self._events_fn(sfeats, nev)
            out.append(self._commit_chunk(s, starts, emissions, score, nev,
                                          cov))
        return "".join(out)

    def flush(self) -> str:
        if self._done:
            raise RuntimeError("stream already flushed")
        if self._reserved:
            raise RuntimeError("reserved chunks not yet committed "
                               "(EventsStreamingBatcher must drain first)")
        self._done = True
        nsample = self._nfed
        if nsample == 0 or self._committed_hi >= nsample:
            return ""
        if self._last_chunk is None:
            starts, emissions, score, nev, _cov = self._chunk_events(0)
            return self._commit(starts, emissions, 0, nsample, score, nev)
        starts, emissions, prev_s, score, nev = self._last_chunk
        prev_start = self._next_start - self.hop
        if nsample <= prev_start + self.chunk_len:
            return self._commit(starts, emissions, self._committed_hi,
                                nsample, score, nev)
        f = max(0, nsample - self.chunk_len)
        f = min(f, prev_start + self.hop)
        starts, emissions, score, nev, _cov = self._chunk_events(f)
        return self._commit(starts, emissions, self._committed_hi, nsample,
                            score, nev)


class EventsStreamingBatcher:
    """Live events-pipeline basecalling of many channels with batched
    device work (the events counterpart of streaming.StreamingBatcher).

    Event detection and features run on the host per chunk; the ready
    chunks of all channels are decoded in groups of at most batch_size
    through one shared EventsChunkDecoder. A channel's bases equal a solo
    EventsStreamingBasecaller's. mesh, device and the batch size's
    rounding as streaming.StreamingBatcher's.
    """

    def __init__(self, chunk_len: int = 10000, overlap: int = 2000,
                 batch_size: int = 8, *, device=None, mesh=None,
                 min_prob: float = 1e-5,
                 tempW: float = 1.0, tempb: float = 1.0,
                 stay_pen: float = 0.0, skip_pen: float = 0.0,
                 local_pen: float = 2.0, use_slip: bool = False,
                 **stream_kwargs):
        self.chunk_len, self.overlap = chunk_len, overlap
        self.mesh = resolve_mesh(device, mesh)
        self.batch_size = round_batch(batch_size, self.mesh)
        self._decoder = EventsChunkDecoder(
            mesh=self.mesh, min_prob=min_prob, tempW=tempW, tempb=tempb,
            stay_pen=stay_pen, skip_pen=skip_pen, local_pen=local_pen,
            use_slip=use_slip)
        self._stream_kwargs = dict(stream_kwargs)
        self._streams: dict = {}
        self._queue: list[tuple] = []  # (key, s, starts, sfeats, nev, cov)
        self._outbuf: dict[object, list[str]] = {}

    # ------------------------------------------------------------ streams

    def add_stream(self, key, **kwargs) -> EventsStreamingBasecaller:
        if key in self._streams:
            raise KeyError(f"stream {key!r} already exists")
        kw = {**self._stream_kwargs, **kwargs}
        sb = EventsStreamingBasecaller(self.chunk_len, self.overlap,
                                       events_fn=self._decoder, **kw)
        self._streams[key] = sb
        self._outbuf[key] = []
        return sb

    def stream(self, key) -> EventsStreamingBasecaller:
        return self._streams[key]

    # ------------------------------------------------------------ decode

    def _run_queue(self, everything: bool) -> None:
        pending = []
        while (len(self._queue) >= self.batch_size
               or (everything and self._queue)):
            group = self._queue[: self.batch_size]
            del self._queue[: len(group)]
            pending.append((group, self._decoder.launch(
                np.stack([g[3] for g in group]), [g[4] for g in group])))
        for group, launched in pending:
            outs = self._decoder.collect(launched)
            for (key, s, starts, _sf, nev, cov), (em, sc) in zip(group, outs):
                bases = self._streams[key]._commit_chunk(s, starts, em, sc,
                                                         nev, cov)
                if bases:
                    self._outbuf[key].append(bases)

    def decode_pending(self) -> None:
        """Decode queued chunks, leaving the bases buffered (the server
        poller's hook; see streaming.StreamingBatcher.decode_pending)."""
        self._run_queue(everything=True)

    def collect(self, key) -> str:
        out = "".join(self._outbuf[key])
        self._outbuf[key].clear()
        return out

    # ------------------------------------------------------------ public

    def feed(self, key, samples) -> str:
        sb = self._streams[key]
        sb.append_samples(samples)
        while sb._chunk_ready():
            s, (starts, sfeats, nev, cov) = sb._reserve_chunk()
            self._queue.append((key, s, starts, sfeats, nev, cov))
        self._run_queue(everything=False)
        return self.collect(key)

    def poll(self) -> dict:
        self._run_queue(everything=True)
        out = {k: self.collect(k) for k in self._outbuf}
        return {k: v for k, v in out.items() if v}

    def flush(self, key) -> str:
        if any(q[0] == key for q in self._queue):
            self._run_queue(everything=True)
        tail = self._streams[key].flush()
        if tail:
            self._outbuf[key].append(tail)
        return self.collect(key)

    def close_stream(self, key) -> None:
        self._queue = [q for q in self._queue if q[0] != key]
        self._streams.pop(key, None)
        self._outbuf.pop(key, None)
