"""Streaming (incremental) basecalling: signal in, bases out, live.

Counterpart of scrappie_tpu/parallel/streaming.py. A `StreamingBasecaller`
accepts raw current samples in any increments (a live sequencing channel),
runs the batch engine's fixed chunk geometry (parallel/chunk.py), and
commits bases as soon as their blocks can no longer change: a block is
emitted once it is at least half an overlap inside a decoded chunk, the
midpoint rule of `chunk_keep_ranges`.

  - feed() decodes one chunk per completed `chunk_len - overlap` hop;
    bases are committed with at most `chunk_len` samples of lookahead.
  - The output is increment-invariant: the same signal fed in any split
    gives the same bases, and so does a channel decoded in any row of any
    batch of a `StreamingBatcher`.
  - The decode is the batch engine's fast mode (a per-chunk decode, then
    the midpoint path stitch); only the last junction can differ from the
    engine, which right-aligns its last chunk.

Normalisation: `calib_mode="prefix"` (default) scales each chunk by the
med-mad of a strided reservoir (every fourth sample) of all the samples up
to the chunk's end, a function of the signal prefix alone;
`calib_mode="frozen"` takes the scale of the first
`min(calib_samples, chunk_len)` samples and keeps it; `normalise=False`
takes the signal as it is.

The device half (`ChunkDecoder`) decodes normalised windows
[n, chunk_len] through the port's routes on one device: rgrgr through
ops/pipeline.rgrgr_basecall_fused, transducer ensembles through
ensemble_basecall_fused (models/ensemble.fused_config), raw_r94 through its
posterior, then the Viterbi forward and backtrace kernels, and rnnrf (with
its members' weighted transitions) through its head, then the CRF kernels
(ops/crf.crf_viterbi_tm). A solo stream builds its own on one device;
`StreamingBatcher` shares one across channels and decodes their ready
chunks in batches of at most `batch_size` on a device mesh
(parallel/sharding.py; every visible card unless `device` or `mesh` says
otherwise, as the JAX batcher's default mesh): each batch is split into
row slices over the data devices, each decoded by its device's replica
of the weights (replicated, as the JAX batcher places them).
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.decode.transducer import viterbi_decode_batch
from scrappie_torch.device import as_device
from scrappie_torch.models.convert import raw_spec
from scrappie_torch.models.ensemble import fused_config, validate_ensemble
from scrappie_torch.ops.crf import crf_viterbi_tm
from scrappie_torch.ops.pipeline import ensemble_basecall_fused
from scrappie_torch.parallel.sharding import (load_replicas, make_mesh,
                                              resolve_mesh, round_batch,
                                              split_rows)
from scrappie_torch.post.overlapper import kmer_len_from_nkmer, overlapper
from scrappie_torch.utils.maths import madf, medianf

NBASE = 4
_CRF_BASES = np.array(list("ACGT"))
# the prefix calibration's reservoir keeps every 4th stream sample
_RES_STRIDE = 4


class ChunkDecoder:
    """The device half of a raw stream: normalised windows
    [n, chunk_len] -> per-block emissions [n, nblock_chunk] (kmer or -1 for
    the transducers, CRF states for rnnrf) and chunk scores [n].

    launch() dispatches the kernels and returns tensors on the devices;
    collect() copies a launch's results to the host. __call__ does both.
    On a mesh (`mesh`, else the one device `device`, default CUDA) the
    windows are split into row slices over the data devices."""

    def __init__(self, model: str, device=None, *, mesh=None,
                 min_prob: float = 1e-5,
                 tempW: float = 1.0, tempb: float = 1.0, stay_pen: float = 0.0,
                 skip_pen: float = 0.0, local_pen: float = 2.0,
                 use_slip: bool = False, ensemble: tuple[str, ...] = (),
                 ensemble_weights: tuple[float, ...] | None = None):
        self.spec = raw_spec(model)
        self.mesh = (mesh if mesh is not None
                     else make_mesh(devices=[as_device(device)]))
        self.device = self.mesh.devices[0, 0]
        ensemble = tuple(ensemble)
        self._ens_w = None
        if ensemble or ensemble_weights is not None:
            self._ens_w = validate_ensemble(model, ensemble,
                                            ensemble_weights).astype(np.float32)
        self._fused_ens = fused_config(model, ensemble, ensemble_weights)
        # replicas[d]: the model and its members on data row d, replicated
        self.replicas = list(zip(*[load_replicas(m, self.mesh, ())
                                   for m in (model,) + ensemble]))
        self._head = dict(min_prob=float(min_prob), tempW=float(tempW),
                          tempb=float(tempb))
        self._decode = dict(stay_pen=float(stay_pen), skip_pen=float(skip_pen),
                            local_pen=float(local_pen), use_slip=bool(use_slip))

    @torch.inference_mode()
    def launch(self, xs: np.ndarray) -> list:
        """Dispatch [n, chunk_len] windows -> each data row's (emissions,
        scores) tensors on its device, in row order."""
        x = np.ascontiguousarray(xs, np.float32)[..., None]
        return [self._launch(self.replicas[r], part)
                for r, part in split_rows(x, self.mesh.data_devices)]

    def _launch(self, nets, x):
        kind = self.spec.kind
        if self._fused_ens is not None:
            w, kinds, acts = self._fused_ens
            scores, paths = ensemble_basecall_fused(
                [net.params for net in nets], w, x, kinds=kinds,
                conv_activations=acts, stride=self.spec.stride, **self._head,
                **self._decode)
            return paths[:, 1:], scores
        if kind == "rgrgr":
            scores, paths = nets[0].basecall_fused(x, **self._head,
                                                   **self._decode)
            return paths[:, 1:], scores
        out = [net(x, return_log=True, **self._head) for net in nets]
        if kind == "rnnrf":
            # the members' transitions, weighted and summed in member order
            trans = out[0]
            if self._ens_w is not None:
                trans = float(self._ens_w[0]) * out[0]
                for w, t in zip(self._ens_w[1:], out[1:]):
                    trans = trans + float(w) * t
            scores, paths = crf_viterbi_tm(trans.transpose(0, 1).contiguous())
            return paths[:, :-1], scores
        scores, paths = viterbi_decode_batch(out[0], **self._decode)
        return paths[:, 1:], scores

    @staticmethod
    def collect(launched) -> tuple[np.ndarray, np.ndarray]:
        emissions = [e.cpu().numpy().astype(np.int32) for e, _ in launched]
        scores = [s.cpu().numpy() for _, s in launched]
        if len(launched) == 1:
            return emissions[0], scores[0]
        return np.concatenate(emissions), np.concatenate(scores)

    def __call__(self, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.collect(self.launch(xs))


class SampleBufferMixin:
    """Stream-buffer machinery shared by the raw and events streams.

    Requires the attributes `_parts` (list of arrays), `_base_off` (samples
    dropped from the front), `_next_start` (the next chunk's first sample)
    and `chunk_len`. A subclass may override `_compact_ready()` to delay
    compaction (the raw stream's frozen calibration keeps its window)."""

    def _buffer(self) -> np.ndarray:
        if len(self._parts) > 1:
            self._parts = [np.concatenate(self._parts)]
        return self._parts[0] if self._parts else np.zeros(0, np.float32)

    def _window(self, start: int, length: int) -> np.ndarray:
        """Samples [start, start+length) in stream coordinates,
        reflect-padded at the tail like chunk.extract_chunks."""
        buf = self._buffer()
        seg = buf[start - self._base_off : start - self._base_off + length]
        if len(seg) == length:
            return seg
        out = np.zeros(length, np.float32)
        out[: len(seg)] = seg
        if len(seg) > 0:
            refl = seg[::-1]
            npad = length - len(seg)
            reps = -(-npad // len(refl))
            out[len(seg):] = np.tile(refl, reps)[:npad]
        return out

    def _compact_ready(self) -> bool:
        return True

    def _compact(self) -> None:
        # keep what a right-aligned final chunk at flush could still need
        # (its start is at least next_start - chunk_len)
        if not self._compact_ready():
            return
        keep_from = max(self._base_off, self._next_start - self.chunk_len)
        buf = self._buffer()
        drop = keep_from - self._base_off
        if drop > 0:
            self._parts = [buf[drop:]]
            self._base_off = keep_from


class StreamingBasecaller(SampleBufferMixin):
    """Incremental basecaller for one read or channel.

    feed(samples) -> str   newly committed bases (possibly "")
    flush() -> str         decode and commit the tail; the stream ends
    .sequence              all bases committed so far
    .score                 decode score so far, weighted by kept blocks

    device: where a solo stream decodes (default "cuda"). decode_fn: a
    decoder of normalised windows [n, chunk_len] -> (emissions
    [n, nblock_chunk], scores [n]), as StreamingBatcher passes its shared
    ChunkDecoder; without one the stream builds its own on `device`.
    trim_start drops that many samples from the head of the stream.
    """

    def __init__(self, model: str = "rgrgr_r94", chunk_len: int = 10000,
                 overlap: int = 1000, *, device=None, normalise: bool = True,
                 calib_mode: str = "prefix", calib_samples: int = 8000,
                 min_prob: float = 1e-5,
                 tempW: float = 1.0, tempb: float = 1.0, stay_pen: float = 0.0,
                 skip_pen: float = 0.0, local_pen: float = 2.0,
                 use_slip: bool = False, decode_fn=None,
                 trim_start: int = 0, ensemble: tuple[str, ...] = (),
                 ensemble_weights: tuple[float, ...] | None = None):
        self.model = model
        self.spec = raw_spec(model)
        if ensemble or ensemble_weights is not None:
            validate_ensemble(model, tuple(ensemble), ensemble_weights)
        stride = self.spec.stride
        if chunk_len % stride or overlap % stride:
            raise ValueError("chunk_len and overlap must be stride multiples")
        if not 0 < overlap < chunk_len:
            raise ValueError("need 0 < overlap < chunk_len")
        self.chunk_len, self.overlap = chunk_len, overlap
        self.hop = chunk_len - overlap
        self.normalise = normalise
        if calib_mode not in ("prefix", "frozen"):
            raise ValueError(f"unknown calib_mode {calib_mode!r}")
        self.calib_mode = calib_mode
        self.calib_samples = calib_samples
        if decode_fn is None:
            decode_fn = ChunkDecoder(
                model, device, min_prob=min_prob, tempW=tempW, tempb=tempb,
                stay_pen=stay_pen, skip_pen=skip_pen, local_pen=local_pen,
                use_slip=use_slip, ensemble=tuple(ensemble),
                ensemble_weights=ensemble_weights)
        self._decode_fn = decode_fn
        self._trim_left = int(trim_start)

        # stream state
        self._parts: list[np.ndarray] = []   # raw samples from _base_off on
        self._base_off = 0                   # samples dropped from the front
        self._nfed = 0                       # samples fed so far
        self._next_start = 0                 # first sample of the next chunk
        self._reserved = 0                   # chunks reserved, not committed
        self._committed_hi = 0               # blocks committed
        self._last_chunk = None              # (emissions, f_blk, score)
        self._last_kmer: int | None = None   # kmer context across commits
        self._med = self._mad = None
        self._res_parts: list[np.ndarray] = []  # the prefix reservoir
        self._seq_parts: list[str] = []
        self._score = 0.0
        self._done = False

    # ------------------------------------------------------------- buffer

    def _compact_ready(self) -> bool:
        # frozen mode keeps its calibration window until it calibrates
        return (self.calib_mode == "prefix" or self._med is not None
                or not self.normalise)

    def _prefix_medmad(self, upto: int) -> tuple[float, float]:
        """(median, mad) of the reservoir samples with stream index below
        `upto`: a function of the signal prefix alone."""
        if len(self._res_parts) > 1:
            self._res_parts = [np.concatenate(self._res_parts)]
        res = self._res_parts[0] if self._res_parts else np.zeros(0, np.float32)
        # reservoir sample i is stream sample i * _RES_STRIDE
        n_use = min(len(res), -(-upto // _RES_STRIDE))
        if n_use == 0:
            return 0.0, 1.0
        win = res[:n_use]
        med = medianf(win)
        mad = madf(win, med)
        return med, (mad if mad > 0 else 1.0)

    def _maybe_calibrate(self, force: bool = False) -> None:
        if not self.normalise or self._med is not None \
                or self.calib_mode == "prefix":
            return
        if self._nfed >= self.calib_samples or force:
            # the first min(calib_samples, chunk_len) samples, whatever the
            # feed sizes (the first chunk may be decoded before
            # calib_samples have arrived)
            win = self._buffer()[: min(self.calib_samples, self.chunk_len,
                                       self._nfed)]
            if len(win) == 0:
                self._med, self._mad = 0.0, 1.0
                return
            self._med = medianf(win)
            mad = madf(win, self._med)
            self._mad = mad if mad > 0 else 1.0

    # ------------------------------------------------------------- decode

    def _chunk_ready(self) -> bool:
        return (not self._done
                and self._nfed >= self._next_start + self.chunk_len)

    def _chunk_input(self, start: int) -> np.ndarray:
        """The normalised [chunk_len] window of the chunk at `start`."""
        x = self._window(start, self.chunk_len)
        if self.normalise:
            if self.calib_mode == "prefix":
                med, mad = self._prefix_medmad(start + self.chunk_len)
            else:
                self._maybe_calibrate(force=True)
                med, mad = self._med, self._mad
            x = (x - med) / mad
        return np.asarray(x, np.float32)

    def _reserve_chunk(self) -> tuple[int, np.ndarray]:
        """Claim the next ready chunk -> (start, normalised input), and
        advance the chunk cursor. Chunks are committed in this order."""
        start = self._next_start
        x = self._chunk_input(start)
        self._next_start += self.hop
        self._reserved += 1
        self._compact()
        return start, x

    def _decode(self, x: np.ndarray) -> tuple[np.ndarray, float]:
        """(per-block emissions [nblock_chunk], score) of one window."""
        emissions, scores = self._decode_fn(x[None])
        return emissions[0], float(scores[0])

    def _emit(self, seg: np.ndarray) -> str:
        """Newly committed emissions -> bases, with the kmer context carried
        across commits, so that the result equals one overlapper pass over
        all the emissions."""
        seg = np.asarray(seg)
        if self.spec.kind == "rnnrf":
            return "".join(_CRF_BASES[seg[seg < NBASE]])
        nonstay = seg >= 0
        if not nonstay.any():
            return ""
        if self._last_kmer is None:
            out = overlapper(seg, self.spec.nstate - 1) or ""
        else:
            ext = np.concatenate([[self._last_kmer], seg])
            klen = kmer_len_from_nkmer(self.spec.nstate - 1)
            out = (overlapper(ext, self.spec.nstate - 1) or "")[klen:]
        self._last_kmer = int(seg[nonstay][-1])
        return out

    def _commit_range(self, emissions: np.ndarray, f_blk: int, lo: int,
                      hi: int, score: float) -> str:
        """Commit blocks [lo, hi) of a chunk that starts at block f_blk;
        returns the new bases."""
        if hi <= lo:
            return ""
        bases = self._emit(emissions[lo - f_blk : hi - f_blk])
        self._committed_hi = hi
        self._score += score * (hi - lo) / max(len(emissions), 1)
        if bases:
            self._seq_parts.append(bases)
        return bases

    def _commit_chunk(self, start: int, emissions: np.ndarray,
                      score: float) -> str:
        """Commit a reserved chunk's decode (in reservation order)."""
        stride = self.spec.stride
        f_blk = start // stride
        hi = f_blk + self.hop // stride + (self.overlap // stride) // 2
        lo = 0 if start == 0 else self._committed_hi
        bases = self._commit_range(np.asarray(emissions), f_blk, lo, hi,
                                   float(score))
        self._last_chunk = (np.asarray(emissions), f_blk, float(score))
        self._reserved -= 1
        return bases

    # ------------------------------------------------------------- public

    @property
    def sequence(self) -> str:
        return "".join(self._seq_parts)

    @property
    def score(self) -> float:
        return self._score

    @property
    def nsample(self) -> int:
        return self._nfed

    def append_samples(self, samples) -> None:
        """Buffer samples without decoding (StreamingBatcher's ingest)."""
        if self._done:
            raise RuntimeError("stream already flushed")
        samples = np.asarray(samples, dtype=np.float32).ravel()
        if self._trim_left:
            drop = min(self._trim_left, len(samples))
            samples = samples[drop:]
            self._trim_left -= drop
        if len(samples):
            if self.normalise and self.calib_mode == "prefix":
                # stream indices [_nfed, _nfed+n): keep those divisible by
                # the stride, whatever the feed's split
                off = (-self._nfed) % _RES_STRIDE
                if off < len(samples):
                    self._res_parts.append(samples[off::_RES_STRIDE])
            self._parts.append(samples)
            self._nfed += len(samples)

    def feed(self, samples) -> str:
        self.append_samples(samples)
        out: list[str] = []
        while self._chunk_ready():
            start, x = self._reserve_chunk()
            emissions, score = self._decode(x)
            out.append(self._commit_chunk(start, emissions, score))
        return "".join(out)

    def flush(self) -> str:
        if self._done:
            raise RuntimeError("stream already flushed")
        if self._reserved:
            raise RuntimeError("reserved chunks not yet committed "
                               "(StreamingBatcher must poll() before flush)")
        self._done = True
        nsample = self._nfed
        if nsample == 0:
            return ""
        stride = self.spec.stride
        total = -(-nsample // stride)
        self._maybe_calibrate(force=True)
        if self._committed_hi >= total:
            return ""
        if self._last_chunk is None:
            # a short read: one reflect-padded chunk covers it
            emissions, score = self._decode(self._chunk_input(0))
            return self._commit_range(np.asarray(emissions), 0, 0, total,
                                      score)
        emissions, prev_f_blk, prev_score = self._last_chunk
        prev_start = self._next_start - self.hop
        if nsample <= prev_start + self.chunk_len:
            # the last decoded chunk covers the tail
            return self._commit_range(emissions, prev_f_blk,
                                      self._committed_hi, total, prev_score)
        # a right-aligned final chunk over the tail, its start rounded up
        # to the stride like chunk.plan_chunks' last chunk
        f = max(0, -(-(nsample - self.chunk_len) // stride) * stride)
        f = min(f, prev_start + self.hop)
        emissions, score = self._decode(self._chunk_input(f))
        return self._commit_range(np.asarray(emissions), f // stride,
                                  self._committed_hi, total, score)


class StreamingBatcher:
    """Live basecalling of many channels with batched device work.

    Ready chunks of all channels queue up and are decoded in groups of at
    most batch_size through one shared ChunkDecoder (full batches inside
    feed(); poll() forces the rest, for a latency deadline). A channel's
    bases equal a solo StreamingBasecaller's with the same parameters.

    feed(key, samples) -> new bases for that channel; bases decoded for
    other channels in the same batch wait for their next
    feed()/poll()/flush()/collect().

    mesh: a parallel/sharding.Mesh; device: one device; with neither,
    every visible card. batch_size is rounded up to a multiple of the
    mesh's data axis.
    """

    def __init__(self, model: str = "rgrgr_r94", chunk_len: int = 10000,
                 overlap: int = 1000, batch_size: int = 8, *, device=None,
                 mesh=None, min_prob: float = 1e-5, tempW: float = 1.0,
                 tempb: float = 1.0, stay_pen: float = 0.0,
                 skip_pen: float = 0.0, local_pen: float = 2.0,
                 use_slip: bool = False, ensemble: tuple[str, ...] = (),
                 ensemble_weights: tuple[float, ...] | None = None,
                 **stream_kwargs):
        self.model = model
        self.spec = raw_spec(model)
        self.chunk_len, self.overlap = chunk_len, overlap
        self.mesh = resolve_mesh(device, mesh)
        self.batch_size = round_batch(batch_size, self.mesh)
        self._decoder = ChunkDecoder(
            model, mesh=self.mesh, min_prob=min_prob, tempW=tempW, tempb=tempb,
            stay_pen=stay_pen, skip_pen=skip_pen, local_pen=local_pen,
            use_slip=use_slip, ensemble=tuple(ensemble),
            ensemble_weights=ensemble_weights)
        self._stream_kwargs = dict(stream_kwargs)
        self._streams: dict = {}
        self._queue: list[tuple] = []        # (key, start, window), FIFO
        self._outbuf: dict[object, list[str]] = {}

    # ------------------------------------------------------------ streams

    def add_stream(self, key, **kwargs) -> StreamingBasecaller:
        if key in self._streams:
            raise KeyError(f"stream {key!r} already exists")
        kw = {**self._stream_kwargs, **kwargs}
        sb = StreamingBasecaller(self.model, self.chunk_len, self.overlap,
                                 decode_fn=self._decoder, **kw)
        self._streams[key] = sb
        self._outbuf[key] = []
        return sb

    def stream(self, key) -> StreamingBasecaller:
        return self._streams[key]

    # ------------------------------------------------------------ decode

    def _run_queue(self, everything: bool) -> None:
        # launch every eligible batch before copying any result back; the
        # commits keep FIFO order, and with it each channel's order
        pending = []
        while (len(self._queue) >= self.batch_size
               or (everything and self._queue)):
            group = self._queue[: self.batch_size]
            del self._queue[: len(group)]
            xs = np.stack([w for _, _, w in group])
            pending.append((group, self._decoder.launch(xs)))
        for group, launched in pending:
            emis, scores = self._decoder.collect(launched)
            for (key, start, _), e, s in zip(group, emis, scores):
                bases = self._streams[key]._commit_chunk(start, e, float(s))
                if bases:
                    self._outbuf[key].append(bases)

    def decode_pending(self) -> None:
        """Decode all queued chunks without collecting: the bases stay in
        each channel's buffer for its next feed()/collect()/flush(). The
        latency-deadline hook of a server's poller (poll() would hand the
        bases to the poller, and they would never reach the client)."""
        self._run_queue(everything=True)

    def collect(self, key) -> str:
        """Bases decoded for `key` since its last feed/poll/collect."""
        out = "".join(self._outbuf[key])
        self._outbuf[key].clear()
        return out

    # ------------------------------------------------------------ public

    def feed(self, key, samples) -> str:
        """Buffer samples for one channel, decode any full batches, and
        return this channel's new bases (other channels' wait)."""
        sb = self._streams[key]
        sb.append_samples(samples)
        while sb._chunk_ready():
            start, x = sb._reserve_chunk()
            self._queue.append((key, start, x))
        self._run_queue(everything=False)
        return self.collect(key)

    def poll(self) -> dict:
        """Decode all queued chunks (latency deadline) -> {key: new bases}
        for every channel that gained bases."""
        self._run_queue(everything=True)
        out = {k: self.collect(k) for k in self._outbuf}
        return {k: v for k, v in out.items() if v}

    def flush(self, key) -> str:
        """Finish one channel: decode its queued chunks, then its tail.
        Returns all of the channel's remaining bases."""
        if any(q[0] == key for q in self._queue):
            # decode everything queued up to and including this channel's
            # chunks (a channel's chunks commit in order)
            self._run_queue(everything=True)
        tail = self._streams[key].flush()
        if tail:
            self._outbuf[key].append(tail)
        return self.collect(key)

    def close_stream(self, key) -> None:
        """Drop a channel's state (after flush(); a live server would
        otherwise keep every finished channel). Its unflushed queued
        chunks are discarded."""
        self._queue = [q for q in self._queue if q[0] != key]
        self._streams.pop(key, None)
        self._outbuf.pop(key, None)
