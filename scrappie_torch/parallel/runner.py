"""Batched multi-read basecalling engine for the rgrgr, rnnrf and events
models, one device.

Counterpart of scrappie_tpu/parallel/runner.py:BasecallEngine, with an
explicit `device` in place of the JAX mesh:

  host:   read -> trim -> normalise -> chunk             (numpy)
  device: [B, chunk_len] -> posterior or fused decode    (torch + kernels)
  host:   stitch, overlapper / homopolymer -> bases      (numpy)

Three paths, as in the JAX engine:
  * fast: the fused per-chunk pipeline (ops/pipeline.py), then the chunk
    paths are stitched at the overlap midpoints;
  * stitch on the device (homopolymer None or "nochange"): chunk
    posteriors stay on the device, are gathered into whole-read matrices
    there and decoded;
  * stitch on the host (homopolymer "mean"): chunk posteriors come to the
    host, are stitched per read, decoded in length buckets, and the
    homopolymer correction reads the whole-read posterior.

For rnnrf_r94 the "posterior" is the CRF transitions [nblock, 25], the
decode is the CRF Viterbi (ops/crf.py) and the bases come from
crfpath_to_basecall. Homopolymer correction does not apply to it, so its
stitch mode always stitches on the device.

For nanonet_events a read is trimmed, its events detected and their
features studentised over the whole read; chunks, overlaps and blocks
are counted in events ([n, chunk_len, 4] feature rows, one block per
event). The path of the first nev blocks gives the bases and annotates
the event table, and the optional dwell correction rewrites homopolymer
run lengths, in both modes. Posterior-mean homopolymer correction does not
apply, so its stitch mode also always stitches on the device.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from scrappie_torch.decode.crf import crfpath_to_basecall
from scrappie_torch.decode.transducer import assemble_events, viterbi_decode_batch
from scrappie_torch.device import as_device
from scrappie_torch.models.calibration import collapsed
from scrappie_torch.models.convert import basecaller_spec
from scrappie_torch.models.forward import load_model
from scrappie_torch.ops.crf import NS, add_emit_bias, crf_viterbi_tm
from scrappie_torch.parallel import chunk as chunklib
from scrappie_torch.post.homopolymer import HomopolymerMode, homopolymer_path
from scrappie_torch.post.overlapper import overlapper
from scrappie_torch.signal.events import detect_events
from scrappie_torch.signal.features import nanonet_features_from_events
from scrappie_torch.signal.trim import trim_and_segment_raw
from scrappie_torch.types import RawSignal
from scrappie_torch.utils.maths import medmad_normalise
from scrappie_torch.utils.tracing import Stage, log

__all__ = ["BasecallEngine", "RawSignal", "ReadResult"]


@dataclasses.dataclass
class ReadResult:
    uuid: str | None
    sequence: str | None
    score: float
    nblock: int
    pos: np.ndarray | None
    trim_start: int
    trim_end: int
    nsample: int
    events: object | None = None  # annotated EventTable (events model only)


#: Device batches in flight before the host waits for the oldest one's
#: results: the host prepares batch k+1 while the device computes batch k.
PIPELINE_DEPTH = 2
#: Whole-read decodes are padded with neutral blocks to a multiple of this
#: many blocks, so reads of similar length decode together.
DECODE_BUCKET = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _no_call(rs: RawSignal) -> ReadResult:
    return ReadResult(rs.uuid, None, float("nan"), 0, None, 0, 0, rs.n)


def _no_homopolymer(homopolymer) -> bool:
    return homopolymer in (None, "nochange", HomopolymerMode.NOCHANGE)


def _gather_decode(post, flat_idx, stay_pen, skip_pen, local_pen, use_slip):
    """Stitch chunk posteriors into whole-read matrices on the device and
    decode them: post [N, nb, ns] chunk outputs, flat_idx [R, T] indices
    into the flattened blocks (index N*nb = the appended neutral block,
    as chunk.neutral_pad_logpost builds on the host)."""
    N, nb, ns = post.shape
    neutral = torch.full((1, ns), -1e30, dtype=post.dtype, device=post.device)
    neutral[0, ns - 1] = stay_pen
    flat = torch.cat([post.reshape(N * nb, ns), neutral])
    lp = flat[flat_idx]  # [R, T, ns] whole-read stitched log posteriors
    return viterbi_decode_batch(lp, stay_pen, skip_pen, local_pen, use_slip)


def _gather_decode_crf(trans, flat_idx, emit_bias):
    """CRF counterpart of _gather_decode: trans [N, nb, 25] chunk
    transitions. The appended neutral block allows only moves into the
    blank state, at cost 0 (as scrappie_tpu's chunk.neutral_pad_crf builds
    on the host), so pad blocks emit nothing and carry the score
    unchanged. The gather is time-major, [T, R, 25], as the CRF kernels
    take it; the emit bias is added after it."""
    N, nb, nsq = trans.shape
    neutral = torch.full((1, nsq), -1e30, dtype=trans.dtype, device=trans.device)
    neutral[0, (NS - 1) * NS :] = 0.0
    flat = torch.cat([trans.reshape(N * nb, nsq), neutral])
    # a transposed index would give the gather its strides: copy it first
    return crf_viterbi_tm(add_emit_bias(flat[flat_idx.T.contiguous()],
                                        emit_bias))


class BasecallEngine:
    """Batched basecalling of many reads on one device.

    chunk_len/overlap are in samples (in events for nanonet_events; defaults
    10 000 / 1 000 samples, 2048 / 256 events) and are rounded up to
    multiples of the model stride. mode 'stitch' decodes whole reads from
    stitched chunk posteriors (chunked == unchunked basecall); 'fast'
    decodes each chunk with the fused pipeline and stitches the paths."""

    def __init__(self, model: str = "rgrgr_r94", chunk_len: int | None = None,
                 overlap: int | None = None, batch_size: int = 8, device=None,
                 min_prob: float = 1e-5, tempW: float = 1.0, tempb: float = 1.0,
                 mode: str = "stitch"):
        self.model = model
        self.spec = basecaller_spec(model)
        self.events = self.spec.kind == "events"
        if mode not in ("stitch", "fast"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.device = as_device(device)
        self._min_prob, self._tempW, self._tempb = min_prob, tempW, tempb
        stride = self.spec.stride
        if chunk_len is None:
            chunk_len = 2048 if self.events else 10000
        if overlap is None:
            overlap = 256 if self.events else 1000
        self.chunk_len = _round_up(chunk_len, stride)
        self.overlap = _round_up(overlap, stride)
        self.batch_size = int(batch_size)
        self.net = load_model(model, self.device)
        self.stage = Stage()

    # ------------------------------------------------------------- device

    def _posterior(self, x):
        return self.net(x, min_prob=self._min_prob, tempW=self._tempW,
                        tempb=self._tempb, return_log=True)

    def _to_device_batch(self, rows: np.ndarray) -> torch.Tensor:
        """[n, chunk_len] raw chunks -> [n, chunk_len, 1] on the device;
        events chunks [n, chunk_len, 4] keep their shape."""
        return torch.as_tensor(rows if self.events else rows[..., None],
                               device=self.device)

    def _device_batches(self, all_chunks: np.ndarray):
        for i in range(0, all_chunks.shape[0], self.batch_size):
            yield self._to_device_batch(all_chunks[i : i + self.batch_size])

    def _posterior_chunks(self, all_chunks: np.ndarray) -> np.ndarray:
        """Run [N, chunk_len] chunks through the net; posteriors to the host."""
        outs = []
        pend: collections.deque = collections.deque()
        for x in self._device_batches(all_chunks):
            pend.append(self._posterior(x))
            if len(pend) >= PIPELINE_DEPTH:
                outs.append(pend.popleft().cpu().numpy())
        outs.extend(p.cpu().numpy() for p in pend)
        return np.concatenate(outs, axis=0)[: all_chunks.shape[0]]

    def _posterior_chunks_device(self, all_chunks: np.ndarray) -> torch.Tensor:
        """Chunk posteriors kept on the device: [N, nblock_chunk, ns]."""
        outs = [self._posterior(x) for x in self._device_batches(all_chunks)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _decode_chunks_streamed(self, chunk_iter, call):
        """Fused per-chunk decode over an iterator of per-read chunk arrays:
        a device batch is dispatched as soon as batch_size chunks are
        there. Returns (scores [N], paths [N, nblock_chunk+1] int32), or
        (None, None) when the iterator yields nothing."""
        B = self.batch_size
        scores, paths = [], []
        pend: collections.deque = collections.deque()

        def collect():
            score, path = pend.popleft()
            scores.append(score.cpu().numpy())
            paths.append(path.cpu().numpy().astype(np.int32))

        def dispatch(rows):
            pend.append(call(self._to_device_batch(rows)))
            if len(pend) >= PIPELINE_DEPTH:
                collect()

        N = 0
        buf: list[np.ndarray] = []
        nbuf = 0
        for chunks in chunk_iter:
            N += chunks.shape[0]
            buf.append(chunks)
            nbuf += chunks.shape[0]
            while nbuf >= B:
                flat = np.concatenate(buf) if len(buf) > 1 else buf[0]
                dispatch(flat[:B])
                rest = flat[B:]
                buf = [rest] if len(rest) else []
                nbuf = len(rest)
        if nbuf:
            dispatch(np.concatenate(buf) if len(buf) > 1 else buf[0])
        while pend:
            collect()
        if N == 0:
            return None, None
        return np.concatenate(scores)[:N], np.concatenate(paths)[:N]

    def _stitch_decode_device(self, prepped, read_chunks, stay_pen, skip_pen,
                              local_pen, use_slip, crf_emit_bias=0.0):
        """Exact stitch with the posterior never leaving the device: chunk
        posteriors are gathered into whole-read matrices (padded to the
        decode bucket with neutral blocks) and decoded there; only scores
        and paths come back. Same kept blocks, neutral padding and
        decoder as the host path.

        Returns {index in prepped: (score, path [nblock+1])}."""
        live = [(i, e, c) for (i, e), c in
                zip([(i, e) for i, e in enumerate(prepped) if e is not None],
                    read_chunks)]
        results: dict[int, tuple[float, np.ndarray]] = {}
        inflight: collections.deque = collections.deque()

        def collect_one():
            group, scores_d, paths_d = inflight.popleft()
            scores = scores_d.cpu().numpy()
            paths = paths_d.cpu().numpy()
            for j, (i, e, _c) in enumerate(group):
                nblock = e[2].nblock_total
                results[i] = (float(scores[j]), paths[j, : nblock + 1].copy())

        gi = 0
        while gi < len(live):
            # group reads so that one posterior pass covers the group
            group = []
            nchunks = 0
            while gi < len(live):
                plan = live[gi][1][2]
                if group and nchunks + plan.nchunk > self.batch_size:
                    break
                group.append(live[gi])
                nchunks += plan.nchunk
                gi += 1

            chunks = np.concatenate([c for _, _, c in group], axis=0)
            with self.stage("posterior"):
                post = self._posterior_chunks_device(chunks)
            nb = post.shape[1]
            neutral_idx = post.shape[0] * nb  # the row _gather_decode appends

            T_bucket = _round_up(max(e[2].nblock_total for _, e, _c in group),
                                 DECODE_BUCKET)
            flat_idx = np.full((len(group), T_bucket), neutral_idx, dtype=np.int64)
            off = 0
            for j, (_, e, _c) in enumerate(group):
                plan = e[2]
                starts_blk = plan.starts // plan.stride
                for ci, (lo, hi) in enumerate(chunklib.chunk_keep_ranges(plan)):
                    if hi <= lo:
                        continue
                    flat_idx[j, lo:hi] = (off + ci) * nb + np.arange(
                        lo - starts_blk[ci], hi - starts_blk[ci])
                off += plan.nchunk

            with self.stage("decode"):
                idx = torch.as_tensor(flat_idx, device=self.device)
                if self.spec.kind == "rnnrf":
                    scores_d, paths_d = _gather_decode_crf(
                        post, idx, float(crf_emit_bias))
                else:
                    scores_d, paths_d = _gather_decode(
                        post, idx, float(stay_pen), float(skip_pen),
                        float(local_pen), bool(use_slip))
            inflight.append((group, scores_d, paths_d))
            if len(inflight) >= PIPELINE_DEPTH:
                with self.stage("collect"):
                    collect_one()
        while inflight:
            with self.stage("collect"):
                collect_one()
        return results

    def _decode_bucketed(self, logposts: list[np.ndarray], stay_pen, skip_pen,
                         local_pen, use_slip):
        """Batched decode of host posteriors, neutrally padded to bucketed
        lengths."""
        order = np.argsort([lp.shape[0] for lp in logposts])
        results: list = [None] * len(logposts)
        i = 0
        while i < len(order):
            target = _round_up(logposts[order[i]].shape[0], DECODE_BUCKET)
            group = []
            while i < len(order) and logposts[order[i]].shape[0] <= target:
                group.append(order[i])
                i += 1
            padded = np.stack(
                [chunklib.neutral_pad_logpost(logposts[g], target, stay_pen)
                 for g in group])
            scores, paths = viterbi_decode_batch(
                torch.as_tensor(padded, device=self.device), stay_pen,
                skip_pen, local_pen, use_slip)
            scores = scores.cpu().numpy()
            paths = paths.cpu().numpy()
            for j, g in enumerate(group):
                nb = logposts[g].shape[0]
                results[g] = (float(scores[j]), paths[j, : nb + 1].copy())
        return results

    def _result(self, rt, et, path, score, nblock: int,
                dwell_correction: bool) -> ReadResult:
        """A read's result from its whole-read path [nblock+1]; for the
        events model (nblock = nev), from its event table et as well. Timed
        as the stage "assemble"."""
        with self.stage("assemble"):
            if self.events:
                seq, pos = assemble_events(et, path, self.spec.nstate,
                                           dwell_correction)
                return ReadResult(rt.uuid, seq, score, nblock, pos, rt.start,
                                  rt.end, rt.n, et)
            pos = np.zeros(nblock + 1, dtype=np.int64)
            if self.spec.kind == "rnnrf":
                seq = crfpath_to_basecall(path, pos)
            else:
                seq = overlapper(path, self.spec.nstate - 1, pos)
            return ReadResult(rt.uuid, seq, score, nblock, pos, rt.start,
                              rt.end, rt.n)

    # ---------------------------------------------------------------- API

    def basecall_signals(self, signals: list[RawSignal], *, skip_pen=0.0,
                         **kwargs) -> list[ReadResult]:
        """Basecall a batch of raw signals.

        Decode-collapse guard (scrappie_tpu/models/calibration.py): a
        positive skip penalty can absorb a whole read into the decoder's
        local states on out-of-distribution data. A read that emits
        implausibly few bases for its block count is warned about and
        decoded again with skip_pen=0."""
        with torch.inference_mode():
            results = self._basecall_signals_impl(signals, skip_pen=skip_pen,
                                                  **kwargs)
            if skip_pen > 0:
                redo = [i for i, r in enumerate(results)
                        if r.nblock and collapsed(len(r.sequence or ""),
                                                  r.nblock, self.model)]
                for i in redo:
                    r = results[i]
                    log("warn", "decode collapsed; re-decoding with skip_pen=0",
                        uuid=r.uuid, nbases=len(r.sequence or ""),
                        nblock=r.nblock, skip_pen=skip_pen)
                if redo:
                    fixed = self._basecall_signals_impl(
                        [signals[i] for i in redo], skip_pen=0.0, **kwargs)
                    for i, r in zip(redo, fixed):
                        results[i] = r
        return results

    def _basecall_signals_impl(self, signals: list[RawSignal], *, trim_start=200,
                               trim_end=10, varseg_chunk=100, varseg_thresh=0.0,
                               stay_pen=0.0, skip_pen=0.0, local_pen=2.0,
                               use_slip=False,
                               homopolymer: HomopolymerMode | str | None = None,
                               crf_emit_bias: float = 0.0,
                               dwell_correction: bool = True,
                               with_qualities: bool = False) -> list[ReadResult]:
        if with_qualities:
            raise NotImplementedError(
                "per-base qualities (FASTQ) are not ported yet: ROADMAP.md "
                "queue 1 item 7")

        def prep_read(rs):
            """One read's host preparation -> ((rt, et, plan), chunks),
            or (None, None); et is the event table of an events read, else
            None. A read that fails only warns (per-read error isolation,
            ref src/scrappie_raw.c:397-400)."""
            try:
                rt = trim_and_segment_raw(rs, trim_start, trim_end,
                                          varseg_chunk, varseg_thresh)
                if rt is None:
                    return None, None
                et = None
                if self.events:
                    # features studentised over the whole read, as
                    # api.basecall_events (ref src/scrappie_events.c:271-299)
                    with self.stage("detect_events"):
                        et = detect_events(rt)
                        rows = nanonet_features_from_events(et, normalise=True)
                    if not len(rows):
                        return None, None
                else:
                    rows = medmad_normalise(rt.trimmed)
                plan = chunklib.plan_chunks(len(rows), self.chunk_len,
                                            self.overlap, self.spec.stride)
            except Exception as e:
                log("warn", "read preprocessing failed", uuid=rs.uuid,
                    error=str(e))
                return None, None
            return (rt, et, plan), chunklib.extract_chunks(rows, plan)

        if self.mode == "fast":
            if not _no_homopolymer(homopolymer):
                log("warn", "fast mode cannot apply posterior-mean "
                            "homopolymer correction (it needs whole-read "
                            "posteriors); use stitch mode for it")
            prepped = []

            def chunk_iter():
                nchunk_total = 0
                for rs in signals:
                    entry, chunks = prep_read(rs)
                    if entry is None:
                        prepped.append(None)
                        continue
                    prepped.append(entry + (nchunk_total,))
                    nchunk_total += entry[2].nchunk
                    yield chunks

            def call(x):
                if self.spec.kind == "rnnrf":
                    return self.net.basecall_fused(x, emit_bias=crf_emit_bias)
                return self.net.basecall_fused(
                    x, min_prob=self._min_prob, tempW=self._tempW,
                    tempb=self._tempb, stay_pen=stay_pen, skip_pen=skip_pen,
                    local_pen=local_pen, use_slip=use_slip)

            with self.stage("decode_fused"):
                scores, paths = self._decode_chunks_streamed(chunk_iter(), call)
            if scores is None:
                return [_no_call(rs) for rs in signals]
            results = []
            for entry, rs in zip(prepped, signals):
                if entry is None:
                    results.append(_no_call(rs))
                    continue
                rt, et, plan, off = entry
                path = chunklib.stitch_paths(paths[off : off + plan.nchunk], plan)
                keep = chunklib.chunk_keep_ranges(plan)
                score = float(sum(
                    scores[off + i] * (hi - lo) / plan.nblock_chunk
                    for i, (lo, hi) in enumerate(keep)))
                results.append(self._result(rt, et, path, score,
                                            plan.nblock_total, dwell_correction))
            return results

        # Stitch modes: prepare every read first (the device stitch groups
        # reads by their chunk counts).
        prepped = []
        all_chunks = []
        nchunk_total = 0
        for rs in signals:
            entry, chunks = prep_read(rs)
            if entry is None:
                prepped.append(None)
                continue
            prepped.append(entry + (nchunk_total,))
            nchunk_total += entry[2].nchunk
            all_chunks.append(chunks)
        if not all_chunks:
            return [_no_call(rs) for rs in signals]

        if self.events and not _no_homopolymer(homopolymer):
            log("warn", "posterior homopolymer correction does not apply "
                        "to the events pipeline (it uses dwell correction); "
                        "ignoring")
            homopolymer = None
        if self.spec.kind == "rnnrf" or _no_homopolymer(homopolymer):
            decoded = self._stitch_decode_device(
                prepped, all_chunks, stay_pen, skip_pen, local_pen, use_slip,
                crf_emit_bias)
            results = []
            for i, (entry, rs) in enumerate(zip(prepped, signals)):
                if entry is None:
                    results.append(_no_call(rs))
                    continue
                rt, et, plan, _ = entry
                score, path = decoded[i]
                results.append(self._result(rt, et, path, score,
                                            plan.nblock_total, dwell_correction))
            return results

        # Host stitch: one device pass over every chunk of every read, then
        # per-read stitching, bucketed decode and homopolymer correction.
        with self.stage("posterior"):
            post = self._posterior_chunks(np.concatenate(all_chunks, axis=0))
        logposts = []
        for entry in prepped:
            if entry is not None:
                _rt, _et, plan, off = entry
                logposts.append(chunklib.stitch_blocks(
                    post[off : off + plan.nchunk], plan))
        with self.stage("decode"):
            decoded = iter(self._decode_bucketed(logposts, stay_pen, skip_pen,
                                                 local_pen, use_slip))
        mode = (HomopolymerMode.parse(homopolymer)
                if isinstance(homopolymer, str) else homopolymer)
        results = []
        lps = iter(logposts)
        for entry, rs in zip(prepped, signals):
            if entry is None:
                results.append(_no_call(rs))
                continue
            rt = entry[0]
            lp = next(lps)
            score, path = next(decoded)
            nblock = lp.shape[0]
            path = homopolymer_path(lp, np.asarray(path).copy(), mode)
            pos = np.zeros(nblock + 1, dtype=np.int64)
            seq = overlapper(path, lp.shape[1] - 1, pos)
            results.append(ReadResult(rt.uuid, seq, score, nblock, pos,
                                      rt.start, rt.end, rt.n))
        return results

    def basecall_files(self, paths, limit: int = 0,
                       **kwargs) -> list[tuple[str, ReadResult]]:
        """Basecall every read of every fast5 file (a multi-read file gives
        one result per read, named ``<path>:<read_id>``; ``limit`` caps
        the number of files)."""
        import sys

        from scrappie_torch.io.fast5 import iterate_fast5, read_raw_all

        files = iterate_fast5(paths)
        if limit:
            files = files[:limit]
        signals = []
        names = []
        for f in files:
            try:
                sigs = read_raw_all(f, scale_to_pA=True)
            except Exception as e:  # per-read error isolation (ref :397-400)
                print(f"Failed to read {f}: {e}", file=sys.stderr)
                continue
            signals.extend(sigs)
            names.extend([str(f)] if len(sigs) == 1 else
                         [f"{f}:{s.uuid}" for s in sigs])
        return list(zip(names, self.basecall_signals(signals, **kwargs)))
