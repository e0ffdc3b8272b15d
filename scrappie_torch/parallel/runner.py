"""Batched multi-read basecalling engine for the rgrgr, raw_r94, rnnrf and
events models, and for ensembles of raw models, on a device mesh.

Counterpart of scrappie_tpu/parallel/runner.py:BasecallEngine. It runs on
a mesh of devices (parallel/sharding.py): with neither `device` nor `mesh`
every visible card, as the JAX engine's default mesh; `device=` pins one.
Every device batch is split into contiguous row slices over the mesh's
data devices, each slice runs on its own device's replica (kernels launch
asynchronously, so distinct cards overlap), and the outputs come back in
chunk order. On a mesh with a 'state' axis the posterior paths split the
output layer's product over the row's state devices
(nn/layers.state_matmul); the fused paths' head kernel takes that weight
whole from the data device. On a one-device mesh the one slice is the
whole batch: one copy to the device, as without a mesh.

  host:   read -> trim -> normalise -> chunk             (numpy)
  device: [B, chunk_len] -> posterior or fused decode    (torch + kernels)
  host:   stitch, overlapper / homopolymer -> bases      (numpy)

Three paths, as in the JAX engine:
  * fast: the fused per-chunk pipeline (ops/pipeline.py), then the chunk
    paths are stitched at the overlap midpoints;
  * stitch on the device (homopolymer None or "nochange"): chunk
    posteriors stay on the mesh, each read group's are gathered onto one
    data device (groups in turn over the data devices; each device's part
    copied once) into whole-read matrices there and decoded;
  * stitch on the host (homopolymer "mean"): chunk posteriors come to the
    host, are stitched per read, decoded in length buckets, and the
    homopolymer correction reads the whole-read posterior.

raw_r94 takes the rgrgr models' paths: its posterior is a 1025-state
transducer's too (bidirectional GRU stages, stride 4).

With `ensemble` members (models/ensemble.py), the members' per-block
outputs are combined with the primary's before the decode, in member order
with float32 weights: transducers (rgrgr, raw_r94) as a weighted log-domain
mean renormalised per block by its log-sum-exp, rnnrf as the weighted sum
of its CRF transitions (no renormalisation: the CRF is globally
normalised). Both stitch paths decode that combined posterior; fast mode
runs the member stacks, the head kernel that combines any number of
members and the Viterbi forward (ops/pipeline.ensemble_basecall_fused), or
sums the weighted transitions
before the CRF kernels (rnnrf_ensemble_basecall_fused).

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

Per-base qualities (`with_qualities=True`, for FASTQ; post/quality.py), as
in the JAX engine: fast mode reads them from the fused paths' quality
stream (ops/pipeline.quality_stream_tm), stitched like the paths; rnnrf
has none there and warns. Stitch mode takes the host path for every model,
since the qualities read the whole-read posterior: transducer_qualities
for the transducers, crf_qualities of posterior_crf_batch (the
forward-backward kernels on the engine's device, the call's reads in the
few launches of crf_groups) for rnnrf. An events read's qualities are dropped, with
a warning, when the dwell correction changes its length.
`qual_calibration="real"` recalibrates them with the measured fit of the
model or of the ensemble configuration (post/quality.QUAL_RECAL).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from scrappie_torch.decode.crf import crfpath_to_basecall, decode_crf
from scrappie_torch.decode.transducer import assemble_events, viterbi_decode_batch
from scrappie_torch import ops
from scrappie_torch.device import float_tensor
from scrappie_torch.models.calibration import collapsed
from scrappie_torch.models.convert import basecaller_spec
from scrappie_torch.models.ensemble import fused_config, validate_ensemble
from scrappie_torch.ops.pipeline import (ensemble_basecall_fused,
                                         rnnrf_ensemble_basecall_fused)
from scrappie_torch.ops.crf import (NS, add_emit_bias, crf_posterior_tm,
                                    crf_viterbi_tm)
from scrappie_torch.parallel import chunk as chunklib
from scrappie_torch.parallel.sharding import (gather_rows, load_replicas,
                                              resolve_mesh, round_batch,
                                              split_rows)
from scrappie_torch.post.homopolymer import HomopolymerMode, homopolymer_path
from scrappie_torch.post.overlapper import overlapper
from scrappie_torch.post.quality import (QUAL_RECAL, crf_qualities,
                                         qualities_from_stream,
                                         recalibrate_phred,
                                         transducer_qualities)
from scrappie_torch.signal.events import detect_events
from scrappie_torch.signal.features import nanonet_features_from_events
from scrappie_torch.signal.trim import trim_and_segment_raw
from scrappie_torch.types import RawSignal
from scrappie_torch.utils.maths import medmad_normalise
from scrappie_torch.utils.validate import checked, raise_pending
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
    qual: str | None = None  # Phred+33, only with with_qualities=True
    events: object | None = None  # annotated EventTable (events model only)


#: Device batches in flight before the host waits for the oldest one's
#: results: the host prepares batch k+1 while the device computes batch k.
PIPELINE_DEPTH = 2
#: Whole-read decodes are padded with neutral blocks to a multiple of this
#: many blocks, so reads of similar length decode together.
DECODE_BUCKET = 1024
#: The reads of one forward-backward launch (rnnrf's qualities) are padded
#: to its longest; a read joins a launch only while the launch's blocks,
#: padding included, stay within this many times its reads' own.
CRF_PAD_RATIO = 2


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


def crf_groups(lengths) -> list[list[int]]:
    """The launches of posterior_crf_batch for reads of these lengths (in
    blocks): their indices, longest first, a new launch wherever the next
    read would take the current one's padded blocks past CRF_PAD_RATIO
    times its real ones. A call thus holds at most CRF_PAD_RATIO times the
    sum of its reads' lengths on the card, however skewed they are."""
    groups: list[list[int]] = []
    real = 0
    for i in sorted(range(len(lengths)), key=lambda i: -lengths[i]):
        if groups and (lengths[groups[-1][0]] * (len(groups[-1]) + 1)
                       <= CRF_PAD_RATIO * (real + lengths[i])):
            groups[-1].append(i)
            real += lengths[i]
        else:
            groups.append([i])
            real = lengths[i]
    return groups


def posterior_crf_padded(trans_list, device) -> list[np.ndarray]:
    """decode/crf.posterior_crf of reads' transitions [T_i, 25] (numpy) in
    one launch -> each read's [T_i + 1, 5]: one copy to `device` of the
    reads and a stitch pad block (chunk.neutral_pad_crf's), one gather
    padding each read to the longest with that block, time-major as the
    kernels take it, one forward-backward over [T, B, 25] and one copy
    back. A pad block's moves go into blank alone, at cost 0, so the walk
    back reaches a read's last real boundary with five equal scores, as
    its own call starts: each read's rows equal posterior_crf's bit for
    bit."""
    lengths = np.array([len(t) for t in trans_list])
    pad = chunklib.neutral_pad_crf(np.empty((0, NS * NS), np.float32), 1)
    flat = float_tensor(np.concatenate([*trans_list, pad]), device)
    starts = np.cumsum(lengths) - lengths
    t = np.arange(lengths.max())[:, None]
    idx = np.where(t < lengths, starts + t, len(flat) - 1)  # [T, B]
    post = crf_posterior_tm(flat[torch.as_tensor(idx, device=flat.device)])
    post = post.cpu().numpy()
    return [post[i, : n + 1] for i, n in enumerate(lengths)]


def posterior_crf_batch(trans_list, device) -> list[np.ndarray]:
    """posterior_crf_padded of every read of an engine call, in the
    launches of crf_groups -> each read's [T_i + 1, 5], in order."""
    out: list = [None] * len(trans_list)
    for group in crf_groups([len(t) for t in trans_list]):
        posts = posterior_crf_padded([trans_list[i] for i in group], device)
        for i, post in zip(group, posts):
            out[i] = post
    return out


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
    """Batched basecalling of many reads on a device mesh.

    mesh: a parallel/sharding.Mesh; device: one device (a one-device
    mesh); with neither, every visible card (sharding.make_mesh()).
    batch_size is the global device batch, rounded up to a multiple of
    the mesh's data axis.

    chunk_len/overlap are in samples (in events for nanonet_events; defaults
    10 000 / 1 000 samples, 2048 / 256 events) and are rounded up to
    multiples of the model stride. mode 'stitch' decodes whole reads from
    stitched chunk posteriors (chunked == unchunked basecall); 'fast'
    decodes each chunk with the fused pipeline and stitches the paths.

    ensemble: extra models of the primary's family (rgrgr and raw_r94, or
    rnnrf) on its block grid, whose outputs are combined with the
    primary's before the decode in every mode; ensemble_weights: one
    weight per model, primary first, default 3:1:...:1, normalised
    (models/ensemble.validate_ensemble).

    qual_calibration: 'raw' (default) gives the posterior-derived Phred
    proxies as they are; 'real' applies the measured recalibration
    (post/quality.QUAL_RECAL): the ensemble configuration's own fit at its
    default weights, else the primary model's."""

    def __init__(self, model: str = "rgrgr_r94", chunk_len: int | None = None,
                 overlap: int | None = None, batch_size: int = 8, device=None,
                 mesh=None, min_prob: float = 1e-5, tempW: float = 1.0,
                 tempb: float = 1.0, mode: str = "stitch", ensemble: tuple[str, ...] = (),
                 ensemble_weights: tuple[float, ...] | None = None,
                 qual_calibration: str = "raw"):
        self.model = model
        self.spec = basecaller_spec(model)
        self.events = self.spec.kind == "events"
        self.ensemble = tuple(ensemble)
        self._ens_w = None
        if self.ensemble or ensemble_weights is not None:
            self._ens_w = validate_ensemble(model, self.ensemble,
                                            ensemble_weights).astype(np.float32)
        if mode not in ("stitch", "fast"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.mesh = resolve_mesh(device, mesh)
        # where the host-stitch path decodes, and the first data device
        self.device = self.mesh.devices[0, 0]
        self._min_prob, self._tempW, self._tempb = min_prob, tempW, tempb
        stride = self.spec.stride
        if chunk_len is None:
            chunk_len = 2048 if self.events else 10000
        if overlap is None:
            overlap = 256 if self.events else 1000
        self.chunk_len = _round_up(chunk_len, stride)
        self.overlap = _round_up(overlap, stride)
        self.batch_size = round_batch(batch_size, self.mesh)
        # replicas[d]: the primary and the members on data row d
        self.replicas = list(zip(*[load_replicas(m, self.mesh)
                                   for m in (model,) + self.ensemble]))
        self.net, self.members = self.replicas[0][0], self.replicas[0][1:]
        # (weights, kinds, conv activations) of the fused transducer ensemble
        self._fused_ens = fused_config(model, self.ensemble, ensemble_weights)
        self._qual_recal_key = self._recal_key(qual_calibration,
                                               ensemble_weights is None)
        self.stage = Stage()

    def _recal_key(self, qual_calibration: str, default_weights: bool):
        """The QUAL_RECAL key of qual_calibration 'real', None for 'raw'."""
        if qual_calibration not in ("raw", "real"):
            raise ValueError(f"unknown qual_calibration {qual_calibration!r}")
        if qual_calibration == "raw":
            return None
        # the configuration's fit applies at its fitted (default) weights;
        # member order does not change the posterior
        composed = "+".join((self.model,) + tuple(sorted(self.ensemble)))
        if composed in QUAL_RECAL and default_weights:
            return composed
        if self.model not in QUAL_RECAL:
            raise ValueError(f"no measured quality recalibration for "
                             f"{self.model!r} (post/quality.QUAL_RECAL)")
        if self.ensemble:
            log("warn", "no quality recalibration fitted for this ensemble "
                        "configuration; using the primary model's fit",
                config=composed)
        return self.model

    # ------------------------------------------------------------- device

    def _posterior(self, x, r: int = 0):
        """[B, chunk_len, C] on data row r's device -> the (combined) log
        posterior or CRF transitions [B, nblock, nstate] there."""
        out = [net(x, min_prob=self._min_prob, tempW=self._tempW,
                   tempb=self._tempb, return_log=True)
               for net in self.replicas[r]]
        if self._ens_w is None:
            return out[0]
        lp = float(self._ens_w[0]) * out[0]
        for w, member in zip(self._ens_w[1:], out[1:]):
            lp = lp + float(w) * member
        if self.spec.kind == "rnnrf":
            return lp
        return lp - ops.logsumexp(lp, dim=-1)

    def _fused_call(self, stay_pen, skip_pen, local_pen, use_slip,
                    crf_emit_bias, with_qual: bool = False):
        """The fast path of the model kind (ops/pipeline.py), single model
        or ensemble: ([B, chunk_len, C] on data row r's device, r) ->
        (scores [B], paths [B, nblock+1] [, quality stream
        [B, nblock+1, klen] with with_qual, transducers only])."""
        params = [[net.params for net in nets] for nets in self.replicas]
        if self.spec.kind == "rnnrf":
            if self._ens_w is None:
                return lambda x, r: self.replicas[r][0].basecall_fused(
                    x, emit_bias=crf_emit_bias)
            acts = tuple(net.conv_activation for net in self.replicas[0])
            return lambda x, r: rnnrf_ensemble_basecall_fused(
                params[r], self._ens_w, x, conv_activations=acts,
                stride=self.spec.stride, emit_bias=crf_emit_bias)
        decode = dict(min_prob=self._min_prob, tempW=self._tempW,
                      tempb=self._tempb, stay_pen=stay_pen, skip_pen=skip_pen,
                      local_pen=local_pen, use_slip=use_slip,
                      with_qual=with_qual)
        if self._fused_ens is None:
            return lambda x, r: self.replicas[r][0].basecall_fused(x, **decode)
        w, kinds, acts = self._fused_ens
        return lambda x, r: ensemble_basecall_fused(
            params[r], w, x, kinds=kinds, conv_activations=acts,
            stride=self.spec.stride, **decode)

    def _on_mesh(self, rows: np.ndarray, fn) -> list:
        """fn(x, r) on each data row's slice of a device batch ([n,
        chunk_len] raw chunks become [n, chunk_len, 1]; events chunks
        [n, chunk_len, 4] keep their shape) -> the outputs in row order."""
        rows = rows if self.events else rows[..., None]
        return [fn(x, r) for r, x in split_rows(rows, self.mesh.data_devices)]

    def _device_batches(self, all_chunks: np.ndarray):
        for i in range(0, all_chunks.shape[0], self.batch_size):
            yield all_chunks[i : i + self.batch_size]

    def _posterior_chunks(self, all_chunks: np.ndarray) -> np.ndarray:
        """Run [N, chunk_len] chunks through the net; posteriors to the host."""
        outs = []
        pend: collections.deque = collections.deque()
        for rows in self._device_batches(all_chunks):
            pend.append(self._on_mesh(rows, self._posterior))
            if len(pend) >= PIPELINE_DEPTH:
                outs.extend(p.cpu().numpy() for p in pend.popleft())
        outs.extend(p.cpu().numpy() for parts in pend for p in parts)
        raise_pending()  # SCRAPPIE_TORCH_VALIDATE's checks on the card
        return np.concatenate(outs, axis=0)[: all_chunks.shape[0]]

    def _posterior_chunks_device(self, all_chunks: np.ndarray,
                                 device) -> torch.Tensor:
        """Chunk posteriors gathered on `device`: [N, nblock_chunk, ns]
        (each data device's part of a batch copied once)."""
        return gather_rows([p for rows in self._device_batches(all_chunks)
                            for p in self._on_mesh(rows, self._posterior)],
                           device)

    def _decode_chunks_streamed(self, chunk_iter, call):
        """Fused per-chunk decode over an iterator of per-read chunk arrays:
        a device batch is dispatched as soon as batch_size chunks are
        there. Returns (scores [N], paths [N, nblock_chunk+1] int32,
        quality streams [N, nblock_chunk+1, klen] or None), or
        (None, None, None) when the iterator yields nothing."""
        B = self.batch_size
        scores, paths, quals = [], [], []
        pend: collections.deque = collections.deque()

        def collect():
            for out in pend.popleft():
                scores.append(out[0].cpu().numpy())
                raise_pending()  # SCRAPPIE_TORCH_VALIDATE's checks on the card
                paths.append(out[1].cpu().numpy().astype(np.int32))
                if len(out) > 2:
                    quals.append(out[2].cpu().numpy())

        def dispatch(rows):
            pend.append(self._on_mesh(rows, call))
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
            return None, None, None
        return (np.concatenate(scores)[:N], np.concatenate(paths)[:N],
                np.concatenate(quals)[:N] if quals else None)

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
            # SCRAPPIE_TORCH_VALIDATE's checks on the card, for the group
            # collected (which may lag the dispatch by the pipeline depth)
            raise_pending()
            for j, (i, e, _c) in enumerate(group):
                nblock = e[2].nblock_total
                results[i] = (float(scores[j]), paths[j, : nblock + 1].copy())

        gi = ngroup = 0
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
            # the group decodes on one data device, the groups in turn
            device = self.mesh.data_devices[ngroup % len(self.replicas)]
            ngroup += 1
            with self.stage("posterior"):
                post = self._posterior_chunks_device(chunks, device)
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
                idx = torch.as_tensor(flat_idx, device=device)
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

    def _decode_bucketed(self, outputs: list[np.ndarray], pad, decode):
        """Batched decode of host posteriors or CRF transitions, each padded
        to a multiple of DECODE_BUCKET blocks with neutral blocks
        (pad(x, target)) and decoded with reads of the same padded length
        (decode(padded [G, T, ns]) -> numpy scores, paths)
        -> [(score, path [nblock+1])]."""
        order = np.argsort([x.shape[0] for x in outputs])
        results: list = [None] * len(outputs)
        i = 0
        while i < len(order):
            target = _round_up(outputs[order[i]].shape[0], DECODE_BUCKET)
            group = []
            while i < len(order) and outputs[order[i]].shape[0] <= target:
                group.append(order[i])
                i += 1
            scores, paths = decode(np.stack([pad(outputs[g], target)
                                             for g in group]))
            for j, g in enumerate(group):
                nb = outputs[g].shape[0]
                results[g] = (float(scores[j]), paths[j, : nb + 1].copy())
        return results

    def _recal(self, qual: str | None) -> str | None:
        """The measured Phred recalibration, with qual_calibration 'real'."""
        if qual is None or self._qual_recal_key is None:
            return qual
        return recalibrate_phred(qual, self._qual_recal_key)

    def _result(self, rt, et, path, score, nblock: int,
                dwell_correction: bool, qual: str | None = None) -> ReadResult:
        """A read's result from its whole-read path [nblock+1] and its
        qualities, if any; for the events model (nblock = nev), from its
        event table et as well. Timed as the stage "assemble"."""
        with self.stage("assemble"):
            if self.events:
                seq, pos, qual = assemble_events(et, path, self.spec.nstate,
                                                 dwell_correction, qual)
                return ReadResult(rt.uuid, seq, score, nblock, pos, rt.start,
                                  rt.end, rt.n, qual, et)
            pos = np.zeros(nblock + 1, dtype=np.int64)
            if self.spec.kind == "rnnrf":
                seq = crfpath_to_basecall(path, pos)
            else:
                seq = overlapper(path, self.spec.nstate - 1, pos)
            return ReadResult(rt.uuid, seq, score, nblock, pos, rt.start,
                              rt.end, rt.n, qual)

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
                    # SCRAPPIE_TORCH_VALIDATE: a non-finite read is skipped
                    # here, not sent to the card (ref validate_scrappie_matrix,
                    # src/scrappie_matrix.c:138-220)
                    checked(rows, f"read.features[{rs.uuid}]")
                else:
                    rows = medmad_normalise(rt.trimmed)
                    checked(rows, f"read.norm[{rs.uuid}]")
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

            fused_qual = with_qualities and self.spec.kind != "rnnrf"
            if with_qualities and not fused_qual:
                log("warn", "fast mode cannot compute CRF per-base "
                            "qualities (forward-backward needs the "
                            "whole-read transitions); skipping")
            call = self._fused_call(stay_pen, skip_pen, local_pen, use_slip,
                                    crf_emit_bias, with_qual=fused_qual)
            with self.stage("decode_fused"):
                scores, paths, quals = self._decode_chunks_streamed(
                    chunk_iter(), call)
            if scores is None:
                return [_no_call(rs) for rs in signals]
            results = []
            for entry, rs in zip(prepped, signals):
                if entry is None:
                    results.append(_no_call(rs))
                    continue
                rt, et, plan, off = entry
                path = chunklib.stitch_paths(paths[off : off + plan.nchunk], plan)
                qual = None
                if quals is not None:
                    qstream = chunklib.stitch_paths(
                        quals[off : off + plan.nchunk], plan)
                    # an events read emits its first nev entries
                    n = len(et.active) if self.events else len(path)
                    with self.stage("qualities"):
                        qual = self._recal(qualities_from_stream(qstream[:n],
                                                                 path[:n]))
                keep = chunklib.chunk_keep_ranges(plan)
                score = float(sum(
                    scores[off + i] * (hi - lo) / plan.nblock_chunk
                    for i, (lo, hi) in enumerate(keep)))
                results.append(self._result(rt, et, path, score,
                                            plan.nblock_total, dwell_correction,
                                            qual))
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
        if not with_qualities and (self.spec.kind == "rnnrf"
                                   or _no_homopolymer(homopolymer)):
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
        # per-read stitching, bucketed decode, and the homopolymer
        # correction and qualities, which read the whole-read posterior.
        with self.stage("posterior"):
            post = self._posterior_chunks(np.concatenate(all_chunks, axis=0))
        logposts = []
        for entry in prepped:
            if entry is not None:
                _rt, _et, plan, off = entry
                logposts.append(chunklib.stitch_blocks(
                    post[off : off + plan.nchunk], plan))
        with self.stage("decode"):
            if self.spec.kind == "rnnrf":
                decoded = self._decode_bucketed(
                    logposts, chunklib.neutral_pad_crf,
                    lambda x: decode_crf(x, emit_bias=crf_emit_bias,
                                         device=self.device))
            else:
                decoded = self._decode_bucketed(
                    logposts,
                    lambda lp, t: chunklib.neutral_pad_logpost(lp, t, stay_pen),
                    lambda x: [t.cpu().numpy() for t in viterbi_decode_batch(
                        torch.as_tensor(x, device=self.device), stay_pen,
                        skip_pen, local_pen, use_slip)])
        mode = (HomopolymerMode.parse(homopolymer)
                if isinstance(homopolymer, str) else homopolymer)
        crf_states = iter(())
        if with_qualities and self.spec.kind == "rnnrf":
            # every read's forward-backward in a few launches; the emit
            # bias calibrates the decode, not the model's reported confidence
            with self.stage("posterior_crf"):
                crf_states = iter(posterior_crf_batch(logposts,
                                                      device=self.device))
        results = []
        lps, decoded = iter(logposts), iter(decoded)
        for entry, rs in zip(prepped, signals):
            if entry is None:
                results.append(_no_call(rs))
                continue
            rt, et = entry[:2]
            lp = next(lps)
            score, path = next(decoded)
            nblock = lp.shape[0]
            qual = None
            if self.events:  # an events read emits its first nev entries
                emitted = path[: len(et.active)]
            elif self.spec.kind != "rnnrf":
                path = emitted = homopolymer_path(lp, np.asarray(path).copy(),
                                                  mode)
            if with_qualities and self.spec.kind == "rnnrf":
                with self.stage("qualities"):
                    qual = self._recal(crf_qualities(next(crf_states), path))
            elif with_qualities:
                with self.stage("qualities"):
                    qual = self._recal(transducer_qualities(lp, emitted))
            results.append(self._result(rt, et, path, score, nblock,
                                        dwell_correction, qual))
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
