"""Public Python API, mirroring scrappie_tpu.api (and the reference
binding, python/scrappy/__init__.py): basecalling with the raw_r94, rgrgr,
rnnrf and events models and with posterior ensembles of raw models,
squiggle prediction, signal-to-squiggle alignment and posterior-to-sequence
mapping.

`calc_post`, `decode_post`, `basecall_raw`, `basecall_events`,
`sequence_to_squiggle`, `map_signal_to_squiggle` and `map_post_to_sequence`
take a `device`: "cuda" (the default) runs the hand-written kernels, "cpu"
their plain twins.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from scrappie_torch.decode import mapping
from scrappie_torch.decode.crf import crfpath_to_basecall, decode_crf, posterior_crf
from scrappie_torch.decode.dtw import squiggle_match_viterbi
from scrappie_torch.decode.transducer import assemble_events, decode_transducer
from scrappie_torch.device import as_device
from scrappie_torch.models.calibration import collapsed
from scrappie_torch.models.convert import raw_spec
from scrappie_torch.models.ensemble import validate_ensemble
from scrappie_torch.models.forward import Network, load_model
from scrappie_torch.models.specs import RAW_MODELS, SQUIGGLE_MODELS
from scrappie_torch.post.homopolymer import HomopolymerMode, homopolymer_path
from scrappie_torch.post.overlapper import overlapper
from scrappie_torch.signal.events import detect_events
from scrappie_torch.signal.features import nanonet_features_from_events
from scrappie_torch.signal.trim import trim_and_segment_raw, trim_raw_by_mad
from scrappie_torch.types import RawSignal
from scrappie_torch.utils.maths import medmad_normalise
from scrappie_torch.utils.tracing import log


def _gsp():
    # (ref python/scrappy/__init__.py:25-44) transducer state-space sizes
    alpha_len = range(4, 8)
    kmer_len = range(1, 10)
    pairs = [(a, k) for a, k in itertools.product(alpha_len, kmer_len)]
    lookup = {a**k: (a, k) for a, k in pairs}

    def guess_state_properties(nstate: int):
        """(alphabet size, kmer length) from transducer state count."""
        return lookup[nstate - 1]

    return guess_state_properties


guess_state_properties = _gsp()


class RawTable:
    """Raw-signal container with chained trim/scale (ref RawTable,
    python/scrappy/__init__.py:47-111)."""

    def __init__(self, data, start: int = 0, end: int | None = None):
        self._rs = RawSignal(np.asarray(data, dtype=np.float32), start=start,
                             end=end)

    def data(self, as_numpy: bool = False):
        if as_numpy:
            return self._rs.trimmed.copy()
        return self._rs

    @property
    def start(self) -> int:
        return self._rs.start

    @property
    def end(self) -> int:
        return self._rs.end

    def trim(self, start=200, end=10, varseg_chunk=100, varseg_thresh=0.0):
        rs = trim_raw_by_mad(self._rs, varseg_chunk, varseg_thresh)
        new_start = rs.start + start if (rs.n - rs.start) > start else rs.n
        new_end = rs.end - end if rs.end > end else 0
        if new_start >= new_end:
            new_start, new_end = 0, 0
        self._rs = RawSignal(rs.raw, start=new_start, end=new_end, uuid=rs.uuid)
        return self

    def scale(self):
        raw = self._rs.raw.copy()
        raw[self._rs.start : self._rs.end] = medmad_normalise(self._rs.trimmed)
        self._rs = RawSignal(raw, self._rs.start, self._rs.end, self._rs.uuid)
        return self


class Posterior:
    """Posterior matrix [nblock, nstate] with the reference's optional
    "sloika" state order (stay first; ref python/scrappy/__init__.py:247-273)."""

    def __init__(self, mat: np.ndarray, model: str):
        self._mat = np.asarray(mat)
        self.model = model

    @property
    def shape(self):
        return self._mat.shape

    def __len__(self):
        return self._mat.shape[0]

    def data(self, as_numpy: bool = False, sloika: bool = True):
        if not as_numpy:
            return self._mat
        if sloika:
            return np.ascontiguousarray(
                np.concatenate([self._mat[:, -1:], self._mat[:, :-1]], axis=1))
        return self._mat.copy()


@functools.lru_cache(maxsize=None)
def _model(model: str, device: torch.device) -> Network:
    return load_model(model, device)


def calc_post(rt: RawTable, model: str = "rgrgr_r94", min_prob: float = 1e-6,
              log: bool = True, tempW: float = 1.0, tempb: float = 1.0,
              device=None) -> Posterior:
    """Run a raw model over a (trimmed, scaled) RawTable (ref calc_post,
    python/scrappy/__init__.py:276-298): the log posterior of raw_r94 or an
    rgrgr model, or the CRF transitions of rnnrf_r94, for which min_prob
    and the temperatures do not apply."""
    if not log and model == "rnnrf_r94":
        raise ValueError("Returning non-log transformed matrix not supported "
                         "for model type 'rnnrf_r94'.")
    if not isinstance(rt, RawTable):
        raise TypeError("`rt` should be a RawTable.")
    raw_spec(model)
    net = _model(model, as_device(device))
    sig = torch.as_tensor(rt.data(as_numpy=True).reshape(1, -1, 1),
                          device=net.device)
    with torch.no_grad():
        out = net(sig, min_prob=min_prob, tempW=tempW, tempb=tempb,
                  return_log=log)
    return Posterior(out[0].cpu().numpy(), model)


def _decode_post_transducer(post: Posterior, stay_pen=0.0, skip_pen=0.0,
                            local_pen=2.0, use_slip=False,
                            homopolymer: str | HomopolymerMode | None = None,
                            device=None):
    nblock, nstate = post.shape
    score, path = decode_transducer(post.data(), stay_pen, skip_pen, local_pen,
                                    use_slip, device=device)
    path = np.asarray(path).copy()
    if homopolymer is not None:
        mode = (HomopolymerMode.parse(homopolymer)
                if isinstance(homopolymer, str) else homopolymer)
        path = homopolymer_path(post.data(), path, mode)
    pos = np.zeros(nblock + 1, dtype=np.int64)
    seq = overlapper(path, nstate - 1, pos)

    # Decode-collapse guard (scrappie_tpu/models/calibration.py): a
    # positive skip penalty can absorb a read into the local states;
    # re-decode with skip_pen=0 instead of returning the collapsed call.
    if skip_pen > 0:
        if collapsed(len(seq or ""), nblock, post.model):
            log("warn", "decode collapsed; re-decoding with skip_pen=0",
                nbases=len(seq or ""), nblock=nblock, skip_pen=skip_pen)
            return _decode_post_transducer(post, stay_pen, 0.0, local_pen,
                                           use_slip, homopolymer, device)
    return seq, float(score), pos


def _decode_post_crf(post: Posterior, emit_bias: float = 0.0, device=None):
    nblock, _ = post.shape
    score, path = decode_crf(post.data(), emit_bias=emit_bias, device=device)
    pos = np.zeros(nblock + 1, dtype=np.int64)
    seq = crfpath_to_basecall(path[: nblock + 1], pos)
    return seq, float(score), pos


def decode_post(post: Posterior, model: str = "rgrgr_r94", device=None,
                **kwargs):
    """Decode a posterior (or rnnrf transitions) into (basecall, score,
    block positions) (ref decode_post, python/scrappy/__init__.py:300-319).
    The keywords are the decoder's: stay_pen, skip_pen, local_pen,
    use_slip and homopolymer for rgrgr; emit_bias for rnnrf."""
    if not isinstance(post, Posterior):
        raise TypeError("`post` should be a Posterior.")
    if raw_spec(model).kind == "rnnrf":
        return _decode_post_crf(post, device=device, **kwargs)
    return _decode_post_transducer(post, device=device, **kwargs)


def basecall_raw(data, model: str = "rgrgr_r94", with_base_probs: bool = False,
                 calibration: str = "reference", ensemble: tuple[str, ...] = (),
                 ensemble_weights: tuple[float, ...] | None = None, device=None,
                 **kwargs):
    """Trim, scale, run the network, decode: one read end to end.

    Returns (sequence, score, block positions, trim start, trim end, base
    probabilities or None); ref basecall_raw,
    python/scrappy/__init__.py:403-430. with_base_probs (rnnrf_r94 only)
    gives the CRF's forward-backward state posterior [nblock+1, 5].
    ``calibration="real"`` fills the measured decode preset
    (models/calibration.py) for knobs not passed. ``ensemble`` decodes the
    members' posteriors combined with the model's, as
    BasecallEngine(ensemble=...) validates and combines them, here in
    float64 on the host and cast to float32 (scrappie_tpu.api's numpy
    combination)."""
    if with_base_probs and model != "rnnrf_r94":
        raise ValueError("Base probabilities can only be returned for model "
                         "'rnnrf_r94'.")
    spec = raw_spec(model)
    device = as_device(device)
    ensemble = tuple(ensemble)
    w = (validate_ensemble(model, ensemble, ensemble_weights)
         if ensemble or ensemble_weights is not None else None)
    if calibration != "reference":
        from scrappie_torch.models import calibration as _calibration

        for key, value in _calibration.preset(model, calibration,
                                              ensemble).items():
            # the CRF decoder spells the emit-bias knob `emit_bias`
            kwargs.setdefault("emit_bias" if key == "crf_emit_bias" else key,
                              value)
    raw = RawTable(data)
    raw.trim().scale()
    post = calc_post(raw, model, log=True, device=device)
    if w is not None:
        lp = w[0] * post.data()
        for wi, m in zip(w[1:], ensemble):
            lp = lp + wi * calc_post(raw, m, log=True, device=device).data()
        if spec.kind != "rnnrf":
            # CRF members are transition energies: their weighted mean is
            # the whole combination (models/ensemble.py)
            lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        post = Posterior(lp.astype(np.float32), model)
    seq, score, pos = decode_post(post, model, device=device, **kwargs)
    base_probs = (posterior_crf(post.data(), device=device) if with_base_probs
                  else None)
    return seq, score, pos, raw.start, raw.end, base_probs


def basecall_events(data, *, trim_start=200, trim_end=10, varseg_chunk=100,
                    varseg_thresh=0.0, min_prob=1e-5, tempW=1.0, tempb=1.0,
                    stay_pen=0.0, skip_pen=0.0, local_pen=2.0, use_slip=False,
                    dwell_correction=True, calibration: str = "reference",
                    device=None):
    """Events pipeline: event detection, the nanonet biLSTM network,
    transducer decode and the optional dwell homopolymer correction, for
    one read (ref src/scrappie_events.c:271-344).

    Returns (sequence, score, annotated EventTable, trim start, trim end).
    ``calibration="real"`` fills the measured stay/skip preset for knobs
    left at their reference defaults (models/calibration.py)."""
    device = as_device(device)
    if calibration != "reference":
        from scrappie_torch.models import calibration as _calibration

        knobs = _calibration.apply("nanonet_events", calibration,
                                   {"stay_pen": stay_pen, "skip_pen": skip_pen})
        stay_pen, skip_pen = knobs["stay_pen"], knobs["skip_pen"]
    rt = trim_and_segment_raw(RawSignal(np.asarray(data, dtype=np.float32)),
                              trim_start, trim_end, varseg_chunk, varseg_thresh)
    if rt is None:
        return None, float("nan"), None, 0, 0
    et = detect_events(rt)
    feats = nanonet_features_from_events(et, normalise=True)
    net = _model("nanonet_events", device)
    with torch.no_grad():
        # the log posterior stays on the device; only the path comes back
        lp = net(torch.as_tensor(feats[None], device=net.device),
                 min_prob=min_prob, tempW=tempW, tempb=tempb)[0]
    nev, nstate = lp.shape
    score, path = decode_transducer(lp, stay_pen, skip_pen, local_pen, use_slip)
    # Decode-collapse guard (models/calibration.py): re-decode the same
    # posterior with skip_pen=0 instead of returning a collapsed call.
    if skip_pen > 0:
        nbases = len(overlapper(path[:nev], nstate - 1) or "")
        if collapsed(nbases, nev, "nanonet_events"):
            log("warn", "events decode collapsed; re-decoding with skip_pen=0",
                nbases=nbases, nev=nev, skip_pen=skip_pen)
            score, path = decode_transducer(lp, stay_pen, 0.0, local_pen,
                                            use_slip)
    seq, _pos, _ = assemble_events(et, path, nstate, dwell_correction)
    return seq, float(score), et, rt.start, rt.end


def get_model_stride(model: str) -> int:
    """Stride of a raw model (ref get_raw_model_stride,
    src/networks.c:87-106)."""
    try:
        return RAW_MODELS[model].stride
    except KeyError:
        raise ValueError(f"Invalid model {model!r}") from None


_base_to_int = {c: i for i, c in enumerate("ACGT")}


def encode_bases(sequence: str, state_len: int = 1) -> np.ndarray:
    """Rolling kmer encoding of a base string (ref encode_bases_to_integers,
    src/scrappie_seq_helpers.c:53-74; first base most significant)."""
    try:
        enc = np.array([_base_to_int[b] for b in sequence.upper()],
                       dtype=np.int64)
    except KeyError as e:
        raise ValueError(f"sequence contains non-ACGT base {e.args[0]!r}") from None
    n = len(enc) - state_len + 1
    if n <= 0:
        raise ValueError("sequence shorter than state length")
    out = np.zeros(n, dtype=np.int64)
    for j in range(state_len):
        out = out * 4 + enc[j : j + n]
    return out


def sequence_to_squiggle(sequence: str, model: str = "squiggle_r94",
                         rescale: bool = False, device=None) -> np.ndarray:
    """Predict (current, sd, dwell) per base of `sequence` [N, 3] (ref
    sequence_to_squiggle, python/scrappy/__init__.py:433-459).
    rescale=True applies the unit transform (sd = exp(log sd), dwell =
    exp(-x)) as the CLI's --rescale does; else the columns are (current,
    log sd, -log dwell)."""
    if model not in SQUIGGLE_MODELS:
        raise KeyError(f"Squiggle model type {model!r} not recognised.")
    seq = encode_bases(sequence, 1).astype(np.int32)
    net = _model(model, as_device(device))
    with torch.no_grad():
        out = net(torch.as_tensor(seq, device=net.device),
                  transform_units=rescale)
    return out.cpu().numpy()


def map_signal_to_squiggle(data, sequence: str, model: str = "squiggle_r94",
                           rate: float = 1.0, back_prob: float = 0.0,
                           local_pen: float = 2.0, skip_pen: float = 5000.0,
                           min_score: float = 5.0, device=None):
    """Align raw signal to the predicted squiggle of `sequence` by DTW (ref
    map_signal_to_squiggle, python/scrappy/__init__.py:462-489). Returns
    (score, path over the FULL input with -1 outside the trimmed/mapped
    region)."""
    device = as_device(device)
    raw = RawTable(data)
    raw.trim().scale()
    squiggle = sequence_to_squiggle(sequence, model=model, rescale=False,
                                    device=device)
    score, path = squiggle_match_viterbi(
        raw.data(as_numpy=True), squiggle, rate=rate, prob_back=back_prob,
        local_pen=local_pen, skip_pen=skip_pen, minscore=min_score,
        device=device)
    full_path = np.full(len(np.asarray(data)), -1, dtype=np.int32)
    full_path[raw.start : raw.end] = path
    return score, full_path


def map_post_to_sequence(post: Posterior, sequence: str, stay_pen=0.0,
                         skip_pen=0.0, local_pen=4.0, viterbi=False,
                         path=False, bands=None, device=None):
    """Local-global alignment of a basecall posterior to a reference
    sequence (ref map_post_to_sequence, python/scrappy/__init__.py:492-578).

    bands: None (full DP), an int half-width (diagonal band), or a
    (low, high) pair of arrays. Returns (score, path or None)."""
    if path and not viterbi:
        raise ValueError("Cannot calculate path with `viterbi==False`.")
    if not isinstance(post, Posterior):
        raise TypeError("`post` should be a Posterior.")
    device = as_device(device)

    nblock, nstate = post.shape
    _, kmer_len = guess_state_properties(nstate)
    seq = encode_bases(sequence, kmer_len)
    seqlen = len(seq)

    if bands is None:
        if viterbi:
            res = mapping.map_to_sequence_viterbi(
                post.data(), seq, stay_pen, skip_pen, local_pen,
                want_path=path, device=device)
            score, p = res if path else (res, None)
        else:
            score = mapping.map_to_sequence_forward(
                post.data(), seq, stay_pen, skip_pen, local_pen, device=device)
            p = None
        return score, p

    if isinstance(bands, int):
        gradient = seqlen / nblock
        half = bands * gradient
        low = np.maximum(0, (np.arange(nblock) * gradient - half)).astype(np.int64)
        high = np.minimum(seqlen, (np.arange(nblock) * gradient + half)).astype(np.int64)
        # Invariants required by are_bounds_sane
        low[0] = 0
        high[-1] = seqlen
        bands = (low, high)
    elif len(bands) != 2:
        raise ValueError("`bands` should be `None`, an integer, or length 2.")
    low, high = (np.asarray(b, dtype=np.int64) for b in bands)
    if not mapping.are_bounds_sane(low, high, nblock, seqlen):
        raise ValueError("Supplied banding structure is not valid.")
    score = mapping.map_to_sequence_banded(
        post.data(), seq, low, high, stay_pen, skip_pen, local_pen,
        viterbi=viterbi, device=device)
    return score, None
