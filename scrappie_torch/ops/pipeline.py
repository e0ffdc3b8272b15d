"""The fast paths: one call from signal chunks to Viterbi paths.

Counterpart of scrappie_tpu/ops/pipeline.py:

  * rgrgr (rgrgr_basecall_fused, rgrgr_features_tm): conv and ELU (a
    library convolution), one transpose to time-major, the five GRU layers
    (ops/gru.py: projection, then recurrence), the head kernel, which
    writes the [T, B, 1025] log posterior for all blocks at once, the
    Viterbi forward (ops/viterbi.py) and the backtrace.
  * raw_r94 (raw_basecall_fused, raw_features_tm): conv and tanh, then two
    stages of forward and backward GRU layers on the same input combined
    by feedforward2_tanh, then the same head, forward and backtrace with
    the FF3 head.
  * rnnrf (rnnrf_basecall_fused, the features of rnnrf_transitions_tm):
    the same conv and GRU kernel in five residual layers, then the
    globalnorm head (a matmul and the partition kernel), the emit bias and
    the CRF forward and backtrace kernels (ops/crf.py). The transitions
    stay time-major, [T, B, 25] straight from the head's matmul, as the
    CRF kernels take them.
  * events (events_basecall_fused, events_features_tm): window(3) over the
    event features and one transpose to time-major, two stages of forward
    and backward peephole LSTM layers combined by feedforward2_tanh (each
    stage's two layers in one projection and one recurrence launch,
    ops/lstm.lstm_pair_tm), then the same head, forward and backtrace as
    rgrgr, with the FF3 head.
  * ensembles: ensemble_basecall_fused runs the K member stacks (rgrgr or
    raw_r94) and hands their hidden features to the head kernel, which
    combines the K heads' log posteriors (any K), then the forward and
    backtrace; rnnrf_ensemble_basecall_fused sums the members' weighted CRF
    transitions before the CRF kernels.

With `with_qual=True` the transducer paths (rgrgr, raw_r94, events and the
ensembles) also return a quality stream, uint8 [B, T+1, klen]: per path
entry, the Phred+33 code of the decoded kmer's base at each kmer position
(quality_stream_tm, the counterpart of scrappie_tpu/ops/pipeline.py's
_fused_quality_stream, _fused_quality_stream_ens and
_qual_from_kmer_scores). As there, it is computed outside any kernel, in
plain PyTorch: the head's softmax once more from the features, and its
[T, B, nstate] float32 posterior (one per member) is held on the device
while the stream is made. post/quality.qualities_from_stream turns it into
a read's quality string. rnnrf has no such stream (its qualities need the
whole read's forward-backward).

The JAX pipeline fuses the head into the Viterbi kernel; ops/viterbi.py
keeps that kernel (viterbi_fused_tm, viterbi_fused_ens_tm) beside this
route, which decodes the same log posterior. `decode` keywords are the
head's (min_prob, tempW, tempb) and the forward's (stay_pen, skip_pen,
local_pen, use_slip). Unlike the JAX pipeline there is no lane or batch
padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scrappie_torch import ops
from scrappie_torch.models.specs import GRU_DIRS
from scrappie_torch.nn.layers import (conv1d, elu, feedforward2_tanh,
                                      globalnorm_tm, softmax_with_temperature,
                                      window)
from scrappie_torch.ops.crf import add_emit_bias, crf_viterbi_tm
from scrappie_torch.ops.gru import gru_layer_tm
from scrappie_torch.ops.lstm import lstm_pair_tm
from scrappie_torch.ops.viterbi import (head_logpost_tm, viterbi_backtrace_tm,
                                        viterbi_scores_tm)
from scrappie_torch.utils.validate import checked

CONV_ACT = {"elu": elu, "tanh": torch.tanh}
#: The `decode` keywords the head takes; the rest are the forward's.
HEAD_OPTIONS = ("min_prob", "tempW", "tempb")
#: The posterior head of each transducer kind that runs on raw signal.
HEAD_KEYS = {"rgrgr": ("FF_W", "FF_b"), "raw": ("FF3_W", "FF3_b")}


def _conv_tm(params, sig, conv_activation: str, stride: int, kind: str):
    """sig [B, T, 1] -> activated conv features, time-major [nblock, B, C]
    (checked as "<kind>.conv" under SCRAPPIE_TORCH_VALIDATE)."""
    x = CONV_ACT[conv_activation](
        conv1d(sig, params["conv_W"], params["conv_b"], int(stride)))
    return checked(x.transpose(0, 1).contiguous(), f"{kind}.conv")


def _gru(params, x, i: int, d: str):
    pre = f"gru{d.upper()}{i}"
    return gru_layer_tm(x, params[f"{pre}_iW"], params[f"{pre}_b"],
                        params[f"{pre}_sW"], params[f"{pre}_sW2"],
                        reverse=(d == "b"))


def rgrgr_features_tm(params, sig, conv_activation: str = "elu",
                      stride: int = 5):
    """sig [B, T, 1] -> time-major hidden features [nblock, B, S]: conv,
    activation and the five alternating GRU layers (B1 F2 B3 F4 B5)."""
    x = _conv_tm(params, sig, conv_activation, stride, "rgrgr")
    for i, d in enumerate(GRU_DIRS, start=1):
        x = checked(_gru(params, x, i, d), f"rgrgr.gru{d.upper()}{i}",
                    lo=-1.0, hi=1.0)
    return x


def raw_features_tm(params, sig, stride: int = 4):
    """raw_r94: sig [B, T, 1] -> time-major features below the FF3 head
    [nblock, B, 96]: tanh(conv), then per stage the forward and backward
    GRU layers on the same input and feedforward2_tanh over their outputs
    (ref src/networks.c:196-247)."""
    x = _conv_tm(params, sig, "tanh", stride, "raw")
    for layer in (1, 2):
        h = {d: _gru(params, x, layer, d) for d in ("f", "b")}
        x = checked(feedforward2_tanh(h["f"], h["b"], params[f"FF{layer}_Wf"],
                                      params[f"FF{layer}_Wb"],
                                      params[f"FF{layer}_b"]),
                    f"raw.ff2_{layer}", lo=-1.0, hi=1.0)
    return x


def rnnrf_features_tm(params, sig, conv_activation: str = "elu",
                      stride: int = 2):
    """sig [B, T, 1] -> time-major features [nblock, B, 96]: conv,
    activation and five residual GRU layers, x = x + gru(x) (ref
    src/networks.c:567-607). The width stays 96 throughout."""
    x = _conv_tm(params, sig, conv_activation, stride, "rnnrf")
    for i, d in enumerate(GRU_DIRS, start=1):
        x = checked(x + _gru(params, x, i, d), f"rnnrf.res_gru{d.upper()}{i}")
    return x


def wire_path(path):
    """Cast a decoded path to int16 for the device-to-host copy. Every
    entry is a state index below 2^15 or -1, so the cast is exact."""
    return path.to(torch.int16)


def _decode_fused(x, W, bvec, weights=None, with_qual: bool = False,
                  **decode):
    """The head on features x [T, B, S] (with weights [K]: K members'
    features [K, T, B, S], combined), the Viterbi forward on its log
    posterior and the backtrace -> (logscore [B], path [B, T+1] int16),
    and with with_qual the quality stream [B, T+1, klen] uint8."""
    head = {k: decode.pop(k) for k in HEAD_OPTIONS if k in decode}
    lp = head_logpost_tm(x, W, bvec, weights, **head)
    score, path = viterbi_backtrace_tm(*viterbi_scores_tm(lp, **decode))
    if with_qual:
        del lp  # the stream holds its own posterior
        return score, wire_path(path), quality_stream_tm(x, W, bvec, path,
                                                         weights, **head)
    return score, wire_path(path)


def quality_stream_tm(x, W, bvec, path, weights=None, *, min_prob=1e-5,
                      tempW=1.0, tempb=1.0, klen: int = 5):
    """Per-entry quality stream of the fast paths: uint8 [B, T+1, klen].

    x [T, B, S] and the head W [S, nstate], bvec [nstate] of one model, or
    with weights [K] the K members' x [K, T, B, S], W [K, S, nstate],
    bvec [K, nstate]; path [B, T+1], the decoded kmers (-1 = stay). The
    head's softmax is computed again from x, and each entry's base
    marginals come from the robustlog-adjusted kmer posterior
    (min_prob/nstate + (1 - min_prob) p), renormalised over the kmer
    states: for K members, from their weighted log-domain sum
    (scrappie_tpu/ops/pipeline.py:_fused_quality_stream and
    _fused_quality_stream_ens). Entry e >= 1 reads posterior row e-1,
    entry 0 row 0, as post/quality.transducer_qualities."""
    if weights is None:
        nstate = W.shape[1]
        post = softmax_with_temperature(x, W, bvec, tempW, tempb)
        return qual_from_kmer_scores(
            min_prob / nstate + (1.0 - min_prob) * post[..., : nstate - 1],
            path, klen)
    nstate = W.shape[2]
    acc = None
    for k in range(x.shape[0]):
        post = softmax_with_temperature(x[k], W[k], bvec[k], tempW, tempb)
        lk = weights[k] * torch.log(
            min_prob / nstate + (1.0 - min_prob) * post[..., : nstate - 1])
        del post
        acc = lk if acc is None else acc + lk
    return qual_from_kmer_scores(torch.exp(acc - acc.amax(-1, keepdim=True)),
                                 path, klen)


def qual_from_kmer_scores(pkflat, path, klen: int):
    """Unnormalised kmer scores pkflat [T, B, nkmer] -> per-position base
    marginals, gathered along the decoded path [B, T+1] and Phred+33
    encoded as uint8 [B, T+1, klen] (scrappie_tpu/ops/pipeline.py:
    _qual_from_kmer_scores; error floor 1e-6, codes clipped to 0-93)."""
    T, B, nkmer = pkflat.shape
    msum = pkflat.sum(-1)  # [T, B] kmer normaliser
    pk = pkflat.reshape((T, B) + (4,) * klen)
    marg = torch.stack(
        [pk.sum(dim=tuple(a for a in range(2, klen + 2) if a != j + 2))
         for j in range(klen)], dim=2)  # [T, B, klen, 4]
    dev = pkflat.device
    rows = (torch.arange(path.shape[1], device=dev) - 1).clamp(0, T - 1)
    kmer = path.long().clamp(0, nkmer - 1)  # [B, T+1]
    shifts = 2 * (klen - 1 - torch.arange(klen, device=dev))
    digits = (kmer[:, :, None] >> shifts) & 3  # [B, T+1, klen]
    marg_e = marg[rows].transpose(0, 1)  # [B, T+1, klen, 4]
    q = torch.gather(marg_e, 3, digits[..., None])[..., 0]
    q = q / msum[rows].transpose(0, 1)[:, :, None]
    perr = torch.clamp(1.0 - q, 1e-6, 1.0)
    phred = torch.clamp(torch.round(-10.0 * torch.log10(perr)), 0, 93) + 33
    return phred.to(torch.uint8)


def rgrgr_basecall_fused(params, sig, *, conv_activation: str = "elu",
                         stride: int = 5, **decode):
    """sig [B, T, 1] -> (logscore [B], path [B, nblock+1] int16[, quality
    stream [B, nblock+1, 5] uint8 with with_qual=True]).

    Matches rgrgr_posterior followed by the transducer decode, within the
    order of the head's fp32 sums."""
    x = rgrgr_features_tm(params, sig, conv_activation, stride)
    return _decode_fused(x, params["FF_W"], params["FF_b"], **decode)


def raw_basecall_fused(params, sig, *, stride: int = 4, **decode):
    """raw_r94 fast path: sig [B, T, 1] -> (logscore [B], path
    [B, nblock+1] int16[, quality stream with with_qual=True]).

    Matches raw_posterior followed by the transducer decode, within the
    order of the head's fp32 sums."""
    x = raw_features_tm(params, sig, stride)
    return _decode_fused(x, params["FF3_W"], params["FF3_b"], **decode)


def rnnrf_basecall_fused(params, sig, *, conv_activation: str = "elu",
                         stride: int = 2, emit_bias: float = 0.0):
    """rnnrf_r94 fast path: sig [B, T, 1] -> (logscore [B], path
    [B, nblock+1] int16 CRF states).

    Matches rnnrf_transitions followed by decode_crf(emit_bias=...) (ref
    src/networks.c:567-615 and src/decode.c:836-894)."""
    x = rnnrf_features_tm(params, sig, conv_activation, stride)
    trans = add_emit_bias(globalnorm_tm(x, params["FF_W"], params["FF_b"]),
                          emit_bias)
    score, path = crf_viterbi_tm(trans)
    return score, wire_path(path)


def events_features_tm(params, feats, winlen: int = 3):
    """feats [B, nevent, 4] -> time-major features below the head
    [nevent, B, 96]: window, then per stage the forward and backward LSTM
    layers on the same input and feedforward2_tanh over their outputs
    (ref src/networks.c:146-194)."""
    x = window(feats, winlen, 1).transpose(0, 1).contiguous()
    for layer in (1, 2):
        hF, hB = lstm_pair_tm(x, *(lstm_weights(params, d, layer)
                                   for d in ("F", "B")))
        x = checked(feedforward2_tanh(hF, hB, params[f"FF{layer}_Wf"],
                                      params[f"FF{layer}_Wb"],
                                      params[f"FF{layer}_b"]),
                    f"events.ff2_{layer}", lo=-1.0, hi=1.0)
    return x


def lstm_weights(params, d: str, layer: int) -> tuple:
    """(iW, b, sW, peep) of the events network's LSTM layer d ("F" or "B")
    of stage `layer`."""
    return tuple(params[f"lstm{d}{layer}_{k}"] for k in ("iW", "b", "sW", "p"))


def events_basecall_fused(params, feats, *, winlen: int = 3, **decode):
    """nanonet events fast path: feats [B, nevent, 4] -> (logscore [B],
    path [B, nevent+1] int16[, quality stream with with_qual=True]).

    Matches events_posterior followed by the transducer decode, within the
    order of the head's fp32 sums."""
    x = events_features_tm(params, feats, winlen)
    return _decode_fused(x, params["FF3_W"], params["FF3_b"], **decode)


def ensemble_features_tm(params_list, sig, *, kinds, conv_activations,
                         stride: int):
    """The hidden features and heads of K transducer members (primary
    first) on one signal batch sig [B, T, 1] -> (h [K, nblock, B, S],
    W [K, S, nstate], bvec [K, nstate]). A member narrower than the widest
    is padded with zeros, features and head rows alike (every in-repo
    member has S = 96)."""
    xs, Ws, bs = [], [], []
    for p, kind, ca in zip(params_list, kinds, conv_activations):
        if kind == "rgrgr":
            xs.append(rgrgr_features_tm(p, sig, ca, stride))
        elif kind == "raw":
            xs.append(raw_features_tm(p, sig, stride))
        else:
            raise ValueError(f"fused ensemble supports transducer kinds "
                             f"only, got {kind!r}")
        wk, bk = HEAD_KEYS[kind]
        Ws.append(p[wk])
        bs.append(p[bk])
    S = max(x.shape[-1] for x in xs)
    h = torch.stack([F.pad(x, (0, S - x.shape[-1])) for x in xs])
    # the stacked heads once per set of member weights, so that the head
    # kernel's image of them is made once too
    W, bvec = ops.derived(f"ensemble heads {S}", (*Ws, *bs), lambda: (
        torch.stack([F.pad(W, (0, 0, 0, S - W.shape[0])) for W in Ws]),
        torch.stack(bs)))
    return h, W, bvec


def ensemble_basecall_fused(params_list, weights, sig, *, kinds,
                            conv_activations, stride: int = 5, **decode):
    """Transducer-ensemble fast path: the K member stacks, then the head
    kernel, which combines the members' log posteriors (weights [K],
    normalised; a weighted log-domain mean renormalised per block), then
    the Viterbi forward and the backtrace. sig [B, T, 1] ->
    (logscore [B], path [B, nblock+1] int16[, quality stream with
    with_qual=True, from the combined posterior]). kinds and conv_activations
    are per member, primary first; every member shares the primary's
    stride and state space (models/ensemble.validate_ensemble). The calls
    match the stitch-mode ensemble's per-chunk decode."""
    h, W, bvec = ensemble_features_tm(params_list, sig, kinds=kinds,
                                      conv_activations=conv_activations,
                                      stride=stride)
    w = torch.as_tensor(weights, dtype=torch.float32, device=h.device)
    return _decode_fused(h, W, bvec, w, **decode)


def rnnrf_ensemble_basecall_fused(params_list, weights, sig, *,
                                  conv_activations, stride: int = 2,
                                  emit_bias: float = 0.0):
    """CRF-ensemble fast path: the members' globalnorm transitions
    [nblock, B, 25], weighted and summed in member order (a log-domain
    product of experts on the shared CRF states; no renormalisation, the
    CRF is globally normalised), then the emit bias and the CRF kernels.
    sig [B, T, 1] -> (logscore [B], path [B, nblock+1] int16)."""
    trans = None
    for w, p, ca in zip(weights, params_list, conv_activations):
        x = rnnrf_features_tm(p, sig, ca, stride)
        tk = float(w) * globalnorm_tm(x, p["FF_W"], p["FF_b"])
        trans = tk if trans is None else trans + tk
    score, path = crf_viterbi_tm(add_emit_bias(trans, emit_bias))
    return score, wire_path(path)
