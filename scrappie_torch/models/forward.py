"""Forward passes of the rgrgr, raw_r94, rnnrf, events and squiggle
networks.

Counterpart of scrappie_tpu/models/forward.py:
  * rgrgr_posterior and rgrgr_posterior_tm (graph: ref
    src/networks.c:250-394): conv, ELU (or tanh), five alternating GRU
    layers through ops/gru.py, then the temperature softmax and robustlog
    over 1025 states;
  * raw_posterior and raw_posterior_tm (ref src/networks.c:196-247): conv,
    tanh, two stages of forward and backward GRU layers through ops/gru.py
    combined by feedforward2_tanh, then the FF3 head's temperature softmax
    and robustlog over 1025 states;
  * rnnrf_transitions, rnnrf_transitions_tm and rnnrf_features (ref
    src/networks.c:567-615): conv, ELU, five residual GRU layers, then the
    globalnorm CRF head over 25 transitions, always in log space;
  * events_posterior and events_posterior_tm (ref src/networks.c:146-194):
    window(3) over 4 event features, two stages of forward and backward
    peephole LSTMs through ops/lstm.py combined by feedforward2_tanh, then
    the temperature softmax and robustlog over 1025 states;
  * squiggle_forward (ref src/networks.c:397-451): an embedding of the
    bases, tanh(conv), four residual tanh convolutions and a last
    convolution to (current, log sd, -log dwell) per base, optionally with
    the unit transform. The convolutions are library calls (`F.conv1d`,
    under the precision policy of nn/config.py), as the JAX package leaves
    them to XLA.

With SCRAPPIE_TORCH_VALIDATE set, utils/validate.checked checks each
layer's output (ops/pipeline.py) and each network's last one here, at the
counterparts of the JAX package's checked() sites.
"""

from __future__ import annotations

import torch
from torch import nn

from scrappie_torch.models import registry
from scrappie_torch.models.convert import model_spec, params_from_numpy
from scrappie_torch.nn.layers import (StateShards, conv1d, embedding,
                                      globalnorm_tm, robustlog,
                                      softmax_with_temperature)
from scrappie_torch.ops.pipeline import (
    events_basecall_fused,
    events_features_tm,
    raw_basecall_fused,
    raw_features_tm,
    rgrgr_basecall_fused,
    rgrgr_features_tm,
    rnnrf_basecall_fused,
    rnnrf_features_tm,
)
from scrappie_torch.utils.validate import checked


def rgrgr_posterior_tm(params, sig, *, conv_activation="elu", stride=5,
                       min_prob=1e-5, tempW=1.0, tempb=1.0, return_log=True):
    """sig [B, T, 1] -> (log) posterior [nblock, B, nstate]."""
    x = rgrgr_features_tm(params, sig, conv_activation, stride)
    post = checked(softmax_with_temperature(x, params["FF_W"], params["FF_b"],
                                            tempW, tempb),
                   "rgrgr.softmax", lo=0.0, hi=1.0)
    return robustlog(post, min_prob) if return_log else post


def rgrgr_posterior(params, sig, **kwargs):
    """sig [B, T, 1] -> (log) posterior [B, nblock, nstate]."""
    return rgrgr_posterior_tm(params, sig, **kwargs).transpose(0, 1)


def raw_posterior_tm(params, sig, *, stride=4, min_prob=1e-5, tempW=1.0,
                     tempb=1.0, return_log=True):
    """raw_r94: sig [B, T, 1] -> (log) posterior [nblock, B, nstate]."""
    x = raw_features_tm(params, sig, stride)
    post = checked(softmax_with_temperature(x, params["FF3_W"],
                                            params["FF3_b"], tempW, tempb),
                   "raw.softmax", lo=0.0, hi=1.0)
    return robustlog(post, min_prob) if return_log else post


def raw_posterior(params, sig, **kwargs):
    """raw_r94: sig [B, T, 1] -> (log) posterior [B, nblock, nstate]."""
    return raw_posterior_tm(params, sig, **kwargs).transpose(0, 1)


def rnnrf_transitions_tm(params, sig, *, conv_activation="elu", stride=2):
    """sig [B, T, 1] -> CRF transitions [nblock, B, 25], time-major."""
    x = rnnrf_features_tm(params, sig, conv_activation, stride)
    return checked(globalnorm_tm(x, params["FF_W"], params["FF_b"]),
                   "rnnrf.globalnorm")


def rnnrf_transitions(params, sig, *, conv_activation="elu", stride=2,
                      min_prob=1e-5, tempW=1.0, tempb=1.0, return_log=True):
    """sig [B, T, 1] -> CRF transitions [B, nblock, 25]. Always log space:
    min_prob and the temperatures do not apply, as in scrappie_tpu."""
    del min_prob, tempW, tempb
    if not return_log:
        raise ValueError("rnnrf transitions are always log-space")
    return rnnrf_transitions_tm(params, sig, conv_activation=conv_activation,
                                stride=stride).transpose(0, 1)


def rnnrf_features(params, sig, *, conv_activation="elu", stride=2):
    """sig [B, T, 1] -> the features below the CRF head, [B, nblock, 96]."""
    return rnnrf_features_tm(params, sig, conv_activation,
                             stride).transpose(0, 1)


def events_posterior_tm(params, feats, *, winlen=3, min_prob=1e-5, tempW=1.0,
                        tempb=1.0, return_log=True):
    """feats [B, nevent, 4] -> (log) posterior [nevent, B, nstate]."""
    x = events_features_tm(params, feats, winlen)
    post = checked(softmax_with_temperature(x, params["FF3_W"],
                                            params["FF3_b"], tempW, tempb),
                   "events.softmax", lo=0.0, hi=1.0)
    return robustlog(post, min_prob) if return_log else post


def events_posterior(params, feats, **kwargs):
    """feats [B, nevent, 4] -> (log) posterior [B, nevent, nstate]."""
    return events_posterior_tm(params, feats, **kwargs).transpose(0, 1)


def squiggle_forward(params, seq, *, transform_units=True):
    """seq [..., N] int bases (0-3 for ACGT) -> predicted squiggle
    [..., N, 3]: (current, sd, dwell in samples) with transform_units, else
    (current, log sd, -log dwell). params holds each conv's weights and its
    stride (`conv{k}_stride`, an int or a one-element tensor)."""
    stride = lambda k: int(params[f"conv{k}_stride"])
    x = embedding(seq, params["embed_W"])
    x = torch.tanh(conv1d(x, params["conv1_W"], params["conv1_b"], stride(1)))
    for k in range(2, 6):
        x = x + torch.tanh(conv1d(x, params[f"conv{k}_W"], params[f"conv{k}_b"],
                                  stride(k)))
    out = checked(conv1d(x, params["conv6_W"], params["conv6_b"], stride(6)),
                  "squiggle.conv6")
    if transform_units:
        out = torch.cat([out[..., 0:1], torch.exp(out[..., 1:2]),
                         torch.exp(-out[..., 2:3])], dim=-1)
    return out


class Network(nn.Module):
    """A network whose weights are buffers on one device. On a mesh with a
    'state' axis (parallel/sharding.load_replicas), `state_shards` also
    holds the output layer's weight split over the row's state devices:
    the posterior paths (forward) read it there, the fused paths read the
    whole buffer."""

    kind: str
    default_model: str

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name, value in params.items():
            self.register_buffer(name, value)
        self.state_shards: dict[str, StateShards] = {}

    @classmethod
    def _spec(cls, model: str | None):
        """The spec of the named model, which must be of this class's
        kind."""
        spec = model_spec(cls.default_model if model is None else model)
        if spec.kind != cls.kind:
            raise ValueError(f"{spec.name!r} is an {spec.kind} model, not "
                             f"{cls.kind}")
        return spec

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    @property
    def posterior_params(self) -> dict:
        """params, with state_shards in place of the weights they split."""
        return {**self.params, **self.state_shards}

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device


class RawModel(Network):
    """A raw-signal network."""

    default_stride: int

    def __init__(self, params: dict[str, torch.Tensor],
                 conv_activation: str = "elu", stride: int | None = None):
        super().__init__(params)
        self.conv_activation = conv_activation
        self.stride = int(self.default_stride if stride is None else stride)

    @classmethod
    def from_params(cls, params, device=None, *, conv_activation: str = "elu",
                    stride: int | None = None):
        """From the registry's numpy parameter dict (see convert.py)."""
        return cls(params_from_numpy(params, device), conv_activation, stride)

    @classmethod
    def from_registry(cls, model: str | None = None, device=None):
        """The named model, of this class's kind, with the repository's
        weights."""
        spec = cls._spec(model)
        return cls.from_params(registry.load_params(spec.name), device,
                               conv_activation=spec.conv_activation,
                               stride=spec.stride)


class RgrgrModel(RawModel):
    """rgrgr_{r94,r941,r10}: a 1025-state transducer posterior."""

    kind = "rgrgr"
    default_model = "rgrgr_r94"
    default_stride = 5

    def forward(self, sig, min_prob=1e-5, tempW=1.0, tempb=1.0,
                return_log=True):
        """sig [B, T, 1] -> (log) posterior [B, nblock, nstate]."""
        return rgrgr_posterior(self.posterior_params, sig,
                               conv_activation=self.conv_activation,
                               stride=self.stride, min_prob=min_prob,
                               tempW=tempW, tempb=tempb, return_log=return_log)

    def basecall_fused(self, sig, **kwargs):
        """The fast path: sig [B, T, 1] -> (score [B], path [B, nblock+1])."""
        return rgrgr_basecall_fused(self.params, sig,
                                    conv_activation=self.conv_activation,
                                    stride=self.stride, **kwargs)


class RawR94Model(RawModel):
    """raw_r94: a 1025-state transducer posterior from bidirectional GRU
    stages."""

    kind = "raw"
    default_model = "raw_r94"
    default_stride = 4

    def forward(self, sig, min_prob=1e-5, tempW=1.0, tempb=1.0,
                return_log=True):
        """sig [B, T, 1] -> (log) posterior [B, nblock, nstate]."""
        return raw_posterior(self.posterior_params, sig, stride=self.stride,
                             min_prob=min_prob, tempW=tempW, tempb=tempb,
                             return_log=return_log)

    def basecall_fused(self, sig, **kwargs):
        """The fast path: sig [B, T, 1] -> (score [B], path [B, nblock+1])."""
        return raw_basecall_fused(self.params, sig, stride=self.stride,
                                  **kwargs)


class RnnrfModel(RawModel):
    """rnnrf_r94: CRF transitions over 5 states."""

    kind = "rnnrf"
    default_model = "rnnrf_r94"
    default_stride = 2

    def forward(self, sig, min_prob=1e-5, tempW=1.0, tempb=1.0,
                return_log=True):
        """sig [B, T, 1] -> CRF transitions [B, nblock, 25]."""
        return rnnrf_transitions(self.posterior_params, sig,
                                 conv_activation=self.conv_activation,
                                 stride=self.stride, min_prob=min_prob,
                                 tempW=tempW, tempb=tempb,
                                 return_log=return_log)

    def basecall_fused(self, sig, emit_bias: float = 0.0):
        """The fast path: sig [B, T, 1] -> (score [B], path [B, nblock+1])."""
        return rnnrf_basecall_fused(self.params, sig,
                                    conv_activation=self.conv_activation,
                                    stride=self.stride, emit_bias=emit_bias)


class EventsModel(Network):
    """nanonet_events: a 1025-state transducer posterior over detected
    events, from their features [B, nevent, 4]."""

    kind = "events"
    default_model = "nanonet_events"

    def __init__(self, params: dict[str, torch.Tensor], winlen: int = 3):
        super().__init__(params)
        self.winlen = int(winlen)

    @classmethod
    def from_registry(cls, model: str | None = None, device=None):
        """The events model with the repository's weights."""
        spec = cls._spec(model)
        return cls(params_from_numpy(registry.load_params(spec.name), device),
                   spec.winlen)

    def forward(self, feats, min_prob=1e-5, tempW=1.0, tempb=1.0,
                return_log=True):
        """feats [B, nevent, 4] -> (log) posterior [B, nevent, nstate]."""
        return events_posterior(self.posterior_params, feats, winlen=self.winlen,
                                min_prob=min_prob, tempW=tempW, tempb=tempb,
                                return_log=return_log)

    def basecall_fused(self, feats, **kwargs):
        """The fast path: feats [B, nevent, 4] -> (score [B], path
        [B, nevent+1])."""
        return events_basecall_fused(self.params, feats, winlen=self.winlen,
                                     **kwargs)


class SquiggleModel(Network):
    """squiggle_{r94,r94_rna,r10}: a base sequence -> its predicted squiggle.
    The convolutions' strides are kept as ints, not buffers."""

    kind = "squiggle"
    default_model = "squiggle_r94"

    def __init__(self, params: dict[str, torch.Tensor], strides: dict[str, int]):
        super().__init__(params)
        self.strides = dict(strides)

    @classmethod
    def from_registry(cls, model: str | None = None, device=None):
        """The named squiggle model with the repository's weights."""
        params = registry.load_params(cls._spec(model).name)
        strides = {k: int(v) for k, v in params.items() if k.endswith("_stride")}
        weights = {k: v for k, v in params.items() if k not in strides}
        return cls(params_from_numpy(weights, device), strides)

    def forward(self, seq, transform_units=True):
        """seq [..., N] int bases -> squiggle [..., N, 3]."""
        return squiggle_forward({**self.params, **self.strides}, seq,
                                transform_units=transform_units)


_MODELS = {cls.kind: cls for cls in (RgrgrModel, RawR94Model, RnnrfModel,
                                     EventsModel, SquiggleModel)}


def load_model(model: str, device=None) -> Network:
    """The named model with the repository's weights, as the class of its
    kind."""
    return _MODELS[model_spec(model).kind].from_registry(model, device)


def network_of(model: str, params: dict[str, torch.Tensor]) -> Network:
    """The named basecaller's network over parameters already placed
    (tensors on their device)."""
    spec = model_spec(model)
    if spec.kind == "squiggle":
        raise ValueError(f"{model!r} is not a basecaller")
    if spec.kind == "events":
        return EventsModel(params, spec.winlen)
    return _MODELS[spec.kind](params, spec.conv_activation, spec.stride)
