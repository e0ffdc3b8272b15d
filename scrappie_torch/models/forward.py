"""Forward passes of the rgrgr networks.

Counterpart of scrappie_tpu/models/forward.py:rgrgr_posterior and
rgrgr_posterior_tm (graph: ref src/networks.c:250-394): conv, ELU (or
tanh), five alternating GRU layers through ops/gru.py, then the
temperature softmax and robustlog over 1025 states.
"""

from __future__ import annotations

import torch
from torch import nn

from scrappie_torch.models.convert import params_from_numpy, rgrgr_spec
from scrappie_torch.nn.layers import robustlog, softmax_with_temperature
from scrappie_torch.ops.pipeline import rgrgr_basecall_fused, rgrgr_features_tm
from scrappie_tpu.models import registry


def rgrgr_posterior_tm(params, sig, *, conv_activation="elu", stride=5,
                       min_prob=1e-5, tempW=1.0, tempb=1.0, return_log=True):
    """sig [B, T, 1] -> (log) posterior [nblock, B, nstate]."""
    x = rgrgr_features_tm(params, sig, conv_activation, stride)
    post = softmax_with_temperature(x, params["FF_W"], params["FF_b"], tempW,
                                    tempb)
    return robustlog(post, min_prob) if return_log else post


def rgrgr_posterior(params, sig, **kwargs):
    """sig [B, T, 1] -> (log) posterior [B, nblock, nstate]."""
    return rgrgr_posterior_tm(params, sig, **kwargs).transpose(0, 1)


class RgrgrModel(nn.Module):
    """An rgrgr network whose weights are buffers on one device."""

    def __init__(self, params: dict[str, torch.Tensor],
                 conv_activation: str = "elu", stride: int = 5):
        super().__init__()
        for name, value in params.items():
            self.register_buffer(name, value)
        self.conv_activation = conv_activation
        self.stride = int(stride)

    @classmethod
    def from_params(cls, params, device=None, *, conv_activation: str = "elu",
                    stride: int = 5) -> "RgrgrModel":
        """From the registry's numpy parameter dict (see convert.py)."""
        return cls(params_from_numpy(params, device), conv_activation, stride)

    @classmethod
    def from_registry(cls, model: str = "rgrgr_r94", device=None) -> "RgrgrModel":
        """The named rgrgr model with the repository's weights."""
        spec = rgrgr_spec(model)
        return cls.from_params(registry.load_params(model), device,
                               conv_activation=spec.conv_activation,
                               stride=spec.stride)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    @property
    def device(self) -> torch.device:
        return self.conv_W.device

    def forward(self, sig, min_prob=1e-5, tempW=1.0, tempb=1.0,
                return_log=True):
        """sig [B, T, 1] -> (log) posterior [B, nblock, nstate]."""
        return rgrgr_posterior(self.params, sig,
                               conv_activation=self.conv_activation,
                               stride=self.stride, min_prob=min_prob,
                               tempW=tempW, tempb=tempb, return_log=return_log)

    def basecall_fused(self, sig, **kwargs):
        """The fast path: sig [B, T, 1] -> (score [B], path [B, nblock+1])."""
        return rgrgr_basecall_fused(self.params, sig,
                                    conv_activation=self.conv_activation,
                                    stride=self.stride, **kwargs)
