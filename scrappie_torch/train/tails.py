"""Strict held-out-tail identity of a model's weights.

Counterpart of scrappie_tpu/train/tails.py, through the port's networks and
decoders. Protocol: the tail 25% of each bundled truth read (the region
no training window touches) is basecalled with the plain per-model forward
and the default decode. Emission layouts match the production pipelines:
transducers emit the whole (nblock+1)-entry path through the overlapper;
the events model emits the first nev path entries (api.basecall_events /
ref src/scrappie_events.c:301). Without bundled reads
(train/realdata.bundled_truth_reads is empty) there is nothing to call:
`tail_identities` returns [] and `mean_tail_identity` NaN, as the JAX
package's do.
"""

from __future__ import annotations

import numpy as np
import torch


def identity(a: str, b: str) -> float:
    """1 - edit distance / the longer length (1.0 for two empty strings)."""
    from scrappie_torch.utils.seqcompare import edit_distance

    return 1.0 - edit_distance(a, b) / max(len(a), len(b), 1)


def tail_identities(model: str, params=None,
                    device=None) -> list[tuple[str, str]]:
    """[(call, truth)] over the bundled reads' strict held-out tails, the
    networks and decoders run on `device` (CUDA unless named)."""
    from scrappie_torch.decode.crf import crfpath_to_basecall, decode_crf
    from scrappie_torch.decode.transducer import decode_transducer
    from scrappie_torch.device import as_device
    from scrappie_torch.models import forward, registry
    from scrappie_torch.models.convert import params_from_numpy
    from scrappie_torch.models.specs import NSTATE_TRANSDUCER, RAW_MODELS
    from scrappie_torch.post.overlapper import overlapper
    from scrappie_torch.train.realdata import (RealEventSampler,
                                               RealReadSampler,
                                               load_labelled_reads)

    dev = as_device(device)
    if params is None:
        params = registry.load_params(model)
    weights = params_from_numpy(params, dev)
    reads = load_labelled_reads("rgrgr_r94", device=dev)
    sampler = (RealEventSampler(reads, seed=0)
               if model == "nanonet_events" else
               RealReadSampler(reads, seed=0))
    out = []
    with torch.inference_mode():
        for ridx in range(len(sampler.reads)):
            if model == "nanonet_events":
                feats, truth = sampler.eval_events(ridx, whole=False)
                if not truth:
                    continue
                x = torch.as_tensor(np.ascontiguousarray(feats, np.float32),
                                    device=dev)[None]
                lp = forward.events_posterior(weights, x, return_log=True)[0]
                _, path = decode_transducer(lp.contiguous(), 0.0, 0.0, 2.0)
                call = overlapper(path[: lp.shape[0]],
                                  NSTATE_TRANSDUCER - 1) or ""
            else:
                spec = RAW_MODELS[model]
                sig, truth = sampler.eval_segment(ridx)
                if not truth:
                    continue
                n = (len(sig) // spec.stride) * spec.stride
                x = torch.as_tensor(np.ascontiguousarray(sig[:n], np.float32),
                                    device=dev)[None, :, None]
                if spec.kind == "rnnrf":
                    trans = forward.rnnrf_transitions(
                        weights, x, conv_activation=spec.conv_activation,
                        stride=spec.stride)
                    _, path = decode_crf(trans.contiguous())
                    call = crfpath_to_basecall(np.asarray(path)[0]) or ""
                else:
                    if spec.kind == "rgrgr":
                        lp = forward.rgrgr_posterior(
                            weights, x, conv_activation=spec.conv_activation,
                            stride=spec.stride, return_log=True)[0]
                    else:
                        lp = forward.raw_posterior(weights, x,
                                                   stride=spec.stride,
                                                   return_log=True)[0]
                    _, path = decode_transducer(lp.contiguous(), 0.0, 0.0, 2.0)
                    call = overlapper(path, lp.shape[1] - 1) or ""
            out.append((call, truth))
    return out


def mean_tail_identity(model: str, params=None, verbose: bool = False,
                       device=None) -> float:
    """The mean of `identity` over tail_identities' pairs (NaN for none)."""
    pairs = tail_identities(model, params, device)
    idents = []
    for i, (call, truth) in enumerate(pairs):
        ident = identity(call, truth)
        if verbose:
            print(f"  {model} read {i}: called {len(call)} truth "
                  f"{len(truth)} identity {ident:.4f}", flush=True)
        idents.append(ident)
    return float(np.mean(idents)) if idents else float("nan")
