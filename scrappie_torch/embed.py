"""Helpers behind the C embed surface (native/embed/scrappie_torch_embed.h).

Counterpart of scrappie_tpu/embed.py. The reference exports a minimal C
API for embedding (`nanonet_posterior` / `nanonet_raw_posterior` and the
matrix free, ref interface/scrappie.h:47-52). The port's analogue embeds
the CPython interpreter: the C shim (native/embed/scrappie_torch_embed.c)
imports this module and calls the functions below with raw buffers, so
the C side needs no numpy or torch headers.

Inputs are C-contiguous float32 buffers passed as buffer objects
(memoryview); outputs are plain Python objects the shim converts. The
device is a torch device name; None (a null pointer in C) means the card.
"""

from __future__ import annotations


def version() -> str:
    import scrappie_torch

    return scrappie_torch.__version__


def basecall_raw(buf, model: str = "rgrgr_r94",
                 device: str | None = None) -> tuple[str, float]:
    """Basecall a float32 raw-signal buffer; returns (sequence, score)."""
    import numpy as np

    from scrappie_torch import api

    sig = np.frombuffer(buf, dtype=np.float32)
    seq, score = api.basecall_raw(sig, model=model, device=device)[:2]
    return seq or "", float(score)


def calc_post(buf, model: str = "rgrgr_r94",
              device: str | None = None) -> tuple[bytes, int, int]:
    """Log posterior (CRF transitions for rnnrf_r94) of a float32
    raw-signal buffer, trimmed and scaled as api.basecall_raw does.

    Returns (float32 bytes [nblock * nstate] row-major, nblock, nstate),
    the embed analogue of the reference's exported posterior functions.
    """
    import numpy as np

    from scrappie_torch import api

    sig = np.frombuffer(buf, dtype=np.float32)
    rt = api.RawTable(sig)
    rt.trim().scale()
    post = api.calc_post(rt, model, log=True, device=device)
    arr = np.ascontiguousarray(post.data(), dtype=np.float32)
    return arr.tobytes(), int(arr.shape[0]), int(arr.shape[1])
