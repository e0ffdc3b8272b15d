"""FASTA and SAM writing.

Behavioural spec: the drivers' fprintf_fasta / fprintf_sam
(ref src/scrappie_raw.c:317-331), including the JSON metadata embedded in
the FASTA description. A copy of the writers of scrappie_tpu/io/fasta.py.
"""

from __future__ import annotations

import json


def format_fasta(name: str, seq: str, *, filename: str = "", uuid: str = "",
                 score: float = 0.0, nblock: int = 0, nsample: int = 0,
                 trim: tuple[int, int] = (0, 0), prefix: str = "") -> str:
    """FASTA record with the reference's JSON metadata description.

    (ref fprintf_fasta, src/scrappie_raw.c:317-325)
    """
    meta = {
        "filename": filename,
        "uuid": uuid,
        "normalised_score": (-score / nblock) if nblock else 0.0,
        "nblock": nblock,
        "sequence_length": len(seq),
        "blocks_per_base": (nblock / len(seq)) if seq else 0.0,
        "nsample": nsample,
        "trim": list(trim),
    }
    return f">{prefix}{name}  {json.dumps(meta)}\n{seq}\n"


def format_sam(name: str, seq: str, prefix: str = "",
               qual: str | None = None) -> str:
    """Unaligned SAM record (ref fprintf_sam, src/scrappie_raw.c:327-331).

    The reference hard-codes QUAL to "*"; we fill it when per-base
    qualities were computed (post/quality.py)."""
    return (f"{prefix}{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t"
            f"{qual or '*'}\n")

