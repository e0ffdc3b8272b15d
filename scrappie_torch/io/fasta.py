"""FASTA/FASTQ reading and FASTA/SAM writing.

Behavioural spec: ref src/kseq.h (parsing) and the drivers' fprintf_fasta
/ fprintf_sam (ref src/scrappie_raw.c:317-331), including the JSON
metadata embedded in the FASTA description. A copy of the readers and the
FASTA/SAM writers of scrappie_tpu/io/fasta.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass
class FastaRecord:
    name: str
    seq: str
    comment: str = ""
    qual: str | None = None


def read_fasta(path):
    """Iterate records from a FASTA/FASTQ file (kseq-equivalent)."""
    records = []
    name = None
    comment = ""
    seq_parts: list[str] = []
    qual_parts: list[str] | None = None
    in_qual = False

    def flush():
        if name is not None:
            records.append(
                FastaRecord(
                    name,
                    "".join(seq_parts),
                    comment,
                    "".join(qual_parts) if qual_parts is not None else None,
                )
            )

    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] in ">@" and not in_qual:
                flush()
                head = line[1:].split(None, 1)
                name = head[0] if head else ""
                comment = head[1] if len(head) > 1 else ""
                seq_parts = []
                qual_parts = None
            elif line[0] == "+" and not in_qual and name is not None:
                in_qual = True
                qual_parts = []
            elif in_qual:
                qual_parts.append(line)
                if sum(map(len, qual_parts)) >= sum(map(len, seq_parts)):
                    in_qual = False
            else:
                seq_parts.append(line)
        flush()
    return records


def read_first_sequence(path) -> FastaRecord | None:
    """First record only (ref read_sequence_from_fasta,
    src/scrappie_seq_helpers.c:76-102)."""
    recs = read_fasta(path)
    return recs[0] if recs else None


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

