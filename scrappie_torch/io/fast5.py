"""fast5 (HDF5) read/write via h5py.

Behavioural spec: ref src/fast5_interface.c.  Reads the first read under
/Raw/Reads and scales ADC counts to picoamps using the channel metadata.

Beyond the reference: MULTI-read fast5 files (the post-2018 MinKNOW
bulk format — top-level ``read_<uuid>`` groups, per-read channel
metadata — which the reference predates) are handled transparently by
``read_raw_all``; the basecall engine and CLI emit one record per
contained read. A copy of the readers and the event writer of
scrappie_tpu/io/fast5.py (without its fault injection); h5py is imported
when a file is read or written (the machine with the card has none).
"""

from __future__ import annotations

import numpy as np

from scrappie_torch.types import EventTable, RawSignal


def read_raw(filename, scale_to_pA: bool = True) -> RawSignal:
    """Read the first raw read (ref read_raw, src/fast5_interface.c:130-217)."""
    import h5py

    with h5py.File(filename, "r") as h:
        reads = h["Raw/Reads"]
        name = sorted(reads.keys())[0]
        grp = reads[name]
        sig = grp["Signal"][()].astype(np.float32)
        uuid = grp.attrs.get("read_id")
        if isinstance(uuid, bytes):
            uuid = uuid.decode()
        if scale_to_pA:
            meta = h["/UniqueGlobalKey/channel_id"].attrs
            raw_unit = float(meta["range"]) / float(meta["digitisation"])
            sig = (sig + float(meta["offset"])) * raw_unit
    return RawSignal(sig, uuid=uuid)


def _scale_pA(sig: np.ndarray, meta) -> np.ndarray:
    raw_unit = float(meta["range"]) / float(meta["digitisation"])
    return (sig + float(meta["offset"])) * raw_unit


def read_raw_all(filename, scale_to_pA: bool = True,
                 limit: int = 0) -> list[RawSignal]:
    """Every read in a fast5 file, single- or multi-read layout.

    Single-read files (the only layout the reference supports, ref
    src/fast5_interface.c:130-217) yield one signal.  Multi-read files
    — top-level ``read_<uuid>`` groups each carrying ``Raw/Signal`` and
    their own ``channel_id`` metadata — yield one signal per read, in
    sorted group order.  ``limit`` caps the number of reads (0 = all).
    """
    import h5py

    out: list[RawSignal] = []
    with h5py.File(filename, "r") as h:
        if "Raw/Reads" in h:               # single-read layout
            return [read_raw(filename, scale_to_pA=scale_to_pA)]
        for name in sorted(h.keys()):
            if not name.startswith("read_"):
                continue
            grp = h[name]
            if "Raw/Signal" not in grp:
                continue
            sig = grp["Raw/Signal"][()].astype(np.float32)
            uuid = grp["Raw"].attrs.get("read_id")
            if isinstance(uuid, bytes):
                uuid = uuid.decode()
            if uuid is None:
                uuid = name[len("read_"):]
            if scale_to_pA:
                sig = _scale_pA(sig, grp["channel_id"].attrs)
            out.append(RawSignal(sig, uuid=uuid))
            if limit and len(out) >= limit:
                break
    if not out:
        raise ValueError(f"{filename}: no reads found (neither Raw/Reads "
                         "nor read_<uuid> groups)")
    return out


def read_scaling(filename) -> dict:
    """Channel scaling attributes (ref get_raw_scaling, src/fast5_interface.c:109-128)."""
    import h5py

    with h5py.File(filename, "r") as h:
        meta = h["/UniqueGlobalKey/channel_id"].attrs
        return {
            "digitisation": float(meta["digitisation"]),
            "offset": float(meta["offset"]),
            "range": float(meta["range"]),
            "sample_rate": float(meta["sampling_rate"]),
        }


def write_annotated_events(filename, readname: str, et: EventTable,
                           chunk_size: int = 200, compression_level: int = 1) -> None:
    """Dump an annotated event table to HDF5.

    (ref write_annotated_events, src/fast5_interface.c:219-301: compound
    dataset under the given name, shuffle + gzip, chunked.)
    """
    import h5py

    ev = et.event
    with h5py.File(filename, "a") as h:
        if readname in h:
            del h[readname]
        h.create_dataset(
            readname,
            data=ev,
            chunks=(max(1, min(chunk_size, len(ev))),),
            shuffle=compression_level > 0,
            compression="gzip" if compression_level > 0 else None,
            compression_opts=compression_level if compression_level > 0 else None,
        )


def iterate_fast5(paths) -> list:
    """Expand files/directories into a flat list of .fast5 paths.

    (the drivers glob *.fast5 under directory arguments —
    ref src/scrappie_raw.c:363-386)
    """
    import pathlib

    out = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.extend(sorted(p.glob("*.fast5")))
        else:
            out.append(p)
    return out
