"""Command line of the port: `raw` (the rgrgr and rnnrf models) and
`events` (nanonet_events) basecall; `squiggle` predicts squiggles, `mappy`
aligns a read's signal to a sequence's predicted squiggle, `seqmappy` maps
its rgrgr_r94 posterior to a sequence, and `event_table` dumps its
detected events.

Counterpart of scrappie_tpu/cli/main.py (FASTA and SAM output, the same
TSV), with the same flags for what the port runs, plus --device. Run as
`python -m scrappie_torch raw|events|squiggle|mappy|seqmappy|event_table
[flags] files...`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

RAW_MODELS = ("rgrgr_r94", "rgrgr_r941", "rgrgr_r10", "rnnrf_r94")
SQUIGGLE_MODELS = ("squiggle_r94", "squiggle_r94_rna", "squiggle_r10")


def _trim_pair(s: str) -> tuple[int, int]:
    parts = s.split(":")
    start = int(parts[0])
    end = int(parts[1]) if len(parts) > 1 else start
    return start, end


def _seg_pair(s: str) -> tuple[int, float]:
    parts = s.split(":")
    chunk = int(parts[0])
    perc = float(parts[1]) / 100.0 if len(parts) > 1 else 0.0
    return chunk, perc


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="Torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch twins")


def _add_common(p) -> None:
    """The flags of every command that reads fast5 signal."""
    p.add_argument("--output", "-o", default=None,
                   help="Write to file rather than stdout")
    p.add_argument("--prefix", "-p", default="",
                   help="Prefix to append to name of each read")
    p.add_argument("--trim", "-t", type=_trim_pair, default=(200, 10),
                   metavar="start:end",
                   help="Number of samples to trim, as start:end")
    p.add_argument("--segmentation", type=_seg_pair, default=(100, 0.0),
                   metavar="chunk:percentile",
                   help="Chunk size and percentile for variance based "
                        "segmentation")
    _add_device(p)


def _add_basecall_common(p) -> None:
    """The flags `raw` and `events` share."""
    _add_common(p)
    p.add_argument("--format", "-f", choices=["fasta", "sam"],
                   default="fasta", type=str.lower,
                   help="Format to output reads")
    p.add_argument("--limit", "-l", type=int, default=0,
                   help="Maximum number of reads to call (0 is unlimited)")
    p.add_argument("--min_prob", "-m", type=float, default=1e-5,
                   help="Minimum bound on probability of match")
    p.add_argument("--skip", "-s", dest="skip_pen", type=float, default=0.0,
                   help="Penalty for skipping a base")
    p.add_argument("--stay", "-y", dest="stay_pen", type=float, default=0.0,
                   help="Penalty for staying")
    p.add_argument("--local", dest="local_pen", type=float, default=2.0,
                   help="Penalty for local basecalling")
    p.add_argument("--temperature1", type=float, default=1.0,
                   help="Temperature for softmax weights")
    p.add_argument("--temperature2", type=float, default=1.0,
                   help="Temperature for softmax bias")
    p.add_argument("--slip", dest="use_slip", action="store_true",
                   default=False, help="Use slipping")
    p.add_argument("--no-slip", dest="use_slip", action="store_false")
    p.add_argument("--uuid", dest="uuid", action="store_true", default=False,
                   help="Output UUID as read name")
    p.add_argument("--no-uuid", dest="uuid", action="store_false")
    p.add_argument("--threads", "-#", type=int, default=None,
                   help="(compatibility) parallelism hint; maps to device "
                        "batch")
    p.add_argument("--batch", type=int, default=8, help="Device batch size")
    p.add_argument("--stage-report", action="store_true", default=False,
                   help="Log per-stage wall-clock timings (JSON, stderr)")


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="scrappie_torch",
        description="scrappie-compatible basecaller on PyTorch and CUDA")
    sub = top.add_subparsers(dest="command", required=True)

    raw = sub.add_parser("raw", help="basecall from raw signal")
    _add_basecall_common(raw)
    raw.add_argument("--calibration", choices=["reference", "real"],
                     default="reference",
                     help="Decode calibration preset: 'reference' keeps zero "
                          "penalties; 'real' applies the per-model stay/skip "
                          "optimum. Explicit --stay/--skip/--crf-emit-bias "
                          "flags win.")
    raw.add_argument("--model", default="rgrgr_r94", choices=RAW_MODELS,
                     help="Raw model to use")
    raw.add_argument("--homopolymer", "-H", default="mean",
                     choices=["nochange", "mean"],
                     help="Homopolymer run calc.")
    raw.add_argument("--crf-emit-bias", type=float, default=0.0,
                     help="Decode-time additive prior on CRF transitions "
                          "into emitting states (rnnrf only; negative "
                          "calls fewer bases)")
    raw.add_argument("--chunk-len", type=int, default=10000,
                     help="Chunk length in samples")
    raw.add_argument("--overlap", type=int, default=1000,
                     help="Chunk overlap in samples")
    raw.add_argument("--fast", action="store_true", default=False,
                     help="Fused per-chunk decode and path stitching; "
                          "posterior-mean homopolymer correction is "
                          "stitch-mode only")
    raw.add_argument("files", nargs="+", help="fast5 files or directories")

    ev = sub.add_parser("events", help="basecall via event detection")
    _add_basecall_common(ev)
    ev.add_argument("--calibration", choices=["reference", "real"],
                    default="reference",
                    help="Decode calibration preset: 'reference' keeps zero "
                         "penalties; 'real' applies the model's measured "
                         "stay/skip optimum. Explicit --stay/--skip win.")
    ev.add_argument("--dwell", dest="dwell_correction", action="store_true",
                    default=True,
                    help="Perform dwell correction of homopolymer lengths")
    ev.add_argument("--no-dwell", dest="dwell_correction",
                    action="store_false")
    ev.add_argument("--chunk-len", type=int, default=2048,
                    help="Chunk length in events")
    ev.add_argument("--overlap", type=int, default=256,
                    help="Chunk overlap in events")
    ev.add_argument("--fast", action="store_true", default=False,
                    help="Fused per-chunk decode and path stitching (dwell "
                         "correction still applies)")
    ev.add_argument("files", nargs="+", help="fast5 files or directories")

    sq = sub.add_parser("squiggle", help="sequence -> predicted squiggle")
    sq.add_argument("--model", "-m", default="squiggle_r94",
                    choices=SQUIGGLE_MODELS)
    sq.add_argument("--limit", "-l", type=int, default=0)
    sq.add_argument("--output", "-o", default=None)
    sq.add_argument("--prefix", "-p", default="")
    sq.add_argument("--rescale", dest="rescale", action="store_true",
                    default=False, help="Rescale network output")
    sq.add_argument("--no-rescale", dest="rescale", action="store_false")
    _add_device(sq)
    sq.add_argument("files", nargs="+", help="FASTA files")

    mp = sub.add_parser("mappy", help="align raw signal to predicted squiggle")
    _add_common(mp)
    mp.add_argument("--model", default="squiggle_r94", choices=SQUIGGLE_MODELS)
    mp.add_argument("--backprob", "-b", type=float, default=0.0,
                    help="Probability of backwards movement")
    mp.add_argument("--skippen", "-k", type=float, default=5000.0,
                    help="Penalty for skipping position")
    mp.add_argument("--localpen", type=float, default=2.0,
                    help="Penalty for local matching")
    mp.add_argument("--minscore", type=float, default=5.0,
                    help="Minimum possible score for matching emission")
    mp.add_argument("--rate", "-r", type=float, default=1.0,
                    help="Translocation rate relative to standard squiggle")
    mp.add_argument("fasta", help="FASTA file")
    mp.add_argument("fast5", help="fast5 file")

    sm = sub.add_parser("seqmappy", help="map basecall posterior to a sequence")
    _add_common(sm)
    sm.add_argument("--localpen", type=float, default=4.0,
                    help="Penalty for local matching")
    sm.add_argument("--min_prob", "-m", type=float, default=1e-5)
    sm.add_argument("--skip", "-s", dest="skip_pen", type=float, default=0.0)
    sm.add_argument("--stay", "-y", dest="stay_pen", type=float, default=0.0)
    sm.add_argument("--temperature1", type=float, default=1.0)
    sm.add_argument("--temperature2", type=float, default=1.0)
    sm.add_argument("fasta", help="FASTA file")
    sm.add_argument("fast5", help="fast5 file")

    et = sub.add_parser("event_table", help="dump detected events as TSV")
    _add_common(et)
    et.add_argument("files", nargs="+", help="fast5 files or directories")

    sub.add_parser("version", help="print version")
    return top


def main_raw(args) -> int:
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.io.fasta import format_fasta
    from scrappie_torch.models import calibration

    batch = max(args.batch, args.threads or 0)
    engine = BasecallEngine(args.model, chunk_len=args.chunk_len,
                            overlap=args.overlap, batch_size=batch,
                            device=args.device, min_prob=args.min_prob,
                            tempW=args.temperature1, tempb=args.temperature2,
                            mode="fast" if args.fast else "stitch")
    call_kwargs = dict(
        trim_start=args.trim[0], trim_end=args.trim[1],
        varseg_chunk=args.segmentation[0], varseg_thresh=args.segmentation[1],
        stay_pen=args.stay_pen, skip_pen=args.skip_pen,
        local_pen=args.local_pen, use_slip=args.use_slip,
        homopolymer=None if args.model == "rnnrf_r94" else args.homopolymer,
        crf_emit_bias=args.crf_emit_bias)
    calibration.apply(args.model, args.calibration, call_kwargs)

    results = engine.basecall_files(args.files, limit=args.limit, **call_kwargs)

    def fasta(name, primary, r):
        return format_fasta(primary, r.sequence, filename=name,
                            uuid=r.uuid or "", score=r.score, nblock=r.nblock,
                            nsample=r.nsample, trim=(r.trim_start, r.trim_end),
                            prefix=args.prefix)

    return _write(args, engine, results, fasta)


def main_events(args) -> int:
    """Events basecalls through BasecallEngine("nanonet_events")."""
    from scrappie_torch.models import calibration
    from scrappie_torch.parallel.runner import BasecallEngine

    batch = max(args.batch, args.threads or 0)
    engine = BasecallEngine("nanonet_events", chunk_len=args.chunk_len,
                            overlap=args.overlap, batch_size=batch,
                            device=args.device, min_prob=args.min_prob,
                            tempW=args.temperature1, tempb=args.temperature2,
                            mode="fast" if args.fast else "stitch")
    call_kwargs = dict(
        trim_start=args.trim[0], trim_end=args.trim[1],
        varseg_chunk=args.segmentation[0], varseg_thresh=args.segmentation[1],
        stay_pen=args.stay_pen, skip_pen=args.skip_pen,
        local_pen=args.local_pen, use_slip=args.use_slip,
        dwell_correction=args.dwell_correction)
    calibration.apply("nanonet_events", args.calibration, call_kwargs)
    results = engine.basecall_files(args.files, limit=args.limit, **call_kwargs)

    def fasta(name, primary, r):
        # the JSON meta of scrappie_tpu's events command
        nev = r.nblock
        meta = {"filename": name, "uuid": r.uuid or "",
                "normalised_score": -r.score / max(nev, 1), "nevent": nev,
                "sequence_length": len(r.sequence),
                "events_per_base": nev / len(r.sequence),
                "nsample": r.nsample, "trim": [r.trim_start, r.trim_end]}
        return f">{args.prefix}{primary}  {json.dumps(meta)}\n{r.sequence}\n"

    return _write(args, engine, results, fasta)


def _write(args, engine, results, fasta) -> int:
    """Write the called reads as FASTA (fasta(name, primary, result) gives
    a record) or SAM, then the stage report and the read count."""
    from scrappie_torch.io.fasta import format_sam

    fh = _out(args)
    nread = 0
    try:
        for name, r in results:
            if r.sequence is None:
                print(f"No basecall for {name}", file=sys.stderr)
                continue
            nread += 1
            primary = (r.uuid or name) if args.uuid else name
            if args.format == "fasta":
                fh.write(fasta(name, primary, r))
            else:
                fh.write(format_sam(primary, r.sequence, prefix=args.prefix))
        fh.flush()
    finally:
        if fh is not sys.stdout:
            fh.close()
    if args.stage_report:
        print(json.dumps({"stages": engine.stage.report()}), file=sys.stderr)
    print(f"Basecalled {nread} reads", file=sys.stderr)
    return 0


def _out(args):
    return open(args.output, "w") if args.output else sys.stdout


def main_squiggle(args) -> int:
    from scrappie_torch.api import sequence_to_squiggle
    from scrappie_torch.io.fasta import read_fasta

    fh = _out(args)
    count = 0
    for f in args.files:
        if args.limit and count >= args.limit:
            break
        for rec in read_fasta(f):
            if args.limit and count >= args.limit:
                break
            count += 1
            try:
                sq = sequence_to_squiggle(rec.seq, model=args.model,
                                          rescale=args.rescale,
                                          device=args.device)
            except ValueError as e:
                print(f"Skipping {rec.name!r}: {e}", file=sys.stderr)
                continue
            fh.write(f"#{args.prefix}{rec.name}\n")
            fh.write("pos\tbase\tcurrent\tsd\tdwell\n")
            for i, base in enumerate(rec.seq):
                fh.write(f"{i}\t{base}\t{sq[i,0]:3.6f}\t{sq[i,1]:3.6f}\t{sq[i,2]:3.6f}\n")
    if fh is not sys.stdout:
        fh.close()
    return 0


def main_mappy(args) -> int:
    from scrappie_torch.api import sequence_to_squiggle
    from scrappie_torch.decode.dtw import squiggle_match_viterbi
    from scrappie_torch.device import as_device
    from scrappie_torch.io.fast5 import read_raw
    from scrappie_torch.io.fasta import read_first_sequence
    from scrappie_torch.signal.trim import trim_and_segment_raw
    from scrappie_torch.utils.maths import medmad_normalise

    device = as_device(args.device)
    rec = read_first_sequence(args.fasta)
    if rec is None:
        print(f"Failed to open {args.fasta!r} for input.", file=sys.stderr)
        return 1
    rs = read_raw(args.fast5)
    rt = trim_and_segment_raw(rs, args.trim[0], args.trim[1],
                              args.segmentation[0], args.segmentation[1])
    if rt is None:
        print(f"Failed to trim signal from {args.fast5!r}.", file=sys.stderr)
        return 1
    norm = medmad_normalise(rt.trimmed)

    try:
        squiggle = sequence_to_squiggle(rec.seq, model=args.model,
                                        rescale=False, device=device)
    except ValueError as e:
        print(f"Could not encode {args.fasta!r}: {e}", file=sys.stderr)
        return 1
    score, path = squiggle_match_viterbi(
        norm, squiggle, rate=args.rate, prob_back=args.backprob,
        local_pen=args.localpen, skip_pen=args.skippen,
        minscore=args.minscore, device=device)
    full = np.full(rt.n, -1, dtype=np.int64)
    full[rt.start : rt.end] = path
    # The normalised signal the DTW aligned (the reference normalises
    # rt.raw in place, so its TSV is in normalised units too).
    raw = np.full(rt.n, np.nan, dtype=np.float64)
    raw[rt.start : rt.end] = norm

    fh = _out(args)
    fh.write(f"# {args.fast5} to {args.fasta}  (score = {score:f})\n")
    fh.write("idx\tsignal\tpos\tbase\tcurrent\tsd\tdwell\n")
    for i in range(rt.n):
        pos = full[i]
        if pos >= 0:
            fh.write(
                f"{i}\t{raw[i]:3.6f}\t{pos}\t{rec.seq[pos]}\t{squiggle[pos,0]:3.6f}"
                f"\t{np.exp(squiggle[pos,1]):3.6f}\t{np.exp(-squiggle[pos,2]):3.6f}\n")
        else:
            sig = raw[i] if rt.start <= i < rt.end else float("nan")
            fh.write(f"{i}\t{sig:3.6f}\t{pos}\tN\tnan\tnan\tnan\n")
    if fh is not sys.stdout:
        fh.close()
    return 0


def main_seqmappy(args) -> int:
    from scrappie_torch.api import RawTable, calc_post, encode_bases
    from scrappie_torch.decode.mapping import map_to_sequence_viterbi
    from scrappie_torch.device import as_device
    from scrappie_torch.io.fast5 import read_raw
    from scrappie_torch.io.fasta import read_first_sequence

    device = as_device(args.device)
    rec = read_first_sequence(args.fasta)
    if rec is None:
        print(f"Failed to open {args.fasta!r} for input.", file=sys.stderr)
        return 1
    rs = read_raw(args.fast5)
    rt = RawTable(rs.raw).trim(args.trim[0], args.trim[1],
                               args.segmentation[0], args.segmentation[1])
    if rt.end <= rt.start:
        print(f"Failed to trim signal from {args.fast5!r}.", file=sys.stderr)
        return 1
    rt = rt.scale()
    post = calc_post(rt, "rgrgr_r94", min_prob=args.min_prob,
                     tempW=args.temperature1, tempb=args.temperature2,
                     device=device)
    try:
        states = encode_bases(rec.seq, 5)
    except ValueError as e:
        print(f"Could not encode {args.fasta!r}: {e}", file=sys.stderr)
        return 1
    score, path = map_to_sequence_viterbi(
        post.data(), states, args.stay_pen, args.skip_pen, args.localpen,
        want_path=True, device=device)
    nblock = len(post)
    fh = _out(args)
    fh.write(f"# {args.fast5} to {args.fasta} -- score {-score:f} over {nblock} blocks"
             f" ({-score / nblock:f} per block)\n")
    fh.write("block\tpos\n")
    for i in range(nblock):
        fh.write(f"{i}\t{path[i]}\n")
    if fh is not sys.stdout:
        fh.close()
    return 0


def main_event_table(args) -> int:
    """Host code only (event detection runs no kernel); --device is
    checked like every command's."""
    from scrappie_torch.device import as_device
    from scrappie_torch.io.fast5 import iterate_fast5, read_raw_all
    from scrappie_torch.signal.events import detect_events
    from scrappie_torch.signal.trim import trim_and_segment_raw

    as_device(args.device)
    fh = _out(args)
    reads: list = []
    for f in iterate_fast5(args.files):
        try:
            sigs = read_raw_all(f)
        except Exception as e:
            print(f"Failed to read {f}: {e}", file=sys.stderr)
            continue
        reads.extend((f if len(sigs) == 1 else f"{f}:{rs.uuid}", rs)
                     for rs in sigs)
    for f, rs in reads:
        rt = trim_and_segment_raw(rs, args.trim[0], args.trim[1],
                                  args.segmentation[0], args.segmentation[1])
        if rt is None:
            print(f"No events returned for {f}", file=sys.stderr)
            continue
        et = detect_events(rt)
        fh.write(f"# {f}\n")
        fh.write("#event\tstart\tmean\tstdv\tdwell\n")
        for i, ev in enumerate(et.event):
            fh.write(f"{i}\t{ev['start']}\t{ev['mean']:f}\t{ev['stdv']:f}\t{int(ev['length'])}\n")
    if fh is not sys.stdout:
        fh.close()
    return 0


_COMMANDS = {"raw": main_raw, "events": main_events, "squiggle": main_squiggle,
             "mappy": main_mappy, "seqmappy": main_seqmappy,
             "event_table": main_event_table}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.command == "version":
        import scrappie_torch

        print(f"scrappie_torch {scrappie_torch.__version__}")
        return 0
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
