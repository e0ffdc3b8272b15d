"""Command line of the port: the `raw` subcommand for the rgrgr and rnnrf
models and the `events` subcommand for nanonet_events.

Counterpart of scrappie_tpu/cli/main.py (`raw` and `events`, FASTA and SAM
output), with the same flags for what the port runs, plus --device. Run as
`python -m scrappie_torch raw|events [flags] files...`.
"""

from __future__ import annotations

import argparse
import json
import sys

RAW_MODELS = ("rgrgr_r94", "rgrgr_r941", "rgrgr_r10", "rnnrf_r94")


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


def _add_basecall_common(p) -> None:
    """The flags `raw` and `events` share."""
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
    p.add_argument("--device", default="cuda",
                   help="Torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch twins")
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

    fh = open(args.output, "w") if args.output else sys.stdout
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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.command == "version":
        import scrappie_torch

        print(f"scrappie_torch {scrappie_torch.__version__}")
        return 0
    if args.command == "events":
        return main_events(args)
    return main_raw(args)


if __name__ == "__main__":
    sys.exit(main())
