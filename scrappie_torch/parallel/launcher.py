"""Multi-process launch over torch.distributed: one process a host (or a
card), the processes independent for inference.

Counterpart of scrappie_tpu/parallel/launcher.py. Every process runs this
program. With a coordinator, `initialize` brings up a torch.distributed
process group (`init_process_group` on tcp://<coordinator>, or the URL
given, with the world size and the rank); the backend is the one named,
or follows the local mesh's devices: NCCL for cards, gloo for the CPU.
There is no switch to another backend when one fails.

Inference: each process basecalls its own round-robin shard of the input
files on a mesh over its local devices (weights replicated, chunk
batches data-parallel) and writes its own FASTA. It issues no collective
(per-process file counts differ, so a collective could wait forever) and
ends with none. Training (`--train STEPS`): every process draws the same
global batch from the same seed, keeps its own rows, and the gradients
are all_reduce'd over the group (train/trainer.py); process 0 writes the
trained parameters and the losses.

    python -m scrappie_torch.parallel.launcher \\
        --coordinator host0:8476 --num-processes N --process-id i \\
        --model rgrgr_r94 --output calls.$i.fa  reads/

Without --coordinator the program runs alone on its local devices. fast5
input needs h5py; `run(argv, reads=(names, signals))` takes the reads in
memory instead, the same path after the files are read.
"""

from __future__ import annotations

import argparse
import sys


def shard_files(files, process_id: int, num_processes: int):
    """Deterministic round-robin file shard for this process."""
    return [f for i, f in enumerate(files) if i % num_processes == process_id]


def backend_for(mesh) -> str:
    """The process group's backend for a mesh's devices: 'nccl' for cards,
    'gloo' for the CPU."""
    return {"cuda": "nccl", "cpu": "gloo"}[mesh.device_type]


def initialize(coordinator: str | None, num_processes: int, process_id: int,
               backend: str | None = None, mesh=None) -> str | None:
    """Bring up torch.distributed when a coordinator is given ("host:port",
    or an init URL such as "file:///path" or "tcp://host:port"); a no-op
    returning None otherwise. backend: 'nccl' or 'gloo', else
    backend_for(mesh). Returns the backend."""
    if not coordinator:
        return None
    import torch.distributed as dist

    if backend is None:
        if mesh is None:
            raise ValueError("initialize needs a backend or a mesh")
        backend = backend_for(mesh)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return backend


def local_mesh(devices: str | None):
    """The data mesh over this process's devices: a comma-separated list
    ("cpu,cpu", "cuda:0,cuda:1"; a device may repeat), or every visible
    card."""
    from scrappie_torch.parallel.sharding import make_mesh

    return make_mesh(devices=None if devices is None else
                     [d.strip() for d in devices.split(",") if d.strip()])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0, or an init URL "
                         "(file://..., tcp://...); omit for one process")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="process group backend (default: nccl for cards, "
                         "gloo for the CPU)")
    ap.add_argument("--devices", default=None,
                    help="this process's mesh, a comma-separated device "
                         "list (default: every visible card)")
    ap.add_argument("--model", default="rgrgr_r94")
    ap.add_argument("--chunk-len", type=int, default=10000)
    ap.add_argument("--overlap", type=int, default=1000)
    ap.add_argument("--batch-per-device", type=int, default=32)
    ap.add_argument("--fast", action="store_true", default=False)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--output", "-o", default=None,
                    help="FASTA (inference) or npz of the trained "
                         "parameters and losses (--train; process 0)")
    ap.add_argument("--train", type=int, default=0, metavar="STEPS",
                    help="train STEPS steps on simulated reads instead")
    ap.add_argument("--batch", type=int, default=8,
                    help="--train: the global batch")
    ap.add_argument("--nsample", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("files", nargs="*")
    return ap


def run(argv=None, reads=None) -> int:
    """The launcher's main. reads: (names, signals) in memory, in place of
    the files (each read a file of the round-robin shard)."""
    args = parser().parse_args(argv)
    if not args.train and not args.files and reads is None:
        print("no input files", file=sys.stderr)
        return 2
    mesh = local_mesh(args.devices)
    initialize(args.coordinator, args.num_processes, args.process_id,
               args.backend, mesh)
    try:
        if args.train:
            return train_shard(args, mesh)
        return basecall_shard(args, mesh, reads)
    finally:
        if args.coordinator:
            import torch.distributed as dist

            dist.destroy_process_group()


def basecall_shard(args, mesh, reads=None) -> int:
    """Basecall this process's round-robin shard of the files (or of the
    in-memory reads) on its local mesh and write its FASTA."""
    from scrappie_torch.io.fasta import format_fasta
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.tracing import log

    engine = BasecallEngine(
        args.model, chunk_len=args.chunk_len, overlap=args.overlap,
        batch_size=args.batch_per_device * mesh.shape["data"], mesh=mesh,
        mode="fast" if args.fast else "stitch")
    if reads is None:
        from scrappie_torch.io.fast5 import iterate_fast5

        files = shard_files(sorted(str(f) for f in iterate_fast5(args.files)),
                            args.process_id, args.num_processes)
        if args.limit:
            files = files[: args.limit]
        log("info", "process shard", process=args.process_id,
            nfiles=len(files), mesh=str(mesh.shape))
        results = engine.basecall_files(files)
    else:
        names, signals = reads
        keep = shard_files(range(len(names)), args.process_id,
                           args.num_processes)
        if args.limit:
            keep = keep[: args.limit]
        results = list(zip([names[i] for i in keep],
                           engine.basecall_signals([signals[i] for i in keep])))

    out = open(args.output, "w") if args.output else sys.stdout
    n = 0
    for name, r in results:
        if r.sequence is None:
            continue
        n += 1
        out.write(format_fasta(name, r.sequence, filename=name,
                               uuid=r.uuid or "", score=r.score,
                               nblock=r.nblock, nsample=r.nsample,
                               trim=(r.trim_start, r.trim_end)))
    if out is not sys.stdout:
        out.close()
    log("info", "process done", process=args.process_id, basecalled=n)
    return 0


def train_shard(args, mesh) -> int:
    """Train on the global batch, this process's rows on its local mesh;
    process 0 writes the parameters and the losses (npz, key 'losses')."""
    import numpy as np

    from scrappie_torch.train.trainer import train

    params, losses = train(args.model, steps=args.train, batch=args.batch,
                           nsample=args.nsample, lr=args.lr, seed=args.seed,
                           mesh=mesh, log_every=0)
    if args.process_id == 0 and args.output:
        np.savez(args.output, losses=np.asarray(losses, np.float64), **params)
    return 0


if __name__ == "__main__":
    sys.exit(run())
