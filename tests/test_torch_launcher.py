"""scrappie_torch/parallel/launcher.py on the CPU: round-robin shards, a
one-process run over fast5 files and over reads in memory, and two
processes over torch.distributed's gloo backend (a file:// rendezvous
under tmp_path, so runs side by side never share a port): their merged
FASTA equals the one-process run, and two steps of training equal a
one-process run on the same global batch, bit for bit (two processes
add two gradients, which is what one process's sum of two replicas'
does). Each subprocess has its own time limit."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from scrappie_torch.parallel import launcher as tl
from scrappie_torch.parallel.runner import BasecallEngine
from scrappie_torch.parallel.sharding import make_mesh
from scrappie_torch.types import RawSignal

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120
COMMON = ["--model", "rgrgr_r94", "--chunk-len", "1000", "--overlap", "200",
          "--batch-per-device", "2"]
TRAIN = ["--model", "rgrgr_r94", "--train", "2", "--batch", "4",
         "--nsample", "600", "--lr", "1e-3", "--seed", "5"]


def _write_fast5(path, counts: np.ndarray, read_id: str):
    import h5py

    with h5py.File(path, "w") as h:
        g = h.create_group("Raw/Reads/Read_7")
        g.attrs["read_id"] = read_id
        g.create_dataset("Signal", data=counts.astype(np.int16))
        ch = h.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["offset"] = 10.0
        ch.attrs["range"] = 1400.0
        ch.attrs["sampling_rate"] = 4000.0


@pytest.fixture(scope="module")
def fast5_dir(tmp_path_factory):
    from scrappie_torch.train.simulate import SquiggleSimulator

    d = tmp_path_factory.mktemp("launcher_reads")
    sim = SquiggleSimulator(seed=11, device="cpu")
    for i in range(3):
        sig, _, _ = sim.simulate_read(300)
        counts = np.round(sig * 40.0 + 300.0).astype(np.int16)
        _write_fast5(d / f"read{i}.fast5", counts, f"uuid-{i}")
    return d


def _parse_fasta(text: str) -> dict[str, str]:
    seqs, name = {}, None
    for line in text.splitlines():
        if line.startswith(">"):
            name = pathlib.Path(line[1:].split()[0]).name
            seqs[name] = ""
        elif name:
            seqs[name] += line.strip()
    return seqs


def _launch(args):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "scrappie_torch.parallel.launcher", *args],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _wait(procs):
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, f"launcher failed:\n{err[-3000:]}"


def _pair(tmp_path, args, out):
    """Two processes, ranks 0 and 1, over gloo; out(rank) their outputs."""
    url = (tmp_path / "rendezvous").as_uri()
    _wait([_launch(["--coordinator", url, "--num-processes", "2",
                    "--process-id", str(i), "--devices", "cpu",
                    "-o", str(out(i)), *args]) for i in range(2)])


def test_shard_files_round_robin():
    files = [f"f{i}" for i in range(7)]
    s0, s1 = tl.shard_files(files, 0, 2), tl.shard_files(files, 1, 2)
    assert s0 == ["f0", "f2", "f4", "f6"]
    assert s1 == ["f1", "f3", "f5"]
    assert sorted(s0 + s1) == sorted(files)


def test_backend_follows_the_mesh_and_no_coordinator_is_a_no_op():
    mesh = make_mesh(devices=["cpu"] * 2)
    assert tl.backend_for(mesh) == "gloo"
    assert tl.initialize(None, 1, 0, mesh=mesh) is None
    with pytest.raises(ValueError, match="backend or a mesh"):
        tl.initialize("localhost:1", 2, 0)
    args = tl.parser().parse_args(["--backend", "nccl", "x.fast5"])
    assert args.backend == "nccl" and args.coordinator is None


def test_one_process_run_equals_the_engine(fast5_dir, tmp_path):
    """run() on a (2, 1) CPU mesh writes what the one-device engine
    calls, for fast5 files and for the same reads in memory."""
    out = tmp_path / "calls.fa"
    assert tl.run(["--devices", "cpu,cpu", "-o", str(out), *COMMON,
                   str(fast5_dir)]) == 0
    got = _parse_fasta(out.read_text())
    eng = BasecallEngine("rgrgr_r94", chunk_len=1000, overlap=200,
                         batch_size=2, device="cpu")
    want = {pathlib.Path(n).name: r.sequence
            for n, r in eng.basecall_files([str(fast5_dir)])}
    assert len(got) == 3 and got == want

    from scrappie_torch.io.fast5 import iterate_fast5, read_raw

    files = sorted(str(f) for f in iterate_fast5([str(fast5_dir)]))
    reads = ([pathlib.Path(f).name for f in files],
             [read_raw(f) for f in files])
    mem = tmp_path / "mem.fa"
    assert tl.run(["--devices", "cpu,cpu", "-o", str(mem), *COMMON],
                  reads=reads) == 0
    assert _parse_fasta(mem.read_text()) == want


def test_in_memory_reads_shard_round_robin(tmp_path):
    from scrappie_torch.train.simulate import SquiggleSimulator

    sim = SquiggleSimulator(seed=3, device="cpu")
    sigs = [RawSignal(sim.simulate_read(250)[0], uuid=f"u{i}")
            for i in range(3)]
    names = [f"m{i}" for i in range(3)]
    out = tmp_path / "shard1.fa"
    assert tl.run(["--devices", "cpu", "--num-processes", "2",
                   "--process-id", "1", "-o", str(out), *COMMON],
                  reads=(names, sigs)) == 0
    assert list(_parse_fasta(out.read_text())) == ["m1"]


def test_two_gloo_processes_equal_one(fast5_dir, tmp_path):
    single = tmp_path / "single.fa"
    _wait([_launch(["--devices", "cpu", "-o", str(single), *COMMON,
                    str(fast5_dir)])])
    _pair(tmp_path, [*COMMON, str(fast5_dir)],
          lambda i: tmp_path / f"calls.{i}.fa")
    merged = {}
    for i in range(2):
        part = _parse_fasta((tmp_path / f"calls.{i}.fa").read_text())
        assert part and not set(part) & set(merged)
        merged.update(part)
    assert merged == _parse_fasta(single.read_text()) and len(merged) == 3


def test_two_gloo_processes_train_as_one(tmp_path):
    """Each process keeps 2 rows of the global batch of 4 on one device;
    the one-process run has both data rows on a (2, 1) mesh."""
    one = tmp_path / "one.npz"
    _wait([_launch(["--devices", "cpu,cpu", "-o", str(one), *TRAIN])])
    _pair(tmp_path, TRAIN, lambda i: tmp_path / "two.npz")
    a, b = np.load(one), np.load(tmp_path / "two.npz")
    assert set(a.files) == set(b.files) and "losses" in a.files
    assert len(a["losses"]) == 2 and np.all(np.isfinite(a["losses"]))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
