"""`python -m scrappie_torch raw` and `events` against `scrappie_tpu`'s on
single-read fast5 files written here (the layout scrappie_tpu/io/fast5.py
reads), in-process on the CPU; the port's profiler traces, live-directory
watching, event dumps, licence and help."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import h5py
import numpy as np
import pytest
import torch

from scrappie_torch.cli.main import main as torch_main
from scrappie_tpu.cli.main import main as tpu_main

torch.set_num_threads(1)


def _write_fast5(path, n: int, seed: int, read_id: str) -> None:
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    pa = 90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)
    digitisation, rng_pa, offset = 8192.0, 1400.0, 10.0
    adc = np.round(pa / (rng_pa / digitisation) - offset).astype(np.int16)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_7")
        grp.create_dataset("Signal", data=adc)
        grp.attrs["read_id"] = read_id
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = digitisation
        meta["range"] = rng_pa
        meta["offset"] = offset
        meta["sampling_rate"] = 4000.0


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    assert code == 0, err.getvalue()
    return out.getvalue()


def _run_exit(main, argv):
    """(exit code, stdout) of a command that may end in SystemExit, as
    argparse's --help does."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = main(argv)
    except SystemExit as e:
        code = int(e.code or 0)
    return code, out.getvalue()


@pytest.fixture
def fast5(tmp_path):
    path = tmp_path / "read.fast5"
    _write_fast5(path, 3200, seed=5, read_id="0d3a9c1e-synthetic")
    return str(path)


def _fasta_records(text):
    lines = text.splitlines()
    assert len(lines) % 2 == 0 and lines
    return [(lines[i], lines[i + 1]) for i in range(0, len(lines), 2)]


def test_raw_fasta_matches_scrappie_tpu(fast5):
    """Default flags: stitch mode with posterior-mean homopolymer runs."""
    ours = _fasta_records(_run(torch_main, ["raw", "--device", "cpu", "--uuid",
                                            fast5]))
    ref = _fasta_records(_run(tpu_main, ["raw", "--uuid", fast5]))
    assert len(ours) == len(ref) == 1
    (head, seq), (jhead, jseq) = ours[0], ref[0]
    assert seq and seq == jseq
    name, meta = head.split(None, 1)
    jname, jmeta = jhead.split(None, 1)
    assert name == jname == ">0d3a9c1e-synthetic"
    meta, jmeta = json.loads(meta), json.loads(jmeta)
    assert meta.pop("normalised_score") == pytest.approx(
        jmeta.pop("normalised_score"), rel=1e-5, abs=1e-6)
    assert meta == jmeta


def test_raw_fast_sam_matches_scrappie_tpu(fast5):
    argv = ["raw", "--fast", "--format", "sam", "--chunk-len", "2000",
            "--overlap", "200", "--homopolymer", "nochange", fast5]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    assert ours == ref
    assert ours.split("\t")[9]


def test_version():
    assert _run(torch_main, ["version"]).startswith("scrappie_torch ")


def test_module_cli_entry_point_runs():
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    proc = subprocess.run([sys.executable, "-m", "scrappie_torch.cli", "version"],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("scrappie_torch ")


@pytest.mark.parametrize("argv", [["licence"], ["license"]])
def test_licence_commands(argv):
    text = _run(torch_main, argv)
    assert text.startswith("scrappie_torch is a PyTorch and CUDA port")


@pytest.mark.parametrize("flag", ["--licence", "--license"])
def test_licence_flag(flag, fast5):
    """Prints the licence and calls nothing."""
    assert _run(torch_main, ["raw", flag, fast5]).startswith("scrappie_torch is")


@pytest.mark.parametrize("argv,expect", [
    (["help"], ("raw", "events", "squiggle", "mappy", "seqmappy", "event_table",
                "serve", "licence")),
    (["help", "raw"], ("--watch", "--profile", "--homopolymer", "--device")),
    (["help", "events"], ("--dump", "--hdf5-compression", "--hdf5-chunk",
                          "--profile")),
])
def test_help(argv, expect):
    code, text = _run_exit(torch_main, argv)
    assert code == 0
    for word in expect:
        assert word in text, word


def _trace_annotations(trace_dir) -> set:
    """The names of the user annotations (record_function spans) of the one
    trace written into trace_dir."""
    traces = list(pathlib.Path(trace_dir).iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json", traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_raw_profile_writes_a_trace(fast5, tmp_path):
    ours = _run(torch_main, ["raw", "--device", "cpu", "--profile",
                             str(tmp_path / "trace"), fast5])
    assert ours == _run(torch_main, ["raw", "--device", "cpu", fast5])
    assert {"posterior", "decode"} <= _trace_annotations(tmp_path / "trace")


def test_events_profile_writes_a_trace(fast5, tmp_path):
    _run(torch_main, ["events", "--device", "cpu", "--profile",
                      str(tmp_path / "trace"), fast5])
    assert {"detect_events", "posterior", "assemble"} <= \
        _trace_annotations(tmp_path / "trace")


def test_events_dump_matches_scrappie_tpu(fast5, tmp_path):
    ours, ref = tmp_path / "ours.h5", tmp_path / "ref.h5"
    argv = ["--hdf5-compression", "3", "--hdf5-chunk", "64", "--local", "20", fast5]
    out = _run(torch_main, ["events", "--device", "cpu", "--dump", str(ours), *argv])
    jout = _run(tpu_main, ["events", "--dump", str(ref), *argv])
    (head, seq), = _fasta_records(out)
    (jhead, jseq), = _fasta_records(jout)
    assert seq and seq == jseq
    meta, jmeta = (json.loads(h.split(None, 1)[1]) for h in (head, jhead))
    assert meta.pop("normalised_score") == pytest.approx(
        jmeta.pop("normalised_score"), rel=1e-5, abs=1e-6)
    assert meta == jmeta
    with h5py.File(ours) as h, h5py.File(ref) as j:
        assert list(h.keys()) == list(j.keys()) == [fast5.replace("/", "_")]
        key = list(h.keys())[0]
        ev, jev = h[key], j[key]
        assert ev.dtype == jev.dtype
        assert ev.dtype.names == ("start", "length", "mean", "stdv", "pos", "state")
        assert ev.chunks == jev.chunks == (64,)
        assert ev.compression == jev.compression == "gzip"
        assert ev.compression_opts == jev.compression_opts == 3
        assert ev.shuffle and jev.shuffle
        ev, jev = ev[()], jev[()]
        for field in ev.dtype.names:
            np.testing.assert_array_equal(ev[field], jev[field], err_msg=field)
        assert (ev["pos"] >= 0).any()


def _watch(tmp_path, after, garbage=()):
    """`raw --watch 0.2 --limit 2 --uuid` on a directory holding r0.fast5 and
    the files named in garbage (not HDF5), in a thread; after(dir) runs two
    seconds in, or with garbage once the first read of it has failed (the
    watcher gives up on a file after five failed polls, one second).
    Returns the FASTA names and stderr."""
    watch = tmp_path / "run"
    watch.mkdir()
    outfa = tmp_path / "out.fa"
    _write_fast5(watch / "r0.fast5", 3200, seed=21, read_id="uuid-0")
    for name in garbage:
        (watch / name).write_bytes(b"not yet a fast5")
    res = {}
    err = io.StringIO()

    def run():
        with contextlib.redirect_stderr(err):
            res["code"] = torch_main([
                "raw", "--device", "cpu", str(watch), "--watch", "0.2",
                "--limit", "2", "--trim", "0:0", "--uuid", "-o", str(outfa)])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    if garbage:
        deadline = time.monotonic() + 300
        while "Failed to read" not in err.getvalue() and time.monotonic() < deadline:
            time.sleep(0.01)
    else:
        time.sleep(2.0)
    after(watch)
    t.join(timeout=300)
    assert not t.is_alive(), "--watch did not exit at --limit"
    assert res["code"] == 0, err.getvalue()
    names = [line[1:].split()[0] for line in outfa.read_text().splitlines()
             if line.startswith(">")]
    return names, err.getvalue()


def _appear(path, seed, read_id):
    """Write a fast5 beside path, then move it into place at once."""
    tmp = path.with_suffix(".part")
    _write_fast5(tmp, 3200, seed=seed, read_id=read_id)
    os.replace(tmp, path)


def test_raw_watch_calls_a_file_written_later(tmp_path):
    names, err = _watch(tmp_path, lambda d: _appear(d / "r1.fast5", 22, "uuid-1"))
    assert names == ["uuid-0", "uuid-1"]
    assert "Basecalled 2 reads" in err


def test_raw_watch_retries_a_file_that_failed_to_read(tmp_path):
    """r1.fast5 is not readable yet at the first polls (the sequencer is
    still writing it); a later poll calls it."""
    names, err = _watch(tmp_path, lambda d: _appear(d / "r1.fast5", 23, "uuid-1"),
                        garbage=["r1.fast5"])
    assert names == ["uuid-0", "uuid-1"]
    assert "Failed to read" in err and "r1.fast5" in err


def test_read_scaling_matches_scrappie_tpu(fast5):
    from scrappie_torch.io.fast5 import read_scaling
    from scrappie_tpu.io.fast5 import read_scaling as tpu_read_scaling

    assert read_scaling(fast5) == tpu_read_scaling(fast5) == {
        "digitisation": 8192.0, "offset": 10.0, "range": 1400.0,
        "sample_rate": 4000.0}
