"""`python -m scrappie_torch raw` against `scrappie_tpu raw` on a
single-read fast5 written here (the layout scrappie_tpu/io/fast5.py
reads), in-process on the CPU."""

import contextlib
import io
import json

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
