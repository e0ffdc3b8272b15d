"""The port's C embed surface (scrappie_torch/native/embed): build the
shim and its demo with the system C compiler against this interpreter's
headers and libpython, basecall a simulated read from C on the CPU, and
compare with scrappie_torch.api's answer (the counterpart of
tests/test_embed.py)."""

import os
import pathlib
import shutil
import site
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
EMBED = REPO / "scrappie_torch" / "native" / "embed"

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def demo_bin(tmp_path_factory):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_config_var(
        "VERSION")
    out = tmp_path_factory.mktemp("embed") / "embed_demo"
    cmd = [cc, "-O2", "-Wall", "-Werror", "-I", str(EMBED), "-I", inc,
           str(EMBED / "embed_demo.c"), str(EMBED / "scrappie_torch_embed.c"),
           f"-L{libdir}", f"-lpython{pyver}", "-ldl", "-lm",
           f"-Wl,-rpath,{libdir}", "-o", str(out)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"embed shim does not build here: {r.stderr[-400:]}")
    return out


def _raw_signal() -> np.ndarray:
    from scrappie_torch.train.simulate import SquiggleSimulator

    sig, _, _ = SquiggleSimulator(seed=11, device="cpu").simulate_read(500)
    sig = sig[:4000]
    med = np.median(sig)
    mad = np.median(np.abs(sig - med)) * 1.4826
    # a plausible pA range, so that trim and scale have work to do
    return ((sig - med) / mad * 12.0 + 90.0).astype(np.float32)


def _env() -> dict:
    """The embedded interpreter starts from the base prefix: hand it the
    repository and this interpreter's packages, and one thread, as the
    test processes use."""
    paths = [str(REPO), *site.getsitepackages(), *sys.path[1:]]
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(dict.fromkeys(p for p in paths if p)))


@pytest.mark.parametrize("model", ["rgrgr_r94", "rnnrf_r94"])
def test_embed_basecall_matches_python(demo_bin, tmp_path, model):
    from scrappie_torch import api

    raw = _raw_signal()
    want_seq, want_score = api.basecall_raw(raw, model=model, device="cpu")[:2]
    rt = api.RawTable(raw)
    rt.trim().scale()
    post = api.calc_post(rt, model, log=True, device="cpu").data()
    f32 = tmp_path / "sig.f32"
    raw.tofile(f32)
    r = subprocess.run([str(demo_bin), str(f32), model, "cpu"],
                       capture_output=True, text=True, timeout=600, env=_env())
    assert r.returncode == 0, r.stderr
    score_str, seq = r.stdout.split(None, 1)
    assert seq.strip() == want_seq and len(want_seq) > 20
    assert float(score_str) == pytest.approx(float(want_score), abs=1e-3)
    assert f"post {post.shape[0]} x {post.shape[1]}" in r.stderr
    assert "scrappie_torch 0.1.0" in r.stderr


def test_embed_module_returns_the_api_answers():
    from scrappie_torch import api, embed

    raw = _raw_signal()
    seq, score = embed.basecall_raw(memoryview(raw), "rgrgr_r94", "cpu")
    want = api.basecall_raw(raw, device="cpu")
    assert (seq, score) == (want[0], float(want[1]))
    data, nblock, nstate = embed.calc_post(memoryview(raw), "rgrgr_r94", "cpu")
    post = np.frombuffer(data, np.float32).reshape(nblock, nstate)
    rt = api.RawTable(raw)
    rt.trim().scale()
    np.testing.assert_array_equal(post, api.calc_post(rt, device="cpu").data())
    assert embed.version() == "0.1.0"


def test_embed_demo_reports_a_bad_device(demo_bin, tmp_path):
    f32 = tmp_path / "sig.f32"
    _raw_signal().tofile(f32)
    r = subprocess.run([str(demo_bin), str(f32), "rgrgr_r94", "meta"],
                       capture_output=True, text=True, timeout=600, env=_env())
    assert r.returncode == 1
    assert "unsupported device" in r.stderr and "basecall failed" in r.stderr
