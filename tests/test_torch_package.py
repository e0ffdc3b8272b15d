"""Package-level contracts of scrappie_torch: it imports nothing of JAX
(the machine with the GPU has none) nor of scrappie_tpu (it keeps its own
copy of the host code it needs), CPU tensors run the plain twins without
touching the launch counters, and asking for CUDA where there is none
raises instead of falling back."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from scrappie_torch import ops
from scrappie_torch.device import as_device
from scrappie_torch.ops import _build
from scrappie_torch.ops.crf import crf_viterbi_scores_tm
from scrappie_torch.nn.rnn import gru_tm as gru_tm_plain
from scrappie_torch.ops.gru import gru_layer_tm, gru_layer_tm_plain, gru_tm
from scrappie_torch.ops.viterbi import (
    viterbi_backtrace_tm,
    viterbi_backtrace_tm_plain,
    viterbi_fused_ens_tm,
    viterbi_fused_ens_tm_plain,
    viterbi_fused_tm,
    viterbi_fused_tm_plain,
    viterbi_scores_tm,
    viterbi_scores_tm_plain,
)
from scrappie_torch.utils.seqcompare import edit_distance, within_flip_rule

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


PORT_FILES = sorted((REPO / "scrappie_torch").rglob("*.py"))


def test_main_path_modules_import_no_jax():
    modules = sorted(".".join(f.relative_to(REPO).with_suffix("").parts)
                     .removesuffix(".__init__") for f in PORT_FILES
                     if f.name != "__main__.py")  # that one runs the CLI
    code = ("import sys\n"
            f"import {', '.join(modules)}\n"
            "bad = sorted(m for m in ('jax', 'jaxlib', 'h5py', 'scrappie_tpu')\n"
            "             if m in sys.modules)\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", [*PORT_FILES, REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    """Not at module level and not inside a function: the port keeps its
    own copy of what it needs (comments may name their counterpart)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("scrappie_tpu", "jax", "jaxlib"), \
                f"{path.name}:{node.lineno} imports {name}"


#: The JAX package's public helpers that the port copies (scrappie_tpu's
#: module of the same path), each held to its original in
#: tests/test_torch_host.py.
HELPERS = (
    ("post.overlapper", "ctc_remove_stays_and_repeats"),
    ("utils.maths", "studentise"), ("utils.maths", "logsumexp2"),
    ("utils.maths", "loglaplace"), ("utils.maths", "plogistic"),
    ("utils", "studentise"), ("signal.features", "features_from_raw"),
    ("signal.features", "deltasample_features_from_raw"),
    ("models.registry", "get_model_stride"), ("models.calibration", "weights_sha"),
    ("ops.viterbi", "viterbi_scores_batch"), ("nn.rnn", "lstm"),
)


@pytest.mark.parametrize("module,name", HELPERS, ids=lambda v: str(v))
def test_public_helpers_are_the_ports_own(module, name):
    """Each copied helper is defined in a file of the port, which the
    import scans above cover (no scrappie_tpu, no JAX)."""
    import importlib
    import inspect

    fn = getattr(importlib.import_module(f"scrappie_torch.{module}"), name)
    source = pathlib.Path(inspect.getsourcefile(fn)).resolve()
    assert source in PORT_FILES, source


def test_module_entry_point_runs():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-m", "scrappie_torch", "version"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("scrappie_torch ")


def _inputs(seed=0, T=9, B=3, C=12, S=16, nstate=65):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (s * rng.standard_normal(shape)).astype(np.float32))
    return dict(x=f(T, B, C), iW=f(C, 3 * S, s=0.3), b=f(3 * S, s=0.1),
                sW=f(S, 2 * S, s=0.3), sW2=f(S, S, s=0.3),
                lp=f(T, B, nstate) - 3.0, h=f(T, B, S),
                W=f(S, nstate, s=2.0), bvec=f(nstate))


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    t = _inputs()
    ops.reset_launches()
    for reverse in (False, True):
        assert torch.equal(
            gru_layer_tm(t["x"], t["iW"], t["b"], t["sW"], t["sW2"], reverse),
            gru_layer_tm_plain(t["x"], t["iW"], t["b"], t["sW"], t["sW2"], reverse))
    final, tb = viterbi_scores_tm(t["lp"], 0.1, 0.2, 2.0, True)
    pfinal, ptb = viterbi_scores_tm_plain(t["lp"], 0.1, 0.2, 2.0, True)
    assert torch.equal(final, pfinal) and torch.equal(tb, ptb)
    for a, b in zip(viterbi_backtrace_tm(final, tb),
                    viterbi_backtrace_tm_plain(final, tb)):
        assert torch.equal(a, b)
    for a, b in zip(viterbi_fused_tm(t["h"], t["W"], t["bvec"]),
                    viterbi_fused_tm_plain(t["h"], t["W"], t["bvec"])):
        assert torch.equal(a, b)
    ens = (torch.stack([t["h"], -t["h"]]), torch.stack([t["W"], t["W"] / 2]),
           torch.stack([t["bvec"], t["bvec"]]), torch.tensor([0.75, 0.25]))
    for a, b in zip(viterbi_fused_ens_tm(*ens), viterbi_fused_ens_tm_plain(*ens)):
        assert torch.equal(a, b)
    x = t["x"] @ t["iW"] + t["b"]
    assert torch.equal(gru_tm(x, t["sW"], t["sW2"], True),
                       gru_tm_plain(x, t["sW"], t["sW2"], True))
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}


def test_wrappers_refuse_other_devices():
    t = _inputs()
    meta = t["lp"].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        viterbi_scores_tm(meta)
    with pytest.raises(ValueError, match="several devices"):
        gru_layer_tm(t["x"], t["iW"].to("meta"), t["b"], t["sW"], t["sW2"])
    with pytest.raises(ValueError, match="unsupported device"):
        crf_viterbi_scores_tm(torch.zeros((3, 2, 25), device="meta"))


def test_kernel_input_checks():
    x = torch.zeros((4, 3), dtype=torch.float32)
    ops.check_kernel_input("x", x, (4, 3))
    with pytest.raises(ValueError, match="shape"):
        ops.check_kernel_input("x", x, (3, 4))
    with pytest.raises(ValueError, match="dtype"):
        ops.check_kernel_input("x", x.double(), (4, 3))
    with pytest.raises(ValueError, match="contiguous"):
        ops.check_kernel_input("x", x.t(), (3, 4))


def test_cuda_requested_without_a_card_raises(no_cuda):
    from scrappie_torch import api
    from scrappie_torch.parallel.runner import BasecallEngine

    with pytest.raises(RuntimeError, match="cuda"):
        as_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        as_device(None)  # the default device is CUDA
    with pytest.raises(RuntimeError, match="cuda"):
        BasecallEngine("rgrgr_r94")
    with pytest.raises(RuntimeError, match="cuda"):
        api.basecall_raw(np.zeros(3000, np.float32) + 90.0)
    assert as_device("cpu") == torch.device("cpu")


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_build_is_keyed_by_source_content(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR
    src = csrc / "gru.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path() != first


def test_every_kernel_source_states_what_it_replaces():
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        if "__global__" in text:
            head = text.split("#include", 1)[0]
            assert "Replaces" in head and "bound" in head \
                and "H100" in head and "Design" in head, src.name


@pytest.mark.parametrize("a,b", [("", ""), ("", "ACG"), ("ACGT", "ACGT"),
                                 ("ACGTACGT", "ACGACGTT"), ("GATTACA", "TACA"),
                                 ("AAAA", "TTTTTT")])
def test_edit_distance_matches_levenshtein(a, b):
    import Levenshtein

    assert edit_distance(a, b) == Levenshtein.distance(a, b)


def test_edit_distance_on_long_random_sequences():
    import Levenshtein

    rng = np.random.default_rng(3)
    for n in (70, 300):
        a = "".join(rng.choice(list("ACGT"), n))
        b = list(a)
        for i in rng.choice(n, n // 20, replace=False):
            b[i] = "ACGT"[(("ACGT".index(b[i])) + 1) % 4]
        b = "".join(b[: n - 3]) + "GG"
        assert edit_distance(a, b) == Levenshtein.distance(a, b)


def test_flip_rule():
    a = "ACGT" * 100
    assert within_flip_rule(a, a)
    assert within_flip_rule(a, a[:-2])          # 2 edits in 400 bases
    assert not within_flip_rule(a, a[:-3])      # 3 edits > 0.5%
    assert not within_flip_rule(a, None)
