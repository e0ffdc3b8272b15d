"""The port's C++ host library (scrappie_torch/native) against its Python
twins, bit for bit, and against the JAX package's native path; its buffer
capacities, its build at first use (atomic, into build/scrappie_torch/)
and its refusal to fall back when it cannot be built.

g++ builds the library here, as on the machine with the card."""

import ctypes
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from scrappie_torch.native import bindings
from scrappie_torch.native import build as nbuild
from scrappie_torch.post import homopolymer as thp
from scrappie_torch.signal import events as tev
from scrappie_torch.types import RawSignal
from scrappie_tpu.post import homopolymer as jhp
from scrappie_tpu.signal import events as jev
from scrappie_tpu.types import RawSignal as JaxRawSignal

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = tev.EVENT_DETECTION_DEFAULTS


def stepped_signal(n: int, seed: int) -> np.ndarray:
    """Levels a few samples long with noise, as a read's current."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 6 + 1).repeat(6)[:n]
    return (levels + rng.normal(0.0, 0.25, n)).astype(np.float32)


SIGNALS = {
    "empty": np.zeros(0, np.float32),
    "shorter_than_windows": stepped_signal(5, 1),
    "twice_the_long_window": stepped_signal(12, 2),
    "thirteen": stepped_signal(13, 3),
    "constant": np.full(300, 2.5, np.float32),
    "read_3000": stepped_signal(3000, 4),
    "read_40000": stepped_signal(40000, 5),
    "wide_range": stepped_signal(5000, 6) * 300.0 + 1000.0,
}


def bitwise(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", SIGNALS)
def test_detect_tstat_equals_numpy_twin(name):
    data = SIGNALS[name]
    sums, sumsqs, t1, t2 = bindings.detect_tstat(data, PARAMS.window_length1,
                                                 PARAMS.window_length2)
    psums, psumsqs = tev.compute_sum_sumsq(data)
    assert bitwise(sums, psums) and bitwise(sumsqs, psumsqs)
    assert bitwise(t1, tev.compute_tstat(psums, psumsqs, PARAMS.window_length1))
    assert bitwise(t2, tev.compute_tstat(psums, psumsqs, PARAMS.window_length2))


@pytest.mark.parametrize("name", SIGNALS)
def test_peak_detector_equals_python_twin(name):
    data = SIGNALS[name]
    _, _, t1, t2 = bindings.detect_tstat(data, PARAMS.window_length1,
                                         PARAMS.window_length2)
    peaks = bindings.peak_detector(t1, t2, PARAMS.threshold1, PARAMS.threshold2,
                                   PARAMS.window_length1, PARAMS.window_length2,
                                   PARAMS.peak_height)
    assert bitwise(peaks, tev._peak_detector_python(t1, t2, PARAMS))


@pytest.mark.parametrize("name", SIGNALS)
def test_detect_events_equals_twin_and_jax(name):
    data = SIGNALS[name]
    et = tev.detect_events(RawSignal(data))
    assert bitwise(et.event, tev.detect_events_python(RawSignal(data)).event)
    assert bitwise(et.event, jev.detect_events(JaxRawSignal(data)).event)


def test_detect_events_on_a_trimmed_window():
    data = stepped_signal(20000, 7)
    rs = RawSignal(data, start=250, end=19900)
    et = tev.detect_events(rs)
    assert len(et.event) > 1000
    assert bitwise(et.event, tev.detect_events_python(rs).event)
    assert bitwise(et.event,
                   jev.detect_events(JaxRawSignal(data, start=250, end=19900)).event)


def kmer_walk(n: int, klen: int, seed: int, stay: float = 0.3,
              homo: float = 0.15) -> np.ndarray:
    """A path of kmers that mostly step by one base, with stays, skips and
    homopolymer runs."""
    rng = np.random.default_rng(seed)
    mask = (1 << (2 * klen)) - 1
    k = int(rng.integers(0, mask + 1))
    out = np.empty(n, np.int32)
    for i in range(n):
        u = rng.random()
        if u < stay:
            out[i] = -1
            continue
        if u < stay + homo:
            k = ((k << 2) | (k & 3)) & mask          # repeat the last base
        elif u < stay + homo + 0.1:
            k = ((k << 4) | int(rng.integers(0, 16))) & mask  # skip
        else:
            k = ((k << 2) | int(rng.integers(0, 4))) & mask
        out[i] = k
    return out


def homopolymer_kmer(base: int, klen: int) -> int:
    return thp.repeatblock(base, klen)


def run_paths() -> dict:
    """Seeded paths, and the edge cases of find_runs."""
    ACCCC, CCCCC = 0b0001010101, homopolymer_kmer(1, 5)  # X Y Y Y Y, Y Y Y Y Y
    GACCC = 0b1000010101  # Z X Y Y Y: enters the run by a skip
    paths = {f"walk_{klen}_{seed}": (kmer_walk(4000, klen, seed), klen)
             for klen, seed in ((5, 0), (5, 1), (4, 2), (3, 3), (2, 4), (6, 5))}
    paths["run_at_the_end"] = (np.array([ACCCC, CCCCC, -1, CCCCC], np.int32), 5)
    paths["run_into_the_last"] = (
        np.array([7, ACCCC, -1, CCCCC, -1, -1], np.int32), 5)
    paths["skip_then_stays"] = (
        np.array([7, GACCC, -1, -1, CCCCC, CCCCC, -1, 99, 5], np.int32), 5)
    paths["skip_to_the_end"] = (np.array([7, GACCC, -1, CCCCC], np.int32), 5)
    paths["stays_only"] = (np.full(50, -1, np.int32), 5)
    paths["empty"] = (np.zeros(0, np.int32), 5)
    paths["three"] = (np.array([ACCCC, CCCCC, CCCCC], np.int32), 5)
    return paths


RUN_PATHS = run_paths()


@pytest.mark.parametrize("name", RUN_PATHS)
def test_find_runs_equals_python_twin_and_jax(name):
    path, klen = RUN_PATHS[name]
    runs = thp.find_runs(path, klen)
    assert runs == thp.find_runs_python(path, klen)
    assert runs == jhp.find_runs(path, klen)
    assert all(type(v) is int for run in runs for v in run)
    if name.startswith("walk_5"):
        assert len(runs) > 20


def test_find_runs_edge_cases_find_their_runs():
    assert thp.find_runs(*RUN_PATHS["run_into_the_last"]) == [(2, 4, 1)]
    assert thp.find_runs(*RUN_PATHS["skip_then_stays"]) == [(4, 3, 1)]


def test_find_runs_refuses_one_base_kmers():
    with pytest.raises(ValueError, match="2 to 31"):
        thp.find_runs(np.zeros(9, np.int32), 1)
    with pytest.raises(ValueError, match="1 to 31"):
        bindings.dwell_overlapper(np.zeros(9, np.int32), np.ones(9), 32, 1.0)


def dwell_cases() -> dict:
    rng = np.random.default_rng(11)
    CCCCC, GGGGG = homopolymer_kmer(1, 5), homopolymer_kmer(2, 5)
    cases = {}
    for seed in range(3):
        path = kmer_walk(3000, 5, 20 + seed)
        cases[f"walk_{seed}"] = (path, rng.integers(1, 15, len(path)).astype(np.float64),
                                 2.7 + seed, (0.0, 0.0, 0.0, 0.0))
    path = kmer_walk(2000, 5, 30)
    cases["non_integer_dwell"] = (path, rng.uniform(0.1, 9.0, len(path)), 3.1,
                                  (0.0, 0.0, 0.0, 0.0))
    cases["base_adj"] = (path, rng.integers(1, 15, len(path)).astype(np.float64),
                         2.5, (0.5, -1.25, 3.0, -4.0))
    cases["stays_only"] = (np.full(40, -1, np.int32), np.ones(40), 2.0,
                           (0.0, 0.0, 0.0, 0.0))
    cases["empty"] = (np.zeros(0, np.int32), np.zeros(0), 2.0, (0.0, 0.0, 0.0, 0.0))
    cases["run_at_the_end"] = (np.array([-1, 5, CCCCC, -1, CCCCC, -1], np.int32),
                               np.array([3.0, 2.0, 4.0, 1.5, 2.5, 7.0]), 2.0,
                               (0.0, 0.0, 0.0, 0.0))
    cases["runs_back_to_back"] = (np.array([GGGGG, CCCCC, -1, GGGGG], np.int32),
                                  np.array([6.0, 2.0, 9.0, 4.0]), 3.0,
                                  (0.0, 0.0, 0.0, 0.0))
    # (hdwell - adj) / scale = 0.49999999999999994: llround gives 0, where
    # floor(x + 0.5) would give 1
    cases["just_below_a_half"] = (np.array([5, CCCCC], np.int32),
                                  np.array([0.0, 0.49999999999999994]), 1.0,
                                  (0.0, 0.0, 0.0, 0.0))
    cases["half_rounds_away_from_zero"] = (
        np.array([5, CCCCC, 9, CCCCC], np.int32), np.array([0.0, 5.0, 0.0, 7.0]),
        2.0, (0.0, 0.0, 0.0, 0.0))
    cases["negative_run"] = (np.array([5, CCCCC, -1, 9], np.int32),
                             np.array([0.0, 1.0, 1.0, 0.0]), 1.0,
                             (0.0, 6.0, 0.0, 0.0))
    return cases


DWELL_CASES = dwell_cases()


@pytest.mark.parametrize("name", DWELL_CASES)
def test_dwell_overlapper_equals_python_twin(name):
    path, dwell, scale, base_adj = DWELL_CASES[name]
    seq = thp.dwell_corrected_overlapper(path, dwell, 1024, scale, base_adj)
    assert seq == thp.dwell_corrected_overlapper_python(path, dwell, 1024, scale,
                                                        base_adj)
    assert (seq is None) == (name in ("stays_only", "empty"))
    if name == "just_below_a_half":
        assert seq == "AAACCCCC"  # AAACC, then CCCCC with no run after it


@pytest.mark.parametrize("name", [n for n in DWELL_CASES if n not in (
    "non_integer_dwell", "just_below_a_half")])
def test_dwell_overlapper_equals_jax(name):
    """scrappie_tpu's wrapper passes dwell as float32; dwells that float32
    holds (event lengths are whole numbers) are exact in both."""
    path, dwell, scale, base_adj = DWELL_CASES[name]
    assert thp.dwell_corrected_overlapper(path, dwell, 1024, scale, base_adj) == \
        jhp.dwell_corrected_overlapper(path, dwell, 1024, scale, base_adj)


def test_float32_dwell_is_summed_in_float64():
    path, dwell, scale, _ = DWELL_CASES["non_integer_dwell"]
    d32 = dwell.astype(np.float32)
    assert thp.dwell_corrected_overlapper(path, d32, 1024, scale) == \
        thp.dwell_corrected_overlapper_python(path, d32, 1024, scale) == \
        thp.dwell_corrected_overlapper(path, d32.astype(np.float64), 1024, scale)


def test_dwell_correction_of_an_events_read_equals_jax():
    """homopolymer_dwell_correction, which builds float64 event lengths."""
    from scrappie_torch.post import overlapper as tover

    path = kmer_walk(2500, 5, 40)
    lengths = np.random.default_rng(41).integers(2, 15, len(path)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.uint64)
    pos = np.zeros(len(path) + 1, dtype=np.int64)
    seq = tover.overlapper(path, 1024, pos)
    args = (lengths, starts, path, pos[:-1], 1 + path, 1025, len(seq))
    ours = thp.homopolymer_dwell_correction(*args)
    assert ours and ours == jhp.homopolymer_dwell_correction(*args)


def overrun_path(n: int = 1000, klen: int = 5, scale: float = 2.0):
    """GTGTG and CCCCC alternating: no two neighbours overlap, so every
    entry emits klen bases, and each CCCCC run's dwell of half a scale
    rounds up to one base more. scrappie_tpu's bound, klen (n + 1) +
    sum(dwell) / scale + 64, is n / 4 - 64 - klen bytes short."""
    gtgtg, ccccc = 0b1011101110, homopolymer_kmer(1, klen)
    path = np.where(np.arange(n) % 2, ccccc, gtgtg).astype(np.int32)
    dwell = np.where(np.arange(n) % 2, 0.5 * scale, 0.0)
    old_bound = int(klen * (n + 1) + np.abs(dwell).sum() / scale + 64)
    return path, dwell, scale, old_bound


def test_a_path_past_the_old_bound_is_called_in_full():
    path, dwell, scale, old_bound = overrun_path()
    seq = thp.dwell_corrected_overlapper(path, dwell, 1024, scale)
    assert seq == thp.dwell_corrected_overlapper_python(path, dwell, 1024, scale)
    assert len(seq) == 5 * 1000 + 500 > old_bound


def test_a_path_past_its_capacity_raises(monkeypatch):
    """With scrappie_tpu's bound for its buffer, the path raises."""
    path, dwell, scale, old_bound = overrun_path()
    monkeypatch.setattr(bindings, "dwell_capacity", lambda *args: old_bound)
    with pytest.raises(ValueError, match="pass its buffer"):
        thp.dwell_corrected_overlapper(path, dwell, 1024, scale)


@pytest.mark.parametrize("capacity", [0, 3, 4999, 5000, 5499])
def test_the_overlapper_writes_nothing_past_its_capacity(capacity):
    path, dwell, scale, _ = overrun_path()
    guard = 64
    buf = ctypes.create_string_buffer(b"#" * (capacity + guard), capacity + guard)
    got = bindings.library().stpu_dwell_overlapper(
        path, dwell, len(path), 5, scale, np.zeros(4), buf, capacity)
    assert got == bindings.OVERFLOW
    assert buf.raw[capacity:] == b"#" * guard
    full = thp.dwell_corrected_overlapper_python(path, dwell, 1024, scale)
    assert full.encode().startswith(buf.raw[:capacity].rstrip(b"#"))


def test_find_runs_and_peaks_write_nothing_past_their_capacity():
    path, klen = RUN_PATHS["walk_5_0"]
    nruns = len(thp.find_runs(path, klen))
    cap, guard = nruns - 1, 8
    outs = [np.full(cap + guard, -7, np.int64) for _ in range(3)]
    got = bindings.library().stpu_find_runs(path, len(path), klen, *outs, cap)
    assert got == bindings.OVERFLOW
    assert all((o[cap:] == -7).all() for o in outs)

    data = SIGNALS["read_3000"]
    _, _, t1, t2 = bindings.detect_tstat(data, 3, 6)
    npeak = int((bindings.peak_detector(t1, t2, 1.4, 9.0, 3, 6, 0.2) > 0).sum())
    out = np.full(npeak + guard - 1, -7, np.int64)
    got = bindings.library().stpu_peak_detector(t1, t2, len(t1), 1.4, 9.0, 3, 6,
                                                0.2, out, npeak - 1)
    assert got == bindings.OVERFLOW and (out[npeak - 1:] == -7).all()


def test_the_overlapper_refuses_what_it_cannot_bound():
    path, dwell, scale, _ = DWELL_CASES["walk_0"]
    for bad_scale in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="scale"):
            bindings.dwell_overlapper(path, dwell, 5, bad_scale)
    with pytest.raises(ValueError, match="finite"):
        bindings.dwell_overlapper(path, np.where(np.arange(len(path)) == 3, np.inf,
                                                 dwell), 5, scale)
    with pytest.raises(ValueError, match="dwell"):
        bindings.dwell_overlapper(path, dwell[:-1], 5, scale)


def test_the_library_builds_outside_the_source_tree():
    path = nbuild.library_path()
    assert path.parent == REPO / "build" / "scrappie_torch"
    assert nbuild.SRC.parent.parent == REPO / "scrappie_torch" / "native"
    assert bindings.library()._name == str(path)
    assert "-ffp-contract=off" in nbuild.CXX_FLAGS
    assert not any("fast-math" in f for f in nbuild.CXX_FLAGS)
    assert not list(nbuild.SRC.parent.parent.rglob("*.so"))


def test_the_library_name_carries_the_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "host_kernels.cpp"
    src.write_text(nbuild.SRC.read_text())
    monkeypatch.setattr(nbuild, "SRC", src)
    first = nbuild.library_path()
    assert first == nbuild.library_path()
    src.write_text(src.read_text() + "\n// edited\n")
    assert nbuild.library_path() != first


def test_importing_the_port_loads_no_library():
    code = ("import scrappie_torch.signal.events, scrappie_torch.post.homopolymer\n"
            "from scrappie_torch.native import bindings\n"
            "assert bindings._load_library.cache_info().currsize == 0\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


BUILD_AT = """
import pathlib, sys, time
from scrappie_torch.native import bindings, build
build.BUILD_DIR = pathlib.Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
lib = bindings.library()
print(lib._name)
print(bindings.find_runs([85, 341, -1, 341, 5, 5], 5))
"""


def test_two_processes_building_at_once_load_the_same_library(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    start = time.time() + 4.0
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AT, str(tmp_path),
                               repr(start)], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = [out.splitlines()[0] for out, _ in outs]
    assert names[0] == names[1]
    assert pathlib.Path(names[0]).parent == tmp_path
    assert [out.splitlines()[1] for out, _ in outs] == ["[(1, 3, 1)]"] * 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [pathlib.Path(names[0]).name]


@pytest.fixture
def fresh_library(tmp_path, monkeypatch):
    """Builds into an empty directory; the loaded library is forgotten
    before and after."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path)
    bindings._load_library.cache_clear()
    yield tmp_path
    bindings._load_library.cache_clear()


def test_without_gxx_the_port_raises(fresh_library, monkeypatch):
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    data = SIGNALS["read_3000"]
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tev.detect_events(RawSignal(data))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        thp.find_runs(RUN_PATHS["walk_5_0"][0], 5)
    path, dwell, scale, _ = DWELL_CASES["walk_0"]
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        thp.dwell_corrected_overlapper(path, dwell, 1024, scale)
    assert not list(fresh_library.iterdir())


def test_a_failed_compile_raises_with_its_stderr(fresh_library, monkeypatch):
    broken = fresh_library / "broken.cpp"
    broken.write_text('extern "C" int stpu_find_runs( { }\n')
    monkeypatch.setattr(nbuild, "SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp(.|\n)*error"):
        thp.find_runs(np.zeros(9, np.int32), 5)
    assert [p.name for p in fresh_library.iterdir()] == ["broken.cpp"]
