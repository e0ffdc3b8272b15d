"""Posterior-to-sequence mapping on the CPU: the port (its plain twins)
against the JAX package on the same seeded posteriors, dense (Viterbi with
and without a path, forward) and banded, through decode/mapping.py, the
API and the seqmappy CLI; and the event_table CLI.

The DP only adds and takes maxima, in the scan's order, so Viterbi finals,
tracebacks and paths are expected to be identical; forward finals and
scores are held to rtol 1e-5 and atol 1e-4 (expf/log1pf in another
implementation). Where each package computes its own rgrgr_r94 posterior
(the CLI), the posteriors differ by the GRU's rounding, and the score is
held to the same tolerance."""

import contextlib
import io

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrappie_torch import api as tapi
from scrappie_torch import ops
from scrappie_torch.cli.main import main as torch_main
from scrappie_torch.decode import mapping as tmap
from scrappie_torch.ops import seqmap as tops
from scrappie_tpu import api as japi
from scrappie_tpu.cli.main import main as tpu_main
from scrappie_tpu.decode import mapping as jmap
from scrappie_tpu.ops.seqmap import map_to_sequence_tm as j_map_tm

torch.set_num_threads(1)
FINAL_TOL = dict(rtol=1e-5, atol=1e-4)
PENALTIES = dict(stay_pen=0.2, skip_pen=0.7, local_pen=4.0)


def dirichlet_logpost(T: int, nst: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.ones(nst), T)).astype(np.float32)


def synthetic_signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA, with a quiet stretch at each end to trim."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    sig = 90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)
    sig[:300] = 60.0 + rng.normal(0.0, 0.2, 300)
    sig[-150:] = 60.0 + rng.normal(0.0, 0.2, 150)
    return sig.astype(np.float32)


@pytest.fixture(scope="module")
def read_post():
    """The rgrgr_r94 log posterior of a synthetic 3000-sample read (from
    scrappie_tpu, handed to both packages) and its basecall as the
    reference sequence."""
    data = synthetic_signal(3000, seed=110)
    raw = japi.RawTable(data)
    raw.trim().scale()
    post = japi.calc_post(raw, "rgrgr_r94")
    seq, _, _ = japi.decode_post(post, "rgrgr_r94")
    assert len(seq) > 100
    return np.asarray(post.data()), seq


@pytest.mark.parametrize("T,nst,seqlen", [(21, 17, 9), (60, 1025, 50)])
@pytest.mark.parametrize("viterbi", [True, False])
def test_seqmap_twin_matches_jax(T, nst, seqlen, viterbi):
    lp = dirichlet_logpost(T, nst, seed=T + seqlen)
    seqstates = np.random.default_rng(seqlen).integers(0, nst - 1, seqlen).astype(np.int32)
    pens = tuple(PENALTIES.values())
    scan_final, scan_tb = jmap._map_dense(jnp.asarray(lp), jnp.asarray(seqstates),
                                          *pens, viterbi, True)
    pallas_final, pallas_tb = j_map_tm(jnp.asarray(lp), jnp.asarray(seqstates),
                                       *pens, viterbi=viterbi, interpret=True)
    final, tb = tops.map_to_sequence_tm(torch.from_numpy(lp),
                                        torch.from_numpy(seqstates), *pens,
                                        viterbi=viterbi)
    assert final.shape == (seqlen + 2,)
    for ref in (scan_final, pallas_final):
        np.testing.assert_allclose(final.numpy(), np.asarray(ref), **FINAL_TOL)
    if viterbi:
        assert tb.dtype == torch.int32 and tb.shape == (T, seqlen + 2)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(scan_tb))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(pallas_tb))
    else:
        assert tb is None


@pytest.mark.parametrize("viterbi", [True, False])
def test_seqmap_keeps_minus_inf_as_the_scan_does(viterbi):
    """-inf log posteriors are not clamped (the Pallas kernel clamps them
    for its one-hot matmul; the scan does not), and -inf with -inf gives
    -inf, not NaN."""
    lp = dirichlet_logpost(40, 17, seed=5)
    lp[::3, 4] = -np.inf
    lp[5:9, -1] = -np.inf
    seqstates = np.array([4, 4, 1, 4, 7, 4, 2, 4], dtype=np.int32)
    ref_final, ref_tb = jmap._map_dense(jnp.asarray(lp), jnp.asarray(seqstates),
                                        0.0, 0.0, 4.0, viterbi, True)
    final, tb = tops.map_to_sequence_plain(torch.from_numpy(lp),
                                           torch.from_numpy(seqstates),
                                           viterbi=viterbi)
    assert not torch.isnan(final).any()
    np.testing.assert_allclose(final.numpy(), np.asarray(ref_final), **FINAL_TOL)
    if viterbi:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(ref_tb))


def _bands(nblock: int, seqlen: int, half: int):
    gradient = seqlen / nblock
    low = np.maximum(0, np.arange(nblock) * gradient - half * gradient).astype(np.int64)
    high = np.minimum(seqlen, np.arange(nblock) * gradient + half * gradient).astype(np.int64)
    low[0], high[-1] = 0, seqlen
    return low, high


def test_decode_functions_match_jax():
    lp = dirichlet_logpost(150, 1025, seed=7)
    seq = np.random.default_rng(8).integers(0, 1024, 60)
    kw = dict(PENALTIES)
    assert tmap.map_to_sequence_viterbi(lp, seq, device="cpu", **kw) == \
        jmap.map_to_sequence_viterbi(lp, seq, **kw)
    score, path = tmap.map_to_sequence_viterbi(lp, seq, want_path=True,
                                               device="cpu", **kw)
    jscore, jpath = jmap.map_to_sequence_viterbi(lp, seq, want_path=True, **kw)
    assert score == jscore
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_allclose(tmap.map_to_sequence_forward(lp, seq, device="cpu", **kw),
                               jmap.map_to_sequence_forward(lp, seq, **kw), **FINAL_TOL)
    # a tensor runs on its own device
    assert tmap.map_to_sequence_viterbi(torch.from_numpy(lp), seq, **kw) == jscore
    for half in (1, 10, 40):
        low, high = _bands(150, 60, half)
        assert tmap.are_bounds_sane(low, high, 150, 60)
        for viterbi in (True, False):
            ref = jmap.map_to_sequence_banded(lp, seq, low, high, viterbi=viterbi, **kw)
            out = tmap.map_to_sequence_banded(lp, seq, low, high, viterbi=viterbi,
                                              device="cpu", **kw)
            np.testing.assert_allclose(out, ref, **FINAL_TOL)


@pytest.mark.parametrize("viterbi,path", [(True, True), (True, False), (False, False)])
def test_map_post_to_sequence_matches_jax(read_post, viterbi, path):
    lp, seq = read_post
    ref = seq[10:-10]
    for bands in (None, 30, "pair"):
        if bands == "pair":
            low, high = _bands(lp.shape[0], len(ref) - 4, 20)
            bands = (low, np.minimum(high + 3, len(ref) - 4))
        if path and bands is not None:
            continue
        kw = dict(viterbi=viterbi, path=path, bands=bands, skip_pen=0.3)
        jscore, jpath = japi.map_post_to_sequence(japi.Posterior(lp, "rgrgr_r94"),
                                                  ref, **kw)
        score, p = tapi.map_post_to_sequence(tapi.Posterior(lp, "rgrgr_r94"), ref,
                                             device="cpu", **kw)
        if viterbi:
            assert score == jscore
        np.testing.assert_allclose(score, jscore, **FINAL_TOL)
        if path:
            np.testing.assert_array_equal(p, jpath)
            assert (p >= 0).mean() > 0.7  # the reference lacks 10 bases at each end
        else:
            assert p is None and jpath is None


def test_map_post_to_sequence_errors(read_post):
    lp, seq = read_post
    post = tapi.Posterior(lp, "rgrgr_r94")
    with pytest.raises(ValueError, match="non-ACGT"):
        tapi.map_post_to_sequence(post, seq[:50] + "N", device="cpu")
    with pytest.raises(ValueError, match="viterbi"):
        tapi.map_post_to_sequence(post, seq, path=True, device="cpu")
    low, high = _bands(lp.shape[0], len(seq) - 4, 20)
    with pytest.raises(ValueError, match="not valid"):
        tapi.map_post_to_sequence(post, seq, bands=(low[::-1], high), device="cpu")
    with pytest.raises(ValueError, match="length 2"):
        tapi.map_post_to_sequence(post, seq, bands=(low, high, low), device="cpu")
    with pytest.raises(TypeError, match="Posterior"):
        tapi.map_post_to_sequence(lp, seq, device="cpu")
    with pytest.raises(ValueError, match="not valid"):
        tmap.map_to_sequence_banded(lp, np.zeros(9, np.int64), low, high)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.map_post_to_sequence(post, seq)


def test_seqmap_launches_nothing_on_the_cpu_and_sizes_its_state():
    ops.reset_launches()
    lp = torch.from_numpy(dirichlet_logpost(10, 17, seed=1))
    tops.map_to_sequence_tm(lp, torch.arange(5, dtype=torch.int32))
    assert ops.LAUNCHES["seqmap"] == 0
    assert tops.SEQMAP_MAX_SHARED_SEQLEN == 28029
    n = tops.SEQMAP_MAX_SHARED_SEQLEN
    assert tops.shared_bytes(1025, n, True) <= ops.MAX_SMEM_BYTES
    assert tops.shared_bytes(1025, n + 1, True) > ops.MAX_SMEM_BYTES
    tops.check_seqmap_input(lp, torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        tops.check_seqmap_input(lp, torch.arange(5))
    with pytest.raises(ValueError, match="contiguous"):
        tops.check_seqmap_input(lp.t().contiguous().t(), torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        tops.check_seqmap_input(torch.zeros((2, 30000)), torch.arange(5, dtype=torch.int32))


def test_api_hands_the_seqmap_kernel_its_layout(monkeypatch, read_post):
    """On a CUDA tensor the seqmap wrapper raises unless its inputs are
    contiguous and of the kernel's types; the twin takes any layout. So the
    twin here runs the kernel's input checks first: every path that
    reaches it must pass."""
    seen = []
    plain = tops.map_to_sequence_plain

    def checked(lp, seqstates, *args, **kwargs):
        tops.check_seqmap_input(lp, seqstates)
        seen.append(tuple(lp.shape))
        return plain(lp, seqstates, *args, **kwargs)

    monkeypatch.setattr(tops, "map_to_sequence_plain", checked)
    lp, seq = read_post
    post = tapi.Posterior(lp, "rgrgr_r94")
    tapi.map_post_to_sequence(post, seq, viterbi=True, path=True, device="cpu")
    tapi.map_post_to_sequence(post, seq, device="cpu")
    sloika = tapi.Posterior(post.data(as_numpy=True, sloika=False)[:, ::-1],
                            "rgrgr_r94")
    tapi.map_post_to_sequence(sloika, seq, viterbi=True, device="cpu")
    assert len(seen) == 3


def _write_fast5(path, data: np.ndarray, read_id: str) -> None:
    digitisation, rng_pa, offset = 8192.0, 1400.0, 10.0
    adc = np.round(data / (rng_pa / digitisation) - offset).astype(np.int16)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_4")
        grp.create_dataset("Signal", data=adc)
        grp.attrs["read_id"] = read_id
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = digitisation
        meta["range"] = rng_pa
        meta["offset"] = offset
        meta["sampling_rate"] = 4000.0


def _run(main, argv) -> str:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    assert code == 0, err.getvalue()
    return out.getvalue()


@pytest.mark.parametrize("extra", [[], ["--stay", "0.2", "--skip", "0.5",
                                        "--localpen", "3"]])
def test_cli_seqmappy_matches_scrappie_tpu(tmp_path, extra):
    data = synthetic_signal(3200, seed=120)
    _write_fast5(tmp_path / "read.fast5", data, "seqmappy-read")
    seq, *_ = japi.basecall_raw(data)
    (tmp_path / "ref.fa").write_text(f">ref\n{seq[5:-5]}\n")
    argv = ["seqmappy", *extra, str(tmp_path / "ref.fa"), str(tmp_path / "read.fast5")]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    ref = _run(tpu_main, argv)
    (head, *rows), (jhead, *jrows) = ours.splitlines(), ref.splitlines()
    assert rows == jrows and len(rows) > 400
    words, jwords = head.split(), jhead.split()
    assert len(words) == len(jwords)
    for w, jw in zip(words, jwords):
        if w != jw:
            np.testing.assert_allclose(float(w.strip("()")), float(jw.strip("()")),
                                       **FINAL_TOL)


def test_cli_event_table_matches_scrappie_tpu(tmp_path):
    for i, n in enumerate((4000, 6000)):
        _write_fast5(tmp_path / f"r{i}.fast5", synthetic_signal(n, seed=130 + i),
                     f"events-{i}")
    argv = ["event_table", "--trim", "100:20", str(tmp_path)]
    ours = _run(torch_main, argv[:1] + ["--device", "cpu"] + argv[1:])
    assert ours.count("#event\tstart") == 2
    assert ours == _run(tpu_main, argv)
