"""The port's real-read training data (train/realdata.py, realsim.py and
tails.py) against the JAX package's.

The samplers, labels, the empirical model and its simulator are numpy on
the host, drawn in the same order from the same seeds, so they are held
equal bit for bit on synthetic LabelledReads with a known base_at (the
reads tests/test_train_data.py builds). label_read runs a network and the
posterior-to-sequence map: it is held to the JAX package's on a simulated
read (same orientation, base_at equal, score within 1e-5 relative). The
bundled truth reads are absent here: the functions that read them give
what the JAX package's give without them."""

import numpy as np
import pytest
import torch

from scrappie_torch.train import realdata as trd
from scrappie_torch.train import realsim as trs
from scrappie_torch.train import tails as ttails
from scrappie_tpu.train import realdata as jrd
from scrappie_tpu.train import realsim as jrs
from scrappie_tpu.train import tails as jtails

torch.set_num_threads(1)


def synth_read(mod, seed=0, seqlen=400, dwell=12, name="synth"):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=seqlen).astype(np.int64)
    levels = rng.normal(size=seqlen).astype(np.float32)
    dwells = np.maximum(rng.poisson(dwell, size=seqlen), 3)
    base_at = np.repeat(np.arange(seqlen), dwells)
    norm = levels[base_at] + 0.08 * rng.standard_normal(len(base_at)).astype(
        np.float32)
    return mod.LabelledRead(name, norm.astype(np.float32), bases,
                            base_at.astype(np.int64), 0.5)


def reads(mod):
    return [synth_read(mod, 3), synth_read(mod, 4, seqlen=300, name="b"),
            synth_read(mod, 6, seqlen=120, dwell=10, name="short")]


def assert_same(a, b):
    """Equal bit for bit, through tuples, lists and dataclasses."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            assert_same(getattr(a, k), getattr(b, k))
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, (a.dtype, np.asarray(b).dtype)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("stride", [2, 4, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_labels_match_jax(seed, stride):
    t, j = synth_read(trd, seed), synth_read(jrd, seed)
    assert_same(trd.transducer_labels(t.base_at, t.bases, stride),
                jrd.transducer_labels(j.base_at, j.bases, stride))
    assert_same(trd.crf_labels(t.base_at, t.bases, stride),
                jrd.crf_labels(j.base_at, j.bases, stride))
    for s0, n, L in ((500, 600, 64), (0, 40, 8), (10, 3, 5)):
        assert_same(trd.window_seqstates(t.base_at[s0:s0 + n], t.bases, L),
                    jrd.window_seqstates(j.base_at[s0:s0 + n], j.bases, L))
    seq = "".join("ACGT"[b] for b in t.bases)
    assert trd.revcomp(seq) == jrd.revcomp(seq)
    assert_same(trd._bases_to_ints(seq), jrd._bases_to_ints(seq))


@pytest.mark.parametrize("kind,augment", [("transducer", False),
                                          ("transducer", True), ("crf", False),
                                          ("crf", True)])
def test_raw_sampler_matches_jax(kind, augment):
    ts = trd.RealReadSampler(reads(trd), holdout_frac=0.25, seed=11)
    js = jrd.RealReadSampler(reads(jrd), holdout_frac=0.25, seed=11)
    for nsample in (1000, 3000):
        assert_same(ts.batch(3, nsample, 5, kind, augment),
                    js.batch(3, nsample, 5, kind, augment))
    assert_same(ts.seq_batch(3, 800, 90, augment), js.seq_batch(3, 800, 90,
                                                                augment))
    for r in range(3):
        assert_same(ts.eval_segment(r), js.eval_segment(r))
    assert_same(ts.train_region_reads(), js.train_region_reads())


@pytest.mark.parametrize("full", [False, True])
def test_event_sampler_matches_jax(full):
    names = frozenset({"b"}) if full else frozenset()
    ts = trd.RealEventSampler(reads(trd), seed=5, full_train_names=names)
    js = jrd.RealEventSampler(reads(jrd), seed=5, full_train_names=names)
    assert ts._train_nev == js._train_nev
    for a, b in zip(ts._ev, js._ev):
        for k in ("feats", "ev_base", "kmers"):
            assert_same(a[k], b[k])
    for nevent in (64, 500):
        assert_same(ts.batch(3, nevent), js.batch(3, nevent))
        assert_same(ts.seq_batch(3, nevent, 70), js.seq_batch(3, nevent, 70))
    for r in range(3):
        for whole in (False, True):
            assert_same(ts.eval_events(r, whole), js.eval_events(r, whole))


@pytest.fixture(scope="module")
def models():
    return (trs.EmpiricalModel.fit(reads(trd)),
            jrs.EmpiricalModel.fit(reads(jrd)))


def test_empirical_model_fit_matches_jax(models):
    tm, jm = models
    assert_same(tm, jm)
    assert len(tm.read_stats) == 3
    empty_t, empty_j = (trs.EmpiricalModel.fit([]), jrs.EmpiricalModel.fit([]))
    assert_same(empty_t, empty_j)


@pytest.mark.parametrize("opts", [{}, {"hetero_sd": False, "rate_drift": 0.0},
                                  {"real_seq_p": 1.0}])
def test_realistic_simulator_matches_jax(models, opts):
    tsim = trs.RealisticSimulator(models[0], seed=3, **opts)
    jsim = jrs.RealisticSimulator(models[1], seed=3, **opts)
    assert_same(tsim.labelled_batch(2, 1500, 5), jsim.labelled_batch(2, 1500, 5))
    assert_same(tsim.crf_labelled_batch(2, 1000, 2),
                jsim.crf_labelled_batch(2, 1000, 2))
    assert_same(tsim.seq_batch(2, 1200, 80), jsim.seq_batch(2, 1200, 80))


@pytest.mark.parametrize("noise_sd", [0.0, 0.12])
def test_augment_window_matches_jax(noise_sd):
    r = synth_read(trd, 8)
    a = trs.augment_window(r.norm[:900], r.base_at[:900],
                           np.random.default_rng(4), noise_sd=noise_sd)
    b = jrs.augment_window(r.norm[:900], r.base_at[:900],
                           np.random.default_rng(4), noise_sd=noise_sd)
    assert_same(a, b)


@pytest.mark.parametrize("pair", [("ACGT", "ACGT"), ("ACGTT", "AGT"), ("", ""),
                                  ("A", ""), ("GATTACA", "GCATGCU")])
def test_identity_matches_jax(pair):
    assert ttails.identity(*pair) == pytest.approx(jtails.identity(*pair), abs=0)


def test_absent_reads_give_what_jax_gives(monkeypatch, tmp_path):
    """Without bundled reads: no truth pairs, no labelled reads, no tail
    pairs and a NaN mean, as in the JAX package. With a directory of pairs
    the port lists the same (name, fast5, truth) as the JAX package's
    READS_DIR would."""
    monkeypatch.delenv(trd.READS_ENV, raising=False)
    assert trd.bundled_truth_reads() == []
    monkeypatch.setattr(jrd, "READS_DIR", str(tmp_path / "absent"))
    assert jrd.bundled_truth_reads() == []
    assert trd.load_labelled_reads(device="cpu") == jrd.load_labelled_reads() == []
    assert ttails.tail_identities("rgrgr_r94", device="cpu") == []
    assert np.isnan(ttails.mean_tail_identity("nanonet_events", device="cpu"))
    assert np.isnan(jtails.mean_tail_identity("nanonet_events"))
    for i, name in enumerate(("x_HG_52221_ch1_read2_strand",
                              "y_HG_52221_ch3_read4_strand")):
        (tmp_path / f"{name}.fa").write_text(f">r{i}\nACGT\nTTGA\n")
    monkeypatch.setenv(trd.READS_ENV, str(tmp_path))
    monkeypatch.setattr(jrd, "READS_DIR", str(tmp_path))
    got = trd.bundled_truth_reads()
    assert got == jrd.bundled_truth_reads()
    assert [g[0] for g in got] == ["ch1_read2", "ch3_read4"]


def test_label_read_matches_jax_on_a_simulated_read():
    """label_read on a 3 000-sample simulated read against its truth: the
    same orientation (bases), base_at equal, the score per block within
    1e-5 relative; the reverse complement's truth picks the other
    orientation and the same labels."""
    from scrappie_tpu.models import registry

    from scrappie_torch.train.simulate import SquiggleSimulator

    sim = SquiggleSimulator(seed=21, device="cpu")
    sig, bases, _ = sim.simulate_read(330)
    sig = sig[:3000]
    med = np.median(sig)
    norm = ((sig - med) / (np.median(np.abs(sig - med)) * 1.4826)).astype(
        np.float32)
    truth = "".join("ACGT"[b] for b in bases)
    params = registry.load_params("rgrgr_r94")
    for seq in (truth, trd.revcomp(truth)):
        t = trd.label_read(norm, seq, params=params, name="sim", device="cpu")
        j = jrd.label_read(norm, seq, params=params, name="sim")
        assert_same(t.bases, j.bases)
        assert_same(t.base_at, j.base_at)
        assert_same(t.norm, j.norm)
        assert t.map_score == pytest.approx(j.map_score, rel=1e-5)
        assert (t.base_at >= 0).mean() > 0.5
