"""The port's copies of the JAX package's host code (numpy and Python)
against their originals, on seeded inputs: the results must be equal.

scrappie_torch imports nothing of scrappie_tpu, so it keeps its own copy
of trimming, normalisation, chunking, the overlapper, the homopolymer
corrections, event detection and features, FASTA reading and FASTA/SAM
writing, fast5 reading, the calibration presets, the weight loader, the
API's base encoding and state-space guess, the DTW's penalties and the
mapping's band check. Where
scrappie_tpu runs native C++ (event detection, find_runs, the dwell
overlapper), the port's numpy and Python code is held to that default
path."""

import tempfile

import h5py
import numpy as np
import pytest

from scrappie_torch import api as tapi
from scrappie_torch import types as ttypes
from scrappie_torch.decode import dtw as tdtw
from scrappie_torch.decode import mapping as tmapping
from scrappie_torch.io import fast5 as tfast5
from scrappie_torch.io import fasta as tfasta
from scrappie_torch.models import calibration as tcal
from scrappie_torch.models import registry as treg
from scrappie_torch.parallel import chunk as tchunk
from scrappie_torch.post import homopolymer as thp
from scrappie_torch.post import overlapper as tover
from scrappie_torch.signal import events as tevents
from scrappie_torch.signal import features as tfeat
from scrappie_torch.signal import trim as ttrim
from scrappie_torch.utils import maths as tmaths
from scrappie_tpu import api as japi
from scrappie_tpu import types as jtypes
from scrappie_tpu.decode import dtw as jdtw
from scrappie_tpu.decode import mapping as jmapping
from scrappie_tpu.io import fast5 as jfast5
from scrappie_tpu.io import fasta as jfasta
from scrappie_tpu.models import calibration as jcal
from scrappie_tpu.models import registry as jreg
from scrappie_tpu.parallel import chunk as jchunk
from scrappie_tpu.post import homopolymer as jhp
from scrappie_tpu.post import overlapper as jover
from scrappie_tpu.signal import events as jevents
from scrappie_tpu.signal import features as jfeat
from scrappie_tpu.signal import trim as jtrim
from scrappie_tpu.utils import maths as jmaths


def signal(n: int, seed: int) -> np.ndarray:
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA, with a quiet stretch at each end to trim."""
    rng = np.random.default_rng(seed)
    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    sig = 90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)
    sig[:300] = 60.0 + rng.normal(0.0, 0.2, 300)
    sig[-150:] = 60.0 + rng.normal(0.0, 0.2, 150)
    return sig.astype(np.float32)


def kmer_path(n: int, seed: int) -> np.ndarray:
    """A transducer path of 5-mers (-1 = stay) moving by steps and skips,
    with homopolymer runs entered from a step (XAAAA -> AAAAA) and from a
    skip (ZXAAA -> AAAAA)."""
    rng = np.random.default_rng(seed)
    path, k = [], int(rng.integers(1024))
    while len(path) < n:
        move = rng.random()
        if move < 0.3:
            path.append(-1)
            continue
        if move < 0.4:  # into a homopolymer run of base b
            b = int(rng.integers(4))
            rep = b * 341  # bbbbb
            entry = (int(rng.integers(4)) * 256 + (rep % 256)
                     if rng.random() < 0.5
                     else int(rng.integers(16)) * 64 + (rep % 64))
            path.extend([entry] + [rep if rng.random() < 0.6 else -1
                                   for _ in range(int(rng.integers(2, 7)))])
            k = rep
            continue
        shift = 1 if move < 0.85 else 2
        k = (k * 4 ** shift + int(rng.integers(4 ** shift))) % 1024
        path.append(k)
    return np.asarray(path[:n], dtype=np.int32)


def logpost(T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, 1025)).astype(np.float32) * 3.0
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def both(fn):
    """Run fn on the port's modules and on the JAX package's."""
    port = dict(types=ttypes, trim=ttrim, maths=tmaths, chunk=tchunk,
                over=tover, hp=thp, events=tevents, feat=tfeat, fasta=tfasta,
                fast5=tfast5, cal=tcal, reg=treg, api=tapi, dtw=tdtw,
                mapping=tmapping)
    ref = dict(types=jtypes, trim=jtrim, maths=jmaths, chunk=jchunk,
               over=jover, hp=jhp, events=jevents, feat=jfeat, fasta=jfasta,
               fast5=jfast5, cal=jcal, reg=jreg, api=japi, dtw=jdtw,
               mapping=jmapping)
    return fn(**port), fn(**ref)


def case_trim(types, trim, **_):
    rs = types.RawSignal(signal(6000, 1), uuid="r")
    a = trim.trim_raw_by_mad(rs, 100, 0.1)
    b = trim.trim_and_segment_raw(rs, 200, 10, 100, 0.0)
    return (a.start, a.end), (b.start, b.end, b.uuid), b.trimmed


def case_maths(maths, **_):
    x = signal(5001, 2)
    return (maths.quantilef(x, [0.1, 0.5, 0.93]), maths.madf(x),
            maths.medmad_normalise(x), maths.medmad_normalise(x[:1]))


def case_chunks(chunk, **_):
    rng = np.random.default_rng(3)
    out = []
    for n, chunk_len, overlap, stride in ((9001, 2000, 200, 5), (700, 2000, 200, 5),
                                          (5000, 2048, 256, 1)):
        plan = chunk.plan_chunks(n, chunk_len, overlap, stride)
        x = rng.standard_normal((n, 4) if stride == 1 else n).astype(np.float32)
        chunks = chunk.extract_chunks(x, plan)
        nb = plan.nblock_chunk
        blocks = rng.standard_normal((plan.nchunk, nb, 3)).astype(np.float32)
        paths = rng.integers(-1, 1024, (plan.nchunk, nb + 1)).astype(np.int32)
        out += [plan.starts, chunks, chunk.chunk_keep_ranges(plan),
                chunk.stitch_blocks(blocks, plan), chunk.stitch_paths(paths, plan),
                chunk.neutral_pad_logpost(blocks[0], nb + 7, 0.5)]
    return out


def case_overlapper(over, **_):
    path = kmer_path(3000, 4)
    pos = np.zeros(len(path), dtype=np.int64)
    return over.overlapper(path, 1024, pos), pos, over.overlapper(np.full(9, -1), 1024)


def case_homopolymer_path(hp, **_):
    path = kmer_path(3001, 5)
    lp = logpost(3000, 6)
    runs = hp.find_runs(path[:3000], 5)
    assert len(runs) > 20
    mean = hp.homopolymer_path(lp, path.copy(), hp.HomopolymerMode.MEAN)
    same = hp.homopolymer_path(lp, path.copy(), hp.HomopolymerMode.parse("nochange"))
    return runs, mean, same


def case_dwell_correction(hp, over, **_):
    path = kmer_path(2000, 7)
    rng = np.random.default_rng(8)
    lengths = rng.integers(2, 15, len(path)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.uint64)
    pos = np.zeros(len(path) + 1, dtype=np.int64)
    seq = over.overlapper(path, 1024, pos)
    return hp.homopolymer_dwell_correction(lengths, starts, path, pos[:-1],
                                           1 + path, 1025, len(seq))


def case_events(types, events, feat, **_):
    rs = types.RawSignal(signal(20000, 9), start=250, end=19900)
    et = events.detect_events(rs)
    assert len(et.event) > 1000
    return (et.event, et.start, et.end, feat.nanonet_features_from_events(et),
            feat.nanonet_features_from_events(et, normalise=False))


def case_fasta(fasta, **_):
    return (fasta.format_fasta("r1", "ACGT", filename="f.fast5", uuid="u",
                               score=-12.5, nblock=40, nsample=200,
                               trim=(200, 190), prefix="p_"),
            fasta.format_fasta("r2", "", nblock=0),
            fasta.format_sam("r1", "ACGT", prefix="p_"))


def case_fasta_read(fasta, **_):
    text = (">r1 first read\nACGT\nacgtN\n\n>r2\nGG\n"
            "@q1 a fastq record\nACGTA\n+\n!!##$\n>r3\n")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/seqs.fa"
        with open(path, "w") as fh:
            fh.write(text)
        with open(f"{tmp}/empty.fa", "w"):
            pass
        recs = fasta.read_fasta(path)
        first = fasta.read_first_sequence(path)
        empty = fasta.read_first_sequence(f"{tmp}/empty.fa")
    fields = lambda r: (r.name, r.seq, r.comment, r.qual)
    return [fields(r) for r in recs], fields(first), empty


def case_encode_bases(api, **_):
    seq = "".join(np.random.default_rng(11).choice(list("ACGTacgt"), 300))
    out = [api.encode_bases(seq, k) for k in (1, 3, 5)]
    for bad in ("ACGN", "AC"):
        try:
            api.encode_bases(bad, 3)
        except ValueError as e:
            out.append(str(e))
    return out


def case_state_properties(api, **_):
    return [api.guess_state_properties(n) for n in (5, 17, 65, 1025, 4**9 + 1,
                                                   6**4 + 1, 7**2 + 1)]


def case_dtw_penalties(dtw, **_):
    rng = np.random.default_rng(12)
    params = np.stack([rng.standard_normal(40), -0.5 + 0.1 * rng.standard_normal(40),
                       0.4 * rng.standard_normal(40)], axis=1).astype(np.float32)
    with np.errstate(divide="ignore"):
        return [dtw._penalties(params, rate, pb)
                for rate in (1.0, 1.3) for pb in (0.0, 0.1)]


def case_bounds(mapping, **_):
    low = np.array([0, 0, 1, 2, 4, 5])
    high = np.array([2, 3, 4, 6, 7, 8])
    return [mapping.are_bounds_sane(lo, hi, n, seqlen) for lo, hi, n, seqlen in (
        (low, high, 6, 8), (low, high, 5, 8), (low, high, 6, 9), (low + 1, high, 6, 8),
        (low, high[::-1], 6, 8), (np.array([0, 3, 3, 4, 5, 6]), high, 6, 8),
        (np.array([0, 2, 1, 2, 4, 5]), high, 6, 8))]


def case_calibration(cal, **_):
    out = []
    for model in ("rgrgr_r94", "nanonet_events", "rnnrf_r94", "raw_r94"):
        for preset in ("reference", "real"):
            out.append(cal.apply(model, preset, {"stay_pen": 0.0, "skip_pen": 0.7}))
        out += [cal.collapsed(10, 1000, model), cal.collapsed(300, 1000, model)]
    return out + [cal.collapsed(10, 1000), cal.collapsed(3, 40)]


def case_weights(reg, **_):
    return [reg.load_params(m) for m in
            ("rgrgr_r94", "rgrgr_r941", "rgrgr_r10", "raw_r94", "rnnrf_r94",
             "nanonet_events")]


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _write_fast5(path, n: int, seed: int) -> None:
    adc = np.round(signal(n, seed) / (1400.0 / 8192.0) - 10.0).astype(np.int16)
    with h5py.File(path, "w") as h:
        grp = h.create_group("Raw/Reads/Read_5")
        grp.create_dataset("Signal", data=adc)
        grp.attrs["read_id"] = "host-read"
        meta = h.create_group("UniqueGlobalKey/channel_id").attrs
        meta["digitisation"] = 8192.0
        meta["range"] = 1400.0
        meta["offset"] = 10.0
        meta["sampling_rate"] = 4000.0


@pytest.mark.parametrize("name", [*sorted(CASES), "fast5"])
def test_port_copy_equals_original(name, tmp_path):
    if name == "fast5":
        _write_fast5(tmp_path / "a.fast5", 3000, 10)

        def case(fast5, **_):
            reads = fast5.read_raw_all(tmp_path / "a.fast5")
            return ([str(p) for p in fast5.iterate_fast5([tmp_path])],
                    [(r.raw, r.uuid) for r in reads],
                    fast5.read_raw(tmp_path / "a.fast5", scale_to_pA=False).raw)
    else:
        case = CASES[name]
    port, ref = both(case)
    assert_equal(port, ref)


def test_missing_weights_raise():
    with pytest.raises(FileNotFoundError, match="no_such_model"):
        treg.load_params("no_such_model")
