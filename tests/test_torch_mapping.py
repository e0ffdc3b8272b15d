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

import chip_smoke
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
    final, moves = tops.map_to_sequence_tm(torch.from_numpy(lp),
                                           torch.from_numpy(seqstates), *pens,
                                           viterbi=viterbi)
    assert final.shape == (seqlen + 2,)
    for ref in (scan_final, pallas_final):
        np.testing.assert_allclose(final.numpy(), np.asarray(ref), **FINAL_TOL)
    if viterbi:
        assert moves.dtype == torch.uint8
        assert moves.shape == (T, tops.move_stride(seqlen))
        assert not moves[:, seqlen + 2:].any()
        tb = tops.moves_to_traceback(moves, seqlen).numpy()
        np.testing.assert_array_equal(tb, np.asarray(scan_tb))
        np.testing.assert_array_equal(tb, np.asarray(pallas_tb))
    else:
        assert moves is None


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
    final, moves = tops.map_to_sequence_plain(torch.from_numpy(lp),
                                              torch.from_numpy(seqstates),
                                              viterbi=viterbi)
    assert not torch.isnan(final).any()
    np.testing.assert_allclose(final.numpy(), np.asarray(ref_final), **FINAL_TOL)
    if viterbi:
        tb = tops.moves_to_traceback(moves, len(seqstates)).numpy()
        np.testing.assert_array_equal(tb, np.asarray(ref_tb))


def tiny_cases(n: int, seed: int) -> list:
    """Seeded small maps where the walk meets its edge cases: integer log
    posteriors (ties), half of them -inf, seqlen 2 or 3, T from 1 to 8, and
    penalties that include a huge local penalty (2e30: the local states
    lose) and a huge skip bonus (-1e30), so that steps and skips from below
    position 0 win and the walk reads the states -1 and -2."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        T, nst, seqlen = int(rng.integers(1, 9)), 5, int(rng.integers(2, 4))
        lp = rng.integers(-3, 1, (T, nst)).astype(np.float32)
        lp[rng.random((T, nst)) < 0.5] = -np.inf
        seq = rng.integers(0, nst - 1, seqlen).astype(np.int32)
        pens = (float(rng.choice([0.0, 0.5])), float(rng.choice([0.0, -1e30, 1.0])),
                float(rng.choice([4.0, 2e30])))
        cases.append((lp, seq, pens))
    return cases


def edge_case(name: str):
    """(lp, seqstates, penalties) of a named edge case of the dense map."""
    rng = np.random.default_rng(len(name))
    if name == "minus_inf":  # the -inf case above: a -1 in the traceback
        lp = dirichlet_logpost(40, 17, seed=5)
        lp[::3, 4] = -np.inf
        lp[5:9, -1] = -np.inf
        return lp, np.array([4, 4, 1, 4, 7, 4, 2, 4], np.int32), (0.0, 0.0, 4.0)
    if name == "ties":  # integer-valued log posteriors and penalties
        lp = rng.integers(-4, 1, (60, 17)).astype(np.float32)
        return lp, rng.integers(0, 16, 20).astype(np.int32), (0.0, 1.0, 4.0)
    T, seqlen = {"T1": (1, 9), "seqlen2": (30, 2), "seqlen3": (30, 3)}[name]
    lp = dirichlet_logpost(T, 17, seed=T + seqlen)
    return lp, rng.integers(0, 16, seqlen).astype(np.int32), tuple(PENALTIES.values())


EDGE_CASES = ("minus_inf", "ties", "T1", "seqlen2", "seqlen3")


def numpy_walk(final, tbs, seqlen: int) -> np.ndarray:
    """The walk of scrappie_tpu/decode/mapping.py:map_to_sequence_viterbi
    over a traceback (for references the scan cannot give)."""
    T, END = tbs.shape[0], seqlen + 1
    path = np.zeros(T, dtype=np.int32)
    path[T - 1] = seqlen - 1 if final[seqlen - 1] > final[END] else END
    for t in range(T - 1, 0, -1):
        path[t - 1] = tbs[t, path[t]]
    path[(path == seqlen) | (path == END)] = -1
    return path


def _dense_pair(lp, seq, pens):
    """(final, moves) of the port's twin and (final, tb) of JAX's scan."""
    final, moves = tops.map_to_sequence_tm(torch.from_numpy(lp),
                                           torch.from_numpy(seq), *pens)
    ref_final, ref_tb = jmap._map_dense(jnp.asarray(lp), jnp.asarray(seq), *pens,
                                        True, True)
    return final, moves, np.asarray(ref_final), np.asarray(ref_tb)


@pytest.mark.parametrize("name", EDGE_CASES)
def test_moves_rebuild_the_scan_traceback(name):
    """moves_to_traceback of the twin's move bytes is JAX's int32 traceback
    element by element, and the finals are identical."""
    lp, seq, pens = edge_case(name)
    final, moves, ref_final, ref_tb = _dense_pair(lp, seq, pens)
    np.testing.assert_array_equal(final.numpy(), ref_final)
    np.testing.assert_array_equal(tops.moves_to_traceback(moves, len(seq)).numpy(),
                                  ref_tb)
    if name == "minus_inf":
        assert (ref_tb < 0).any()


@pytest.mark.parametrize("name", EDGE_CASES)
def test_walk_twin_matches_jax(name):
    """The walk twin's path is map_to_sequence_viterbi(want_path=True)'s,
    through decode/mapping.py on the CPU and through the twins directly."""
    lp, seq, pens = edge_case(name)
    jscore, jpath = jmap.map_to_sequence_viterbi(lp, seq, *pens, want_path=True)
    score, path = tmap.map_to_sequence_viterbi(lp, seq, *pens, want_path=True,
                                               device="cpu")
    assert score == jscore and path.dtype == np.int32
    np.testing.assert_array_equal(path, jpath)
    final, moves = tops.map_to_sequence_tm(torch.from_numpy(lp),
                                           torch.from_numpy(seq), *pens)
    np.testing.assert_array_equal(tops.seqmap_walk(final, moves, len(seq)).numpy(),
                                  jpath)


def test_walk_reads_states_below_zero_as_numpy_does():
    """On the tiny cases, whose walks pass through the states -1 and -2
    (read as the columns END and START by numpy's negative indexing), the
    twins' tracebacks and paths are JAX's."""
    below = set()
    for lp, seq, pens in tiny_cases(40, seed=11):
        final, moves, ref_final, ref_tb = _dense_pair(lp, seq, pens)
        np.testing.assert_array_equal(final.numpy(), ref_final)
        np.testing.assert_array_equal(
            tops.moves_to_traceback(moves, len(seq)).numpy(), ref_tb)
        jscore, jpath = jmap.map_to_sequence_viterbi(lp, seq, *pens, want_path=True)
        score, path = tmap.map_to_sequence_viterbi(lp, seq, *pens, want_path=True,
                                                   device="cpu")
        assert score == jscore
        np.testing.assert_array_equal(path, jpath)
        raw = numpy_walk(ref_final, ref_tb, len(seq))
        below.update(int(v) for v in raw if v == -2)
        below.update(-1 for t in range(1, len(raw)) if ref_tb[t, raw[t]] == -1)
    assert below == {-1, -2}


def windowed_walk(final, moves, seqlen: int) -> np.ndarray:
    """The walk kernel's control flow (csrc/seqmap.cu seqmap_walk_kernel)
    in Python, a row at a time (a batch of WALK_BATCH rows is taken only
    where its rows would be): a window of WALK_ROWS rows anchored at the
    walk's column where it starts (tops.walk_window), the next window
    anchored at the column the walk has at the window's first row, an
    exact step for a byte above 2 or a column below the window, a window
    anchored at END loaded after a step below column 0, START the end.
    Asserts that every byte the walk reads lies in its window's rows and
    copied columns; returns the path."""
    T, ld = moves.shape
    n, START, END = seqlen + 2, seqlen, seqlen + 1
    shown = lambda st: -1 if st >= START else st
    path = np.empty(T, np.int32)
    col = seqlen - 1 if final[seqlen - 1] > final[END] else END
    path[T - 1] = shown(col)
    s, fresh, windows = T - 1, True, {}
    while s > 0:
        if fresh:
            top, fresh = s, False
            windows["this"] = (top, *tops.walk_window(col, ld))
        if top - tops.WALK_ROWS >= 1:
            windows["next"] = (top - tops.WALK_ROWS, *tops.walk_window(col, ld))
        wtop, lo, pieces = windows["this"]
        assert wtop == top
        exact = False
        while s > top - min(tops.WALK_ROWS, top):
            assert lo <= col < lo + 16 * pieces <= ld
            b = int(moves[s, col])
            if b > 2 or col - b < lo:
                exact = True
                break
            col -= b
            s -= 1
            path[s] = shown(col)
        if exact:
            st = START if b == 3 else col - b
            s -= 1
            path[s] = shown(st)
            col = st + n if st < 0 else st
            if col == START:
                path[:s] = -1
                break
            fresh = True
            continue
        if s == 0:
            break
        top = s
        windows["this"] = windows.pop("next")
    return path


def numpy_traceback(moves, seqlen: int) -> np.ndarray:
    """JAX's int32 traceback from the move bytes, in numpy: a state's index
    less its move, START for move 3."""
    mv = moves[:, :seqlen + 2].astype(np.int32)
    return np.where(mv == 3, seqlen, np.arange(seqlen + 2, dtype=np.int32) - mv)


@pytest.mark.parametrize("k", range(len(chip_smoke.SEQMAP_WALK_PLANES)))
def test_walks_on_the_hand_made_planes(k):
    """chip_smoke.py's hand-made seqmap planes (phase seqmap_kernel, made by
    the same helper and seed): the walk twin, the numpy transcription of
    scrappie_tpu/decode/mapping.py:150-153 and the kernel's windowed
    control flow (windowed_walk) all take the path the plane was made
    from, and the plane holds the events its kind promises."""
    T, seqlen, finish = chip_smoke.SEQMAP_WALK_PLANES[k]
    final, moves, path, counts = chip_smoke.seqmap_walk_plane(
        T, seqlen, np.random.default_rng((chip_smoke.SEED, 51, k)), finish)
    assert moves.shape == (T, tops.move_stride(seqlen))
    np.testing.assert_array_equal(numpy_walk(final, numpy_traceback(moves, seqlen),
                                             seqlen), path)
    np.testing.assert_array_equal(
        tops.seqmap_walk_plain(torch.from_numpy(final), torch.from_numpy(moves),
                               seqlen).numpy(), path)
    np.testing.assert_array_equal(windowed_walk(final, moves, seqlen), path)
    if T >= 8000:
        assert counts["skip_runs"] >= 1 and counts["wraps"] >= 1
        assert counts["column0"] > tops.WALK_ROWS
    assert counts["entries"] == (finish.startswith("entry") and T > 2)
    assert counts["minus2"] == (finish == "minus2")


def test_windowed_walk_on_the_dense_maps():
    """The kernel's windowed control flow takes the twin's path on the DP's
    own moves: the tiny cases (walks through -1, -2 and START), the edge
    cases and the read-sized map of a Dirichlet posterior."""
    cases = tiny_cases(40, seed=12) + [edge_case(name) for name in EDGE_CASES]
    cases.append((dirichlet_logpost(3000, 17, seed=9),
                  np.random.default_rng(9).integers(0, 16, 1500).astype(np.int32),
                  tuple(PENALTIES.values())))
    for lp, seq, pens in cases:
        final, moves = tops.map_to_sequence_tm(torch.from_numpy(lp),
                                               torch.from_numpy(seq), *pens)
        np.testing.assert_array_equal(
            windowed_walk(final.numpy(), moves.numpy(), len(seq)),
            tops.seqmap_walk_plain(final, moves, len(seq)).numpy())


@pytest.mark.parametrize("seqlen", [1, 14, 15, 500, 1502, 6000])
def test_walk_windows_hold_the_fall(seqlen):
    """tops.walk_window at every column of a row: 16-byte aligned, inside
    the row, at most WALK_PIECES pieces, holding the column and every
    column WALK_FALL below it (two windows' rows at a fall of 2); the
    kernel's shared memory within a block's."""
    ld = tops.move_stride(seqlen)
    for col in range(seqlen + 2):
        lo, pieces = tops.walk_window(col, ld)
        assert lo % 16 == 0 and 0 <= lo <= max(col - tops.WALK_FALL, 0)
        assert col < lo + 16 * pieces <= ld and pieces <= tops.WALK_PIECES
    assert tops.WALK_FALL == 2 * (2 * tops.WALK_ROWS - 1)
    assert tops.walk_smem_bytes() <= ops.MAX_SMEM_BYTES


@pytest.mark.parametrize("T", [1, 6])
def test_seqmap_twin_at_seqlen_1_matches_the_pallas_kernel(T):
    """At seqlen 1 the scan of _map_dense raises (its skip candidates
    broadcast to the wrong length), so the JAX package's Pallas kernel, in
    interpret mode, is the reference, with the scan's walk over its
    traceback."""
    lp = dirichlet_logpost(T, 17, seed=T)
    seq = np.array([3], np.int32)
    pens = tuple(PENALTIES.values())
    with pytest.raises(TypeError):
        jmap._map_dense(jnp.asarray(lp), jnp.asarray(seq), *pens, True, True)
    ref_final, ref_tb = (np.asarray(a) for a in j_map_tm(
        jnp.asarray(lp), jnp.asarray(seq), *pens, viterbi=True, interpret=True))
    final, moves = tops.map_to_sequence_tm(torch.from_numpy(lp),
                                           torch.from_numpy(seq), *pens)
    np.testing.assert_array_equal(final.numpy(), ref_final)
    np.testing.assert_array_equal(tops.moves_to_traceback(moves, 1).numpy(), ref_tb)
    np.testing.assert_array_equal(tops.seqmap_walk(final, moves, 1).numpy(),
                                  numpy_walk(ref_final, ref_tb, 1))
    fwd, _ = tops.map_to_sequence_tm(torch.from_numpy(lp), torch.from_numpy(seq),
                                     *pens, viterbi=False)
    jfwd, _ = j_map_tm(jnp.asarray(lp), jnp.asarray(seq), *pens, viterbi=False,
                       interpret=True)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), **FINAL_TOL)


def explicit_bands(T: int, width: int, lead: int, rng):
    """(low, high, seqlen) of a sane band of the given width: the first
    `lead` blocks keep low == 0 (entry allowed), then low rises by 0 to
    width a block (delta reaches the width), high = low + width, and the
    last block's band is one narrower (masked)."""
    steps = rng.integers(0, width + 1, T)
    steps[:lead + 1] = 0
    steps[lead + 1::7] = width
    low = np.cumsum(steps).astype(np.int64)
    seqlen = int(low[-1]) + width - 1 if width > 1 else int(low[-1]) + 1
    high = np.minimum(low + width, seqlen)
    return low, high, seqlen


def _jax_banded(lp, seq, low, high, pens, viterbi):
    """(window, END) of scrappie_tpu's _map_banded on the inputs its
    map_to_sequence_banded builds."""
    width = int((high - low).max())
    seqlen = len(seq)
    offs = low[:, None] + np.arange(width)[None, :]
    emit = np.take_along_axis(lp, seq[np.minimum(offs, seqlen - 1)], axis=1)
    mask = (low <= seqlen - 1) & (seqlen - 1 < high)
    prev_low = np.concatenate([[0], low[:-1]])
    sm1 = np.stack([np.concatenate([[False], mask[:-1]]).astype(np.int32),
                    np.clip(seqlen - 1 - prev_low, 0, width - 1).astype(np.int32)], 1)
    init = np.full(width, -1e30, np.float32)
    init[0] = lp[0, seq[0]]
    if width > 1 and seqlen > 1 and high[0] > 1:
        init[1] = lp[0, seq[1]]
    if width > 2 and seqlen > 2 and high[0] > 2:
        init[2] = lp[0, seq[2]] - pens[1]
    win, end = jmap._map_banded(
        jnp.asarray(lp), jnp.asarray(emit[1:]), jnp.asarray((offs < high[:, None])[1:]),
        jnp.asarray(np.diff(low).astype(np.int32)), jnp.asarray((low == 0)[1:]),
        *pens, jnp.asarray(lp[1:, seq[0]]), jnp.asarray(sm1[1:]), jnp.asarray(init),
        width, viterbi)
    return np.asarray(win), float(end), init


@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("viterbi", [True, False])
def test_banded_twin_matches_jax_at_narrow_widths(width, viterbi):
    """The banded twin against JAX's scan on explicit bands of width 1, 2
    and 3 whose shift reaches the width, with leading blocks at low == 0:
    the window and END identical for Viterbi (the forward within
    FINAL_TOL), and the decode functions' scores."""
    _check_banded_twin(width, viterbi)


@pytest.mark.parametrize("width", [32, 33, 64, 65, 128, 129, 256, 257])
@pytest.mark.parametrize("viterbi", [True, False])
def test_banded_twin_matches_jax_at_the_kernels_mode_boundaries(width, viterbi):
    """As at the narrow widths, at the widths where the banded kernel's
    launch plan changes: the warp mode's offsets a lane (1, 2, 4, 8) and
    the block mode above 256 offsets."""
    beside = width + 1 if width % 32 == 0 else width - 1
    assert tops.banded_layout(17, width) != tops.banded_layout(17, beside)
    _check_banded_twin(width, viterbi)


def _check_banded_twin(width, viterbi):
    """The banded twin against JAX's scan on explicit bands of the width
    whose shift reaches it, with leading blocks at low == 0: the window and
    END identical for Viterbi (the forward within FINAL_TOL), and the
    decode functions' scores."""
    rng = np.random.default_rng(width)
    T = 80
    low, high, seqlen = explicit_bands(T, width, lead=6, rng=rng)
    assert int((high - low).max()) == width and np.diff(low).max() == width
    assert jmap.are_bounds_sane(low, high, T, seqlen)
    lp = dirichlet_logpost(T, 17, seed=width + 20)
    seq = rng.integers(0, 16, seqlen)
    pens = tuple(PENALTIES.values())
    jwin, jend, init = _jax_banded(lp, seq, low, high, pens, viterbi)
    out = tops.map_banded_tm(
        torch.from_numpy(lp), torch.from_numpy(seq.astype(np.int32)),
        torch.from_numpy(np.stack([low, high]).astype(np.int32)),
        torch.from_numpy(init), *pens, viterbi=viterbi).numpy()
    assert out.shape == (width + 1,)
    if viterbi:
        np.testing.assert_array_equal(out[:width], jwin)
        assert out[width] == jend
    else:
        np.testing.assert_allclose(out[:width], jwin, **FINAL_TOL)
        np.testing.assert_allclose(out[width], jend, **FINAL_TOL)
    ref = jmap.map_to_sequence_banded(lp, seq, low, high, *pens, viterbi=viterbi)
    score = tmap.map_to_sequence_banded(lp, seq, low, high, *pens, viterbi=viterbi,
                                        device="cpu")
    if viterbi:
        assert score == ref
    np.testing.assert_allclose(score, ref, **FINAL_TOL)


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
    states = torch.arange(5, dtype=torch.int32)
    final, moves = tops.map_to_sequence_tm(lp, states)
    tops.seqmap_walk(final, moves, 5)
    low = torch.tensor([0] * 4 + [1] * 6, dtype=torch.int32)
    tops.map_banded_tm(lp, states, torch.stack([low, low + 4]),
                       torch.zeros(4))
    for name in ("seqmap", "seqmap_walk", "seqmap_banded"):
        assert ops.LAUNCHES[name] == 0
    # the scores of a run of 4, 8 or 16 states a thread in registers
    assert tops.SEQMAP_MAX_REGISTER_SEQLEN == 16382
    assert tops.seqmap_layout(9) == (4, 32, True)
    assert tops.seqmap_layout(4094) == (4, 1024, True)
    assert tops.seqmap_layout(5996) == (8, 768, True)  # chip_smoke's read
    assert tops.seqmap_layout(16382) == (16, 1024, True)
    assert tops.seqmap_layout(16383) == (4, 1024, False)
    assert tops.seqmap_layout(9, global_state=True) == (4, 1024, False)
    # the forward variant stores no moves: more threads, runs of 6 and 12
    assert tops.seqmap_layout(5996, viterbi=False) == (6, 1024, True)
    assert tops.seqmap_layout(9000, viterbi=False) == (12, 768, True)
    assert tops.seqmap_layout(4094, viterbi=False) == (4, 1024, True)
    assert tops.seqmap_layout(16383, viterbi=False) == (4, 1024, False)
    with pytest.raises(ValueError, match="registers"):
        tops.seqmap_layout(16383, global_state=False)
    for seqlen in (1, 9, 4094, 5996, 16382):
        run, threads, _ = tops.seqmap_layout(seqlen)
        assert threads * run >= tops.move_stride(seqlen) >= seqlen + 2
        assert threads % 32 == 0 and tops.move_stride(seqlen) % 16 == 0
    assert tops.move_stride(5996) == 6000 and tops.move_stride(14) == 16
    assert tops.shared_bytes(1025) <= ops.MAX_SMEM_BYTES
    # the banded window in shared memory while it fits
    n = tops.max_shared_width(1025)
    assert tops.banded_shared_bytes(1025, n, True) <= ops.MAX_SMEM_BYTES
    assert tops.banded_shared_bytes(1025, n + 1, True) > ops.MAX_SMEM_BYTES
    # one warp up to 256 offsets (the warp mode: offsets a lane), wider a
    # thread an offset (the block mode)
    assert tops.banded_layout(1025, 1) == (32, True, 1)
    assert tops.banded_layout(1025, 100) == (32, True, 4)
    assert tops.banded_layout(1025, 1500) == (1024, True, 0)
    assert tops.banded_layout(1025, n + 1) == (1024, False, 0)
    assert tops.banded_layout(1025, 100, global_state=True) == (128, False, 0)
    with pytest.raises(ValueError, match="shared memory"):
        tops.banded_layout(1025, n + 1, global_state=False)
    tops.check_seqmap_input(lp, states)
    with pytest.raises(ValueError, match="dtype"):
        tops.check_seqmap_input(lp, torch.arange(5))
    with pytest.raises(ValueError, match="contiguous"):
        tops.check_seqmap_input(lp.t().contiguous().t(), states)
    with pytest.raises(ValueError, match="shared memory"):
        tops.check_seqmap_input(torch.zeros((2, 30000)), states)
    tops.check_walk_input(final, moves, 5)
    with pytest.raises(ValueError, match="shape"):
        tops.check_walk_input(final, moves[:, :7], 5)
    with pytest.raises(ValueError, match="dtype"):
        tops.check_walk_input(final, moves.int(), 5)
    bands = torch.stack([low, low + 4])
    tops.check_banded_input(lp, states, bands, torch.zeros(4))
    with pytest.raises(ValueError, match="dtype"):
        tops.check_banded_input(lp, states, bands.long(), torch.zeros(4))
    with pytest.raises(ValueError, match="bands"):
        tops.check_banded_input(lp, states, bands[:, :5], torch.zeros(4))


@pytest.mark.parametrize("nst", [17, 1025])
def test_banded_launch_plan(nst):
    """The banded kernel's plan at every width up to 600 and around the
    shared window's limit: one warp while the band has at most
    BAND_WARP_MAX offsets, each lane the fewest offsets of BAND_LANE_RUNS
    that cover it, its shared memory (the ring of plane rows and two
    guarded windows) far below the card's; wider, a thread an offset up
    to MAX_THREADS with the window in shared memory while
    banded_shared_bytes fits; the plane's rows 16-byte aligned."""
    n = tops.max_shared_width(nst)
    for width in [*range(1, 601), n - 1, n, n + 1, 40000]:
        plan = tops.banded_layout(nst, width)
        stride = tops.plane_stride(width)
        assert stride % 4 == 0 and width + tops.BAND_HEADER <= stride < width + 8
        if width <= tops.BAND_WARP_MAX:
            runs = [r for r in tops.BAND_LANE_RUNS if 32 * r >= width]
            assert plan == (32, True, runs[0])
            assert tops.banded_shared_bytes(nst, width, True, plan.per_lane) <= 48 * 1024
        else:
            assert plan.per_lane == 0 and plan.threads % 32 == 0
            assert plan.threads == min(tops.MAX_THREADS, -(-width // 32) * 32)
            assert plan.shared == (width <= n)
            if plan.shared:
                assert tops.banded_shared_bytes(nst, width, True) <= ops.MAX_SMEM_BYTES
        forced = tops.banded_layout(nst, width, global_state=True)
        assert forced.per_lane == 0 and not forced.shared
    assert tops.BAND_WARP_MAX == 256 and tops.BAND_DEPTH == 32


@pytest.mark.parametrize("nst", [17, 1025])
def test_banded_warp_windows_hold_every_shifted_read(nst):
    """The warp mode's shared memory holds every read and store of its step
    at every width it takes and every shift: the windows' floats, taken
    from banded_shared_bytes, against the kernel's indices (lane l's
    offset l + 32 k reads the previous window at the slice start
    clamp(width + d - by, 0, 2 width) - width past the window's start, the
    window width floats into its span), up to width + 32 K - 1 past the
    window's start when the shift reaches the width (at width 65, K = 4:
    161, past the 3 width + 32 floats a span once held)."""
    batches = 8 * (tops.BAND_DEPTH // tops.BAND_BATCH)
    for width in range(1, tops.BAND_WARP_MAX + 1):
        K = tops.banded_layout(nst, width).per_lane
        ring = tops.BAND_DEPTH * tops.plane_stride(width)
        floats = (tops.banded_shared_bytes(nst, width, True, K) - batches) // 4
        span = (floats - ring) // 2
        assert ring + 2 * span == floats and span == tops.band_span(width, K)
        d = np.arange(-2 * width - 3, 3 * width + 4)[:, None] - np.arange(3)
        starts = np.clip(width + d, 0, 2 * width) - width
        offsets = np.arange(32)[:, None] + 32 * np.arange(K)
        assert width + starts.min() + offsets.min() == 0
        assert width + starts.max() + offsets.max() == 2 * width + 32 * K - 1 < span
        assert width + offsets.max() < span  # the stores, past width -1e30
        assert 2 * span * 4 % 8 == 0  # the mbarriers after the windows aligned


def test_api_hands_the_seqmap_kernel_its_layout(monkeypatch, read_post):
    """On a CUDA tensor the mapping wrappers raise unless their inputs are
    contiguous and of the kernels' types; the twins take any layout. So the
    twins here run the kernels' input checks first: every path that
    reaches them must pass (the DP, the walk and the banded DP)."""
    seen = []

    def checked(name, check, plain):
        def run(*args, **kwargs):
            check(*args[:check.__code__.co_argcount])
            seen.append(name)
            return plain(*args, **kwargs)
        monkeypatch.setattr(tops, plain.__name__, run)

    checked("seqmap", tops.check_seqmap_input, tops.map_to_sequence_plain)
    checked("seqmap_walk", tops.check_walk_input, tops.seqmap_walk_plain)
    checked("seqmap_banded", tops.check_banded_input, tops.map_banded_plain)
    lp, seq = read_post
    post = tapi.Posterior(lp, "rgrgr_r94")
    tapi.map_post_to_sequence(post, seq, viterbi=True, path=True, device="cpu")
    tapi.map_post_to_sequence(post, seq, device="cpu")
    sloika = tapi.Posterior(post.data(as_numpy=True, sloika=False)[:, ::-1],
                            "rgrgr_r94")
    tapi.map_post_to_sequence(sloika, seq, viterbi=True, device="cpu")
    tapi.map_post_to_sequence(sloika, seq, viterbi=True, bands=20, device="cpu")
    low, high = _bands(lp.shape[0], len(seq) - 4, 20)
    tapi.map_post_to_sequence(post, seq, bands=(low, high), device="cpu")
    assert seen == ["seqmap", "seqmap_walk", "seqmap", "seqmap",
                    "seqmap_banded", "seqmap_banded"]


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
