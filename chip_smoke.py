#!/usr/bin/env python3
"""Drive scrappie_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; it needs neither JAX nor h5py.
It prints one JSON line per phase and fails (nonzero exit, no result line)
if any phase fails:

  1. builds the kernels (scrappie_torch/csrc, nvcc, sm_90a) and prints the
     build time and nvcc's per-kernel register and spill report (stderr);
  2. holds each kernel against its plain PyTorch twin at the main path's
     shapes (T = 2000 blocks, S = 96, 1025 states; B = 8 and 64) and times
     both (CUDA events, median of 20 after warm-up);
  3. holds the Viterbi kernels against their twins with nonzero penalties,
     slip and temperatures, and on log posteriors drawn from a few
     integers, where ties decide most moves;
  4. runs the main path, BasecallEngine("rgrgr_r94", device="cuda"), on
     16 seeded synthetic reads of 20k-100k samples in fast mode and in both
     stitch modes, checks that each kernel's launch counter rose and that
     every read has a sequence, and compares two reads with the port's CPU
     run of the same reads;
  5. times the fused path at B = 64 chunks of 10 000 samples;
  6. profiles (torch.profiler) the engine in each mode and the fused path,
     and times the engine and the fused path at several batch sizes;
  7. holds the three CRF kernels (Viterbi forward, backtrace, partition
     function) against their twins at T = 5000 blocks (a 10 000-sample
     chunk at stride 2), B = 8 and 64: on the rnnrf head's transitions, on
     integer transitions in {-3..0}, and with an emit bias of -1;
  8. runs BasecallEngine("rnnrf_r94", device="cuda") in fast and stitch
     mode on the same 16 reads, checks the launch counters and every
     read's sequence, and compares two reads with the port's CPU run;
  9. times the rnnrf fused path at B = 64 x 10 000 samples, stage by stage,
     and profiles the rnnrf engine in both modes;
 10. holds the peephole-LSTM kernel against its twin with the events
     network's weights at T = 2048 events, B = 8 and 64, C = 12 and 96, in
     both directions, and times the layer, its projection and its
     recurrence (and torch.matmul on the same projection); then holds the
     fused head + Viterbi, forward and backtrace kernels against their
     twins on the second stage's output and the FF3 head's posterior;
 11. runs BasecallEngine("nanonet_events", device="cuda") in fast and
     stitch mode on the same 16 reads, checks the launch counters and every
     read's sequence, and compares two reads with the port's CPU run;
 12. times the events fused path at B = 64 x 2048 events, stage by stage,
     and profiles the events engine in both modes;
 13. predicts the squiggles of a seeded 2 000-base sequence with the three
     squiggle models on the card and holds them to the port's CPU run;
 14. holds the DTW kernel against its twin, Viterbi and forward, with
     prob_back 0 and 0.1, on signals simulated from predicted squiggles:
     state in shared memory (300 positions, 3 000 samples) and in global
     memory (15 000 positions, 2 000 samples); then times it at 6 000
     positions and 60 000 samples, with the traceback's copy to the host;
 15. holds the seqmap kernel against its twin, Viterbi and forward, in
     both variants, on the rgrgr_r94 posterior of a synthetic 60 000-sample
     read (about 12 000 blocks) against a seeded 6 000-base reference, and
     times it;
 16. runs the mapping path through the API on the card,
     map_signal_to_squiggle on a signal simulated from the squiggle of a
     6 000-base sequence and map_post_to_sequence (Viterbi with a path,
     forward, banded), checks that each kernel's launch counter rose, and
     holds each result to the port's CPU run on the same inputs.

The last lines are the kernel table (each kernel's time beside its bound,
the least time the card could take for the same work), the card's name
and power limit as nvidia-smi gives them, and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 20261016
T_BLOCKS = 2000          # blocks in a 10 000-sample chunk at stride 5
T_CRF = 5000             # blocks in a 10 000-sample chunk at stride 2
CHUNK = 10000
GRU_ATOL = 1e-4
FUSED_RTOL = 1e-5
FUSED_MIN_SAME_ROWS = 0.99
PARTITION_RTOL = 1e-5    # expf/logf against torch's logsumexp, T = 5000
EMIT_BIAS = -1.0
T_EVENTS = 2048          # events in a chunk of the events engine
LSTM_ATOL = 1e-4
NREADS = 16
READ_LEN = (20000, 100000)
SQUIGGLE_MODELS = ("squiggle_r94", "squiggle_r94_rna", "squiggle_r10")
SQUIGGLE_BASES = 2000
SQUIGGLE_RTOL = 1e-5     # fp32 convolutions summed in another order
DTW_SHARED = (300, 3000)     # (positions, samples): scores in shared memory
DTW_GLOBAL = (15000, 2000)   # above the shared-memory limit: global memory
MAP_BASES = 6000         # the mapping path's sequences, and the timed DTW's
MAP_SAMPLES = 60000      # the timed DTW's samples; the seqmap read's length
MAP_BAND = 100           # half-width of the banded mapping
FORWARD_RTOL = 1e-5      # forward finals: expf/log1pf against the host's
# map_signal_to_squiggle's defaults
DTW_OPTIONS = dict(local_pen=2.0, skip_pen=5000.0, minscore=5.0)
# the CLI's --stay/--skip/--local/--slip and a calibration's temperatures
VITERBI_OPTIONS = dict(stay_pen=0.3, skip_pen=1.1, local_pen=4.0, use_slip=True)
TEMPS = dict(tempW=1.2, tempb=0.9)
RUNS = (("fast", "nochange"), ("stitch", "nochange"), ("stitch", "mean"))

KERNELS = {
    "gru_layer": ("scrappie_torch/csrc/gru.cu", "scrappie_tpu/ops/gru.py:152"),
    "viterbi_fwd": ("scrappie_torch/csrc/viterbi.cu",
                    "scrappie_tpu/ops/viterbi.py:169"),
    "viterbi_backtrace": ("scrappie_torch/csrc/viterbi.cu",
                          "scrappie_tpu/ops/viterbi.py:283"),
    "viterbi_fused": ("scrappie_torch/csrc/viterbi.cu",
                      "scrappie_tpu/ops/viterbi.py:385"),
    "crf_fwd": ("scrappie_torch/csrc/crf.cu", "scrappie_tpu/ops/crf.py:39"),
    "crf_backtrace": ("scrappie_torch/csrc/crf.cu",
                      "scrappie_tpu/ops/crf.py:121"),
    "crf_partition": ("scrappie_torch/csrc/crf.cu",
                      "scrappie_tpu/nn/layers.py:133 (a lax.scan; no TPU "
                      "kernel)"),
    "lstm_layer": ("scrappie_torch/csrc/lstm.cu", "scrappie_tpu/ops/lstm.py:53"),
    "seqmap": ("scrappie_torch/csrc/seqmap.cu", "scrappie_tpu/ops/seqmap.py:32"),
    "dtw": ("scrappie_torch/csrc/dtw.cu", "scrappie_tpu/ops/dtw.py:59"),
}
RGRGR_KERNELS = ("gru_layer", "viterbi_fwd", "viterbi_backtrace", "viterbi_fused")
RNNRF_KERNELS = ("gru_layer", "crf_fwd", "crf_backtrace", "crf_partition")
EVENTS_KERNELS = {"fast": ("lstm_layer", "viterbi_fused", "viterbi_backtrace"),
                  "stitch": ("lstm_layer", "viterbi_fwd", "viterbi_backtrace")}
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# fp32 outside the tensor cores (the kernels are exact fp32, TF32 off).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build() -> None:
    from scrappie_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = path.with_suffix(".log")
    if log.exists():
        report = [ln for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print("\n".join(report), file=sys.stderr)
    emit({"phase": "build", "seconds": round(seconds, 3), "library": path.name})


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take for work that moves nbytes (each
    input read once, each output written once) and does nops fp32
    operations (a multiply-add counts 2): the larger of the two times at
    the published peaks, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def viterbi_ops(T: int, B: int, nhist: int, use_slip: bool = False) -> float:
    """What a step of the decode needs for each row: the max of each group
    of predecessors (n - 1 compares for each of the nhist / n groups of
    n = 4 steps, 16 skips and 64 slips), an add and a compare for each
    history state and move (stay, step, skip, start, slip), and the max
    over the states into the end state."""
    groups = (4, 16, 64) if use_slip else (4, 16)
    moves = 2 + len(groups)
    per_step = (sum((n - 1) * (nhist // n) for n in groups)
                + 2 * moves * nhist + nhist)
    return float(T) * B * per_step


def kernel_work(name: str, **d) -> dict:
    """bound() of one kernel call at the shapes d. Only the products'
    multiply-adds and the decoders' adds and maxes are counted as
    operations (the gates' elementwise arithmetic adds a few percent), so
    each bound is a lower bound. The backtraces read one traceback entry
    per step and row: what the data needs, not the whole traceback. The
    mapping DPs (one read, Viterbi) write their whole int32 traceback; per
    step and position the DTW does 23 operations (its forward state 6 adds
    and 5 compares with the end jump's max, the end-jump candidate's add,
    the emission's 6 and its 2 adds, the back state's 2 adds and compare)
    and the seqmap 7 (3 adds, 2 subtractions, 2 compares)."""
    T, B = d["T"], d.get("B", 1)
    if name == "dtw":
        npos = d["npos"]
        nstate = 2 * npos + 2
        return bound(4 * (T + 3 * npos + 4 * (npos + 2) + nstate + T * nstate),
                     23 * T * npos)
    if name == "seqmap":
        nst, seqlen = d["nst"], d["seqlen"]
        return bound(4 * (T * nst + seqlen + (seqlen + 2) * (T + 1)),
                     7 * T * seqlen)
    if name == "gru_layer":
        C, S = d["C"], d["S"]
        return bound(4 * (T * B * (C + S) + 3 * S * (C + 1) + 3 * S * S),
                     2 * T * B * 3 * S * (C + S))
    if name == "lstm_layer":
        C, S = d["C"], d["S"]
        return bound(4 * (T * B * (C + S) + 4 * S * (C + 1) + 4 * S * S + 3 * S),
                     2 * T * B * 4 * S * (C + S))
    if name == "viterbi_fwd":
        ns = d["nstate"]
        return bound(4 * T * B * ns + 2 * T * B * (ns + 1) + 4 * B * (ns + 1),
                     viterbi_ops(T, B, ns - 1))
    if name == "viterbi_fused":
        S, ns = d["S"], d["nstate"]
        return bound(4 * (T * B * S + (S + 1) * ns + B * (ns + 1))
                     + 2 * T * B * (ns + 1),
                     2 * T * B * S * ns + 4 * T * B * ns
                     + viterbi_ops(T, B, ns - 1))
    if name == "viterbi_backtrace":
        return bound(4 * B * d["nst2"] + 2 * T * B + 4 * B * (T + 1), T * B)
    if name == "crf_fwd":
        return bound(4 * T * B * 25 + T * B * 5 + 4 * B * 5, 2 * T * B * 25)
    if name == "crf_backtrace":
        return bound(4 * B * 5 + T * B + 4 * B * (T + 1), T * B)
    if name == "crf_partition":  # add, max, subtract, exp, sum; 5 logs
        return bound(4 * T * B * 25 + 4 * B, 5 * T * B * 25 + 5 * T * B)
    raise KeyError(name)


def synthetic_signal(n: int, rng) -> "np.ndarray":
    """Piecewise-constant current levels (about 8 samples a base) plus
    noise, in pA."""
    import numpy as np

    levels = rng.normal(0.0, 1.0, n // 8 + 1).repeat(8)[:n]
    return (90.0 + 12.0 * levels + rng.normal(0.0, 2.0, n)).astype(np.float32)


def check_kernels(net, B: int) -> dict:
    """Each kernel against its plain twin on the same CUDA tensors."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import robustlog, softmax_with_temperature
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops import viterbi as v
    from scrappie_torch.nn.layers import conv1d
    from scrappie_torch.ops.pipeline import CONV_ACT

    rng = np.random.default_rng(SEED + B)
    p = net.params
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device=net.device)
    x = CONV_ACT[net.conv_activation](
        conv1d(sig, p["conv_W"], p["conv_b"], net.stride)).transpose(0, 1).contiguous()
    require(x.shape == (T_BLOCKS, B, 96), f"features shape {tuple(x.shape)}")
    out = {}

    # GRU: one backward (B1) and one forward (F2) layer.
    err = 0.0
    for pre, reverse in (("gruB1", True), ("gruF2", False)):
        w = [p[f"{pre}_{k}"] for k in ("iW", "b", "sW", "sW2")]
        hk = g.gru_layer_tm(x, *w, reverse=reverse)
        hp = g.gru_layer_tm_plain(x, *w, reverse=reverse)
        sync()
        require(bool(torch.isfinite(hk).all()), f"{pre} kernel output finite")
        err = max(err, float((hk - hp).abs().max()))
    require(err <= GRU_ATOL, f"gru max abs err {err} <= {GRU_ATOL}")
    w = [p[f"gruB1_{k}"] for k in ("iW", "b", "sW", "sW2")]
    out["gru_layer"] = {
        **kernel_work("gru_layer", T=T_BLOCKS, B=B, C=96, S=96),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: g.gru_layer_tm(x, *w, reverse=True)),
        "plain_ms": cuda_ms(lambda: g.gru_layer_tm_plain(x, *w, reverse=True))}

    # Viterbi forward and backtrace on the main path's posterior.
    h = hk  # the F2 layer's output: main-path hidden features
    lp = robustlog(softmax_with_temperature(h, p["FF_W"], p["FF_b"]), 1e-5).contiguous()
    fk, tbk, errs = check_forward_and_backtrace(lp, "main path")
    nstate = lp.shape[-1]
    out["viterbi_fwd"] = {"max_abs_err": errs[0],
                          **kernel_work("viterbi_fwd", T=T_BLOCKS, B=B,
                                        nstate=nstate)}
    out["viterbi_backtrace"] = {"max_abs_err": errs[1],
                                **kernel_work("viterbi_backtrace", T=T_BLOCKS,
                                              B=B, nst2=nstate + 1)}
    out["viterbi_fused"] = check_fused(h, p["FF_W"], p["FF_b"], "main path")
    out["viterbi_fused"].update(kernel_work("viterbi_fused", T=T_BLOCKS, B=B,
                                            S=96, nstate=nstate))
    out["viterbi_fwd"]["ms"] = cuda_ms(lambda: v.viterbi_scores_tm(lp))
    out["viterbi_fwd"]["plain_ms"] = cuda_ms(lambda: v.viterbi_scores_tm_plain(lp))
    out["viterbi_backtrace"]["ms"] = cuda_ms(lambda: v.viterbi_backtrace_tm(fk, tbk))
    out["viterbi_backtrace"]["plain_ms"] = cuda_ms(
        lambda: v.viterbi_backtrace_tm_plain(fk, tbk))
    out["viterbi_fused"]["ms"] = cuda_ms(
        lambda: v.viterbi_fused_tm(h, p["FF_W"], p["FF_b"]))
    out["viterbi_fused"]["plain_ms"] = cuda_ms(
        lambda: v.viterbi_fused_tm_plain(h, p["FF_W"], p["FF_b"]))
    emit({"phase": "kernels", "B": B, "T": T_BLOCKS, "kernels": out})
    return out


def check_forward_and_backtrace(lp, what: str, **opts):
    """Forward and backtrace kernels against their twins: traceback, final,
    path and score identical. Returns the kernel's final and tb, and the
    largest difference in final and in path (both 0 once checked)."""
    import torch

    from scrappie_torch.ops import viterbi as v

    fk, tbk = v.viterbi_scores_tm(lp, **opts)
    fp, tbp = v.viterbi_scores_tm_plain(lp, **opts)
    sync()
    require(torch.equal(tbk, tbp), f"viterbi_fwd traceback identical ({what})")
    require(torch.equal(fk, fp), f"viterbi_fwd final identical ({what})")
    sk, pk = v.viterbi_backtrace_tm(fk, tbk)
    sp, pp = v.viterbi_backtrace_tm_plain(fk, tbk)
    sync()
    require(torch.equal(pk, pp), f"viterbi_backtrace path identical ({what})")
    require(torch.equal(sk, sp), f"viterbi_backtrace score identical ({what})")
    return fk, tbk, (float((fk - fp).abs().max()), float((pk - pp).abs().max()))


def check_fused(h, W, b, what: str, **opts) -> dict:
    """Fused head + forward against head-then-forward: final within
    FUSED_RTOL, paths identical in FUSED_MIN_SAME_ROWS of the rows."""
    from scrappie_torch.ops import viterbi as v

    B = h.shape[1]
    ffk, ftbk = v.viterbi_fused_tm(h, W, b, **opts)
    ffp, ftbp = v.viterbi_fused_tm_plain(h, W, b, **opts)
    sync()
    rel = float(((ffk - ffp).abs() / ffp.abs().clamp(min=1.0)).max())
    require(rel <= FUSED_RTOL,
            f"viterbi_fused final rel err {rel} <= {FUSED_RTOL} ({what})")
    fsk, fpk = v.viterbi_backtrace_tm(ffk, ftbk)
    fsp, fpp = v.viterbi_backtrace_tm_plain(ffp, ftbp)
    differ = (fpk != fpp).any(dim=1)
    ndiff = int(differ.sum())
    gap = float((fsk - fsp).abs()[differ].min()) if ndiff else None
    require(B - ndiff >= FUSED_MIN_SAME_ROWS * B,
            f"viterbi_fused paths identical in {B - ndiff}/{B} rows ({what})")
    return {"max_abs_err": float((ffk - ffp).abs().max()), "max_rel_err": rel,
            "rows_differ": ndiff, "min_score_gap": gap}


def check_viterbi_options(net) -> None:
    """The Viterbi kernels with the options the main path leaves at their
    defaults: nonzero stay/skip/local penalties, slip and temperatures, on
    the head's log posteriors and on log posteriors drawn from a few
    integers, where equal candidates are everywhere and the first-max and
    strict-`>` rules decide most moves."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import robustlog, softmax_with_temperature

    B = 8
    rng = np.random.default_rng(SEED + 2)
    p = net.params
    h = torch.as_tensor(np.tanh(rng.standard_normal((T_BLOCKS, B, 96)))
                        .astype(np.float32), device=net.device)
    head = robustlog(softmax_with_temperature(h, p["FF_W"], p["FF_b"], **TEMPS),
                     1e-5).contiguous()
    ties = torch.as_tensor(rng.integers(-3, 1, (T_BLOCKS, B, 1025))
                           .astype(np.float32), device=net.device)
    for what, lp, opts in (("head, penalties + slip", head, VITERBI_OPTIONS),
                           ("integer lp", ties, {}),
                           ("integer lp, penalties + slip", ties, VITERBI_OPTIONS)):
        check_forward_and_backtrace(lp, what, **opts)
    fused = check_fused(h, p["FF_W"], p["FF_b"], "penalties + slip + temperatures",
                        **VITERBI_OPTIONS, **TEMPS)
    emit({"phase": "viterbi_options", "B": B, "T": T_BLOCKS,
          "options": VITERBI_OPTIONS, "temperatures": TEMPS,
          "forward_backtrace": "identical (head, integer lp, integer lp + options)",
          "fused": fused})


def synthetic_reads() -> list:
    """NREADS seeded reads of READ_LEN samples."""
    import numpy as np

    from scrappie_torch.parallel.runner import RawSignal

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(READ_LEN[0], READ_LEN[1] + 1, NREADS)
    return [RawSignal(synthetic_signal(int(n), rng), uuid=f"read{i:02d}")
            for i, n in enumerate(lengths)]


def main_path(card: str, reads: list) -> dict:
    """BasecallEngine("rgrgr_r94") on the card in fast and both stitch
    modes."""
    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.seqcompare import edit_distance, within_flip_rule
    from scrappie_torch.utils.tracing import Stage

    lengths = [len(r.raw) for r in reads]
    nsample = sum(lengths)
    engines = {mode: BasecallEngine("rgrgr_r94", device="cuda", mode=mode)
               for mode in ("fast", "stitch")}
    # warm up each path once (cuBLAS / cuDNN handles, allocator)
    for mode, hp in RUNS:
        engines[mode].basecall_signals(reads[:1], homopolymer=hp)

    ops.reset_launches()
    results = {}
    for mode, hp in RUNS:
        before = dict(ops.LAUNCHES)
        engines[mode].stage = Stage()
        t0 = time.perf_counter()
        res = engines[mode].basecall_signals(reads, homopolymer=hp)
        seconds = time.perf_counter() - t0
        require(all(r.sequence for r in res), f"{mode}/{hp}: every read called")
        results[(mode, hp)] = res
        emit({"phase": "main_path", "mode": mode, "homopolymer": hp,
              "reads": len(res), "samples": nsample,
              "seconds": round(seconds, 4),
              "samples_per_s": round(nsample / seconds, 1),
              "bases": sum(len(r.sequence) for r in res),
              "launches": {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES},
              "stages": engines[mode].stage.report(), "card": card})
    launches = dict(ops.LAUNCHES)
    for name in RGRGR_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} launched on the rgrgr path ({launches[name]})")

    # The two shortest reads against the port's own CPU run.
    short = sorted(range(len(reads)), key=lambda i: lengths[i])[:2]
    for mode, hp in RUNS:
        cpu = BasecallEngine("rgrgr_r94", device="cpu", mode=mode)
        cres = cpu.basecall_signals([reads[i] for i in short], homopolymer=hp)
        for i, c in zip(short, cres):
            g = results[(mode, hp)][i].sequence
            dist = 0 if g == c.sequence else edit_distance(g, c.sequence)
            emit({"phase": "cpu_vs_cuda", "mode": mode, "homopolymer": hp,
                  "read": reads[i].uuid, "bases": len(g), "edit_distance": dist})
            require(within_flip_rule(g, c.sequence),
                    f"{mode}/{hp} {reads[i].uuid}: CUDA and CPU calls agree")
    return launches


def throughput(net, card: str) -> None:
    """The fused path at B = 64 chunks of 10 000 samples."""
    import numpy as np
    import torch

    from scrappie_torch.ops.pipeline import rgrgr_features_tm
    from scrappie_torch.ops.viterbi import viterbi_backtrace_tm, viterbi_fused_tm

    B = 64
    rng = np.random.default_rng(SEED + 1)
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device="cuda")
    p = net.params
    with torch.inference_mode():
        total = cuda_ms(lambda: net.basecall_fused(sig), reps=5)
        feats = cuda_ms(lambda: rgrgr_features_tm(p, sig, net.conv_activation,
                                                  net.stride), reps=5)
        x = rgrgr_features_tm(p, sig, net.conv_activation, net.stride)
        fused = cuda_ms(lambda: viterbi_fused_tm(x, p["FF_W"], p["FF_b"]), reps=5)
        final, tb = viterbi_fused_tm(x, p["FF_W"], p["FF_b"])
        back = cuda_ms(lambda: viterbi_backtrace_tm(final, tb), reps=5)
    emit({"phase": "throughput", "path": "fused", "B": B, "chunk": CHUNK,
          "ms": round(total, 4),
          "samples_per_s": round(B * CHUNK / (total / 1e3), 1),
          "breakdown_ms": {"conv+gru x5": round(feats, 4),
                           "fused head+viterbi": round(fused, 4),
                           "backtrace": round(back, 4)},
          "card": card})


def device_activity(prof) -> tuple[float, list]:
    """Device busy seconds (the union of the intervals of the device's own
    events: kernels and copies) and the six kernels or copies with the most
    device time, as [name, ms, count]. CPU ops, which carry their children's
    kernel time, and user annotation ranges on the device timeline, which
    span whole stages, are left out, so nothing is counted twice."""
    from torch.autograd import DeviceType

    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    top = sorted(per_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    return busy_us / 1e6, [[name[:60], ms, n] for name, (ms, n) in top]


def profiled(label: str, fn, card: str) -> None:
    """One run of fn() under torch.profiler, after a warm-up run: wall
    seconds, device busy seconds, the idle share, and the kernels and
    copies with the most device time. The profiler's own cost is in the
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, top = device_activity(prof)
    emit({"phase": "profile", "run": label, "wall_s": wall, "device_busy_s": busy,
          "idle_share": 1.0 - busy / wall, "top_device_ms": top, "card": card})


def profile_and_scale(net, card: str, reads: list) -> None:
    """The engine in each mode and the fused path at B = 64 under the
    profiler; then the fast engine at several batch sizes and the fused
    path at several chunk counts, without it."""
    import numpy as np
    import torch

    from scrappie_torch.parallel.runner import BasecallEngine

    nsample = sum(len(r.raw) for r in reads)
    rng = np.random.default_rng(SEED + 3)
    with torch.inference_mode():
        for mode, hp in RUNS:
            eng = BasecallEngine("rgrgr_r94", device="cuda", mode=mode)
            profiled(f"engine {mode}/{hp}, batch {eng.batch_size}, {len(reads)} "
                     f"reads, {nsample} samples",
                     lambda: eng.basecall_signals(reads, homopolymer=hp), card)
        sig = torch.as_tensor(rng.standard_normal((64, CHUNK, 1)).astype(np.float32),
                              device="cuda")
        profiled(f"fused path, B = 64 x {CHUNK}", lambda: net.basecall_fused(sig),
                 card)
        for batch in (8, 32, 64, 128):
            eng = BasecallEngine("rgrgr_r94", device="cuda", mode="fast",
                                 batch_size=batch)
            eng.basecall_signals(reads[:2])
            t0 = time.perf_counter()
            eng.basecall_signals(reads)
            seconds = time.perf_counter() - t0
            emit({"phase": "scaling", "path": "fast engine", "batch": batch,
                  "seconds": seconds, "samples_per_s": nsample / seconds,
                  "card": card})
        for B in (128, 132, 256):
            sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1))
                                  .astype(np.float32), device="cuda")
            ms = cuda_ms(lambda: net.basecall_fused(sig), reps=5)
            emit({"phase": "scaling", "path": "fused", "B": B, "chunk": CHUNK,
                  "ms": ms, "samples_per_s": B * CHUNK / (ms / 1e3),
                  "card": card})


def check_crf(trans, what: str) -> dict:
    """The three CRF kernels against their twins on transitions [T, B, 25]:
    forward tracebacks and finals, backtrace paths and scores identical,
    the partition function within PARTITION_RTOL."""
    import torch

    from scrappie_torch.ops import crf as c

    fk, tbk = c.crf_viterbi_scores_tm(trans)
    fp, tbp = c.crf_viterbi_scores_tm_plain(trans)
    sync()
    require(torch.equal(tbk, tbp), f"crf_fwd traceback identical ({what})")
    require(torch.equal(fk, fp), f"crf_fwd final identical ({what})")
    sk, pk = c.crf_backtrace_tm(fk, tbk)
    sp, pp = c.crf_backtrace_tm_plain(fk, tbk)
    sync()
    require(torch.equal(pk, pp), f"crf_backtrace path identical ({what})")
    require(torch.equal(sk, sp), f"crf_backtrace score identical ({what})")
    zk = c.crf_partition_tm(trans)
    zp = c.crf_partition_tm_plain(trans)
    sync()
    require(bool(torch.isfinite(zk).all()), f"crf_partition finite ({what})")
    # Relative to the magnitude the recursion carries, sum_t max |trans|:
    # that is |logZ| for raw transitions, while after globalnorm logZ is
    # about 0 and the error of its T-step sum is all there is.
    scale = torch.maximum(zp.abs(), trans.abs().amax(-1).sum(0)).clamp(min=1.0)
    rel = float(((zk - zp).abs() / scale).max())
    require(rel <= PARTITION_RTOL,
            f"crf_partition rel err {rel} <= {PARTITION_RTOL} ({what})")
    return {"crf_fwd": float((fk - fp).abs().max()),
            "crf_backtrace": float((pk - pp).abs().max()),
            "crf_partition": float((zk - zp).abs().max()),
            "crf_partition_rel": rel}


def check_crf_kernels(rnet, B: int) -> dict:
    """The CRF kernels on the rnnrf head's transitions of B chunks, on
    integer transitions in {-3..0} (ties at almost every step) and with an
    emit bias; then their times and their twins' (CUDA events; fewer
    repeats for the twins, launch-bound loops over T)."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import feedforward, globalnorm_tm
    from scrappie_torch.ops import crf as c
    from scrappie_torch.ops.pipeline import rnnrf_features_tm

    rng = np.random.default_rng(SEED + 10 + B)
    p = rnet.params
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device=rnet.device)
    x = rnnrf_features_tm(p, sig, rnet.conv_activation, rnet.stride)
    require(x.shape == (T_CRF, B, 96), f"rnnrf features shape {tuple(x.shape)}")
    raw = feedforward(x, p["FF_W"], p["FF_b"])
    head = globalnorm_tm(x, p["FF_W"], p["FF_b"])
    ties = torch.as_tensor(rng.integers(-3, 1, (T_CRF, B, 25)).astype(np.float32),
                           device=rnet.device)
    errs = {}
    for what, trans in (("head before globalnorm", raw), ("head", head),
                        ("integer transitions", ties),
                        (f"head, emit bias {EMIT_BIAS}",
                         c.add_emit_bias(head, EMIT_BIAS))):
        for name, err in check_crf(trans, what).items():
            errs[name] = max(errs.get(name, 0.0), err)
    fk, tbk = c.crf_viterbi_scores_tm(head)
    out = {name: {"max_abs_err": errs[name], **kernel_work(name, T=T_CRF, B=B)}
           for name in ("crf_fwd", "crf_backtrace", "crf_partition")}
    out["crf_partition"]["max_rel_err"] = errs["crf_partition_rel"]
    timed = {"crf_fwd": (lambda: c.crf_viterbi_scores_tm(head),
                         lambda: c.crf_viterbi_scores_tm_plain(head)),
             "crf_backtrace": (lambda: c.crf_backtrace_tm(fk, tbk),
                               lambda: c.crf_backtrace_tm_plain(fk, tbk)),
             "crf_partition": (lambda: c.crf_partition_tm(raw),
                               lambda: c.crf_partition_tm_plain(raw))}
    for name, (kernel, plain) in timed.items():
        out[name]["ms"] = cuda_ms(kernel)
        out[name]["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
        out[name]["us_per_step"] = out[name]["ms"] * 1e3 / T_CRF
    emit({"phase": "crf_kernels", "B": B, "T": T_CRF,
          "checked_on": ["head before globalnorm", "head", "integer transitions",
                         f"head, emit bias {EMIT_BIAS}"],
          "kernels": out})
    return out


def main_path_rnnrf(card: str, reads: list) -> dict:
    """BasecallEngine("rnnrf_r94") on the card in fast and stitch mode."""
    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.seqcompare import edit_distance, within_flip_rule
    from scrappie_torch.utils.tracing import Stage

    lengths = [len(r.raw) for r in reads]
    nsample = sum(lengths)
    modes = ("fast", "stitch")
    engines = {mode: BasecallEngine("rnnrf_r94", device="cuda", mode=mode)
               for mode in modes}
    for mode in modes:
        engines[mode].basecall_signals(reads[:1])

    ops.reset_launches()
    results = {}
    for mode in modes:
        before = dict(ops.LAUNCHES)
        engines[mode].stage = Stage()
        t0 = time.perf_counter()
        res = engines[mode].basecall_signals(reads)
        seconds = time.perf_counter() - t0
        require(all(r.sequence for r in res), f"rnnrf {mode}: every read called")
        results[mode] = res
        emit({"phase": "main_path_rnnrf", "mode": mode, "reads": len(res),
              "samples": nsample, "seconds": round(seconds, 4),
              "samples_per_s": round(nsample / seconds, 1),
              "bases": sum(len(r.sequence) for r in res),
              "launches": {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES},
              "stages": engines[mode].stage.report(), "card": card})
    launches = dict(ops.LAUNCHES)
    for name in RNNRF_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} launched on the rnnrf path ({launches[name]})")

    short = sorted(range(len(reads)), key=lambda i: lengths[i])[:2]
    for mode in modes:
        cpu = BasecallEngine("rnnrf_r94", device="cpu", mode=mode)
        cres = cpu.basecall_signals([reads[i] for i in short])
        for i, c in zip(short, cres):
            g = results[mode][i].sequence
            dist = 0 if g == c.sequence else edit_distance(g, c.sequence)
            emit({"phase": "cpu_vs_cuda_rnnrf", "mode": mode,
                  "read": reads[i].uuid, "bases": len(g), "edit_distance": dist})
            require(within_flip_rule(g, c.sequence),
                    f"rnnrf {mode} {reads[i].uuid}: CUDA and CPU calls agree")
    return launches


def throughput_rnnrf(rnet, card: str, reads: list) -> None:
    """The rnnrf fused path at B = 64 chunks of 10 000 samples, stage by
    stage; then the rnnrf engine in each mode under torch.profiler."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import globalnorm_tm
    from scrappie_torch.ops.crf import crf_backtrace_tm, crf_viterbi_scores_tm
    from scrappie_torch.ops.pipeline import rnnrf_features_tm
    from scrappie_torch.parallel.runner import BasecallEngine

    B = 64
    rng = np.random.default_rng(SEED + 4)
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device=rnet.device)
    p = rnet.params
    with torch.inference_mode():
        total = cuda_ms(lambda: rnet.basecall_fused(sig), reps=5)
        feats = cuda_ms(lambda: rnnrf_features_tm(p, sig, rnet.conv_activation,
                                                  rnet.stride), reps=5)
        x = rnnrf_features_tm(p, sig, rnet.conv_activation, rnet.stride)
        head = cuda_ms(lambda: globalnorm_tm(x, p["FF_W"], p["FF_b"]), reps=5)
        trans = globalnorm_tm(x, p["FF_W"], p["FF_b"])
        fwd = cuda_ms(lambda: crf_viterbi_scores_tm(trans), reps=5)
        final, tb = crf_viterbi_scores_tm(trans)
        back = cuda_ms(lambda: crf_backtrace_tm(final, tb), reps=5)
        emit({"phase": "throughput_rnnrf", "path": "fused", "B": B,
              "chunk": CHUNK, "ms": round(total, 4),
              "samples_per_s": round(B * CHUNK / (total / 1e3), 1),
              "breakdown_ms": {"conv+gru x5 residual": round(feats, 4),
                               "head+partition": round(head, 4),
                               "crf forward": round(fwd, 4),
                               "backtrace": round(back, 4)},
              "card": card})
        nsample = sum(len(r.raw) for r in reads)
        for mode in ("fast", "stitch"):
            eng = BasecallEngine("rnnrf_r94", device="cuda", mode=mode)
            profiled(f"rnnrf engine {mode}, batch {eng.batch_size}, "
                     f"{len(reads)} reads, {nsample} samples",
                     lambda: eng.basecall_signals(reads), card)


def events_input(enet, B: int, rng) -> "torch.Tensor":
    """Studentised event features of B chunks of T_EVENTS events, as the
    engine hands them to the network: [B, T_EVENTS, 4] on the card."""
    import numpy as np
    import torch

    return torch.as_tensor(rng.standard_normal((B, T_EVENTS, 4)).astype(np.float32),
                           device=enet.device)


def check_lstm_kernel(enet, B: int) -> dict:
    """The LSTM kernel against its twin on the events network's four
    layers (C = 12 for stage 1, 96 for stage 2; forward and backward), on
    the features a chunk of B x T_EVENTS events gives; then the times of
    the layer, of its projection and recurrence kernels, of torch.matmul
    on the same projection (a yardstick the port never calls) and of the
    twin (median of 3, a loop over T). Last, the decode kernels against
    their twins on what the events path hands them: the fused head +
    Viterbi on the second stage's feedforward2_tanh output with FF3, the
    forward and backtrace on the FF3 head's log posterior."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import (feedforward, feedforward2_tanh,
                                          robustlog, softmax_with_temperature,
                                          window)
    from scrappie_torch.ops import lstm as L

    rng = np.random.default_rng(SEED + 20 + B)
    p = enet.params
    x = window(events_input(enet, B, rng), enet.winlen, 1).transpose(0, 1).contiguous()
    rows = {}
    for layer in (1, 2):
        C = x.shape[-1]
        h = {}
        for d in ("F", "B"):
            w = [p[f"lstm{d}{layer}_{k}"] for k in ("iW", "b", "sW", "p")]
            hk = L.lstm_layer_tm(x, *w, reverse=(d == "B"))
            hp = L.lstm_layer_tm_plain(x, *w, reverse=(d == "B"))
            sync()
            require(bool(torch.isfinite(hk).all()), f"lstm{d}{layer} kernel output finite")
            err = float((hk - hp).abs().max())
            require(err <= LSTM_ATOL, f"lstm{d}{layer} max abs err {err} <= {LSTM_ATOL}")
            h[d] = hk
            rows[f"lstm{d}{layer}"] = {"C": C, "max_abs_err": err}
        w = [p[f"lstmB{layer}_{k}"] for k in ("iW", "b", "sW", "p")]
        xproj = L.lstm_project_cuda(x, w[0], w[1])
        rows[f"lstmB{layer}"].update({
            "ms": cuda_ms(lambda: L.lstm_layer_tm(x, *w, reverse=True)),
            "projection_ms": cuda_ms(lambda: L.lstm_project_cuda(x, w[0], w[1])),
            "recurrence_ms": cuda_ms(
                lambda: L.lstm_recurrence_cuda(xproj, w[2], w[3], reverse=True)),
            "projection_library_ms": cuda_ms(lambda: feedforward(x, w[0], w[1])),
            "plain_ms": cuda_ms(lambda: L.lstm_layer_tm_plain(x, *w, reverse=True),
                                reps=3, warmup=1),
            **kernel_work("lstm_layer", T=T_EVENTS, B=B, C=C, S=w[2].shape[0])})
        x = feedforward2_tanh(h["F"], h["B"], p[f"FF{layer}_Wf"],
                              p[f"FF{layer}_Wb"], p[f"FF{layer}_b"])
    emit({"phase": "lstm_kernel", "B": B, "T": T_EVENTS, "layers": rows})
    fused = check_fused(x, p["FF3_W"], p["FF3_b"], "events")
    lp = robustlog(softmax_with_temperature(x, p["FF3_W"], p["FF3_b"]),
                   1e-5).contiguous()
    check_forward_and_backtrace(lp, "events posterior")
    emit({"phase": "events_decode_kernels", "B": B, "T": T_EVENTS,
          "fused": fused, "forward_backtrace": "identical"})
    row = dict(rows["lstmB2"])  # the C = 96 layer, the larger of the two
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return row


def main_path_events(card: str, reads: list) -> dict:
    """BasecallEngine("nanonet_events") on the card in fast and stitch
    mode; each mode's kernels must have launched in its own run."""
    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.seqcompare import edit_distance, within_flip_rule
    from scrappie_torch.utils.tracing import Stage

    lengths = [len(r.raw) for r in reads]
    nsample = sum(lengths)
    modes = ("fast", "stitch")
    engines = {mode: BasecallEngine("nanonet_events", device="cuda", mode=mode)
               for mode in modes}
    for mode in modes:
        engines[mode].basecall_signals(reads[:1])

    ops.reset_launches()
    results = {}
    for mode in modes:
        before = dict(ops.LAUNCHES)
        engines[mode].stage = Stage()
        t0 = time.perf_counter()
        res = engines[mode].basecall_signals(reads)
        seconds = time.perf_counter() - t0
        require(all(r.sequence for r in res), f"events {mode}: every read called")
        results[mode] = res
        launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        for name in EVENTS_KERNELS[mode]:
            require(launched[name] > 0,
                    f"kernel {name} launched on the events {mode} path "
                    f"({launched[name]})")
        nevent = sum(r.nblock for r in res)
        stages = engines[mode].stage.report()
        emit({"phase": "main_path_events", "mode": mode, "reads": len(res),
              "samples": nsample, "events": nevent, "seconds": round(seconds, 4),
              "events_per_s": round(nevent / seconds, 1),
              "samples_per_s": round(nsample / seconds, 1),
              "bases": sum(len(r.sequence) for r in res),
              "detect_events_share": stages["detect_events"]["seconds"] / seconds,
              "assemble_share": stages["assemble"]["seconds"] / seconds,
              "launches": launched, "stages": stages, "card": card})
    launches = dict(ops.LAUNCHES)

    short = sorted(range(len(reads)), key=lambda i: lengths[i])[:2]
    for mode in modes:
        cpu = BasecallEngine("nanonet_events", device="cpu", mode=mode)
        cres = cpu.basecall_signals([reads[i] for i in short])
        for i, c in zip(short, cres):
            g = results[mode][i].sequence
            dist = 0 if g == c.sequence else edit_distance(g, c.sequence)
            emit({"phase": "cpu_vs_cuda_events", "mode": mode,
                  "read": reads[i].uuid, "bases": len(g), "edit_distance": dist})
            require(within_flip_rule(g, c.sequence),
                    f"events {mode} {reads[i].uuid}: CUDA and CPU calls agree")
    return launches


def throughput_events(enet, card: str, reads: list) -> None:
    """The events fused path at B = 64 chunks of T_EVENTS events, stage by
    stage; then the events engine in each mode under torch.profiler."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import feedforward2_tanh, window
    from scrappie_torch.ops.lstm import lstm_layer_tm
    from scrappie_torch.ops.viterbi import viterbi_backtrace_tm, viterbi_fused_tm
    from scrappie_torch.parallel.runner import BasecallEngine

    B = 64
    p = enet.params
    feats = events_input(enet, B, np.random.default_rng(SEED + 5))
    breakdown = {}
    with torch.inference_mode():
        total = cuda_ms(lambda: enet.basecall_fused(feats), reps=5)
        win = lambda: window(feats, enet.winlen, 1).transpose(0, 1).contiguous()
        breakdown["window"] = cuda_ms(win, reps=5)
        x = win()
        for layer in (1, 2):
            h = {}
            for d in ("F", "B"):
                w = [p[f"lstm{d}{layer}_{k}"] for k in ("iW", "b", "sW", "p")]
                breakdown[f"lstm {d}{layer}"] = cuda_ms(
                    lambda: lstm_layer_tm(x, *w, reverse=(d == "B")), reps=5)
                h[d] = lstm_layer_tm(x, *w, reverse=(d == "B"))
            ff = lambda: feedforward2_tanh(h["F"], h["B"], p[f"FF{layer}_Wf"],
                                           p[f"FF{layer}_Wb"], p[f"FF{layer}_b"])
            breakdown[f"feedforward2_tanh {layer}"] = cuda_ms(ff, reps=5)
            x = ff()
        breakdown["fused head+viterbi"] = cuda_ms(
            lambda: viterbi_fused_tm(x, p["FF3_W"], p["FF3_b"]), reps=5)
        final, tb = viterbi_fused_tm(x, p["FF3_W"], p["FF3_b"])
        breakdown["backtrace"] = cuda_ms(lambda: viterbi_backtrace_tm(final, tb),
                                         reps=5)
        emit({"phase": "throughput_events", "path": "fused", "B": B,
              "events": T_EVENTS, "ms": total,
              "events_per_s": B * T_EVENTS / (total / 1e3),
              "breakdown_ms": breakdown, "card": card})
        nsample = sum(len(r.raw) for r in reads)
        for mode in ("fast", "stitch"):
            eng = BasecallEngine("nanonet_events", device="cuda", mode=mode)
            profiled(f"events engine {mode}, batch {eng.batch_size}, "
                     f"{len(reads)} reads, {nsample} samples",
                     lambda: eng.basecall_signals(reads), card)


def random_bases(n: int, rng) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def simulate_squiggle(squiggle, n: int, rng) -> "np.ndarray":
    """n normalised samples from an untransformed squiggle [npos, 3]
    (current, log sd, -log dwell): each base holds round(1.25 dwell)
    samples (at least 1) of its current plus Gaussian noise of its sd, cut
    or padded with noise to n."""
    import numpy as np

    dwell = np.maximum(1, np.rint(1.25 * np.exp(-squiggle[:, 2]))).astype(int)
    x = (np.repeat(squiggle[:, 0], dwell)
         + rng.standard_normal(dwell.sum()) * np.repeat(np.exp(squiggle[:, 1]), dwell))
    x = np.concatenate([x, rng.standard_normal(max(0, n - len(x)))])[:n]
    return x.astype(np.float32)


def check_squiggle(card: str) -> None:
    """The three squiggle models on the card against the port's CPU run,
    with and without the unit transform."""
    import numpy as np

    from scrappie_torch import api

    seq = random_bases(SQUIGGLE_BASES, np.random.default_rng(SEED + 30))
    rows = {}
    for model in SQUIGGLE_MODELS:
        for rescale in (False, True):
            t0 = time.perf_counter()
            gpu = api.sequence_to_squiggle(seq, model, rescale, device="cuda")
            seconds = time.perf_counter() - t0
            cpu = api.sequence_to_squiggle(seq, model, rescale, device="cpu")
            require(gpu.shape == (SQUIGGLE_BASES, 3) and bool(np.isfinite(gpu).all()),
                    f"{model} squiggle finite [{SQUIGGLE_BASES}, 3]")
            rel = float((np.abs(gpu - cpu) / np.maximum(np.abs(cpu), 1.0)).max())
            require(rel <= SQUIGGLE_RTOL,
                    f"{model} squiggle rel err {rel} <= {SQUIGGLE_RTOL}")
            rows[f"{model}{' rescaled' if rescale else ''}"] = {
                "max_abs_err": float(np.abs(gpu - cpu).max()), "max_rel_err": rel,
                "seconds": seconds}
    emit({"phase": "squiggle", "bases": SQUIGGLE_BASES, "models": rows,
          "card": card})


def dtw_case(npos: int, T: int, rng):
    """A DTW input: the squiggle_r94 prediction of npos seeded bases (on
    the card) and T samples simulated from it, as a tensor on the card."""
    import torch

    from scrappie_torch import api

    params = api.sequence_to_squiggle(random_bases(npos, rng), device="cuda")
    sig = torch.as_tensor(simulate_squiggle(params, T, rng), device="cuda")
    return sig, params


def check_dtw(sig, params, what: str) -> dict:
    """The DTW kernel against its twin on one input, Viterbi and forward,
    prob_back 0 and 0.1: Viterbi finals and tracebacks identical, forward
    finals within FORWARD_RTOL. Returns the largest differences and the
    twin's seconds for Viterbi with prob_back 0."""
    import torch

    from scrappie_torch.decode.dtw import match_inputs
    from scrappie_torch.ops import dtw as d

    out = {"max_abs_err": 0.0, "forward_rel_err": 0.0}
    for prob_back in (0.0, 0.1):
        inputs = match_inputs(params, 1.0, prob_back, "cuda")
        args = (sig, *inputs, prob_back, DTW_OPTIONS["local_pen"],
                DTW_OPTIONS["skip_pen"], DTW_OPTIONS["minscore"])
        for viterbi in (True, False):
            fk, tbk = d.squiggle_match_tm(*args, viterbi=viterbi)
            t0 = time.perf_counter()
            fp, tbp = d.squiggle_match_plain(*args, viterbi=viterbi)
            sync()
            if viterbi and not prob_back:
                out["plain_s"] = time.perf_counter() - t0
            label = f"{what}, viterbi={viterbi}, prob_back={prob_back}"
            require(bool(torch.isfinite(fk).all()), f"dtw final finite ({label})")
            if viterbi:
                require(torch.equal(tbk, tbp), f"dtw traceback identical ({label})")
                require(torch.equal(fk, fp), f"dtw final identical ({label})")
            else:
                rel = float(((fk - fp).abs() / fp.abs().clamp(min=1.0)).max())
                require(rel <= FORWARD_RTOL,
                        f"dtw forward final rel err {rel} <= {FORWARD_RTOL} ({label})")
                out["forward_rel_err"] = max(out["forward_rel_err"], rel)
            out["max_abs_err"] = max(out["max_abs_err"], float((fk - fp).abs().max()))
    return out


def check_dtw_kernel(card: str) -> dict:
    """The DTW kernel in both variants against its twin, then its times at
    the main path's size (MAP_BASES positions, MAP_SAMPLES samples)."""
    import numpy as np
    import torch

    from scrappie_torch.decode.dtw import match_inputs
    from scrappie_torch.ops import dtw as d

    rng = np.random.default_rng(SEED + 40)
    rows = {}
    for name, (npos, T) in (("shared", DTW_SHARED), ("global", DTW_GLOBAL)):
        sig, params = dtw_case(npos, T, rng)
        require((npos <= d.DTW_MAX_SHARED_NPOS) == (name == "shared"),
                f"dtw {name} case {npos} positions takes its variant")
        row = check_dtw(sig, params, f"{name}, {npos} x {T}")
        args = (sig, *match_inputs(params, 1.0, 0.0, "cuda"), 0.0,
                *DTW_OPTIONS.values())
        row.update(npos=npos, T=T, ms=cuda_ms(lambda: d.squiggle_match_tm(*args)),
                   plain_ms=row.pop("plain_s") * 1e3)
        rows[name] = row
    npos, T = MAP_BASES, MAP_SAMPLES
    sig, params = dtw_case(npos, T, rng)
    args = (sig, *match_inputs(params, 1.0, 0.0, "cuda"), 0.0, *DTW_OPTIONS.values())
    fk, tbk = d.squiggle_match_tm(*args)
    t0 = time.perf_counter()
    fp, tbp = d.squiggle_match_plain(*args)
    sync()
    plain_s = time.perf_counter() - t0
    require(torch.equal(tbk, tbp) and torch.equal(fk, fp),
            f"dtw traceback and final identical ({npos} x {T})")
    del tbp
    timed = {"npos": npos, "T": T, "max_abs_err": float((fk - fp).abs().max()),
             "ms": cuda_ms(lambda: d.squiggle_match_tm(*args)),
             "global_ms": cuda_ms(lambda: d.squiggle_match_tm(*args, global_state=True),
                                  reps=3, warmup=1),
             "forward_ms": cuda_ms(lambda: d.squiggle_match_tm(*args, viterbi=False),
                                   reps=3, warmup=1),
             "plain_ms": plain_s * 1e3,
             "traceback_bytes": tbk.numel() * 4,
             "traceback_copy_ms": cuda_ms(lambda: tbk.cpu(), reps=3, warmup=0),
             **kernel_work("dtw", T=T, npos=npos)}
    timed["us_per_sample"] = timed["ms"] * 1e3 / T
    # the table's error: the largest difference of any check
    timed["max_abs_err"] = max([timed["max_abs_err"]]
                               + [r["max_abs_err"] for r in rows.values()])
    emit({"phase": "dtw_kernel", "checked": rows, "timed": timed, "card": card})
    return timed


def seqmap_case(rng):
    """The rgrgr_r94 log posterior (through api.calc_post on the card) of
    a synthetic MAP_SAMPLES-sample read, and a seeded MAP_BASES-base
    reference."""
    from scrappie_torch import api

    raw = api.RawTable(synthetic_signal(MAP_SAMPLES, rng))
    raw.trim().scale()
    return api.calc_post(raw, "rgrgr_r94", device="cuda"), random_bases(MAP_BASES, rng)


def check_seqmap_kernel(card: str) -> dict:
    """The seqmap kernel against its twin, Viterbi (with its traceback)
    and forward, with the scores in shared and in global memory; then its
    times."""
    import numpy as np
    import torch

    from scrappie_torch import api
    from scrappie_torch.ops import seqmap as m

    post, ref = seqmap_case(np.random.default_rng(SEED + 50))
    lp = torch.as_tensor(post.data(), device="cuda")
    states = torch.as_tensor(api.encode_bases(ref, 5).astype(np.int32), device="cuda")
    T, nst = lp.shape
    seqlen = states.shape[0]
    pens = (0.0, 0.0, 4.0)
    out = {"T": T, "nst": nst, "seqlen": seqlen, "max_abs_err": 0.0,
           "forward_rel_err": 0.0}
    for viterbi in (True, False):
        t0 = time.perf_counter()
        fp, tbp = m.map_to_sequence_plain(lp, states, *pens, viterbi=viterbi)
        sync()
        if viterbi:
            out["plain_ms"] = (time.perf_counter() - t0) * 1e3
        for global_state in (False, True):
            fk, tbk = m.map_to_sequence_tm(lp, states, *pens, viterbi=viterbi,
                                           global_state=global_state)
            sync()
            label = f"viterbi={viterbi}, global_state={global_state}"
            require(bool(torch.isfinite(fk).all()), f"seqmap final finite ({label})")
            if viterbi:
                require(torch.equal(tbk, tbp), f"seqmap traceback identical ({label})")
                require(torch.equal(fk, fp), f"seqmap final identical ({label})")
            else:
                rel = float(((fk - fp).abs() / fp.abs().clamp(min=1.0)).max())
                require(rel <= FORWARD_RTOL,
                        f"seqmap forward final rel err {rel} <= {FORWARD_RTOL} ({label})")
                out["forward_rel_err"] = max(out["forward_rel_err"], rel)
            out["max_abs_err"] = max(out["max_abs_err"], float((fk - fp).abs().max()))
    _, tb = m.map_to_sequence_tm(lp, states, *pens)
    out.update(
        ms=cuda_ms(lambda: m.map_to_sequence_tm(lp, states, *pens)),
        global_ms=cuda_ms(lambda: m.map_to_sequence_tm(lp, states, *pens,
                                                       global_state=True)),
        forward_ms=cuda_ms(lambda: m.map_to_sequence_tm(lp, states, *pens,
                                                        viterbi=False), reps=5),
        traceback_bytes=tb.numel() * 4,
        traceback_copy_ms=cuda_ms(lambda: tb.cpu(), reps=5),
        **kernel_work("seqmap", T=T, nst=nst, seqlen=seqlen))
    out["us_per_block"] = out["ms"] * 1e3 / T
    emit({"phase": "seqmap_kernel", **out, "card": card})
    return out


def main_path_mapping(card: str) -> dict:
    """The mapping path through the API on the card: the launches of its
    two kernels in this run, each call's seconds, and each result held to
    the port's CPU run on the same inputs. map_signal_to_squiggle's CPU
    reference aligns the same normalised signal to the card's squiggle (the
    squiggle phase holds the two squiggles to SQUIGGLE_RTOL; a DP path over
    tens of thousands of samples is identical only on identical inputs);
    map_post_to_sequence's maps the same posterior."""
    import numpy as np

    from scrappie_torch import api, ops
    from scrappie_torch.decode.dtw import squiggle_match_viterbi

    rng = np.random.default_rng(SEED + 60)
    seq = random_bases(MAP_BASES, rng)
    squiggle = api.sequence_to_squiggle(seq, device="cuda")
    pad = lambda: 150.0 + rng.normal(0.0, 0.3, 300)
    data = np.concatenate([pad(), 90.0 + 12.0 * simulate_squiggle(
        squiggle, MAP_SAMPLES, rng), pad()]).astype(np.float32)
    read = synthetic_signal(MAP_SAMPLES, rng)
    ref = random_bases(MAP_BASES, rng)
    calls = (("viterbi, path", dict(viterbi=True, path=True)),
             ("forward", {}),
             (f"banded {MAP_BAND}, viterbi", dict(viterbi=True, bands=MAP_BAND)),
             (f"banded {MAP_BAND}, forward", dict(bands=MAP_BAND)))

    ops.reset_launches()
    t0 = time.perf_counter()
    score, path = api.map_signal_to_squiggle(data, seq, device="cuda")
    seconds = {"map_signal_to_squiggle": time.perf_counter() - t0}
    raw = api.RawTable(read)
    raw.trim().scale()
    post = api.calc_post(raw, "rgrgr_r94", device="cuda")
    results = {}
    for what, kw in calls:
        t0 = time.perf_counter()
        results[what] = api.map_post_to_sequence(post, ref, device="cuda", **kw)
        seconds[what] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in ("dtw", "seqmap"):
        require(launches[name] > 0,
                f"kernel {name} launched on the mapping path ({launches[name]})")

    raw = api.RawTable(data)
    raw.trim().scale()
    require(np.array_equal(api.sequence_to_squiggle(seq, device="cuda"), squiggle),
            "the card's squiggle is reproducible")
    t0 = time.perf_counter()
    cscore, cpath = squiggle_match_viterbi(raw.data(as_numpy=True), squiggle,
                                           skip_pen=DTW_OPTIONS["skip_pen"],
                                           device="cpu")
    cpu_seconds = {"map_signal_to_squiggle": time.perf_counter() - t0}
    require(np.array_equal(cpath, path[raw.start:raw.end]) and cscore == score,
            "map_signal_to_squiggle: CUDA and CPU paths and scores identical")
    mapped = path[path >= 0]
    for what, kw in calls:
        t0 = time.perf_counter()
        cres = api.map_post_to_sequence(post, ref, device="cpu", **kw)
        cpu_seconds[what] = time.perf_counter() - t0
        gres = results[what]
        if kw.get("viterbi"):
            require(cres[0] == gres[0], f"map_post_to_sequence {what}: scores identical")
        else:
            rel = abs(cres[0] - gres[0]) / max(abs(cres[0]), 1.0)
            require(rel <= FORWARD_RTOL,
                    f"map_post_to_sequence {what}: score rel err {rel} <= {FORWARD_RTOL}")
        if kw.get("path"):
            require(np.array_equal(cres[1], gres[1]),
                    f"map_post_to_sequence {what}: paths identical")
    emit({"phase": "main_path_mapping", "bases": MAP_BASES,
          "samples": len(data), "trimmed": raw.end - raw.start,
          "blocks": post.shape[0], "score": score,
          "mapped_samples": int(len(mapped)),
          "positions_reached": int(mapped.max()) + 1 if len(mapped) else 0,
          "scores": {k: v[0] for k, v in results.items()},
          "seconds": seconds, "cpu_seconds": cpu_seconds, "launches": launches,
          "card": card})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    from scrappie_torch.models.forward import EventsModel, RgrgrModel, RnnrfModel

    card = card_line()
    build()
    net = RgrgrModel.from_registry("rgrgr_r94", "cuda")
    rnet = RnnrfModel.from_registry("rnnrf_r94", "cuda")
    enet = EventsModel.from_registry("nanonet_events", "cuda")
    with torch.inference_mode():
        check_kernels(net, 8)
        table = check_kernels(net, 64)
        check_viterbi_options(net)
        check_crf_kernels(rnet, 8)
        table.update(check_crf_kernels(rnet, 64))
        check_lstm_kernel(enet, 8)
        table["lstm_layer"] = check_lstm_kernel(enet, 64)
    reads = synthetic_reads()
    launches = main_path(card, reads)
    throughput(net, card)
    profile_and_scale(net, card, reads)
    rnnrf_launches = main_path_rnnrf(card, reads)
    throughput_rnnrf(rnet, card, reads)
    events_launches = main_path_events(card, reads)
    throughput_events(enet, card, reads)
    with torch.inference_mode():
        check_squiggle(card)
        table["dtw"] = check_dtw_kernel(card)
        table["seqmap"] = check_seqmap_kernel(card)
    mapping_launches = main_path_mapping(card)
    # each kernel's launches on its own path; the GRU's and the Viterbi
    # kernels' on the rgrgr path
    launches.update({k: rnnrf_launches[k] for k in RNNRF_KERNELS
                     if k != "gru_layer"})
    launches["lstm_layer"] = events_launches["lstm_layer"]
    launches.update({k: mapping_launches[k] for k in ("dtw", "seqmap")})
    # No single PyTorch call computes any of these functions: torch.nn.GRU
    # applies r after its matmul (scrappie before), torch.nn.LSTM has no
    # peepholes, and nothing in PyTorch does a Viterbi decode, the CRF's
    # partition function or either mapping DP. So library_ms is null
    # throughout.
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": table[name]["max_abs_err"], "ms": table[name]["ms"],
         "plain_ms": table[name]["plain_ms"],
         "bound_ms": table[name]["bound_ms"],
         "bound_by": table[name]["bound_by"], "library_ms": None}
        for name in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
