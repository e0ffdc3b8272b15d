#!/usr/bin/env python3
"""Time the LSTM's training kernels against variants of their design.

    python3 scripts/lstm_walk_variants.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
Builds scrappie_torch/csrc/lstm.cu as it is and in variants made by
editing its text, each into a library of its own under
build/lstm_variants/, and times each library's training forward and
backward walk (both directions of a stage in one launch, CUDA events,
median of 20, in turns) on the events network's shapes: T = 2048 and
B = 8 and 64, and the whole-read step's T = 11 520, B = 1. Two kinds of
variant:

  * designs that compute the same thing: the forward storing the walk's
    six coefficients in place of tanh(c) and the gates ("coefficient
    planes"), the input copies issued after the step's product, not
    right after the barrier ("copies after the product"), da in shared
    memory without the padding that spreads a warp's reads over the banks
    ("da rows unpadded"); each
    variant's da is held to the shipped kernel's (equal, or within 1e-5
    of its largest entry for the coefficient planes, whose products
    associate otherwise);
  * timing-only variants that leave one part of the walk's step out
    (the da store, the input copies, the reduce-scatter, the block
    barrier, the coefficients' arithmetic): their results are wrong and
    only their times are read.

Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "scrappie_torch" / "csrc" / "lstm.cu"
OUT = ROOT / "build" / "lstm_variants"
SHAPES = ((2048, 8), (2048, 64), (11520, 1))
S = 96
REPS = 20
ROUNDS = 2

# The forward's training stores and the walk's coefficients, as shipped.
PLANE_STORES = """        yt[2 * coff] = tc;
        yt[3 * coff] = cell;
        yt[4 * coff] = in;
        yt[5 * coff] = forget;
        yt[6 * coff] = so;
"""
COEF_STORES = """        const float A = tc * so * (1.0f - so);
        const float F = c_old * forget * (1.0f - forget);
        const float I = cell * in * (1.0f - in);
        yt[2 * coff] = in * (1.0f - cell * cell);
        yt[3 * coff] = I;
        yt[4 * coff] = F;
        yt[5 * coff] = A;
        yt[6 * coff] = so * (1.0f - tc * tc) + A * p_out;
        yt[7 * coff] = forget + F * p_f + I * p_in;
"""
WALK_COEF = """    const LstmCoef co =
        lstm_coef(in[0], in[BW_PLANE], in[2 * BW_PLANE], in[3 * BW_PLANE],
                  in[4 * BW_PLANE], cp, s_peep[0][kc], s_peep[1][kc],
                  s_peep[2][kc]);
"""
READ_COEF = """    const LstmCoef co = {in[0], in[BW_PLANE], in[2 * BW_PLANE],
                         in[3 * BW_PLANE], in[4 * BW_PLANE], in[5 * BW_PLANE]};
"""
# name -> (edits, forward planes past h, same result as shipped)
VARIANTS = {
    "shipped": ([], 6, True),
    "coefficient planes": ([
        ("    c = __fadd_rn(__fmul_rn(forget, c), __fmul_rn(in, cell));\n",
         "    const float c_old = c;\n"
         "    c = __fadd_rn(__fmul_rn(forget, c), __fmul_rn(in, cell));\n"),
        ("    if (g == 0 && live) {\n      const float h = __fmul_rn(so, tc);\n",
         "    const float p_in = __shfl_sync(FULL, p_gate, quad + 1);\n"
         "    const float p_f = __shfl_sync(FULL, p_gate, quad + 2);\n"
         "    if (g == 0 && live) {\n      const float h = __fmul_rn(so, tc);\n"),
        (PLANE_STORES, COEF_STORES),
        ("  constexpr int NG = 5;", "  constexpr int NG = 6;"),
        (WALK_COEF, READ_COEF)], 7, True),
    "copies after the product": ([
        ("      fetch(n + BW_RING - 1);  // into the slot of step n - 1\n", ""),
        ("      carry_h = reduce_scatter16(p, q);\n",
         "      carry_h = reduce_scatter16(p, q);\n"
         "      fetch(n + BW_RING - 1);\n")], 6, True),
    "da rows unpadded": ([
        ("__device__ constexpr int da_at(int j) { return j + 4 * (j / BW_ROWS); }",
         "__device__ constexpr int da_at(int j) { return j; }")], 6, True),
    "timing only: no da store": ([
        ("      if (live) *dout = mine;\n", "")], 6, False),
    "timing only: no input copies": ([
        ("      fetch(n + BW_RING - 1);  // into the slot of step n - 1\n", "")],
        6, False),
    "timing only: no reduce-scatter": ([
        ("      carry_h = reduce_scatter16(p, q);",
         "      carry_h = __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));")],
        6, False),
    "timing only: no block barrier": ([
        ("      cp_async_wait_mem<BW_RING - 3>();  // this thread's copies of n + 1\n"
         "      __syncthreads();\n",
         "      cp_async_wait_mem<BW_RING - 3>();\n")], 6, False),
    "timing only: no coefficient arithmetic": ([
        (WALK_COEF, READ_COEF.replace("in[5 * BW_PLANE]", "cp"))], 6, False),
}


def build_all() -> dict:
    """Each variant's library, built by parallel nvcc processes."""
    from scrappie_torch.ops import _build

    text = SOURCE.read_text()
    procs = {}
    for i, (name, (edits, _planes, _same)) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {old[:60]!r} not in {SOURCE.name}")
            src = src.replace(old, new, 1)
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "lstm.cu").write_text(src)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "lstm.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        cdll = ctypes.CDLL(str(lib))
        for fn in ("scrappie_lstm_pair_train", "scrappie_lstm_recurrence_bwd"):
            getattr(cdll, fn).argtypes = _build._SIGNATURES[fn]
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def median_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    from scrappie_torch import ops

    if not torch.cuda.is_available():
        print("lstm_walk_variants: no CUDA GPU", file=sys.stderr)
        return 2
    libs = build_all()
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(17)
    f = lambda *shape, s=1.0: torch.as_tensor(
        (s * rng.standard_normal(shape)).astype(np.float32), device="cuda")
    w = [(f(S, 4 * S, s=S ** -0.5), f(3 * S, s=0.3)) for _ in "FB"]
    stream = lambda: ctypes.c_void_p(ops.stream_handle())
    for T, B in SHAPES:
        xproj = f(T, B, 8 * S)
        gh = f(2, T, B, S)
        outs, das = {}, {}

        def forward(name):
            out = outs[name]
            err = libs[name].scrappie_lstm_pair_train(
                xproj.data_ptr(), w[0][0].data_ptr(), w[0][1].data_ptr(),
                out[0, 0].data_ptr(), out[1, 0].data_ptr(), w[1][0].data_ptr(),
                w[1][1].data_ptr(), out[0, 1].data_ptr(), out[1, 1].data_ptr(),
                T, B, S, 0, stream())
            assert err == 0, (name, err)

        def walk(name):
            out, (da, dp) = outs[name], das[name]
            err = libs[name].scrappie_lstm_recurrence_bwd(
                out[1, 0].data_ptr(), gh[0].data_ptr(), w[0][0].data_ptr(),
                w[0][1].data_ptr(), 0, out[1, 1].data_ptr(), gh[1].data_ptr(),
                w[1][0].data_ptr(), w[1][1].data_ptr(), 1, out.stride(0),
                da.data_ptr(), 8 * S, dp.data_ptr(), 2, T, B, S, 0, stream())
            assert err == 0, (name, err)

        for name, (_edits, planes, _same) in VARIANTS.items():
            outs[name] = torch.empty((1 + planes, 2, T, B, S), device="cuda")
            das[name] = (torch.empty((T, B, 8 * S), device="cuda"),
                         torch.empty((2, B, 3 * S), device="cuda"))
            forward(name)
            walk(name)
        torch.cuda.synchronize()
        ref = das["shipped"][0]
        row = {"T": T, "B": B, "S": S, "card": card}
        for name, (_edits, _planes, same) in VARIANTS.items():
            if same and name != "shipped":
                err = float((das[name][0] - ref).abs().max() / ref.abs().max())
                if err > 1e-5:
                    raise RuntimeError(f"{name}: da rel err {err} against shipped")
                row[f"{name}: da max rel err"] = err
        for _ in range(ROUNDS):
            for name in VARIANTS:
                row.setdefault(f"{name}: walk ms", []).append(
                    median_ms(lambda: walk(name)))
                if name in ("shipped", "coefficient planes"):
                    row.setdefault(f"{name}: forward ms", []).append(
                        median_ms(lambda: forward(name)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
