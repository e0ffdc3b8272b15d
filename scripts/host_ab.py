#!/usr/bin/env python3
"""Time the host-bound runs of two checkouts of scrappie_torch on one GPU,
in turns.

    python3 scripts/host_ab.py OTHER_CHECKOUT

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
Each turn (other, this, this, other) is a fresh process that imports
scrappie_torch and chip_smoke.py from its own checkout (its kernels built
there at first use) and times, on chip_smoke's 16 seeded reads, the runs
whose time the host bounds:

  * BasecallEngine("rgrgr_r94", device="cuda") in stitch mode with the
    homopolymer "nochange" and "mean";
  * BasecallEngine("nanonet_events", device="cuda") in fast and stitch
    mode;

each after one warm-up call, the median of REPS calls (host clock, the
card synchronised); then nanonet_events training as chip_smoke's phase
main_path_train runs it (TRAIN: 8 steps of 8 x 400 detected events from
the same seeded init, one value_and_grad first), seconds a step.

Prints a JSON line a turn, then the card's name and power limit. Host
times move between calls with the host's load: compare two checkouts only
within one call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPS = 3
ENGINE_RUNS = (("rgrgr stitch nochange", "rgrgr_r94", "stitch", "nochange"),
               ("rgrgr stitch mean", "rgrgr_r94", "stitch", "mean"),
               ("events fast", "nanonet_events", "fast", None),
               ("events stitch", "nanonet_events", "stitch", None))


def turn(checkout: pathlib.Path) -> dict:
    """The times of one checkout, in this process."""
    sys.path.insert(0, str(checkout))
    import torch

    import chip_smoke
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.train import trainer
    from scrappie_torch.train.simulate import SquiggleSimulator

    reads = chip_smoke.synthetic_reads()
    out = {}
    with torch.inference_mode():
        for label, model, mode, hp in ENGINE_RUNS:
            eng = BasecallEngine(model, device="cuda", mode=mode)
            eng.basecall_signals(reads[:1], homopolymer=hp)
            seconds = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                eng.basecall_signals(reads, homopolymer=hp)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            out[label] = {"median_s": statistics.median(seconds), "runs_s": seconds}

    model, train = "nanonet_events", chip_smoke.TRAIN
    params = chip_smoke.random_params(model, chip_smoke.SEED + 133)
    seed = chip_smoke.SEED + 143
    sim = SquiggleSimulator(seed=seed, device="cuda")
    sig, labels = sim.detected_events_batch(train["batch"], train["nsample"] // 10)
    trainer.value_and_grad(model, {k: torch.as_tensor(v, device="cuda")
                                   for k, v in params.items()}, sig, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(model, params=params, seed=seed, log_every=0, device="cuda",
                  **train)
    torch.cuda.synchronize()
    out["events training"] = {"s_per_step": (time.perf_counter() - t0) / train["steps"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="the other checkout's root")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("host_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    if opts.turn:
        print(json.dumps(turn(opts.other.resolve())))
        return 0
    this = pathlib.Path(__file__).resolve().parents[1]
    other = opts.other.resolve()
    for i, (label, checkout) in enumerate((("other", other), ("this", this),
                                           ("this", this), ("other", other))):
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                               str(checkout), "--turn"], cwd=checkout,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(json.dumps({"turn": i, "checkout": label, "path": str(checkout),
                          **json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
