#!/usr/bin/env python3
"""Drive scrappie_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OTHER_CHECKOUT

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; it needs neither JAX nor h5py.
It prints one JSON line per phase and fails (nonzero exit, no result line)
if any phase fails:

  1. builds the kernels (scrappie_torch/csrc, nvcc, sm_90a), prints the
     build time and nvcc's per-kernel register and spill report (stderr),
     and fails if the GRU or LSTM recurrence, which hold their weights in
     registers, spills; then builds the port's C++ host library
     (scrappie_torch/native, g++) and holds each of its functions to its
     Python twin bit for bit on what one rgrgr stitch "mean" and one
     events stitch engine call hand it from the 16 reads of step 5
     (detect_events on every read, find_runs, the dwell overlapper), with
     the build's seconds and each function's host seconds in the library
     and the twin (phase host_native); and traces one rgrgr fast engine
     call with utils/tracing.profile, whose trace must name
     gru_recurrence_kernel (phase profile_trace);
  2. holds each kernel against its plain PyTorch twin at the main path's
     shapes (T = 2000 blocks, S = 96, 1025 states, B = 64; at B = 8 the
     Viterbi forward and backtrace, whose backtrace walks segments of a
     row there) and times both (CUDA events after warm-up: a kernel's
     median of 20, a twin's loop over time one run): the GRU layer through
     the paths' route (projection, then recurrence) and through the
     superseded layer kernel, the projection also beside torch.addmm (also
     over bursts of 10 calls, which leave out the host time), the
     head kernel's log posterior, and its route (head, then Viterbi
     forward) against the fused kernel's twin;
  3. holds the Viterbi kernels against their twins with nonzero penalties,
     slip and temperatures, and on log posteriors drawn from a few
     integers, where ties decide most moves;
  4. holds the fused ensemble kernel against its twin on the hidden
     features of rgrgr_r94, rgrgr_r941 and rgrgr_r10 (weights 3:1:1) at
     T = 2000, B = 64, also with penalties, slip and temperatures and
     with K = 2, and times it; holds the head kernel (K = 3 and 5) and its
     route the same way (phase ens_kernel); times the route against the
     fused kernels at K = 1 and 3, B = 8, 64 and 256 (phase routes); holds
     the head kernel against its twin at K = 1 (B = 8, 64 and 256), 3 and
     5 (B = 8 and 64), with and without temperatures, with its launch
     plan, its bound in each precision mode, torch.addmm's time for its
     product alone and a K = 3, B = 64 call's peak device memory (phase
     head_kernel); holds
     the GRU recurrence kernel against nn/rnn.gru_tm at T = 2000, S = 96,
     B = 8 and 64, both directions, and times it (phase
     gru_recurrence_kernel); holds the GRU (S = 160, 352) and LSTM (S =
     160, 288; at 160 also the pair route) layers in their big-S modes
     against their twins (phase big_s), the Viterbi forward and backtrace
     at nhist = 80, 1024 and, with slip, 2048, at B = 8, 64 and 256, on
     random and integer log posteriors (phase nhist); holds the forward
     and backtrace at the stitch shape and at T = 1, 7 and 2001, and the
     backtrace alone on hand-built tracebacks (all stays, a START run over
     the whole row, leading START and trailing END runs, tied finals) at
     B = 1, 3, 8, 64 and 256 and each of those nhist (phase
     backtrace_edges); and times the forward on random and integer log
     posteriors at B = 8, 64 and 256 and at a stitch shape, B = 4 x
     12 500 blocks (phase scaling, path "viterbi forward"); holds the GRU
     recurrence's backward walk kernel against its twin, and the whole
     backward (gates, walk, weight products) against torch.autograd
     through nn/rnn.gru_tm, at T = 2000, S = 96, B = 8 and 64, both
     directions, and at S = 40 and 7 (T = 300, B = 5, seeded weights)
     against the twin, and times it (phase gru_backward_kernel); holds the
     LSTM pair's training mode (h equal to the inference launch's, the
     planes the walk reads, c, tanh(c) and the gates, against the plain
     loop's), the LSTM's backward walk kernel (da and the dpeep partials)
     against its twin and the whole backward against torch.autograd
     through nn/rnn.lstm_tm, on the events network's first stage at T =
     2048, S = 96, B = 8 and 64, both directions in one launch, the walk
     at S = 40 and 7, and both kernels at the whole-read events step's
     11 520 events, B = 1, and times them with the forward in both modes
     (phase lstm_backward_kernel); holds the GRU's and the LSTM
     pair's training kernels at S = 160 in their big-S modes against their
     twins and against autograd, and the LSTM's big-S walk in its cluster
     mode at S = 160 and 288, B = 8 and 64 (its ms beside its bound, a
     latency floor and its cluster layout) and in its mode from L2 at S =
     400 (phase big_s_backward); holds the
     transducer and CRF lattice kernels (forward, then backward) against
     their twins on log P, logZ_local and the gradient, on rgrgr_r94's log
     posterior of 8 simulated windows of 800 blocks against 800 kmer
     states and on rnnrf_r94's transitions of 8 windows of 2 000 blocks
     against 1 408 bases (a row without a sequence; again checkpointed
     every 96 steps, with the CTAs' arrays in shared and in global
     memory, the gradient equal to chunk = T's; L = 1 and 2 too) and at a
     whole read of 30 720 blocks and 7 000 bases, checkpointed every 256
     steps (against the twins on the card and, in host processes, in
     float64; equal to chunk = T's bit for bit), and times them there,
     with the bytes they keep; and at 70 000 bases, above what one run of
     positions a thread holds (phase lattice_kernels);
  5. runs the main path, BasecallEngine("rgrgr_r94", device="cuda"), on
     16 seeded synthetic reads of 20k-100k samples in fast mode and in both
     stitch modes, checks that each kernel's launch counter rose and that
     every read has a sequence, and compares the shortest read with the port's CPU
     run of the same reads;
  6. times the fused path at B = 64 chunks of 10 000 samples;
  7. profiles (torch.profiler) the engine in each mode and the fused path,
     and times the engine and the fused path at several batch sizes;
  8. runs BasecallEngine("raw_r94") the same way in its three modes (phase
     main_path_raw) and times its fused path stage by stage
     (throughput_raw);
  9. holds the three CRF kernels (Viterbi forward, backtrace, partition
     function) against their twins at T = 1, 7, 5000 (a 10 000-sample
     chunk at stride 2) and 31 744 blocks (a stitch group of two reads)
     and B = 1, 2, 5, 7, 8, 33, 64 and 256: on the rnnrf head's
     transitions before and after globalnorm, on integer transitions in
     {-3..0}, with an emit bias of -1, and with stitch padding blocks, and
     the backtrace also on tracebacks built by hand (a constant map and
     the identity); the forward-backward kernel in both its modes (the
     state posterior; the partition's gradient, the edge marginals times a
     seeded g) at B = 1, 2, 5 and 64 on the same sets and T, within
     FWDBWD_ATOL of its twins, rows and blocks summing to 1, and at T =
     5000 the batched posterior of reads of unequal lengths (1 and 7
     blocks among them, padded as the engine pads them) in one launch and
     in the engine's launches (parallel/runner.crf_groups), each read's
     rows equal to its own call's bit for bit;
     times them at T = 5000, B = 8 and 64, and at T = 31 744, B = 2
     (phase crf_kernels); at that stitch shape holds the CRF Viterbi
     kernels and the forward-backward to decode/crf's parallel-in-time
     decode and posterior (impl "assoc", plain PyTorch on the card): paths
     equal, scores within 1e-4 relative, posteriors within 1e-4, and
     times both (phase crf_assoc);
 10. runs BasecallEngine("rnnrf_r94", device="cuda") in fast and stitch
     mode on the same 16 reads, checks the launch counters and every
     read's sequence, and compares the shortest read with the port's CPU run;
 11. times the rnnrf fused path at B = 64 x 10 000 samples, stage by stage,
     and profiles the rnnrf engine in both modes;
 12. runs the ensembles through the engine: rgrgr_r94 + rgrgr_r941 +
     rgrgr_r10 at 3:1:1 in fast mode (the head kernel must launch) and
     device stitch, the same primary with five members (3:1:1:1:1, beyond
     the fused ensemble kernel's four) in fast mode, and the rnnrf_r94
     self-ensemble in fast and stitch mode, whose calls must be the solo
     model's (phases main_path_ensemble, main_path_ensemble_k5,
     main_path_rnnrf_self_ensemble); then times the 3:1:1 fused path stage
     by stage and profiles its fast engine (throughput_ensemble);
 13. holds the peephole-LSTM routes against their twins with the events
     network's weights at T = 2048 events, B = 64, C = 12 and 96:
     each stage through the pair route (one projection against both
     layers' weights, one recurrence launch for both directions) and each
     layer through the single-direction route, and both routes at S = 16
     on seeded weights; times the recurrence alone (one direction and the
     pair), the layer and the pair route, and the projection at N = 4S and
     8S beside torch.addmm; then holds the fused head + Viterbi kernel and
     the head route, forward and backtrace kernels against their twins on
     the second stage's output and the FF3 head's posterior;
 14. runs BasecallEngine("nanonet_events", device="cuda") in fast and
     stitch mode on the same 16 reads, checks the launch counters and every
     read's sequence, and compares the shortest read with the port's CPU run;
 15. times the events fused path at B = 64 x 2048 events, stage by stage,
     and profiles the events engine in both modes;
 16. predicts the squiggles of a seeded 2 000-base sequence with the three
     squiggle models on the card and holds them to the port's CPU run;
 17. holds the DTW kernels against their twins, Viterbi (finals, moves,
     end sources, and the walk kernel's path) and forward, with prob_back 0
     and 0.1, on signals simulated from predicted squiggles: the cluster
     kernel at 300 positions x 3 000 samples, at 6 000 x 15 000 and on
     integer (tied) inputs, 2 000 x 20 000, and the global-state kernel
     above the cluster's capacity (2 000 samples), the 6 000 x 15 000 case
     also on clusters of 4 and 8 CTAs; then times the DP at 6 000 x 60 000
     on clusters of 4, 8 and 16 CTAs, the global kernel and the forward
     variant, the walk and the path's copy to the host, each walk beside
     its latency floor; then holds the walk against its twin on hand-made
     move planes (6 000 x 60 000, one at 6 001 positions starting 3 bytes
     past a 16-byte boundary, 40 x 3 000 and 3 x 2 000: far END jumps,
     back-state excursions, runs of skips, stays longer than a window of
     the walk, a leading START run) and times it there;
 18. holds the seqmap kernel (moves and finals, Viterbi and forward, the
     scores in registers and in global memory) and its walk kernel against
     their twins on the rgrgr_r94 posterior of a synthetic 60 000-sample
     read (about 12 000 blocks) against a seeded 6 000-base reference, on
     2 000 of its blocks against 12 000 and 20 000 bases, and on 65 small
     edge cases (ties, -inf, walks through the states -1 and -2 and START,
     seqlen 1 to 3, T = 1), and times the DP, its forward variant and the
     walk (alone, in bursts of 10, a block's microseconds, beside its
     latency floor); then holds the walk against its twin on hand-made
     move planes (seqmap_walk_plane: runs of skips that fall 2 a block
     over whole windows, entries at a window's first and last rows, steps
     below column 0 to the states -1 and -2, long stays at column 0, T = 1
     and 2) and times it there (phase seqmap_kernel); holds the banded kernel against its twin
     on the read's band of half-width 100, at widths 1, 2, 3, 32, 33, 256
     and 257 (shifts of the whole width, blocks at low == 0; the warp
     mode's boundaries), above 1 024 and with its window in global memory,
     and times it beside its latency floor (phase seqmap_banded_kernel);
 19. runs the mapping path through the API on the card,
     map_signal_to_squiggle on a signal simulated from the squiggle of a
     6 000-base sequence and map_post_to_sequence (Viterbi with a path,
     forward, banded), checks that each kernel's launch counter rose,
     splits each banded call into its kernels' device time and the rest,
     records what map_signal_to_squiggle and map_post_to_sequence (Viterbi
     with a path) copy to the host (profiler trace; the latter at most the
     path, two finals and one byte), and holds each result to the port's
     CPU run on the same inputs;
 20. runs BasecallEngine(..., device="cuda") with_qualities=True on the 16
     reads (phase qualities): rgrgr_r94 fast and stitch "nochange",
     raw_r94 fast, the 3:1:1 ensemble fast (also with
     qual_calibration="real", which must be the raw qualities through the
     ensemble's fit), nanonet_events fast and stitch without the dwell
     correction, and rnnrf_r94 stitch; every quality string has its
     sequence's length, every sequence equals the same call without
     qualities, and the two shortest reads' calls and qualities equal the
     port's CPU run (run in TWIN_WORKERS host processes meanwhile) within
     utils/seqcompare.quals_agree; prints each run's seconds with and
     without qualities, its stages and launches (rnnrf's forward-backward,
     stage "posterior_crf", must launch its kernels on the card once for
     each launch that parallel/runner.crf_groups gives the engine call's
     reads);
 21. trains rgrgr_r94, raw_r94, rnnrf_r94 and nanonet_events on the card
     (phase main_path_train): scrappie_torch.train.trainer.train(device=
     "cuda") for 8 steps of 8 simulated reads of 4 000 samples (the events
     model: 400 detected events) from a seeded random init, through the
     projection, GRU recurrence, LSTM pair (training mode) and partition
     kernels forward and the GRU's and LSTM's backward walks and the CRF
     forward-backward kernels backward; then make_lattice_train_step for 8
     steps each for rgrgr_r94 and rnnrf_r94 on seq_batch windows (8 x
     4 000 samples, 800 and 1 408 states), through the lattice kernels;
     then one make_wholeread_transducer_step (rgrgr_r94, and
     nanonet_events on the region's detected events), make_wholeread_step
     and make_head_step (rnnrf_r94) on a simulated region of 61 440
     samples (12 288 and 30 720 blocks, chunk 256);
     every loss finite and the last of each 8-step run below its first;
     seconds a step, launches by kernel, peak memory of the whole-read
     steps, and each run under the profiler (device busy time, idle
     share); after every timed run, the first step's loss and every
     gradient against the port's CPU run on the same batch (in host
     processes; the whole-read steps on the region's first 2 560 blocks);
 22. checks that a row decodes alike at B = 1 and 8 (phase
     batch_invariance: the rgrgr fused path and posterior), then serves
     on the card (phase main_path_serve): make_server(device=
     "cuda", batch 8, chunk 10 000 / overlap 1 000) on 127.0.0.1 in a
     daemon thread, and four concurrent connections send the 16 reads as
     whole-read requests (half with qualities), one read routed to
     rnnrf_r94 and one to nanonet_events, four live raw channels and one
     events channel in 4 000-sample feeds, flushed, and the stats op;
     every kernel of the serving path must launch in that run; each
     response must equal a direct BasecallEngine call on the card with its
     options, each channel a solo stream on the card fed the whole signal,
     and one channel the port's CPU stream; prints requests/s, the p50 and
     p95 request latency, live samples/s and the service's batches and
     engine calls;
 23. holds the four kernels with products to their twins under the
     precision policy's 'default' (TF32 operands on the card) and 'bf16'
     (bfloat16 operands), the twins rounding the same operands: the
     projection and the head (K = 1 and 3) at T = 2000, B = 64 within
     1e-3, the GRU recurrence (and its big-S mode at S = 160) and the
     LSTM recurrence (the events network's first stage, T = 2048, B = 64,
     both directions a launch; one layer; its big-S mode at S = 160)
     within 2e-3 on h, and times each in each mode beside 'highest'
     (phase precision_kernels); then runs the 16 reads through rgrgr_r94
     fast, rnnrf_r94 stitch, nanonet_events fast and the 3:1:1 ensemble
     fast in each mode and prints each mode's edit distance to
     'highest''s calls, a figure, and the shortest read's 'bf16' call on
     the card against the CPU's 'bf16' call (phase precision_paths);
     then trains in 'default' and 'bf16' (phase precision_train): the
     six training kernels that take the mode's rounding (the GRU walk
     and its big-S mode, the LSTM pair's walk and training forward and
     their big-S modes) against their twins in each mode, within four
     ulps of the mode at the output's largest magnitude, timed beside
     'highest'; one bf16 framewise step of rgrgr_r94, rnnrf_r94 and
     nanonet_events against the CPU's bf16 step on the same batch (loss
     within 1e-3, gradient norm within 2e-2); 8 steps of rgrgr_r94 and
     nanonet_events in each mode, the loss falling, seconds a step; a
     bf16 lattice window step and whole-read step, finite and not
     'highest''s;
 24. labels a simulated read of 80 790 samples (the bundled read
     ch174_read172's trimmed length) against its truth on the card
     (train/realdata.label_read: rgrgr_r94's posterior, then the seqmap
     kernel in both orientations), and a 20 000-sample one also on the
     CPU (the same orientation and base_at, the score within 1e-5
     relative); fits realsim.EmpiricalModel to them and takes rgrgr_r94
     framewise training steps on a RealReadSampler and a
     RealisticSimulator batch and a whole-read transducer step on the
     labelled region, every loss finite (phase realdata);
 25. runs the rgrgr_r94 fast engine over 8 reads, one poisoned with NaN,
     with SCRAPPIE_TORCH_VALIDATE's checks on: the poisoned read skipped,
     the others' calls those of the run without them; and a poisoned
     forward's checks on the card raised by validate.raise_pending
     (phase validate);
 26. calls scrappie_torch.embed (the C shim's module) on the card, equal
     to the api's calls (phase embed);
 27. runs the multi-device layer (parallel/sharding.py) on meshes whose
     devices repeat the one card, ["cuda:0"] * 2 (data 2) and * 4 (data 2
     x state 2) (phase multigpu): BasecallEngine(mesh=) for rgrgr_r94
     stitch and fast, raw_r94 fast, rnnrf_r94 fast, nanonet_events stitch
     and fast and the 3:1:1 ensemble stitch and fast on the 16 reads at
     the models' full width, each call's sequences equal to the one-card
     engine's and scores within MESH_SCORE_RTOL, each path's kernels
     launched by the mesh runs (their counts set to 0 before them) and
     their seconds beside the one-card call's (repeated devices share the
     SMs: information, no speed-up asked); StreamingBatcher(mesh=) and
     EventsStreamingBatcher(mesh=) on four channels, equal to solo
     streams; one training step of each of the four models on both
     meshes against the one-card step (trainer.value_and_grad_on_mesh
     against value_and_grad: loss and the gradient's global norm within
     MESH_TRAIN_RTOL); then the launcher (parallel/launcher.py) in worker
     processes on the card: one process basecalling the 16 reads, two
     processes each its round-robin half (a NCCL process group, no
     collective), whose merged calls must equal one process's; two
     processes training two steps over gloo on CUDA tensors and one
     process training two steps over NCCL at world size 1 (NCCL refuses
     two ranks on one card), each held to the in-process two-step run on
     the same global batch: both losses within MESH_TRAIN_RTOL and the
     weights within LAUNCHER_WEIGHT_ATOL (Adam's first update moves a
     weight by lr whatever its gradient; the second step's loss and
     weights read the all_reduce'd gradients).

Each engine path's launch counters are set to 0 just before its runs and
read just after; no inference path may launch a backward kernel, the
LSTM's training mode or a lattice kernel. Every phase's line carries the
seconds since the start; a line "total" gives the seconds of all phases.
The last lines are the kernel table (each kernel's time beside its bound,
the least time the card could take for the same work), the card's name
and power limit as nvidia-smi gives them, and {"ok": true, "device":
{...}}.

With --ab it does none of that: it times the Viterbi forward and
backtrace, the DTW, map_signal_to_squiggle, the CRF forward, partition
function, backtrace, posterior and partition gradient, the GRU
recurrence, its backward walk and whole backward, the rnnrf fused path, the seqmap DP,
map_post_to_sequence's four calls, the head (one model and 3:1:1 at
B = 8 and 64: alone, in bursts and the host's time a call, and the 3:1:1
call's peak device memory) and the fast engine (rgrgr_r94 and 3:1:1) of another
checkout of the repo (a `git archive`
of the parent commit, say; its kernels are built there) and of this one
on the same inputs, each in a fresh process, in turns other, this, this,
other (time_checkout, compare_checkouts), and prints a JSON line a turn
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 20261016
T_BLOCKS = 2000          # blocks in a 10 000-sample chunk at stride 5
T_CRF = 5000             # blocks in a 10 000-sample chunk at stride 2
CHUNK = 10000
GRU_ATOL = 1e-4
FUSED_RTOL = 1e-5
FUSED_MIN_SAME_ROWS = 0.99
PARTITION_RTOL = 1e-5    # expf/logf against torch's logsumexp, T up to 31 744
# The CRF forward-backward (posterior, the partition's gradient) against its
# twin: max-normalised scores, so each marginal is a softmax of values
# within the transitions' range; expf/logf against torch's, summed in
# another order. Absolute, probabilities (the gradient: times max |g|).
FWDBWD_ATOL = 1e-5
FWDBWD_BATCHES = (1, 2, 5, 64)
# The GRU recurrence's backward walk against its twin and against autograd
# through the plain forward: float32 sums in another order over T steps,
# relative to the largest |gradient| (seen 1.5e-7 on an H100).
GRU_BWD_RTOL = 1e-5
GRU_BWD_SMALL = ((300, 5, 40), (300, 5, 7))  # (T, B, S): tiles part past S
NEUTRAL = -1e30          # a stitch pad block's moves into the emitting states
# The CRF checks' shapes: rows that leave a warp's six-row groups part
# filled and rows over several blocks; T below and off the prefetch depths,
# a chunk and a stitch group of two ~62 000-sample reads at stride 2 (T
# rounded up to parallel/runner.DECODE_BUCKET = 1024).
CRF_BATCHES = (1, 2, 5, 7, 8, 33, 64, 256)
CRF_STITCH = (31744, 2)  # (T, B)
# The twins' checks: up to T_CRF (every layout is a matter of B, checked
# there); at CRF_STITCH the kernels are timed, and phase crf_assoc holds
# them to the parallel-in-time decode and posterior (decode/crf.py).
CRF_STEPS = (1, 7, T_CRF)
CRF_AB = ((T_CRF, 8), (T_CRF, 64), CRF_STITCH)  # the CRF shapes --ab times
# the batched posterior's reads (blocks), rows of the T_CRF sets cut short
CRF_BATCH_READS = (1, 7, 300, 2048, T_CRF - 1, T_CRF)
EMIT_BIAS = -1.0
T_EVENTS = 2048          # events in a chunk of the events engine
T_WHOLE_EVENTS = 11520   # the whole-read events step's detected events
LSTM_ATOL = 1e-4
HEAD_RTOL = 1e-6         # the head's lp against its twin: fp32 sums of the
HEAD_ATOL = 1e-5         # product, softmax and renormalisation in another order
HEAD_BATCHES = (8, 64, 256)  # phase head_kernel: one model at each B,
HEAD_ENS_BATCHES = (8, 64)   # K = 3 and 5 members at these
PROJECT_RTOL = 1e-5      # the projection against its twin, relative to max(|y|, 1)
BIG_S = {"gru": (160, 352), "lstm": (160, 288)}  # above the registers' S = 96
BIG_S_BWD = 160          # the big-S backward walks' check
# The LSTM's big-S walk (phase big_s_backward): its cluster mode at each
# (S, B), the first the kernels line's shape; its mode from L2 (S above
# ops/lstm.CLUSTER_MAX_S) at (S, B, T). The cluster walk's latency floor:
# its step's chain without the exchange (the DSMEM store and the cluster
# barrier, not timed alone): three dependent fp32 operations (12 cycles),
# the float4 load of da from shared memory (30), an accumulator's FMA
# chain (4 cycles each of rows / 2) and five shuffles with their adds
# (28 each).
LSTM_BIG_S_WALKS = ((160, 8), (160, 64), (288, 8), (288, 64))
LSTM_L2_WALK = (400, 8, 100)


def cluster_walk_floor_cycles(rows: int) -> int:
    return 12 + 30 + 4 * (rows // 2) + 5 * 28


S_SMALL = 16             # the LSTM routes' check at another size
T_BIG_S = 500            # steps of the big-S checks
NHIST_CASES = ((80, False), (1024, False), (2048, True))  # (nhist, use_slip)
FWD_BATCHES = (8, 64, 256)
NHIST_BATCHES = (8, 256)  # phase nhist's twin checks: the smallest and largest
STITCH_SHAPE = (12500, 4)  # (T, B): whole reads of a stitch bucket
BT_STEPS = (1, 7, T_BLOCKS + 1)  # more backtrace checks, at B = 8
BT_BATCHES = (1, 3, 8, 64, 256)  # the hand-built tracebacks' batches
T_BT_HAND = 501          # steps of the hand-built tracebacks
BT_AB = ((T_BLOCKS, 8), (T_BLOCKS, 64), STITCH_SHAPE)  # the backtrace --ab times
ROUTE_BATCHES = (8, 64, 256)
NREADS = 16
READ_LEN = (20000, 100000)
SQUIGGLE_MODELS = ("squiggle_r94", "squiggle_r94_rna", "squiggle_r10")
SQUIGGLE_BASES = 2000
SQUIGGLE_RTOL = 1e-5     # fp32 convolutions summed in another order
DTW_SHARED = (300, 3000)     # (positions, samples): scores in shared memory
DTW_GLOBAL_SAMPLES = 2000    # above the cluster's capacity: global memory
DTW_TIES = (2000, 20000)     # integer signal and locs: candidates tie
DTW_CLUSTERS = (4, 8, 16)    # cluster sizes timed at the main path's size
DTW_TWIN_WORKERS = 6         # host processes running the DTW's Viterbi twins
DTW_CARD_TWIN_WORKERS = 4    # processes running its forward twins on the card
MAP_BASES = 6000         # the mapping path's sequences, and the timed DTW's
MAP_SAMPLES = 60000      # the timed DTW's samples; the seqmap read's length
# The DTW's cluster sizes are held to the twins at MAP_BASES positions
# (the main path's layouts, a matter of the positions) and a quarter of
# its samples; the kernels are timed at MAP_SAMPLES.
DTW_CLUSTER_SAMPLES = MAP_SAMPLES // 4
MAP_BAND = 100           # half-width of the banded mapping
# The banded kernel's mode boundaries (ops/seqmap.banded_layout): the
# widest bands a lane's run of 1, 2, 4 and 8 offsets covers in the warp
# mode, each beside one offset wider (the block mode above 256); on
# narrow_bands the shift reaches the width, so each of the warp mode's K
# reads its window's far guard at both edges.
BANDED_BOUNDARY_WIDTHS = (32, 33, 64, 65, 128, 129, 256, 257)
# Latency floors of the redesigned walks, in cycles a block or a sample at
# the card's top SM clock (nvidia-smi clocks.max.sm), from the chains of
# their designs: the banded warp mode's a block (a shared-memory load of
# the previous window, the candidate's subtraction and add, two maxima,
# the mask's select and the store; the forward: two dependent logaddexps,
# each an ex2 and a lg2, in place of the maxima) and the DTW walk's a
# sample (a shared-memory load of the move byte and an add).
BANDED_FLOOR_CYCLES = {"viterbi": 80, "forward": 250}
WALK_FLOOR_CYCLES = 28
# The DTW walk's hand-made move planes (phase dtw_kernel): (samples,
# positions, the plane's offset in bytes from a 16-byte boundary). The
# second's rows are 12 004 bytes apart and start 3 bytes past one.
WALK_PLANES = ((MAP_SAMPLES, MAP_BASES, 0), (MAP_SAMPLES, MAP_BASES + 1, 3),
               (3000, 40, 5), (2000, 3, 7))
# The seqmap walk's hand-made move planes (phase seqmap_kernel,
# seqmap_walk_plane; tests/test_torch_mapping.py walks them on the CPU):
# (blocks, bases, how the walk ends). The seqmap walk's chain is the DTW
# walk's (a shared-memory byte load and a subtraction a block), so its
# floor is WALK_FLOOR_CYCLES a block.
SEQMAP_WALK_PLANES = ((12000, 1500, "entry_first"), (12000, 1500, "entry_last"),
                      (8000, 2000, "minus2"), (12000, 2500, "none"),
                      (700, 40, "entry_last"), (1, 5, "none"), (2, 5, "none"),
                      (2, 1, "minus2"))
FORWARD_RTOL = 1e-5      # forward finals: expf/log1pf against the host's
# map_signal_to_squiggle's defaults
DTW_OPTIONS = dict(local_pen=2.0, skip_pen=5000.0, minscore=5.0)
# the CLI's --stay/--skip/--local/--slip and a calibration's temperatures
VITERBI_OPTIONS = dict(stay_pen=0.3, skip_pen=1.1, local_pen=4.0, use_slip=True)
TEMPS = dict(tempW=1.2, tempb=0.9)
# the transducer ensemble the JAX package measured (rgrgr_r94 + rgrgr_r941 +
# rgrgr_r10 at 3:1:1, scrappie_tpu/parallel/runner.py:147-150)
ENSEMBLE = ("rgrgr_r941", "rgrgr_r10")
# five members, which the fused ensemble kernel (at most four) cannot take
ENSEMBLE5 = ("rgrgr_r941", "rgrgr_r10", "rgrgr_r941", "rgrgr_r10")
RUNS = (("fast", "nochange"), ("stitch", "nochange"), ("stitch", "mean"))

KERNELS = {
    "gru_layer": ("scrappie_torch/csrc/gru.cu", "scrappie_tpu/ops/gru.py:152"),
    "project": ("scrappie_torch/csrc/project.cu",
                "scrappie_tpu/ops/gru.py:152 and ops/lstm.py:53 (the "
                "projection in their bodies)"),
    "head": ("scrappie_torch/csrc/head.cu",
             "scrappie_tpu/ops/viterbi.py:385 and :531 (the head in their "
             "bodies)"),
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
    "lstm_pair": ("scrappie_torch/csrc/lstm.cu",
                  "scrappie_tpu/ops/lstm.py:53 (both layers of a "
                  "bidirectional stage in one launch)"),
    "seqmap": ("scrappie_torch/csrc/seqmap.cu", "scrappie_tpu/ops/seqmap.py:32"),
    "seqmap_walk": ("scrappie_torch/csrc/seqmap.cu",
                    "scrappie_tpu/decode/mapping.py:150 (the host walk of the "
                    "traceback; no TPU kernel)"),
    "seqmap_banded": ("scrappie_torch/csrc/seqmap.cu",
                      "scrappie_tpu/decode/mapping.py:170 (_map_banded, a "
                      "lax.scan; no TPU kernel)"),
    "dtw": ("scrappie_torch/csrc/dtw.cu", "scrappie_tpu/ops/dtw.py:59"),
    "dtw_walk": ("scrappie_torch/csrc/dtw.cu",
                 "scrappie_tpu/decode/dtw.py:179 (the host walk of the "
                 "traceback; no TPU kernel)"),
    "viterbi_fused_ens": ("scrappie_torch/csrc/viterbi.cu",
                          "scrappie_tpu/ops/viterbi.py:531"),
    "gru_recurrence": ("scrappie_torch/csrc/gru.cu", "scrappie_tpu/ops/gru.py:67"),
    "gru_recurrence_global": ("scrappie_torch/csrc/gru.cu",
                              "scrappie_tpu/ops/gru.py:67 (S above 96)"),
    "lstm_layer_global": ("scrappie_torch/csrc/lstm.cu",
                          "scrappie_tpu/ops/lstm.py:53 (S above 96)"),
    "gru_recurrence_bwd": ("scrappie_torch/csrc/gru.cu",
                           "scrappie_tpu/nn/rnn.py:40 (the VJP of gru's "
                           "lax.scan, which XLA differentiates; no TPU kernel)"),
    # crf_posterior and crf_partition_grad count forward-backward calls,
    # each of two kernels: crf_walk_kernel, then the marginal pass
    # (crf_state_marginals_kernel or crf_edge_marginals_kernel)
    "crf_posterior": ("scrappie_torch/csrc/crf.cu",
                      "scrappie_tpu/decode/crf.py:134 (_crf_posterior, a "
                      "lax.scan; no TPU kernel)"),
    "crf_partition_grad": ("scrappie_torch/csrc/crf.cu",
                           "scrappie_tpu/nn/layers.py:133 (the VJP of "
                           "crf_partition_function's lax.scan; no TPU kernel)"),
    "lstm_pair_train": ("scrappie_torch/csrc/lstm.cu",
                        "scrappie_tpu/ops/lstm.py:53 (the pair launch that "
                        "also stores the planes the walk reads, for "
                        "training)"),
    "lstm_recurrence_bwd": ("scrappie_torch/csrc/lstm.cu",
                            "scrappie_tpu/nn/rnn.py:80 (the VJP of lstm's "
                            "lax.scan, which XLA differentiates; no TPU "
                            "kernel)"),
    "gru_recurrence_bwd_global": ("scrappie_torch/csrc/gru.cu",
                                  "scrappie_tpu/nn/rnn.py:40 (the VJP of "
                                  "gru's lax.scan, S above 96; no TPU kernel)"),
    "lstm_pair_train_global": ("scrappie_torch/csrc/lstm.cu",
                               "scrappie_tpu/ops/lstm.py:53 (the pair launch "
                               "that also stores the planes, S above 96)"),
    "lstm_recurrence_bwd_cluster": ("scrappie_torch/csrc/lstm.cu",
                                    "scrappie_tpu/nn/rnn.py:80 (the VJP of "
                                    "lstm's lax.scan, 96 < S <= 384 on a "
                                    "cluster of CTAs; no TPU kernel)"),
    "lstm_recurrence_bwd_global": ("scrappie_torch/csrc/lstm.cu",
                                   "scrappie_tpu/nn/rnn.py:80 (the VJP of "
                                   "lstm's lax.scan, S above 384, sW from "
                                   "L2; no TPU kernel)"),
    # lattice_fwdbwd and crf_lattice_fwdbwd count launches of one kernel
    # each, its forward mode and its backward mode
    "lattice_fwdbwd": ("scrappie_torch/csrc/lattice.cu",
                       "scrappie_tpu/train/lattice.py:49 (_lattice_forward_"
                       "impl, a lax.scan, and its VJP; no TPU kernel)"),
    "crf_lattice_fwdbwd": ("scrappie_torch/csrc/lattice.cu",
                           "scrappie_tpu/train/lattice.py:125 and :210 (the "
                           "CRF lattice's and local partition's lax.scans "
                           "and their VJPs; no TPU kernel)"),
}
# The kernels each path must launch, by engine mode.
GRU_KERNELS = ("project", "gru_recurrence")
TRANSDUCER_KERNELS = {
    "fast": GRU_KERNELS + ("head", "viterbi_fwd", "viterbi_backtrace"),
    "stitch": GRU_KERNELS + ("viterbi_fwd", "viterbi_backtrace")}
ENSEMBLE_KERNELS = TRANSDUCER_KERNELS
RNNRF_KERNELS = {mode: GRU_KERNELS + ("crf_fwd", "crf_backtrace", "crf_partition")
                 for mode in ("fast", "stitch")}
EVENTS_KERNELS = {
    "fast": ("project", "lstm_pair", "head", "viterbi_fwd", "viterbi_backtrace"),
    "stitch": ("project", "lstm_pair", "viterbi_fwd", "viterbi_backtrace")}
# map_post_to_sequence's calls on the mapping path, Viterbi with a path first
MAP_CALLS = (("viterbi, path", dict(viterbi=True, path=True)),
             ("forward", {}),
             (f"banded {MAP_BAND}, viterbi", dict(viterbi=True, bands=MAP_BAND)),
             (f"banded {MAP_BAND}, forward", dict(bands=MAP_BAND)))
MAPPING_KERNELS = ("dtw", "dtw_walk", "seqmap", "seqmap_walk", "seqmap_banded")
# Training (phase main_path_train): each model from a seeded random init
# (0.1 standard normal, as tests/test_models.py:124-129), the first step's
# loss and gradients against the port's CPU run on the same batch: loss
# relative 1e-5; each gradient relative to its largest entry 1e-4, the
# limit the CPU tests hold the port's gradients to against JAX (the
# kernels' float32 forward and backward against the twins' over up to
# 2 000 steps and five layers; seen at most 2.5e-6, raw_r94's conv_W).
# nanonet_events trains on TRAIN["nsample"] // 10 detected events a row.
TRAIN_MODELS = ("rgrgr_r94", "raw_r94", "rnnrf_r94", "nanonet_events")
TRAIN = dict(steps=8, batch=8, nsample=4000, lr=2e-3)
TRAIN_PROFILE_STEPS = 2
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_KERNELS = {kind: GRU_KERNELS + ("gru_recurrence_bwd",) + crf
                 for kind, crf in (("rgrgr", ()), ("raw", ()),
                                   ("rnnrf", ("crf_partition",
                                              "crf_partition_grad")))}
TRAIN_KERNELS["events"] = ("project", "lstm_pair_train", "lstm_recurrence_bwd")
# The lattice runs (make_lattice_train_step on seq_batch windows of
# TRAIN["nsample"] samples and L kmer states, as scripts/train_wholeread_
# {transducer,crf}.py size them) and the whole-read steps (one simulated
# region of WHOLE_SAMPLES samples, chunk WHOLE_CHUNK; held to the CPU on
# its first WHOLE_CPU_BLOCKS blocks). Their gradients are held to the CPU
# at LATTICE_GRAD_RTOL, the limit tests/test_torch_lattice.py holds the
# lattice losses' to JAX: the lattice's posteriors feed five GRU layers,
# and rnnrf's is the difference of logZ_local's and log P's, which largely
# cancel (float32 against float64 on the CPU: up to 2.3e-4).
LATTICE_RUNS = (("rgrgr_r94", 4000 // 5),
                ("rnnrf_r94", 4000 // 2 * 3 // 4 // 128 * 128))
LATTICE_KERNELS = {
    "rgrgr": GRU_KERNELS + ("gru_recurrence_bwd", "lattice_fwdbwd"),
    "rnnrf": GRU_KERNELS + ("gru_recurrence_bwd", "crf_partition",
                            "crf_partition_grad", "crf_lattice_fwdbwd")}
LATTICE_GRAD_RTOL = 5e-4
WHOLE_SAMPLES = 61440
WHOLE_CHUNK = 256
WHOLE_CPU_BLOCKS = 2560
# Launched by training alone: no inference path may launch them.
BACKWARD_KERNELS = ("gru_recurrence_bwd", "crf_partition_grad",
                    "lstm_pair_train",
                    "lstm_recurrence_bwd", "lattice_fwdbwd",
                    "crf_lattice_fwdbwd")
# The LSTM's backward (phase lstm_backward_kernel): the walk against its
# twin and the whole backward against autograd, relative to the largest
# entry (float32 sums in another order over 2 048 steps, as GRU_BWD_RTOL),
# also at LSTM_BWD_SMALL's sizes.
LSTM_BWD_RTOL = 1e-5
LSTM_BWD_SMALL = ((300, 5, 40), (300, 5, 7))  # (T, B, S): tiles part past S
# The lattice kernels (phase lattice_kernels) against their twins: log P
# and logZ relative 1e-5; the gradient relative to its largest entry 5e-5
# (expf and log1pf against torch's, and the posteriors summed into states
# and classes in another order, over up to 30 720 steps). The windows (B,
# samples, L), and the whole-read shape, checkpointed every WHOLE_CHUNK
# steps as the whole-read steps run it.
LATTICE_RTOL = 1e-5
LATTICE_GRAD_TWIN_RTOL = 5e-5
# At the whole-read shape also against the twins in float64: log P and
# logZ at LATTICE_RTOL, the gradient relative to its largest entry at
# LATTICE_F64_GRAD_RTOL (float32's rounding over 30 720 steps, which each
# step's normalisation to a posterior sum of 1 leaves only where the
# states' scores drift apart; seen at most 3.2e-3).
LATTICE_F64_GRAD_RTOL = 1e-2
LATTICE_WINDOWS = {"transducer": (8, 4000, 4000 // 5), "crf": (8, 4000, 1408)}
WHOLE_READ_SHAPE = (30720, 7000)  # (blocks, bases), B = 1
# The whole-read twins (float32 and float64) run on the read's first
# WHOLE_TWIN_BLOCKS blocks against all its bases: the kernels' layout is a
# matter of the bases (16 CTAs a row), each of the twins' steps a round of
# launches, and 7 680 blocks still take a path across 7 000 bases.
WHOLE_TWIN_BLOCKS = 7680
# Above 16 CTAs x 512 threads x 8 positions a thread walks more than one
# run of positions a step (ops/lattice.cluster_layout's groups). Held to
# the twins at the windows with the layout's limits forced down
# (LATTICE_SMALL_RUNS: MAX_CLUSTER, MAX_THREADS), so that a thread walks
# two or three runs; and at 70 000 bases (LATTICE_LONG: blocks, bases; a
# path must cross every base, one a block for the CRF, two for the
# transducer), kernels only: finite, and a checkpoint every WHOLE_CHUNK
# steps bit for bit every LATTICE_LONG_CHUNK's (chunk = T would keep
# 11 GB and 39 GB of rows).
LATTICE_SMALL_RUNS = (2, 32)
LATTICE_LONG = {"transducer": (40000, 70000), "crf": (72000, 70000)}
LATTICE_LONG_CHUNK = 1024
WINDOW_CHUNK = 96        # the windows' checkpoint check: 800 and 2 000 steps
# A plain twin's time is one run, without a warm-up: a launch-bound loop
# over T whose figure sits beside the kernel's, timed by no gate.
TWIN_REPS = dict(reps=1, warmup=0)
# Kept, checked and timed; no path launches them.
SUPERSEDED = ("gru_layer", "viterbi_fused", "viterbi_fused_ens")
# Kernels whose design keeps their weights in registers: ptxas must report
# no spill for any of their instances.
NO_SPILL = ("gru_recurrence_kernel", "lstm_recurrence_kernel",
            "gru_recurrence_bwd_kernel", "lstm_recurrence_bwd_kernel",
            "lstm_walk_cluster_kernel")
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# fp32 outside the tensor cores (the kernels are exact fp32, TF32 off).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# and the dense tensor-core peaks of the head's product in 'default' (TF32)
# and 'bf16' (kernel_work("head", mode=...))
PEAK_TC_OPS_PER_S = {"default": 495e12, "bf16": 989e12}


START = time.perf_counter()
SPILLS: dict[str, int] = {}  # ptxas's spill bytes of the NO_SPILL kernels


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi(query: str, fmt: str = "csv,noheader") -> str:
    """nvidia-smi's answer to --query-gpu=query for card 0."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 20, warmup: int = 2, burst: int = 1) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events). A
    single call's interval includes the host time before its launch, where
    the card waits for it; with burst > 1 each interval holds that many
    calls back to back and the time is per call, the device's own where the
    host keeps ahead of it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def build() -> None:
    from scrappie_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = path.with_suffix(".log")
    require(log.exists(), f"nvcc's report {log.name} beside the library")
    report = [ln for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print("\n".join(report), file=sys.stderr)
    spills, entry = {}, None
    for ln in report:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln and entry and any(k in entry for k in NO_SPILL):
            spills[entry] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", ln))
    for k in NO_SPILL:
        require(any(k in e for e in spills), f"ptxas reports {k}")
    require(not any(spills.values()), f"no spill in {NO_SPILL}: {spills}")
    SPILLS.update(spills)
    emit({"phase": "build", "seconds": round(seconds, 3), "library": path.name,
          "spill_bytes": spills})


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take for work that moves nbytes (each
    input read once, each output written once) and does nops fp32
    operations (a multiply-add counts 2): the larger of the two times at
    the published peaks, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def floor_ms(steps: int, cycles: float) -> float:
    """A latency floor: steps dependent steps of `cycles` each at the
    card's top SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    return steps * cycles / (mhz * 1e3)


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
    mapping DPs (one read, Viterbi) write their whole traceback at a byte a
    state (the winning candidate: the seqmap's four moves; the DTW's six
    for a forward state and two for a back state, which is all a walk
    needs, and its end jump's source a sample); each walk reads a byte a
    step and writes the path. The banded DP reads the emissions of its
    window's positions, the stay and entry emissions and the band's bounds
    a block. Per step and position the DTW does
    23 operations (its forward state 6 adds and 5 compares with the end
    jump's max, the end-jump candidate's add, the emission's 6 and its 2
    adds, the back state's 2 adds and compare) and the seqmap and banded
    DPs 7 (3 adds, 2 subtractions, 2 compares or maxima). The lattices'
    forward-backward (both modes together) reads each row's emissions once
    a step (the transducer: its distinct valid kmer states and the stay; the
    CRF: the transition row) and writes the gradient once; per valid
    position and step the transducer does 27 operations (forward two
    logaddexps of 6 and 4 adds and subtractions; backward three exps,
    two logaddexps and their adds) and the CRF 36 (its two states), and
    the CRF's local partition 200 a row and step. The head's bound is for a
    precision mode (d["mode"], "bound_mode" in the result): 'highest' (the
    default) counts every operation at the fp32 peak; 'default' and 'bf16'
    its product at the dense TF32 or bf16 tensor-core peak and its 4
    operations an entry (K > 1: 4 more) at the fp32 peak."""
    T, B = d["T"], d.get("B", 1)
    if name == "dtw":
        npos = d["npos"]
        nstate = 2 * npos + 2
        return bound(4 * (T + 3 * npos + 4 * (npos + 2) + nstate + T)
                     + T * nstate, 23 * T * npos)
    if name == "dtw_walk":  # a move byte a sample, the path, two finals
        return bound(T + 4 * T + 8, T)
    if name == "seqmap":  # a move byte a state (int32=True: an int32 traceback)
        nst, seqlen = d["nst"], d["seqlen"]
        per_state = 4 if d.get("int32") else 1
        return bound(4 * (T * nst + seqlen + seqlen + 2)
                     + per_state * T * (seqlen + 2), 7 * T * seqlen)
    if name == "seqmap_walk":  # a move byte a block, the path, two finals
        return bound(T + 4 * T + 8, T)
    if name == "seqmap_banded":  # the band's emissions, stay and entry a block
        width = d["width"]
        return bound(4 * (T * (width + 2) + 2 * T + width + width + 1),
                     7 * T * width)
    if name == "project":  # x [T, B, C] @ W [C, N] + b
        C, N = d["C"], d["N"]
        return bound(4 * (T * B * C + C * N + N + T * B * N), 2 * T * B * C * N)
    if name == "head":  # K heads' product and softmax; K > 1: renormalise
        K, S, ns = d.get("K", 1), d["S"], d["nstate"]
        M = T * B
        nbytes = 4 * (K * M * S + K * (S + 1) * ns + K + M * ns)
        product = K * 2 * M * S * ns
        rest = K * 4 * M * ns + (4 * M * ns if K > 1 else 0)
        mode = d.get("mode", "highest")
        if mode == "highest":  # every operation at the fp32 peak
            return {**bound(nbytes, product + rest), "bound_mode": mode}
        # the product on the tensor cores, the softmax's work in fp32
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = (product / PEAK_TC_OPS_PER_S[mode] + rest / PEAK_FP32_OPS_PER_S) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_mode": mode}
    if name == "gru_layer":
        C, S = d["C"], d["S"]
        return bound(4 * (T * B * (C + S) + 3 * S * (C + 1) + 3 * S * S),
                     2 * T * B * 3 * S * (C + S))
    if name == "lstm_layer":
        C, S = d["C"], d["S"]
        return bound(4 * (T * B * (C + S) + 4 * S * (C + 1) + 4 * S * S + 3 * S),
                     2 * T * B * 4 * S * (C + S))
    if name == "lstm_recurrence":  # xproj [T, B, 4S], h @ sW; dirs layers
        S, n = d["S"], d.get("dirs", 1)
        return bound(n * 4 * (T * B * 4 * S + 4 * S * S + 3 * S + T * B * S),
                     n * 2 * T * B * 4 * S * S)
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
    if name == "viterbi_fused_ens":  # K heads, the renormalisation, the DP
        K, S, ns = d["K"], d["S"], d["nstate"]
        return bound(4 * (K * T * B * S + K * (S + 1) * ns + K + B * (ns + 1))
                     + 2 * T * B * (ns + 1),
                     K * (2 * T * B * S * ns + 4 * T * B * ns)
                     + 4 * T * B * ns + viterbi_ops(T, B, ns - 1))
    if name == "gru_recurrence":  # x [T, B, 3S] projected, h @ sW and rh @ sW2
        S = d["S"]
        return bound(4 * (T * B * 3 * S + 3 * S * S + T * B * S),
                     2 * T * B * 3 * S * S)
    if name == "viterbi_backtrace":
        return bound(4 * B * d["nst2"] + 2 * T * B + 4 * B * (T + 1), T * B)
    if name == "crf_fwd":
        return bound(4 * T * B * 25 + T * B * 5 + 4 * B * 5, 2 * T * B * 25)
    if name == "crf_backtrace":
        return bound(4 * B * 5 + T * B + 4 * B * (T + 1), T * B)
    if name == "crf_partition":  # add, max, subtract, exp, sum; 5 logs
        return bound(4 * T * B * 25 + 4 * B, 5 * T * B * 25 + 5 * T * B)
    if name == "crf_posterior":  # two walks as the partition's, a softmax
        return bound(4 * T * B * 25 + 4 * B * (T + 1) * 5,  # add, sub, exp,
                     2 * (5 * T * B * 25 + 5 * T * B)      # sum, div a state
                     + 5 * B * (T + 1) * 5)
    if name == "crf_partition_grad":  # two walks; 2 adds, max, sub, exp,
        return bound(4 * T * B * 25 * 2 + 4 * B,  # sum, mul an edge
                     2 * (5 * T * B * 25 + 5 * T * B) + 7 * T * B * 25)
    if name == "gru_recurrence_bwd":  # gates, h_prev, gh in; da out; 3S^2 MACs
        S = d["S"]
        return bound(4 * (T * B * 5 * S + 3 * S * S + T * B * 3 * S),
                     2 * T * B * 3 * S * S)
    if name == "lstm_recurrence_bwd":  # 6 planes, gh in; da, dpeep out
        S, n = d["S"], d.get("dirs", 1)
        return bound(n * 4 * (T * B * 11 * S + 4 * S * S + 3 * S + B * 3 * S),
                     n * 2 * T * B * 4 * S * S)
    if name == "lstm_pair_train":  # the pair's recurrence, h and 6 planes out
        S, n = d["S"], d.get("dirs", 2)
        return bound(n * 4 * (T * B * 11 * S + 4 * S * S + 3 * S),
                     n * 2 * T * B * 4 * S * S)
    if name == "lattice_fwdbwd":  # both modes; see the docstring
        S, L, nd, nv = d["S"], d["L"], d["distinct"], d["valid"]
        return bound(4 * (T * (nd + B) + B * L + T * B * S), 27 * T * nv)
    if name == "crf_lattice_fwdbwd":  # both modes and both lattices
        L, nv = d["L"], d["valid"]
        return bound(4 * (2 * T * B * 25 + B * L),
                     36 * T * (nv + B) + 200 * T * B)
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

    # GRU: one backward (B1) and one forward (F2) layer, through the path's
    # route (projection + recurrence) and the superseded layer kernel.
    err = {"route": 0.0, "gru_layer": 0.0}
    for pre, reverse in (("gruB1", True), ("gruF2", False)):
        w = [p[f"{pre}_{k}"] for k in ("iW", "b", "sW", "sW2")]
        hk = g.gru_layer_tm(x, *w, reverse=reverse)
        ho = g.gru_layer_fused_cuda(x, *w, reverse=reverse)
        hp = g.gru_layer_tm_plain(x, *w, reverse=reverse)
        sync()
        for name, got in (("route", hk), ("gru_layer", ho)):
            require(bool(torch.isfinite(got).all()), f"{pre} {name} output finite")
            err[name] = max(err[name], float((got - hp).abs().max()))
    for name, e in err.items():
        require(e <= GRU_ATOL, f"gru {name} max abs err {e} <= {GRU_ATOL}")
    w = [p[f"gruB1_{k}"] for k in ("iW", "b", "sW", "sW2")]
    out["gru_layer"] = {
        **kernel_work("gru_layer", T=T_BLOCKS, B=B, C=96, S=96),
        "max_abs_err": err["gru_layer"],
        "ms": cuda_ms(lambda: g.gru_layer_fused_cuda(x, *w, reverse=True)),
        "route_ms": cuda_ms(lambda: g.gru_layer_tm(x, *w, reverse=True)),
        "route_max_abs_err": err["route"],
        "plain_ms": cuda_ms(lambda: g.gru_layer_tm_plain(x, *w, reverse=True),
                            **TWIN_REPS)}
    out["project"] = check_projection(x, w[0], w[1])

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
    out["head"] = check_head(h, p["FF_W"], p["FF_b"], "main path")
    out["head"]["route"] = check_fused(h, p["FF_W"], p["FF_b"], "main path",
                                       route=True)
    out["viterbi_fwd"]["ms"] = cuda_ms(lambda: v.viterbi_scores_tm(lp))
    out["viterbi_fwd"]["plain_ms"] = cuda_ms(lambda: v.viterbi_scores_tm_plain(lp),
                                             **TWIN_REPS)
    out["viterbi_backtrace"]["ms"] = cuda_ms(lambda: v.viterbi_backtrace_tm(fk, tbk))
    out["viterbi_backtrace"]["us_per_step"] = (out["viterbi_backtrace"]["ms"] * 1e3
                                               / T_BLOCKS)
    out["viterbi_backtrace"]["segments"] = v.backtrace_segments(
        T_BLOCKS, B, nstate + 1, torch.cuda.get_device_properties(0).multi_processor_count)
    # the ring's own floor: the whole traceback read once
    out["viterbi_backtrace"]["stream_floor_ms"] = (tbk.numel() * 2 / PEAK_BYTES_PER_S
                                                   * 1e3)
    out["viterbi_backtrace"]["plain_ms"] = cuda_ms(
        lambda: v.viterbi_backtrace_tm_plain(fk, tbk), **TWIN_REPS)
    out["viterbi_fused"]["ms"] = cuda_ms(
        lambda: v.viterbi_fused_tm(h, p["FF_W"], p["FF_b"]))
    out["viterbi_fused"]["plain_ms"] = cuda_ms(
        lambda: v.viterbi_fused_tm_plain(h, p["FF_W"], p["FF_b"]), **TWIN_REPS)
    out["head"]["route_ms"] = cuda_ms(lambda: head_route(h, p["FF_W"], p["FF_b"]))
    emit({"phase": "kernels", "B": B, "T": T_BLOCKS, "kernels": out})
    return out


def check_decode_kernels(net, B: int) -> None:
    """The Viterbi forward and backtrace against their twins on the main
    path's posterior of B chunks (at B <= 16 the backtrace splits each
    row's walk into segments, a mode of its own), the features through the
    GRU kernels: the B = 8 half of check_kernels, whose other kernels take
    the same code path at every B and are held to their twins at B = 64."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import conv1d, robustlog, softmax_with_temperature
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops.pipeline import CONV_ACT

    rng = np.random.default_rng(SEED + B)
    p = net.params
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device=net.device)
    h = CONV_ACT[net.conv_activation](
        conv1d(sig, p["conv_W"], p["conv_b"], net.stride)).transpose(0, 1).contiguous()
    for pre, reverse in (("gruB1", True), ("gruF2", False)):
        h = g.gru_layer_tm(h, *(p[f"{pre}_{k}"] for k in ("iW", "b", "sW", "sW2")),
                           reverse=reverse)
    lp = robustlog(softmax_with_temperature(h, p["FF_W"], p["FF_b"]), 1e-5).contiguous()
    _, _, errs = check_forward_and_backtrace(lp, f"main path, B = {B}")
    emit({"phase": "kernels", "B": B, "T": T_BLOCKS,
          "checked": ["viterbi_fwd", "viterbi_backtrace"], "max_abs_err": errs})


def check_projection(x, W, b) -> dict:
    """The projection kernel against its twin (nn/layers.feedforward) within
    PROJECT_RTOL, and its time beside the twin's and torch.addmm's on the
    same product (TF32 off), which the port never calls; the kernel's and
    addmm's also over bursts of 10 calls."""
    import torch

    from scrappie_torch.nn.layers import feedforward
    from scrappie_torch.ops.project import project_tm

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 off for matmul")
    T, B, C = x.shape
    yk = project_tm(x, W, b)
    yp = feedforward(x, W, b)
    sync()
    rel = float(((yk - yp).abs() / yp.abs().clamp(min=1.0)).max())
    require(rel <= PROJECT_RTOL, f"project rel err {rel} <= {PROJECT_RTOL}")
    x2 = x.view(T * B, C)
    return {**kernel_work("project", T=T, B=B, C=C, N=W.shape[1]),
            "max_abs_err": float((yk - yp).abs().max()), "max_rel_err": rel,
            "ms": cuda_ms(lambda: project_tm(x, W, b)),
            "plain_ms": cuda_ms(lambda: feedforward(x, W, b)),
            "library_ms": cuda_ms(lambda: torch.addmm(b, x2, W)),
            "burst_ms": cuda_ms(lambda: project_tm(x, W, b), reps=5, burst=10),
            "library_burst_ms": cuda_ms(lambda: torch.addmm(b, x2, W), reps=5,
                                        burst=10)}


def head_route(h, W, b, weights=None, **opts):
    """The fast paths' decode up to the traceback: the head kernel (K
    members with weights), then the Viterbi forward kernel -> (final, tb)."""
    from scrappie_torch.ops import viterbi as v
    from scrappie_torch.ops.pipeline import HEAD_OPTIONS

    head = {k: opts.pop(k) for k in HEAD_OPTIONS if k in opts}
    return v.viterbi_scores_tm(v.head_logpost_tm(h, W, b, weights, **head), **opts)


def check_head(h, W, b, what: str, weights=None, **temps) -> dict:
    """The head kernel's log posterior (K members with weights) against
    its twin within HEAD_RTOL / HEAD_ATOL; then the kernel's and the
    twin's times."""
    import torch

    from scrappie_torch.ops import viterbi as v

    lk = v.head_logpost_tm(h, W, b, weights, **temps)
    lpl = v.head_logpost_tm_plain(h, W, b, weights, **temps)
    sync()
    require(bool(torch.isfinite(lk).all()), f"head lp finite ({what})")
    excess = float(((lk - lpl).abs() - HEAD_ATOL - HEAD_RTOL * lpl.abs()).max())
    require(excess <= 0.0, f"head lp within rtol {HEAD_RTOL}, atol {HEAD_ATOL} "
                           f"({what}; excess {excess})")
    K = 1 if weights is None else h.shape[0]
    T, B, S = h.shape[-3:]
    return {"K": K, **kernel_work("head", T=T, B=B, K=K, S=S, nstate=W.shape[-1]),
            "max_abs_err": float((lk - lpl).abs().max()),
            "max_rel_err": float(((lk - lpl).abs() / lpl.abs().clamp(min=1e-6)).max()),
            "ms": cuda_ms(lambda: v.head_logpost_tm(h, W, b, weights, **temps)),
            "plain_ms": cuda_ms(lambda: v.head_logpost_tm_plain(h, W, b, weights,
                                                                **temps))}


def product_library_ms(h, W, b, weights=None) -> float:
    """torch.addmm of the head's product alone (TF32 off), K calls for K
    members: the product's time, not the head's (no one PyTorch call
    computes the head's softmax, robustlog and combination)."""
    import torch

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 off for matmul")
    if weights is None:
        h, W, b = h[None], W[None], b[None]
    S = h.shape[-1]
    rows = [h[k].reshape(-1, S) for k in range(h.shape[0])]
    return cuda_ms(lambda: [torch.addmm(b[k], x, W[k]) for k, x in enumerate(rows)])


def check_head_kernel(nets: list, card: str) -> dict:
    """The head kernel against its twin within HEAD_RTOL / HEAD_ATOL
    ('highest') on the features the three rgrgr models give for B chunks
    of CHUNK samples: one model (rgrgr_r94) at each of HEAD_BATCHES, 3:1:1
    (K = 3) and 3:1:1:1:1 (K = 5, the trio's two repeated) at B = 8 and 64,
    each with and without TEMPS (check_head); beside each shape without
    temperatures the launch plan, the bound in each precision mode and
    product_library_ms; and the device's peak memory above what it held
    for one K = 3, B = 64 call, which must not exceed the posterior's
    (phase head_kernel). Returns {"K = k, B = b": row}."""
    import numpy as np
    import torch

    from scrappie_torch.ops import viterbi as v
    from scrappie_torch.ops.pipeline import ensemble_features_tm

    pick = [0, 1, 2, 1, 2]  # ENSEMBLE5's members: the trio's, repeated
    rows = {}
    for B in HEAD_BATCHES:
        members = nets if B in HEAD_ENS_BATCHES else nets[:1]
        sig = torch.as_tensor(np.random.default_rng(SEED + 400 + B).standard_normal(
            (B, CHUNK, 1)).astype(np.float32), device="cuda")
        h, W, b = ensemble_features_tm(
            [n.params for n in members], sig, kinds=("rgrgr",) * len(members),
            conv_activations=[n.conv_activation for n in members], stride=5)
        cases = {1: (h[0], W[0], b[0], None)}
        if B in HEAD_ENS_BATCHES:
            cases[3] = (h, W, b, ensemble_weights(3))
            cases[5] = (h[pick], W[pick], b[pick], ensemble_weights(5))
        for K, (hk, Wk, bk, wk) in cases.items():
            what = f"K = {K}, B = {B}"
            row = check_head(hk, Wk, bk, what, wk)
            tempered = check_head(hk, Wk, bk, f"{what}, temperatures", wk, **TEMPS)
            row["max_abs_err"] = max(row["max_abs_err"], tempered["max_abs_err"])
            row["temps_ms"] = tempered["ms"]
            row["bounds"] = {mode: kernel_work("head", T=T_BLOCKS, B=B, K=K, S=96,
                                               nstate=Wk.shape[-1], mode=mode)
                             for mode in PRECISION_ROUNDING}
            row["product_library_ms"] = product_library_ms(hk, Wk, bk, wk)
            row["launch"] = v.head_launch(
                T_BLOCKS * B, 96, Wk.shape[-1],
                v.head_max_clusters(0, Wk.shape[-1], 96, wk is not None, 0))
            if (K, B) == (3, 64):
                sync()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                lp = v.head_logpost_tm(hk, Wk, bk, wk)
                sync()
                row["peak_bytes_above"] = torch.cuda.max_memory_allocated() - base
                row["posterior_bytes"] = lp.numel() * 4
                require(row["peak_bytes_above"] <= row["posterior_bytes"] + 2 ** 21,
                        f"head K = 3, B = 64 allocates only its posterior "
                        f"({row['peak_bytes_above']} B)")
                del lp
            rows[what] = row
        del h, W, b, cases
    emit({"phase": "head_kernel", "T": T_BLOCKS, "rows": rows, "card": card})
    return rows


# Phase head_widths: hidden sizes the resident mode cannot take (S not a
# multiple of 4, or above 208: the big-S GRU's and LSTM's), and h not
# 16-byte aligned, all in the head kernel's streamed mode.
HEAD_WIDTHS = ((18, 1, True), (18, 3, True), (BIG_S["lstm"][1], 1, True),
               (BIG_S["gru"][1], 1, True), (BIG_S["gru"][1], 3, True),
               (96, 1, False))


def check_head_widths(card: str) -> None:
    """The head kernel's streamed mode against its twin on seeded inputs
    (tanh of 2 x standard normal; W 2 / sqrt(S) x standard normal, bias
    0.1 x, placed outside inference mode; T_BIG_S blocks, B = 8, 1025
    states), at each of HEAD_WIDTHS (S,
    K, h aligned): within HEAD_RTOL / HEAD_ATOL in 'highest', with and
    without TEMPS (check_head), and at the widest S and K = 1 and 3 in
    'default' and 'bf16' within HEAD_TC_ATOL of the rounded twin (phase
    head_widths)."""
    import torch

    from scrappie_torch.ops import viterbi as v

    gen = torch.Generator(device="cuda").manual_seed(SEED + 410)
    T, B, nstate = T_BIG_S, 8, 1025
    rows = {}
    for S, K, aligned in HEAD_WIDTHS:
        rnd = lambda *shape, s: s * torch.randn(shape, generator=gen, device="cuda")
        with torch.inference_mode(False):  # placed as the port's loaders place weights
            W, b = rnd(K, S, nstate, s=2.0 / S ** 0.5), rnd(K, nstate, s=0.1)
        h = torch.tanh(rnd(K, T, B, S, s=2.0))
        if not aligned:  # the same rows one float past a 16-byte boundary
            buf = torch.empty(h.numel() + 4, device="cuda")
            h = buf[1:1 + h.numel()].view(h.shape).copy_(h)
        wk = ensemble_weights(K) if K > 1 else None
        args = (h, W, b, wk) if K > 1 else (h[0], W[0], b[0], None)
        require(v.head_streams(S, args[0].data_ptr() % 16 == 0),
                f"head S = {S}{'' if aligned else ', h unaligned'} runs streamed")
        what = f"S = {S}, K = {K}" + ("" if aligned else ", h unaligned")
        row = check_head(*args[:3], what, args[3])
        tempered = check_head(*args[:3], f"{what}, temperatures", args[3], **TEMPS)
        row["max_abs_err"] = max(row["max_abs_err"], tempered["max_abs_err"])
        if S == BIG_S["gru"][1]:
            row.update(precision_case(
                f"head {what}", lambda: v.head_logpost_tm(*args),
                lambda r: v.head_logpost_tm_plain(*args, rounding=r), HEAD_TC_ATOL))
        rows[what] = row
    emit({"phase": "head_widths", "T": T, "B": B, "rows": rows, "card": card})


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


def check_fused(h, W, b, what: str, weights=None, route: bool = False,
                **opts) -> dict:
    """Fused head + forward against head-then-forward (with weights, the
    fused ensemble against its twin, h [K, T, B, S]): final within
    FUSED_RTOL, paths identical in FUSED_MIN_SAME_ROWS of the rows. With
    route, the paths' route (head kernel, then forward kernel) in place of
    the fused kernel, held to the same twin."""
    from scrappie_torch.ops import viterbi as v

    B = h.shape[-2]
    if weights is None:
        name = "head route" if route else "viterbi_fused"
        run = head_route if route else v.viterbi_fused_tm
        ffk, ftbk = run(h, W, b, **opts)
        ffp, ftbp = v.viterbi_fused_tm_plain(h, W, b, **opts)
    else:
        name = "head route (K members)" if route else "viterbi_fused_ens"
        run = head_route if route else v.viterbi_fused_ens_tm
        ffk, ftbk = run(h, W, b, weights, **opts)
        ffp, ftbp = v.viterbi_fused_ens_tm_plain(h, W, b, weights, **opts)
    sync()
    rel = float(((ffk - ffp).abs() / ffp.abs().clamp(min=1.0)).max())
    require(rel <= FUSED_RTOL,
            f"{name} final rel err {rel} <= {FUSED_RTOL} ({what})")
    fsk, fpk = v.viterbi_backtrace_tm(ffk, ftbk)
    fsp, fpp = v.viterbi_backtrace_tm_plain(ffp, ftbp)
    differ = (fpk != fpp).any(dim=1)
    ndiff = int(differ.sum())
    gap = float((fsk - fsp).abs()[differ].min()) if ndiff else None
    require(B - ndiff >= FUSED_MIN_SAME_ROWS * B,
            f"{name} paths identical in {B - ndiff}/{B} rows ({what})")
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
    route = check_fused(h, p["FF_W"], p["FF_b"], "penalties + slip + temperatures",
                        route=True, **VITERBI_OPTIONS, **TEMPS)
    head = check_head(h, p["FF_W"], p["FF_b"], "temperatures", **TEMPS)
    emit({"phase": "viterbi_options", "B": B, "T": T_BLOCKS,
          "options": VITERBI_OPTIONS, "temperatures": TEMPS,
          "forward_backtrace": "identical (head, integer lp, integer lp + options)",
          "fused": fused, "head_route": route,
          "head_lp": {k: head[k] for k in ("max_abs_err", "max_rel_err")}})


def ensemble_nets(device: str = "cuda") -> list:
    """The members of the measured transducer ensemble, primary first."""
    from scrappie_torch.models.forward import RgrgrModel

    return [RgrgrModel.from_registry(m, device)
            for m in ("rgrgr_r94",) + ENSEMBLE]


def ensemble_weights(K: int) -> "torch.Tensor":
    """The engine's normalised weights (3:1:...:1) of the first K members
    of rgrgr_r94 + ENSEMBLE5 (whose first two are ENSEMBLE), on the card."""
    import torch

    from scrappie_torch.models.ensemble import validate_ensemble

    w = validate_ensemble("rgrgr_r94", ENSEMBLE5[: K - 1]).astype("float32")
    return torch.as_tensor(w, device="cuda")


def check_ens_kernel(nets: list, B: int) -> tuple[dict, dict]:
    """The fused ensemble kernel against its twin on the hidden features
    the three rgrgr models give for B chunks of CHUNK samples (T_BLOCKS
    blocks), at 3:1:1; at B = 64 also with penalties, slip and temperatures,
    and with K = 2. Then its time (median of 20) and its twin's (median of
    3, a loop over T). The same for the paths' route (head kernel, then
    forward kernel) at K = 3 and at K = 5 (the three members and two
    repeated, 3:1:1:1:1, which the fused kernel cannot take), and the head
    kernel's log posterior against its twin at K = 3 and 5. Returns the
    fused kernel's row and the K = 3 head kernel's."""
    import numpy as np
    import torch

    from scrappie_torch.ops import viterbi as v
    from scrappie_torch.ops.pipeline import ensemble_features_tm

    rng = np.random.default_rng(SEED + 70 + B)
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device="cuda")
    K = len(nets)
    h, W, b = ensemble_features_tm(
        [n.params for n in nets], sig, kinds=("rgrgr",) * K,
        conv_activations=[n.conv_activation for n in nets], stride=5)
    w = ensemble_weights(K)
    require(h.shape == (K, T_BLOCKS, B, 96), f"ensemble features {tuple(h.shape)}")
    row = check_fused(h, W, b, f"3:1:1, B = {B}", weights=w)
    checked = {"3:1:1": dict(row)}
    if B == 64:
        checked["3:1:1, penalties + slip + temperatures"] = check_fused(
            h, W, b, "3:1:1, penalties + slip + temperatures", weights=w,
            **VITERBI_OPTIONS, **TEMPS)
        checked["K = 2, 3:1"] = check_fused(h[:2], W[:2], b[:2], "K = 2",
                                            weights=ensemble_weights(2))
    for more in checked.values():
        row["max_abs_err"] = max(row["max_abs_err"], more["max_abs_err"])
        row["max_rel_err"] = max(row["max_rel_err"], more["max_rel_err"])
    pick = [0, 1, 2, 1, 2]  # ENSEMBLE5's members: the trio's, repeated
    h5, W5, b5, w5 = h[pick], W[pick], b[pick], ensemble_weights(5)
    route = {"K = 3, 3:1:1": check_fused(h, W, b, "K = 3", weights=w, route=True),
             "K = 5, 3:1:1:1:1": check_fused(h5, W5, b5, "K = 5", weights=w5,
                                             route=True)}
    if B == 64:
        route["K = 3, penalties + slip + temperatures"] = check_fused(
            h, W, b, "K = 3, penalties + slip + temperatures", weights=w,
            route=True, **VITERBI_OPTIONS, **TEMPS)
    heads = {3: check_head(h, W, b, "K = 3", weights=w),
             5: check_head(h5, W5, b5, "K = 5", weights=w5)}
    heads[3]["route_ms"] = cuda_ms(lambda: head_route(h, W, b, w))
    heads[5]["route_ms"] = cuda_ms(lambda: head_route(h5, W5, b5, w5))
    nstate = W.shape[-1]
    row.update(K=K, **kernel_work("viterbi_fused_ens", T=T_BLOCKS, B=B, K=K, S=96,
                                  nstate=nstate),
               ms=cuda_ms(lambda: v.viterbi_fused_ens_tm(h, W, b, w)),
               plain_ms=cuda_ms(lambda: v.viterbi_fused_ens_tm_plain(h, W, b, w),
                                **TWIN_REPS))
    row["us_per_step"] = row["ms"] * 1e3 / T_BLOCKS
    row["single_head_ms"] = cuda_ms(lambda: v.viterbi_fused_tm(h[0], W[0], b[0]))
    emit({"phase": "ens_kernel", "B": B, "T": T_BLOCKS, "checked": checked,
          "timed": row, "route_checked": route, "head": heads})
    return row, heads[3]


def check_gru_recurrence(net, B: int) -> dict:
    """The GRU recurrence kernel against nn/rnn.gru_tm, both directions, on
    rgrgr_r94's first layer's projected conv features of B chunks (T_BLOCKS
    blocks, S = 96); then the times of the kernel (median of 20) and of the
    twin (median of 3)."""
    import numpy as np
    import torch

    from scrappie_torch.nn import rnn
    from scrappie_torch.nn.layers import feedforward
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops.pipeline import CONV_ACT
    from scrappie_torch.nn.layers import conv1d

    rng = np.random.default_rng(SEED + 80 + B)
    p = net.params
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device="cuda")
    x = CONV_ACT[net.conv_activation](
        conv1d(sig, p["conv_W"], p["conv_b"], net.stride)).transpose(0, 1)
    xproj = feedforward(x, p["gruB1_iW"], p["gruB1_b"]).contiguous()
    sW, sW2 = p["gruB1_sW"], p["gruB1_sW2"]
    require(xproj.shape == (T_BLOCKS, B, 288), f"projected {tuple(xproj.shape)}")
    err = 0.0
    for reverse in (True, False):
        hk = g.gru_tm(xproj, sW, sW2, reverse)
        hp = rnn.gru_tm(xproj, sW, sW2, reverse)
        sync()
        require(bool(torch.isfinite(hk).all()), "gru_recurrence output finite")
        err = max(err, float((hk - hp).abs().max()))
    require(err <= GRU_ATOL, f"gru_recurrence max abs err {err} <= {GRU_ATOL}")
    row = {"max_abs_err": err,
           **kernel_work("gru_recurrence", T=T_BLOCKS, B=B, S=96),
           "ms": cuda_ms(lambda: g.gru_tm(xproj, sW, sW2, True)),
           "plain_ms": cuda_ms(lambda: rnn.gru_tm(xproj, sW, sW2, True),
                               **TWIN_REPS)}
    emit({"phase": "gru_recurrence_kernel", "B": B, "T": T_BLOCKS, **row})
    return row


def check_gru_backward(net, B: int) -> dict:
    """The GRU recurrence's backward walk kernel (ops/gru.gru_walk) against
    its twin and ops/gru.gru_tm_backward against torch.autograd through
    the plain forward (nn/rnn.gru_tm), both directions, on rgrgr_r94's
    first layer's projected conv features of B chunks (T_BLOCKS blocks,
    S = 96) and a seeded output gradient (at B = 64 also the walk against
    its twin at GRU_BWD_SMALL's sizes); then the times of the walk
    kernel (median of 20), of its twin (median of 3) and of the whole
    backward (the gates' and weights' products with the walk)."""
    import numpy as np
    import torch

    from scrappie_torch.nn import rnn
    from scrappie_torch.nn.layers import conv1d, feedforward
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops.pipeline import CONV_ACT

    rng = np.random.default_rng(SEED + 90 + B)
    p = net.params
    with torch.no_grad():
        sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                              device="cuda")
        x = CONV_ACT[net.conv_activation](
            conv1d(sig, p["conv_W"], p["conv_b"], net.stride)).transpose(0, 1)
        xproj = feedforward(x, p["gruB1_iW"], p["gruB1_b"]).contiguous()
        gh = torch.as_tensor(rng.standard_normal((T_BLOCKS, B, 96)).astype(np.float32),
                             device="cuda")
    sW, sW2 = p["gruB1_sW"], p["gruB1_sW2"]
    errs = {"walk": 0.0, "autograd": 0.0}
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    for reverse in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (xproj, sW, sW2)]
        h = rnn.gru_tm(*leaves, reverse)
        h.backward(gh)
        with torch.no_grad():
            h = h.detach()
            h_prev, gates = g.backward_inputs(xproj, h, sW, sW2, reverse)
            dk = g.gru_walk(gates, h_prev, gh, sW, sW2, reverse)
            dp = g.gru_walk_plain(gates, h_prev, gh, sW, sW2, reverse)
            full = g.gru_tm_backward(xproj, h, sW, sW2, gh, reverse)
            sync()
            require(bool(torch.isfinite(dk).all()), "gru_recurrence_bwd finite")
            errs["walk"] = max(errs["walk"], rel(dk, dp))
            for got, leaf in zip(full, leaves):
                errs["autograd"] = max(errs["autograd"], rel(got, leaf.grad))
    if B == 64:  # and at the sizes of GRU_BWD_SMALL, on seeded weights
        gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
        errs["small_S"] = 0.0
        with torch.no_grad():
            for T, Bs, S in GRU_BWD_SMALL:
                xs = torch.randn((T, Bs, 3 * S), generator=gen, device="cuda")
                ws = [0.3 * torch.randn(shape, generator=gen, device="cuda")
                      for shape in ((S, 2 * S), (S, S))]
                ghs = torch.randn((T, Bs, S), generator=gen, device="cuda")
                for reverse in (True, False):
                    hs = g.gru_tm(xs, *ws, reverse)
                    hps, gs = g.backward_inputs(xs, hs, *ws, reverse)
                    errs["small_S"] = max(errs["small_S"], rel(
                        g.gru_walk(gs, hps, ghs, *ws, reverse),
                        g.gru_walk_plain(gs, hps, ghs, *ws, reverse)))
    for what, err in errs.items():
        require(err <= GRU_BWD_RTOL,
                f"gru_recurrence_bwd {what}: rel err {err} <= {GRU_BWD_RTOL}")
    with torch.no_grad():
        row = {"max_abs_err": float((dk - dp).abs().max()),
               "max_rel_err": errs["walk"], "autograd_max_rel_err": errs["autograd"],
               **({"small_S": GRU_BWD_SMALL, "small_S_max_rel_err": errs["small_S"]}
                  if "small_S" in errs else {}),
               **kernel_work("gru_recurrence_bwd", T=T_BLOCKS, B=B, S=96),
               "ms": cuda_ms(lambda: g.gru_walk(gates, h_prev, gh, sW, sW2, False)),
               "plain_ms": cuda_ms(lambda: g.gru_walk_plain(gates, h_prev, gh, sW,
                                                            sW2, False),
                                   **TWIN_REPS),
               "backward_ms": cuda_ms(lambda: g.gru_tm_backward(xproj, h, sW, sW2,
                                                                gh, False)),
               "forward_ms": cuda_ms(lambda: g.gru_tm(xproj, sW, sW2, False))}
    emit({"phase": "gru_backward_kernel", "B": B, "T": T_BLOCKS, **row})
    return row


def check_lstm_backward(enet, B: int) -> tuple[dict, dict]:
    """The LSTM's training kernels on the events network's first stage
    (S = 96) over B chunks of T_EVENTS events, both directions in one
    launch: the pair's training mode (its h equal to the inference
    launch's bit for bit, its planes, c, tanh(c) and the gates, against
    the plain loop's), the backward walk kernel (da and each row's dpeep
    partials) against its twin on those planes, and
    ops/lstm.lstm_tm_backward against torch.autograd through the plain
    forward, on a seeded output gradient (at B = 64 also the walk at
    LSTM_BWD_SMALL's sizes on seeded weights, one and two directions);
    then the times of the walk (median of 20) and its twin (one run), of
    the whole backward, and of the pair's forward in both modes. At B = 64
    also both kernels at the whole-read events step's shape (T_WHOLE_EVENTS
    events, B = 1): held to their twins once and timed (median of 5), the
    twins not timed. Returns the table's rows for the walk and the
    training forward, with ptxas's spill report in the phase's line."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import window
    from scrappie_torch.nn.rnn import lstm_tm
    from scrappie_torch.ops import lstm as L
    from scrappie_torch.ops.pipeline import lstm_weights
    from scrappie_torch.ops.project import project_tm

    rng = np.random.default_rng(SEED + 150 + B)
    p = enet.params
    wF, wB = (lstm_weights(p, d, 1) for d in "FB")
    S = wF[2].shape[0]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

    def stage(T: int, Bs: int):
        """A stage's projected input, its training forward and the twins'
        (h, planes) a direction, and seeded output gradients."""
        feats = torch.as_tensor(rng.standard_normal((Bs, T, 4)).astype(np.float32),
                                device=enet.device)
        x = window(feats, enet.winlen, 1).transpose(0, 1).contiguous()
        xpair = project_tm(x, torch.cat((wF[0], wB[0]), 1), torch.cat((wF[1], wB[1])))
        out = L.lstm_pair_train_cuda(xpair, *wF[2:], *wB[2:])
        gh = [torch.as_tensor(rng.standard_normal((T, Bs, S)).astype(np.float32),
                              device="cuda") for _ in "FB"]
        return xpair, out, gh

    def held(xpair, out, gh, what: str) -> dict:
        """The training forward against the inference launch and the
        twin's planes, the walk against its twin; the errors."""
        hF, hB, pF, pB = out
        iF, iB = L.lstm_pair_recurrence_cuda(xpair, *wF[2:], *wB[2:])
        twin = (lstm_tm(xpair[..., : 4 * S], *wF[2:], False, return_planes=True),
                lstm_tm(xpair[..., 4 * S :], *wB[2:], True, return_planes=True))
        walks = [(pF, gh[0], *wF[2:], False), (pB, gh[1], *wB[2:], True)]
        dk, parts = L.lstm_walk_pair(walks)
        dp = [L.lstm_walk_plain(*w) for w in walks]
        sync()
        require(torch.equal(hF, iF) and torch.equal(hB, iB),
                f"lstm_pair_train {what}: h equal to the inference launch's")
        planes_err = max(float((pk - t[1]).abs().max()) for pk, t in zip((pF, pB), twin))
        require(planes_err <= LSTM_ATOL,
                f"lstm_pair_train {what}: planes max abs err {planes_err} <= {LSTM_ATOL}")
        require(bool(torch.isfinite(dk).all()), f"lstm_recurrence_bwd {what} finite")
        errs = {"planes_max_abs_err": planes_err,
                "max_abs_err": float((dk - torch.cat([d[0] for d in dp], -1)).abs().max()),
                "max_rel_err": rel(dk, torch.cat([d[0] for d in dp], -1)),
                "dpeep_max_rel_err": rel(parts, torch.stack([d[1] for d in dp]))}
        for k in ("max_rel_err", "dpeep_max_rel_err"):
            require(errs[k] <= LSTM_BWD_RTOL,
                    f"lstm_recurrence_bwd {what} {k} {errs[k]} <= {LSTM_BWD_RTOL}")
        return errs

    with torch.no_grad():
        xpair, out, gh = stage(T_EVENTS, B)
        errs = held(xpair, out, gh, f"B={B}")
        hF, hB, pF, pB = out
        walks = [(pF, gh[0], *wF[2:], False), (pB, gh[1], *wB[2:], True)]
        layers = [(hF, pF, *wF[2:], False, gh[0]), (hB, pB, *wB[2:], True, gh[1])]
        full_da, full_w = L.lstm_tm_backward(layers)
    errs["autograd"] = 0.0
    for k, (h, planes, sW, pe, rev, g) in enumerate(layers):
        xs = xpair[..., 4 * S * k : 4 * S * (k + 1)]
        leaves = [t.clone().requires_grad_(True) for t in (xs, sW, pe)]
        lstm_tm(*leaves, rev).backward(g)
        got = (full_da[..., 4 * S * k : 4 * S * (k + 1)], *full_w[k])
        for a, leaf in zip(got, leaves):
            errs["autograd"] = max(errs["autograd"], rel(a, leaf.grad))
    require(errs["autograd"] <= LSTM_BWD_RTOL,
            f"lstm backward against autograd: rel err {errs['autograd']} <= {LSTM_BWD_RTOL}")
    whole = {}
    if B == 64:  # the sizes of LSTM_BWD_SMALL on seeded weights; the whole read
        gen = torch.Generator(device="cuda").manual_seed(SEED + 151)
        errs["small_S"] = 0.0
        with torch.no_grad():
            for T, Bs, Ss in LSTM_BWD_SMALL:
                xx = torch.randn((T, Bs, 8 * Ss), generator=gen, device="cuda")
                ws = [(0.3 * torch.randn((Ss, 4 * Ss), generator=gen, device="cuda"),
                       0.3 * torch.randn(3 * Ss, generator=gen, device="cuda"))
                      for _ in "FB"]
                _, _, p0, p1 = L.lstm_pair_train_cuda(xx, *ws[0], *ws[1])
                g0, g1 = (torch.randn((T, Bs, Ss), generator=gen, device="cuda")
                          for _ in "FB")
                ww = [(p0, g0, *ws[0], False), (p1, g1, *ws[1], True)]
                for dirs in (ww, ww[1:]):
                    got, got_parts = L.lstm_walk_pair(dirs)
                    want = [L.lstm_walk_plain(*w) for w in dirs]
                    errs["small_S"] = max(
                        errs["small_S"], rel(got, torch.cat([w[0] for w in want], -1)),
                        rel(got_parts, torch.stack([w[1] for w in want])))
            require(errs["small_S"] <= LSTM_BWD_RTOL,
                    f"lstm_recurrence_bwd small S: rel err {errs['small_S']}")
            wx, wout, wgh = stage(T_WHOLE_EVENTS, 1)
            whole = {"T": T_WHOLE_EVENTS, "B": 1, **held(wx, wout, wgh, "whole read")}
            wwalks = [(wout[2], wgh[0], *wF[2:], False), (wout[3], wgh[1], *wB[2:], True)]
            whole.update(
                walk_ms=cuda_ms(lambda: L.lstm_walk_pair(wwalks), reps=5, warmup=1),
                train_ms=cuda_ms(lambda: L.lstm_pair_train_cuda(wx, *wF[2:], *wB[2:]),
                                 reps=5, warmup=1),
                inference_ms=cuda_ms(
                    lambda: L.lstm_pair_recurrence_cuda(wx, *wF[2:], *wB[2:]),
                    reps=5, warmup=1),
                walk_bound_ms=kernel_work("lstm_recurrence_bwd", T=T_WHOLE_EVENTS, B=1,
                                          S=S, dirs=2)["bound_ms"],
                train_bound_ms=kernel_work("lstm_pair_train", T=T_WHOLE_EVENTS, B=1,
                                           S=S)["bound_ms"])
    with torch.no_grad():
        walk = {**kernel_work("lstm_recurrence_bwd", T=T_EVENTS, B=B, S=S, dirs=2),
                "max_abs_err": errs["max_abs_err"], "max_rel_err": errs["max_rel_err"],
                "dpeep_max_rel_err": errs["dpeep_max_rel_err"],
                "autograd_max_rel_err": errs["autograd"],
                **({"small_S": LSTM_BWD_SMALL, "small_S_max_rel_err": errs["small_S"]}
                   if "small_S" in errs else {}),
                "ms": cuda_ms(lambda: L.lstm_walk_pair(walks)),
                "plain_ms": cuda_ms(lambda: [L.lstm_walk_plain(*w) for w in walks],
                                    reps=1, warmup=0),
                "backward_ms": cuda_ms(lambda: L.lstm_tm_backward(layers))}
        train = {**kernel_work("lstm_pair_train", T=T_EVENTS, B=B, S=S),
                 "max_abs_err": errs["planes_max_abs_err"],
                 "ms": cuda_ms(lambda: L.lstm_pair_train_cuda(xpair, *wF[2:], *wB[2:])),
                 "inference_ms": cuda_ms(
                     lambda: L.lstm_pair_recurrence_cuda(xpair, *wF[2:], *wB[2:])),
                 "plain_ms": cuda_ms(
                     lambda: (lstm_tm(xpair[..., : 4 * S], *wF[2:], False,
                                      return_planes=True),
                              lstm_tm(xpair[..., 4 * S :], *wB[2:], True,
                                      return_planes=True)),
                     reps=1, warmup=0)}
    emit({"phase": "lstm_backward_kernel", "B": B, "T": T_EVENTS, "S": S,
          "walk": walk, "train_forward": train,
          **({"whole_read": whole} if whole else {}),
          "spill_bytes": {k: v for k, v in SPILLS.items() if "lstm" in k}})
    return walk, train


def lattice_window(model_net, kind: str):
    """A window batch for the lattice of `kind` ("transducer" or "crf"):
    LATTICE_WINDOWS' B seq_batch windows from the simulator (seeded), the
    last row's sequence removed; through the model's real weights, its log
    posterior [T, B, 1025] or transitions [T, B, 25] (time-major) and the
    kmer states [B, L] int32 (the CRF: their bases, state % 4)."""
    import torch

    from scrappie_torch.train.simulate import SquiggleSimulator

    import numpy as np

    B, nsample, L = LATTICE_WINDOWS[kind]
    sim = SquiggleSimulator(seed=SEED + 160 + len(kind), device="cuda")
    sig, seq = sim.seq_batch(B, nsample, L)
    seq[-1] = -1
    if kind == "crf":
        seq = np.where(seq >= 0, seq % 4, -1)
    with torch.no_grad():
        x = model_net(torch.as_tensor(sig, device="cuda"))
    return (x.transpose(0, 1).contiguous(),
            torch.as_tensor(seq, dtype=torch.int32, device="cuda"))


def lattice_pair(kind: str, x, seq, gen, twin: bool, global_rows: bool = False,
                 chunk=None):
    """The kind's kernels (forward, then backward on a seeded gP, and gZ
    for the CRF; a checkpoint every `chunk` steps, None keeping every
    step's rows; with global_rows their CTAs' arrays in global memory, the
    mode of an L above shared memory's) or with twin their plain twins ->
    (log P, logZ or None, the gradient)."""
    import torch

    from scrappie_torch.ops import lattice as tl

    B = seq.shape[0]
    gP = torch.randn(B, generator=gen, device="cuda")
    if kind == "transducer":
        if twin:
            logp, *kept = tl.lattice_fwd_plain(x, seq, 0.0, 4.0, 4.0, chunk)
            return logp, None, tl.lattice_bwd_plain(x, seq, *kept, gP, 0.0, 4.0, 4.0)
        logp, *kept = tl.lattice_fwd_cuda(x, seq, 0.0, 4.0, 4.0, chunk, global_rows)
        return logp, None, tl.lattice_bwd_cuda(x, seq, *kept, gP, 0.0, 4.0, 4.0,
                                               global_rows)
    gZ = torch.randn(B, generator=gen, device="cuda")
    if not twin:
        logp, logz, *saved = tl.crf_lattice_fwd_cuda(x, seq, 4.0, chunk, global_rows)
        return logp, logz, tl.crf_lattice_bwd_cuda(x, seq, *saved, gP, gZ, 4.0,
                                                   global_rows)
    logp, *kept = tl.crf_fwd_plain(x, seq, 4.0, chunk)
    logz, z, zm = tl.partition_fwd_plain(x, 4.0)
    return logp, logz, (tl.crf_bwd_plain(x, seq, *kept, gP, 4.0)
                        + tl.partition_bwd_plain(x, z, zm, gZ, 4.0))


def lattice_held_bytes(kind: str, x, seq, chunk) -> int:
    """The bytes the kind's forward kernel keeps for its backward at
    `chunk`: the checkpoints, the last chunk's rows and the maxima (the
    CRF's partition's rows and maxima too)."""
    from scrappie_torch.ops import lattice as tl

    if kind == "transducer":
        kept = tl.lattice_fwd_cuda(x, seq, 0.0, 4.0, 4.0, chunk)[1:]
    else:
        kept = tl.crf_lattice_fwd_cuda(x, seq, 4.0, chunk)[2:]
    return sum(t.numel() * t.element_size() for t in kept)


def lattice_seeded():
    """The generator of the lattice checks' output gradients."""
    import torch

    return torch.Generator(device="cuda").manual_seed(SEED + 161)


def check_lattice_case(kind: str, x, seq, what: str, global_rows: bool = False,
                       want=None, chunk=None) -> tuple[float, tuple]:
    """The kind's kernels (global_rows: see lattice_pair; a checkpoint
    every `chunk` steps) against their twins (want: their result on
    lattice_seeded()'s output gradients, if already taken) on the same
    inputs and seeded output gradients: log P (and logZ) finite and within
    LATTICE_RTOL on the rows with a sequence, the sentinel on those
    without, the gradient within LATTICE_GRAD_TWIN_RTOL of its largest
    entry and exactly 0 on the transducer's rows without a sequence ->
    (the largest gradient error, the kernels' result)."""
    import torch

    has = (seq >= 0).any(1)
    got = lattice_pair(kind, x, seq, lattice_seeded(), False, global_rows, chunk)
    if want is None:
        want = lattice_pair(kind, x, seq, lattice_seeded(), True)
    sync()
    for a, b, name in zip(got[:2], want[:2], ("log P", "logZ")):
        if b is None:
            continue
        rows = has if name == "log P" else torch.ones_like(has)
        require(bool(torch.isfinite(a[rows]).all() and (a[rows] > -1e29).all()),
                f"{kind} {what} {name}: finite")
        err = float(((a - b).abs() / b.abs())[rows].max())
        require(err <= LATTICE_RTOL, f"{kind} {what} {name}: rel err {err}")
        if name == "log P":
            require(bool((a[~has] < -1e29).all()), f"{kind} {what}: sentinels")
    require(bool(torch.isfinite(got[2]).all()), f"{kind} {what}: finite gradient")
    gerr = float((got[2] - want[2]).abs().max() / want[2].abs().max())
    require(gerr <= LATTICE_GRAD_TWIN_RTOL, f"{kind} {what} gradient: rel err {gerr}")
    if kind == "transducer":
        require(not bool(got[2][:, ~has].any()), f"{what}: rows without a sequence get 0")
    return gerr, got


def whole_read_lattice(kind: str, S: int, shape=WHOLE_READ_SHAPE):
    """Seeded inputs of the kind's lattice at shape (blocks, bases), B =
    1: a log posterior [T, 1, S] and kmer states, or transitions [T, 1,
    25] and bases."""
    import torch

    TW, LW = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 162)
    if kind == "transducer":
        x = torch.log_softmax(2.0 * torch.randn((TW, 1, S), generator=g, device="cuda"), -1)
        seq = torch.randint(0, S - 1, (1, LW), generator=g, device="cuda",
                            dtype=torch.int32)
        return x, seq
    x = 2.0 * torch.randn((TW, 1, 25), generator=g, device="cuda")
    seq = torch.randint(0, 4, (1, LW), generator=g, device="cuda", dtype=torch.int32)
    return x, seq


@contextlib.contextmanager
def lattice_limits(max_cluster: int, max_threads: int):
    """ops/lattice's layout limits (MAX_CLUSTER, MAX_THREADS) set lower
    for the block: the kernels take any layout within their own."""
    from scrappie_torch.ops import lattice as tl

    old = tl.MAX_CLUSTER, tl.MAX_THREADS
    tl.MAX_CLUSTER, tl.MAX_THREADS = max_cluster, max_threads
    try:
        yield
    finally:
        tl.MAX_CLUSTER, tl.MAX_THREADS = old


def lattice_twin(part: str, device: str, dtype: str, x, seq, g):
    """One part of the lattice kernels' plain twins ("transducer"; "crf",
    the CRF's sequence lattice; "partition", its local partition) in a
    worker process, on the device in float32 or float64: numpy inputs x,
    seq and output gradient g -> (log P or logZ, the gradient) as numpy,
    and the seconds they took."""
    import torch

    from scrappie_torch.ops import lattice as tl

    t0 = time.perf_counter()
    torch.set_num_threads(2)
    with torch.inference_mode():
        x = torch.as_tensor(x, device=device).to(getattr(torch, dtype))
        seq = torch.as_tensor(seq, device=device)
        g = torch.as_tensor(g, device=device).to(x.dtype)
        if part == "transducer":
            value, *kept = tl.lattice_fwd_plain(x, seq, 0.0, 4.0, 4.0)
            grad = tl.lattice_bwd_plain(x, seq, *kept, g, 0.0, 4.0, 4.0)
        elif part == "crf":
            value, *kept = tl.crf_fwd_plain(x, seq, 4.0)
            grad = tl.crf_bwd_plain(x, seq, *kept, g, 4.0)
        else:
            value, z, zm = tl.partition_fwd_plain(x, 4.0)
            grad = tl.partition_bwd_plain(x, z, zm, g, 4.0)
    return value.cpu().numpy(), grad.cpu().numpy(), time.perf_counter() - t0


def check_lattice_kernels(net, rnet) -> dict:
    """Each lattice kernel against its twins on log P (and logZ_local)
    and the gradient (phase lattice_kernels): at its window shape
    (LATTICE_WINDOWS: rgrgr_r94's log posterior and rnnrf_r94's
    transitions of simulated windows, the last row without a sequence),
    there again with its CTAs' arrays in global memory (the mode of an L
    whose arrays shared memory cannot hold), at L = 1 and 2 on the
    window's first rows, with several runs of positions a thread (at the
    window under LATTICE_SMALL_RUNS' limits, in shared and in global
    memory, also checkpointed, equal to chunk = T's bit for bit; and at
    LATTICE_LONG, the kernels alone, their first call timed), and at the
    whole-read shape (WHOLE_READ_SHAPE, seeded inputs, a checkpoint every
    WHOLE_CHUNK steps): on its first WHOLE_TWIN_BLOCKS blocks against the
    twins on the card at the windows' tolerances, and against the twins in
    float64 (on the card; the
    partition's on the host CPU) within LATTICE_RTOL and
    LATTICE_F64_GRAD_RTOL, the twins' parts all at once
    in worker processes; and its log P, logZ and gradient at WHOLE_CHUNK
    equal to chunk = T's bit for bit. Timed at the window (forward and
    backward, the kernels' median of 5, the twins' single run) and at the
    whole-read shape (the kernels' median of 3 at WHOLE_CHUNK and at
    chunk = T, with the bytes they keep and their peak; the twins'
    seconds, side by side). Returns the table's rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from scrappie_torch.ops import lattice as tl

    kinds = (("transducer", "lattice_fwdbwd", net), ("crf", "crf_lattice_fwdbwd", rnet))
    rows, errs = {}, {}
    for kind, name, model_net in kinds:
        x, seq = lattice_window(model_net, kind)
        T, B = x.shape[:2]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        sync()
        ev[0].record()
        want = lattice_pair(kind, x, seq, lattice_seeded(), True)
        ev[1].record()
        ev[1].synchronize()
        e = errs[kind] = {}
        e["window"], got = check_lattice_case(kind, x, seq, "window", want=want)
        # checkpoints every WINDOW_CHUNK steps (a ragged last chunk), in
        # shared memory and in global memory: the gradient of chunk = T
        # bit for bit
        for glob in (False, True):
            what = f"window, chunk {WINDOW_CHUNK}" + (", global rows" if glob else "")
            e[what], chunked = check_lattice_case(kind, x, seq, what, glob, want,
                                                  WINDOW_CHUNK)
            require(torch.equal(chunked[2], got[2]) and torch.equal(chunked[0], got[0]),
                    f"{kind} {what}: equal to chunk = T")
            del chunked
        for L in (1, 2):
            e[f"L={L}"] = check_lattice_case(kind, x[:, :2].contiguous(),
                                             seq[:2, :L].contiguous(), f"L={L}")[0]
        valid = int((seq >= 0).sum())
        distinct = sum(len(set(r[r >= 0].tolist())) for r in seq.cpu())
        gen = torch.Generator(device="cuda")
        work = (kernel_work(name, T=T, B=B, S=x.shape[2], L=seq.shape[1],
                            distinct=distinct, valid=valid) if kind == "transducer"
                else kernel_work(name, T=T, B=B, L=seq.shape[1], valid=valid))
        npos = seq.shape[1] + (kind == "crf")
        rows[name] = {**work, "T": T, "B": B, "L": seq.shape[1],
                      "layout": tl.cluster_layout(npos)._asdict(),
                      "max_abs_err": float((got[2] - want[2]).abs().max()),
                      "ms": cuda_ms(lambda: lattice_pair(kind, x, seq, gen, False), reps=5),
                      "plain_ms": ev[0].elapsed_time(ev[1])}
        # several runs of positions a thread, at the window
        with lattice_limits(*LATTICE_SMALL_RUNS):
            lay = tl.cluster_layout(npos)
            require(lay.groups > 1, f"{kind} {LATTICE_SMALL_RUNS}: {lay} walks one run")
            e["runs"], full = check_lattice_case(kind, x, seq, "runs", want=want)
            for glob in (False, True):
                what = f"runs, chunk {WINDOW_CHUNK}" + (", global rows" if glob else "")
                e[what], chunked = check_lattice_case(kind, x, seq, what, glob, want,
                                                      WINDOW_CHUNK)
                require(all(torch.equal(a, b) for a, b in zip(chunked, full)
                            if b is not None), f"{kind} {what}: equal to chunk = T")
        rows[name]["runs"] = {"limits": LATTICE_SMALL_RUNS, "layout": lay._asdict()}
        del got, want, full, chunked
        # a real row above one run of positions a thread, the kernels alone
        TL, LL = LATTICE_LONG[kind]
        xl, sl = whole_read_lattice(kind, x.shape[2], (TL, LL))
        lay = tl.cluster_layout(LL + (kind == "crf"))
        require(lay.groups > 1, f"{kind} {LATTICE_LONG[kind]}: {lay} walks one run")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        sync()
        ev[0].record()
        a = lattice_pair(kind, xl, sl, lattice_seeded(), False, chunk=WHOLE_CHUNK)
        ev[1].record()
        b = lattice_pair(kind, xl, sl, lattice_seeded(), False, chunk=LATTICE_LONG_CHUNK)
        for u, v, what in zip(a, b, ("log P", "logZ", "gradient")):
            if v is not None:
                require(bool(torch.isfinite(u).all() and (u > -1e29).all()),
                        f"{kind} long {what}: finite")
                require(torch.equal(u, v), f"{kind} long {what}: chunk {WHOLE_CHUNK} "
                                           f"equal to chunk {LATTICE_LONG_CHUNK}")
        rows[name]["long"] = {
            "T": TL, "L": LL, "chunk": WHOLE_CHUNK, "layout": lay._asdict(),
            "log_p": float(a[0][0]), "grad_abs_max": float(a[2].abs().max()),
            "ms": ev[0].elapsed_time(ev[1])}
        del xl, sl, a, b
    # the whole-read shape: the kernels timed, their chunks against
    # chunk = T, then held against the twins
    TW, LW = WHOLE_READ_SHAPE
    whole = {}
    for kind, name, _ in kinds:
        xw, sw = whole_read_lattice(kind, 1025)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device="cuda")
        ms = cuda_ms(lambda: lattice_pair(kind, xw, sw, gen, False, chunk=WHOLE_CHUNK),
                     **TWIN_REPS)
        peak = torch.cuda.max_memory_allocated() - base
        held = lattice_held_bytes(kind, xw, sw, WHOLE_CHUNK)
        held_T = lattice_held_bytes(kind, xw, sw, None)
        ms_T = cuda_ms(lambda: lattice_pair(kind, xw, sw, gen, False), **TWIN_REPS)
        chunked = lattice_pair(kind, xw, sw, lattice_seeded(), False, chunk=WHOLE_CHUNK)
        full = lattice_pair(kind, xw, sw, lattice_seeded(), False)
        for a, b, what in zip(chunked, full, ("log P", "logZ", "gradient")):
            if b is not None:
                require(torch.equal(a, b), f"{kind} whole read {what}: chunk "
                                           f"{WHOLE_CHUNK} equal to chunk = T")
        del chunked, full
        wv = int((sw >= 0).sum())
        rows[name]["whole_read"] = {
            "T": TW, "L": LW, "chunk": WHOLE_CHUNK, "ms": ms, "bytes_held": held,
            "peak_bytes": peak, "ms_chunk_T": ms_T, "bytes_held_chunk_T": held_T,
            "equal_to_chunk_T": True,
            "layout": tl.cluster_layout(LW + (kind == "crf"))._asdict(),
            **(kernel_work(name, T=TW, B=1, S=xw.shape[2], L=LW, valid=wv,
                           distinct=len(set(sw[0].tolist())))
               if kind == "transducer" else kernel_work(name, T=TW, B=1, L=LW, valid=wv))}
        whole[kind] = (xw[:WHOLE_TWIN_BLOCKS].contiguous(), sw)
    # the twins of each part (the transducer; the CRF's lattice and its
    # partition) in float32 and in float64 on the card (the partition's
    # float64 on the host CPU, where its seven states run fastest), all at
    # once in worker processes: a twin's step is tens of small launches or
    # host ops, bound by the host, over 30 720 steps (the lattices'
    # float64 on a busy host CPU took twice the card's time)
    parts = {"transducer": ("transducer",), "crf": ("crf", "partition")}
    dtypes = ("float32", "float64")
    place = lambda part, dtype: "cpu" if dtype == "float64" and part == "partition" else "cuda"
    npart = sum(len(v) for v in parts.values()) * len(dtypes)
    twin_s = {}
    with ProcessPoolExecutor(npart, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {}
        for kind, (xw, sw) in whole.items():
            g = lattice_seeded()  # lattice_pair draws the output gradients so
            gP, gZ = (torch.randn(1, generator=g, device="cuda").cpu().numpy()
                      for _ in range(2))
            xn, sn = xw.cpu().numpy(), sw.cpu().numpy()
            for part in parts[kind]:
                for dtype in dtypes:
                    jobs[kind, part, dtype] = pool.submit(
                        lattice_twin, part, place(part, dtype), dtype, xn, sn,
                        gZ if part == "partition" else gP)
        for kind, (xw, sw) in whole.items():
            got = lattice_pair(kind, xw, sw, lattice_seeded(), False, chunk=WHOLE_CHUNK)
            for dtype in dtypes:
                res = [jobs[kind, part, dtype].result() for part in parts[kind]]
                for part, r in zip(parts[kind], res):
                    twin_s[f"{part} {dtype} {place(part, dtype)}"] = r[2]
                want = (res[0][0], res[1][0] if kind == "crf" else None,
                        sum(r[1] for r in res))
                if dtype == "float32":
                    want = [None if v is None else torch.as_tensor(v, device="cuda")
                            for v in want]
                    errs[kind]["whole read"] = check_lattice_case(
                        kind, xw, sw, "whole read", want=want, chunk=WHOLE_CHUNK)[0]
                    continue
                f64 = {n: float(np.abs(a.double().cpu().numpy() - r).max() / np.abs(r).max())
                       for n, a, r in zip(("log P", "logZ", "gradient"), got, want)
                       if r is not None}
                for n, err in f64.items():
                    limit = LATTICE_F64_GRAD_RTOL if n == "gradient" else LATTICE_RTOL
                    require(err <= limit, f"{kind} whole read {n} against float64: "
                                          f"rel err {err} <= {limit}")
                errs[kind]["whole read, float64"] = f64
    for kind, name, _ in kinds:
        rows[name]["grad_max_rel_err"] = errs[kind]
        rows[name]["whole_read"]["twin_s"] = {k: v for k, v in twin_s.items()
                                              if k.split()[0] in parts[kind]}
        emit({"phase": "lattice_kernels", "kind": kind, "kernel": name, **rows[name]})
    return rows


def compare_routes(nets: list, card: str) -> dict:
    """The fast paths' decode, the head kernel then the forward kernel,
    against the fused kernels it replaced, one model (rgrgr_r94's FF head)
    and the 3:1:1 ensemble, at each of ROUTE_BATCHES chunks of CHUNK
    samples, timed in turns (fused, route, route, fused; CUDA events,
    median of 5 each)."""
    import numpy as np
    import torch

    from scrappie_torch.ops import viterbi as v
    from scrappie_torch.ops.pipeline import ensemble_features_tm

    K = len(nets)
    w = ensemble_weights(K)
    rows = {}
    for B in ROUTE_BATCHES:
        sig = torch.as_tensor(np.random.default_rng(SEED + 100 + B).standard_normal(
            (B, CHUNK, 1)).astype(np.float32), device="cuda")
        h, W, b = ensemble_features_tm(
            [n.params for n in nets], sig, kinds=("rgrgr",) * K,
            conv_activations=[n.conv_activation for n in nets], stride=5)
        h1 = h[0].contiguous()
        cases = {1: (lambda: v.viterbi_fused_tm(h1, W[0], b[0]),
                     lambda: head_route(h1, W[0], b[0])),
                 K: (lambda: v.viterbi_fused_ens_tm(h, W, b, w),
                     lambda: head_route(h, W, b, w))}
        for k, (fused, route) in cases.items():
            f1, r1, r2, f2 = (cuda_ms(fn, reps=5) for fn in (fused, route, route, fused))
            rows[f"K = {k}, B = {B}"] = {
                "fused_ms": [f1, f2], "route_ms": [r1, r2],
                "head_ms": cuda_ms(lambda: v.head_logpost_tm(
                    *((h1, W[0], b[0]) if k == 1 else (h, W, b, w))), reps=5)}
        del h, h1
    emit({"phase": "routes", "T": T_BLOCKS, "rows": rows, "card": card})
    return rows


def check_big_s() -> dict:
    """The GRU and LSTM wrappers at sizes above the registers' S = 96
    (BIG_S): each layer, projection and all, against its twin on seeded
    weights and inputs (T_BIG_S steps, B = 8, C = 96, both directions), and
    the LSTM's pair route, through the big-S mode, whose counter must rise;
    then the times of the largest size's recurrence (GRU) or layer (LSTM)
    beside its twin's."""
    import numpy as np
    import torch

    from scrappie_torch import ops
    from scrappie_torch.nn import rnn
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops import lstm as L
    from scrappie_torch.ops.project import project_tm

    rng = np.random.default_rng(SEED + 90)
    T, B, C = T_BIG_S, 8, 96

    def f(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32),
                               device="cuda")

    rows = {"gru_recurrence_global": {"max_abs_err": 0.0},
            "lstm_layer_global": {"max_abs_err": 0.0}}
    x = f(T, B, C)
    for kind, sizes in BIG_S.items():
        name = "gru_recurrence_global" if kind == "gru" else "lstm_layer_global"
        for S in sizes:
            ng = 3 if kind == "gru" else 4
            iW, bias = f(C, ng * S, scale=C ** -0.5), f(ng * S, scale=0.1)
            rec = ((f(S, 2 * S, scale=S ** -0.5), f(S, S, scale=S ** -0.5))
                   if kind == "gru" else (f(S, 4 * S, scale=S ** -0.5),
                                          f(3 * S, scale=0.3)))
            layer, plain = ((g.gru_layer_tm, g.gru_layer_tm_plain) if kind == "gru"
                            else (L.lstm_layer_tm, L.lstm_layer_tm_plain))
            before = ops.LAUNCHES[name]
            for reverse in (False, True):
                hk = layer(x, iW, bias, *rec, reverse=reverse)
                hp = plain(x, iW, bias, *rec, reverse=reverse)
                sync()
                require(bool(torch.isfinite(hk).all()), f"{kind} S={S} finite")
                err = float((hk - hp).abs().max())
                tol = GRU_ATOL if kind == "gru" else LSTM_ATOL
                require(err <= tol, f"{kind} S={S} max abs err {err} <= {tol}")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            if kind == "lstm":  # a second layer's weights: the pair route
                wB = (f(C, 4 * S, scale=C ** -0.5), f(4 * S, scale=0.1),
                      f(S, 4 * S, scale=S ** -0.5), f(3 * S, scale=0.3))
                pair = L.lstm_pair_tm(x, (iW, bias, *rec), wB)
                twin = L.lstm_pair_tm_plain(x, (iW, bias, *rec), wB)
                sync()
                err = max(float((k - t).abs().max()) for k, t in zip(pair, twin))
                require(err <= LSTM_ATOL, f"lstm pair S={S} max abs err {err}")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            require(ops.LAUNCHES[name] - before == (2 if kind == "gru" else 4),
                    f"{name} launched for {kind} S={S}")
        if kind == "gru":
            xproj = project_tm(x, iW, bias)
            timed = (lambda: g.gru_tm(xproj, *rec), lambda: rnn.gru_tm(xproj, *rec))
            work = kernel_work("gru_recurrence", T=T, B=B, S=S)
        else:
            timed = (lambda: layer(x, iW, bias, *rec), lambda: plain(x, iW, bias, *rec))
            work = kernel_work("lstm_layer", T=T, B=B, C=C, S=S)
        rows[name].update(S=S, T=T, B=B, **work, ms=cuda_ms(timed[0], reps=5),
                          plain_ms=cuda_ms(timed[1], **TWIN_REPS))
    emit({"phase": "big_s", "sizes": BIG_S, "T": T, "B": B, "rows": rows})
    return rows


def check_big_s_backward() -> dict:
    """The training kernels above the registers' S = 96, at S = BIG_S_BWD
    (phase big_s_backward; T_BIG_S steps, B = 8, C = 96, seeded weights of
    scale S^-1/2): the GRU's big-S walk (ops/gru.gru_walk) against its
    twin on the gates of the big-S forward, both directions; the LSTM
    pair's big-S training forward against the twin loops' h and planes;
    the LSTM's big-S walk over both directions (ops/lstm.lstm_walk_pair,
    da and the dpeep partials) against the twin, in its cluster mode at
    each LSTM_BIG_S_WALKS shape (planes from the big-S training forward,
    T_BIG_S steps; its ms, bound, latency floor, layout and clusters) and
    in its mode from L2 at LSTM_L2_WALK; each counter must rise. Then a GRU layer (ops/gru.gru_layer_tm)
    and an LSTM stage (ops/lstm.lstm_pair_tm) with gradients wanted,
    through those kernels, against torch.autograd through their plain
    twins: every input's and weight's gradient within TRAIN_GRAD_RTOL of its
    largest entry (the two routes' forwards differ too, as a training
    step's on the card and on the CPU). Times of each kernel (median of 5)
    beside its twin's (median of 3)."""
    import numpy as np
    import torch

    from scrappie_torch import ops
    from scrappie_torch.nn.rnn import lstm_tm
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops import lstm as L
    from scrappie_torch.ops.project import project_tm

    rng = np.random.default_rng(SEED + 92)
    T, B, C, S = T_BIG_S, 8, 96, BIG_S_BWD

    def f(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32),
                               device="cuda")

    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    rows = {}
    x = f(T, B, C)
    with torch.no_grad():
        # the GRU's walk
        iW, bias = f(C, 3 * S, scale=C ** -0.5), f(3 * S, scale=0.1)
        sW, sW2 = f(S, 2 * S, scale=S ** -0.5), f(S, S, scale=S ** -0.5)
        xg, gh = project_tm(x, iW, bias), f(T, B, S)
        before = ops.LAUNCHES["gru_recurrence_bwd_global"]
        err = 0.0
        for reverse in (False, True):
            h = g.gru_tm(xg, sW, sW2, reverse)
            h_prev, gates = g.backward_inputs(xg, h, sW, sW2, reverse)
            dk = g.gru_walk(gates, h_prev, gh, sW, sW2, reverse)
            dp = g.gru_walk_plain(gates, h_prev, gh, sW, sW2, reverse)
            sync()
            require(bool(torch.isfinite(dk).all()), "gru_recurrence_bwd_global finite")
            err = max(err, rel(dk, dp))
        require(err <= GRU_BWD_RTOL, f"gru big-S walk: rel err {err} <= {GRU_BWD_RTOL}")
        require(ops.LAUNCHES["gru_recurrence_bwd_global"] - before == 2,
                "gru_recurrence_bwd_global launched")
        rows["gru_recurrence_bwd_global"] = {
            "S": S, "T": T, "B": B, "max_abs_err": float((dk - dp).abs().max()),
            "max_rel_err": err, **kernel_work("gru_recurrence_bwd", T=T, B=B, S=S),
            "ms": cuda_ms(lambda: g.gru_walk(gates, h_prev, gh, sW, sW2, True), reps=5),
            "plain_ms": cuda_ms(lambda: g.gru_walk_plain(gates, h_prev, gh, sW, sW2,
                                                         True), **TWIN_REPS)}
        # the LSTM pair's training forward and walk
        wF, wB = ((f(C, 4 * S, scale=C ** -0.5), f(4 * S, scale=0.1),
                   f(S, 4 * S, scale=S ** -0.5), f(3 * S, scale=0.3)) for _ in "FB")
        xp = project_tm(x, torch.cat((wF[0], wB[0]), 1), torch.cat((wF[1], wB[1])))
        ghF, ghB = f(T, B, S), f(T, B, S)
        before = {k: ops.LAUNCHES[k] for k in ("lstm_pair_train_global",)}
        hF, hB, pF, pB = L.lstm_pair_train_cuda(xp, *wF[2:], *wB[2:])
        twin = lambda: (lstm_tm(xp[..., : 4 * S], *wF[2:], False, return_planes=True),
                        lstm_tm(xp[..., 4 * S :], *wB[2:], True, return_planes=True))
        (tF, tpF), (tB, tpB) = twin()
        sync()
        ferr = max(float((a - b).abs().max())
                   for a, b in ((hF, tF), (hB, tB), (pF, tpF), (pB, tpB)))
        require(ferr <= LSTM_ATOL, f"lstm big-S training forward: max abs err {ferr}")
        require(ops.LAUNCHES["lstm_pair_train_global"] - before["lstm_pair_train_global"]
                == 1, "lstm_pair_train_global launched")
        rows["lstm_pair_train_global"] = {
            "S": S, "T": T, "B": B, "max_abs_err": ferr,
            **kernel_work("lstm_pair_train", T=T, B=B, S=S),
            "ms": cuda_ms(lambda: L.lstm_pair_train_cuda(xp, *wF[2:], *wB[2:]), reps=5),
            "plain_ms": cuda_ms(twin, **TWIN_REPS)}
        # the LSTM's big-S walk: its cluster mode at each LSTM_BIG_S_WALKS
        # shape, its mode from L2 at LSTM_L2_WALK
        cases = {}
        for Sw, Bw, Tw in [(s_, b_, T) for s_, b_ in LSTM_BIG_S_WALKS] + [LSTM_L2_WALK]:
            mode = L.walk_mode(Sw)
            counter = L.WALK_MODES[mode][0]
            if (Sw, Bw) == (S, B):
                lw = (wF[2:], wB[2:])
                gh2 = (ghF, ghB)
                planes = (pF, pB)
            else:
                lw = [(f(Sw, 4 * Sw, scale=Sw ** -0.5), f(3 * Sw, scale=0.3))
                      for _ in "FB"]
                xw = f(Tw, Bw, 8 * Sw)
                gh2 = (f(Tw, Bw, Sw), f(Tw, Bw, Sw))
                planes = L.lstm_pair_train_cuda(xw, *lw[0], *lw[1])[2:]
                del xw
            dirs = [(planes[0], gh2[0], *lw[0], False), (planes[1], gh2[1], *lw[1], True)]
            n0 = ops.LAUNCHES[counter]
            dk, dparts = L.lstm_walk_pair(dirs)
            t0 = time.perf_counter()
            want = [L.lstm_walk_plain(*d) for d in dirs]
            dp = torch.cat([w[0] for w in want], dim=-1)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            label = f"S = {Sw}, B = {Bw}, T = {Tw}"
            require(bool(torch.isfinite(dk).all()), f"{counter} finite ({label})")
            werr = max(rel(dk, dp), rel(dparts, torch.stack([w[1] for w in want])))
            require(werr <= LSTM_BWD_RTOL, f"lstm big-S walk ({mode}, {label}): "
                                           f"rel err {werr} <= {LSTM_BWD_RTOL}")
            require(ops.LAUNCHES[counter] - n0 == 1, f"{counter} launched ({label})")
            row = {"S": Sw, "T": Tw, "B": Bw, "mode": mode,
                   "max_abs_err": float((dk - dp).abs().max()), "max_rel_err": werr,
                   **kernel_work("lstm_recurrence_bwd", T=Tw, B=Bw, S=Sw, dirs=2),
                   "ms": cuda_ms(lambda: L.lstm_walk_pair(dirs), reps=5),
                   "plain_ms": plain_ms}
            row["us_per_step"] = row["ms"] * 1e3 / Tw
            layout = L.walk_cluster_layout(Sw)
            if mode == "cluster":
                row["layout"] = layout._asdict()
                row["clusters"] = 2 * Bw
                row["latency_floor_ms"] = floor_ms(
                    Tw, cluster_walk_floor_cycles(layout.rows))
            cases[label] = row
            del dirs, planes, gh2, dk, dp, want
        first = next(iter(cases.values()))
        rows["lstm_recurrence_bwd_cluster"] = {**first, "cases": cases}
        rows["lstm_recurrence_bwd_global"] = list(cases.values())[-1]
    # the routes with gradients wanted against autograd through the twins
    grads = {}
    for route, layer in (("kernels", True), ("twins", False)):
        leaves = [t.clone().requires_grad_(True) for t in (x, iW, bias, sW, sW2)]
        fn = g.gru_layer_tm if layer else g.gru_layer_tm_plain
        (fn(*leaves, reverse=True) * gh).sum().backward()
        wl = [[t.clone().requires_grad_(True) for t in w] for w in (wF, wB)]
        xl = x.clone().requires_grad_(True)
        pair = (L.lstm_pair_tm if layer else L.lstm_pair_tm_plain)(xl, *wl)
        ((pair[0] * ghF).sum() + (pair[1] * ghB).sum()).backward()
        grads[route] = [t.grad for t in leaves + [xl] + wl[0] + wl[1]]
    sync()
    route_err = max(rel(a, b) for a, b in zip(grads["kernels"], grads["twins"]))
    require(route_err <= TRAIN_GRAD_RTOL,
            f"big-S training routes against autograd: rel err {route_err}")
    emit({"phase": "big_s_backward", "S": S, "T": T, "B": B,
          "routes_max_rel_err": route_err, "rows": rows})
    return rows


def seeded_logposts(shape, gen) -> tuple:
    """Log posteriors on the card from the generator gen: standard normal
    minus 3, and integers in {-3..0} (ties at almost every step)."""
    import torch

    lp = torch.randn(shape, generator=gen, device="cuda") - 3.0
    ties = torch.randint(-3, 1, shape, generator=gen, device="cuda").float()
    return lp, ties


def check_nhist() -> dict:
    """The Viterbi forward and backtrace kernels at each of NHIST_CASES and
    NHIST_BATCHES: tracebacks, finals, paths and scores identical to the
    twins' on seeded log posteriors and on integer ones (ties), at
    T_BLOCKS blocks; then the forward's times at B = 8."""
    import torch

    from scrappie_torch.ops import viterbi as v

    gen = torch.Generator(device="cuda").manual_seed(SEED + 95)
    rows = {}
    for nhist, slip in NHIST_CASES:
        for B in NHIST_BATCHES:
            lp, ties = seeded_logposts((T_BLOCKS, B, nhist + 1), gen)
            for what, x in (("random", lp), ("integer", ties)):
                check_forward_and_backtrace(x, f"nhist {nhist}, B = {B}, {what}",
                                            use_slip=slip)
            if B == 8:
                rows[nhist] = {"use_slip": slip, "identical": list(NHIST_BATCHES),
                               "launch": v.forward_launch(nhist),
                               **kernel_work("viterbi_fwd", T=T_BLOCKS, B=B,
                                             nstate=nhist + 1),
                               "ms": cuda_ms(lambda: v.viterbi_scores_tm(
                                   lp, use_slip=slip), reps=5)}
            del lp, ties
    emit({"phase": "nhist", "T": T_BLOCKS, "B": 8, "rows": rows})
    return rows


def hand_tracebacks(T: int, B: int, nhist: int, gen) -> dict:
    """Transducer tracebacks [T, B, nhist+2] int16 and finals [B, nhist+2]
    built by hand on the card, each a case a backtrace can get wrong: every
    entry a stay (-1); random moves whose START column is START and whose
    best final is START (a START run over the whole row); random moves,
    best final END, END staying END over the last third and every history
    state moving to START at step T // 3 (a leading START and a trailing END
    run, each about a third of the row); finals tied at 0 and 1."""
    import torch

    nst2 = nhist + 2
    start, end = nhist, nhist + 1
    moves = torch.randint(-1, nhist, (T, B, nst2), generator=gen, device="cuda",
                          dtype=torch.int16)
    moves[:, :, start] = start
    final = torch.randn((B, nst2), generator=gen, device="cuda")
    start_final = final.clone()
    start_final[:, start] = 1e3
    runs = moves.clone()
    runs[T // 3, :, :nhist] = start
    runs[2 * T // 3:, :, end] = end
    runs[2 * T // 3 - 1, :, end] = 5 % nhist
    end_final = final.clone()
    end_final[:, end] = 1e3
    ties = torch.randint(0, 2, (B, nst2), generator=gen, device="cuda").float()
    return {"all stay": (final, torch.full_like(moves, -1)),
            "START run over the whole row": (start_final, moves),
            "leading START and trailing END runs": (end_final, runs),
            "tied finals": (ties, moves)}


def check_backtraces() -> dict:
    """The transducer backtrace where its ring and its segments can go
    wrong: the forward and backtrace kernels against their twins at
    STITCH_SHAPE and, at B = 8, at each T of BT_STEPS (T_BLOCKS + 1 is no
    multiple of a chunk of the ring) on seeded log posteriors; then the
    backtrace alone on hand_tracebacks of T_BT_HAND steps at every B of
    BT_BATCHES and nhist of NHIST_CASES (one pass a row at B = 64 and 256,
    segments at B <= 8). Paths and scores identical. The twins are not
    timed here."""
    import torch

    from scrappie_torch.ops import viterbi as v

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 94)
    shapes = [STITCH_SHAPE] + [(T, 8) for T in BT_STEPS]
    for T, B in shapes:
        lp, _ = seeded_logposts((T, B, 1025), gen)
        check_forward_and_backtrace(lp, f"T = {T}, B = {B}")
        del lp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    segments, names = {}, []
    for nhist, _slip in NHIST_CASES:
        for B in BT_BATCHES:
            cases = hand_tracebacks(T_BT_HAND, B, nhist, gen)
            for what, (final, tb) in cases.items():
                sk, pk = v.viterbi_backtrace_tm(final, tb)
                sp, pp = v.viterbi_backtrace_tm_plain(final, tb)
                sync()
                case = f"{what}, nhist {nhist}, B = {B}"
                require(torch.equal(pk, pp), f"viterbi_backtrace path identical ({case})")
                require(torch.equal(sk, sp), f"viterbi_backtrace score identical ({case})")
            segments[f"nhist {nhist}, B = {B}"] = v.backtrace_segments(
                T_BT_HAND, B, nhist + 2, sms)
            names = list(cases)
            del cases
    out = {"forward_and_backtrace": [f"T = {T}, B = {B}" for T, B in shapes],
           "hand_built": names, "T": T_BT_HAND,
           "segments": segments}
    emit({"phase": "backtrace_edges", "identical": True, **out,
          "seconds": round(time.perf_counter() - t0, 3)})
    return out


def forward_scaling(card: str) -> dict:
    """The forward at nhist 1024 on random and integer log posteriors, at
    T_BLOCKS blocks and each of FWD_BATCHES and at STITCH_SHAPE: its ms
    (CUDA events, median of 5) and us a step. Phase nhist holds it to the
    twin at these batches."""
    import torch

    from scrappie_torch.ops import viterbi as v

    gen = torch.Generator(device="cuda").manual_seed(SEED + 96)
    rows = {}
    for T, B in [(T_BLOCKS, b) for b in FWD_BATCHES] + [STITCH_SHAPE]:
        for what, lp in zip(("random", "integer"), seeded_logposts((T, B, 1025), gen)):
            ms = cuda_ms(lambda: v.viterbi_scores_tm(lp), reps=5)
            rows[f"B = {B}, T = {T}, {what}"] = {"ms": ms, "us_per_step": ms * 1e3 / T}
            del lp
    emit({"phase": "scaling", "path": "viterbi forward", "nhist": 1024,
          "launch": v.forward_launch(1024), "rows": rows, "card": card})
    return rows


def synthetic_reads() -> list:
    """NREADS seeded reads of READ_LEN samples."""
    import numpy as np

    from scrappie_torch.parallel.runner import RawSignal

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(READ_LEN[0], READ_LEN[1] + 1, NREADS)
    return [RawSignal(synthetic_signal(int(n), rng), uuid=f"read{i:02d}")
            for i, n in enumerate(lengths)]


def drive_engine(card: str, phase: str, reads: list, model: str, runs,
                 kernels: dict, extra=None, **engine_kw) -> tuple[dict, dict]:
    """BasecallEngine(model, device="cuda", **engine_kw) on the reads in
    each (mode, homopolymer) of runs, after a warm-up of each: every read
    must have a sequence and each run must launch kernels[mode]; then the
    shortest read against the port's CPU run of the same engine.
    extra(results, row) adds fields to a run's line. Returns the launch
    counts of all the runs (set to 0 just before them) and each run's
    results."""
    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.seqcompare import edit_distance, within_flip_rule
    from scrappie_torch.utils.tracing import Stage

    lengths = [len(r.raw) for r in reads]
    nsample = sum(lengths)
    engines = {mode: BasecallEngine(model, device="cuda", mode=mode, **engine_kw)
               for mode in dict.fromkeys(mode for mode, _ in runs)}
    # warm up each path once (cuBLAS / cuDNN handles, allocator)
    for mode, hp in runs:
        engines[mode].basecall_signals(reads[:1], homopolymer=hp)

    ops.reset_launches()
    results = {}
    for mode, hp in runs:
        before = dict(ops.LAUNCHES)
        engines[mode].stage = Stage()
        t0 = time.perf_counter()
        res = engines[mode].basecall_signals(reads, homopolymer=hp)
        seconds = time.perf_counter() - t0
        require(all(r.sequence for r in res), f"{phase} {mode}/{hp}: every read called")
        launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        for name in kernels[mode]:
            require(launched[name] > 0,
                    f"kernel {name} launched on {phase} {mode} ({launched[name]})")
        for name in BACKWARD_KERNELS:
            require(launched[name] == 0, f"no backward kernel {name} on "
                                         f"{phase} {mode} ({launched[name]})")
        results[(mode, hp)] = res
        row = {"phase": phase, "mode": mode, "homopolymer": hp,
               "reads": len(res), "samples": nsample, "seconds": round(seconds, 4),
               "samples_per_s": round(nsample / seconds, 1),
               "bases": sum(len(r.sequence) for r in res), "launches": launched,
               "stages": engines[mode].stage.report(), "card": card}
        if extra is not None:
            row.update(extra(res, row))
        emit(row)
    launches = dict(ops.LAUNCHES)

    short = sorted(range(len(reads)), key=lambda i: lengths[i])[:1]
    for mode, hp in runs:
        cpu = BasecallEngine(model, device="cpu", mode=mode, **engine_kw)
        cres = cpu.basecall_signals([reads[i] for i in short], homopolymer=hp)
        for i, c in zip(short, cres):
            g = results[(mode, hp)][i].sequence
            dist = 0 if g == c.sequence else edit_distance(g, c.sequence)
            emit({"phase": "cpu_vs_cuda", "path": phase, "mode": mode,
                  "homopolymer": hp, "read": reads[i].uuid, "bases": len(g),
                  "edit_distance": dist})
            require(within_flip_rule(g, c.sequence),
                    f"{phase} {mode}/{hp} {reads[i].uuid}: CUDA and CPU calls agree")
    return launches, results


def main_path(card: str, reads: list) -> dict:
    """BasecallEngine("rgrgr_r94") on the card in fast and both stitch
    modes."""
    return drive_engine(card, "main_path", reads, "rgrgr_r94", RUNS,
                        TRANSDUCER_KERNELS)[0]


def host_native(card: str, reads: list) -> None:
    """The port's C++ host library (phase host_native): its build seconds,
    then each of its functions against its Python twin, bit for bit, on
    what the main paths hand it from the reads: detect_events on each
    read's trimmed signal (the events engine), find_runs on the rgrgr
    stitch "mean" paths, the dwell overlapper on the events paths; each
    function's host seconds in the library and in the twin. The inputs are
    recorded from one engine call of each path on the card."""
    from scrappie_torch.native import bindings
    from scrappie_torch.native import build as native_build
    from scrappie_torch.parallel import runner
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.post import homopolymer
    from scrappie_torch.signal import events

    t0 = time.perf_counter()
    built = not native_build.library_path().exists()
    bindings.library()
    build_s = time.perf_counter() - t0

    calls = {"detect_events": [], "find_runs": [], "dwell_overlapper": []}
    patched = ((runner, "detect_events", "detect_events"),
               (homopolymer, "find_runs", "find_runs"),
               (homopolymer, "dwell_corrected_overlapper", "dwell_overlapper"))

    def recording(name, fn):
        def record(*args):
            # copies: homopolymer_path rewrites its path after find_runs
            calls[name].append([a.copy() if hasattr(a, "copy") else a
                                for a in args])
            return fn(*args)
        return record

    originals = [getattr(mod, attr) for mod, attr, _ in patched]
    try:
        for (mod, attr, name), fn in zip(patched, originals):
            setattr(mod, attr, recording(name, fn))
        BasecallEngine("rgrgr_r94", device="cuda", mode="stitch").basecall_signals(
            reads, homopolymer="mean")
        BasecallEngine("nanonet_events", device="cuda", mode="stitch").basecall_signals(
            reads)
    finally:
        for (mod, attr, _), fn in zip(patched, originals):
            setattr(mod, attr, fn)
    require(len(calls["detect_events"]) == len(reads), "host_native: detect_events "
            f"called once a read ({len(calls['detect_events'])})")
    require(calls["find_runs"] and calls["dwell_overlapper"],
            "host_native: find_runs and the dwell overlapper called")

    pairs = {
        "detect_events": (events.detect_events, events.detect_events_python,
                          lambda et: et.event.tobytes()),
        "find_runs": (homopolymer.find_runs, homopolymer.find_runs_python,
                      lambda runs: runs),
        "dwell_overlapper": (homopolymer.dwell_corrected_overlapper,
                             homopolymer.dwell_corrected_overlapper_python,
                             lambda seq: seq),
    }
    seconds, sizes = {}, {}
    for name, (lib_fn, twin_fn, key) in pairs.items():
        t0 = time.perf_counter()
        ours = [key(lib_fn(*args)) for args in calls[name]]
        t_lib = time.perf_counter() - t0
        t0 = time.perf_counter()
        twins = [key(twin_fn(*args)) for args in calls[name]]
        t_twin = time.perf_counter() - t0
        differ = sum(a != b for a, b in zip(ours, twins))
        require(differ == 0, f"host_native: {name} equals its twin bit for bit "
                             f"({differ} of {len(ours)} calls differ)")
        seconds[name] = {"library": t_lib, "twin": t_twin}
        sizes[name] = {"calls": len(ours),
                       "entries": sum(len(args[0].trimmed) if name == "detect_events"
                                      else len(args[0]) for args in calls[name])}
    emit({"phase": "host_native", "library": native_build.library_path().name,
          "built": built, "build_s": build_s, "bit_for_bit": True,
          "inputs": sizes, "seconds": seconds, "card": card})


def profile_trace(card: str, reads: list) -> None:
    """One rgrgr_r94 fast engine call on the card under utils/tracing.profile
    (phase profile_trace): the Chrome trace it writes must name the GRU
    recurrence kernel and the engine's decode_fused stage."""
    import shutil

    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.tracing import profile

    eng = BasecallEngine("rgrgr_r94", device="cuda", mode="fast")
    eng.basecall_signals(reads[:1])
    trace_dir = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        with profile(trace_dir):
            eng.basecall_signals(reads[:4])
        seconds = time.perf_counter() - t0
        traces = list(trace_dir.glob("*.json"))
        require(len(traces) == 1, f"profile wrote one trace ({traces})")
        nbytes = traces[0].stat().st_size
        trace = json.loads(traces[0].read_text())["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    kernels = [e["name"] for e in trace if e.get("cat") == "kernel"]
    spans = {e["name"] for e in trace if e.get("cat") == "user_annotation"}
    require(any("gru_recurrence_kernel" in k for k in kernels),
            "the profile trace names gru_recurrence_kernel")
    require("decode_fused" in spans,
            f"the profile trace names the engine's stages ({sorted(spans)})")
    emit({"phase": "profile_trace", "seconds": seconds, "trace_bytes": nbytes,
          "kernel_events": len(kernels),
          "gru_recurrence_kernel": sum("gru_recurrence_kernel" in k for k in kernels),
          "stages": sorted(spans), "card": card})


def throughput(net, card: str) -> None:
    """The fused path at B = 64 chunks of 10 000 samples."""
    import numpy as np
    import torch

    from scrappie_torch.ops.pipeline import rgrgr_features_tm

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
        breakdown = {"conv+gru x5": feats,
                     **decode_breakdown(x, p["FF_W"], p["FF_b"])}
    emit({"phase": "throughput", "path": "fused", "B": B, "chunk": CHUNK,
          "ms": total, "samples_per_s": B * CHUNK / (total / 1e3),
          "breakdown_ms": breakdown, "card": card})


def decode_breakdown(x, W, b, weights=None) -> dict:
    """The fast paths' decode stage by stage on features x (K members'
    with weights): the head kernel, the Viterbi forward and the backtrace
    (CUDA events, median of 5)."""
    from scrappie_torch.ops.viterbi import (head_logpost_tm, viterbi_backtrace_tm,
                                            viterbi_scores_tm)

    lp = head_logpost_tm(x, W, b, weights)
    final, tb = viterbi_scores_tm(lp)
    return {"head": cuda_ms(lambda: head_logpost_tm(x, W, b, weights), reps=5),
            "viterbi forward": cuda_ms(lambda: viterbi_scores_tm(lp), reps=5),
            "backtrace": cuda_ms(lambda: viterbi_backtrace_tm(final, tb), reps=5)}


def device_activity(prof) -> tuple[float, list, list]:
    """Device busy seconds (the union of the intervals of the device's own
    events: kernels and copies), the six kernels or copies with the most
    device time, as [name, ms, count], and the backtraces' kernels (names
    with "backtrace" or "_bt_") the same way. CPU ops, which carry their
    children's kernel time, and user annotation ranges on the device
    timeline, which span whole stages, are left out, so nothing is counted
    twice."""
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
    ranked = sorted(per_name.items(), key=lambda kv: kv[1][0], reverse=True)
    back = [[name[:60], ms, n] for name, (ms, n) in ranked
            if "backtrace" in name or "_bt_" in name]
    return busy_us / 1e6, [[name[:60], ms, n] for name, (ms, n) in ranked[:6]], back


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
    busy, top, back = device_activity(prof)
    emit({"phase": "profile", "run": label, "wall_s": wall, "device_busy_s": busy,
          "idle_share": 1.0 - busy / wall, "top_device_ms": top,
          "backtrace_device_ms": back, "card": card})


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


def crf_sets(rnet, T: int, rng) -> dict:
    """The CRF checks' transition sets, [T, max(CRF_BATCHES), 25] on the
    card: the rnnrf head before and after globalnorm on seeded signals of
    2T samples, integer transitions in {-3..0} (ties at almost every step),
    the head with an emit bias, and the head whose last quarter (at least
    one block) is the stitch's neutral padding (-1e30 into the emitting
    states, 0 into blank: parallel/runner._gather_decode_crf)."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import feedforward, globalnorm_tm
    from scrappie_torch.ops.crf import add_emit_bias
    from scrappie_torch.ops.pipeline import rnnrf_features_tm

    B, p = max(CRF_BATCHES), rnet.params
    sig = torch.as_tensor(rng.standard_normal((B, 2 * T, 1)).astype(np.float32),
                          device=rnet.device)
    # 64 rows a pass, as the fused path takes them (at T = 31 744 the
    # projection of 256 rows would pass 2^31 elements)
    x = torch.cat([rnnrf_features_tm(p, sig[i:i + 64], rnet.conv_activation,
                                     rnet.stride) for i in range(0, B, 64)], dim=1)
    require(x.shape == (T, B, 96), f"rnnrf features shape {tuple(x.shape)}")
    head = globalnorm_tm(x, p["FF_W"], p["FF_b"])
    padded = head.clone()
    npad = max(1, T // 4)
    padded[T - npad:] = NEUTRAL
    padded[T - npad:, :, 20:] = 0.0
    return {"head before globalnorm": feedforward(x, p["FF_W"], p["FF_b"]),
            "head": head,
            "integer transitions": torch.as_tensor(
                rng.integers(-3, 1, (T, B, 25)).astype(np.float32),
                device=rnet.device),
            f"head, emit bias {EMIT_BIAS}": add_emit_bias(head, EMIT_BIAS),
            "head, stitch padding": padded}


def check_crf(sets: dict) -> dict:
    """The three CRF kernels against their twins on each set of
    transitions [T, max(CRF_BATCHES), 25], at every B of CRF_BATCHES (the
    kernel on the set's first B rows): forward tracebacks and finals,
    backtrace paths and scores identical, the partition function within
    PARTITION_RTOL. The twins, loops over T, run once on all sets' rows
    side by side; every row is independent of the others."""
    import torch

    from scrappie_torch.ops import crf as c

    nrow = max(CRF_BATCHES)
    every = torch.cat(list(sets.values()), dim=1)
    fp, tbp = c.crf_viterbi_scores_tm_plain(every)
    sp, pp = c.crf_backtrace_tm_plain(fp, tbp)
    zp = c.crf_partition_tm_plain(every)
    gen = torch.Generator(device=every.device).manual_seed(SEED + 12)
    g_every = torch.randn(every.shape[1], generator=gen, device=every.device)
    postp = c.crf_posterior_tm_plain(every)
    gradp = c.crf_partition_grad_tm_plain(every, g_every)
    errs = {"crf_fwd": 0.0, "crf_backtrace": 0.0, "crf_partition": 0.0,
            "crf_partition_rel": 0.0, "crf_posterior": 0.0,
            "crf_partition_grad": 0.0}
    for i, (what, trans_all) in enumerate(sets.items()):
        for B in CRF_BATCHES:
            case = f"{what}, T = {trans_all.shape[0]}, B = {B}"
            rows = slice(i * nrow, i * nrow + B)
            trans = trans_all[:, :B].contiguous()
            fk, tbk = c.crf_viterbi_scores_tm(trans)
            sk, pk = c.crf_backtrace_tm(fk, tbk)
            zk = c.crf_partition_tm(trans)
            sync()
            require(torch.equal(tbk, tbp[:, :, rows]),
                    f"crf_fwd traceback identical ({case})")
            require(torch.equal(fk, fp[rows]), f"crf_fwd final identical ({case})")
            require(torch.equal(pk, pp[rows]), f"crf_backtrace path identical ({case})")
            require(torch.equal(sk, sp[rows]), f"crf_backtrace score identical ({case})")
            require(bool(torch.isfinite(zk).all()), f"crf_partition finite ({case})")
            # Relative to the magnitude the recursion carries, sum_t max
            # |trans| over the moves that are possible (a neutral block's
            # -1e30 adds nothing to the scores): that is |logZ| for raw
            # transitions, while after globalnorm logZ is about 0 and the
            # error of its T-step sum is all there is.
            live = torch.where(trans > NEUTRAL / 10, trans.abs(), 0.0)
            scale = torch.maximum(zp[rows].abs(), live.amax(-1).sum(0)).clamp(min=1.0)
            rel = float(((zk - zp[rows]).abs() / scale).max())
            require(rel <= PARTITION_RTOL,
                    f"crf_partition rel err {rel} <= {PARTITION_RTOL} ({case})")
            for name, err in (("crf_fwd", (fk - fp[rows]).abs().max()),
                              ("crf_backtrace", (pk - pp[rows]).abs().max()),
                              ("crf_partition", (zk - zp[rows]).abs().max()),
                              ("crf_partition_rel", rel)):
                errs[name] = max(errs[name], float(err))
            if B not in FWDBWD_BATCHES:
                continue
            g = g_every[rows].contiguous()
            post = c.crf_posterior_tm(trans)
            grad = c.crf_partition_grad_tm(trans, g)
            sync()
            perr = float((post - postp[rows]).abs().max())
            gerr = float((grad - gradp[:, rows]).abs().max())
            gmax = max(1.0, float(g.abs().max()))
            require(perr <= FWDBWD_ATOL,
                    f"crf_posterior max abs err {perr} <= {FWDBWD_ATOL} ({case})")
            require(float((post.sum(-1) - 1).abs().max()) <= FWDBWD_ATOL,
                    f"crf_posterior rows sum to 1 ({case})")
            require(gerr <= FWDBWD_ATOL * gmax, f"crf_partition_grad max abs err "
                                               f"{gerr} <= {FWDBWD_ATOL} * {gmax} ({case})")
            edges = c.crf_partition_grad_tm(trans, torch.ones_like(g)).sum(-1)
            require(float((edges - 1).abs().max()) <= FWDBWD_ATOL,
                    f"crf_partition_grad: a block's edge marginals sum to 1 ({case})")
            errs["crf_posterior"] = max(errs["crf_posterior"], perr)
            errs["crf_partition_grad"] = max(errs["crf_partition_grad"], gerr / gmax)
    return errs


def check_crf_batch(sets: dict) -> dict:
    """parallel/runner's batched posterior, as the engine's rnnrf qualities
    call it, on reads of CRF_BATCH_READS blocks (row i of the head set cut
    to the i-th length) and one of the integer set (ties): all of them in
    one launch (posterior_crf_padded) and in the engine's launches
    (posterior_crf_batch, one a group of crf_groups), each read's rows
    equal to its own posterior_crf call bit for bit both ways, and within
    FWDBWD_ATOL of the twin run on the padded batch."""
    import numpy as np
    import torch

    from scrappie_torch import ops
    from scrappie_torch.decode.crf import posterior_crf
    from scrappie_torch.ops.crf import crf_posterior_tm_plain
    from scrappie_torch.parallel.chunk import neutral_pad_crf
    from scrappie_torch.parallel.runner import (crf_groups,
                                                posterior_crf_batch,
                                                posterior_crf_padded)

    n = len(CRF_BATCH_READS)
    head = sets["head"][:, :n].cpu().numpy()
    ties = sets["integer transitions"][:, 0].cpu().numpy()
    reads = ([head[:T, i] for i, T in enumerate(CRF_BATCH_READS)]
             + [ties[: CRF_BATCH_READS[2]]])
    groups = crf_groups([len(r) for r in reads])
    out = {}
    for label, fn, want in (("padded", posterior_crf_padded, 1),
                            ("batch", posterior_crf_batch, len(groups))):
        before = ops.LAUNCHES["crf_posterior"]
        out[label] = fn(reads, device="cuda")
        launched = ops.LAUNCHES["crf_posterior"] - before
        require(launched == want,
                f"{fn.__name__}: {want} launches ({launched})")
    T = max(len(r) for r in reads)
    twin = crf_posterior_tm_plain(torch.as_tensor(
        np.stack([neutral_pad_crf(r, T) for r in reads], 1), device="cuda"))
    err = 0.0
    for i, (r, post, grouped) in enumerate(zip(reads, out["padded"],
                                               out["batch"])):
        require(post.shape == (len(r) + 1, 5), f"batched posterior {i} shape")
        own = posterior_crf(r, device="cuda")
        require(np.array_equal(post, own) and np.array_equal(grouped, own),
                f"batched posterior of a {len(r)}-block read: its own call's")
        err = max(err, float(np.abs(post - twin[i, : len(r) + 1].cpu().numpy()).max()))
    require(err <= FWDBWD_ATOL, f"batched posterior max abs err {err} <= "
                                f"{FWDBWD_ATOL}")
    return {"batched_reads": [len(r) for r in reads], "batched_identical": True,
            "batched_groups": groups, "batched_max_abs_err": err}


def check_crf_maps(T: int, gen) -> list:
    """The CRF backtrace against its twin on tracebacks built by hand,
    [T, 5, max(CRF_BATCHES)], at every B of CRF_BATCHES (the kernel on the
    first B rows): every byte 0 (a constant map) and tb[t, s, b] = s (the
    identity), with seeded finals; paths and scores identical."""
    import torch

    from scrappie_torch.ops import crf as c

    nrow = max(CRF_BATCHES)
    final = torch.randn((nrow, 5), generator=gen, device="cuda")
    maps = {"constant": torch.zeros((T, 5, nrow), dtype=torch.int8, device="cuda"),
            "identity": torch.arange(5, dtype=torch.int8, device="cuda")[None, :, None]
            .expand(T, 5, nrow).contiguous()}
    for what, tb in maps.items():
        sp, pp = c.crf_backtrace_tm_plain(final, tb)
        for B in CRF_BATCHES:
            sk, pk = c.crf_backtrace_tm(final[:B].contiguous(), tb[:, :, :B].contiguous())
            sync()
            case = f"{what} map, T = {T}, B = {B}"
            require(torch.equal(pk, pp[:B]), f"crf_backtrace path identical ({case})")
            require(torch.equal(sk, sp[:B]), f"crf_backtrace score identical ({case})")
    return list(maps)


def check_crf_kernels(rnet) -> dict:
    """The CRF kernels against their twins at every T of CRF_STEPS and B of
    CRF_BATCHES on the five sets of crf_sets (one phase line a T; at
    CRF_STITCH phase crf_assoc holds them to the associative scan); then
    their times and their twins' at T_CRF and B = 8 and 64 (CUDA events;
    fewer repeats for the twins, launch-bound loops over T), and the
    kernels' alone at CRF_STITCH, whose twins are not timed (a loop of
    31 744 steps), with the SM clock read just after. Returns the B = 64
    line's kernels, with the largest errors of the checks at T_CRF; at
    T_CRF also the batched posterior (check_crf_batch)."""
    import numpy as np

    from scrappie_torch.ops import crf as c

    import torch

    rng = np.random.default_rng(SEED + 10)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    table, inputs = {}, {}
    for T in CRF_STEPS + (CRF_STITCH[0],):
        t0 = time.perf_counter()
        sets = crf_sets(rnet, T, rng)
        for shape in ((T_CRF, 8), (T_CRF, 64), CRF_STITCH):
            if shape[0] == T:
                inputs[shape] = [sets[k][:, :shape[1]].contiguous()
                                 for k in ("head before globalnorm", "head")]
        if T not in CRF_STEPS:
            del sets
            continue
        errs = check_crf(sets)
        maps = check_crf_maps(T, gen)
        batched = check_crf_batch(sets) if T == T_CRF else {}
        emit({"phase": "crf_kernels", "checked_T": T, "B": list(CRF_BATCHES),
              "checked_on": list(sets), "backtrace_checked_on": maps,
              "identical": True,
              "partition_max_rel_err": errs["crf_partition_rel"],
              "fwdbwd_B": list(FWDBWD_BATCHES),
              "posterior_max_abs_err": errs["crf_posterior"],
              "partition_grad_max_abs_err_per_g": errs["crf_partition_grad"],
              **batched, "seconds": round(time.perf_counter() - t0, 3)})
        if T == T_CRF:
            table = {name: {"max_abs_err": errs[name]}
                     for name in ("crf_fwd", "crf_backtrace", "crf_partition",
                                  "crf_posterior", "crf_partition_grad")}
            table["crf_partition"]["max_rel_err"] = errs["crf_partition_rel"]
        del sets
    for (T, B), (raw, head) in inputs.items():
        fk, tbk = c.crf_viterbi_scores_tm(head)
        timed = {"crf_fwd": (lambda: c.crf_viterbi_scores_tm(head),
                             lambda: c.crf_viterbi_scores_tm_plain(head)),
                 "crf_backtrace": (lambda: c.crf_backtrace_tm(fk, tbk),
                                   lambda: c.crf_backtrace_tm_plain(fk, tbk)),
                 "crf_partition": (lambda: c.crf_partition_tm(raw),
                                   lambda: c.crf_partition_tm_plain(raw)),
                 "crf_posterior": (lambda: c.crf_posterior_tm(head),
                                   lambda: c.crf_posterior_tm_plain(head)),
                 "crf_partition_grad": (
                     lambda: c.crf_partition_grad_tm(raw, ones),
                     lambda: c.crf_partition_grad_tm_plain(raw, ones))}
        ones = torch.ones(B, device=head.device)
        out = {name: dict(kernel_work(name, T=T, B=B)) for name in timed}
        # the backtrace's own floor: its traceback bytes read once
        out["crf_backtrace"]["stream_floor_ms"] = tbk.numel() / PEAK_BYTES_PER_S * 1e3
        for name, (kernel, plain) in timed.items():
            out[name]["ms"] = cuda_ms(kernel)
            out[name]["us_per_step"] = out[name]["ms"] * 1e3 / T
        mhz = int(smi("clocks.sm", "csv,noheader,nounits"))
        for name, (kernel, plain) in timed.items():
            out[name]["cycles_per_step"] = out[name]["us_per_step"] * mhz
            out[name]["plain_ms"] = (cuda_ms(plain, **TWIN_REPS)
                                     if (T, B) != CRF_STITCH else None)
        emit({"phase": "crf_kernels", "B": B, "T": T, "timed_on": "head "
              "(partition and its gradient: head before globalnorm)",
              "sm_clock_mhz": mhz,
              "kernels": out})
        if (T, B) == (T_CRF, 64):
            for name in timed:
                table[name].update(out[name])
    return table


def main_path_rnnrf(card: str, reads: list) -> tuple[dict, dict]:
    """BasecallEngine("rnnrf_r94") on the card in fast and stitch mode."""
    return drive_engine(card, "main_path_rnnrf", reads, "rnnrf_r94",
                        (("fast", None), ("stitch", None)), RNNRF_KERNELS)


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


def check_lstm_routes(x, wF, wB, what: str) -> tuple[float, float]:
    """A stage's two LSTM layers (wF, wB: (iW, b, sW, peep)) on x through
    the pair route and each through the single-direction route, against
    their twins -> (largest error of the layers, of the pair), both within
    LSTM_ATOL."""
    import torch

    from scrappie_torch.ops import lstm as L

    twin = L.lstm_pair_tm_plain(x, wF, wB)
    pair = L.lstm_pair_tm(x, wF, wB)
    layers = (L.lstm_layer_tm(x, *wF), L.lstm_layer_tm(x, *wB, reverse=True))
    sync()
    errs = []
    for route, got in (("layer", layers), ("pair", pair)):
        for d, h, t in zip("FB", got, twin):
            require(bool(torch.isfinite(h).all()), f"lstm {route} {d} {what} finite")
        errs.append(max(float((h - t).abs().max()) for h, t in zip(got, twin)))
        require(errs[-1] <= LSTM_ATOL,
                f"lstm {route} {what} max abs err {errs[-1]} <= {LSTM_ATOL}")
    return errs[0], errs[1]


def check_lstm_kernel(enet, B: int) -> tuple[dict, dict]:
    """The LSTM routes against their twins on the events network's two
    stages (C = 12, then 96; S = 96), on the features a chunk of B x
    T_EVENTS events gives, and at S = S_SMALL on seeded weights (C = 12
    and 96); then, per stage, the times of the recurrence kernel alone in
    one direction (the backward layer) and for the pair, beside their
    twins (median of 3, loops over T), of the layer and of the pair route,
    and of the projection at N = 4S and 8S beside torch.addmm. Last, the
    decode kernels against their twins on what the events path hands them:
    the fused head + Viterbi on the second stage's feedforward2_tanh output
    with FF3, the forward and backtrace on the FF3 head's log posterior.
    Returns the table's rows for the single-direction recurrence and the
    pair's, at C = 96."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import (feedforward2_tanh, robustlog,
                                          softmax_with_temperature, window)
    from scrappie_torch.nn.rnn import lstm_tm
    from scrappie_torch.ops import lstm as L
    from scrappie_torch.ops.pipeline import lstm_weights
    from scrappie_torch.ops.project import project_tm

    rng = np.random.default_rng(SEED + 20 + B)
    p = enet.params
    x = window(events_input(enet, B, rng), enet.winlen, 1).transpose(0, 1).contiguous()

    def f(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32),
                               device="cuda")

    small = {}
    for C in (12, 96):
        S = S_SMALL
        ws = [(f(C, 4 * S, scale=C ** -0.5), f(4 * S, scale=0.1),
               f(S, 4 * S, scale=S ** -0.5), f(3 * S, scale=0.3)) for _ in "FB"]
        small[C] = check_lstm_routes(f(T_EVENTS, B, C), *ws, f"S={S} C={C}")
    rows = {}
    for layer in (1, 2):
        C = x.shape[-1]
        wF, wB = (lstm_weights(p, d, layer) for d in "FB")
        S = wF[2].shape[0]
        err, pair_err = check_lstm_routes(x, wF, wB, f"stage {layer}")
        Wp, bp = torch.cat((wF[0], wB[0]), 1), torch.cat((wF[1], wB[1]))
        xproj, xpair = project_tm(x, wB[0], wB[1]), project_tm(x, Wp, bp)
        rows[layer] = {
            "C": C, "S": S, "max_abs_err": err, "pair_max_abs_err": pair_err,
            "recurrence_ms": cuda_ms(
                lambda: L.lstm_recurrence_cuda(xproj, *wB[2:], reverse=True)),
            "recurrence_plain_ms": cuda_ms(
                lambda: lstm_tm(xproj, *wB[2:], reverse=True), **TWIN_REPS),
            "recurrence": kernel_work("lstm_recurrence", T=T_EVENTS, B=B, S=S),
            "pair_recurrence_ms": cuda_ms(
                lambda: L.lstm_pair_recurrence_cuda(xpair, *wF[2:], *wB[2:])),
            "pair_recurrence_plain_ms": cuda_ms(
                lambda: (lstm_tm(xpair[..., :4 * S], *wF[2:]),
                         lstm_tm(xpair[..., 4 * S:], *wB[2:], reverse=True)),
                **TWIN_REPS),
            "pair_recurrence": kernel_work("lstm_recurrence", T=T_EVENTS, B=B,
                                           S=S, dirs=2),
            "layer_ms": cuda_ms(lambda: L.lstm_layer_tm(x, *wB, reverse=True)),
            "layer": kernel_work("lstm_layer", T=T_EVENTS, B=B, C=C, S=S),
            "pair_ms": cuda_ms(lambda: L.lstm_pair_tm(x, wF, wB)),
            "projection": check_projection(x, wB[0], wB[1]),
            "pair_projection": check_projection(x, Wp, bp)}
        hF, hB = L.lstm_pair_tm(x, wF, wB)
        x = feedforward2_tanh(hF, hB, p[f"FF{layer}_Wf"], p[f"FF{layer}_Wb"],
                              p[f"FF{layer}_b"])
    emit({"phase": "lstm_kernel", "B": B, "T": T_EVENTS, "stages": rows,
          "small_S": {"S": S_SMALL, "max_abs_err": {
              C: {"layer": e[0], "pair": e[1]} for C, e in small.items()}}})
    fused = check_fused(x, p["FF3_W"], p["FF3_b"], "events")
    route = check_fused(x, p["FF3_W"], p["FF3_b"], "events", route=True)
    lp = robustlog(softmax_with_temperature(x, p["FF3_W"], p["FF3_b"]),
                   1e-5).contiguous()
    check_forward_and_backtrace(lp, "events posterior")
    emit({"phase": "events_decode_kernels", "B": B, "T": T_EVENTS,
          "fused": fused, "head_route": route, "forward_backtrace": "identical"})
    # the table's rows: the C = 96 stage, the errors of every check
    last = rows[2]
    errs = [r["max_abs_err"] for r in rows.values()] + [e[0] for e in small.values()]
    pair_errs = ([r["pair_max_abs_err"] for r in rows.values()]
                 + [e[1] for e in small.values()])
    single = {**last["recurrence"], "max_abs_err": max(errs),
              "ms": last["recurrence_ms"], "plain_ms": last["recurrence_plain_ms"],
              "layer_ms": last["layer_ms"], "layer_bound_ms": last["layer"]["bound_ms"]}
    pair = {**last["pair_recurrence"], "max_abs_err": max(pair_errs),
            "ms": last["pair_recurrence_ms"],
            "plain_ms": last["pair_recurrence_plain_ms"],
            "route_ms": last["pair_ms"]}
    return single, pair


def main_path_events(card: str, reads: list) -> dict:
    """BasecallEngine("nanonet_events") on the card in fast and stitch
    mode; each mode's kernels must have launched in its own run, and no
    LSTM layer outside the pair route."""

    def extra(res, row):
        nevent = sum(r.nblock for r in res)
        stages = row["stages"]
        return {"events": nevent,
                "events_per_s": round(nevent / row["seconds"], 1),
                "detect_events_share": stages["detect_events"]["seconds"] / row["seconds"],
                "assemble_share": stages["assemble"]["seconds"] / row["seconds"]}

    launches = drive_engine(card, "main_path_events", reads, "nanonet_events",
                            (("fast", None), ("stitch", None)), EVENTS_KERNELS,
                            extra)[0]
    for name in ("lstm_layer", "lstm_layer_global"):
        require(launches[name] == 0,
                f"events path launched {name} ({launches[name]}), not lstm_pair")
    return launches


def throughput_events(enet, card: str, reads: list) -> None:
    """The events fused path at B = 64 chunks of T_EVENTS events, stage by
    stage; then the events engine in each mode under torch.profiler."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import feedforward2_tanh, window
    from scrappie_torch.ops.lstm import lstm_pair_tm
    from scrappie_torch.ops.pipeline import lstm_weights
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
            wF, wB = (lstm_weights(p, d, layer) for d in "FB")
            breakdown[f"lstm pair {layer}"] = cuda_ms(
                lambda: lstm_pair_tm(x, wF, wB), reps=5)
            h = lstm_pair_tm(x, wF, wB)
            ff = lambda: feedforward2_tanh(*h, p[f"FF{layer}_Wf"],
                                           p[f"FF{layer}_Wb"], p[f"FF{layer}_b"])
            breakdown[f"feedforward2_tanh {layer}"] = cuda_ms(ff, reps=5)
            x = ff()
        breakdown.update(decode_breakdown(x, p["FF3_W"], p["FF3_b"]))
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


def main_path_raw(card: str, reads: list) -> dict:
    """BasecallEngine("raw_r94") on the card in fast and both stitch
    modes."""
    return drive_engine(card, "main_path_raw", reads, "raw_r94", RUNS,
                        TRANSDUCER_KERNELS)[0]


def throughput_raw(card: str) -> None:
    """The raw_r94 fused path at B = 64 chunks of CHUNK samples, stage by
    stage (CUDA events, median of 5)."""
    import numpy as np
    import torch

    from scrappie_torch.nn.layers import feedforward2_tanh
    from scrappie_torch.models.forward import RawR94Model
    from scrappie_torch.ops.gru import gru_layer_tm
    from scrappie_torch.ops.pipeline import _conv_tm

    B = 64
    net = RawR94Model.from_registry("raw_r94", "cuda")
    p = net.params
    sig = torch.as_tensor(np.random.default_rng(SEED + 6).standard_normal(
        (B, CHUNK, 1)).astype(np.float32), device="cuda")
    breakdown = {}
    with torch.inference_mode():
        total = cuda_ms(lambda: net.basecall_fused(sig), reps=5)
        conv = lambda: _conv_tm(p, sig, "tanh", net.stride, "raw")
        breakdown["conv+tanh"] = cuda_ms(conv, reps=5)
        x = conv()
        for layer in (1, 2):
            h = {}
            for d in ("F", "B"):
                w = [p[f"gru{d}{layer}_{k}"] for k in ("iW", "b", "sW", "sW2")]
                breakdown[f"gru {d}{layer}"] = cuda_ms(
                    lambda: gru_layer_tm(x, *w, reverse=(d == "B")), reps=5)
                h[d] = gru_layer_tm(x, *w, reverse=(d == "B"))
            ff = lambda: feedforward2_tanh(h["F"], h["B"], p[f"FF{layer}_Wf"],
                                           p[f"FF{layer}_Wb"], p[f"FF{layer}_b"])
            breakdown[f"feedforward2_tanh {layer}"] = cuda_ms(ff, reps=5)
            x = ff()
        breakdown.update(decode_breakdown(x, p["FF3_W"], p["FF3_b"]))
    emit({"phase": "throughput_raw", "path": "fused", "B": B, "chunk": CHUNK,
          "blocks": x.shape[0], "ms": total,
          "samples_per_s": B * CHUNK / (total / 1e3), "breakdown_ms": breakdown,
          "card": card})


def main_path_ensemble(card: str, reads: list, rnnrf_results: dict) -> dict:
    """The ensembles through BasecallEngine on the card: rgrgr_r94 with
    rgrgr_r941 and rgrgr_r10 at 3:1:1 in fast and device-stitch mode, and
    the rnnrf_r94 self-ensemble (weights 1:1) in fast and stitch mode,
    whose calls must be the solo model's (rnnrf_results, from
    main_path_rnnrf on the same reads): the two halves of the weighted sum
    add up to the solo transitions exactly; then rgrgr_r94 with ENSEMBLE5
    (five members, 3:1:1:1:1) in fast mode, which the fused ensemble
    kernel could not take. Returns the 3:1:1 runs' launch counts."""
    runs = (("fast", "nochange"), ("stitch", "nochange"))
    launches = drive_engine(card, "main_path_ensemble", reads, "rgrgr_r94", runs,
                            ENSEMBLE_KERNELS, ensemble=ENSEMBLE)[0]
    drive_engine(card, "main_path_ensemble_k5", reads, "rgrgr_r94",
                 (("fast", "nochange"),), ENSEMBLE_KERNELS, ensemble=ENSEMBLE5)
    runs = (("fast", None), ("stitch", None))
    _, results = drive_engine(card, "main_path_rnnrf_self_ensemble", reads,
                              "rnnrf_r94", runs, RNNRF_KERNELS,
                              ensemble=("rnnrf_r94",), ensemble_weights=(1, 1))
    for run in runs:
        same = [a.sequence == b.sequence
                for a, b in zip(results[run], rnnrf_results[run])]
        require(all(same), f"rnnrf self-ensemble {run[0]}: the solo calls "
                           f"({sum(same)}/{len(same)})")
    return launches


def throughput_ensemble(card: str, reads: list) -> None:
    """The 3:1:1 ensemble's fused path at B = 64 chunks of CHUNK samples,
    stage by stage (CUDA events, median of 5); then its fast engine under
    torch.profiler."""
    import numpy as np
    import torch

    from scrappie_torch.ops.pipeline import (ensemble_basecall_fused,
                                             ensemble_features_tm,
                                             rgrgr_features_tm)
    from scrappie_torch.parallel.runner import BasecallEngine

    B = 64
    nets = ensemble_nets()
    params = [n.params for n in nets]
    acts = tuple(n.conv_activation for n in nets)
    w = ensemble_weights(len(nets))
    sig = torch.as_tensor(np.random.default_rng(SEED + 7).standard_normal(
        (B, CHUNK, 1)).astype(np.float32), device="cuda")
    breakdown = {}
    with torch.inference_mode():
        total = cuda_ms(lambda: ensemble_basecall_fused(
            params, w, sig, kinds=("rgrgr",) * len(nets), conv_activations=acts,
            stride=5), reps=5)
        for name, n in zip(("rgrgr_r94",) + ENSEMBLE, nets):
            breakdown[f"{name} conv+gru x5"] = cuda_ms(
                lambda: rgrgr_features_tm(n.params, sig, n.conv_activation,
                                          n.stride), reps=5)
        h, W, b = ensemble_features_tm(params, sig, kinds=("rgrgr",) * len(nets),
                                       conv_activations=acts, stride=5)
        breakdown.update(decode_breakdown(h, W, b, w))
        emit({"phase": "throughput_ensemble", "path": "fused", "K": len(nets),
              "B": B, "chunk": CHUNK, "ms": total,
              "samples_per_s": B * CHUNK / (total / 1e3),
              "breakdown_ms": breakdown, "card": card})
        eng = BasecallEngine("rgrgr_r94", device="cuda", mode="fast",
                             ensemble=ENSEMBLE)
        nsample = sum(len(r.raw) for r in reads)
        profiled(f"3:1:1 ensemble engine fast, batch {eng.batch_size}, "
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


def dtw_tie_case(npos: int, T: int, rng):
    """A DTW input where candidates tie: integer locs and signal, unit
    scales and one dwell for every position."""
    import numpy as np
    import torch

    params = np.zeros((npos, 3), np.float32)
    params[:, 0] = rng.integers(-2, 3, npos)
    sig = torch.as_tensor(rng.integers(-2, 3, T).astype(np.float32), device="cuda")
    return sig, params


def dtw_twin(args, viterbi: bool, device: str = "cpu"):
    """The DTW's twin in a worker process, on the host CPU or the card, on
    the host's copy of the inputs: (final, moves, end_src, seconds), on the
    host."""
    import torch

    from scrappie_torch.ops import dtw as d

    torch.set_num_threads(1)
    args = [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]
    t0 = time.perf_counter()
    out = d.squiggle_match_plain(*args, viterbi=viterbi)
    out = [None if o is None else o.cpu() for o in out]
    return (*out, time.perf_counter() - t0)


def submit_dtw_twins(pool, sig, params, viterbi: bool = True) -> dict:
    """Start the twin of one input on the pool, prob_back 0 and 0.1, on the
    host's copy of the inputs (match_inputs computes them on the host for
    both devices): Viterbi on the host CPU (the DP only adds, divides and
    takes maxima, so the host's twin is the card's bit for bit), or the
    forward variant on the card (its expf and log1pf are the kernel's)
    under the keys ("forward", prob_back)."""
    from scrappie_torch.decode.dtw import match_inputs

    jobs = {}
    for prob_back in (0.0, 0.1):
        args = (sig.cpu(), *match_inputs(params, 1.0, prob_back, "cpu"), prob_back,
                *DTW_OPTIONS.values())
        key = prob_back if viterbi else ("forward", prob_back)
        jobs[key] = pool.submit(dtw_twin, args, viterbi, "cpu" if viterbi else "cuda")
    return jobs


def check_dtw(sig, params, what: str, jobs: dict, clusters=()) -> dict:
    """The DTW kernel on the card against its twin, prob_back 0 and 0.1:
    Viterbi finals, moves and end sources identical to the host twin's
    (jobs, from submit_dtw_twins), and the walk kernel's path identical to
    the host walk's; forward finals within FORWARD_RTOL of the twin run on
    the card (jobs too), whose expf and log1pf are the kernel's (the
    host's differ by ulps, which a long read adds up). The kernel runs on
    DTW_CLUSTER CTAs
    and on each other cluster size in `clusters`. Returns the largest
    differences and the host twin's seconds for Viterbi with prob_back 0."""
    import torch

    from scrappie_torch.decode.dtw import match_inputs
    from scrappie_torch.ops import dtw as d

    out = {"max_abs_err": 0.0, "forward_rel_err": 0.0}
    for prob_back, viterbi in ((0.0, False), (0.1, False), (0.0, True), (0.1, True)):
        args = (sig, *match_inputs(params, 1.0, prob_back, "cuda"), prob_back,
                *DTW_OPTIONS.values())
        if viterbi:
            fp, mp, ep, seconds = jobs[prob_back].result()
            mp, ep = mp.cuda(), ep.cuda()
            if not prob_back:
                out["plain_s"] = seconds
        else:
            fp = jobs["forward", prob_back].result()[0]
        fp = fp.cuda()
        for k in (d.DTW_CLUSTER, *clusters):
            fk, mk, ek = d.squiggle_match_tm(*args, viterbi=viterbi, cluster=k)
            label = f"{what}, {k} CTAs, viterbi={viterbi}, prob_back={prob_back}"
            require(bool(torch.isfinite(fk).all()), f"dtw final finite ({label})")
            if viterbi:
                require(torch.equal(mk, mp), f"dtw moves identical ({label})")
                require(torch.equal(ek, ep), f"dtw end sources identical ({label})")
                require(torch.equal(fk, fp), f"dtw final identical ({label})")
                if k == d.DTW_CLUSTER:
                    pk = d.dtw_walk(fk, mk, ek)
                    pp = d.dtw_walk_plain(fk, mk, ek)
                    sync()
                    require(torch.equal(pk, pp), f"dtw_walk path identical ({label})")
                del mk
            else:
                rel = float(((fk - fp).abs() / fp.abs().clamp(min=1.0)).max())
                require(rel <= FORWARD_RTOL,
                        f"dtw forward final rel err {rel} <= {FORWARD_RTOL} ({label})")
                out["forward_rel_err"] = max(out["forward_rel_err"], rel)
            out["max_abs_err"] = max(out["max_abs_err"], float((fk - fp).abs().max()))
        if viterbi:
            del mp
    return out


def walk_plane(T: int, npos: int, rng, end_every: int = 300):
    """A hand-made DTW traceback for the walk: a seeded random path built
    backwards from the end state, each of its samples' move byte the move
    that leads to its earlier state. The end state stays, then jumps; from
    then on an END move at some forward state every end_every to 2
    end_every samples jumps to a far state (end_src; the DP writes END only
    at the end state, the walk reads it anywhere alike); among stays (90%)
    and steps, runs of 20 to 120 skips, excursions into the back state for
    0 to 400 samples, and stays of 300 to 700 samples, longer than a window
    of the walk; the first T / 20 samples a run of START. Returns (final,
    end_src, path) as numpy arrays and the path's (rows, states, moves):
    the bytes to write into a plane of random moves (forward 0-5, back
    0-1)."""
    import numpy as np

    nf = npos + 2
    final = rng.standard_normal(2 * npos + 2).astype(np.float32)
    final[nf - 1] = final[nf - 2] + 1.0
    end_src = rng.integers(1, npos, T).astype(np.int32)
    path = np.zeros(T, np.int32)
    rows, states, codes = [], [], []
    s, st = T - 1, nf - 1
    path[s] = st
    lead = T // 20
    next_end = s - 2 * end_every

    def put(code, prev):
        nonlocal s, st
        rows.append(s)
        states.append(st)
        codes.append(code)
        s -= 1
        st = prev
        path[s] = st

    while s > 0:
        if s <= lead:
            if st >= nf:
                put(1, st - nf + 2)
            else:
                put(3 if st else 0, 0)
        elif st == nf - 1:
            if s > next_end + end_every:
                put(0, st)
            else:
                end_src[s] = rng.integers(npos // 2, npos)
                put(4, int(end_src[s]))
        elif s <= next_end or st < 8:
            end_src[s] = rng.integers(npos // 3, npos)
            next_end = s - end_every - int(rng.integers(0, end_every))
            put(4, int(end_src[s]))
        else:
            u = rng.random()
            if u < 0.002:
                for _ in range(int(rng.integers(20, 120))):
                    if s <= lead or st < 4:
                        break
                    put(2, st - 2)
            elif u < 0.004 and 2 <= st <= npos:
                c = st
                put(5, nf + c - 2)
                for _ in range(int(rng.integers(0, 400))):
                    if s <= lead:
                        break
                    put(0, st)
                if s > lead:
                    put(1, c)
            elif u < 0.005:
                for _ in range(int(rng.integers(300, 700))):
                    if s <= lead:
                        break
                    put(0, st)
            elif u < 0.1:
                put(1, st - 1)
            else:
                put(0, st)
    return final, end_src, path, (np.array(rows), np.array(states), np.array(codes))


def check_walk_planes() -> dict:
    """The DTW walk kernel on WALK_PLANES' hand-made planes (walk_plane's
    paths in planes of seeded random moves, made on the card, each at its
    offset from a 16-byte boundary): its path identical to dtw_walk_plain's
    and to the path the plane was made from; with each plane's END jumps,
    back-state samples, skips and START run, and the walk's time (median
    of 5)."""
    import numpy as np
    import torch

    from scrappie_torch.ops import dtw as d

    rng = np.random.default_rng(SEED + 45)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    out = {}
    for T, npos, offset in WALK_PLANES:
        final, end_src, path, (rows, states, codes) = walk_plane(T, npos, rng)
        nf, nstate = npos + 2, 2 * npos + 2
        buf = torch.empty(T * nstate + offset + 16, dtype=torch.uint8, device="cuda")
        start = offset + (-buf.data_ptr()) % 16
        moves = buf[start:start + T * nstate].view(T, nstate)
        moves[:, :nf] = torch.randint(0, 6, (T, nf), dtype=torch.uint8,
                                      device="cuda", generator=gen)
        moves[:, nf:] = torch.randint(0, 2, (T, npos), dtype=torch.uint8,
                                      device="cuda", generator=gen)
        moves[torch.as_tensor(rows, device="cuda"),
              torch.as_tensor(states, device="cuda")] = torch.as_tensor(
                  codes.astype(np.uint8), device="cuda")
        fk = torch.as_tensor(final, device="cuda")
        ek = torch.as_tensor(end_src, device="cuda")
        label = f"{T} x {npos}, offset {offset}"
        require(moves.data_ptr() % 16 == offset, f"the plane's offset ({label})")
        pk = d.dtw_walk(fk, moves, ek)
        pp = d.dtw_walk_plain(fk, moves, ek)
        sync()
        require(np.array_equal(pp.cpu().numpy(), path),
                f"the hand-made plane's walk takes its path ({label})")
        require(torch.equal(pk, pp), f"dtw_walk path identical on a hand-made plane ({label})")
        out[label] = {
            "ms": cuda_ms(lambda: d.dtw_walk(fk, moves, ek), reps=5),
            "end_jumps": int((codes == 4).sum()), "skips": int((codes == 2).sum()),
            "back_samples": int((path >= nf).sum()),
            "start_run": int((path == 0).sum()), "row_bytes": nstate}
        del buf, moves
    return out


def check_dtw_kernel(card: str) -> tuple[dict, dict]:
    """The DTW kernels against their twins: the cluster kernel at a small
    size, on tied inputs and at the main path's positions (MAP_BASES,
    DTW_CLUSTER_SAMPLES samples) on each cluster size, the global-state
    kernel above the cluster's
    capacity, each Viterbi twin run on the host CPU in DTW_TWIN_WORKERS
    processes while the card times the DP at the main path's size at each
    cluster size (with the card's cudaOccupancyMaxActiveClusters), the
    other cases, the global kernel and the forward variant, and the walk
    (at the small size too, alone and in bursts of 10, beside its latency
    floor, WALK_FLOOR_CYCLES) and the path's copy to the host; then, the
    card's times taken, the forward twins run on the card in
    DTW_CARD_TWIN_WORKERS processes while the kernels run (at the main
    path's size on each cluster size the card places) and are held to the
    twins; last, the walk on hand-made planes (check_walk_planes). Returns
    the DP's and the walk's table rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from scrappie_torch.decode.dtw import match_inputs
    from scrappie_torch.ops import dtw as d

    rng = np.random.default_rng(SEED + 40)
    npos_global = d.DTW_MAX_SHARED_NPOS + 1000
    cases = {name: make(npos, T, rng) for name, (npos, T), make in (
        ("shared", DTW_SHARED, dtw_case),
        ("ties", DTW_TIES, dtw_tie_case),
        ("global", (npos_global, DTW_GLOBAL_SAMPLES), dtw_case),
        ("clusters", (MAP_BASES, DTW_CLUSTER_SAMPLES), dtw_case),
        ("timed", (MAP_BASES, MAP_SAMPLES), dtw_case))}
    card_args = lambda name: (cases[name][0], *match_inputs(cases[name][1], 1.0, 0.0, "cuda"),
                              0.0, *DTW_OPTIONS.values())
    args = card_args("timed")
    npos, T = MAP_BASES, MAP_SAMPLES
    rows, clusters, times = {}, {}, {}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(DTW_TWIN_WORKERS, mp_context=spawn) as pool:
        # the longest twins first; the card takes the phase's times while
        # they run
        jobs = {name: submit_dtw_twins(pool, *cases[name])
                for name in ("clusters", "ties", "global", "shared")}
        for k in DTW_CLUSTERS:
            fits = d.max_active_clusters(npos, k)
            clusters[k] = {"max_active_clusters": fits}
            if fits:
                ms = cuda_ms(lambda: d.squiggle_match_tm(*args, cluster=k), reps=5)
                clusters[k].update(
                    ms=ms, us_per_sample=ms * 1e3 / T,
                    forward_ms=cuda_ms(lambda: d.squiggle_match_tm(
                        *args, viterbi=False, cluster=k), **TWIN_REPS),
                    layout=d.cluster_layout(npos, k)._asdict())
        for name in ("shared", "ties", "global"):
            cargs = card_args(name)
            times[name] = {"ms": cuda_ms(lambda: d.squiggle_match_tm(*cargs), reps=5)}
        # the walk at the first shape too
        sfinal, smoves, send = d.squiggle_match_tm(*card_args("shared"))
        times["shared"]["walk_ms"] = cuda_ms(lambda: d.dtw_walk(sfinal, smoves, send), reps=5)
        times["shared"]["walk_burst_ms"] = cuda_ms(
            lambda: d.dtw_walk(sfinal, smoves, send), reps=5, burst=10)
        t0 = time.perf_counter()
        d.dtw_walk_plain(sfinal, smoves, send)
        times["shared"]["walk_plain_ms"] = (time.perf_counter() - t0) * 1e3
        del sfinal, smoves, send
        final, moves, end_src = d.squiggle_match_tm(*args)
        path = d.dtw_walk(final, moves, end_src)
        t0 = time.perf_counter()
        d.dtw_walk_plain(final, moves, end_src)
        walk_plain_ms = (time.perf_counter() - t0) * 1e3
        timed = {"cluster": d.DTW_CLUSTER, "clusters": clusters,
                 "ms": clusters[d.DTW_CLUSTER]["ms"],
                 "global_ms": cuda_ms(lambda: d.squiggle_match_tm(*args, global_state=True),
                                      **TWIN_REPS),
                 "forward_ms": cuda_ms(lambda: d.squiggle_match_tm(*args, viterbi=False),
                                       **TWIN_REPS),
                 "moves_bytes": moves.numel() + end_src.numel() * 4,
                 **kernel_work("dtw", T=T, npos=npos)}
        walk = {"T": T, "max_abs_err": 0.0,
                "ms": cuda_ms(lambda: d.dtw_walk(final, moves, end_src), reps=5),
                "plain_ms": walk_plain_ms, "path_bytes": path.numel() * 4,
                "path_copy_ms": cuda_ms(lambda: path.cpu(), reps=5),
                "burst_ms": cuda_ms(lambda: d.dtw_walk(final, moves, end_src), reps=5,
                                    burst=10),
                "latency_floor_ms": floor_ms(T - 1, WALK_FLOOR_CYCLES),
                **kernel_work("dtw_walk", T=T)}
        walk["us_per_sample"] = walk["ms"] * 1e3 / T
        times["shared"]["walk_latency_floor_ms"] = floor_ms(DTW_SHARED[1] - 1,
                                                            WALK_FLOOR_CYCLES)
        del final, moves, end_src, path
        with ProcessPoolExecutor(DTW_CARD_TWIN_WORKERS, mp_context=spawn) as card_pool:
            for name in ("clusters", "ties", "global", "shared"):
                jobs[name].update(submit_dtw_twins(card_pool, *cases[name], viterbi=False))
            for name in ("shared", "ties", "global", "clusters"):
                csig, cparams = cases[name]
                cnpos, cT = cparams.shape[0], csig.shape[0]
                require((cnpos <= d.DTW_MAX_SHARED_NPOS) == (name != "global"),
                        f"dtw {name} case {cnpos} positions takes its kernel")
                others = [k for k in DTW_CLUSTERS if k != d.DTW_CLUSTER
                          and clusters[k]["max_active_clusters"]] if name == "clusters" else []
                row = check_dtw(csig, cparams, f"{name}, {cnpos} x {cT}", jobs.pop(name),
                                others)
                row.update(npos=cnpos, T=cT, plain_ms=row.pop("plain_s") * 1e3,
                           **times.get(name, {}))
                rows[name] = row
                if name == "ties":  # the cluster kernel agrees with the global one
                    cargs = card_args(name)
                    fg, mg, eg = d.squiggle_match_tm(*cargs, global_state=True)
                    fc, mc, ec = d.squiggle_match_tm(*cargs)
                    sync()
                    require(torch.equal(mg, mc) and torch.equal(eg, ec) and torch.equal(fg, fc),
                            "dtw global and cluster kernels identical (ties)")
    # the twin's time at the clusters' check (DTW_CLUSTER_SAMPLES samples)
    timed = {**rows["clusters"], **timed, "T": T, "plain_T": DTW_CLUSTER_SAMPLES}
    timed["us_per_sample"] = timed["ms"] * 1e3 / T
    # the table's error: the largest difference of any check
    timed["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    walk["planes"] = check_walk_planes()
    emit({"phase": "dtw_kernel", "checked": rows, "timed": timed, "walk": walk,
          "card": card})
    return timed, walk


def seqmap_case(rng):
    """The rgrgr_r94 log posterior (through api.calc_post on the card) of
    a synthetic MAP_SAMPLES-sample read, and a seeded MAP_BASES-base
    reference."""
    from scrappie_torch import api

    raw = api.RawTable(synthetic_signal(MAP_SAMPLES, rng))
    raw.trim().scale()
    return api.calc_post(raw, "rgrgr_r94", device="cuda"), random_bases(MAP_BASES, rng)


def finite_max_diff(a, b) -> float:
    """The largest |a - b| where it is finite (equal infinities give NaN)."""
    import torch

    err = (a - b).abs()
    err = err[torch.isfinite(err)]
    return float(err.max()) if err.numel() else 0.0


def seqmap_edge_cases(rng) -> list:
    """Small dense maps at the seqmap kernel's edges, as (lp, seqstates,
    penalties) on the host: 60 with integer log posteriors (ties), half of
    them -inf, seqlen 1 to 3, T from 1 to 8, and a huge local penalty
    (2e30) or skip bonus (-1e30), whose walks pass through the states -1
    and -2 and sit in START; and T = 1 and 1025 states at seqlen 1, 2, 3
    and 9."""
    import numpy as np

    cases = []
    for _ in range(60):
        T, seqlen = int(rng.integers(1, 9)), int(rng.integers(1, 4))
        lp = rng.integers(-3, 1, (T, 5)).astype(np.float32)
        lp[rng.random((T, 5)) < 0.5] = -np.inf
        pens = (float(rng.choice([0.0, 0.5])), float(rng.choice([0.0, -1e30, 1.0])),
                float(rng.choice([4.0, 2e30])))
        cases.append((lp, rng.integers(0, 4, seqlen).astype(np.int32), pens))
    for T, seqlen in ((1, 9), (40, 1), (40, 2), (40, 3), (300, 9)):
        lp = np.log(rng.dirichlet(np.ones(1025), T)).astype(np.float32)
        cases.append((lp, rng.integers(0, 1024, seqlen).astype(np.int32),
                      (0.2, 0.7, 4.0)))
    return cases


def check_seqmap_case(lp, states, pens, label: str, twin_on_host: bool) -> dict:
    """The seqmap kernel against its twin, Viterbi and forward, in every
    state mode that takes the read (registers while it fits, global
    memory): Viterbi finals and moves identical, forward finals within
    FORWARD_RTOL; and the walk kernel's path identical to the twin walk's.
    The twins run on the host (tiny cases) or on the card. Returns the
    largest differences, the Viterbi twin's and the walk twin's ms."""
    import torch

    from scrappie_torch.ops import seqmap as m

    seqlen = states.shape[0]
    modes = (False, True) if seqlen <= m.SEQMAP_MAX_REGISTER_SEQLEN else (True,)
    out = {"max_abs_err": 0.0, "forward_rel_err": 0.0}
    for viterbi in (True, False):
        args = (lp.cpu(), states.cpu()) if twin_on_host else (lp, states)
        t0 = time.perf_counter()
        fp, mp = m.map_to_sequence_plain(*args, *pens, viterbi=viterbi)
        sync()
        if viterbi:
            out["plain_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            pp = m.seqmap_walk_plain(fp, mp, seqlen).cuda()
            out["walk_plain_ms"] = (time.perf_counter() - t0) * 1e3
            mp = mp.cuda()
        fp = fp.cuda()
        for global_state in modes:
            fk, mk = m.map_to_sequence_tm(lp, states, *pens, viterbi=viterbi,
                                          global_state=global_state)
            sync()
            what = f"{label}, viterbi={viterbi}, global_state={global_state}"
            if viterbi:
                require(torch.equal(mk, mp), f"seqmap moves identical ({what})")
                require(torch.equal(fk, fp), f"seqmap final identical ({what})")
                pk = m.seqmap_walk(fk, mk, seqlen)
                sync()
                require(torch.equal(pk, pp), f"seqmap_walk path identical ({what})")
            else:
                finite = torch.isfinite(fp)
                require(torch.equal(finite, torch.isfinite(fk)) and torch.equal(
                    fk[~finite], fp[~finite]), f"seqmap forward infinities ({what})")
                rel = float(((fk - fp).abs() / fp.abs().clamp(min=1.0))[finite].max()
                            if finite.any() else 0.0)
                require(rel <= FORWARD_RTOL,
                        f"seqmap forward final rel err {rel} <= {FORWARD_RTOL} ({what})")
                out["forward_rel_err"] = max(out["forward_rel_err"], rel)
            out["max_abs_err"] = max(out["max_abs_err"], finite_max_diff(fk, fp))
    return out


def seqmap_walk_plane(T: int, seqlen: int, rng, finish: str = "none"):
    """A hand-made seqmap traceback for the walk kernel: a seeded path built
    backwards from the final state, each of its rows' move byte the move to
    its earlier state, in a plane of random moves the DP could write
    elsewhere (positions 0-2, position 0 also 3, START 0, END 0 or 2, the
    row's padding 0). From END or seqlen-1 (the finals decide; seqlen-1
    at T <= 2) the path
    stays, steps and skips (a fall of about 0.75 a row), with runs of 300
    to 400 skips (a fall of 2 across whole windows of the walk, WALK_ROWS
    rows); at column 1 it skips (the state -1: END, a window's jump up) or
    steps or stays; at column 0 it stays up to 300 rows, then steps to the
    state -1; END stays, then exits to seqlen-1. In the second half it
    ends by `finish`: "entry_first" / "entry_last", an entry (move 3) at
    the first / last row of one of the walk kernel's windows (WALK_ROWS
    rows from the row the walk, or its last jump to END, starts at);
    "minus2", a skip from column 0 to the state -2 (START); "none", no end.
    Returns (final, moves [T, move_stride(seqlen)], path) numpy and the
    path's counts of each event."""
    import numpy as np

    from scrappie_torch.ops import seqmap as m

    n, START, END = seqlen + 2, seqlen, seqlen + 1
    moves = rng.integers(0, 3, (T, m.move_stride(seqlen))).astype(np.uint8)
    moves[:, 0] = rng.integers(0, 4, T)
    moves[:, START] = 0
    moves[:, END] = 2 * rng.integers(0, 2, T)
    moves[:, n:] = 0
    final = rng.standard_normal(n).astype(np.float32)
    col = int(rng.choice([END, seqlen - 1])) if T > 2 else seqlen - 1
    final[col] = final[END + seqlen - 1 - col] + 1.0  # col's final wins
    path = np.empty(T, np.int32)
    path[T - 1] = -1 if col >= START else col
    counts = dict(skips=0, skip_runs=0, wraps=0, column0=0, entries=0, minus2=0,
                  end_rows=0)
    s, top, run, stay = T - 1, T - 1, 0, 0

    def put(code):
        nonlocal s, col, top
        st = START if code == 3 else col - code
        moves[s, col] = code
        s -= 1
        path[s] = -1 if st >= START else st
        col = st + n if st < 0 else st
        if st == -1:
            counts["wraps"] += 1
            top = s  # the walk loads a window anchored at END from row s
        counts["skips"] += code == 2
        counts["column0"] += col == 0
        counts["end_rows"] += col == END
        counts["entries"] += code == 3
        counts["minus2"] += st == -2

    while s > 0:
        ending = finish != "none" and 2 * s <= T
        if col == START:
            put(0)
        elif col == END:
            put(0 if rng.random() < 0.97 else 2)
        elif run:
            run -= 1
            put(2)
        elif col >= 2:
            u = rng.random()
            if u < 0.004 and col >= 800:
                run = int(rng.integers(300, 400)) - 1
                counts["skip_runs"] += 1
                put(2)
            else:
                put(0 if u < 0.45 else 1 if u < 0.8 else 2)
        elif col == 1:
            u = rng.random()
            put(2 if u < 0.3 else 1 if u < 0.6 else 0)
        elif ending and finish == "minus2":
            put(2)
        elif ending:
            edge = (top - s) % m.WALK_ROWS
            put(3 if edge == (0 if finish == "entry_first" else m.WALK_ROWS - 1)
                else 0)
        else:
            stay = stay or int(rng.integers(1, 300))
            stay -= 1
            put(0 if stay else 1)
    return final, moves, path, counts


def check_seqmap_walk_planes() -> dict:
    """The seqmap walk kernel on SEQMAP_WALK_PLANES' hand-made planes
    (seqmap_walk_plane, plane k seeded (SEED, 51, k)): its path identical to seqmap_walk_plain's and to
    the path the plane was made from; with each plane's events and the
    walk's time (median of 5)."""
    import numpy as np
    import torch

    from scrappie_torch.ops import seqmap as m

    out = {}
    for k, (T, seqlen, finish) in enumerate(SEQMAP_WALK_PLANES):
        final, moves, path, counts = seqmap_walk_plane(
            T, seqlen, np.random.default_rng((SEED, 51, k)), finish)
        fk = torch.as_tensor(final, device="cuda")
        mk = torch.as_tensor(moves, device="cuda")
        label = f"{T} x {seqlen}, {finish}"
        pk = m.seqmap_walk(fk, mk, seqlen)
        pp = m.seqmap_walk_plain(fk, mk, seqlen)
        sync()
        require(np.array_equal(pp.cpu().numpy(), path),
                f"the hand-made plane's walk takes its path ({label})")
        require(torch.equal(pk, pp),
                f"seqmap_walk path identical on a hand-made plane ({label})")
        out[label] = {"ms": cuda_ms(lambda: m.seqmap_walk(fk, mk, seqlen), reps=5),
                      **counts}
        del fk, mk
    return out


def check_seqmap_kernel(card: str) -> tuple[dict, dict]:
    """The seqmap and walk kernels against their twins (check_seqmap_case):
    on the edge cases (twins on the host), on the rgrgr_r94 posterior of a
    synthetic read against a seeded MAP_BASES-base reference (twins on the
    card), and on its first 2000 blocks against 12 000 bases (16 states a
    thread) and against 20 000 (past the registers: global memory); then
    the DP's times (registers, global memory, the forward variant), the
    walk's and the path's copy to the host at the read's size. Returns the
    DP's and the walk's table rows."""
    import numpy as np
    import torch

    from scrappie_torch import api
    from scrappie_torch.ops import seqmap as m

    rng = np.random.default_rng(SEED + 50)
    post, ref = seqmap_case(rng)
    lp = torch.as_tensor(post.data(), device="cuda")
    states = torch.as_tensor(api.encode_bases(ref, 5).astype(np.int32), device="cuda")
    T, nst = lp.shape
    seqlen = states.shape[0]
    pens = (0.0, 0.0, 4.0)
    edges = {"max_abs_err": 0.0, "forward_rel_err": 0.0}
    for k, (elp, est, epens) in enumerate(seqmap_edge_cases(rng)):
        row = check_seqmap_case(torch.as_tensor(elp, device="cuda"),
                                torch.as_tensor(est, device="cuda"), epens,
                                f"edge case {k}", twin_on_host=True)
        for key in edges:
            edges[key] = max(edges[key], row[key])
    checked = {"edges": edges}
    for name, blocks, bases in (("long", 2000, 12000), ("global", 2000, 20000)):
        big = torch.as_tensor(rng.integers(0, 1024, bases).astype(np.int32),
                              device="cuda")
        checked[name] = check_seqmap_case(lp[:blocks].contiguous(), big, pens,
                                          f"{name}, {blocks} x {bases}", False)
        checked[name]["layout"] = m.seqmap_layout(bases)._asdict()
    out = check_seqmap_case(lp, states, pens, f"read, {T} x {seqlen}", False)
    final, moves = m.map_to_sequence_tm(lp, states, *pens)
    path = m.seqmap_walk(final, moves, seqlen)
    out.update(
        T=T, nst=nst, seqlen=seqlen, layout=m.seqmap_layout(seqlen)._asdict(),
        ms=cuda_ms(lambda: m.map_to_sequence_tm(lp, states, *pens)),
        global_ms=cuda_ms(lambda: m.map_to_sequence_tm(lp, states, *pens,
                                                       global_state=True), reps=5),
        forward_ms=cuda_ms(lambda: m.map_to_sequence_tm(lp, states, *pens,
                                                        viterbi=False), reps=5),
        moves_bytes=moves.numel(),
        **kernel_work("seqmap", T=T, nst=nst, seqlen=seqlen))
    out["bound_int32_ms"] = kernel_work("seqmap", T=T, nst=nst, seqlen=seqlen,
                                        int32=True)["bound_ms"]
    out["us_per_block"] = out["ms"] * 1e3 / T
    for row in checked.values():
        out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
    walk = {"T": T, "max_abs_err": 0.0, "plain_ms": out.pop("walk_plain_ms"),
            "ms": cuda_ms(lambda: m.seqmap_walk(final, moves, seqlen), reps=10),
            "burst_ms": cuda_ms(lambda: m.seqmap_walk(final, moves, seqlen),
                                reps=5, burst=10),
            "latency_floor_ms": floor_ms(T - 1, WALK_FLOOR_CYCLES),
            "path_bytes": path.numel() * 4,
            "path_copy_ms": cuda_ms(lambda: path.cpu(), reps=5),
            **kernel_work("seqmap_walk", T=T)}
    walk["us_per_block"] = walk["burst_ms"] * 1e3 / T
    walk["planes"] = check_seqmap_walk_planes()
    emit({"phase": "seqmap_kernel", **out, "checked": checked, "walk": walk,
          "card": card})
    return out, walk


def banded_case(lp, seqlen: int, half: int):
    """The bands api.map_post_to_sequence makes for an int half-width."""
    import numpy as np

    nblock = lp.shape[0]
    gradient = seqlen / nblock
    low = np.maximum(0, np.arange(nblock) * gradient - half * gradient).astype(np.int64)
    high = np.minimum(seqlen, np.arange(nblock) * gradient + half * gradient).astype(np.int64)
    low[0], high[-1] = 0, seqlen
    return low, high


def narrow_bands(T: int, width: int, rng):
    """(low, high, seqlen) of a sane band of the given width whose shift
    reaches the width: the first 6 blocks keep low == 0, then low rises by
    0 to width a block, high = low + width, the last block one narrower."""
    import numpy as np

    steps = rng.integers(0, width + 1, T)
    steps[:7] = 0
    steps[7::7] = width
    low = np.cumsum(steps).astype(np.int64)
    seqlen = int(low[-1]) + width - 1 if width > 1 else int(low[-1]) + 1
    return low, np.minimum(low + width, seqlen), seqlen


def check_banded_kernel(card: str) -> dict:
    """The banded kernel against its twin: on the seqmap read with the
    bands of MAP_BAND (twins on the card, timed), at widths 1, 2 and 3 and
    at the warp mode's boundaries (BANDED_BOUNDARY_WIDTHS) on bands whose
    shift reaches the width, and at a width above 1024 (T = 2000 blocks of
    the read; twins on the host), and with the window in global memory;
    Viterbi identical, forward within FORWARD_RTOL; each case's launch plan;
    then the kernel's times at the read's size (the warp mode's two
    launches, gather and DP, in each interval) beside its latency floor
    (BANDED_FLOOR_CYCLES). Returns its table row."""
    import numpy as np
    import torch

    from scrappie_torch import api
    from scrappie_torch.decode.mapping import banded_inputs
    from scrappie_torch.ops import seqmap as m

    rng = np.random.default_rng(SEED + 55)
    post, ref = seqmap_case(rng)
    lp = torch.as_tensor(post.data(), device="cuda")
    seq = api.encode_bases(ref, 5).astype(np.int64)
    pens = (0.0, 0.3, 4.0)
    short = lp[:T_BLOCKS].contiguous()
    cases = [("read", lp, seq, *banded_case(lp, len(seq), MAP_BAND), False, None)]
    for width in (1, 2, 3, *BANDED_BOUNDARY_WIDTHS):
        low, high, seqlen = narrow_bands(T_BLOCKS, width, rng)
        cases.append((f"width {width}", short, rng.integers(0, 1024, seqlen),
                      low, high, True, None))
    wide_seq = rng.integers(0, 1024, 3000)
    low, high = banded_case(short, 3000, 700)
    cases.append(("wide", short, wide_seq, low, high, True, None))
    cases.append(("wide, global", short, wide_seq, low, high, True, True))
    out = {"max_abs_err": 0.0, "forward_rel_err": 0.0, "widths": {}, "layouts": {}}
    for name, clp, cseq, low, high, host, global_state in cases:
        states, bands, init = banded_inputs(clp, cseq, low, high, pens[1])
        width = init.shape[0]
        out["widths"][name] = width
        out["layouts"][name] = m.banded_layout(clp.shape[1], width, global_state)._asdict()
        for viterbi in (True, False):
            targs = ((clp.cpu(), states.cpu(), bands.cpu(), init.cpu()) if host
                     else (clp, states, bands, init))
            t0 = time.perf_counter()
            tp = m.map_banded_plain(*targs, *pens, viterbi=viterbi).cuda()
            sync()
            if name == "read":
                out["plain_ms" if viterbi else "forward_plain_ms"] = (
                    time.perf_counter() - t0) * 1e3
            tk = m.map_banded_tm(clp, states, bands, init, *pens, viterbi=viterbi,
                                 global_state=global_state)
            sync()
            what = f"{name}, width {width}, viterbi={viterbi}"
            if viterbi:
                require(torch.equal(tk, tp), f"seqmap_banded identical ({what})")
            else:
                finite = torch.isfinite(tp)
                require(torch.equal(finite, torch.isfinite(tk)),
                        f"seqmap_banded forward infinities ({what})")
                rel = float(((tk - tp).abs() / tp.abs().clamp(min=1.0))[finite].max())
                require(rel <= FORWARD_RTOL,
                        f"seqmap_banded forward rel err {rel} <= {FORWARD_RTOL} ({what})")
                out["forward_rel_err"] = max(out["forward_rel_err"], rel)
            out["max_abs_err"] = max(out["max_abs_err"], finite_max_diff(tk, tp))
    states, bands, init = banded_inputs(lp, seq, *banded_case(lp, len(seq), MAP_BAND),
                                        pens[1])
    T, width = lp.shape[0], init.shape[0]
    out.update(
        T=T, seqlen=len(seq), width=width,
        layout=m.banded_layout(lp.shape[1], width),
        ms=cuda_ms(lambda: m.map_banded_tm(lp, states, bands, init, *pens), reps=10),
        forward_ms=cuda_ms(lambda: m.map_banded_tm(lp, states, bands, init, *pens,
                                                   viterbi=False), reps=10),
        **kernel_work("seqmap_banded", T=T, width=width))
    out["us_per_block"] = out["ms"] * 1e3 / T
    out["forward_us_per_block"] = out["forward_ms"] * 1e3 / T
    out["latency_floor_ms"] = floor_ms(T - 1, BANDED_FLOOR_CYCLES["viterbi"])
    out["forward_latency_floor_ms"] = floor_ms(T - 1, BANDED_FLOOR_CYCLES["forward"])
    emit({"phase": "seqmap_banded_kernel", **out, "card": card})
    return out


def host_copies(fn) -> dict:
    """What fn() copies from the card to the host: the count, bytes and
    device milliseconds of the memcpy events in torch.profiler's trace
    (bytes None if the trace does not give them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scrappie_torch.ops import _build

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = _build.BUILD_DIR / f"host_copies.{time.time_ns()}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    copies = [e for e in events
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    known = all("bytes" in e.get("args", {}) for e in copies)
    return {"copies": len(copies),
            "bytes": sum(e["args"]["bytes"] for e in copies) if known else None,
            "device_ms": sum(e.get("dur", 0.0) for e in copies) / 1e3}


def banded_split(post, ref, kw) -> dict:
    """One banded map_post_to_sequence call on the card, after a warm-up
    call: its wall milliseconds, the banded kernels' device milliseconds
    (CUDA events recorded on the stream around the library's entry point,
    which launches the warp mode's gather and DP, or the block mode's
    kernel, and nothing else; torch.profiler's trace at times lost every
    device event here) and the rest of the call (the posterior's copy,
    banded_inputs, the wrapper's checks, the result's copy and the host's
    work)."""
    import torch

    from scrappie_torch import api
    from scrappie_torch.ops import _build

    lib = _build.library()
    inner = lib.scrappie_seqmap_banded
    marks = []

    def timed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        err = inner(*args)
        end.record()
        marks.append((start, end))
        return err

    api.map_post_to_sequence(post, ref, device="cuda", **kw)
    torch.cuda.synchronize()
    lib.scrappie_seqmap_banded = timed
    try:
        t0 = time.perf_counter()
        api.map_post_to_sequence(post, ref, device="cuda", **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        lib.scrappie_seqmap_banded = inner
    device_ms = sum(start.elapsed_time(end) for start, end in marks)
    return {"wall_ms": wall_ms, "kernel_device_ms": device_ms,
            "rest_ms": wall_ms - device_ms, "kernel_calls": len(marks)}


def mapping_signal(squiggle, rng) -> "np.ndarray":
    """A raw read for map_signal_to_squiggle: MAP_SAMPLES samples simulated
    from the squiggle, scaled to pA, between two flat 300-sample pads."""
    import numpy as np

    pad = lambda: 150.0 + rng.normal(0.0, 0.3, 300)
    return np.concatenate([pad(), 90.0 + 12.0 * simulate_squiggle(
        squiggle, MAP_SAMPLES, rng), pad()]).astype(np.float32)


def main_path_mapping(card: str) -> dict:
    """The mapping path through the API on the card: the launches of its
    kernels (MAPPING_KERNELS) in this run, what map_post_to_sequence copies
    to the host, each call's seconds, each banded call split into its
    kernels' device time and the rest (banded_split), and each result held to
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
    data = mapping_signal(squiggle, rng)
    read = synthetic_signal(MAP_SAMPLES, rng)
    ref = random_bases(MAP_BASES, rng)

    ops.reset_launches()
    t0 = time.perf_counter()
    score, path = api.map_signal_to_squiggle(data, seq, device="cuda")
    seconds = {"map_signal_to_squiggle": time.perf_counter() - t0}
    raw = api.RawTable(read)
    raw.trim().scale()
    post = api.calc_post(raw, "rgrgr_r94", device="cuda")
    results = {}
    for what, kw in MAP_CALLS:
        t0 = time.perf_counter()
        results[what] = api.map_post_to_sequence(post, ref, device="cuda", **kw)
        seconds[what] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for name in MAPPING_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} launched on the mapping path ({launches[name]})")
    banded = {what: banded_split(post, ref, kw) for what, kw in MAP_CALLS
              if "bands" in kw}
    for what, split in banded.items():
        require(split["kernel_calls"] == 1 and split["kernel_device_ms"] > 0,
                f"{what}: the banded kernels timed in the call ({split})")
    copied = host_copies(lambda: api.map_signal_to_squiggle(data, seq, device="cuda"))
    # Viterbi with a path copies the path, the two finals and the one byte
    # of the seqmap wrapper's check of the kmer states, and no traceback.
    # It copies the path for certain, so a trace without a copy lost its
    # events: profile again.
    for _ in range(3):
        mapped_copies = host_copies(lambda: api.map_post_to_sequence(
            post, ref, device="cuda", **MAP_CALLS[0][1]))
        if mapped_copies["copies"]:
            break
    allowed = 4 * post.shape[0] + 8 + 1
    require(mapped_copies["copies"] > 0 and mapped_copies["bytes"] is not None
            and mapped_copies["bytes"] <= allowed,
            f"map_post_to_sequence viterbi, path copies {mapped_copies} "
            f"(at most {allowed} bytes) to the host")

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
    for what, kw in MAP_CALLS:
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
          "seconds": seconds, "cpu_seconds": cpu_seconds,
          "banded_split": banded, "launches": launches,
          "map_signal_to_squiggle_host_copies": copied,
          "map_post_to_sequence_host_copies": mapped_copies, "card": card})
    return launches


# ------------------------------------------------------------- qualities

# The engine runs of phase `qualities`: (label, model, engine options,
# call options). The second 3:1:1 run recalibrates ("real") the first's
# qualities with the ensemble's own fit.
QUALITY_RUNS = (
    ("rgrgr_r94 fast", "rgrgr_r94", dict(mode="fast"), {}),
    ("rgrgr_r94 stitch nochange", "rgrgr_r94", dict(mode="stitch"),
     dict(homopolymer="nochange")),
    ("raw_r94 fast", "raw_r94", dict(mode="fast"), {}),
    ("3:1:1 fast", "rgrgr_r94", dict(mode="fast", ensemble=ENSEMBLE), {}),
    ("3:1:1 fast, real", "rgrgr_r94",
     dict(mode="fast", ensemble=ENSEMBLE, qual_calibration="real"), {}),
    ("nanonet_events fast", "nanonet_events", dict(mode="fast"),
     dict(dwell_correction=False)),
    ("nanonet_events stitch", "nanonet_events", dict(mode="stitch"),
     dict(dwell_correction=False)),
    ("rnnrf_r94 stitch", "rnnrf_r94", dict(mode="stitch"), {}),
)
TWIN_WORKERS = 6         # host processes running the CPU references


def cpu_calls(model: str, engine_kw: dict, call_kw: dict, signals: list):
    """BasecallEngine on the CPU with qualities, in a worker process:
    [(sequence, qual)] of the signals."""
    import torch

    from scrappie_torch.parallel.runner import BasecallEngine

    torch.set_num_threads(1)
    eng = BasecallEngine(model, device="cpu", **engine_kw)
    return [(r.sequence, r.qual) for r in
            eng.basecall_signals(signals, with_qualities=True, **call_kw)]


def cpu_stream(model: str, chunk_len: int, overlap: int, sig) -> str:
    """A solo StreamingBasecaller on the CPU, in a worker process."""
    import torch

    from scrappie_torch.parallel.streaming import StreamingBasecaller

    torch.set_num_threads(1)
    sb = StreamingBasecaller(model, chunk_len, overlap, device="cpu")
    sb.feed(sig)
    sb.flush()
    return sb.sequence


def check_qualities(card: str, reads: list, pool) -> dict:
    """BasecallEngine(..., device="cuda") with_qualities=True on the reads
    in each of QUALITY_RUNS: every call's quality string has its
    sequence's length, every sequence equals the same call without
    qualities, the recalibrated 3:1:1 run is the raw one's qualities
    through the ensemble's fit, and the two shortest reads' calls and
    qualities match the port's CPU run (utils/seqcompare.quals_agree).
    Prints each run's seconds with and without qualities, its stages
    (rnnrf's forward-backward is the stage "posterior_crf") and its
    launches (set to 0 just before the run with qualities, read just
    after); rnnrf's must launch the forward-backward once for each launch
    that parallel/runner.crf_groups gives the call's reads.
    Returns the launches of the runs, crf_posterior among them."""
    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine, crf_groups
    from scrappie_torch.post.quality import recalibrate_phred
    from scrappie_torch.utils.seqcompare import qual_diffs, quals_agree
    from scrappie_torch.utils.tracing import Stage

    lengths = [len(r.raw) for r in reads]
    short = sorted(range(len(reads)), key=lambda i: lengths[i])[:2]
    twins = {label: pool.submit(cpu_calls, model, ekw, ckw,
                                [reads[i] for i in short])
             for label, model, ekw, ckw in QUALITY_RUNS}
    calls, launches = {}, dict.fromkeys(ops.LAUNCHES, 0)
    for label, model, ekw, ckw in QUALITY_RUNS:
        eng = BasecallEngine(model, device="cuda", **ekw)
        for quals in (False, True):  # warm up both paths
            eng.basecall_signals(reads[:1], with_qualities=quals, **ckw)
        recal = ekw.get("qual_calibration") == "real"
        if not recal:
            t0 = time.perf_counter()
            plain = eng.basecall_signals(reads, **ckw)
            plain_s = time.perf_counter() - t0
        eng.stage = Stage()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = eng.basecall_signals(reads, with_qualities=True, **ckw)
        qual_s = time.perf_counter() - t0
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        for name in BACKWARD_KERNELS:
            require(name not in launched, f"qualities {label}: no {name}")
        if model == "rnnrf_r94":
            want = len(crf_groups([r.nblock for r in res
                                   if r.sequence is not None]))
            require(launched.get("crf_posterior", 0) == want,
                    f"qualities {label}: the forward-backward launched once "
                    f"a group of crf_groups, {want} "
                    f"({launched.get('crf_posterior', 0)})")
            launches["crf_posterior"] += launched["crf_posterior"]
        require(all(r.sequence and r.qual and len(r.qual) == len(r.sequence)
                    for r in res), f"qualities {label}: a code a base")
        if recal:
            raw = calls["3:1:1 fast"]
            key = "+".join(("rgrgr_r94",) + tuple(sorted(ENSEMBLE)))
            require(all(r.sequence == w.sequence
                        and r.qual == recalibrate_phred(w.qual, key)
                        for r, w in zip(res, raw)),
                    f"qualities {label}: the raw qualities through {key}'s fit")
            plain, plain_s = raw, None
        require(all(r.sequence == p.sequence for r, p in zip(res, plain)),
                f"qualities {label}: the calls without qualities")
        calls[label] = res
        nsample = sum(lengths)
        emit({"phase": "qualities", "run": label, "reads": len(res),
              "samples": nsample, "bases": sum(len(r.sequence) for r in res),
              "seconds_without": plain_s, "seconds_with": qual_s,
              "samples_per_s_with": nsample / qual_s,
              "stages_with": eng.stage.report(), "launches_with": launched,
              "card": card})
    for label, *_ in QUALITY_RUNS:
        for i, (cseq, cqual) in zip(short, twins[label].result()):
            g = calls[label][i]
            require(g.sequence == cseq,
                    f"qualities {label} {reads[i].uuid}: the CPU run's call")
            n, step = qual_diffs(g.qual, cqual)
            emit({"phase": "cpu_vs_cuda", "path": "qualities", "run": label,
                  "read": reads[i].uuid, "bases": len(cseq),
                  "qual_codes_differing": n, "largest_step": step})
            require(quals_agree(g.qual, cqual),
                    f"qualities {label} {reads[i].uuid}: the CPU run's codes")
    return launches


# -------------------------------------------------------------- training

def random_params(model: str, seed: int) -> dict:
    """A seeded random init of the model's weights: 0.1 standard normal in
    the registry's keys and shapes (tests/test_models.py:124-129)."""
    import numpy as np

    from scrappie_torch.models import registry

    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(model).items()}


def cpu_value_and_grad(model: str, params: dict, sig, labels):
    """The training loss and every gradient on the CPU (the plain twins),
    in a worker process, as numpy."""
    import torch

    from scrappie_torch.train.trainer import value_and_grad

    torch.set_num_threads(1)
    loss, grads = value_and_grad(
        model, {k: torch.as_tensor(v) for k, v in params.items()}, sig, labels)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def loss_of(kind: str, model: str):
    """The loss a lattice or whole-read step of `kind` takes its gradient
    of, lfn(params, x, seq): "lattice" (train/lattice.make_lattice_train_
    step's), "transducer", "crf" or "head" (train/wholeread's steps', chunk
    WHOLE_CHUNK)."""
    from scrappie_torch.train import lattice, wholeread

    if kind == "lattice":
        return lattice.lattice_loss(model)
    if kind == "transducer":
        return wholeread.transducer_wholeread_loss(model, chunk=WHOLE_CHUNK)
    if kind == "crf":
        return wholeread.crf_wholeread_loss(model, chunk=WHOLE_CHUNK)
    return wholeread.head_loss(chunk=WHOLE_CHUNK)


def value_and_grad_on(kind: str, model: str, params: dict, x, seq, device):
    """loss_of(kind, model)'s value and gradients at params (numpy) on x
    and seq (numpy) on the device -> (loss, {key: numpy gradient})."""
    import torch

    from scrappie_torch.train.trainer import value_and_grad_of

    loss, grads = value_and_grad_of(
        loss_of(kind, model),
        {k: torch.as_tensor(v, device=device) for k, v in params.items()},
        torch.as_tensor(x, dtype=torch.float32, device=device),
        torch.as_tensor(seq, device=device).long())
    return float(loss), {k: g.cpu().numpy() for k, g in grads.items()}


def cpu_value_and_grad_on(kind: str, model: str, params: dict, x, seq):
    """value_and_grad_on on the CPU (the plain twins), in a worker."""
    import torch

    torch.set_num_threads(1)
    return value_and_grad_on(kind, model, params, x, seq, "cpu")


def compare_with_cpu(what: str, card, cpu, rtol: float) -> dict:
    """The card's (loss, gradients) against the CPU's: the loss within
    TRAIN_LOSS_RTOL, each gradient within rtol of its largest entry."""
    import numpy as np

    (loss, grads), (cpu_loss, cpu_grads) = card, cpu
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    grad_rel = {k: float(np.abs(grads[k] - g).max()
                         / max(float(np.abs(g).max()), 1e-30))
                for k, g in cpu_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    require(loss_rel <= TRAIN_LOSS_RTOL,
            f"{what}: loss {loss} against the CPU's {cpu_loss}")
    require(grad_rel[worst] <= rtol,
            f"{what}: gradient {worst} rel err {grad_rel[worst]} <= {rtol}")
    return {"cpu_loss_rel_err": loss_rel, "cpu_grad_max_rel_err": grad_rel[worst],
            "cpu_grad_worst": worst}


def require_kernels(what: str, launched: dict, names) -> None:
    for name in names:
        require(launched.get(name, 0) > 0, f"kernel {name} launched on {what}")


def main_path_train(card: str, pool) -> dict:
    """train(model, device="cuda", **TRAIN) for each of TRAIN_MODELS from a
    seeded random init (phase main_path_train): every loss finite, the last
    below the first, each kernel of TRAIN_KERNELS launched (the counts set
    to 0 just before the run, read just after), and one backward walk
    launched for each forward recurrence; then TRAIN_PROFILE_STEPS steps
    under the profiler (device busy time, idle share). Then the lattice
    runs and the whole-read steps (main_path_lattice, main_path_wholeread).
    Last, after every timed run (they are host-bound, and busy workers
    beside them would slow them), each run's first step's loss and every
    gradient, on the same batch, against the port's CPU run in the pool's
    worker processes (compare_with_cpu; TRAIN_GRAD_RTOL, LATTICE_GRAD_RTOL
    for the lattice losses), and each run's line. Returns the launches
    summed over every run."""
    import numpy as np
    import torch

    from scrappie_torch import ops
    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.train import trainer
    from scrappie_torch.train.simulate import SquiggleSimulator

    total = dict.fromkeys(ops.LAUNCHES, 0)
    runs = []
    for i, model in enumerate(TRAIN_MODELS):
        spec = RAW_MODELS.get(model)
        kind = "events" if spec is None else spec.kind
        params = random_params(model, SEED + 130 + i)
        seed = SEED + 140 + i
        # train() draws its first batch from a simulator of the same seed
        sim = SquiggleSimulator(seed=seed, device="cuda")
        if spec is None:
            sig, labels = sim.detected_events_batch(TRAIN["batch"], TRAIN["nsample"] // 10)
        else:
            make = (sim.crf_labelled_batch if spec.kind == "rnnrf"
                    else sim.labelled_batch)
            sig, labels = make(TRAIN["batch"], TRAIN["nsample"], spec.stride)
        loss, grads = trainer.value_and_grad(
            model, {k: torch.as_tensor(v, device="cuda") for k, v in params.items()},
            sig, labels)
        sync()
        ops.reset_launches()
        t0 = time.perf_counter()
        trained, losses = trainer.train(model, params=params, seed=seed,
                                        log_every=0, device="cuda", **TRAIN)
        sync()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        require(all(np.isfinite(losses)), f"train {model}: every loss finite")
        require(losses[-1] < losses[0],
                f"train {model}: the loss falls ({losses[0]} -> {losses[-1]})")
        require(all(np.isfinite(v).all() for v in trained.values()),
                f"train {model}: finite parameters")
        require_kernels(f"train {model}", launched, TRAIN_KERNELS[kind])
        n = lambda name: launched.get(name, 0)
        if kind == "events":
            require(n("lstm_recurrence_bwd") == n("lstm_pair_train")
                    and n("lstm_pair") == 0,
                    f"train {model}: a backward walk for each stored forward")
        else:
            require(n("gru_recurrence_bwd") == n("gru_recurrence"),
                    f"train {model}: a backward walk launched for each recurrence")
        if kind == "rnnrf":
            require(n("crf_partition_grad") == n("crf_partition") == TRAIN["steps"],
                    f"train {model}: a partition gradient launched a step")
        require(abs(losses[0] - float(loss)) <= TRAIN_LOSS_RTOL * abs(float(loss)),
                f"train {model}: the first step's loss ({losses[0]}) is its "
                f"batch's ({float(loss)})")
        for k, v in launched.items():
            total[k] += v
        runs.append((f"train {model}",
                     {"phase": "main_path_train", "model": model, **TRAIN,
                      "losses": losses, "seconds": seconds,
                      "seconds_per_step": seconds / TRAIN["steps"],
                      "launches": launched, "card": card},
                     (float(loss), {k: g.cpu().numpy() for k, g in grads.items()}),
                     (cpu_value_and_grad, model, params, sig, labels), TRAIN_GRAD_RTOL))
        profiled(f"train {model}, {TRAIN_PROFILE_STEPS} steps",
                 lambda: trainer.train(model, params=params, seed=seed,
                                       log_every=0, device="cuda",
                                       **{**TRAIN, "steps": TRAIN_PROFILE_STEPS}),
                 card)
    runs += main_path_lattice(card, total)
    runs += main_path_wholeread(card, total)
    jobs = [pool.submit(*job) for _, _, _, job, _ in runs]
    for (what, line, card_vg, _, rtol), job in zip(runs, jobs):
        emit({**line, **compare_with_cpu(what, card_vg, job.result(), rtol)})
    return total


def lattice_batches(model: str, L: int) -> list:
    """TRAIN["steps"] seq_batch windows for the lattice run of `model`."""
    from scrappie_torch.train.simulate import SquiggleSimulator

    sim = SquiggleSimulator(seed=SEED + 180 + L, device="cuda")
    return [sim.seq_batch(TRAIN["batch"], TRAIN["nsample"], L)
            for _ in range(TRAIN["steps"])]


def main_path_lattice(card: str, total: dict) -> list:
    """make_lattice_train_step for each of LATTICE_RUNS on the card (phase
    main_path_train, run "lattice"): TRAIN["steps"] steps on seq_batch
    windows from a seeded random init, every loss finite and the last
    below the first, the first its batch's value_and_grad's, each kernel of
    LATTICE_KERNELS launched; then TRAIN_PROFILE_STEPS steps under the
    profiler. Adds the launches to total; returns main_path_train's runs
    (the first step against the CPU within LATTICE_GRAD_RTOL)."""
    import numpy as np
    import torch

    from scrappie_torch import ops
    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.train.lattice import make_lattice_train_step
    from scrappie_torch.train.optim import FiniteClippedAdam

    runs = []
    for i, (model, L) in enumerate(LATTICE_RUNS):
        params = random_params(model, SEED + 185 + i)
        batches = lattice_batches(model, L)
        card_vg = value_and_grad_on("lattice", model, params, *batches[0], "cuda")
        sync()

        def run(steps):
            opt = FiniteClippedAdam({k: torch.as_tensor(v, device="cuda").clone()
                                     for k, v in params.items()}, TRAIN["lr"])
            step = make_lattice_train_step(model, opt)
            return [float(step(*b)) for b in batches[:steps]], opt

        ops.reset_launches()
        t0 = time.perf_counter()
        losses, opt = run(TRAIN["steps"])
        sync()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        what = f"lattice {model}"
        require(all(np.isfinite(losses)), f"{what}: every loss finite")
        require(losses[-1] < losses[0],
                f"{what}: the loss falls ({losses[0]} -> {losses[-1]})")
        require(all(bool(torch.isfinite(v).all()) for v in opt.params.values()),
                f"{what}: finite parameters")
        require_kernels(what, launched, LATTICE_KERNELS[RAW_MODELS[model].kind])
        require(abs(losses[0] - card_vg[0]) <= TRAIN_LOSS_RTOL * abs(card_vg[0]),
                f"{what}: the first step's loss is its batch's")
        for k, v in launched.items():
            total[k] += v
        runs.append((what, {"phase": "main_path_train", "run": "lattice", "model": model,
                            "L": L, **TRAIN, "losses": losses, "seconds": seconds,
                            "seconds_per_step": seconds / TRAIN["steps"],
                            "launches": launched, "card": card},
                     card_vg, (cpu_value_and_grad_on, "lattice", model, params,
                               *batches[0]), LATTICE_GRAD_RTOL))
        profiled(f"lattice {model}, {TRAIN_PROFILE_STEPS} steps",
                 lambda: run(TRAIN_PROFILE_STEPS), card)
    return runs


def whole_read():
    """A simulated read (squiggle_r94 on the card, seeded) of at least
    WHOLE_SAMPLES samples, with the attributes train/wholeread's region
    functions read."""
    import types

    from scrappie_torch.train.simulate import SquiggleSimulator
    from scrappie_torch.utils.maths import medmad_normalise

    sim = SquiggleSimulator(seed=SEED + 190, device="cuda")
    sig, bases, base_at = sim.simulate_read(WHOLE_SAMPLES // 6)
    require(len(sig) >= WHOLE_SAMPLES, f"whole read: {len(sig)} samples")
    return types.SimpleNamespace(norm=medmad_normalise(sig), base_at=base_at,
                                 bases=bases, name="whole")


# The whole-read steps: (kind, model, the region function)
WHOLE_RUNS = (("transducer", "rgrgr_r94", "region_seqstates"),
              ("crf", "rnnrf_r94", "region_sequence"),
              ("head", "rnnrf_r94", "region_sequence"),
              ("transducer", "nanonet_events", "region_event_seqstates"))


def events_sampler(read, nsample: int, nev: int | None = None):
    """What train/wholeread.region_event_seqstates reads of a read (as the
    JAX package's real-data sampler builds it): the events the port's
    detector finds in the read's signal, their nanonet features, each
    event's base (at its last sample) and the read's kmers, the training
    region ending at the first event past nsample samples, or after its
    first nev events."""
    import types

    import numpy as np

    from scrappie_torch.models.specs import KMER_LEN
    from scrappie_torch.signal.events import detect_events
    from scrappie_torch.signal.features import nanonet_features_from_events
    from scrappie_torch.train.simulate import _rolling_kmers
    from scrappie_torch.types import RawSignal

    et = detect_events(RawSignal(read.norm))
    ev = et.active
    last = np.minimum(ev["start"].astype(np.int64) + ev["length"].astype(np.int64) - 1,
                      len(read.base_at) - 1)
    return types.SimpleNamespace(
        _ev=[{"feats": nanonet_features_from_events(et, normalise=True),
              "ev_base": read.base_at[last].astype(np.int64),
              "kmers": _rolling_kmers(read.bases, KMER_LEN)}],
        _train_nev=[int(np.searchsorted(last, nsample)) if nev is None else
                    min(nev, len(last))], klen=KMER_LEN)


def wholeread_inputs(read, kind: str, model: str, region: str, params: dict,
                     nsample: int, nev: int | None = None):
    """(x, seq [1, L]) of the read's region of nsample samples for the
    kind's step: the signal [1, Tsig, 1], for "head" rnnrf_r94's features
    [1, T, 96] under params on the card, for region_event_seqstates the
    features [1, T, 4] of the events in those samples, or of the first
    nev."""
    import torch

    from scrappie_torch.models import forward
    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.train import wholeread

    if region == "region_event_seqstates":
        feats, seq = wholeread.region_event_seqstates(events_sampler(read, nsample, nev),
                                                      0, WHOLE_CHUNK)
        return feats[None], seq[None]
    spec = RAW_MODELS[model]
    sig, seq = getattr(wholeread, region)(read, nsample, spec.stride, WHOLE_CHUNK)
    x = sig[None, :, None]
    if kind == "head":
        with torch.no_grad():
            x = forward.rnnrf_features(
                {k: torch.as_tensor(v, device="cuda") for k, v in params.items()},
                torch.as_tensor(x, device="cuda"),
                conv_activation=spec.conv_activation, stride=spec.stride).cpu().numpy()
    return x, seq[None]


def main_path_wholeread(card: str, total: dict) -> list:
    """One step of each of WHOLE_RUNS on the card (phase main_path_train,
    run "wholeread"): make_wholeread_transducer_step (rgrgr_r94, and
    nanonet_events on the region's detected events),
    make_wholeread_step and make_head_step (rnnrf_r94) on the simulated
    region of WHOLE_SAMPLES samples (12 288 and 30 720 blocks, the events
    the detector finds there; chunk WHOLE_CHUNK), its loss finite and the
    lattice kernel launched, with its seconds and peak device memory; then
    the step under the profiler. Adds the launches to total; returns
    main_path_train's runs (the loss and gradients on the region's first
    WHOLE_CPU_BLOCKS blocks or events against the CPU's within
    LATTICE_GRAD_RTOL)."""
    import numpy as np
    import torch

    from scrappie_torch import ops
    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.train import wholeread
    from scrappie_torch.train.optim import FiniteClippedAdam

    makers = {"transducer": lambda m, o: wholeread.make_wholeread_transducer_step(
                  m, o, chunk=WHOLE_CHUNK),
              "crf": lambda m, o: wholeread.make_wholeread_step(m, o, chunk=WHOLE_CHUNK),
              "head": lambda m, o: wholeread.make_head_step(o, chunk=WHOLE_CHUNK)}
    kernels = {"transducer": ("lattice_fwdbwd", "gru_recurrence_bwd"),
               "crf": ("crf_lattice_fwdbwd", "crf_partition_grad", "gru_recurrence_bwd"),
               "head": ("crf_lattice_fwdbwd", "crf_partition_grad"),
               "events": ("lattice_fwdbwd", "lstm_pair_train", "lstm_recurrence_bwd")}
    read = whole_read()
    runs = []
    for i, (kind, model, region) in enumerate(WHOLE_RUNS):
        what = f"wholeread {kind} {model}"
        params = random_params(model, SEED + 195 + i)
        events = model not in RAW_MODELS
        full = wholeread_inputs(read, kind, model, region, params, WHOLE_SAMPLES)
        cut = (wholeread_inputs(read, kind, model, region, params, WHOLE_SAMPLES,
                                WHOLE_CPU_BLOCKS) if events else
               wholeread_inputs(read, kind, model, region, params,
                                WHOLE_CPU_BLOCKS * RAW_MODELS[model].stride))
        if kind == "head":
            params = {k: params[k] for k in wholeread.HEAD_KEYS}
        card_vg = value_and_grad_on(kind, model, params, *cut, "cuda")

        def run():
            opt = FiniteClippedAdam({k: torch.as_tensor(v, device="cuda").clone()
                                     for k, v in params.items()}, TRAIN["lr"])
            return float(makers[kind](model, opt)(*full))

        sync()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss = run()
        sync()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        require(bool(np.isfinite(loss)), f"{what}: the loss finite")
        require_kernels(what, launched, kernels["events" if events else kind])
        for k, v in launched.items():
            total[k] += v
        blocks = full[0].shape[1] // (1 if kind == "head" or events
                                      else RAW_MODELS[model].stride)
        runs.append((what, {"phase": "main_path_train", "run": "wholeread", "kind": kind,
                            "model": model, "blocks": blocks, "seq_len": full[1].shape[1],
                            "chunk": WHOLE_CHUNK, "loss": loss, "seconds": seconds,
                            "peak_bytes": torch.cuda.max_memory_allocated(),
                            "launches": launched, "cpu_blocks": WHOLE_CPU_BLOCKS,
                            "card": card},
                     card_vg, (cpu_value_and_grad_on, kind, model, params, *cut),
                     LATTICE_GRAD_RTOL))
        profiled(f"wholeread {kind} {model}, 1 step", run, card)
    return runs


# ----------------------------------------------------------------- serve

SERVE = dict(model="rgrgr_r94", batch_size=8, chunk_len=CHUNK, overlap=1000)
SERVE_FEED = 4000        # samples a live feed request
SERVE_CLIENTS = 4
SERVE_TIMEOUT = 300.0    # seconds a socket read and a client thread may take
# every kernel on the serving path: the GRU models' (the whole reads, the
# raw channels), the head (the channels' fused route), the CRF kernels
# (the request routed to rnnrf_r94) and the LSTM pair (events)
SERVE_KERNELS = ("project", "gru_recurrence", "head", "viterbi_fwd",
                 "viterbi_backtrace", "crf_fwd", "crf_backtrace",
                 "crf_partition", "lstm_pair")


class ServeClient:
    """One connection to the server: rpc() sends a request line and reads
    its answer, both bounded by SERVE_TIMEOUT."""

    def __init__(self, port: int):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=SERVE_TIMEOUT)
        self.rfile = self.sock.makefile("rb")

    def rpc(self, obj) -> dict:
        self.sock.sendall((json.dumps(obj) + "\n").encode())
        line = self.rfile.readline()
        require(bool(line), f"a response to {obj.get('op', 'read')}")
        resp = json.loads(line)
        require("error" not in resp, f"request {obj.get('id')}: {resp}")
        return resp

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()


def b64(sig) -> str:
    import base64

    import numpy as np

    return base64.b64encode(np.asarray(sig, "<f4").tobytes()).decode()


def serve_client(port: int, i: int, reads: list, live: dict, out: dict) -> None:
    """Client i: opens its live raw channel (client 2 also the events
    channel), then alternates its whole-read requests (every other one
    with qualities) with SERVE_FEED-sample feeds until both are done, and
    flushes; client 0 routes a read to rnnrf_r94, client 1 one to
    nanonet_events, client 3 asks for the stats last. Records each
    whole read's response and latency, and each channel's bases."""
    c = ServeClient(port)
    try:
        chans = {"c": live[i]}
        if i == 2:
            chans["e"] = live["events"]
        for name in chans:
            req = {"op": "open", "channel": name}
            if name == "e":
                req["pipeline"] = "events"
            require(c.rpc(req)["open"], f"client {i} opens {name}")
        requests = [(j, {"id": f"read{j:02d}", "signal_b64": b64(reads[j].raw)}
                     | ({"opts": {"with_qualities": True}} if j % 2 else {}))
                    for j in range(i, len(reads), SERVE_CLIENTS)]
        if i in (0, 1):
            model = ("rnnrf_r94", "nanonet_events")[i]
            requests.append((model, {"id": model, "model": model,
                                     "signal_b64": b64(reads[i].raw)}))
        offsets = {name: 0 for name in chans}
        bases = {name: "" for name in chans}
        while requests or any(offsets[n] < len(chans[n]) for n in chans):
            if requests:
                key, req = requests.pop(0)
                t0 = time.perf_counter()
                resp = c.rpc(req)
                out["latency"].append(time.perf_counter() - t0)
                out["responses"][key] = resp
            for name, sig in chans.items():
                off = offsets[name]
                if off < len(sig):
                    resp = c.rpc({"op": "feed", "channel": name,
                                  "signal_b64": b64(sig[off : off + SERVE_FEED])})
                    bases[name] += resp["bases"]
                    offsets[name] = off + SERVE_FEED
        for name in chans:
            resp = c.rpc({"op": "flush", "channel": name})
            require(resp["final"], f"client {i} flushes {name}")
            bases[name] += resp["bases"]
        out["live"][i] = bases["c"]
        if "e" in bases:
            out["live"]["events"] = bases["e"]
        if i == 3:
            out["stats"] = c.rpc({"op": "stats", "id": "stats"})
    finally:
        c.close()


def check_batch_invariance(card: str) -> None:
    """What a channel or a served read relies on: a row's decode does not
    depend on its batch. Eight seeded chunks of CHUNK samples through the
    rgrgr fused path (the channels' route) and the rgrgr posterior (the
    whole reads' stitch) at B = 8 and one at a time must give identical
    rows (paths, scores and log posteriors bit for bit)."""
    import numpy as np
    import torch

    from scrappie_torch.models.forward import load_model

    net = load_model("rgrgr_r94", "cuda")
    rng = np.random.default_rng(SEED + 70)
    sig = torch.as_tensor(rng.standard_normal((8, CHUNK, 1)).astype(np.float32),
                          device="cuda")
    with torch.inference_mode():
        score, path = net.basecall_fused(sig)
        post = net(sig)
        fused = posterior = 0
        for i in range(len(sig)):
            row = sig[i : i + 1].contiguous()
            s1, p1 = net.basecall_fused(row)
            fused += int(torch.equal(p1[0], path[i]) and torch.equal(s1[0], score[i]))
            posterior += int(torch.equal(net(row)[0], post[i]))
    emit({"phase": "batch_invariance", "rows": len(sig),
          "fused_rows_identical": fused, "posterior_rows_identical": posterior,
          "card": card})
    require(fused == posterior == len(sig), "rows decode alike at B = 1 and 8")


def main_path_serve(card: str, reads: list, pool) -> dict:
    """The serving path on the card: make_server(device="cuda", batch 8,
    chunk 10 000 / overlap 1 000) on 127.0.0.1 in a daemon thread, and
    SERVE_CLIENTS concurrent connections (serve_client) sending the reads
    as whole-read requests (half with qualities), a read routed to
    rnnrf_r94 and one to nanonet_events, four live raw channels and one
    events channel fed SERVE_FEED samples a request, and the stats op.
    Every kernel of SERVE_KERNELS must launch in that run (counts set to 0
    just before it). Then each whole read must equal a direct
    BasecallEngine call on the card with its options (sequence, nblock and
    nsample equal, score within FUSED_RTOL relative, qualities by
    quals_agree), each live channel a solo stream on the card fed its
    whole signal, and the shortest raw channel the port's CPU stream.
    Prints requests/s, the p50 and p95 request latency, live samples/s
    and the service's batches and engine calls."""
    import threading

    import numpy as np

    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.parallel.streaming import StreamingBasecaller
    from scrappie_torch.parallel.streaming_events import (
        EventsStreamingBasecaller,
    )
    from scrappie_torch.serve import make_server
    from scrappie_torch.utils.seqcompare import qual_diffs, quals_agree

    chunk, overlap = SERVE["chunk_len"], SERVE["overlap"]
    live = {i: reads[len(reads) - 1 - i].raw for i in range(SERVE_CLIENTS)}
    live["events"] = reads[len(reads) - 1 - SERVE_CLIENTS].raw
    short = min(range(SERVE_CLIENTS), key=lambda i: len(live[i]))
    twin = pool.submit(cpu_stream, SERVE["model"], chunk, overlap, live[short])

    server = make_server("127.0.0.1", 0, device="cuda", **SERVE)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = {"responses": {}, "latency": [], "live": {}, "stats": None}
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=serve_client,
                                    args=(port, i, reads, live, out))
                   for i in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=4 * SERVE_TIMEOUT)
            require(not t.is_alive(), "a serve client finished in time")
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        server.shutdown()
        thread.join(timeout=60)
        server.close_services()
        server.server_close()
    require(not thread.is_alive(), "the server thread stopped")
    require(len(out["responses"]) == len(reads) + 2 and out["stats"]
            and len(out["live"]) == SERVE_CLIENTS + 1,
            f"every client finished ({len(out['responses'])} responses, "
            f"{len(out['live'])} channels)")
    for name in SERVE_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} launched on the serve path ({launches[name]})")
    stats = out["stats"]

    # the same calls made directly on the card
    engines = {m: BasecallEngine(m, device="cuda", **(
        {k: v for k, v in SERVE.items() if k != "model"}
        if m != "nanonet_events" else {"batch_size": SERVE["batch_size"]}))
        for m in ("rgrgr_r94", "rnnrf_r94", "nanonet_events")}
    compared = 0
    for key, resp in out["responses"].items():
        model = key if isinstance(key, str) else "rgrgr_r94"
        j = {"rnnrf_r94": 0, "nanonet_events": 1}.get(key, key)
        opts = {"with_qualities": True} if resp.get("qual") else {}
        want = engines[model].basecall_signals([reads[j]], **opts)[0]
        require(resp["sequence"] == want.sequence and want.sequence
                and resp["nblock"] == want.nblock
                and resp["nsample"] == want.nsample,
                f"serve {resp['id']}: the direct engine call's call")
        rel = abs(resp["score"] - want.score) / max(abs(want.score), 1e-30)
        require(rel <= FUSED_RTOL, f"serve {resp['id']}: score rel err {rel}")
        if opts:
            require(quals_agree(resp["qual"], want.qual),
                    f"serve {resp['id']}: qualities {qual_diffs(resp['qual'], want.qual)}")
        compared += 1
    require(sum(1 for r in out["responses"].values() if "qual" in r)
            == len(reads) // 2, "half the reads came back with qualities")
    for key, sig in live.items():
        if key == "events":
            solo = EventsStreamingBasecaller(chunk, overlap, device="cuda")
        else:
            solo = StreamingBasecaller(SERVE["model"], chunk, overlap,
                                       device="cuda")
        solo.feed(sig)
        solo.flush()
        require(out["live"][key] == solo.sequence and solo.sequence,
                f"live channel {key}: the solo stream's bases")
    require(out["live"][short] == twin.result(),
            f"live channel {short}: the CPU stream's bases")
    lat = np.asarray(out["latency"])
    live_samples = sum(len(s) for s in live.values())
    emit({"phase": "main_path_serve", "requests": len(lat),
          "requests_per_s": len(lat) / wall,
          "latency_p50_s": float(np.percentile(lat, 50)),
          "latency_p95_s": float(np.percentile(lat, 95)),
          "live_channels": len(live), "live_samples": live_samples,
          "live_samples_per_s": live_samples / wall, "wall_s": wall,
          "service_batches": stats["batches"],
          "service_engine_calls": stats["engine_calls"],
          "service_requests": stats["requests"], "compared": compared,
          "launches": launches, "card": card})
    return launches


def time_checkout(checkout: pathlib.Path) -> None:
    """Times the scrappie_torch of `checkout`, imported from there (its
    kernels built there), on inputs made by this script: the Viterbi
    forward at nhist 1024 on seeded log posteriors at T_BLOCKS blocks and
    each of FWD_BATCHES and at STITCH_SHAPE (CUDA events, median of 10),
    the Viterbi backtrace at BT_AB on the traceback the checkout's own
    forward wrote from those log posteriors (median of 10),
    the DTW's Viterbi DP and forward variant at MAP_BASES positions x
    MAP_SAMPLES samples (dtw_case; median of 3), the DTW walk on that DP's
    moves and on those of a DTW_SHARED case (median of 10), and
    map_signal_to_squiggle
    on a read made as main_path_mapping makes it (host clock, median of 3
    after one call), the CRF forward, partition function, backtrace (on
    the checkout's own forward's traceback), posterior and partition
    gradient (g = 1) at CRF_AB shapes on seeded transitions (2 x standard
    normal; CUDA events, median of 10), the lattice losses
    (time_lattices), the GRU recurrence, its backward
    walk and whole backward (ops/gru.gru_tm, gru_walk, gru_tm_backward:
    T_BLOCKS blocks, S = 96,
    B = 8 and 64, seeded input, weights 0.1 x standard normal and output
    gradient, the gates from the checkout's own forward; median of 10),
    the rnnrf fused path, RnnrfModel.basecall_fused, at
    B = 64 chunks of CHUNK samples (median of 5), the seqmap DP, Viterbi
    with its traceback (median of 10) and forward (median of 5), on the
    posterior and reference of seqmap_case, the banded DP (map_banded_tm,
    Viterbi and forward, median of 10) on them with the bands of MAP_BAND,
    and the four MAP_CALLS of
    map_post_to_sequence on them (host clock, median of 3 after one call),
    the seqmap walk on the checkout's own DP's moves (alone, median of 10,
    and in bursts of 10) and the DP with its walk (median of 10),
    the head (time_head), the LSTM's big-S walk and a big-S training step
    (time_lstm_big_s), the lattice losses (time_lattices) and the fast
    engine (time_engines). Prints one JSON line."""
    sys.path.insert(0, str(checkout))
    import numpy as np
    import torch

    import scrappie_torch
    from scrappie_torch import api
    from scrappie_torch.decode.dtw import match_inputs
    from scrappie_torch.decode.mapping import banded_inputs
    from scrappie_torch.models.forward import RnnrfModel
    from scrappie_torch.ops import _build, crf as c, dtw as d, gru as g
    from scrappie_torch.ops import seqmap as m, viterbi as v

    require(pathlib.Path(scrappie_torch.__file__).resolve().is_relative_to(checkout),
            f"scrappie_torch imported from {checkout}")
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 97)
    rng = np.random.default_rng(SEED + 98)
    out = {}
    with torch.inference_mode():
        for T, B in [(T_BLOCKS, b) for b in FWD_BATCHES] + [STITCH_SHAPE]:
            lp, _ = seeded_logposts((T, B, 1025), gen)
            out[f"viterbi_fwd_ms B = {B}, T = {T}"] = cuda_ms(
                lambda: v.viterbi_scores_tm(lp), reps=10)
            if (T, B) in BT_AB:
                final, tb = v.viterbi_scores_tm(lp)
                out[f"viterbi_backtrace_ms B = {B}, T = {T}"] = cuda_ms(
                    lambda: v.viterbi_backtrace_tm(final, tb), reps=10)
                del final, tb
            del lp
        sig, params = dtw_case(MAP_BASES, MAP_SAMPLES, rng)
        args = (sig, *match_inputs(params, 1.0, 0.0, "cuda"), 0.0,
                *DTW_OPTIONS.values())
        out["dtw_viterbi_ms"] = cuda_ms(lambda: d.squiggle_match_tm(*args),
                                        **TWIN_REPS)
        out["dtw_forward_ms"] = cuda_ms(
            lambda: d.squiggle_match_tm(*args, viterbi=False), **TWIN_REPS)
        final, moves, end_src = d.squiggle_match_tm(*args)
        out[f"dtw_walk_ms T = {MAP_SAMPLES}"] = cuda_ms(
            lambda: d.dtw_walk(final, moves, end_src), reps=10)
        del final, moves, end_src
        sig, params = dtw_case(*DTW_SHARED, rng)
        sargs = (sig, *match_inputs(params, 1.0, 0.0, "cuda"), 0.0,
                 *DTW_OPTIONS.values())
        final, moves, end_src = d.squiggle_match_tm(*sargs)
        out[f"dtw_walk_ms T = {DTW_SHARED[1]}"] = cuda_ms(
            lambda: d.dtw_walk(final, moves, end_src), reps=10)
        del final, moves, end_src
    seq = random_bases(MAP_BASES, rng)
    data = mapping_signal(api.sequence_to_squiggle(seq, device="cuda"), rng)
    api.map_signal_to_squiggle(data, seq, device="cuda")
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        api.map_signal_to_squiggle(data, seq, device="cuda")
        seconds.append(time.perf_counter() - t0)
    out["map_signal_to_squiggle_s"] = statistics.median(seconds)
    with torch.inference_mode():
        for T, B in CRF_AB:
            trans = 2.0 * torch.randn((T, B, 25), generator=gen, device="cuda")
            out[f"crf_fwd_ms B = {B}, T = {T}"] = cuda_ms(
                lambda: c.crf_viterbi_scores_tm(trans), reps=10)
            out[f"crf_partition_ms B = {B}, T = {T}"] = cuda_ms(
                lambda: c.crf_partition_tm(trans), reps=10)
            final, tb = c.crf_viterbi_scores_tm(trans)
            out[f"crf_backtrace_ms B = {B}, T = {T}"] = cuda_ms(
                lambda: c.crf_backtrace_tm(final, tb), reps=10)
            out[f"crf_posterior_ms B = {B}, T = {T}"] = cuda_ms(
                lambda: c.crf_posterior_tm(trans), reps=10)
            ones = torch.ones(B, device="cuda")
            out[f"crf_partition_grad_ms B = {B}, T = {T}"] = cuda_ms(
                lambda: c.crf_partition_grad_tm(trans, ones), reps=10)
        S = 96
        for B in (8, 64):
            x = torch.randn((T_BLOCKS, B, 3 * S), generator=gen, device="cuda")
            sW = 0.1 * torch.randn((S, 2 * S), generator=gen, device="cuda")
            sW2 = 0.1 * torch.randn((S, S), generator=gen, device="cuda")
            gh = torch.randn((T_BLOCKS, B, S), generator=gen, device="cuda")
            h = g.gru_tm(x, sW, sW2, False)
            out[f"gru_tm_ms B = {B}, T = {T_BLOCKS}"] = cuda_ms(
                lambda: g.gru_tm(x, sW, sW2, False), reps=10)
            h_prev, gates = g.backward_inputs(x, h, sW, sW2, False)
            out[f"gru_walk_ms B = {B}, T = {T_BLOCKS}"] = cuda_ms(
                lambda: g.gru_walk(gates, h_prev, gh, sW, sW2, False), reps=10)
            out[f"gru_tm_backward_ms B = {B}, T = {T_BLOCKS}"] = cuda_ms(
                lambda: g.gru_tm_backward(x, h, sW, sW2, gh, False), reps=10)
        rnet = RnnrfModel.from_registry("rnnrf_r94", "cuda")
        chunks = torch.as_tensor(
            rng.standard_normal((64, CHUNK, 1)).astype(np.float32), device="cuda")
        out["rnnrf_fused_ms B = 64"] = cuda_ms(lambda: rnet.basecall_fused(chunks),
                                               reps=5)
    post, ref = seqmap_case(np.random.default_rng(SEED + 99))
    lp = torch.as_tensor(post.data(), device="cuda")
    states = torch.as_tensor(api.encode_bases(ref, 5).astype(np.int32), device="cuda")
    with torch.inference_mode():
        out["seqmap_viterbi_ms"] = cuda_ms(
            lambda: m.map_to_sequence_tm(lp, states, 0.0, 0.0, 4.0), reps=10)
        out["seqmap_forward_ms"] = cuda_ms(
            lambda: m.map_to_sequence_tm(lp, states, 0.0, 0.0, 4.0, viterbi=False),
            reps=5)
        bargs = banded_inputs(lp, api.encode_bases(ref, 5).astype(np.int64),
                              *banded_case(lp, MAP_BASES, MAP_BAND), 0.3)
        out["banded_viterbi_ms"] = cuda_ms(
            lambda: m.map_banded_tm(lp, *bargs, 0.0, 0.3, 4.0), reps=10)
        out["banded_forward_ms"] = cuda_ms(
            lambda: m.map_banded_tm(lp, *bargs, 0.0, 0.3, 4.0, viterbi=False),
            reps=10)
        seqlen = states.shape[0]
        final, moves = m.map_to_sequence_tm(lp, states, 0.0, 0.0, 4.0)
        out[f"seqmap_walk_ms T = {lp.shape[0]}"] = cuda_ms(
            lambda: m.seqmap_walk(final, moves, seqlen), reps=10)
        out[f"seqmap_walk_burst_ms T = {lp.shape[0]}"] = cuda_ms(
            lambda: m.seqmap_walk(final, moves, seqlen), reps=5, burst=10)
        out["seqmap_viterbi_walk_ms"] = cuda_ms(
            lambda: m.seqmap_walk(*m.map_to_sequence_tm(lp, states, 0.0, 0.0, 4.0),
                                  seqlen), reps=10)
        del final, moves
    del lp, states, bargs
    for what, kw in MAP_CALLS:
        api.map_post_to_sequence(post, ref, device="cuda", **kw)
        seconds = []
        for _ in range(3):
            t0 = time.perf_counter()
            api.map_post_to_sequence(post, ref, device="cuda", **kw)
            seconds.append(time.perf_counter() - t0)
        out[f"map_post_to_sequence_s {what}"] = statistics.median(seconds)
    with torch.inference_mode():
        out.update(time_head())
    out.update(time_lstm_big_s())
    out.update(time_lattices())
    out.update(time_engines())
    print(json.dumps(out), flush=True)


def time_lstm_big_s() -> dict:
    """The imported scrappie_torch's LSTM big-S walk (ops/lstm.lstm_walk_pair,
    both directions) at each LSTM_BIG_S_WALKS shape, T_BIG_S steps, on the
    planes of its own big-S training forward (seeded weights of scale
    S^-1/2; median of 5), and one training step of a big-S stage at the
    first shape: ops/lstm.lstm_pair_tm on a [T_BIG_S, B, 96] input with
    gradients wanted, forward and backward (the projection, the training
    forward, the walk, dsW; median of 5)."""
    import numpy as np
    import torch

    from scrappie_torch.ops import lstm as L

    rng = np.random.default_rng(SEED + 93)
    f = lambda *shape, scale=1.0: torch.as_tensor(
        (scale * rng.standard_normal(shape)).astype(np.float32), device="cuda")
    out = {}
    T, C = T_BIG_S, 96
    with torch.no_grad():
        for S, B in LSTM_BIG_S_WALKS:
            lw = [(f(S, 4 * S, scale=S ** -0.5), f(3 * S, scale=0.3)) for _ in "FB"]
            planes = L.lstm_pair_train_cuda(f(T, B, 8 * S), *lw[0], *lw[1])[2:]
            dirs = [(planes[0], f(T, B, S), *lw[0], False),
                    (planes[1], f(T, B, S), *lw[1], True)]
            out[f"lstm_big_s_walk_ms S = {S}, B = {B}, T = {T}"] = cuda_ms(
                lambda: L.lstm_walk_pair(dirs), reps=5)
            del planes, dirs
    S, B = LSTM_BIG_S_WALKS[0]
    x = f(T, B, C).requires_grad_(True)
    ws = [[f(C, 4 * S, scale=C ** -0.5).requires_grad_(True),
           f(4 * S, scale=0.1).requires_grad_(True),
           f(S, 4 * S, scale=S ** -0.5).requires_grad_(True),
           f(3 * S, scale=0.3).requires_grad_(True)] for _ in "FB"]
    gh = (f(T, B, S), f(T, B, S))

    def step():
        hF, hB = L.lstm_pair_tm(x, ws[0], ws[1])
        ((hF * gh[0]).sum() + (hB * gh[1]).sum()).backward()

    out[f"lstm_big_s_train_step_ms S = {S}, B = {B}, T = {T}"] = cuda_ms(step, reps=5)
    return out


def time_engines() -> dict:
    """The imported scrappie_torch's fast engine, rgrgr_r94 alone and the
    3:1:1 ensemble (ENSEMBLE), on synthetic_reads(): wall seconds of
    basecall_signals, median of 3 after one call."""
    import torch

    from scrappie_torch.parallel.runner import BasecallEngine

    reads = synthetic_reads()
    out = {}
    for label, kw in (("rgrgr_r94 fast", {}), ("3:1:1 fast", {"ensemble": ENSEMBLE})):
        eng = BasecallEngine("rgrgr_r94", device="cuda", mode="fast", **kw)
        eng.basecall_signals(reads)
        seconds = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.basecall_signals(reads)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out[f"engine_s {label}"] = statistics.median(seconds)
    return out


def host_us(fn, reps: int = 20) -> float:
    """Microseconds of host time a call of fn() takes while the card runs
    behind it: reps calls back to back, no synchronisation between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def time_head() -> dict:
    """The imported scrappie_torch's head, ops/viterbi.head_logpost_tm, on
    seeded features (tanh of 2 x standard normal, T_BLOCKS blocks, S = 96)
    with the FF heads of rgrgr_r94 and ENSEMBLE (this script's npz files,
    placed outside inference mode as the port's loaders place weights):
    one model and the three at 3:1:1, at each of HEAD_ENS_BATCHES: a call
    alone (CUDA events, median of 10; the host's time before the launch
    included), per call in bursts of 10 (the device's own time where the
    host keeps ahead) and the host's time a call (host_us); and the
    device's peak memory above what it held for one call of the three at
    the last B; then one model at the widest S the parent took (S = 352,
    seeded W, T_BIG_S blocks, B = 8; in bursts of 10)."""
    import numpy as np
    import torch

    from scrappie_torch.ops import viterbi as v

    params = pathlib.Path(__file__).resolve().parent / "scrappie_tpu" / "models" / "params"
    heads = [np.load(params / f"{m}.npz") for m in ("rgrgr_r94",) + ENSEMBLE]
    with torch.inference_mode(False):  # placed as the port's loaders place weights
        W = torch.as_tensor(np.stack([z["FF_W"] for z in heads]), device="cuda")
        b = torch.as_tensor(np.stack([z["FF_b"] for z in heads]), device="cuda")
    w = torch.tensor([0.6, 0.2, 0.2], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 177)
    out = {}
    for B in HEAD_ENS_BATCHES:
        h = torch.tanh(2.0 * torch.randn((3, T_BLOCKS, B, 96), generator=gen,
                                         device="cuda"))
        for K, call in ((1, lambda: v.head_logpost_tm(h[0], W[0], b[0])),
                        (3, lambda: v.head_logpost_tm(h, W, b, w))):
            out[f"head_ms K = {K}, B = {B}"] = cuda_ms(call, reps=10)
            out[f"head_burst_ms K = {K}, B = {B}"] = cuda_ms(call, reps=10, burst=10)
            out[f"head_host_us K = {K}, B = {B}"] = host_us(call)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    v.head_logpost_tm(h, W, b, w)
    sync()
    out[f"head_peak_bytes K = 3, B = {B}"] = torch.cuda.max_memory_allocated() - base
    # the widest S the parent's head took (the big-S GRU's), T_BIG_S blocks
    S = BIG_S["gru"][1]
    with torch.inference_mode(False):
        Ws = 2.0 / S ** 0.5 * torch.randn((S, 1025), generator=gen, device="cuda")
    hs = torch.tanh(2.0 * torch.randn((T_BIG_S, 8, S), generator=gen, device="cuda"))
    out[f"head_ms K = 1, S = {S}, T = {T_BIG_S}, B = 8"] = cuda_ms(
        lambda: v.head_logpost_tm(hs, Ws, b[0]), reps=10, burst=10)
    return out


# The lattices --ab times: (kind, what, (T, B, L), chunk); None keeps every
# step's rows, as the windows' losses do.
LATTICE_AB = (("transducer", "window", (800, 8, 800), None),
              ("crf", "window", (2000, 8, 1408), None),
              ("transducer", "whole read", (*WHOLE_READ_SHAPE[:1], 1, WHOLE_READ_SHAPE[1]),
               WHOLE_CHUNK),
              ("crf", "whole read", (*WHOLE_READ_SHAPE[:1], 1, WHOLE_READ_SHAPE[1]),
               WHOLE_CHUNK))


def time_lattices() -> dict:
    """The imported scrappie_torch's lattice losses, forward and backward
    through ops/lattice's lattice_forward_tm and crf_lattice_tm and
    torch.autograd.grad (both logZ_local and log P for the CRF), at each of
    LATTICE_AB's shapes on seeded inputs (log_softmax of 2 x standard
    normal, or 2 x standard normal transitions; random kmer states or
    bases), with its chunk where the checkout takes one (CUDA events,
    median of 5, the whole read's of 3), and each whole read's peak device
    memory above what it was before."""
    import inspect

    import torch

    from scrappie_torch.ops import lattice as tl

    takes_chunk = "chunk" in inspect.signature(tl.lattice_forward_tm).parameters
    gen = torch.Generator(device="cuda").manual_seed(SEED + 163)
    out = {"lattice_chunked": takes_chunk}
    for kind, what, (T, B, L), chunk in LATTICE_AB:
        if kind == "transducer":
            x = torch.log_softmax(2.0 * torch.randn((T, B, 1025), generator=gen,
                                                   device="cuda"), -1)
            seq = torch.randint(0, 1024, (B, L), generator=gen, device="cuda",
                                dtype=torch.int32)
        else:
            x = 2.0 * torch.randn((T, B, 25), generator=gen, device="cuda")
            seq = torch.randint(0, 4, (B, L), generator=gen, device="cuda",
                                dtype=torch.int32)
        x.requires_grad_(True)
        g = torch.randn((2, B), generator=gen, device="cuda")
        kw = {"chunk": chunk} if takes_chunk and chunk else {}

        def run():
            if kind == "transducer":
                loss = (tl.lattice_forward_tm(x, seq, 0.0, 4.0, 4.0, **kw) * g[0]).sum()
            else:
                logp, logz = tl.crf_lattice_tm(x, seq, 4.0, **kw)
                loss = (logp * g[0]).sum() + (logz * g[1]).sum()
            return torch.autograd.grad(loss, x)

        whole = what == "whole read"
        key = f"{kind}_lattice_ms {what} T = {T}, B = {B}, L = {L}"
        out[key] = cuda_ms(run, reps=3 if whole else 5, warmup=1)
        if whole:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            out[f"{kind}_lattice_peak_bytes {what}"] = (
                torch.cuda.max_memory_allocated() - base)
        del x, seq
    return out


def compare_checkouts(other: pathlib.Path) -> None:
    """time_checkout of another checkout and of this one, each in a fresh
    process, in turns other, this, this, other, so that both see the card
    in the same state: one JSON line a turn, then the card's name and power
    limit."""
    here = pathlib.Path(__file__).resolve().parent
    turns = (("other", other), ("this", here), ("this", here), ("other", other))
    for i, (label, checkout) in enumerate(turns):
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--times", str(checkout)], capture_output=True,
                              text=True)
        require(proc.returncode == 0, f"timing {checkout} exited "
                                      f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        emit({"turn": i, "checkout": label, "path": str(checkout),
              **json.loads(proc.stdout.strip().splitlines()[-1])})
    print(card_line(), flush=True)


# ------------------------------------------------------------ precision
# The precision policy (nn/config.py) on the card: each kernel with
# products against its twin with the same operand rounding, in 'default'
# (TF32) and 'bf16' (phase precision_kernels). Kernel and twin round the
# same operands the same way and multiply them exactly, so only the order
# of the sums differs: the projection's output within PRECISION_ATOL, the
# head's (its sums on the tensor cores) within HEAD_TC_ATOL. A recurrence rounds the h it carries at every step, so a
# sum's last bit can move a rounded h by one of its mode's ulps, and the
# next steps carry that: h (bounded by 1) within four ulps of the mode at
# 1 (TF32 2^-11, bfloat16 2^-8; measured: bfloat16's GRU h 5.4e-3 apart).
PRECISION_MODES = ("default", "bf16")
PRECISION_ROUNDING = {"highest": None, "default": "tf32", "bf16": "bf16"}
PRECISION_H_ATOL = {"default": 4 * 2.0 ** -11, "bf16": 4 * 2.0 ** -8}
PRECISION_ATOL = {"default": 1e-3, "bf16": 1e-3}
# The head runs its product on the tensor cores in these modes (mma.sync,
# csrc/head.cu): a logit's 96 exact products summed in the tensor cores'
# order and fp32 accumulation, not the twin's, and lp moves by at most
# twice a logit's move (the softmax and robustlog) plus the
# renormalisation's (read: 3.1e-5 and 1.7e-5 at K = 1, T = 2000, B = 64 on
# an H100, 1.0e-5 and 8e-6 at K = 3).
HEAD_TC_ATOL = {"default": 2e-4, "bf16": 2e-4}
# The paths whose calls each mode changes (phase precision_paths): model,
# engine keywords.
PRECISION_PATHS = (("rgrgr_r94", dict(mode="fast")),
                   ("rnnrf_r94", dict(mode="stitch")),
                   ("nanonet_events", dict(mode="fast")),
                   ("rgrgr_r94", dict(mode="fast", ensemble=ENSEMBLE)))
# Phase realdata: a simulated read of the bundled read ch174_read172's
# trimmed length ([200, 80 990)), and a shorter one held to the CPU.
REAL_SAMPLES = 80790
REAL_CPU_SAMPLES = 20000
REAL_SCORE_RTOL = 1e-5
# Phase crf_assoc: the associative scan against the sequential kernels.
# (the posteriors of two float32 recursions over 31 744 steps, the scan's
# sums in log depth; measured 1.35e-4 apart)
ASSOC_SCORE_RTOL = 1e-4
ASSOC_POST_ATOL = 5e-4


def in_mode(mode: str, fn):
    """fn() under precision `mode`, the mode before restored after."""
    from scrappie_torch.nn import config

    with config.precision(mode):
        return fn()


def precision_case(name: str, kernel, twin, tol) -> dict:
    """kernel() (a tensor or a tuple of them) in each mode against
    twin(rounding) with the mode's rounding: finite, the largest
    difference within tol[mode] (one bound for every output, or a list of
    one an output); its time in each mode and in 'highest', and how far
    'bf16' moved it from 'highest'. A tuple's row also lists each output's
    error and move (max_abs_errs_<mode>, moved_from_highest_<mode>); every
    row each output's relative L2 to the twin and to 'highest'
    (rel_l2_<mode>, moved_rel_l2_<mode>)."""
    import torch

    as_tuple = lambda t: t if isinstance(t, tuple) else (t,)
    diffs = lambda a, b: [float((x - y).abs().max()) for x, y in zip(a, b)]
    row = {"ms_highest": cuda_ms(lambda: in_mode("highest", kernel), reps=10)}
    exact = as_tuple(in_mode("highest", kernel))
    for mode in PRECISION_MODES:
        got = as_tuple(in_mode(mode, kernel))
        want = as_tuple(twin(PRECISION_ROUNDING[mode]))
        sync()
        require(all(bool(torch.isfinite(t).all()) for t in got),
                f"{name} {mode}: finite")
        errs, moved = diffs(got, want), diffs(got, exact)
        bounds = tol[mode] if isinstance(tol[mode], list) else [tol[mode]] * len(errs)
        for i, (err, bound) in enumerate(zip(errs, bounds)):
            require(err <= bound,
                    f"{name} {mode} output {i}: max abs err {err} <= {bound}")
        row[f"max_abs_err_{mode}"] = max(errs)
        row[f"moved_from_highest_{mode}"] = max(moved) if len(got) == 1 else moved
        if len(got) > 1:
            row[f"max_abs_errs_{mode}"] = errs
        row[f"rel_l2_{mode}"] = [rel_l2(g, w) for g, w in zip(got, want)]
        row[f"moved_rel_l2_{mode}"] = [rel_l2(g, e) for g, e in zip(got, exact)]
        row[f"ms_{mode}"] = cuda_ms(lambda: in_mode(mode, kernel), reps=10)
    return row


def check_precision_kernels(net, enet, card: str) -> dict:
    """The four kernels with products in 'default' and 'bf16' against
    their twins with the same rounding, at the shapes their paths run: the
    projection (rgrgr_r94's first GRU layer, T = 2000, B = 64, K = 96,
    N = 288), the GRU recurrence (its projected input, both modes of the
    kernel: registers at S = 96, and the big-S mode at S = 160), the head
    (K = 1 and 3 at T = 2000, B = 64) and the LSTM recurrence (the events
    network's first stage, T = 2048, B = 64, both directions a launch; one
    layer in the big-S mode at S = 160); each kernel's time in each mode
    beside 'highest' (phase precision_kernels). Returns
    {kernel: {max_abs_err_<mode>, ms_<mode>}} for the kernels line."""
    import numpy as np
    import torch

    from scrappie_torch.nn import rnn
    from scrappie_torch.nn.layers import affine, conv1d, window
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops import lstm as L
    from scrappie_torch.ops import viterbi as v
    from scrappie_torch.ops.pipeline import (CONV_ACT, ensemble_features_tm,
                                             lstm_weights)
    from scrappie_torch.ops.project import project_tm

    t0 = time.perf_counter()
    B = 64
    rng = np.random.default_rng(SEED + 300)
    p = net.params
    sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                          device="cuda")
    x = CONV_ACT[net.conv_activation](
        conv1d(sig, p["conv_W"], p["conv_b"], net.stride)).transpose(0, 1).contiguous()
    iW, bias, sW, sW2 = (p[f"gruB1_{k}"] for k in ("iW", "b", "sW", "sW2"))
    xproj = project_tm(x, iW, bias)
    h = g.gru_layer_tm(x, *(p[f"gruF2_{k}"] for k in ("iW", "b", "sW", "sW2")))
    out = {
        "project": precision_case(
            "project", lambda: project_tm(x, iW, bias),
            lambda r: affine(x, iW, bias, r), PRECISION_ATOL),
        "gru_recurrence": precision_case(
            "gru_recurrence", lambda: g.gru_tm(xproj, sW, sW2, True),
            lambda r: rnn.gru_tm(xproj, sW, sW2, True, r), PRECISION_H_ATOL),
        "head": precision_case(
            "head K = 1", lambda: v.head_logpost_tm(h, p["FF_W"], p["FF_b"]),
            lambda r: v.head_logpost_tm_plain(h, p["FF_W"], p["FF_b"], rounding=r),
            HEAD_TC_ATOL)}
    nets = ensemble_nets()
    h3, W3, b3 = ensemble_features_tm(
        [n.params for n in nets], sig, kinds=("rgrgr",) * 3,
        conv_activations=[n.conv_activation for n in nets], stride=5)
    w3 = ensemble_weights(3)
    out["head"]["K3"] = precision_case(
        "head K = 3", lambda: v.head_logpost_tm(h3, W3, b3, w3),
        lambda r: v.head_logpost_tm_plain(h3, W3, b3, w3, rounding=r),
        HEAD_TC_ATOL)
    for K, row in ((1, out["head"]), (3, out["head"]["K3"])):
        row.update({f"bound_ms_{mode}": kernel_work(
            "head", T=T_BLOCKS, B=B, K=K, S=96, nstate=W3.shape[-1],
            mode=mode)["bound_ms"] for mode in PRECISION_ROUNDING})
    del h3, W3, b3
    # the LSTM: the events network's first stage
    e = enet.params
    xe = window(events_input(enet, B, rng), enet.winlen, 1).transpose(0, 1).contiguous()
    wF, wB = (lstm_weights(e, d, 1) for d in ("F", "B"))
    S = wF[2].shape[0]
    xpair = project_tm(xe, torch.cat((wF[0], wB[0]), 1), torch.cat((wF[1], wB[1])))
    out["lstm_pair"] = precision_case(
        "lstm_pair", lambda: L.lstm_pair_recurrence_cuda(xpair, *wF[2:], *wB[2:]),
        lambda r: (rnn.lstm_tm(xpair[..., :4 * S], *wF[2:], False, rounding=r),
                   rnn.lstm_tm(xpair[..., 4 * S:], *wB[2:], True, rounding=r)),
        PRECISION_H_ATOL)
    out["lstm_layer"] = precision_case(
        "lstm_layer", lambda: L.lstm_recurrence_cuda(
            xpair[..., 4 * S:].contiguous(), *wB[2:], True),
        lambda r: rnn.lstm_tm(xpair[..., 4 * S:], *wB[2:], True, rounding=r),
        PRECISION_H_ATOL)
    # the big-S modes (weights read from L2), seeded weights at S = 160
    gen = torch.Generator(device="cuda").manual_seed(SEED + 301)
    Sb, Tb, Bb = BIG_S_BWD, T_BIG_S, 8
    rnd = lambda *shape, s=0.3: s * torch.randn(shape, generator=gen, device="cuda")
    gx, gsW, gsW2 = rnd(Tb, Bb, 3 * Sb, s=1.0), rnd(Sb, 2 * Sb, s=0.1), rnd(Sb, Sb, s=0.1)
    out["gru_recurrence_global"] = precision_case(
        "gru_recurrence_global", lambda: g.gru_tm(gx, gsW, gsW2, False),
        lambda r: rnn.gru_tm(gx, gsW, gsW2, False, r), PRECISION_H_ATOL)
    lx, lsW, lp = rnd(Tb, Bb, 4 * Sb, s=1.0), rnd(Sb, 4 * Sb, s=0.1), rnd(3 * Sb)
    out["lstm_layer_global"] = precision_case(
        "lstm_layer_global", lambda: L.lstm_recurrence_cuda(lx, lsW, lp, False),
        lambda r: rnn.lstm_tm(lx, lsW, lp, False, rounding=r), PRECISION_H_ATOL)
    emit({"phase": "precision_kernels", "T": T_BLOCKS, "B": B,
          "lstm": {"T": T_EVENTS, "B": B, "S": S},
          "big_s": {"S": Sb, "T": Tb, "B": Bb}, "kernels": out,
          "seconds": round(time.perf_counter() - t0, 3), "card": card})
    return out


def precision_cpu_call(mode: str, model: str, engine_kw: dict, sig):
    """One read's call on the CPU under precision `mode`, in a worker
    process."""
    import torch

    from scrappie_torch.nn import config
    from scrappie_torch.parallel.runner import BasecallEngine

    torch.set_num_threads(1)
    with config.precision(mode):  # the worker runs other jobs after
        return BasecallEngine(model, device="cpu",
                              **engine_kw).basecall_signals([sig])[0].sequence


def precision_paths(card: str, reads: list, pool) -> dict:
    """The 16 reads through each of PRECISION_PATHS on the card in
    'highest', 'default' and 'bf16': every read called in each mode, and
    the edit distance of each mode's calls to 'highest''s (a figure, not a
    gate); then each path's shortest read in 'bf16' on the card against
    the CPU's 'bf16' call (phase cpu_vs_cuda, a figure: the CPU runs in
    the pool meanwhile). Returns {path: {mode: (edits, bases)}}."""
    from scrappie_torch.parallel.runner import BasecallEngine
    from scrappie_torch.utils.seqcompare import edit_distance

    t0 = time.perf_counter()
    short = min(range(len(reads)), key=lambda i: len(reads[i].raw))
    jobs = {i: pool.submit(precision_cpu_call, "bf16", model, kw, reads[short])
            for i, (model, kw) in enumerate(PRECISION_PATHS)}
    table = {}
    for i, (model, kw) in enumerate(PRECISION_PATHS):
        label = model + (" 3:1:1" if "ensemble" in kw else "") + f" {kw['mode']}"
        engine = BasecallEngine(model, device="cuda", **kw)
        calls, seconds = {}, {}
        for mode in ("highest",) + PRECISION_MODES:
            t1 = time.perf_counter()
            res = in_mode(mode, lambda: engine.basecall_signals(reads))
            seconds[mode] = time.perf_counter() - t1
            require(all(r.sequence for r in res), f"precision {label} {mode}: every read called")
            calls[mode] = [r.sequence for r in res]
        row = {}
        for mode in PRECISION_MODES:
            dists = [edit_distance(a, b) for a, b in zip(calls[mode], calls["highest"])]
            row[mode] = {"edits": sum(dists), "bases": sum(map(len, calls["highest"])),
                         "reads_differing": sum(d > 0 for d in dists),
                         "edits_per_base": sum(dists) / sum(map(len, calls["highest"]))}
        table[label] = row
        emit({"phase": "precision_paths", "path": label, "reads": len(reads),
              "against_highest": row, "seconds": seconds, "card": card})
        cpu = jobs[i].result()
        g = calls["bf16"][short]
        emit({"phase": "cpu_vs_cuda", "path": f"precision_paths {label}",
              "precision": "bf16", "read": reads[short].uuid, "bases": len(g),
              "edit_distance": 0 if g == cpu else edit_distance(g, cpu)})
    emit({"phase": "precision_paths", "seconds": round(time.perf_counter() - t0, 3)})
    return table


# ------------------------------------------------------- precision_train

#: One ulp of a mode's rounding (fp32 carries 24 bits; TF32 11, bfloat16
#: 8): each output of a walk or training forward is held to PRECISION_ULPS
#: of the mode at its own largest magnitude in the 'highest' twin,
#: precision_kernels' gate for h in [-1, 1] (PRECISION_H_ATOL) carried to
#: outputs of any scale.
PRECISION_ULP = {"default": 2.0 ** -11, "bf16": 2.0 ** -8}
PRECISION_ULPS = 4
#: That gate is wider than the mode's own move: over thousands of steps a
#: rounding that the kernel's and the twin's fp32 orders of summation take
#: apart is carried into every later step and its roundings, so at the
#: full length a kernel lies as little as 1.7 times nearer its mode's twin
#: than the 'highest' one (relative L2; PERF.md, section 6). The
#: rounding itself is checked where no such flip has been carried far: on
#: the first PRECISION_SHORT_T steps of the same inputs each output's
#: relative L2 to its mode's twin is at most 1/PRECISION_NEARER of its
#: relative L2 to the 'highest' twin (at 16 steps the TF32 walks were
#: already only 4.6 times nearer). A kernel that ignores its rounding code
#: lies as near the 'highest' twin as its mode's twin moves from it.
PRECISION_SHORT_T = 4
PRECISION_NEARER = 4
#: A framewise step under 'bf16' on the card against the port's CPU step on
#: the same batch: two fp32 orders of summation that round to bfloat16 take
#: different roundings once one falls the other way, so the loss, the
#: gradient's global norm and the whole gradient's relative L2 are
#: compared, not each entry; the gradient also lies PRECISION_NEARER times
#: nearer the CPU's 'bf16' one than the card's 'highest' one does.
PRECISION_TRAIN_LOSS_RTOL = 1e-3
PRECISION_TRAIN_NORM_RTOL = 2e-2
PRECISION_TRAIN_GRAD_RTOL = 2e-3
PRECISION_TRAIN_MODELS = ("rgrgr_r94", "rnnrf_r94", "nanonet_events")
PRECISION_TRAIN_BATCH = dict(batch=4, nsample=2000)


def rel_l2(got, want) -> float:
    """|got - want| / |want| over every entry, in float64 (tensors on
    their device, or arrays)."""
    import numpy as np
    import torch

    if isinstance(got, torch.Tensor):
        got, want = got.double(), want.to(got.device).double()
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want).clamp(min=1e-300))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def precision_walk_case(name: str, make) -> dict:
    """precision_case for a backward or training kernel: make(n) gives
    (kernel, twin) on the first n steps of the case's inputs (all of them
    for None); kernel() reads the mode's rounding
    (nn/config.kernel_rounding) and twin(rounding) is its plain twin. The
    full length is held to PRECISION_ULPS ulps of the mode at each output's
    scale, the first PRECISION_SHORT_T steps to lie PRECISION_NEARER times
    nearer the mode's twin than the 'highest' twin, output by output."""
    as_tuple = lambda t: t if isinstance(t, tuple) else (t,)
    kernel, twin = make(None)
    scales = [float(t.abs().max()) for t in as_tuple(twin(None))]
    tol = {m: [PRECISION_ULPS * PRECISION_ULP[m] * s for s in scales]
           for m in PRECISION_MODES}
    row = precision_case(name, kernel, twin, tol)
    row["tol"] = tol
    kernel, twin = make(PRECISION_SHORT_T)
    highest = as_tuple(twin(None))
    for mode in PRECISION_MODES:
        got = as_tuple(in_mode(mode, kernel))
        near = [rel_l2(g, w) for g, w in zip(got, as_tuple(twin(PRECISION_ROUNDING[mode])))]
        moved = [rel_l2(g, h) for g, h in zip(got, highest)]
        for i, (e, m) in enumerate(zip(near, moved)):
            require(m > 0 and e * PRECISION_NEARER <= m,
                    f"{name} {mode} output {i}, {PRECISION_SHORT_T} steps: rel L2 "
                    f"{e} to the mode's twin, {m} to the 'highest' twin")
        row[f"short_rel_l2_{mode}"] = near
        row[f"short_moved_{mode}"] = moved
    return row


def cpu_value_and_grad_mode(mode: str, model: str, params: dict, sig, labels):
    """cpu_value_and_grad under precision `mode`, in a worker process."""
    from scrappie_torch.nn import config

    with config.precision(mode):
        return cpu_value_and_grad(model, params, sig, labels)


def global_norm(grads: dict) -> float:
    import numpy as np

    return float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in grads.values())))


def check_precision_train(net, enet, card: str, pool) -> dict:
    """Training under 'default' and 'bf16' on the card (phase
    precision_train): (1) each of the six kernel instances that take the
    backward's rounding in each mode against its twin with the mode's
    rounding (precision_walk_case), with its ms beside 'highest''s: the
    GRU walk (rgrgr_r94's first layer, T_BLOCKS steps, B = 64, S = 96) and
    its big-S walk, the LSTM pair's walk (the events network's first stage,
    T_EVENTS steps, B = 64) and its big-S walk, the pair's training forward
    (h and the planes) and its big-S mode (big-S: seeded weights, T_BIG_S
    steps, B = 8, S = BIG_S_BWD); (2) one framewise step of each of
    PRECISION_TRAIN_MODELS under 'bf16' on the card against the port's CPU
    'bf16' step on the same batch (in the pool): the loss within
    PRECISION_TRAIN_LOSS_RTOL, the gradient's global norm within
    PRECISION_TRAIN_NORM_RTOL, the whole gradient within
    PRECISION_TRAIN_GRAD_RTOL relative L2 and PRECISION_NEARER times
    nearer than the card's 'highest' gradient; (3) TRAIN["steps"] steps of
    rgrgr_r94 and nanonet_events in each mode after one untimed step, the
    loss falling, the seconds a step of each mode; (4) one lattice window
    step and one rgrgr_r94 whole-read step under 'bf16': the loss finite, the gradient finite and not
    'highest''s. Returns {kernel: {max_abs_err_<mode>, ms_<mode>}} for the
    kernels line."""
    import numpy as np
    import torch

    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.nn import config, rnn
    from scrappie_torch.nn.layers import conv1d, feedforward, window
    from scrappie_torch.ops import gru as g
    from scrappie_torch.ops import lstm as L
    from scrappie_torch.ops.pipeline import CONV_ACT, lstm_weights
    from scrappie_torch.ops.project import project_tm
    from scrappie_torch.train import trainer
    from scrappie_torch.train.simulate import SquiggleSimulator

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 400)
    cuda_r = lambda: config.kernel_rounding("cuda")
    out = {}
    with torch.no_grad():
        # (1) the GRU walk on rgrgr_r94's first layer
        p, B = net.params, 64
        sig = torch.as_tensor(rng.standard_normal((B, CHUNK, 1)).astype(np.float32),
                              device="cuda")
        x = CONV_ACT[net.conv_activation](
            conv1d(sig, p["conv_W"], p["conv_b"], net.stride)).transpose(0, 1)
        xg = feedforward(x, p["gruB1_iW"], p["gruB1_b"]).contiguous()
        sW, sW2 = p["gruB1_sW"], p["gruB1_sW2"]
        gh = torch.as_tensor(rng.standard_normal((T_BLOCKS, B, 96)).astype(np.float32),
                             device="cuda")
        h = g.gru_tm(xg, sW, sW2, False)
        hp, gates = g.backward_inputs(xg, h, sW, sW2, False)

        def gru_walk_case(name, gates, hp, gh, sW, sW2, reverse):
            def make(n):
                w = (gates[:n], hp[:n], gh[:n], sW, sW2, reverse)
                return (lambda: g.gru_walk(*w, cuda_r()),
                        lambda r: g.gru_walk_plain(*w, r))
            return precision_walk_case(name, make)

        out["gru_recurrence_bwd"] = gru_walk_case("gru_recurrence_bwd", gates, hp, gh,
                                                  sW, sW2, False)
        del sig, x, xg, gh, h, hp, gates
        # the big-S walk and training forward, seeded weights
        gen = torch.Generator(device="cuda").manual_seed(SEED + 401)
        Sb, Tb, Bb = BIG_S_BWD, T_BIG_S, 8
        rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=gen, device="cuda")
        bx, bgh = rnd(Tb, Bb, 3 * Sb), rnd(Tb, Bb, Sb)
        bsW, bsW2 = rnd(Sb, 2 * Sb, s=Sb ** -0.5), rnd(Sb, Sb, s=Sb ** -0.5)
        bhp, bgates = g.backward_inputs(bx, g.gru_tm(bx, bsW, bsW2, True), bsW, bsW2,
                                        True)
        out["gru_recurrence_bwd_global"] = gru_walk_case(
            "gru_recurrence_bwd_global", bgates, bhp, bgh, bsW, bsW2, True)
        # the LSTM pair: the events network's first stage
        e = enet.params
        wF, wB = (lstm_weights(e, d, 1) for d in "FB")
        S = wF[2].shape[0]
        feats = torch.as_tensor(rng.standard_normal((B, T_EVENTS, 4)).astype(np.float32),
                                device="cuda")
        xe = window(feats, enet.winlen, 1).transpose(0, 1).contiguous()
        xpair = project_tm(xe, torch.cat((wF[0], wB[0]), 1), torch.cat((wF[1], wB[1])))
        ghs = [torch.as_tensor(rng.standard_normal((T_EVENTS, B, S)).astype(np.float32),
                               device="cuda") for _ in "FB"]

        def pair_twin(xp, w_f, w_b, r):
            S4 = 4 * w_f[0].shape[0]
            hF, pF = rnn.lstm_tm(xp[..., :S4], *w_f, False, True, r)
            hB, pB = rnn.lstm_tm(xp[..., S4:], *w_b, True, True, r)
            return hF, hB, pF, pB

        def pair_case(name, xp, w_f, w_b, gh2):
            def make_train(n):
                return (lambda: L.lstm_pair_train_cuda(xp[:n], *w_f, *w_b, cuda_r()),
                        lambda r: pair_twin(xp[:n], w_f, w_b, r))

            def make_walk(n):
                _, _, pF, pB = L.lstm_pair_train_cuda(xp[:n], *w_f, *w_b)
                dirs = [(pF, gh2[0][:n], *w_f, False), (pB, gh2[1][:n], *w_b, True)]

                def twin(r):
                    walks = [L.lstm_walk_plain(*d, r) for d in dirs]
                    return (torch.cat([w[0] for w in walks], -1),
                            torch.stack([w[1] for w in walks]))
                return lambda: L.lstm_walk_pair(dirs, cuda_r()), twin

            walk = L.WALK_MODES[L.walk_mode(w_f[0].shape[0])][0]
            return precision_walk_case(name, make_train), precision_walk_case(walk, make_walk)

        out["lstm_pair_train"], out["lstm_recurrence_bwd"] = pair_case(
            "lstm_pair_train", xpair, wF[2:], wB[2:], ghs)
        del feats, xe, xpair, ghs
        lw = [(rnd(Sb, 4 * Sb, s=Sb ** -0.5), rnd(3 * Sb, s=0.1)) for _ in "FB"]
        out["lstm_pair_train_global"], out["lstm_recurrence_bwd_cluster"] = pair_case(
            "lstm_pair_train_global", rnd(Tb, Bb, 8 * Sb), lw[0], lw[1],
            [rnd(Tb, Bb, Sb) for _ in "FB"])
    emit({"phase": "precision_train", "part": "kernels",
          "shapes": {"gru": {"T": T_BLOCKS, "B": B, "S": 96},
                     "lstm": {"T": T_EVENTS, "B": B, "S": S},
                     "big_s": {"T": Tb, "B": Bb, "S": Sb}},
          "kernels": out, "card": card})
    # (2) a framewise step of each model under 'bf16', card against CPU
    sim = SquiggleSimulator(seed=SEED + 402, device="cuda")
    runs = []
    for i, model in enumerate(PRECISION_TRAIN_MODELS):
        spec = RAW_MODELS.get(model)
        nb, ns = PRECISION_TRAIN_BATCH["batch"], PRECISION_TRAIN_BATCH["nsample"]
        if spec is None:
            sigb, labels = sim.detected_events_batch(nb, ns // 10)
        else:
            make = sim.crf_labelled_batch if spec.kind == "rnnrf" else sim.labelled_batch
            sigb, labels = make(nb, ns, spec.stride)
        params = random_params(model, SEED + 410 + i)
        job = pool.submit(cpu_value_and_grad_mode, "bf16", model, params, sigb, labels)
        tp = {k: torch.as_tensor(v, device="cuda") for k, v in params.items()}
        loss, grads = in_mode("bf16", lambda: trainer.value_and_grad(model, tp, sigb, labels))
        hloss, hgrads = trainer.value_and_grad(model, tp, sigb, labels)
        runs.append((model, float(loss), {k: v.cpu().numpy() for k, v in grads.items()},
                     {k: v.cpu().numpy() for k, v in hgrads.items()}, job))
    steps = {}
    # (3) TRAIN["steps"] steps in each mode
    for i, model in enumerate(("rgrgr_r94", "nanonet_events")):
        params = random_params(model, SEED + 420 + i)
        steps[model] = {}
        run = lambda steps: trainer.train(model, params=params, seed=SEED + 425 + i,
                                          log_every=0, device="cuda",
                                          **{**TRAIN, "steps": steps})
        for mode in ("highest",) + PRECISION_MODES:
            in_mode(mode, lambda: run(1))  # the mode's first products, untimed
            sync()
            t1 = time.perf_counter()
            _, losses = in_mode(mode, lambda: run(TRAIN["steps"]))
            sync()
            sec = (time.perf_counter() - t1) / TRAIN["steps"]
            require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                    f"precision_train {model} {mode}: the loss falls ({losses})")
            steps[model][mode] = {"seconds_per_step": sec, "losses": losses}
    emit({"phase": "precision_train", "part": "steps", **TRAIN, "steps": steps,
          "card": card})
    # (4) a lattice window step and an rgrgr whole-read step under 'bf16'
    read = whole_read()
    lattice_x = lattice_batches("rgrgr_r94", LATTICE_RUNS[0][1])[0]
    params = random_params("rgrgr_r94", SEED + 430)
    wx, wseq = wholeread_inputs(read, "transducer", "rgrgr_r94", "region_seqstates",
                                params, WHOLE_CPU_BLOCKS * 5)
    losses = {}
    for kind, xs in (("lattice", lattice_x), ("transducer", (wx, wseq))):
        bl, bg = in_mode("bf16", lambda: value_and_grad_on(kind, "rgrgr_r94", params,
                                                           *xs, "cuda"))
        hl, hg = value_and_grad_on(kind, "rgrgr_r94", params, *xs, "cuda")
        require(np.isfinite(bl) and all(np.isfinite(v).all() for v in bg.values()),
                f"precision_train {kind} bf16: finite loss and gradient")
        moved = max(float(np.abs(bg[k] - hg[k]).max()) for k in bg)
        require(moved > 0, f"precision_train {kind}: bf16's gradient is not highest's")
        losses[kind] = {"loss_bf16": bl, "loss_highest": hl, "grad_moved": moved}
    emit({"phase": "precision_train", "part": "lattice", "runs": losses, "card": card})
    for model, loss, grads, hgrads, job in runs:
        cpu_loss, cpu_grads = job.result()
        loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
        norm_rel = abs(global_norm(grads) - global_norm(cpu_grads)) / global_norm(cpu_grads)
        flat = lambda gs: np.concatenate([np.ravel(gs[k]) for k in sorted(cpu_grads)])
        grad_rel, highest_rel = (rel_l2(flat(gs), flat(cpu_grads)) for gs in (grads, hgrads))
        require(loss_rel <= PRECISION_TRAIN_LOSS_RTOL,
                f"precision_train {model}: bf16 loss {loss} against the CPU's {cpu_loss}")
        require(norm_rel <= PRECISION_TRAIN_NORM_RTOL,
                f"precision_train {model}: bf16 gradient norm rel err {norm_rel}")
        require(grad_rel <= PRECISION_TRAIN_GRAD_RTOL and highest_rel > 0
                and grad_rel * PRECISION_NEARER <= highest_rel,
                f"precision_train {model}: bf16 gradient rel L2 {grad_rel} to the "
                f"CPU's, 'highest''s {highest_rel}")
        emit({"phase": "precision_train", "part": "cpu", "model": model,
              **PRECISION_TRAIN_BATCH, "loss_rel_err": loss_rel,
              "grad_norm_rel_err": norm_rel, "grad_rel_l2_to_cpu": grad_rel,
              "highest_grad_rel_l2_to_cpu": highest_rel, "card": card})
    emit({"phase": "precision_train", "seconds": round(time.perf_counter() - t0, 3)})
    return out


# ------------------------------------------------------------ realdata


def simulated_read(nsample: int, seed: int):
    """A med/MAD-normalised read of nsample samples from the port's
    squiggle simulator (on the card) and the truth bases it covers."""
    import numpy as np

    from scrappie_torch.train.simulate import SquiggleSimulator

    sim = SquiggleSimulator(seed=seed, device="cuda")
    sig, bases, base_at = sim.simulate_read(nsample // 7)
    require(len(sig) >= nsample, f"simulated {len(sig)} >= {nsample} samples")
    sig = sig[:nsample]
    med = np.median(sig)
    norm = ((sig - med) / (np.median(np.abs(sig - med)) * 1.4826)).astype(np.float32)
    return norm, "".join("ACGT"[b] for b in bases[: base_at[nsample - 1] + 1])


def cpu_label_read(norm, truth):
    """label_read on the CPU, in a worker process."""
    import torch

    from scrappie_torch.train.realdata import label_read

    torch.set_num_threads(2)
    return label_read(norm, truth, device="cpu", name="cpu")


def check_realdata(card: str, pool) -> None:
    """Real-read training data on the card (phase realdata): label_read of
    a simulated read of REAL_SAMPLES samples (rgrgr_r94's posterior, then
    the seqmap kernel and its walk in both orientations), its aligned
    fraction, score a block and seconds; label_read of a
    REAL_CPU_SAMPLES-sample read held to the port's CPU run (the same
    orientation, base_at equal, the score within REAL_SCORE_RTOL); then
    EmpiricalModel.fit on both labelled reads, one rgrgr_r94 framewise
    training step on a RealReadSampler batch and one on a
    RealisticSimulator batch, and one whole-read transducer step on the
    shorter read's labelled region: their losses finite."""
    import numpy as np
    import torch

    from scrappie_torch.models import registry
    from scrappie_torch.models.convert import params_from_numpy
    from scrappie_torch.train import trainer, wholeread
    from scrappie_torch.train.optim import FiniteClippedAdam
    from scrappie_torch.train.realdata import RealReadSampler, label_read
    from scrappie_torch.train.realsim import EmpiricalModel, RealisticSimulator

    t0 = time.perf_counter()
    short, short_truth = simulated_read(REAL_CPU_SAMPLES, SEED + 311)
    job = pool.submit(cpu_label_read, short, short_truth)
    norm, truth = simulated_read(REAL_SAMPLES, SEED + 310)
    sync()
    t1 = time.perf_counter()
    lr = label_read(norm, truth, device="cuda", name="simulated")
    seconds = time.perf_counter() - t1
    aligned = float((lr.base_at >= 0).mean())
    require(aligned > 0.5, f"label_read aligned fraction {aligned}")
    require(np.isfinite(lr.map_score), "label_read score finite")
    row = {"samples": len(norm), "blocks": len(norm) // 5, "truth_bases": len(truth),
           "aligned_fraction": aligned, "score_per_block": lr.map_score,
           "orientation_kept": "fwd" if len(lr.bases) == len(truth) and
           "".join("ACGT"[b] for b in lr.bases) == truth else "rc",
           "seconds": seconds}
    ls = label_read(short, short_truth, device="cuda", name="short")
    lc = job.result()
    require(np.array_equal(ls.bases, lc.bases), "label_read orientation: card = CPU")
    same = float((ls.base_at == lc.base_at).mean())
    rel = abs(ls.map_score - lc.map_score) / abs(lc.map_score)
    row["cpu_check"] = {"samples": len(short), "score_rel_err": rel,
                        "base_at_equal_fraction": same,
                        "blocks_differing": int((ls.base_at[::5] != lc.base_at[::5]).sum())}
    emit({"phase": "realdata", "cpu_check": row["cpu_check"]})
    require(rel <= REAL_SCORE_RTOL, f"label_read score rel err {rel} <= {REAL_SCORE_RTOL}")
    require(same == 1.0, f"label_read base_at: card = CPU on {same}")
    reads = [lr, ls]
    model = EmpiricalModel.fit(reads)
    require(np.isfinite(model.level).all() and 0 <= model.phi < 1, "EmpiricalModel fit")
    params = params_from_numpy(registry.load_params("rgrgr_r94"), "cuda")
    opt = FiniteClippedAdam({k: v.clone() for k, v in params.items()}, 1e-4)
    step = trainer.make_train_step("rgrgr_r94", opt)
    sampler = RealReadSampler(reads, seed=SEED)
    losses = {"framewise, RealReadSampler": float(step(*sampler.batch(8, 4000, 5)))}
    sim = RealisticSimulator(model, seed=SEED)
    losses["framewise, RealisticSimulator"] = float(step(*sim.labelled_batch(8, 4000, 5)))
    wstep = wholeread.make_wholeread_transducer_step(
        "rgrgr_r94", FiniteClippedAdam({k: v.clone() for k, v in params.items()}, 1e-4))
    rsig, rseq = wholeread.region_seqstates(ls, sampler._train_end[1], 5, WHOLE_CHUNK)
    losses["whole-read transducer, labelled region"] = float(
        wstep(rsig[None, :, None], rseq[None]))
    for what, loss in losses.items():
        require(np.isfinite(loss), f"realdata {what}: loss finite ({loss})")
    emit({"phase": "realdata", "label_read": row,
          "empirical_model": {"phi": model.phi, "sigma": model.sigma,
                              "dwell_pool": len(model.dwell_pool)},
          "losses": losses, "region": {"samples": len(rsig), "states": len(rseq)},
          "seconds": round(time.perf_counter() - t0, 3), "card": card})


# ------------------------------------------------------------ validate


def check_validate(card: str, reads: list) -> None:
    """SCRAPPIE_TORCH_VALIDATE on the card (phase validate): the rgrgr_r94
    fast engine over 8 reads, one poisoned with NaN, with validation off
    and on: on, the poisoned read is skipped (no sequence) and the others'
    calls equal the run's with validation off; then a forward on a
    poisoned chunk raises nothing until validate.raise_pending() reads
    the card's checks, and a clean one leaves nothing pending."""
    import numpy as np
    import torch

    from scrappie_torch.parallel.runner import BasecallEngine, RawSignal
    from scrappie_torch.utils import validate

    t0 = time.perf_counter()
    batch = list(reads[:8])
    raw = batch[3].raw.copy()
    raw[5000:5100] = np.nan
    batch[3] = RawSignal(raw, uuid="poisoned")
    engine = BasecallEngine("rgrgr_r94", device="cuda", mode="fast")
    try:
        validate.set_enabled(False)  # the seven good reads
        off = engine.basecall_signals(batch[:3] + batch[4:])
        validate.set_enabled(True)
        on = engine.basecall_signals(batch)
        require(on[3].sequence is None, "validate: the poisoned read is skipped")
        same = [a.sequence == b.sequence for a, b in zip(on[:3] + on[4:], off)]
        require(all(same) and all(r.sequence for r in off),
                f"validate: the other calls equal validation off's ({sum(same)}/7)")
        net = engine.net
        sig = torch.randn((2, CHUNK, 1), device="cuda")
        with torch.inference_mode():
            net(sig)
            validate.raise_pending()
            sig[1, 500:510] = float("nan")
            net(sig)
        sync()
        try:
            validate.raise_pending()
            raised = None
        except validate.ValidationError as err:
            raised = str(err)
        require(raised is not None and "non-finite" in raised,
                f"validate: the card's checks raise at raise_pending ({raised})")
    finally:
        validate.set_enabled(None)
        validate._pending.clear()
    emit({"phase": "validate", "reads": len(batch), "skipped": ["poisoned"],
          "others_equal": True, "deferred_error": raised[:200],
          "seconds": round(time.perf_counter() - t0, 3), "card": card})


# ------------------------------------------------------------ crf_assoc


def check_crf_assoc(rnet, card: str) -> None:
    """decode/crf's parallel-in-time decode and posterior (impl "assoc":
    associative scans of the 5 x 5 transition matrices, plain PyTorch) on
    the card at the rnnrf stitch shape CRF_STITCH, on rnnrf_r94's
    transitions of seeded signal, against the sequential kernels (the CRF
    forward and backtrace, the forward-backward): paths equal, scores
    within ASSOC_SCORE_RTOL, posteriors within ASSOC_POST_ATOL; each
    one's time (phase crf_assoc)."""
    import numpy as np
    import torch

    from scrappie_torch.decode import crf as dc
    from scrappie_torch.nn.layers import globalnorm_tm
    from scrappie_torch.ops import crf as c
    from scrappie_torch.ops.pipeline import rnnrf_features_tm

    T, B = CRF_STITCH
    rng = np.random.default_rng(SEED + 320)
    sig = torch.as_tensor(rng.standard_normal((B, 2 * T, 1)).astype(np.float32),
                          device="cuda")
    p = rnet.params
    trans = globalnorm_tm(rnnrf_features_tm(p, sig, rnet.conv_activation, rnet.stride),
                          p["FF_W"], p["FF_b"]).contiguous()
    sk, pk = c.crf_viterbi_tm(trans)
    sa, pa = dc.crf_viterbi_assoc_tm(trans)
    postk = c.crf_posterior_tm(trans)
    posta = dc.crf_posterior_assoc_tm(trans)
    sync()
    require(torch.equal(pk.long(), pa.long()), "crf assoc: paths equal to the kernels'")
    srel = float(((sk - sa).abs() / sk.abs()).max())
    require(srel <= ASSOC_SCORE_RTOL, f"crf assoc score rel err {srel}")
    perr = float((postk - posta).abs().max())
    require(bool(torch.isfinite(posta).all()) and perr <= ASSOC_POST_ATOL,
            f"crf assoc posterior max abs err {perr} <= {ASSOC_POST_ATOL}")
    emit({"phase": "crf_assoc", "T": T, "B": B, "paths_equal": True,
          "score_max_rel_err": srel, "posterior_max_abs_err": perr,
          "ms": {"viterbi kernels": cuda_ms(lambda: c.crf_viterbi_tm(trans), reps=5),
                 "viterbi assoc": cuda_ms(lambda: dc.crf_viterbi_assoc_tm(trans), reps=3),
                 "posterior kernels": cuda_ms(lambda: c.crf_posterior_tm(trans), reps=5),
                 "posterior assoc": cuda_ms(lambda: dc.crf_posterior_assoc_tm(trans),
                                            reps=3)},
          "card": card})


# ------------------------------------------------------------ embed


def check_embed(card: str, reads: list) -> None:
    """scrappie_torch.embed (what the C shim calls) on the card, its
    device None as the shim's null: basecall_raw and calc_post equal to
    api.basecall_raw's and api.calc_post's on the card, for rgrgr_r94 and
    rnnrf_r94 (phase embed; the shim itself is built and run by
    tests/test_torch_embed.py)."""
    import numpy as np

    from scrappie_torch import api, embed

    raw = np.ascontiguousarray(reads[0].raw[:20000], dtype=np.float32)
    rows = {}
    for model in ("rgrgr_r94", "rnnrf_r94"):
        seq, score = embed.basecall_raw(memoryview(raw), model, None)
        want = api.basecall_raw(raw, model=model, device="cuda")
        require(seq and (seq, score) == (want[0], float(want[1])),
                f"embed {model}: basecall_raw equals api's")
        data, nblock, nstate = embed.calc_post(memoryview(raw), model, None)
        rt = api.RawTable(raw)
        rt.trim().scale()
        post = api.calc_post(rt, model, device="cuda").data()
        require(np.array_equal(np.frombuffer(data, np.float32).reshape(nblock, nstate),
                               post), f"embed {model}: calc_post equals api's")
        rows[model] = {"bases": len(seq), "post": [nblock, nstate]}
    emit({"phase": "embed", "version": embed.version(), "models": rows, "card": card})


# ------------------------------------------------------------- multigpu

# The mesh paths: scrappie_tpu's dryrun_multichip's kinds and modes.
MESH_PATHS = (("rgrgr_r94", "stitch", ()), ("rgrgr_r94", "fast", ()),
              ("raw_r94", "fast", ()), ("rnnrf_r94", "fast", ()),
              ("nanonet_events", "stitch", ()),
              ("nanonet_events", "fast", ()),
              ("rgrgr_r94", "stitch", ENSEMBLE), ("rgrgr_r94", "fast", ENSEMBLE))
MESH_SHAPES = {"2x1": (2, 1), "2x2": (2, 2)}
# A slice is a smaller batch, and on a 'state' axis the posterior's output
# layer sums two partial products: equal sequences, scores this close.
MESH_SCORE_RTOL = 1e-5
MESH_TRAIN_RTOL = 1e-5
# The launcher's two steps: Adam's second update reads the gradients' size,
# so a wrong or missing gradient all_reduce moves weights by about lr.
LAUNCHER_WEIGHT_ATOL = 1e-2 * TRAIN["lr"]
MESH_CHANNELS = 4
LAUNCHER_TIMEOUT = 300   # seconds a launcher worker may take


def card_mesh(shape):
    """A mesh of the given shape over one card repeated."""
    from scrappie_torch.parallel.sharding import make_mesh

    n_data, n_state = shape
    return make_mesh(n_data, n_state, devices=["cuda:0"] * (n_data * n_state))


def mesh_kernels(model: str, mode: str) -> tuple:
    kind = {"rnnrf_r94": RNNRF_KERNELS, "nanonet_events": EVENTS_KERNELS}
    return kind.get(model, TRANSDUCER_KERNELS)[mode]


def timed_calls(engine, reads):
    engine.basecall_signals(reads[:1])  # warm-up
    sync()
    t0 = time.perf_counter()
    res = engine.basecall_signals(reads)
    return res, time.perf_counter() - t0


def check_mesh_engines(card: str, reads: list) -> None:
    """Every MESH_PATHS path on both meshes against the one-card engine."""
    from scrappie_torch import ops
    from scrappie_torch.parallel.runner import BasecallEngine

    meshes = {k: card_mesh(v) for k, v in MESH_SHAPES.items()}
    for model, mode, ens in MESH_PATHS:
        kw = dict(mode=mode, ensemble=ens, batch_size=8)
        want, one_s = timed_calls(BasecallEngine(model, device="cuda", **kw),
                                  reads)
        row = {"phase": "multigpu", "path": f"{model} {mode}"
               + (" 3:1:1" if ens else ""), "one_card_seconds": round(one_s, 4),
               "card": card}
        for name, mesh in meshes.items():
            eng = BasecallEngine(model, mesh=mesh, **kw)
            require(len(eng.replicas) == 2 and eng.batch_size == 8,
                    f"{name}: two data rows")
            eng.basecall_signals(reads[:1])
            ops.reset_launches()
            sync()
            t0 = time.perf_counter()
            got = eng.basecall_signals(reads)
            seconds = time.perf_counter() - t0
            launched = dict(ops.LAUNCHES)
            require_kernels(f"multigpu {model} {mode} {name}", launched,
                            mesh_kernels(model, mode))
            rel = 0.0
            for g, w in zip(got, want, strict=True):
                require(g.sequence and g.sequence == w.sequence,
                        f"multigpu {model} {mode} {name} {w.uuid}: sequence "
                        "equals the one-card call")
                rel = max(rel, abs(g.score - w.score) / abs(w.score))
            require(rel <= MESH_SCORE_RTOL,
                    f"multigpu {model} {mode} {name}: scores within "
                    f"{MESH_SCORE_RTOL} ({rel})")
            row[name] = {"seconds": round(seconds, 4),
                         "score_max_rel_err": rel,
                         "launches": {k: v for k, v in launched.items() if v}}
        row["bases"] = sum(len(r.sequence) for r in want)
        emit(row)


def check_mesh_batchers(card: str, reads: list) -> None:
    """Both streaming batchers on the 2 x 1 mesh against solo streams."""
    from scrappie_torch.parallel import streaming, streaming_events

    mesh = card_mesh(MESH_SHAPES["2x1"])
    sigs = [r.raw for r in reads[:MESH_CHANNELS]]
    for label, solo, bat in (
            ("raw rgrgr_r94",
             lambda: streaming.StreamingBasecaller("rgrgr_r94", CHUNK, 1000,
                                                   device="cuda"),
             streaming.StreamingBatcher("rgrgr_r94", CHUNK, 1000,
                                        batch_size=8, mesh=mesh)),
            ("events",
             lambda: streaming_events.EventsStreamingBasecaller(
                 CHUNK, 2000, device="cuda"),
             streaming_events.EventsStreamingBatcher(CHUNK, 2000, batch_size=8,
                                                     mesh=mesh))):
        want = []
        for sig in sigs:
            sb = solo()
            sb.feed(sig)
            sb.flush()
            want.append(sb.sequence)
        t0 = time.perf_counter()
        got = {}
        for i in range(len(sigs)):
            bat.add_stream(i)
            got[i] = ""
        for lo in range(0, max(map(len, sigs)), 4 * CHUNK):
            for i, sig in enumerate(sigs):
                if lo < len(sig):
                    got[i] += bat.feed(i, sig[lo:lo + 4 * CHUNK])
        got = [got[i] + bat.flush(i) for i in range(len(sigs))]
        seconds = time.perf_counter() - t0
        require(all(want) and got == want,
                f"multigpu {label} batcher on a mesh equals solo streams")
        emit({"phase": "multigpu", "batcher": label, "channels": len(sigs),
              "mesh": "2x1", "seconds": round(seconds, 4),
              "bases": sum(map(len, got)), "card": card})


def check_mesh_train(card: str) -> None:
    """One step of each model on both meshes against the one-card step."""
    import numpy as np
    import torch

    from scrappie_torch.models.specs import RAW_MODELS
    from scrappie_torch.train.simulate import SquiggleSimulator
    from scrappie_torch.train.trainer import (value_and_grad,
                                              value_and_grad_on_mesh)

    def norm(grads):
        return float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))

    sim = SquiggleSimulator(seed=SEED, device="cuda")
    B, n = TRAIN["batch"], TRAIN["nsample"]
    for model in TRAIN_MODELS:
        spec = RAW_MODELS.get(model)
        if spec is None:
            sig, labels = sim.detected_events_batch(B, n // 10)
        elif spec.kind == "rnnrf":
            sig, labels = sim.crf_labelled_batch(B, n, spec.stride)
        else:
            sig, labels = sim.labelled_batch(B, n, spec.stride)
        params = {k: torch.as_tensor(v, device="cuda")
                  for k, v in random_params(model, SEED).items()}
        value_and_grad(model, params, sig, labels)  # warm-up
        sync()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(model, params, sig, labels)
        want = (float(loss), norm(grads))
        one_s = time.perf_counter() - t0
        row = {"phase": "multigpu", "train": model, "loss": want[0],
               "one_card_seconds": round(one_s, 4), "card": card}
        for name, shape in MESH_SHAPES.items():
            sync()
            t0 = time.perf_counter()
            mloss, mgrads = value_and_grad_on_mesh(model, params,
                                                   card_mesh(shape), sig,
                                                   labels)
            got = (float(mloss), norm(mgrads))
            seconds = time.perf_counter() - t0
            rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
            require(max(rel) <= MESH_TRAIN_RTOL and np.isfinite(got).all(),
                    f"multigpu train {model} {name}: loss and gradient norm "
                    f"within {MESH_TRAIN_RTOL} ({rel})")
            row[name] = {"seconds": round(seconds, 4), "loss_rel_err": rel[0],
                         "grad_norm_rel_err": rel[1]}
        emit(row)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_workers(argvs: list) -> float:
    """Start every argv at once; each must exit 0 within LAUNCHER_TIMEOUT;
    every process is stopped either way. Returns the wall seconds."""
    env = {**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in argvs]
    try:
        for argv, p in zip(argvs, procs):
            _, err = p.communicate(timeout=LAUNCHER_TIMEOUT)
            require(p.returncode == 0, f"launcher worker {argv[3:]} exit "
                                       f"{p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def fasta_seqs(path) -> dict:
    seqs, name = {}, None
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith(">"):
            name = line[1:].split()[0]
            seqs[name] = ""
        elif name:
            seqs[name] += line.strip()
    return seqs


def check_launcher(card: str) -> None:
    """The launcher in worker processes on the card (see the module doc)."""
    import numpy as np

    from scrappie_torch.parallel.launcher import backend_for
    from scrappie_torch.parallel.sharding import make_mesh
    from scrappie_torch.train.trainer import train

    me = [sys.executable, str(pathlib.Path(__file__).resolve()),
          "--launcher-worker"]
    mod = [sys.executable, "-m", "scrappie_torch.parallel.launcher"]
    call = ["--devices", "cuda:0", "--batch-per-device", "8"]
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        one_s = launch_workers([me + call + ["-o", str(out / "one.fa")]])
        url = f"localhost:{free_port()}"
        two_s = launch_workers([me + call + [
            "--coordinator", url, "--num-processes", "2", "--process-id",
            str(i), "-o", str(out / f"two.{i}.fa")] for i in range(2)])
        one = fasta_seqs(out / "one.fa")
        merged = {}
        for i in range(2):
            part = fasta_seqs(out / f"two.{i}.fa")
            require(part and not set(part) & set(merged),
                    f"launcher process {i} calls its own shard")
            merged.update(part)
        require(len(one) == NREADS and merged == one,
                "two launcher processes' merged calls equal one process's")
        emit({"phase": "multigpu", "launcher": "basecall", "reads": len(one),
              "one_process_seconds": round(one_s, 4),
              "two_process_seconds": round(two_s, 4),
              "backend": backend_for(make_mesh(devices=["cuda:0"])),
              "card": card})

        # two steps on the global batch: two gloo processes, each one data
        # row on the card, and NCCL at world size 1, against this process
        # on a 2 x 1 mesh of the card
        step = ["--train", "2", "--model", "rgrgr_r94", "--batch",
                str(TRAIN["batch"]), "--nsample", str(TRAIN["nsample"]),
                "--lr", str(TRAIN["lr"]), "--seed", str(SEED)]
        t0 = time.perf_counter()
        params, losses = train("rgrgr_r94", steps=2, batch=TRAIN["batch"],
                               nsample=TRAIN["nsample"], lr=TRAIN["lr"],
                               seed=SEED, log_every=0,
                               mesh=make_mesh(devices=["cuda:0"] * 2))
        in_s = time.perf_counter() - t0
        gloo = f"localhost:{free_port()}"
        nccl = f"localhost:{free_port()}"
        t_s = launch_workers(
            [mod + step + ["--devices", "cuda:0", "--backend", "gloo",
                           "--coordinator", gloo, "--num-processes", "2",
                           "--process-id", str(i), "-o",
                           str(out / "gloo.npz")] for i in range(2)]
            + [mod + step + ["--devices", "cuda:0,cuda:0", "--backend", "nccl",
                             "--coordinator", nccl, "--num-processes", "1",
                             "--process-id", "0", "-o",
                             str(out / "nccl.npz")]])
        row = {"phase": "multigpu", "launcher": "train", "model": "rgrgr_r94",
               "losses": losses, "in_process_seconds": round(in_s, 4),
               "workers_seconds": round(t_s, 4), "card": card}
        for backend in ("gloo", "nccl"):
            got = np.load(out / f"{backend}.npz")
            require(len(got["losses"]) == 2,
                    f"launcher {backend}: two losses, not {got['losses']}")
            rel = max(abs(float(g) - w) / abs(w)
                      for g, w in zip(got["losses"], losses))
            off = max(float(np.abs(got[k] - v).max()) for k, v in params.items())
            require(rel <= MESH_TRAIN_RTOL and off <= LAUNCHER_WEIGHT_ATOL,
                    f"launcher {backend} steps equal the in-process steps "
                    f"(losses {rel}, weights {off})")
            row[backend] = {"loss_rel_err": rel, "weights_max_abs_diff": off}
        emit(row)


def launcher_worker(argv: list) -> int:
    """A launcher process basecalling the 16 synthetic reads in memory."""
    from scrappie_torch.parallel import launcher

    reads = synthetic_reads()
    return launcher.run(argv, reads=([r.uuid for r in reads], reads))


def check_multigpu(card: str, reads: list) -> None:
    import torch

    t0 = time.perf_counter()
    with torch.inference_mode():
        check_mesh_engines(card, reads)
        check_mesh_batchers(card, reads)
    check_mesh_train(card)
    check_launcher(card)
    emit({"phase": "multigpu", "seconds": round(time.perf_counter() - t0, 3),
          "card": card})


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description="Drive scrappie_torch on one "
                                             "CUDA GPU (see the module's doc).")
    ap.add_argument("--ab", type=pathlib.Path, metavar="OTHER_CHECKOUT",
                    help="only time the Viterbi forward and backtrace, the "
                         "DTW, map_signal_to_squiggle, the CRF forward, "
                         "partition function, backtrace, posterior and "
                         "partition gradient, the lattice losses at "
                         "their windows and a whole read, the GRU "
                         "recurrence, its "
                         "backward walk and whole backward, the rnnrf fused "
                         "path, the seqmap "
                         "DP, its walk and both, the banded DP, the LSTM's "
                         "big-S walk and a big-S training step, the DTW "
                         "walk at 60 000 and "
                         "3 000 samples, map_post_to_sequence, the head at K = 1 "
                         "and 3, B = 8 and 64 and the fast engine "
                         "(rgrgr_r94, 3:1:1) of OTHER_CHECKOUT and "
                         "of this checkout, in turns")
    ap.add_argument("--times", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--launcher-worker", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    if opts.launcher_worker is not None:
        return launcher_worker(opts.launcher_worker)
    if opts.times:
        time_checkout(opts.times.resolve())
        return 0
    if opts.ab:
        compare_checkouts(opts.ab.resolve())
        return 0
    from scrappie_torch.models.forward import EventsModel, RgrgrModel, RnnrfModel

    card = card_line()
    build()
    reads = synthetic_reads()
    with torch.inference_mode():
        host_native(card, reads)
        profile_trace(card, reads)
    net = RgrgrModel.from_registry("rgrgr_r94", "cuda")
    rnet = RnnrfModel.from_registry("rnnrf_r94", "cuda")
    enet = EventsModel.from_registry("nanonet_events", "cuda")
    with torch.inference_mode():
        check_decode_kernels(net, 8)
        table = check_kernels(net, 64)
        check_viterbi_options(net)
        nets = ensemble_nets()
        table["viterbi_fused_ens"], head3 = check_ens_kernel(nets, 64)
        table["head"]["K3"] = head3
        compare_routes(nets, card)
        heads = check_head_kernel(nets, card)
        check_head_widths(card)
        table["head"]["product_library_ms"] = heads["K = 1, B = 64"]["product_library_ms"]
        check_gru_recurrence(net, 8)
        table["gru_recurrence"] = check_gru_recurrence(net, 64)
        table.update(check_big_s())
        check_nhist()
        check_backtraces()
        forward_scaling(card)
        table.update(check_crf_kernels(rnet))
        check_crf_assoc(rnet, card)
        table["lstm_layer"], table["lstm_pair"] = check_lstm_kernel(enet, 64)
        precision = check_precision_kernels(net, enet, card)
    # autograd is its reference: no inference mode
    table["gru_recurrence_bwd"] = check_gru_backward(net, 64)
    table["lstm_recurrence_bwd"], table["lstm_pair_train"] = check_lstm_backward(enet, 64)
    table.update(check_big_s_backward())
    with torch.inference_mode():
        table.update(check_lattice_kernels(net, rnet))
    launches = main_path(card, reads)
    throughput(net, card)
    profile_and_scale(net, card, reads)
    main_path_raw(card, reads)
    throughput_raw(card)
    rnnrf_launches, rnnrf_results = main_path_rnnrf(card, reads)
    throughput_rnnrf(rnet, card, reads)
    ensemble_launches = main_path_ensemble(card, reads, rnnrf_results)
    throughput_ensemble(card, reads)
    events_launches = main_path_events(card, reads)
    throughput_events(enet, card, reads)
    with torch.inference_mode():
        check_squiggle(card)
        table["dtw"], table["dtw_walk"] = check_dtw_kernel(card)
        table["seqmap"], table["seqmap_walk"] = check_seqmap_kernel(card)
        table["seqmap_banded"] = check_banded_kernel(card)
    mapping_launches = main_path_mapping(card)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(TWIN_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        train_launches = main_path_train(card, pool)
        with torch.inference_mode():
            quality_launches = check_qualities(card, reads, pool)
        check_batch_invariance(card)
        main_path_serve(card, reads, pool)
        precision_paths(card, reads, pool)
        precision.update(check_precision_train(net, enet, card, pool))
        check_realdata(card, pool)
    check_validate(card, reads)
    check_embed(card, reads)
    check_multigpu(card, reads)
    # each kernel's launches on its own path: the GRU recurrence's, the
    # head's and the Viterbi kernels' on the rgrgr path, the CRF kernels' on
    # rnnrf's, the LSTM's on the events path's, the fused ensemble kernel's
    # on the 3:1:1 ensemble's; the projection's on all four, which it
    # serves; the backward kernels' on the training path, the
    # forward-backward's posterior on rnnrf's qualities. No path runs the
    # superseded kernels, a big-S mode (no model has S above 96) or a
    # single LSTM layer (the events path runs pairs).
    launches["project"] = sum(
        ls["project"] for ls in (launches, rnnrf_launches, ensemble_launches,
                                 events_launches))
    launches.update({k: rnnrf_launches[k]
                     for k in ("crf_fwd", "crf_backtrace", "crf_partition")})
    launches["viterbi_fused_ens"] = ensemble_launches["viterbi_fused_ens"]
    launches.update({k: events_launches[k]
                     for k in ("lstm_layer", "lstm_pair", "lstm_layer_global")})
    launches.update({k: mapping_launches[k] for k in MAPPING_KERNELS})
    launches.update({k: train_launches[k] for k in BACKWARD_KERNELS})
    launches["crf_posterior"] = quality_launches["crf_posterior"]
    for name in SUPERSEDED:
        require(launches[name] == 0, f"superseded {name} launched on a path "
                                     f"({launches[name]})")
    # One PyTorch call computes the projection (torch.addmm) and none any
    # other of these functions: torch.nn.GRU applies r after its matmul
    # (scrappie before), torch.nn.LSTM has no peepholes, and nothing in
    # PyTorch does the head's robustlog and renormalised combination, a
    # Viterbi decode (alone, after a head or after K combined heads), the
    # CRF's partition function, its gradient or posterior, a mapping DP or
    # a walk, the backward of scrappie's GRU (torch.nn.GRU's
    # differentiates its own gate order) or of its peephole LSTM, or a
    # lattice's forward-backward (torch's ctc_loss has no stay and skip
    # moves, kmer states, local START and END, or CRF transitions).
    emit({"phase": "total", "seconds": time.perf_counter() - START, "card": card})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": table[name]["max_abs_err"], "ms": table[name]["ms"],
         "plain_ms": table[name]["plain_ms"],
         "bound_ms": table[name]["bound_ms"],
         "bound_by": table[name]["bound_by"],
         "library_ms": table[name].get("library_ms"),
         # the head's product alone in torch.addmm (TF32 off), not the head
         **({"product_library_ms": table[name]["product_library_ms"]}
            if "product_library_ms" in table[name] else {}),
         # the kernels with products, in the precision policy's other modes
         **{f"{k}_{mode}": precision[name][f"{k}_{mode}"]
            for k in ("max_abs_err", "ms") for mode in PRECISION_MODES
            if name in precision}}
        for name in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
