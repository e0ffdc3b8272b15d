"""scrappie_torch -- the rgrgr, rnnrf and events basecallers, squiggle
prediction, signal-to-squiggle alignment and posterior-to-sequence mapping
on PyTorch and CUDA.

A port of scrappie_tpu (JAX with Pallas kernels for the TPU), which stays
beside it as the reference. The port imports nothing of scrappie_tpu: it
keeps its own copy of the host-side numpy code it needs (trimming,
normalisation, event detection and features, chunking, the overlapper,
homopolymer corrections, calibration presets, FASTA/SAM and fast5 IO) and
reads the weights from the npz files beside scrappie_tpu
(models/registry.py). The compute path is PyTorch, with the hot loops (the
GRU layer, the peephole-LSTM layer, the transducer Viterbi forward, the
fused head + Viterbi, its backtrace, the CRF Viterbi forward, backtrace
and partition function, the signal-to-squiggle DTW and the
posterior-to-sequence map) as hand-written CUDA kernels for sm_90a under
`csrc/`, each beside a plain PyTorch twin that the CPU runs.

Entry points: scrappie_torch.api (basecall_raw, calc_post, decode_post,
basecall_events, sequence_to_squiggle, map_signal_to_squiggle,
map_post_to_sequence), scrappie_torch.parallel.runner.BasecallEngine, and
`python -m scrappie_torch raw|events|squiggle|mappy|seqmappy|event_table`.
"""

from scrappie_torch import device as _device  # noqa: F401  (sets the precision policy)

__version__ = "0.1.0"
