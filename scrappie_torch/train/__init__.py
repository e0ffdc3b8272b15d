"""Training of the raw basecall networks on simulated reads.

Counterpart of scrappie_tpu/train: `simulate.SquiggleSimulator` (signal
from random DNA through the squiggle_r94 network), `optim` (the optax
optimiser the JAX trainer builds, written out) and `trainer` (framewise
cross-entropy for rgrgr and raw_r94, the CRF negative log-likelihood for
rnnrf_r94). The forward runs the port's kernels under autograd Functions,
the backward the GRU recurrence's and the CRF's backward kernels
(ops/gru.py, ops/crf.py).
"""
