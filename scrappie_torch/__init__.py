"""scrappie_torch -- the rgrgr and rnnrf raw basecallers on PyTorch and CUDA.

A port of scrappie_tpu (JAX with Pallas kernels for the TPU), which stays
beside it as the reference. The host-side numpy code (trimming,
normalisation, chunking, the overlapper, homopolymer correction, IO and
the weight registry) is imported from scrappie_tpu, whose host modules
import no JAX. The compute path is PyTorch, with the hot loops (the GRU
layer, the transducer Viterbi forward, the fused head + Viterbi, its
backtrace, and the CRF Viterbi forward, backtrace and partition function)
as hand-written CUDA kernels for sm_90a under `csrc/`, each beside a plain
PyTorch twin that the CPU runs.

Entry points: scrappie_torch.api (basecall_raw, calc_post, decode_post),
scrappie_torch.parallel.runner.BasecallEngine, and
`python -m scrappie_torch raw`.
"""

from scrappie_torch import device as _device  # noqa: F401  (sets exact fp32)

__version__ = "0.1.0"
