"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Counterpart of scrappie_tpu/native/build.py. At first use every
`csrc/*.cu` is compiled for sm_90a by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain
C interface, under `build/scrappie_torch/` at the root of the checkout.
The file name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one loads the library already there. nvcc's
output (with `-Xptxas -v`: registers, shared memory and spills per kernel)
is kept beside the library as a `.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "scrappie_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types; each returns a cudaError_t.
_SIGNATURES = {
    "scrappie_gru_layer": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "scrappie_viterbi_fwd": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P),
    "scrappie_viterbi_fused": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                               _F, _F, _F, _F, _I, _P),
    "scrappie_viterbi_backtrace": (_P, _P, _P, _P, _I, _I, _I, _P),
    "scrappie_crf_fwd": (_P, _P, _P, _I, _I, _P),
    "scrappie_crf_partition": (_P, _P, _I, _I, _P),
    "scrappie_crf_backtrace": (_P, _P, _P, _P, _I, _I, _P),
    "scrappie_lstm_project": (_P, _P, _P, _P, _I, _I, _I, _P),
    "scrappie_lstm_recurrence": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "scrappie_dtw": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                     _F, _F, _I, _I, _P),
    "scrappie_seqmap": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P),
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "first use and need the CUDA toolkit")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libscrappie_torch_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless this exact build exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for src, _obj, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(f"== {src.name}\n{stdout}{stderr}")
        if proc.returncode:
            failed.append(f"{src.name} (code {proc.returncode}):\n{stderr}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        if not failed:
            proc = subprocess.run(
                [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *(str(obj) for _src, obj, _proc in jobs)],
                capture_output=True, text=True)
            log.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode:
                failed.append(f"link (code {proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text("".join(log))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, out)
    finally:
        for _src, obj, _proc in jobs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.scrappie_gru_smem_bytes.argtypes = (_I, _I)
    lib.scrappie_gru_smem_bytes.restype = ctypes.c_size_t
    lib.scrappie_lstm_smem_bytes.argtypes = (_I,)
    lib.scrappie_lstm_smem_bytes.restype = ctypes.c_size_t
    lib.scrappie_error_string.argtypes = (_I,)
    lib.scrappie_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        text = library().scrappie_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
