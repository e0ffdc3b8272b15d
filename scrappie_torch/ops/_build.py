"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Counterpart of scrappie_tpu/native/build.py. Every `csrc/*.cu` is
compiled in one nvcc call for sm_90a into a shared library with a plain C
interface, under `build/scrappie_torch/` at the root of the checkout, at
first use. The file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one loads the library already
there. nvcc's output (with `-Xptxas -v`: registers, shared memory and
spills per kernel) is kept beside the library as a `.log`.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
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
    lib.scrappie_error_string.argtypes = (_I,)
    lib.scrappie_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        text = library().scrappie_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
