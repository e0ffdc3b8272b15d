"""Build the port's host library (src/host_kernels.cpp) with g++.

Counterpart of scrappie_tpu/native/build.py. The library is built at first
use into `build/scrappie_torch/` at the root of the checkout, never into
the source tree. Its file name carries a hash of the source and the flags,
so an edited source builds anew and an unchanged one loads the library
already there. g++ writes a file of its own and `os.replace` moves it into
place, so processes that build at once never load a half-written library.
It needs g++ only (no CUDA toolkit): on the CPU and beside the card alike.

    python -m scrappie_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

SRC = pathlib.Path(__file__).resolve().parent / "src" / "host_kernels.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "scrappie_torch"
# -ffp-contract=off: no fused multiply-add, so the t-statistics round every
# product and sum as the numpy twin does (bit for bit). Never -ffast-math.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the port's host library "
                           f"({SRC.name}) is compiled at first use and "
                           "needs g++")
    return found


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libscrappie_torch_host_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless this exact build exists; return its path.
    A failed compile raises with g++'s stderr."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx(), *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SRC.name} (code "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(build())
