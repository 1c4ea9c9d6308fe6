"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/torch_kernels/
libgs_kernels.so`` under the repository root, and loaded with ``ctypes``.
No PyTorch header is included, so the build takes seconds. It happens at
the first call of :func:`library` (never at import: machines without a card
import every module), and again whenever a source is newer than the
library. ``-Xptxas -v`` writes each kernel's registers and shared memory
into ``build.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libgs_kernels.so"
BUILD_LOG = BUILD_DIR / "build.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name → argtypes; every pointer and the stream are c_void_p, or ctypes
# would pass them as 32-bit ints and cut them.
_SIGNATURES = {
    "gs_stream_fwd": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into :data:`LIBRARY` if it is missing or stale."""
    srcs = sorted(CSRC.glob("*.cu"))
    if (not force and LIBRARY.exists() and LIBRARY.stat().st_mtime
            >= max(s.stat().st_mtime for s in srcs)):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)   # atomic: concurrent builders never see half
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ptxas_report(kernel: str) -> list[str]:
    """The ``-Xptxas -v`` lines of the last build about ``kernel`` (a
    substring of its mangled name): stack, spills, registers, barriers."""
    lines = BUILD_LOG.read_text().splitlines() if BUILD_LOG.exists() else []
    out, inside = [], False
    for line in lines:
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out
