"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all in parallel) and linked into one shared library with a plain C
interface, ``build/torch_kernels/libgs_kernels.so`` under the repository
root, loaded with ``ctypes``.
No PyTorch header is included, so the build takes seconds. It happens at
the first call of :func:`library` (never at import: machines without a card
import every module), and again whenever a source or a header
(``csrc/*.cuh``) is newer than the library. ``-Xptxas -v`` writes each kernel's registers and shared memory
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name → argtypes; every pointer and the stream are c_void_p, or ctypes
# would pass them as 32-bit ints and cut them.
_STREAM_FWD = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
               _I, _I, _I, _I, _P]
_STREAM_BWD = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P,
               _I, _I, _I, _I, _P]
_SIGNATURES = {
    "gs_stream_fwd": _STREAM_FWD,            # B1
    "gs_stream_fwd_fast": _STREAM_FWD,       # B3f
    "gs_stream_bwd": _STREAM_BWD,            # B2
    "gs_stream_bwd_fast": _STREAM_BWD,       # B3b
    "gs_padded_fwd": [_P] * 7 + [_I] * 5 + [_P],          # B4
    "gs_padded_bwd": [_P] * 10 + [_I] * 5 + [_P],         # B5
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
    """Compile ``csrc/*.cu`` into :data:`LIBRARY` if it is missing or stale:
    one ``nvcc -c`` per source, all started together, then one link."""
    srcs = sorted(CSRC.glob("*.cu"))
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    if (not force and LIBRARY.exists() and LIBRARY.stat().st_mtime
            >= max(s.stat().st_mtime for s in deps)):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
    failed = [(cmd[-1], proc.returncode, out)
              for cmd, proc, out in zip(cmds, procs, outs) if proc.returncode]
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{tag}")
    if not failed:
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode:
            failed.append(("link", proc.returncode, proc.stdout + proc.stderr))
    for obj in objs:
        obj.unlink(missing_ok=True)
    BUILD_LOG.write_text(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{what} ({rc}):\n{out}" for what, rc, out in failed))
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
