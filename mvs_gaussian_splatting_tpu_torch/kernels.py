"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all in parallel) and linked into one shared library with a plain C
interface, ``libgs_kernels.so`` in :data:`BUILD_DIR`, loaded with
``ctypes``: ``build/torch_kernels`` of the checkout when the package sits
in a source tree, else a per-user cache directory (:func:`build_dir`).
No PyTorch header is included, so the build takes seconds. It happens at
the first call of :func:`library` (never at import: machines without a card
import every module), and again whenever a source or a header
(``csrc/*.cuh``) is newer than the library. ``-Xptxas -v`` writes each
kernel's registers and shared memory into the log beside the library
(:data:`BUILD_LOG`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"


def build_dir(package: Path = PACKAGE) -> Path:
    """Where the kernels are built: ``build/torch_kernels`` of the checkout
    when ``package`` sits in a source tree (its parent holds
    ``pyproject.toml``); otherwise, as for an installed package whose parent
    is ``site-packages``, ``torch_kernels`` in a per-user cache directory
    (``$XDG_CACHE_HOME`` or ``~/.cache``)."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_kernels"
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return Path(cache) / package.name / "torch_kernels"


BUILD_DIR = build_dir()
LIBRARY = BUILD_DIR / "libgs_kernels.so"
BUILD_LOG = LIBRARY.with_suffix(".log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name → argtypes; every pointer and the stream are c_void_p, or ctypes
# would pass them as 32-bit ints and cut them.
# B1, B3f, B3b and B2 take the tile order (heaviest first) after tile_ids,
# B5 after counts
_STREAM_FWD = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P,
               _I, _I, _I, _I, _P]
_STREAM_BWD = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P, _P,
               _I, _I, _I, _I, _P]
_OCCUPANCY = [_I, _I, _I, _P, _P]
_SIGNATURES = {
    "gs_stream_fwd": _STREAM_FWD,            # B1
    "gs_stream_fwd_fast": _STREAM_FWD,       # B3f
    "gs_stream_bwd": _STREAM_BWD,            # B2
    "gs_stream_bwd_fast": _STREAM_BWD,       # B3b
    "gs_padded_fwd": [_P] * 7 + [_I] * 5 + [_P],          # B4
    "gs_padded_bwd": [_P] * 11 + [_I] * 5 + [_P],         # B5
    # (mode, tile_w, tile_h, *ctas_per_sm, *registers): the launch's
    # resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    # and registers per thread; mode 1 is B3f for gs_stream_fwd_occupancy,
    # unused by the others
    "gs_stream_fwd_occupancy": _OCCUPANCY,
    "gs_stream_bwd_fast_occupancy": _OCCUPANCY,
    "gs_stream_bwd_occupancy": _OCCUPANCY,
    "gs_padded_bwd_occupancy": _OCCUPANCY,
    # (buffer, tiles): the section-clock library's counters (sections.cuh)
    "gs_stream_fwd_sections": [_P, _P],
    "gs_stream_bwd_fast_sections": [_P, _P],
    "gs_stream_bwd_sections": [_P, _P],
    "gs_padded_fwd_sections": [_P, _P],
    "gs_padded_bwd_sections": [_P, _P],
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


def build(force: bool = False, *, csrc: Path = CSRC,
          library: Path = LIBRARY, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/*.cu`` into ``library`` if it is missing or stale:
    one ``nvcc -c`` per source, all started together, then one link; its
    ``-Xptxas -v`` report goes to ``library`` with the suffix ``.log``.
    ``defines`` (``-D`` flags) build a variant such as the section-clock
    library of ``profile_kernels.py``, under another name."""
    srcs = sorted(Path(csrc).glob("*.cu"))
    deps = srcs + sorted(Path(csrc).glob("*.cuh"))
    if (not force and library.exists() and library.stat().st_mtime
            >= max(s.stat().st_mtime for s in deps)):
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [library.parent / f"{library.stem}.{src.stem}.{tag}.o"
            for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c", "-o",
             str(obj), str(src)] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
    failed = [(cmd[-1], proc.returncode, out)
              for cmd, proc, out in zip(cmds, procs, outs) if proc.returncode]
    tmp = library.with_name(f"{library.name}.{tag}")
    if not failed:
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode:
            failed.append(("link", proc.returncode, proc.stdout + proc.stderr))
    for obj in objs:
        obj.unlink(missing_ok=True)
    library.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{what} ({rc}):\n{out}" for what, rc, out in failed))
    os.replace(tmp, library)   # atomic: concurrent builders never see half
    return library


def load(path: Path) -> ctypes.CDLL:
    """``path`` loaded with ``ctypes``, every entry point of
    :data:`_SIGNATURES` it has typed."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def ptxas_report(kernel: str, log: Path = BUILD_LOG) -> list[str]:
    """The ``-Xptxas -v`` lines of the last build about ``kernel`` (a
    substring of its mangled name): stack, spills, registers, barriers."""
    lines = log.read_text().splitlines() if log.exists() else []
    out, inside = [], False
    for line in lines:
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out
