"""ctypes bindings for the native scene-I/O runtime (``gsio.cpp``).

The port's own copy of the JAX package's ``native/``: the same C++ COLMAP
binary parsers behind the same C ABI. ``gsio.cpp`` is compiled with ``g++
-O3 -shared`` at first use into ``native/libgsio.so`` under the kernels'
build directory (:func:`library_path`: ``build/torch_kernels`` of a
checkout, or the per-user cache for an installed package), never beside
the source; again whenever the source is newer. ``data/colmap.py`` falls
back to its Python parsers when no compiler is available. :data:`parses`
counts the parses the native library answered.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .. import kernels

SOURCE = Path(__file__).resolve().parent / "gsio.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
parses = 0      # native parses that returned a result


def library_path(package: Path = kernels.PACKAGE) -> Path:
    """Where ``libgsio.so`` is built for ``package``."""
    return kernels.build_dir(package) / "native" / "libgsio.so"


def build(src: Path = SOURCE, so: Optional[Path] = None) -> bool:
    """Compiles ``src`` into ``so`` (default :func:`library_path`); False
    when there is no compiler or it fails. The library is written under a
    temporary name and renamed, so concurrent builds never load a partial
    file."""
    so = Path(so) if so is not None else library_path()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o",
           str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    os.replace(tmp, so)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if missing or older than its
    source; None if it cannot be built or loaded (tried once)."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED:
        return None
    _TRIED = True
    so = library_path()
    if not so.exists() or so.stat().st_mtime < SOURCE.stat().st_mtime:
        if not build(SOURCE, so):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.gsio_read_points3d.restype = ctypes.c_longlong
    lib.gsio_read_points3d.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p]
    lib.gsio_read_images.restype = ctypes.c_longlong
    lib.gsio_read_images.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 6
    lib.gsio_read_cameras.restype = ctypes.c_longlong
    lib.gsio_read_cameras.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 5
    _LIB = lib
    return lib


def _count(result):
    global parses
    if result is not None:
        parses += 1
    return result


def read_points3d(path: str):
    """Native points3D.bin parse → (xyz f64[n,3], rgb u8[n,3], err f64[n,1])
    or None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = lib.gsio_read_points3d(path.encode(), None, None, None)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n, 1), np.float64)
    got = lib.gsio_read_points3d(path.encode(),
                                 xyz.ctypes.data_as(ctypes.c_void_p),
                                 rgb.ctypes.data_as(ctypes.c_void_p),
                                 err.ctypes.data_as(ctypes.c_void_p))
    if got != n:
        return None
    return _count((xyz, rgb, err))


def read_images(path: str):
    """Native images.bin parse → dict[int, (qvec, tvec, camera_id, name)]
    or None."""
    lib = load()
    if lib is None:
        return None
    name_total = ctypes.c_longlong(0)
    n = lib.gsio_read_images(path.encode(), None, None, None, None, None,
                             ctypes.byref(name_total))
    if n < 0:
        return None
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names_buf = ctypes.create_string_buffer(int(name_total.value))
    got = lib.gsio_read_images(path.encode(),
                               ids.ctypes.data_as(ctypes.c_void_p),
                               qvec.ctypes.data_as(ctypes.c_void_p),
                               tvec.ctypes.data_as(ctypes.c_void_p),
                               cam_ids.ctypes.data_as(ctypes.c_void_p),
                               names_buf, None)
    if got != n:
        return None
    names = names_buf.raw.split(b"\x00")[:n]
    return _count({int(ids[i]): (qvec[i].copy(), tvec[i].copy(),
                                 int(cam_ids[i]), names[i].decode("utf-8"))
                   for i in range(n)})


def read_cameras(path: str):
    """Native cameras.bin parse → dict[int, (model_id, w, h, params)] or
    None."""
    lib = load()
    if lib is None:
        return None
    n = lib.gsio_read_cameras(path.encode(), None, None, None, None, None)
    if n < 0:
        return None
    ids = np.empty(n, np.int32)
    models = np.empty(n, np.int32)
    ws = np.empty(n, np.int64)
    hs = np.empty(n, np.int64)
    params = np.empty((n, 12), np.float64)
    got = lib.gsio_read_cameras(path.encode(),
                                ids.ctypes.data_as(ctypes.c_void_p),
                                models.ctypes.data_as(ctypes.c_void_p),
                                ws.ctypes.data_as(ctypes.c_void_p),
                                hs.ctypes.data_as(ctypes.c_void_p),
                                params.ctypes.data_as(ctypes.c_void_p))
    if got != n:
        return None
    n_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4,
                9: 5, 10: 12}
    return _count({int(ids[i]): (int(models[i]), int(ws[i]), int(hs[i]),
                                 params[i, :n_params[int(models[i])]].copy())
                   for i in range(n)})
