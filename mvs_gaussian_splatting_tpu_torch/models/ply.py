"""PLY interchange I/O — bit-compatible with the reference's model snapshots.

The reference stores models as binary-little-endian PLY with fields
x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_* (scene/gaussian_model.py
save_ply :293-310 / load_ply :317-358) and point clouds as x,y,z,nx,ny,nz,
red,green,blue (scene/dataset_readers.py storePly :115-130 / fetchPly
:107-113). Implemented with plain numpy (no plyfile dependency): the format is
a text header + packed little-endian records.

Field-order detail matched to the reference: f_rest is stored channel-major
(the [N, R, 3] coefficient array transposed to [N, 3, R] before flattening),
as the reference's ``transpose(1, 2).flatten(start_dim=1)``.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict

import numpy as np


def _open_ply(path: str, mode: str):
    """Binary file handle; a ``.gz`` suffix selects transparent gzip.

    Run artifacts gitignore the raw point_cloud/ PLYs as heavy binaries, so a
    converged model used to die with its round — blocking any later offline
    re-measurement (the round-4 specscale eval-gap investigation had no model
    left to re-render). Validation runs now retain the final model as an
    EXACT gzipped PLY small enough to commit."""
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


_PLY_DTYPES = {"f4": "float", "u1": "uchar", "f8": "double", "i4": "int"}
_PLY_DTYPES_INV = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4",
                   "float32": "<f4", "uint8": "u1", "float64": "<f8", "int32": "<i4"}


def write_ply(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY 'vertex' element from named columns."""
    names = list(fields)
    n = len(fields[names[0]])
    dtype = np.dtype([(name, fields[name].dtype.str) for name in names])
    rec = np.empty(n, dtype=dtype)
    for name in names:
        rec[name] = fields[name]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name in names:
        kind = fields[name].dtype.str.lstrip("<>|=")
        header.append(f"property {_PLY_DTYPES[kind]} {name}")
    header.append("end_header")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _open_ply(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY (binary LE or ascii) into columns."""
    with _open_ply(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break
        if n is None:
            raise ValueError(f"{path}: no vertex element")
        dtype = np.dtype([(name, _PLY_DTYPES_INV[kind]) for name, kind in props])
        if fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        elif fmt == "ascii":
            rows = [f.readline().split()[:len(props)] for _ in range(n)]
            rec = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def save_gaussian_ply(path: str, gaussians: Dict[str, np.ndarray]) -> None:
    """Write a Gaussian model snapshot in the reference's schema.

    gaussians: compacted arrays — xyz [N,3], f_dc [N,1,3], f_rest [N,R,3],
    opacity [N,1], scaling [N,3], rotation [N,4] (raw/unactivated values).
    """
    xyz = np.asarray(gaussians["xyz"], np.float32)
    n = len(xyz)
    f_dc = np.asarray(gaussians["f_dc"], np.float32).transpose(0, 2, 1).reshape(n, -1)
    f_rest = np.asarray(gaussians["f_rest"], np.float32).transpose(0, 2, 1).reshape(n, -1)
    fields: Dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        fields[name] = xyz[:, i]
    for i, name in enumerate(("nx", "ny", "nz")):
        fields[name] = np.zeros(n, np.float32)
    for i in range(f_dc.shape[1]):
        fields[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        fields[f"f_rest_{i}"] = f_rest[:, i]
    fields["opacity"] = np.asarray(gaussians["opacity"], np.float32).reshape(n)
    scaling = np.asarray(gaussians["scaling"], np.float32)
    for i in range(scaling.shape[1]):
        fields[f"scale_{i}"] = scaling[:, i]
    rotation = np.asarray(gaussians["rotation"], np.float32)
    for i in range(rotation.shape[1]):
        fields[f"rot_{i}"] = rotation[:, i]
    write_ply(path, fields)


def load_gaussian_ply(path: str, max_sh_degree: int = 3) -> Dict[str, np.ndarray]:
    """Read a reference-schema Gaussian PLY back into raw parameter arrays."""
    cols = read_ply(path)
    n = len(cols["x"])
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    f_dc = np.stack([cols["f_dc_0"], cols["f_dc_1"], cols["f_dc_2"]], axis=1)
    rest_names = sorted((k for k in cols if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    expected = 3 * (max_sh_degree + 1) ** 2 - 3
    if len(rest_names) != expected:
        raise ValueError(f"expected {expected} f_rest fields, got {len(rest_names)}")
    f_rest = np.stack([cols[k] for k in rest_names], axis=1).reshape(n, 3, -1)
    scale_names = sorted((k for k in cols if k.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((k for k in cols if k.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    return {
        "xyz": xyz.astype(np.float32),
        "f_dc": f_dc[:, None, :].transpose(0, 1, 2).astype(np.float32).reshape(n, 1, 3),
        "f_rest": f_rest.transpose(0, 2, 1).astype(np.float32),
        "opacity": cols["opacity"].astype(np.float32)[:, None],
        "scaling": np.stack([cols[k] for k in scale_names], 1).astype(np.float32),
        "rotation": np.stack([cols[k] for k in rot_names], 1).astype(np.float32),
    }


def store_point_cloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """storePly-compatible point cloud (rgb uint8 0-255)."""
    n = len(xyz)
    fields = {}
    for i, name in enumerate("xyz"):
        fields[name] = np.asarray(xyz, np.float32)[:, i]
    for name in ("nx", "ny", "nz"):
        fields[name] = np.zeros(n, np.float32)
    for i, name in enumerate(("red", "green", "blue")):
        fields[name] = np.asarray(rgb, np.uint8)[:, i]
    write_ply(path, fields)


def fetch_point_cloud_ply(path: str):
    """fetchPly-compatible: returns (points [N,3], colors [N,3] in [0,1], normals)."""
    cols = read_ply(path)
    points = np.stack([cols["x"], cols["y"], cols["z"]], 1).astype(np.float32)
    colors = np.stack([cols["red"], cols["green"], cols["blue"]], 1).astype(np.float32) / 255.0
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], 1).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals
