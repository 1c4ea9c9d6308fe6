"""SIBR remote-viewer wire protocol server.

Port of the JAX package's ``viewer/network_gui.py``, byte-compatible with
it and with gaussian_renderer/network_gui.py (:24-86), so the reference's
SIBR_remoteGaussian viewer, the JAX package's client or this package's can
connect to a training run of either package:

- non-blocking TCP listener; one connection at a time
- request: 4-byte LE length + JSON message {resolution_x, resolution_y,
  train, fov_y, fov_x, z_near, z_far, shs_python, rot_scale_python,
  keep_alive, scaling_modifier, view_matrix (16 floats), view_projection_
  matrix (16 floats)}
- response: H·W·3 raw RGB bytes, then 4-byte LE length + training source
  path string

The receive() return layout mirrors the reference: (custom_camera|None,
do_training, convert_SHs_python, compute_cov3D_python, keep_alive,
scaling_modifier). The camera is returned as a MiniCam-style object whose
``view(device)`` is the port's ``CameraView`` ready for ops.render.
"""

from __future__ import annotations

import json
import math
import socket
import traceback
from typing import Optional

import numpy as np

host: Optional[str] = None
port: Optional[int] = None
listener: Optional[socket.socket] = None
conn: Optional[socket.socket] = None
addr = None


class MiniCam:
    """Pose-only camera from viewer matrices (scene/cameras.py:59-71).

    The viewer sends the torch-convention transposed matrices; we convert to
    this framework's column-vector CameraView on demand.
    """

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transposed: np.ndarray,
                 full_proj_transposed: np.ndarray):
        self.image_width = width
        self.image_height = height
        self.FoVy = fovy
        self.FoVx = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transposed = world_view_transposed
        self.full_proj_transposed = full_proj_transposed

    def view(self, device="cuda"):
        import torch

        from ..ops.preprocess import CameraView
        w2v = self.world_view_transposed.T
        proj = self.full_proj_transposed.T
        campos = np.linalg.inv(w2v)[:3, 3]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return CameraView(f32(w2v), f32(proj), f32(campos),
                          f32(math.tan(self.FoVx * 0.5)),
                          f32(math.tan(self.FoVy * 0.5)))


def init(wish_host: str, wish_port: int) -> None:
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def close() -> None:
    """Close the connection and the listener, if open: the loop's pump is a
    no-op again."""
    global listener, conn
    for s in (conn, listener):
        if s is not None:
            s.close()
    conn = listener = None


def try_connect() -> None:
    global conn, addr
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def _recv_exact(n: int) -> bytes:
    """recv() can return partial data on fragmented TCP streams (the
    reference's single-recv read drops the connection in that case —
    network_gui.py:43-48); loop until the full message arrives."""
    buf = bytearray()
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("viewer closed mid-message")
        buf.extend(part)
    return bytes(buf)


def read() -> dict:
    messageLength = int.from_bytes(_recv_exact(4), "little")
    return json.loads(_recv_exact(messageLength).decode("utf-8"))


def send(message_bytes: Optional[bytes], verify: str) -> None:
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive():
    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width != 0 and height != 0:
        try:
            do_training = bool(message["train"])
            fovy = message["fov_y"]
            fovx = message["fov_x"]
            znear = message["z_near"]
            zfar = message["z_far"]
            do_shs_python = bool(message["shs_python"])
            do_rot_scale_python = bool(message["rot_scale_python"])
            keep_alive = bool(message["keep_alive"])
            scaling_modifier = message["scaling_modifier"]
            world_view = np.reshape(np.array(message["view_matrix"]), (4, 4))
            full_proj = np.reshape(np.array(message["view_projection_matrix"]),
                                   (4, 4))
            # The SIBR viewer sends a flipped-handedness convention: negate
            # columns 1, 2 of the (transposed) view matrix and column 1 of
            # the full-projection matrix on receipt, exactly as the
            # reference does (gaussian_renderer/network_gui.py:76-79).
            world_view[:, 1] = -world_view[:, 1]
            world_view[:, 2] = -world_view[:, 2]
            full_proj[:, 1] = -full_proj[:, 1]
            custom_cam = MiniCam(width, height, fovy, fovx, znear, zfar,
                                 world_view, full_proj)
        except Exception:
            print("")
            traceback.print_exc()
            raise
        return (custom_cam, do_training, do_shs_python, do_rot_scale_python,
                keep_alive, scaling_modifier)
    return None, None, None, None, None, None


def render_to_bytes(image) -> memoryview:
    """[3, H, W] float render (a tensor on any device, or an array) → the
    viewer's H·W·3 byte payload."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    arr = np.clip(arr, 0.0, 1.0)
    return memoryview((arr * 255).astype(np.uint8).transpose(1, 2, 0).copy())
