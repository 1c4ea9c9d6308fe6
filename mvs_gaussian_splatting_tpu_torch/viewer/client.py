"""Remote-viewer wire-protocol client.

The port's own copy of the JAX package's ``viewer/client.py`` (numpy and
sockets only). Counterpart to :mod:`viewer.network_gui` (the in-train
server) speaking the SIBR remote viewer's byte protocol (reference
gaussian_renderer/network_gui.py:43-55 read/send framing): request a
render of the live training state from an arbitrary camera, optionally
pausing training, and receive the raw RGB frame. It talks to a server of
either package.

Request fields mirror network_gui.receive(); the response is
``H·W·3`` raw RGB bytes followed by a 4-byte LE length + verify string (the
training source path).
"""

from __future__ import annotations

import json
import math
import socket
from typing import Optional, Tuple

import numpy as np

from ..utils import graphics


def orbit_camera(angle: float, radius: float = 4.0, height: float = 0.0,
                 target: Optional[np.ndarray] = None):
    """(R, T) world-to-view extrinsics orbiting ``target`` (COLMAP R conv)."""
    target = np.zeros(3) if target is None else np.asarray(target, np.float64)
    eye = target + np.array([radius * math.sin(angle), height,
                             -radius * math.cos(angle)])
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    R_w2c = np.stack([right, np.cross(forward, right), forward])
    return R_w2c.T, -R_w2c @ eye


class ViewerClient:
    """Blocking client for one training-server connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("server closed mid-message")
            buf.extend(part)
        return bytes(buf)

    def request(self, width: int, height: int, R: np.ndarray, T: np.ndarray,
                fovx: float, fovy: float, *, znear: float = 0.01,
                zfar: float = 100.0, train: bool = True,
                shs_python: bool = False, rot_scale_python: bool = False,
                keep_alive: bool = True, scaling_modifier: float = 1.0
                ) -> Tuple[np.ndarray, str]:
        """Render the live model from (R, T). Returns (rgb [H,W,3] u8, path).

        Matrices go over the wire transposed (torch row-vector convention)
        AND in the SIBR viewer's flipped-handedness convention — columns
        1, 2 of the transposed view matrix and column 1 of the transposed
        view-projection negated — because the server undoes exactly those
        negations on receipt (gaussian_renderer/network_gui.py:76-79).
        """
        w2v = graphics.world_to_view(R, T)
        proj = graphics.projection_matrix(znear, zfar, fovx, fovy)
        view_t = w2v.T.copy()
        view_t[:, 1] = -view_t[:, 1]
        view_t[:, 2] = -view_t[:, 2]
        full_t = (proj @ w2v).T.copy()
        full_t[:, 1] = -full_t[:, 1]
        msg = {
            "resolution_x": int(width),
            "resolution_y": int(height),
            "train": bool(train),
            "fov_y": float(fovy),
            "fov_x": float(fovx),
            "z_near": float(znear),
            "z_far": float(zfar),
            "shs_python": bool(shs_python),
            "rot_scale_python": bool(rot_scale_python),
            "keep_alive": bool(keep_alive),
            "scaling_modifier": float(scaling_modifier),
            "view_matrix": [float(v) for v in view_t.reshape(-1)],
            "view_projection_matrix": [float(v) for v in full_t.reshape(-1)],
        }
        payload = json.dumps(msg).encode("utf-8")
        self.sock.sendall(len(payload).to_bytes(4, "little"))
        self.sock.sendall(payload)

        rgb = np.frombuffer(self._recv_exact(width * height * 3),
                            dtype=np.uint8).reshape(height, width, 3)
        vlen = int.from_bytes(self._recv_exact(4), "little")
        verify = self._recv_exact(vlen).decode("ascii")
        return rgb, verify

    def disconnect_request(self) -> str:
        """Zero-resolution message: a no-op frame. The server still answers
        with the verify-string trailer (no image bytes); consume and return
        it so the stream stays framed for the next request."""
        msg = {"resolution_x": 0, "resolution_y": 0}
        payload = json.dumps(msg).encode("utf-8")
        self.sock.sendall(len(payload).to_bytes(4, "little"))
        self.sock.sendall(payload)
        vlen = int.from_bytes(self._recv_exact(4), "little")
        return self._recv_exact(vlen).decode("ascii")
