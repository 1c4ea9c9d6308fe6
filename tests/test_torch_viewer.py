"""The port's network viewer (``viewer/``, the loop's ``_gui_pump``) over a
real loopback socket: the twins of the JAX package's
``tests/test_network_gui.py`` (framing, frame layout, verify string, the
train toggle, the SIBR sign flips, the pipeline toggles, the zero-size
request), and the JAX package's ``ViewerClient`` talking to the port's
server, byte for byte.

Each test pumps the server until its client thread has finished (bounded
by a deadline), not a fixed number of times: a pump before the client has
connected returns at once, so a fixed count can run out first. Every socket
has a timeout, and every thread is joined with one.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

from mvs_gaussian_splatting_tpu.viewer.client import \
    ViewerClient as JViewerClient
from mvs_gaussian_splatting_tpu_torch.models.gaussians import init_from_pcd
from mvs_gaussian_splatting_tpu_torch.ops.preprocess import CameraView
from mvs_gaussian_splatting_tpu_torch.ops.rasterize import RasterConfig
from mvs_gaussian_splatting_tpu_torch.ops.render import render
from mvs_gaussian_splatting_tpu_torch.train.config import ModelConfig
from mvs_gaussian_splatting_tpu_torch.train.loop import _gui_pump
from mvs_gaussian_splatting_tpu_torch.utils import graphics
from mvs_gaussian_splatting_tpu_torch.viewer import network_gui
from mvs_gaussian_splatting_tpu_torch.viewer.client import (ViewerClient,
                                                            orbit_camera)

torch.set_num_threads(1)

W = H = 64
TIMEOUT = 60.0
RASTER = RasterConfig(tile_capacity=64, max_tiles_per_gaussian=16,
                      tile_batch=8, backend="jnp")


@pytest.fixture
def server_port():
    network_gui.init("127.0.0.1", 0)
    port = network_gui.listener.getsockname()[1]
    yield port
    network_gui.close()


def tiny_model(n=32, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    return init_from_pcd(pts, cols, capacity=64, sh_degree=2, device="cpu")


def serve(client, model_cfg, params, aux, raster_cfg=RASTER):
    """Runs ``client`` (a function) in a thread and pumps the server, one
    pump an iteration, until the thread has finished or the deadline has
    passed; returns what the client put in its dict."""
    result = {}
    th = threading.Thread(target=client, args=(result,), daemon=True)
    th.start()
    deadline = time.monotonic() + TIMEOUT
    it = 0
    while th.is_alive() and time.monotonic() < deadline:
        _gui_pump(model_cfg, params, aux, raster_cfg, sh_degree=0,
                  iteration=it, max_iterations=100)
        it += 1
        time.sleep(0.001)
    th.join(timeout=TIMEOUT)
    assert not th.is_alive()
    assert "error" not in result, result.get("error")
    return result


def client_of(fn, port, cls=ViewerClient):
    def run(result):
        try:
            with cls("127.0.0.1", port, timeout=TIMEOUT) as c:
                fn(c, result)
        except Exception as e:   # noqa: BLE001 - reported by serve()
            result["error"] = repr(e)
    return run


def direct_render_u8(params, aux, R, T, fovx, raster_cfg=RASTER):
    """The frame of a direct render with the unflipped camera, its matrices
    in float64 as the server reads them (its centre is numpy's float64
    inverse; a float32 inverse can move the view-dependent colour by an
    8-bit step)."""
    w2v = graphics.world_to_view(R, T).astype(np.float64)
    proj = graphics.projection_matrix(0.01, 100.0, fovx, fovx)
    tan = torch.tensor(math.tan(fovx / 2), dtype=torch.float32)
    view = CameraView(torch.tensor(w2v.astype(np.float32)),
                      torch.tensor((proj @ w2v).astype(np.float32)),
                      torch.tensor(np.linalg.inv(w2v)[:3, 3].astype(
                          np.float32)), tan, tan)
    with torch.no_grad():
        img = render(view, W, H, params, torch.zeros(3), sh_degree=0,
                     alive=aux.alive, raster_config=raster_cfg)["render"]
    return np.asarray(network_gui.render_to_bytes(img)).reshape(H, W, 3)


def test_client_receives_frame_and_verify_string(server_port):
    params, aux = tiny_model()

    def ask(c, result):
        R, T = orbit_camera(0.3)
        fovx = math.radians(60.0)
        result["rgb"], result["verify"] = c.request(
            W, H, R, T, fovx, fovx, train=True, keep_alive=False)

    result = serve(client_of(ask, server_port),
                   ModelConfig(source_path="/data/scene42"), params, aux)
    assert result["verify"] == "/data/scene42"
    rgb = result["rgb"]
    assert rgb.shape == (H, W, 3) and rgb.dtype == np.uint8
    assert rgb.max() > 10          # the splats appear
    assert rgb.min() == 0          # background


def test_sibr_convention_matches_direct_render(server_port):
    """A request in the SIBR viewer's flipped-handedness convention renders
    what a direct render with the unflipped camera does."""
    params, aux = tiny_model()
    fovx = math.radians(60.0)
    R, T = orbit_camera(0.7)

    def ask(c, result):
        result["rgb"], _ = c.request(W, H, R, T, fovx, fovx, train=True,
                                     keep_alive=False)

    result = serve(client_of(ask, server_port), ModelConfig(source_path="p"),
                   params, aux)
    assert result["rgb"].max() > 10
    np.testing.assert_array_equal(result["rgb"],
                                  direct_render_u8(params, aux, R, T, fovx))


def test_viewer_pipeline_toggles_plumb_into_render(server_port):
    """shs_python / rot_scale_python reach the render call: with both on,
    the frame matches the default path's."""
    params, aux = tiny_model()
    fovx = math.radians(60.0)
    R, T = orbit_camera(0.7)

    def ask(c, result):
        result["base"], _ = c.request(W, H, R, T, fovx, fovx, train=False,
                                      keep_alive=True)
        result["toggled"], _ = c.request(W, H, R, T, fovx, fovx, train=True,
                                         keep_alive=False, shs_python=True,
                                         rot_scale_python=True)

    result = serve(client_of(ask, server_port), ModelConfig(source_path="p"),
                   params, aux)
    assert result["base"].max() > 10
    diff = np.abs(result["base"].astype(int) - result["toggled"].astype(int))
    assert diff.max() <= 1


def test_zero_resolution_is_noop_and_connection_survives(server_port):
    params, aux = tiny_model()

    def ask(c, result):
        result["verify"] = c.disconnect_request()
        R, T = orbit_camera(1.1)
        fovx = math.radians(60.0)
        result["rgb"], _ = c.request(W, H, R, T, fovx, fovx, train=True,
                                     keep_alive=False)

    result = serve(client_of(ask, server_port), ModelConfig(source_path="p"),
                   params, aux)
    assert result["verify"] == "p"
    assert result["rgb"].shape == (H, W, 3)


def test_jax_client_talks_to_port_server(server_port):
    """The JAX package's client against the port's server: the same wire
    protocol, byte for byte; its frames equal direct renders."""
    params, aux = tiny_model(seed=3)
    fovx = math.radians(50.0)
    poses = [orbit_camera(a, radius=3.0) for a in (0.2, 1.4)]

    def ask(c, result):
        result["frames"] = [c.request(W, H, R, T, fovx, fovx, train=False)
                            for R, T in poses]
        result["verify"] = c.disconnect_request()

    result = serve(client_of(ask, server_port, JViewerClient),
                   ModelConfig(source_path="/scenes/jax"), params, aux)
    assert result["verify"] == "/scenes/jax"
    for (rgb, verify), (R, T) in zip(result["frames"], poses):
        assert verify == "/scenes/jax"
        assert rgb.max() > 10
        np.testing.assert_array_equal(
            rgb, direct_render_u8(params, aux, R, T, fovx))
