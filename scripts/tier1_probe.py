"""Probes for a whole run of the test suite on the CPU: where its time goes
and how often the viewer test's race strikes.

Three tools, one file:

- ``race OUT [PERIOD]``: repeat ``tests/test_network_gui.py``'s race
  every PERIOD seconds (default 5) until killed, one JSON line a trial in
  OUT: a client thread connects while the main thread pumps the training
  loop's ``_gui_pump`` 200 times on a non-blocking listener. ``served`` is
  false where the client got no frame (the test then waits out its 900 s
  socket timeout; here the client gives up after 8 s; the first trial
  compiles the render and is not one). Run it beside a whole run to read
  the strike rate over the run's course::

      JAX_PLATFORMS=cpu python scripts/tier1_probe.py race race.jsonl &

- ``cpu -- CMD ...``: run CMD and print the machine's CPU-seconds over it
  from ``/proc/stat`` (user, nice, system, idle, steal) and its wall time.
- as a pytest plugin (``PYTHONPATH=scripts ... pytest -p tier1_probe``):
  each xdist worker appends "epoch-seconds worker start|end node-id" for
  every test to ``$TIER1_TIMELOG`` (files' start times and overlaps).
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def race(out_path: str, period: float = 5.0) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np

    from mvs_gaussian_splatting_tpu.models.gaussians import init_from_pcd
    from mvs_gaussian_splatting_tpu.ops.rasterize import RasterConfig
    from mvs_gaussian_splatting_tpu.train.config import ModelConfig
    from mvs_gaussian_splatting_tpu.train.loop import _gui_pump
    from mvs_gaussian_splatting_tpu.viewer import network_gui
    from mvs_gaussian_splatting_tpu.viewer.client import (ViewerClient,
                                                           orbit_camera)

    # the test's model and layout (tests/test_network_gui.py)
    rng = np.random.RandomState(0)
    params, aux = init_from_pcd(
        rng.uniform(-0.5, 0.5, (32, 3)).astype(np.float32),
        rng.rand(32, 3).astype(np.float32), capacity=64, sh_degree=2)
    model_cfg = ModelConfig(source_path="/data/scene42")
    raster_cfg = RasterConfig(tile_capacity=64, max_tiles_per_gaussian=16,
                              tile_batch=8, backend="jnp")
    t_start = time.time()
    with open(out_path, "a") as out:
        while True:
            network_gui.init("127.0.0.1", 0)
            port = network_gui.listener.getsockname()[1]
            result = {}

            def client():
                try:
                    with ViewerClient("127.0.0.1", port, timeout=8.0) as c:
                        R, T = orbit_camera(0.3)
                        f = math.radians(60.0)
                        result["rgb"], _ = c.request(64, 64, R, T, f, f,
                                                     train=True,
                                                     keep_alive=False)
                except OSError as e:
                    result["error"] = repr(e)

            t0 = time.time()
            th = threading.Thread(target=client)
            th.start()
            pumps = 0
            for it in range(200):
                pumps += 1
                _gui_pump(model_cfg, params, aux, raster_cfg, sh_degree=0,
                          iteration=it, max_iterations=100)
                if not th.is_alive():
                    break
            th.join(timeout=20)
            if network_gui.conn is not None:
                network_gui.conn.close()
                network_gui.conn = None
            network_gui.listener.close()
            network_gui.listener = None
            out.write(json.dumps({"t": round(t0 - t_start, 1),
                                  "pumps": pumps,
                                  "served": "rgb" in result}) + "\n")
            out.flush()
            time.sleep(period)


def _stat():
    with open("/proc/stat") as f:
        return [int(v) for v in f.readline().split()[1:]]


def cpu(cmd) -> int:
    s0, t0 = _stat(), time.time()
    rc = subprocess.call(cmd)
    s1, t1 = _stat(), time.time()
    d = [(b - a) / os.sysconf("SC_CLK_TCK") for a, b in zip(s0, s1)]
    print(json.dumps({"rc": rc, "wall_s": round(t1 - t0, 1),
                      "user": d[0], "nice": d[1], "system": d[2],
                      "idle": d[3], "steal": d[7],
                      "busy": d[0] + d[1] + d[2]}))
    return rc


def _log(kind: str, nodeid: str) -> None:
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker and os.environ.get("TIER1_TIMELOG"):
        with open(os.environ["TIER1_TIMELOG"], "a") as f:
            f.write(f"{time.time():.2f} {worker} {kind} {nodeid}\n")


def pytest_runtest_logstart(nodeid, location):
    _log("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _log("end", nodeid)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "race":
        race(sys.argv[2], float(sys.argv[3]) if len(sys.argv) > 3 else 5.0)
    elif len(sys.argv) >= 3 and sys.argv[1] == "cpu" and "--" in sys.argv:
        sys.exit(cpu(sys.argv[sys.argv.index("--") + 1:]))
    else:
        sys.exit(__doc__)
