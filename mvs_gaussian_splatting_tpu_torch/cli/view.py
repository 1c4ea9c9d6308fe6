"""Headless remote viewer — client counterpart to the training GUI server.

Port of the JAX package's ``cli/view.py``. The reference relies on the
SIBR_viewers C++ app to watch a live training run (README.md:288-340); this
CLI speaks the same wire protocol from Python: connect to a running
``cli.train --ip --port`` session (of either package), orbit the scene (or
hold a fixed view), and save the received frames as PNGs. Works over SSH
with no GL, and needs no card.

Example:
    python -m mvs_gaussian_splatting_tpu_torch.cli.view \
        --port 6009 --frames 24 --radius 4 --out /tmp/view
"""

from __future__ import annotations

import argparse
import math
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Remote training viewer")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--fovx_deg", type=float, default=60.0)
    parser.add_argument("--frames", type=int, default=1,
                        help="number of orbit frames to capture")
    parser.add_argument("--radius", type=float, default=4.0)
    parser.add_argument("--cam_height", type=float, default=0.0)
    parser.add_argument("--angle_deg", type=float, default=0.0,
                        help="start angle (single-frame: the view angle)")
    parser.add_argument("--pause_training", action="store_true",
                        help="ask the server to pause optimization while "
                             "frames are captured")
    parser.add_argument("--scaling_modifier", type=float, default=1.0)
    parser.add_argument("--out", type=str, default="viewer_frames")
    args = parser.parse_args(argv)

    from PIL import Image

    from ..utils import graphics
    from ..viewer.client import ViewerClient, orbit_camera

    fovx = math.radians(args.fovx_deg)
    fovy = graphics.focal2fov(graphics.fov2focal(fovx, args.width),
                              args.height)
    os.makedirs(args.out, exist_ok=True)

    with ViewerClient(args.ip, args.port) as client:
        for i in range(args.frames):
            angle = math.radians(args.angle_deg) + 2 * math.pi * i / max(
                args.frames, 1)
            R, T = orbit_camera(angle, radius=args.radius,
                                height=args.cam_height)
            rgb, source = client.request(
                args.width, args.height, R, T, fovx, fovy,
                train=not args.pause_training,
                scaling_modifier=args.scaling_modifier)
            path = os.path.join(args.out, f"frame_{i:04d}.png")
            Image.fromarray(rgb, "RGB").save(path)
            print(f"[{i + 1}/{args.frames}] {path}  (training: {source})")


if __name__ == "__main__":
    main()
