"""COLMAP ingestion wrapper — the reference's convert.py (:31-123).

The port's copy of the JAX package's ``cli/convert.py``. Shells out to the
external ``colmap`` binary: feature extraction → exhaustive matching →
mapper → image undistortion to PINHOLE, with optional ImageMagick
downscales (images_2/4/8). Pure host tooling; unchanged semantics.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: str) -> None:
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}: {cmd}")
        raise SystemExit(code)


def main(argv=None):
    parser = argparse.ArgumentParser(description="COLMAP converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)

    colmap = f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    magick = f'"{args.magick_executable}"' if args.magick_executable else "magick"
    use_gpu = int(not args.no_gpu)
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run(f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}")
        run(f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP")

    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        print("Copying and resizing...")
        for factor, pct in (("images_2", 50), ("images_4", 25), ("images_8", 12.5)):
            os.makedirs(os.path.join(src, factor), exist_ok=True)
        for file in os.listdir(os.path.join(src, "images")):
            source_file = os.path.join(src, "images", file)
            for factor, pct in (("images_2", 50), ("images_4", 25),
                                ("images_8", 12.5)):
                dest = os.path.join(src, factor, file)
                shutil.copy2(source_file, dest)
                run(f"{magick} mogrify -resize {pct}% {dest}")
    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
