"""COLMAP preprocessing pipeline: port of msgs/apps/convert.py.

Shells out to the `colmap` binary for feature extraction, matching,
mapping and undistortion, moves the undistorted model into sparse/0, and
with --resize writes images_2/, images_4/ and images_8/ (through PIL, as
the JAX app does). It runs no torch.

  python -m msgs_torch.apps.convert -s <dir with input/ images> [--no_gpu]
      [--skip_matching] [--resize]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: str):
    print("+", cmd)
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}. Exiting.")
        sys.exit(code)


def main(argv=None):
    p = argparse.ArgumentParser("msgs_torch convert")
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--resize", action="store_true",
                   help="also write images_2/ images_4/ images_8/")
    p.add_argument("--magick_executable", default="")
    args = p.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap.split()[0]) is None:
        raise SystemExit(
            f"'{colmap}' not found on PATH — install COLMAP or pass "
            f"--colmap_executable")
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
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

    # Move sparse/* into sparse/0, where the scene loader looks first.
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        from PIL import Image
        for scale, name in ((2, "images_2"), (4, "images_4"),
                            (8, "images_8")):
            out_dir = os.path.join(src, name)
            os.makedirs(out_dir, exist_ok=True)
            for fname in os.listdir(os.path.join(src, "images")):
                with Image.open(os.path.join(src, "images", fname)) as im:
                    im.resize((im.width // scale, im.height // scale)
                              ).save(os.path.join(out_dir, fname))
        print("wrote images_2/ images_4/ images_8/")

    print("Done.")


if __name__ == "__main__":
    main()
