"""Writes the JPEG-colour `.klg` fixture `sweep_jpeg.klg` and the colour a
PIL decode of it gives, every 8th row (`sweep_jpeg_rows.npz`): the first two
frames of the 640x480 synthetic sweep (`chip_smoke.make_frames`), colour as
JPEG at quality 75 the way the original Logger stores it, depth zlib.

    python tests/data/make_jpeg_klg.py          # from the repository root

Needs PIL; the files are committed so that a machine without PIL can hold its
native decoder against them."""

import io
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from elasticfusion_tpu_torch.config import CameraConfig  # noqa: E402
from elasticfusion_tpu_torch.io.klg import write_klg  # noqa: E402
from elasticfusion_tpu_torch.utils.synthetic import (  # noqa: E402
    make_scene,
    pose_from_xyzrpy,
    render_frame,
)

N_FRAMES, QUALITY, ROW_STEP = 2, 75, 8


def main() -> None:
    from PIL import Image

    cam = CameraConfig()
    scene = make_scene(n_side=1400)
    frames = []
    for i in range(N_FRAMES):
        T = pose_from_xyzrpy(x=0.008 * i, yaw=0.003 * i, z=0.002 * i)
        d, rgb = render_frame(scene[0], scene[1], T, cam)
        frames.append((1_000_000 + 33_333 * i, d, rgb))
    path = os.path.join(HERE, "sweep_jpeg.klg")
    write_klg(path, frames, jpeg_quality=QUALITY)
    rows = []
    for _, _, rgb in frames:
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=QUALITY)
        rows.append(np.asarray(Image.open(buf).convert("RGB"))[::ROW_STEP])
    np.savez_compressed(os.path.join(HERE, "sweep_jpeg_rows.npz"),
                        rows=np.stack(rows), row_step=ROW_STEP)


if __name__ == "__main__":
    main()
