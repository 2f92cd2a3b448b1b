"""Binary PLY surfel export/import (own copy of the reference package's
`io/ply.py`), byte-compatible with `ElasticFusion::savePly`
(ElasticFusion.cpp:684-781): binary_little_endian 1.0 with per-vertex
`x y z (f32) r g b (u8) nx ny nz radius (f32)`, normals negated, surfels
below the confidence threshold dropped.  `save_ply` takes the port's torch
`SurfelMap` and reads it to the host once."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .._device import read_back

_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("radius", "<f4"),
    ]
)


def map_to_host(surfel_map):
    """The live surfels of a map as host arrays, in ONE device read:
    (pos [3,n], conf [n], color [3,n], init_t [n], last_t [n],
    normal [3,n], radius [n]).  The count rides in the read as a float32
    (exact below 2^24)."""
    m = surfel_map
    f32 = torch.float32
    packed = read_back(torch.cat([
        m.count.to(f32).reshape(1), m.pos.reshape(-1), m.conf, m.color.reshape(-1),
        m.init_t, m.last_t, m.normal.reshape(-1), m.radius]))
    cap = m.capacity
    n = int(packed[0])
    fields, o = [], 1
    for rows in (3, 1, 3, 1, 1, 3, 1):
        a = packed[o:o + rows * cap].reshape(rows, cap)[:, :n]
        fields.append(a if rows == 3 else a[0])
        o += rows * cap
    return tuple(np.ascontiguousarray(a) for a in fields)


def save_ply(path: str | Path, surfel_map, conf_threshold: float) -> int:
    """Write live surfels with conf > threshold.  Returns the vertex count."""
    pos, conf, col, _, _, nrm, rad = map_to_host(surfel_map)
    keep = conf > conf_threshold
    m = int(keep.sum())

    rec = np.empty(m, _DTYPE)
    rec["x"], rec["y"], rec["z"] = pos[0, keep], pos[1, keep], pos[2, keep]
    rec["red"] = np.clip(col[0, keep], 0, 255).astype(np.uint8)
    rec["green"] = np.clip(col[1, keep], 0, 255).astype(np.uint8)
    rec["blue"] = np.clip(col[2, keep], 0, 255).astype(np.uint8)
    # the original flips normals on export (ElasticFusion.cpp:741-743)
    rec["nx"], rec["ny"], rec["nz"] = -nrm[0, keep], -nrm[1, keep], -nrm[2, keep]
    rec["radius"] = rad[keep]

    header = (
        "ply\nformat binary_little_endian 1.0"
        f"\nelement vertex {m}"
        "\nproperty float x\nproperty float y\nproperty float z"
        "\nproperty uchar red\nproperty uchar green\nproperty uchar blue"
        "\nproperty float nx\nproperty float ny\nproperty float nz"
        "\nproperty float radius"
        "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return m


def load_ply(path: str | Path) -> np.ndarray:
    """Read a PLY written by save_ply (or the original system) into a
    structured array with fields x,y,z,red,green,blue,nx,ny,nz,radius."""
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii")
    count = 0
    for line in header.splitlines():
        if line.startswith("element vertex"):
            count = int(line.split()[-1])
    return np.frombuffer(raw[end:], dtype=_DTYPE, count=count)
