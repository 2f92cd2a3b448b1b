"""Benchmark dataset fetcher — TUM RGB-D + ICL-NUIM sequences used by the
reference's evaluation story (BASELINE.md; the reference writes `.freiburg`
trajectories for the TUM tooling, ElasticFusion.cpp:112-139).

Downloads + extracts into a local cache so `eval_suite.py` can run the
BASELINE.json configs against real sequences.  Without network egress this
fails fast with a clear message; eval_suite then falls back to the synthetic
sequence battery (utils/synthetic.py).  The port's copy of the reference
package's `tools/fetch_datasets.py`: the same table, messages and layout, so
either package's eval_suite reads a cache the other fetched.

Usage:
    python -m elasticfusion_tpu_torch.tools.fetch_datasets [-dir datasets] [names...]
"""

from __future__ import annotations

import argparse
import sys
import tarfile
import urllib.request
from pathlib import Path

TUM_BASE = "https://cvg.cit.tum.de/rgbd/dataset"
ICL_BASE = "http://www.doc.ic.ac.uk/~ahanda/VaFRIC"

DATASETS = {
    # name -> (url, kind)
    "fr1_desk": (f"{TUM_BASE}/freiburg1/rgbd_dataset_freiburg1_desk.tgz", "tum"),
    "fr2_xyz": (f"{TUM_BASE}/freiburg2/rgbd_dataset_freiburg2_xyz.tgz", "tum"),
    "fr3_office": (
        f"{TUM_BASE}/freiburg3/"
        "rgbd_dataset_freiburg3_long_office_household.tgz", "tum",
    ),
    "lr_kt0": (f"{ICL_BASE}/living_room_traj0_frei_png.tar.gz", "icl"),
    "lr_kt1": (f"{ICL_BASE}/living_room_traj1_frei_png.tar.gz", "icl"),
    "lr_kt2": (f"{ICL_BASE}/living_room_traj2_frei_png.tar.gz", "icl"),
    "lr_kt3": (f"{ICL_BASE}/living_room_traj3_frei_png.tar.gz", "icl"),
    "dyson_lab": (
        "http://www.doc.ic.ac.uk/~sleutene/datasets/elasticfusion/"
        "dyson_lab.klg", "klg",
    ),
}


def fetch(name: str, root: Path) -> Path:
    url, kind = DATASETS[name]
    dest = root / name
    if dest.exists() and any(dest.iterdir()):
        print(f"[cached] {name} -> {dest}")
        return dest
    dest.mkdir(parents=True, exist_ok=True)
    fname = dest / Path(url).name
    print(f"[fetch] {url}")
    try:
        urllib.request.urlretrieve(url, fname)
    except Exception as e:  # noqa: BLE001
        raise SystemExit(
            f"download failed for {name}: {e}\n"
            "No network egress? eval_suite.py will fall back to the "
            "synthetic benchmark battery."
        )
    if fname.suffixes[-1:] == [".klg"]:
        return dest
    with tarfile.open(fname) as tf:
        tf.extractall(dest)
    fname.unlink()
    print(f"[ok] {name} -> {dest}")
    return dest


def dataset_dir(name: str, root: Path) -> Path | None:
    """Resolve the TUM-format directory of a cached dataset, or None."""
    dest = root / name
    if not dest.exists():
        return None
    if (dest / "depth.txt").exists():
        return dest
    for sub in sorted(dest.iterdir()):
        if sub.is_dir() and (sub / "depth.txt").exists():
            return sub
    klg = list(dest.glob("*.klg"))
    return klg[0] if klg else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("names", nargs="*", default=None,
                   help="dataset names (default: all)")
    p.add_argument("-dir", dest="root", default="datasets")
    args = p.parse_args(argv)
    root = Path(args.root)
    for name in args.names or list(DATASETS):
        if name not in DATASETS:
            print(f"unknown dataset {name}; known: {sorted(DATASETS)}")
            return 1
        fetch(name, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
