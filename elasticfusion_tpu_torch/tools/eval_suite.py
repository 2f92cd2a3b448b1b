"""Accuracy/throughput evaluation suite of the port (the reference package's
`tools/eval_suite.py`): runs the config ladder and writes a results table.

Two data sources:
  * real TUM / ICL-NUIM sequences when a datasets directory holds them — each
    run goes through `run_slam`, the same CLI + `.freiburg` path;
  * the synthetic battery (utils/synthetic.synthetic_trajectory) — exact
    ground truth, same engine path, results labelled SYNTHETIC.

On a CUDA card the battery runs at the full 640x480; on the CPU
(`-device cpu`) at 160x120.  Every configuration runs at pipeline depth 2.

Usage:
    python -m elasticfusion_tpu_torch.tools.eval_suite [-dir datasets]
        [-o RESULTS_torch.md] [-quick] [-synth-only] [-device cpu]
        [-configs name,...]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

from .fetch_datasets import dataset_dir

# (name, run_slam args, dataset name, ICL-NUIM)
REAL_CONFIGS = [
    # open-loop frame-to-frame fast odometry (`-o -ftf -fo` odometry mode)
    ("config1_fr1_xyz", ["-ol", "-ftf", "-fo"], "fr1_xyz", False),
    ("config2_fr1_desk", ["-c", "0.5"], "fr1_desk", False),
    ("config2_fr2_xyz", ["-c", "0.5"], "fr2_xyz", False),
    ("config4_fr3_office", ["-rl"], "fr3_office", False),
    ("config3_lr_kt0", [], "lr_kt0", True),
    ("config3_lr_kt1", [], "lr_kt1", True),
    ("config3_lr_kt2", [], "lr_kt2", True),
    ("config3_lr_kt3", [], "lr_kt3", True),
]

SYNTH_CONFIGS = [
    # (name, trajectory kind, frames, closeLoops, time_delta, extra cfg)
    ("synth_sweep_openloop_fast", "sweep", 120, False, 200,
     dict(frame_to_frame_rgb=True, fast_odom=True)),
    ("synth_sweep_openloop", "sweep", 120, False, 200, {}),
    ("synth_sweep_f2model", "sweep", 120, True, 200, {}),
    ("synth_there_back_localclosure", "there_back", 220, True, 80, {}),
    ("synth_orbit_globalclosure", "orbit", 260, True, 80, {}),
]


def run_real(root: Path, out_rows: list, device: str) -> None:
    from .run_slam import main as run_slam_main

    for name, extra, ds, icl in REAL_CONFIGS:
        d = dataset_dir(ds, root)
        if d is None:
            out_rows.append((name, ds, None, None, "dataset not cached"))
            continue
        klg = d.suffix == ".klg"
        src = ["-l", str(d)] if klg else ["-tum", str(d)]
        argv = src + ["-gt", str((d.parent if klg else d) / "groundtruth.txt"),
                      "-o", str(root / name), "-device", device] \
            + extra + (["-icl"] if icl else [])
        print(f"[run] {name}: run_slam {' '.join(argv)}", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_slam_main(argv)
        stats = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
        out_rows.append((
            name, ds, stats.get("ate_rmse_m"), stats.get("fps"),
            "" if rc == 0 else f"rc={rc}",
        ))


def run_synth(out_rows: list, quick: bool, device, configs=None) -> None:
    import numpy as np

    from ..config import CameraConfig, EngineConfig
    from ..engine import Engine
    from ..io.trajectory import ate_rmse
    from ..utils.synthetic import make_scene, render_frame, synthetic_trajectory

    on_card = device.type == "cuda"
    if on_card:
        cam = CameraConfig()  # full 640x480
        scene = make_scene(n_side=1400)
    else:
        cam = CameraConfig(width=160, height=120, fx=132.0, fy=132.0,
                           cx=80.0, cy=60.0)
        scene = make_scene(n_side=700)

    for name, kind, n, close, tdelta, extra in SYNTH_CONFIGS:
        if configs is not None and name not in configs:
            continue
        if quick:
            n = max(n // 4, 30)
        cfg = EngineConfig(
            camera=cam, max_surfels=1 << (21 if on_card else 17),
            confidence_threshold=0.3, closeLoops=close, time_delta=tdelta,
            pipeline_depth=2,
            # one pinned capacity bucket, as the reference's battery runs
            initial_surfels=1 << (19 if on_card else 15),
            **extra,
        )
        eng = Engine(cfg, device)
        Ts = synthetic_trajectory(kind, n)
        # rendered ahead on the host: the fps column measures the engine,
        # not the synthetic renderer
        rendered = [render_frame(scene[0], scene[1], T, cam) for T in Ts]
        gt = []
        # fps is steady-state: the median per-frame wall time after a short
        # warm-up (the original's 30 Hz bar, MainController.cpp:249-251)
        warm = min(8, n // 4)
        frame_t = []
        for i, (T, (d, r)) in enumerate(zip(Ts, rendered)):
            t0 = time.perf_counter()
            eng.process_frame(r, d, timestamp=int(i * 33333))
            frame_t.append(time.perf_counter() - t0)
            gt.append((i * 0.033333, T))
        eng.flush()
        med = float(np.median(frame_t[warm:]))
        est = [(i * 0.033333, T) for i, (_, T) in enumerate(eng.tick_poses)]
        ate = ate_rmse(gt, est, align=False)
        out_rows.append((
            name, f"SYNTHETIC {kind} x{n}", round(ate, 5),
            round(1.0 / med, 2),
            f"deforms={eng.deforms}+{eng.fern_deforms} "
            f"surfels={eng.surfel_count}",
        ))
        print(f"[done] {name}: ate={ate*1000:.1f}mm {1.0/med:.2f}fps(med)",
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-dir", dest="root", default="datasets")
    p.add_argument("-o", dest="out", default="RESULTS_torch.md")
    p.add_argument("-quick", action="store_true")
    p.add_argument("-synth-only", action="store_true")
    p.add_argument("-device", dest="device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("-configs", default=None,
                   help="comma-separated synthetic configuration names (default: all)")
    args = p.parse_args(argv)
    root = Path(args.root)

    import torch

    from .._device import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    configs = None if args.configs is None else set(args.configs.split(","))

    rows: list = []
    have_real = root.exists() and any(root.iterdir()) and not args.synth_only
    if have_real:
        run_real(root, rows, args.device)
    run_synth(rows, args.quick, device, configs)

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    lines = [
        "# RESULTS — elasticfusion_tpu_torch evaluation",
        "",
        f"Device: `{where}`; generated by "
        "`python -m elasticfusion_tpu_torch.tools.eval_suite`.",
        "",
    ]
    if not have_real:
        lines += [
            "**No real benchmark datasets are cached.**  Rows below are the",
            "SYNTHETIC battery: exact ground-truth trajectories over a",
            "procedurally-textured scene, run through the identical",
            "engine/.freiburg/ATE path.",
            "",
        ]
    lines += [
        "The fps column is the MEDIAN per-frame rate after warm-up.",
        "",
        "| config | sequence | ATE RMSE (m) | fps | notes |",
        "|---|---|---|---|---|",
    ]
    for name, seq, ate, fps, note in rows:
        lines.append(
            f"| {name} | {seq} | "
            f"{'-' if ate is None else ate} | {'-' if fps is None else fps} "
            f"| {note} |"
        )
    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
