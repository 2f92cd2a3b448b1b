"""Headless SLAM runner of the port — the MainController/Main.cpp equivalent
(MainController.cpp:22-123 of the original system, CLI flags per its
README), with the same flags and defaults as the reference package's
`tools/run_slam.py`.

Consumes a .klg log or a TUM-format dataset directory, runs the engine frame
loop, writes the `.freiburg` trajectory and `.ply` map, and (given ground
truth) reports ATE RMSE as one JSON line of stats.

    python -m elasticfusion_tpu_torch.tools.run_slam -l seq.klg -o out
    python -m elasticfusion_tpu_torch.tools.run_slam -tum dir -device cpu

Runs on the CUDA card unless `-device` names something else (`-device cpu`
takes the plain PyTorch versions of the kernels); without a card the default
raises.  A `.klg` is decoded natively where the host can build the decoder
(the stats line names the decoder).

Multi-device and multi-process runs, as the reference's flags:
`-mesh S` shards the surfel map over S sub-maps (one process: on
`cuda:0..S-1`, or all on `-device` when it is given); `-dist-coordinator
host:port -dist-nprocs W -dist-rank r` starts W processes of the same run
over `torch.distributed` (gloo), the S sub-maps spread over them and the fern
database partitioned, every rank writing the same trajectory:

    python -m elasticfusion_tpu_torch.tools.run_slam -l seq.klg -mesh 2 \
        -dist-coordinator localhost:29500 -dist-nprocs 2 -dist-rank 0 -o r0
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="elasticfusion_tpu_torch SLAM runner")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-l", dest="log", help=".klg log file")
    src.add_argument("-tum", dest="tum", help="TUM-format dataset directory")
    p.add_argument("-cal", dest="cal", help='calibration file: one line "fx fy cx cy"')
    p.add_argument("-o", dest="out", default=None, help="output basename")
    p.add_argument("-n", dest="max_frames", type=int, default=None)
    p.add_argument("-gt", dest="groundtruth", default=None,
                   help="groundtruth.txt for ATE evaluation")
    # knobs of the original (MainController.cpp:69-94)
    p.add_argument("-c", dest="confidence", type=float, default=10.0)
    p.add_argument("-d", dest="depth_cutoff", type=float, default=3.0)
    p.add_argument("-i", dest="icp_weight", type=float, default=10.0)
    p.add_argument("-ie", dest="icp_err", type=float, default=4e-5)
    p.add_argument("-ic", dest="icp_count", type=int, default=40000)
    p.add_argument("-cv", dest="cov", type=float, default=1e-5)
    p.add_argument("-pt", dest="photo", type=float, default=115.0)
    p.add_argument("-ft", dest="fern", type=float, default=0.3095)
    p.add_argument("-t", dest="time_delta", type=int, default=200)
    p.add_argument("-s", dest="skip", type=int, default=0, help="fast-forward frames")
    p.add_argument("-fs", dest="frameskip", action="store_true",
                   help="skip frames when a frame takes >33.3ms "
                        "(MainController.cpp:249-251)")
    p.add_argument("-stats", dest="stats", default=None,
                   help="per-frame residual/inlier/timing time-series (JSONL)")
    p.add_argument("-ol", dest="open_loop", action="store_true",
                   help="open loop (no loop closures)")
    p.add_argument("-rl", dest="reloc", action="store_true")
    p.add_argument("-ftf", dest="frame_to_frame", action="store_true")
    p.add_argument("-fo", dest="fast_odom", action="store_true")
    p.add_argument("-icl", dest="iclnuim", action="store_true")
    p.add_argument("-surfels", dest="max_surfels", type=int, default=1 << 22)
    p.add_argument("-res", dest="res", default="640x480")
    p.add_argument("-device", dest="device", default="cuda",
                   help="torch device: cuda (the default; raises without a card) "
                        "or cpu (the plain PyTorch versions of the kernels)")
    # multi-process bring-up (parallel/distributed.py): every process runs
    # the same loop over the same stream; the map's sub-maps span the
    # processes and the fern DB is partitioned per process
    p.add_argument("-dist-coordinator", dest="dist_coordinator", default=None,
                   help="torch.distributed coordinator address host:port")
    p.add_argument("-dist-nprocs", dest="dist_nprocs", type=int, default=None)
    p.add_argument("-dist-rank", dest="dist_rank", type=int, default=None)
    p.add_argument("-mesh", dest="mesh", type=int, default=None,
                   help="shard the surfel map over N sub-maps")
    return p


def make_config(args):
    """The `EngineConfig` of parsed arguments (camera from `-res` / `-cal`)."""
    from ..config import CameraConfig, EngineConfig

    w, h = (int(x) for x in args.res.split("x"))
    if args.cal:
        fx, fy, cx, cy = (float(v) for v in Path(args.cal).read_text().split()[:4])
    else:
        fx = fy = 528.0 * w / 640
        cx, cy = w / 2.0, h / 2.0
    cam = CameraConfig(width=w, height=h, fx=fx, fy=fy, cx=cx, cy=cy)

    return EngineConfig(
        camera=cam,
        confidence_threshold=args.confidence,
        depth_cutoff=args.depth_cutoff,
        icp_weight=args.icp_weight,
        icp_error_threshold=args.icp_err,
        icp_count_threshold=args.icp_count,
        cov_threshold=args.cov,
        photo_threshold=args.photo,
        fern_threshold=args.fern,
        time_delta=args.time_delta,
        closeLoops=not args.open_loop,
        reloc_mode=args.reloc,
        frame_to_frame_rgb=args.frame_to_frame,
        fast_odom=args.fast_odom,
        max_surfels=args.max_surfels,
        mesh_shape=(args.mesh,) if args.mesh else None,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .._device import resolve_device
    from ..parallel.distributed import initialize_from_env

    grouped = initialize_from_env(args.dist_coordinator, args.dist_nprocs,
                                  args.dist_rank)
    try:
        return _run(args, resolve_device)
    finally:
        if grouped:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, resolve_device) -> int:
    from ..engine import Engine
    from ..io.klg import decoder_in_use, open_klg
    from ..io.trajectory import ate_rmse, read_freiburg
    from ..parallel.distributed import PartitionedFerns, world

    # "cuda" resolves like the engine's default: it raises without a card
    device = resolve_device(None if args.device == "cuda" else args.device)

    cfg = make_config(args)
    w, h = cfg.camera.width, cfg.camera.height

    if args.log:
        reader = open_klg(args.log, w, h)
        base = args.out or args.log
    else:
        from ..io.tum import TumLogReader

        reader = TumLogReader(args.tum)
        base = args.out or str(Path(args.tum) / "elasticfusion_tpu")

    if args.skip:
        reader.fast_forward(args.skip)

    # a sharded map on the default device: cuda:0..S-1 (or the rank's card)
    eng = Engine(cfg, None if cfg.mesh_shape and args.device == "cuda" else device)
    n_procs, rank = world()
    if eng.ferns is not None and n_procs > 1:
        # each process keeps the keyframes it owns; retrieval resolves ONE
        # global winner, so closure decisions are the same on every rank
        eng.ferns = PartitionedFerns(eng.ferns, n_procs, rank)
    n_done = 0
    n_skipped = 0
    stats_f = open(args.stats, "w") if args.stats else None
    t0 = time.perf_counter()
    while reader.has_more():
        if args.max_frames is not None and n_done >= args.max_frames:
            break
        f = reader.get_next()
        res = eng.process_frame(f.rgb, f.depth_mm, timestamp=f.timestamp)
        n_done += 1
        if stats_f is not None:
            sw = eng.stopwatch.timings
            stats_f.write(json.dumps({
                "tick": eng.tick, "ts": f.timestamp,
                "icp_error": res.icp_error, "icp_count": res.icp_count,
                "icp_err_thresh": cfg.icp_error_threshold,
                "icp_count_thresh": cfg.icp_count_threshold,
                "fused": res.fused, "lost": res.lost,
                "deforms": eng.deforms, "fern_deforms": eng.fern_deforms,
                "run_ms": round(sw.get("Run", 0.0), 2),
                "dispatch_ms": round(sw.get("dispatch", 0.0), 2),
                "drain_ms": round(sw.get("drain", 0.0), 2),
            }) + "\n")
        # frameskip controller (MainController.cpp:249-251): a frame that
        # overran the 33.3 ms budget drops the frames a live camera would
        # have produced in the meantime
        if args.frameskip and not res.lost:
            run_ms = eng.stopwatch.timings.get("Run", 0.0)
            if run_ms > 33.33:
                for _ in range(int(run_ms / 33.33)):
                    if not reader.has_more():
                        break
                    reader.get_next()
                    n_skipped += 1
        if n_done % 50 == 0:
            dt = time.perf_counter() - t0
            print(
                f"[{n_done}] {n_done/dt:.2f} fps, surfels={res.surfel_count}, "
                f"deforms={eng.deforms}+{eng.fern_deforms}, "
                f"ferns={len(eng.ferns.frames) if eng.ferns else 0}"
                + (" LOST" if res.lost else ""),
                flush=True,
            )
    wall = time.perf_counter() - t0
    if stats_f is not None:
        stats_f.close()

    if n_done == 0:
        print(json.dumps({"error": "no frames decoded", "frames": 0}))
        return 1

    traj = base + ".freiburg"
    eng.save_trajectory(traj, iclnuim=args.iclnuim)
    n_ply = eng.save_ply(base + ".ply")
    stats = {
        "frames": n_done,
        "frames_skipped": n_skipped,
        "fps": round(n_done / wall, 3),
        "surfels": eng.surfel_count,
        "ply_vertices": n_ply,
        "deforms": eng.deforms,
        "fern_deforms": eng.fern_deforms,
        "fern_keyframes": len(eng.ferns.frames) if eng.ferns else 0,
        "trajectory": traj,
    }
    if args.log:
        stats["klg_decoder"] = decoder_in_use()
    if cfg.mesh_shape is not None:
        stats["mesh"] = list(cfg.mesh_shape)
        stats["processes"] = n_procs

    if args.groundtruth:
        from ..io.tum import read_groundtruth

        gt = read_groundtruth(Path(args.groundtruth).parent)
        est = read_freiburg(traj)
        try:
            stats["ate_rmse_m"] = round(ate_rmse(gt, est), 5)
        except ValueError as e:
            stats["ate_error"] = str(e)

    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
