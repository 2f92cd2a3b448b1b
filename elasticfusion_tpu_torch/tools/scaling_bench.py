"""Map-axis scaling measurement + collective inventory of the sharded surfel
map (the reference package's `tools/scaling_bench.py`).

Runs the per-frame program (`engine.slam_step`) on a map of 1 and of N
sub-maps (`parallel/shard_step.py`) at a fixed map capacity, reports the
ms per step, the speedup and efficiency of N sub-maps against one, and the
collectives of a step, read from the `MapGroup` that reduces over the
sub-maps (`calls`; MIN, SUM and MERGE are the reference's `all-reduce`,
ALL-GATHER its `all-gather`).

The reference's `gspmd` leg measures XLA's automatic partitioner, which
inserts its own collectives; PyTorch has no counterpart, so that leg reports
the one-device `slam_step` on the unsharded map under "1" and null for N
sub-maps.  `-crossover` measures per-surfel work at the >= 4M-surfel regime
on a synthetic in-frustum map at 64x48, as the reference does.

The sub-maps sit on `cuda:0 .. cuda:N-1` (raises when fewer cards are
visible), or all on `-device` when it names one (`-device cuda:0` puts N
sub-maps on one card, where N > 1 measures the sub-map overhead, not a
speedup; `-device cpu` runs the plain PyTorch versions of the kernels).

Usage:
    python -m elasticfusion_tpu_torch.tools.scaling_bench [-n 8] [-cap 20]
        [-frames 5] [-device cuda:0]
    python -m elasticfusion_tpu_torch.tools.scaling_bench -crossover [-n 8]
        [-cap 22] [-fill 0.9] [-frames 3] [-device cuda:0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

# the reference's collective names of the group's calls
COLLECTIVE_NAMES = {"min": "all-reduce", "sum": "all-reduce", "merge": "all-reduce",
                    "all_gather": "all-gather"}


class Leg(NamedTuple):
    """One leg of a measurement: its final map, the pose of every timed
    step, the group's calls over the timed steps, and its times."""

    map: object                     # SurfelMap or ShardedMap
    poses: List[np.ndarray]
    calls: Dict[str, int]
    steps: int
    wall_ms_per_step: float
    cpu_s_per_step: float


def _devices(device: str, n: int) -> List[torch.device]:
    """`cuda` (the default): the first n cards, raising without a card; any
    other device: n times that one."""
    from .._device import resolve_device
    from ..parallel.sharding import make_mesh

    if device == "cuda":
        resolve_device(None)
        return make_mesh(n)
    return [resolve_device(device)] * n


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_args(cam, lead, depth_mm, rgb, i):
    """The reference's step inputs: identity pose, no previous prediction,
    the same frame every step at tick 2 + i."""
    H, W = cam.height, cam.width
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=lead)  # noqa: E731
    return (torch.eye(4, dtype=torch.float32, device=lead), z(H >> 2, W >> 2),
            z(3, H, W), z(3, H, W), z(H, W, 3), depth_mm, rgb,
            torch.tensor(2.0 + i, device=lead), torch.tensor(1.0, device=lead))


def run_leg(step, start, frames: int, cam, lead, depth_mm, rgb, group=None) -> Leg:
    """One warm step on `start()`, then `frames` timed steps from a fresh
    `start()`; `group.calls` counts the timed steps' collectives."""
    from .._device import read_back

    step(start(), *_step_args(cam, lead, depth_mm, rgb, 0))
    m = start()
    _sync(lead)
    if group is not None:
        group.calls.clear()
    poses = []
    t0, c0 = time.perf_counter(), os.times()
    for i in range(frames):
        out = step(m, *_step_args(cam, lead, depth_mm, rgb, i))
        m = out[0]
        poses.append(out[1])
    _sync(lead)
    wall = (time.perf_counter() - t0) / frames * 1e3
    ct = os.times()
    cpu = ((ct.user - c0.user) + (ct.system - c0.system)) / frames
    return Leg(map=m, poses=[read_back(T) for T in poses],
               calls=dict(group.calls) if group is not None else {},
               steps=frames, wall_ms_per_step=wall, cpu_s_per_step=cpu)


def collectives_per_step(leg: Leg) -> Dict[str, float]:
    """The leg's collectives per step under the reference's names."""
    out: Dict[str, float] = {}
    for k, v in leg.calls.items():
        name = COLLECTIVE_NAMES[k]
        out[name] = out.get(name, 0.0) + v / leg.steps
    return out


def _backend(lead: torch.device) -> dict:
    name = torch.cuda.get_device_name(lead) if lead.type == "cuda" else "cpu"
    return {"backend": lead.type, "device": name}


def bench(n_devices: int = 8, cap_log2: int = 20, frames: int = 5,
          device: str = "cuda"):
    """The reference's `main`: 320x240, the first frame of the synthetic
    scene as the map.  Returns (the JSON object, the legs: "one_device" and
    the sub-map counts 1 and n)."""
    from ..config import CameraConfig, EngineConfig
    from ..engine import slam_step
    from ..ops.preprocess import metricise_depth
    from ..parallel.shard_step import make_shardmap_step, shard_empty_map
    from ..parallel.sharding import MapGroup
    from ..surfels import init_map_from_frame
    from ..utils.synthetic import make_scene, render_frame

    w, h = 320, 240
    cam = CameraConfig(width=w, height=h, fx=264.0, fy=264.0, cx=160.0, cy=120.0)
    cfg = EngineConfig(camera=cam, max_surfels=1 << cap_log2,
                       confidence_threshold=0.3)
    lead = _devices(device, 1)[0]
    scene = make_scene(n_side=900)
    depth_np, rgb_np = render_frame(scene[0], scene[1], np.eye(4), cam)
    depth_mm = torch.from_numpy(depth_np.astype(np.float32)).to(lead)
    rgb = torch.from_numpy(np.ascontiguousarray(rgb_np)).to(lead)
    raw = metricise_depth(depth_mm, cfg.depth_cutoff)
    m0 = init_map_from_frame(cfg.max_surfels, raw, raw, rgb, cam, cfg.depth_cutoff)

    def one_device_map():
        return m0._replace(**{f: getattr(m0, f).clone() for f in m0._fields})

    legs = {"one_device": run_leg(lambda m, *a: slam_step(m, *a, cfg), one_device_map,
                                  frames, cam, lead, depth_mm, rgb)}
    for n in sorted({1, n_devices}):
        group = MapGroup(_devices(device, n))
        legs[n] = run_leg(make_shardmap_step(cfg),
                          lambda: shard_empty_map(cfg.max_surfels, group, first=m0),
                          frames, cam, lead, depth_mm, rgb, group)

    n = n_devices
    sm_ms = {str(k): legs[k].wall_ms_per_step for k in sorted({1, n})}
    sm_speedup = sm_ms["1"] / sm_ms[str(n)]
    out = {
        **_backend(lead),
        "capacity": 1 << cap_log2,
        "gspmd": {
            "ms_per_step": {"1": legs["one_device"].wall_ms_per_step, str(n): None},
            "speedup": None,
            "efficiency": None,
            "collectives": {"1": {}, str(n): None},
            "note": ("XLA's automatic partitioner has no PyTorch counterpart: "
                     "\"1\" is the one-device slam_step on the unsharded map, "
                     "the N-way leg is not run"),
        },
        "shard_map": {
            "ms_per_step": sm_ms,
            "speedup": sm_speedup,
            "efficiency": sm_speedup / n,
            "collectives": {str(k): collectives_per_step(legs[k]) for k in sorted({1, n})},
            "calls": {str(k): legs[k].calls for k in sorted({1, n})},
            "steps": frames,
        },
    }
    return out, legs


def synthetic_map(cap: int, fill: float, cam, dev):
    """The reference's crossover map: `fill * cap` live surfels spread
    uniformly over the camera's frustum at 0.8-3 m, facing it
    (`numpy.random.default_rng(0)`)."""
    from ..surfels import empty_map

    w, h = cam.width, cam.height
    rng = np.random.default_rng(0)
    n_live = int(cap * fill)
    z = rng.uniform(0.8, 3.0, n_live).astype(np.float32)
    u = rng.uniform(0, w, n_live).astype(np.float32)
    v = rng.uniform(0, h, n_live).astype(np.float32)
    pos = np.zeros((3, cap), np.float32)
    pos[0, :n_live] = (u - cam.cx) * z / cam.fx
    pos[1, :n_live] = (v - cam.cy) * z / cam.fy
    pos[2, :n_live] = z
    nrm = np.zeros((3, cap), np.float32)
    nrm[2, :n_live] = -1.0
    live = (np.arange(cap) < n_live).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return empty_map(cap, dev)._replace(
        pos=t(pos), normal=t(nrm), conf=t(live), radius=t(live * np.float32(0.01)),
        last_t=t(live), init_t=t(live),
        count=torch.tensor(n_live, dtype=torch.int32, device=dev)), n_live


def crossover_bench(n_devices: int = 8, cap_log2: int = 22, fill: float = 0.9,
                    frames: int = 3, device: str = "cuda"):
    """The reference's `-crossover`: a 64x48 camera, so the step is almost
    all per-surfel map work, over a synthetic map `fill` full, distributed
    round-robin over 1 and N sub-maps.  Returns (the JSON object, the legs)."""
    from ..config import CameraConfig, EngineConfig
    from ..parallel.shard_step import distribute_map, make_shardmap_step
    from ..parallel.sharding import MapGroup
    from ..utils.synthetic import make_scene, render_frame

    w, h = 64, 48
    cam = CameraConfig(width=w, height=h, fx=52.8, fy=52.8, cx=32.0, cy=24.0)
    cap = 1 << cap_log2
    cfg = EngineConfig(camera=cam, max_surfels=cap, confidence_threshold=0.3)
    lead = _devices(device, 1)[0]
    scene = make_scene(n_side=160)
    depth_np, rgb_np = render_frame(scene[0], scene[1], np.eye(4), cam)
    depth_mm = torch.from_numpy(depth_np.astype(np.float32)).to(lead)
    rgb = torch.from_numpy(np.ascontiguousarray(rgb_np)).to(lead)
    m0, n_live = synthetic_map(cap, fill, cam, lead)

    out = {"capacity": cap, "live": n_live, "camera": f"{w}x{h}",
           **_backend(lead), "results": {}}
    legs = {}
    for n in sorted({1, n_devices}):
        group = MapGroup(_devices(device, n))
        legs[n] = leg = run_leg(make_shardmap_step(cfg), lambda: distribute_map(m0, group),
                                frames, cam, lead, depth_mm, rgb, group)
        out["results"][str(n)] = {
            "wall_ms_per_step": leg.wall_ms_per_step,
            "cpu_s_per_step": leg.cpu_s_per_step,
            # the reference's arithmetic (CPU seconds per million live
            # surfels, times 1e3), kept so that the two JSONs compare
            "cpu_us_per_Msurfel": leg.cpu_s_per_step / (n_live / 1e6) * 1e6 / 1e3,
            "collectives": collectives_per_step(leg),
        }
    r1, rN = out["results"]["1"], out["results"][str(n_devices)]
    out["work_ratio_Nway_vs_1"] = rN["cpu_s_per_step"] / max(r1["cpu_s_per_step"], 1e-9)
    return out, legs


def _parser(crossover: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-n", dest="n_devices", type=int, default=8)
    p.add_argument("-cap", dest="cap_log2", type=int, default=22 if crossover else 20,
                   help="log2 surfel capacity (default 2^%d)" % (22 if crossover else 20))
    if crossover:
        p.add_argument("-fill", type=float, default=0.9,
                       help="live fraction of capacity to fill")
    p.add_argument("-frames", type=int, default=3 if crossover else 5)
    p.add_argument("-device", dest="device", default="cuda",
                   help="cuda (the default: sub-maps on cuda:0..N-1; raises without "
                        "a card), or one device for every sub-map (cuda:0, cpu)")
    return p


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "-crossover":
        args = _parser(True).parse_args(argv[1:])
        out, _ = crossover_bench(args.n_devices, args.cap_log2, args.fill,
                                 args.frames, args.device)
    else:
        args = _parser(False).parse_args(argv)
        out, _ = bench(args.n_devices, args.cap_log2, args.frames, args.device)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
