"""Run by hand, not collected: how many SO(3) and Gauss-Newton iterations
the frame's own tracking ran on every frame of chip_smoke.py's 640x480
sweep (phase 4's configuration), per pyramid level, through
`Engine.process_frame` of the port in the tree given, with its final pose.

    python tests/exit_iterations.py run <tree> <device> <out.json>
    python tests/exit_iterations.py compare <a.json> <b.json>

`run` imports `elasticfusion_tpu_torch` from <tree>.  An iteration counts
when it ran: in a tracker whose loops are predicated launches
(`so3_update` / `gn_update`) those whose `active` flag was set when the
update was called (read with a sync), counted in an eager `_frame_main` on
a copy of the state and inputs each frame gets (the engine's own frame may
be a replayed CUDA graph, which calls no Python); in a tracker that reads
each iteration back, those reads.  `compare` prints the
frames and levels whose counts differ and the largest pose gap."""

import json
import sys


def run(tree: str, device: str, out_path: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from elasticfusion_tpu_torch import engine, tracking
    from elasticfusion_tpu_torch.config import CameraConfig, EngineConfig
    from elasticfusion_tpu_torch.utils.synthetic import (
        make_scene,
        pose_from_xyzrpy,
        render_frame,
    )

    cam = CameraConfig()
    cfg = EngineConfig(camera=cam, closeLoops=False, pipeline_depth=0,
                       initial_surfels=1 << 19, max_surfels=1 << 21,
                       confidence_threshold=0.3)
    state = dict(in_track=False, level=None, so3=0, gn=[0, 0, 0])
    heights = {cam.height >> lvl: lvl for lvl in range(3)}

    real_track, real_icp = engine._track, tracking.icp_step

    def track(*a, **k):
        state["in_track"] = True
        try:
            return real_track(*a, **k)
        finally:
            state["in_track"] = False

    def icp(*a, **k):
        state["level"] = heights[a[1].shape[1]]
        return real_icp(*a, **k)

    engine._track, tracking.icp_step = track, icp
    if hasattr(tracking, "gn_update"):
        real_gn, real_so3 = tracking.gn_update, tracking.so3_update

        def gn(stage, pack, carry, active, *a, **k):
            if state["in_track"] and stage == 1 and int(active) != 0:
                state["gn"][state["level"]] += 1
            return real_gn(stage, pack, carry, active, *a, **k)

        def so3(stage, pack, carry, active, *a, **k):
            if state["in_track"] and stage == 1 and int(active) != 0:
                state["so3"] += 1
            return real_so3(stage, pack, carry, active, *a, **k)
        tracking.gn_update, tracking.so3_update = gn, so3
    else:
        real_read = tracking.read_back

        def read(t):
            if state["in_track"] and t.numel() == 14:
                state["so3"] += 1
            elif state["in_track"] and t.numel() == 88:
                state["gn"][state["level"]] += 1
            return real_read(t)
        tracking.read_back = read

    def eager_frame(eng, d, r):
        """The frame `eng` is about to run, eagerly, on copies of its state."""
        def clone(x):
            ts = [t.clone() for t in x]
            return type(x)(*ts) if hasattr(x, "_fields") else tuple(ts)

        f32 = dict(dtype=torch.float32, device=eng.device)
        tick = torch.full((), float(eng.tick), **f32)
        pred = clone(eng._pred)
        engine._frame_main(
            clone(eng.map), eng._T_f32.clone(), eng._so3_hist.clone(),
            pred.vertex, pred.normal, pred.image, *clone(eng._fill),
            eng._dense_dev.clone(),
            torch.from_numpy(d.astype(np.float32)).to(eng.device),
            torch.from_numpy(r).to(eng.device), tick, tick, eng.lost,
            torch.full((), 1.0, **f32), None, cfg,
            do_compact=eng.tick % cfg.compact_every == 0)

    scene = make_scene(n_side=1400)
    eng = engine.Engine(cfg, device=device)
    replayed = getattr(eng, "runner", None) is not None
    rows = []
    for i in range(36):
        T = pose_from_xyzrpy(x=0.008 * i, yaw=0.003 * i, z=0.002 * i)
        d, r = render_frame(scene[0], scene[1], T, cam)
        state.update(so3=0, gn=[0, 0, 0])
        if replayed and i > 0:
            eager_frame(eng, d, r)
            counted = dict(so3=state["so3"], gn=list(state["gn"]))
            engine._track = real_track
            res = eng.process_frame(r, d, timestamp=i)
            engine._track = track
            state.update(counted)
        else:
            res = eng.process_frame(r, d, timestamp=i)
        rows.append(dict(frame=i, so3=state["so3"], gn=list(state["gn"]),
                         T=np.asarray(res.T_wc).tolist()))
    if device != "cpu":
        torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump(rows, f)
    so3 = sum(r["so3"] for r in rows[1:]) / (len(rows) - 1)
    gn = sum(sum(r["gn"]) for r in rows[1:]) / (len(rows) - 1)
    print(f"exit_iterations {tree}: SO(3) {so3:.2f}, Gauss-Newton {gn:.2f} a tracked "
          f"frame")


def compare(a_path: str, b_path: str) -> None:
    import numpy as np

    a, b = (json.load(open(p)) for p in (a_path, b_path))
    differ = [(x["frame"], x["so3"], y["so3"], x["gn"], y["gn"]) for x, y in zip(a, b)
              if x["so3"] != y["so3"] or x["gn"] != y["gn"]]
    gap = max(float(np.linalg.norm(np.asarray(x["T"])[:3, 3] - np.asarray(y["T"])[:3, 3]))
              for x, y in zip(a, b))
    rot = max(float(np.abs(np.asarray(x["T"])[:3, :3] - np.asarray(y["T"])[:3, :3]).max())
              for x, y in zip(a, b))
    print(f"exit_iterations_compare: {len(a)} frames, {len(differ)} with other iteration "
          f"counts (frame, SO(3) a, b, GN per level 2/1/0 a, b): {differ}; largest pose "
          f"gap {gap * 1e3:.4f} mm, rotation entry {rot:.2e}")


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(*sys.argv[2:5])
    else:
        compare(*sys.argv[2:4])
