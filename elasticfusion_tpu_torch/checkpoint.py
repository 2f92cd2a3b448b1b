"""Map/engine checkpointing (the reference package's `checkpoint.py`, same
npz schema and `FORMAT_VERSION`, so a checkpoint written by either package
loads in the other).  All engine state is plain arrays (surfel SoA, pose
log, fern DB, deformation carry state), so a checkpoint is one compressed
npz; restore rebuilds a running `Engine` mid-sequence, whose first frame
regenerates the carried prediction from the restored map."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ._device import DeviceLike
from .config import EngineConfig

FORMAT_VERSION = 1


def save_checkpoint(path: str | Path, engine) -> None:
    """Write `engine`'s state (flushes the frame pipeline first; the map is
    read to the host once)."""
    from .io.ply import map_to_host

    m = engine.export_map()
    data = {
        "version": FORMAT_VERSION,
        "tick": engine.tick,
        "T_wc": engine.T_wc,
        "lost": engine.lost,
        "tracking_count": engine.tracking_count,
        "deforms": engine.deforms,
        "fern_deforms": engine.fern_deforms,
        "pose_ticks": np.array([t for t, _ in engine.tick_poses], np.int64),
        "pose_mats": np.stack([T for _, T in engine.tick_poses])
        if engine.tick_poses else np.zeros((0, 4, 4)),
        "pose_times": np.array(engine.pose_times, np.int64),
    }
    if m is not None:
        pos, conf, color, init_t, last_t, normal, radius = map_to_host(m)
        data.update(
            map_count=conf.shape[0], map_capacity=m.capacity,
            map_pos=pos, map_conf=conf, map_color=color, map_init_t=init_t,
            map_last_t=last_t, map_normal=normal, map_radius=radius,
        )
    f = engine.ferns
    if f is not None and f.frames:
        data.update(
            fern_codes=np.stack([fr.codes for fr in f.frames]),
            fern_good=np.array([fr.good_codes for fr in f.frames], np.int64),
            fern_poses=np.stack([fr.T_wc for fr in f.frames]),
            fern_times=np.array([fr.src_time for fr in f.frames], np.int64),
            fern_rgb=np.stack([fr.rgb for fr in f.frames]),
            fern_verts=np.stack([fr.verts for fr in f.frames]),
            fern_norms=np.stack([fr.norms for fr in f.frames]),
        )
    # loop-closure carry state (EF.cpp:529-531): the downsampled relative
    # constraints fed into future global deformations, plus each
    # deformation's incremental-activation clock
    if engine.relative_cons:
        rc = engine.relative_cons
        data.update(
            rel_src=np.stack([c.src for c in rc]),
            rel_target=np.stack([c.target for c in rc]),
            rel_src_time=np.array([c.src_time for c in rc], np.int64),
            rel_target_time=np.array([c.target_time for c in rc], np.int64),
        )
    if engine.local_deformation is not None:
        data.update(
            local_last_deform=engine.local_deformation.last_deform_time,
            local_deforms=engine.local_deformation.deforms,
            global_last_deform=engine.global_deformation.last_deform_time,
            global_deforms=engine.global_deformation.deforms,
        )
    np.savez_compressed(path, **data)


def load_checkpoint(path: str | Path, cfg: Optional[EngineConfig] = None,
                    device: DeviceLike = None):
    """Rebuild an `Engine` from a checkpoint, on the card unless `device`
    names something else.  `cfg` must match the sensor geometry the
    checkpoint was recorded with.  Restored capacity: the next bucket of
    twice the live count, rounded up to a multiple of the shards when
    `cfg.mesh_shape` is set (the map is saved as one one-device map at any
    S, and the first frame redistributes it over the engine's shards)."""
    from .convert import load_fern_db
    from .deformation import HostConstraint
    from .engine import Engine, _next_bucket
    from .surfels import empty_map

    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])} unsupported")
    cfg = cfg or EngineConfig()
    eng = Engine(cfg, device)
    eng.tick = int(z["tick"])
    eng.T_wc = np.asarray(z["T_wc"])
    eng.lost = bool(z["lost"])
    eng.tracking_count = int(z["tracking_count"])
    eng.deforms = int(z["deforms"])
    eng.fern_deforms = int(z["fern_deforms"])
    eng.tick_poses = [(int(t), T) for t, T in zip(z["pose_ticks"], z["pose_mats"])]
    eng.pose_times = [int(t) for t in z["pose_times"]]

    if "map_count" in z:
        n = int(z["map_count"])
        cap = _next_bucket(2 * n, max(cfg.max_surfels, 2 * n))
        if cfg.mesh_shape is not None:
            S = math.prod(cfg.mesh_shape)
            cap = -(-cap // S) * S
        m = empty_map(cap, eng.device)
        for f in ("pos", "conf", "color", "init_t", "last_t", "normal", "radius"):
            getattr(m, f)[..., :n] = torch.from_numpy(
                np.asarray(z["map_" + f], np.float32)).to(eng.device)
        m.count.fill_(n)
        eng._adopt_map(m, n)
    if "fern_codes" in z and eng.ferns is not None:
        load_fern_db(eng.ferns, (
            dict(codes=z["fern_codes"][i], good_codes=z["fern_good"][i],
                 T_wc=z["fern_poses"][i], src_time=z["fern_times"][i],
                 rgb=z["fern_rgb"][i], verts=z["fern_verts"][i],
                 norms=z["fern_norms"][i])
            for i in range(len(z["fern_times"]))))
    if "rel_src" in z:
        eng.relative_cons = [
            HostConstraint(s, t, st, tt, relative=True)
            for s, t, st, tt in zip(z["rel_src"], z["rel_target"],
                                    z["rel_src_time"], z["rel_target_time"])
        ]
    if "local_last_deform" in z and eng.local_deformation is not None:
        eng.local_deformation.last_deform_time = int(z["local_last_deform"])
        eng.local_deformation.deforms = int(z["local_deforms"])
        eng.global_deformation.last_deform_time = int(z["global_last_deform"])
        eng.global_deformation.deforms = int(z["global_deforms"])
    return eng
