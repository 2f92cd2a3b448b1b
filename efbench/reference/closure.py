"""The reference of a loop closure, from the program's state at the closure.

`solve` is the deformation graph's solve (`Deformation::constrain`) on a
graph sample and a constraint set handed over as plain arrays; `repair` is
the closure's map repair (ElasticFusion.cpp:410-534 with clean's graph
application, copy_unstable.vert:132-321): the surfels older than the
closure frame deformed through the solved graph, the newer ones moved by
the rigid correction, last-seen times refreshed against the synthesized
inactive depth (local closures), the map re-cleaned and the carried
prediction regenerated at the corrected pose.  Written after the port's
`engine._deform`, `_refresh_last_seen` and `_apply_closure` (one device).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from .config import EngineConfig
from .deformation import Deformation, GraphState, HostConstraint, apply_graph_to_surfels
from .frame import Carried, _ident, _tree, predict
from .fuse import clean
from .splat import combined_predict, predict_indices
from .surfels import SurfelMap


def solve(graph: GraphState, constraints: List[dict], last_deform_time: int,
          cfg: EngineConfig, kw: dict, device):
    """(accepted, new fern poses, new pose history, solved graph) of
    `constrain` with the keyword arguments `kw`."""
    d = Deformation(node_capacity=cfg.max_deformation_nodes,
                    sample_rate=cfg.def_graph_sample_rate, device=device)
    d.graph = GraphState(*(x.to(device) for x in graph))
    d._stale = False
    d.last_deform_time = last_deform_time
    d.constraints = [HostConstraint(c["src"], c["target"], c["src_time"], c["target_time"],
                                    c["relative"], c["pin"]) for c in constraints]
    ok, fern_poses, history, _ = d.constrain(**kw)
    return ok, fern_poses, history, d.graph


def _deform(m: SurfelMap, graph: GraphState, T_fix, closure_tick: float):
    deformed_pos, deformed_nrm = apply_graph_to_surfels(m, graph)
    recent = m.init_t >= closure_tick
    Rf, tf = T_fix[:3, :3], T_fix[:3, 3]
    new_pos = torch.where(recent[None], Rf @ m.pos + tf[:, None], deformed_pos)
    new_nrm = torch.where(recent[None], Rf @ m.normal, deformed_nrm)
    return m._replace(pos=new_pos, normal=new_nrm), recent


def _refresh_last_seen(m1: SurfelMap, recent, depth_synth, T_new, tick_now: float,
                       cfg: EngineConfig) -> SurfelMap:
    cam = cfg.camera
    H, W = cam.height, cam.width
    t = T_new[:3, 3]
    lp2 = T_new[:3, :3].T @ (m1.pos - t[:, None])
    sz = torch.where(torch.abs(lp2[2]) > 1e-12, lp2[2], torch.ones_like(lp2[2]))
    x2 = lp2[0] * cam.fx / sz + cam.cx
    y2 = lp2[1] * cam.fy / sz + cam.cy
    inb = ((lp2[2] > 0) & (lp2[2] < cfg.max_depth_processed)
           & (x2 > 0) & (y2 > 0) & (x2 < W) & (y2 < H))
    flat = (torch.clamp(y2.to(torch.int32), 0, H - 1).to(torch.int64) * W
            + torch.clamp(x2.to(torch.int32), 0, W - 1))
    d = depth_synth.reshape(-1)[flat]
    refresh = ((m1.conf > cfg.confidence_threshold) & ~recent & inb
               & (d > 0) & (lp2[2] < d + 0.1))
    return m1._replace(last_t=torch.where(
        refresh, torch.full_like(m1.last_t, tick_now), m1.last_t))


def repair(m: SurfelMap, graph: GraphState, T_fix, closure_tick: float, T_new,
           tick_now: float, max_time: float, filt_m, rgb, cfg: EngineConfig,
           fern_accepted: bool, so3, q: Callable = _ident) -> Carried:
    """The carried state after the closure's repair (`so3` passes through)."""
    cam = cfg.camera
    depth_synth = None
    if not fern_accepted:
        depth_synth = combined_predict(
            m, T_new, cam, tick_now, tick_now - cfg.time_delta, 65535,
            cfg.confidence_threshold, cfg.max_depth_processed).depth
    m1, recent = _deform(m, graph, T_fix, closure_tick)
    if depth_synth is not None:
        m1 = _refresh_last_seen(m1, recent, depth_synth, T_new, tick_now, cfg)
    m1 = _tree(q, m1)
    pidx = predict_indices(m1, T_new, cam, tick_now, cfg.time_delta, cfg.max_depth_processed)
    m2 = _tree(q, clean(m1, pidx, T_new, tick_now, cam, cfg.confidence_threshold,
                        cfg.time_delta, cfg.max_depth_processed, cfg.unstable_age,
                        do_compact=True, fx16_patch=False))
    pred, fill, dense = _tree(q, predict(m2, T_new, tick_now, max_time, filt_m, rgb, cfg))
    return Carried(m2, T_new, so3, pred.vertex, pred.normal, pred.image, *fill, dense)


def rigid_fix(T_target: np.ndarray, T_wc: np.ndarray, T_carried: torch.Tensor):
    """(T_fix f32, T_new = T_fix @ carried pose) of a closure that takes the
    host pose `T_wc` to `T_target` (both float64)."""
    T_fix = T_target @ np.linalg.inv(T_wc)
    T_fix32 = torch.from_numpy(T_fix.astype(np.float32)).to(T_carried.device)
    return T_fix32, T_fix32 @ T_carried
