"""What decides `correct`: frames of the window recomputed by the plain
reference (`efbench/reference`) and compared with what the program produced.

A SLAM frame's answer depends on the whole history before it, and two
float32 programs that round differently part ways over hundreds of frames
(a surfel fused or not, a compaction shifted).  So the check follows the
program step by step: for each sampled frame it takes the carried state the
program handed that frame (map, pose, SO(3) history, prediction and its
fill-in, coverage) and the frame's raw input, copied on the device's stream
right before the frame ran, and the state the frame left, copied right
after it; after the window the reference computes the frame from the same
state and input.  The start is checked by itself: the program's state after
the first frame against the reference's map made from that frame.

Numbers compared (the worst over the sampled frames and the start):

- `pose_mm`: distance between the program's and the reference's camera
  positions after tracking, in mm;
- `rot_mdeg`: angle between their rotations, in millidegrees;
- `pred_px`: share of pixels of the end-of-frame prediction or of its
  fill-in (the next frame's tracking target, made from the map after fuse
  and clean) whose depth differs by more than 1 mm or is valid on one side
  only;
- `count_rel`: relative difference of the live surfel counts.

Loop closures of the window are checked the same way, from the program's
state at the closure (reservoirs of solves and of repairs, drawn from the
seed): each `constrain` is solved again by the reference from the graph
sample and the constraint set the program handed it (the nodes'
translations and the poses it moves count in `pose_mm`, the nodes' rotation
entries, in radians, and the moved poses' rotations in `rot_mdeg`; where the
two disagree on accepting the solve `pose_mm` reads `DISAGREE`), and each
repair is recomputed from the map,
pose and latest frame before it and the program's solved graph (the state
after it counts in `pose_mm`, `rot_mdeg`, `pred_px` and `count_rel`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .reference import closure as ref_closure
from .reference import frame as ref_frame
from .reference.surfels import SurfelMap as RefMap

# the limit of each number compared, set between the largest reading of
# sound runs (48 seeds on an H100, trial traffics included) and the smallest
# of the bfloat16 control (15 runs); PERF.md gives the readings
LIMITS: Dict[str, float] = {
    "pose_mm": 0.05,      # sound <= 0.00595, control >= 1.40
    "rot_mdeg": 2.0,      # sound <= 0.150, control >= 29.7
    "pred_px": 1e-3,      # sound <= 2.28e-5, control >= 0.82
    "count_rel": 1e-3,    # sound <= 5.3e-6, control >= 0.095
}
DISAGREE = 1e6    # pose_mm where the program and the reference decide otherwise

_MAP_FIELDS = ("pos", "conf", "color", "init_t", "last_t", "normal", "radius", "count")


def _clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone_tree(v) for v in x)
    return x


def snapshot_state(S: dict) -> dict:
    """Copies, on the stream, of a `FrameRunner`'s static tensors: the
    carried state and (when present) the frame's inputs."""
    keys = ("map", "T", "so3", "pred", "fill", "dense", "depth", "rgb", "tick",
            "max_time", "weight")
    return {k: _clone_tree(S[k]) for k in keys if k in S}


def _ref_map(m, device) -> RefMap:
    return RefMap(*(getattr(m, f).to(device) for f in _MAP_FIELDS))


def carried_of(state: dict, device) -> ref_frame.Carried:
    """The reference's carried state from a program snapshot."""
    p, f = state["pred"], state["fill"]
    return ref_frame.Carried(
        map=_ref_map(state["map"], device), T=state["T"].to(device),
        so3=state["so3"].to(device), pred_vertex=p.vertex.to(device),
        pred_normal=p.normal.to(device), pred_image=p.image.to(device),
        fill_vertex=f[0].to(device), fill_normal=f[1].to(device),
        fill_image=f[2].to(device), dense=state["dense"].to(device))


def _depth_gap_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels whose z differs by > 1 mm or is valid on one side."""
    za, zb = a[2].float(), b[2].float()
    va, vb = za > 0, zb > 0
    bad = (va != vb) | (va & vb & ((za - zb).abs() > 1e-3))
    return float(bad.float().mean())


def compare(prog: ref_frame.Carried, ref: ref_frame.Carried) -> Dict[str, float]:
    """The numbers compared, of one frame."""
    Tp = prog.T.double().cpu()
    Tr = ref.T.double().cpu()
    dt = float(torch.linalg.vector_norm(Tp[:3, 3] - Tr[:3, 3])) * 1e3
    R = Tp[:3, :3].T @ Tr[:3, :3]
    # the angle from both the skew part and the trace: steady where the two
    # rotations agree to rounding and are not exactly orthonormal
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ang = math.degrees(math.atan2(float(torch.linalg.vector_norm(w)) / 2.0,
                                  (float(torch.trace(R)) - 1.0) / 2.0)) * 1e3
    px = max(_depth_gap_share(prog.pred_vertex.cpu(), ref.pred_vertex.cpu()),
             _depth_gap_share(prog.fill_vertex.cpu(), ref.fill_vertex.cpu()))
    cp, cr = int(prog.map.count), int(ref.map.count)
    return dict(pose_mm=dt, rot_mdeg=ang, pred_px=px,
                count_rel=abs(cp - cr) / max(cr, 1))


def _pose_gap(Tp: np.ndarray, Tr: np.ndarray):
    """(mm, millidegrees) between two poses."""
    dt = float(np.linalg.norm(Tp[:3, 3] - Tr[:3, 3])) * 1e3
    R = Tp[:3, :3].T @ Tr[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return dt, math.degrees(math.atan2(np.linalg.norm(w) / 2.0,
                                       (np.trace(R) - 1.0) / 2.0)) * 1e3


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in LIMITS}


class Sampler:
    """Which window events (frames, closure solves, closure repairs) are
    checked: a reservoir of `k` of them, uniform over all the window's
    events of the kind, drawn from the seed.  Each kept event holds its
    before and after snapshots."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.kept: List[dict] = []
        self._seen = 0
        self._slot: Optional[int] = None

    def wants(self) -> bool:
        """Decide for the next window frame; True when it is to be kept."""
        i = self._seen
        self._seen += 1
        if i < self.k:
            self._slot = i
            self.kept.append({})
            return True
        j = int(self.rng.integers(0, i + 1))
        self._slot = j if j < self.k else None
        if self._slot is not None:
            self.kept[j] = {}
        return self._slot is not None

    def drop(self) -> None:
        """The event just chosen has nothing to check."""
        self.kept[self._slot] = {}

    def record(self, key: str, value) -> None:
        self.kept[self._slot][key] = value

    def complete(self) -> List[dict]:
        return [s for s in self.kept if "after" in s]


class Reference:
    """The reference's computations of a frame, a solve and a repair; the
    control (`test_efbench_control.py`) computes the same in a lower
    precision and stands in for the program."""

    def __init__(self, q: Callable = ref_frame._ident):
        self.q = q

    def frame(self, c, args):
        return ref_frame.frame(c, *args, q=self.q)

    def solve(self, graph, constraints, last_deform_time, cfg, kw, device):
        ok, poses, hist, g = ref_closure.solve(graph, constraints, last_deform_time,
                                               cfg, kw, device)
        return ok, poses, hist, ref_frame._tree(self.q, g)

    def repair(self, *args, **kw):
        return ref_closure.repair(*args, q=self.q, **kw)


def check_frames(samples: List[dict], cfg, device,
                 control: Optional[Reference] = None) -> List[Dict[str, float]]:
    """Recompute each sampled frame with the reference on `device` and
    compare.  `control` stands in for the program's after-state."""
    ref_of = Reference()
    rows = []
    for s in samples:
        before, after, key = s["before"], s["after"], s["key"]
        c = carried_of(before, device)
        args = (before["depth"].to(device), before["rgb"].to(device),
                before["tick"].to(device), before["max_time"].to(device),
                before["weight"].to(device), bool(key["do_compact"]), cfg)
        ref = ref_of.frame(c, args)
        prog = control.frame(c, args) if control is not None else carried_of(after, device)
        rows.append(compare(prog, ref))
        del ref, prog, c
    return rows


def _graph_gap(a, b):
    """(largest node translation gap in mm, largest rotation entry gap in
    millidegrees) of two solved graphs."""
    n = int(a.n_nodes)
    if n != int(b.n_nodes):
        return DISAGREE, 0.0
    dR = float((a.R[:n].cpu() - b.R[:n].cpu()).abs().max())
    dt = float((a.t[:n].cpu() - b.t[:n].cpu()).abs().max())
    return dt * 1e3, math.degrees(dR) * 1e3


def check_solves(samples: List[dict], cfg, device,
                 control: Optional[Reference] = None) -> List[Dict[str, float]]:
    """Each sampled `constrain` solved again from the program's graph sample
    and constraints; the accept decision, the solved nodes and the moved
    poses compared."""
    ref_of = Reference()
    rows = []
    for s in samples:
        b, a = s["before"], s["after"]
        args = (b["graph"], b["constraints"], b["last_deform_time"], cfg, b["kw"], device)
        ok_r, poses_r, hist_r, g_r = ref_of.solve(*args)
        if control is not None:
            ok_p, poses_p, hist_p, g_p = control.solve(*args)
        else:
            ok_p, poses_p, hist_p, g_p = a["ok"], a["poses"], a["history"], a["graph"]
        row = dict(pose_mm=0.0, rot_mdeg=0.0, pred_px=0.0, count_rel=0.0)
        if ok_p != ok_r:
            row["pose_mm"] = DISAGREE
        elif ok_r:
            row["pose_mm"], row["rot_mdeg"] = _graph_gap(g_p, g_r)
            for (_, Tp), (_, Tr) in zip(list(poses_p) + list(hist_p),
                                        list(poses_r) + list(hist_r)):
                dt, ang = _pose_gap(np.asarray(Tp), np.asarray(Tr))
                row["pose_mm"] = max(row["pose_mm"], dt)
                row["rot_mdeg"] = max(row["rot_mdeg"], ang)
        rows.append(row)
    return rows


def check_repairs(samples: List[dict], cfg, device,
                  control: Optional[Reference] = None) -> List[Dict[str, float]]:
    """Each sampled closure repair recomputed from the program's map, pose
    and latest frame before it and its solved graph."""
    ref_of = Reference()
    rows = []
    for s in samples:
        b = s["before"]
        m = _ref_map(b["map"], device)
        T_fix, T_new = ref_closure.rigid_fix(b["T_target"], b["T_wc"], b["T"].to(device))
        graph = ref_closure.GraphState(*(x.to(device) for x in b["graph"]))
        args = (m, graph, T_fix, b["closure_tick"], T_new, b["tick_now"], b["tick_now"],
                b["filt"].to(device), b["rgb"].to(device), cfg, b["fern_accepted"],
                b["so3"].to(device))
        ref = ref_of.repair(*args)
        prog = control.repair(*args) if control is not None else carried_of(s["after"], device)
        rows.append(compare(prog, ref))
        del ref, prog, m
    return rows


def check_start(first: dict, cfg, device) -> Dict[str, float]:
    """The program's state after the first frame against the reference's."""
    ref = ref_frame.first_frame(first["depth"].to(device), first["rgb"].to(device),
                                first["capacity"], cfg)
    return compare(carried_of(first["state"], device), ref)
