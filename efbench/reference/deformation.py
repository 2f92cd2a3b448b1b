"""Frozen copy of the port's `deformation.py`: the deformation graph, its
Gauss-Newton solve with matrix-free conjugate gradients, and its
application to surfels and poses (Core/Deformation, DeformationGraph;
copy_unstable.vert:132-303).  Host reads are plain copies here."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .surfels import SurfelMap


def read_back(t: torch.Tensor):
    return t.detach().cpu().numpy()


def resolve_device(device=None) -> torch.device:
    return torch.device(device or "cpu")

K_NEIGHBOURS = 4     # k, Deformation.cpp:23
LOOKBACK = 20        # DeformationGraph.cpp:133/269
W_ROT, W_REG, W_CON = 1.0, 10.0, 100.0   # DeformationGraph.cpp:26-28


class GraphState(NamedTuple):
    """Node arrays of fixed capacity NN; slots >= n_nodes are dead."""

    pos: torch.Tensor      # [NN, 3] node position g_n (world)
    times: torch.Tensor    # [NN] node init time, nondecreasing, +inf when dead
    R: torch.Tensor        # [NN, 3, 3] affine rotation (identity at rest)
    t: torch.Tensor        # [NN, 3] translation
    nbr: torch.Tensor      # [NN, k] i64 temporal neighbours (connectGraphSeq)
    n_nodes: torch.Tensor  # 0-d i32


def empty_graph(capacity: int = 1024, device=None) -> GraphState:
    dev = resolve_device(device)
    return GraphState(
        pos=torch.zeros((capacity, 3), device=dev),
        times=torch.full((capacity,), float("inf"), device=dev),
        R=torch.eye(3, device=dev).expand(capacity, 3, 3).contiguous(),
        t=torch.zeros((capacity, 3), device=dev),
        nbr=torch.zeros((capacity, K_NEIGHBOURS), dtype=torch.int64, device=dev),
        n_nodes=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


# ---------------------------------------------------------------------------
# Temporal-window kNN weighting (weightVerticesSeq / setPosesSeq /
# copy_unstable.vert's surfel variant)
# ---------------------------------------------------------------------------


def weight_points(
    points: torch.Tensor,   # [M, 3]
    times: torch.Tensor,    # [M]
    g: GraphState,
    mode: str = "back",
    lookback: int = LOOKBACK,
    k: int = K_NEIGHBOURS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary-search the node timeline, take a `lookback` window of
    consecutive nodes, pick the k nearest by Euclidean distance and weight
    them (1 - d/dMax)^2, normalised (DeformationGraph.cpp:268-373).

    mode="back": the window extends backward from the found node
    (weightVerticesSeq / setPosesSeq); mode="centered": lookback/2 back and
    lookback/2 forward (copy_unstable.vert:195-232).  Ties in distance go to
    the earlier window slot, as `jax.lax.top_k` orders them.  Returns
    (node idx [M,k] i64, weights [M,k])."""
    NN = g.pos.shape[0]
    n = g.n_nodes.to(torch.int64)

    found = torch.searchsorted(g.times, times.contiguous())   # dead slots +inf
    found = torch.minimum(torch.clamp(found, min=0), n - 1)
    # nearest of the two bracketing nodes
    below = torch.clamp(found - 1, 0, NN - 1)
    d_below = torch.abs(g.times[below] - times)
    d_at = torch.abs(g.times[torch.clamp(found, 0, NN - 1)] - times)
    found = torch.where(d_below < d_at, below, found)

    back = lookback - 1 if mode == "back" else lookback // 2 - 1
    start = torch.minimum(torch.clamp(found - back, min=0),
                          torch.clamp(n - lookback, min=0))

    win = start[:, None] + torch.arange(lookback, device=points.device)[None, :]
    win_valid = win < n
    win_c = torch.clamp(win, 0, NN - 1)
    d = _norm3(g.pos[win_c] - points[:, None, :])               # [M, L]
    d = torch.where(win_valid, d, torch.full_like(d, float("inf")))

    # k nearest + the (k+1)-th for dMax (DeformationGraph.cpp:214); a stable
    # sort keeps equal distances in window order
    dists, top_i = torch.sort(d, dim=1, stable=True)
    dists, top_i = dists[:, :k + 1], top_i[:, :k + 1]
    d_max = torch.clamp(dists[:, k], min=1e-12)
    w = torch.square(1.0 - dists[:, :k] / d_max[:, None])
    w = torch.where(torch.isfinite(dists[:, :k]), w, torch.zeros_like(w))
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    nodes = torch.gather(win_c, 1, top_i[:, :k])
    return nodes, w


def _rotate(Rn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rn [..., 3, 3] applied to v [..., 3]."""
    return torch.sum(Rn * v[..., None, :], dim=-1)


def blend_points(
    points: torch.Tensor, nodes: torch.Tensor, w: torch.Tensor, g: GraphState
) -> torch.Tensor:
    """phi(p) = sum_i w_i (R_i (p - g_i) + g_i + t_i)
    (computeVertexPosition, DeformationGraph.cpp:925-942)."""
    gp = g.pos[nodes]                                 # [M, k, 3]
    rotated = _rotate(g.R[nodes], points[:, None, :] - gp)
    return torch.sum(w[..., None] * (rotated + gp + g.t[nodes]), dim=1)


# ---------------------------------------------------------------------------
# Energy + Gauss-Newton / CG solve
# ---------------------------------------------------------------------------


def _neighbours(n: int, capacity: int, k: int = K_NEIGHBOURS) -> np.ndarray:
    """Temporal connectivity (connectGraphSeq, DeformationGraph.cpp:239-266):
    interior node i links i±1..i±k/2; boundary nodes link the first/last k+1
    block.  Dead slots reference themselves (their edges are masked out)."""
    nbr = np.arange(capacity, dtype=np.int64)[:, None].repeat(k, axis=1)
    h = k // 2
    for i in range(min(n, capacity)):
        if i < h:
            opts = [m for m in range(min(k + 1, n)) if m != i]
        elif i >= n - h:
            opts = [m for m in range(max(n - (k + 1), 0), n) if m != i]
        else:
            opts = []
            for m in range(h):
                opts += [i - (m + 1), i + (m + 1)]
        opts = (opts + [i] * k)[:k]  # pad degenerate tiny graphs with self
        nbr[i] = opts
    return nbr


class ConstraintSet(NamedTuple):
    """Fixed-capacity constraint block (src deformed towards target)."""

    src: torch.Tensor        # [NC, 3] source points (world)
    src_nodes: torch.Tensor  # [NC, k] i64
    src_w: torch.Tensor      # [NC, k]
    target: torch.Tensor     # [NC, 3] absolute target, or relative target point
    tar_nodes: torch.Tensor  # [NC, k] i64 (relative constraints)
    tar_w: torch.Tensor      # [NC, k]
    relative: torch.Tensor   # [NC] bool
    valid: torch.Tensor      # [NC] bool


def _masks(g: GraphState, nbr, enabled, cons: ConstraintSet):
    """Square-root-weighted masks of the three energy blocks: rotation
    [NN], edge [NN,k] (either endpoint enabled, live, no self edge) and
    constraint [NC] (valid and influenced by an enabled node)."""
    NN = g.pos.shape[0]
    slot = torch.arange(NN, device=g.pos.device)
    live = slot < g.n_nodes
    edge_on = (enabled[:, None] | enabled[nbr]) & live[:, None] & (nbr != slot[:, None])
    influenced = torch.any(enabled[cons.src_nodes] & (cons.src_w > 0), dim=1) | (
        cons.relative & torch.any(enabled[cons.tar_nodes] & (cons.tar_w > 0), dim=1)
    )
    f32 = torch.float32
    return (enabled.to(f32) * math.sqrt(W_ROT),
            edge_on.to(f32) * math.sqrt(W_REG),
            (cons.valid & influenced).to(f32) * math.sqrt(W_CON))


def _residuals(R, t, g: GraphState, nbr, enabled, cons: ConstraintSet):
    """The three energy blocks (sparseResidual, DeformationGraph.cpp:791-887),
    each masked to a fixed shape, square-root weights folded in."""
    rot_w, reg_w, con_w = _masks(g, nbr, enabled, cons)

    # E_rot: column orthogonality of each enabled node (cpp:797-822)
    c0, c1, c2 = R[:, :, 0], R[:, :, 1], R[:, :, 2]
    erot = torch.stack(
        [
            torch.sum(c0 * c1, -1),
            torch.sum(c0 * c2, -1),
            torch.sum(c1 * c2, -1),
            torch.sum(c0 * c0, -1) - 1.0,
            torch.sum(c1 * c1, -1) - 1.0,
            torch.sum(c2 * c2, -1) - 1.0,
        ],
        dim=1,
    ) * rot_w[:, None]

    # E_reg: R_j (g_n - g_j) + g_j + t_j - (g_n + t_n) per edge (cpp:824-837)
    gn = g.pos[nbr]                                        # [NN, k, 3]
    pred = _rotate(R[:, None], gn - g.pos[:, None, :]) + (
        g.pos[:, None, :] + t[:, None, :])
    ereg = (pred - (gn + t[nbr])) * reg_w[..., None]

    # E_con: phi(src) - target (absolute) or phi(src) - phi(tar) (cpp:839-882)
    gc = g._replace(R=R, t=t)
    src_phi = blend_points(cons.src, cons.src_nodes, cons.src_w, gc)
    tar_phi = blend_points(cons.target, cons.tar_nodes, cons.tar_w, gc)
    tgt = torch.where(cons.relative[:, None], tar_phi, cons.target)
    econ = (src_phi - tgt) * con_w[:, None]
    return erot, ereg, econ


def _split(x: torch.Tensor, NN: int):
    return x[: NN * 9].reshape(NN, 3, 3), x[NN * 9:].reshape(NN, 3)


def _flat_residual(x, g: GraphState, nbr, enabled, cons: ConstraintSet):
    R, t = _split(x, g.pos.shape[0])
    erot, ereg, econ = _residuals(R, t, g, nbr, enabled, cons)
    return torch.cat([erot.reshape(-1), ereg.reshape(-1), econ.reshape(-1)])


class _Linear:
    """J·v and Jᵀ·u of `_flat_residual` for one solve.  The graph's
    geometry, the neighbour and constraint node lists and the masks are fixed
    during a solve, so only the rotation block's Jacobian depends on x.

    Jᵀ sums every node's contributions from its neighbours' edges and from
    the constraints that reference it by a gather over an inverse adjacency
    (`inv`: for each node the entry rows that touch it, padded with a row of
    zeros) and a sum in a fixed order — deterministic on a card, where a
    scatter-add would add in the order the atomics land.  Building it costs
    one host read (the live node count and the largest degree)."""

    def __init__(self, g: GraphState, nbr, enabled, cons: ConstraintSet):
        NN, k = nbr.shape
        dev = g.pos.device
        self.NN = NN
        self.nbr = nbr
        self.rot_w, self.reg_w, self.con_w = _masks(g, nbr, enabled, cons)
        self.reg_e = g.pos[nbr] - g.pos[:, None, :]            # [NN, k, 3]
        self.src_nodes, self.tar_nodes = cons.src_nodes, cons.tar_nodes
        self.src_e = cons.src[:, None, :] - g.pos[cons.src_nodes]
        self.tar_e = cons.target[:, None, :] - g.pos[cons.tar_nodes]
        self.src_w = cons.src_w
        self.tar_w = torch.where(cons.relative[:, None], cons.tar_w,
                                 torch.zeros_like(cons.tar_w))

        # entries of the transposed product that land on another node: the
        # far end of every edge, then every (constraint, node) pair; the ones
        # whose weight is zero go to a sink row past the live nodes
        n = g.n_nodes.to(torch.int64)
        on = torch.cat([
            (self.reg_w > 0).reshape(-1),
            ((self.con_w[:, None] > 0) & (self.src_w != 0)).reshape(-1),
            ((self.con_w[:, None] > 0) & (self.tar_w != 0)).reshape(-1),
        ])
        key = torch.cat([nbr.reshape(-1), self.src_nodes.reshape(-1),
                         self.tar_nodes.reshape(-1)])
        key = torch.where(on & (key < n), key, torch.full_like(key, NN))
        P = key.numel()
        order = torch.sort(key, stable=True).indices
        skey = key[order]
        counts = torch.bincount(key, minlength=NN + 1)
        n_host, maxdeg = (int(v) for v in read_back(
            torch.stack([n, counts[:NN].max()])))
        seg_start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(P, device=dev) - seg_start[skey]
        inv = torch.full((NN + 1, max(maxdeg, 1)), P, dtype=torch.int64, device=dev)
        keep = skey < NN
        inv[skey[keep], pos[keep]] = order[keep]
        self.inv = inv[:n_host]
        self.n = n_host

    def jv(self, R, dR, dt):
        """J·(dR, dt) at rotations R, in `_flat_residual`'s layout."""
        c0, c1, c2 = R[:, :, 0], R[:, :, 1], R[:, :, 2]
        d0, d1, d2 = dR[:, :, 0], dR[:, :, 1], dR[:, :, 2]
        erot = torch.stack([
            torch.sum(d0 * c1 + c0 * d1, -1),
            torch.sum(d0 * c2 + c0 * d2, -1),
            torch.sum(d1 * c2 + c1 * d2, -1),
            torch.sum(d0 * c0 + c0 * d0, -1),
            torch.sum(d1 * c1 + c1 * d1, -1),
            torch.sum(d2 * c2 + c2 * d2, -1),
        ], dim=1) * self.rot_w[:, None]
        ereg = ((_rotate(dR[:, None], self.reg_e) + dt[:, None, :]) - dt[self.nbr]
                ) * self.reg_w[..., None]
        src = torch.sum(self.src_w[..., None] * (
            _rotate(dR[self.src_nodes], self.src_e) + dt[self.src_nodes]), dim=1)
        tar = torch.sum(self.tar_w[..., None] * (
            _rotate(dR[self.tar_nodes], self.tar_e) + dt[self.tar_nodes]), dim=1)
        econ = (src - tar) * self.con_w[:, None]
        return torch.cat([erot.reshape(-1), ereg.reshape(-1), econ.reshape(-1)])

    def jt(self, R, u):
        """Jᵀ·u at rotations R → (dR [NN,3,3], dt [NN,3])."""
        NN, k = self.nbr.shape
        u_rot = u[: NN * 6].reshape(NN, 6) * self.rot_w[:, None]
        u_reg = u[NN * 6: NN * 6 + NN * k * 3].reshape(NN, k, 3) * self.reg_w[..., None]
        u_con = u[NN * 6 + NN * k * 3:].reshape(-1, 3) * self.con_w[:, None]

        c0, c1, c2 = R[:, :, 0], R[:, :, 1], R[:, :, 2]
        ur = [u_rot[:, i:i + 1] for i in range(6)]
        dR = torch.stack([
            ur[0] * c1 + ur[1] * c2 + 2.0 * ur[3] * c0,
            ur[0] * c0 + ur[2] * c2 + 2.0 * ur[4] * c1,
            ur[1] * c0 + ur[2] * c1 + 2.0 * ur[5] * c2,
        ], dim=-1)
        dR = dR + torch.sum(u_reg[..., :, None] * self.reg_e[..., None, :], dim=1)
        dt = torch.sum(u_reg, dim=1)

        src_u = u_con[:, None, :] * self.src_w[..., None]          # [NC, k, 3]
        tar_u = -(u_con[:, None, :] * self.tar_w[..., None])
        entries = torch.cat([
            torch.cat([torch.zeros((NN * k, 9), dtype=u.dtype, device=u.device),
                       -u_reg.reshape(-1, 3)], dim=1),
            torch.cat([(src_u[..., :, None] * self.src_e[..., None, :]).reshape(-1, 9),
                       src_u.reshape(-1, 3)], dim=1),
            torch.cat([(tar_u[..., :, None] * self.tar_e[..., None, :]).reshape(-1, 9),
                       tar_u.reshape(-1, 3)], dim=1),
            torch.zeros((1, 12), dtype=u.dtype, device=u.device),
        ])
        far = torch.sum(entries[self.inv], dim=1)                    # [n, 12]
        far = torch.nn.functional.pad(far, (0, 0, 0, NN - self.n))
        return dR + far[:, :9].reshape(NN, 3, 3), dt + far[:, 9:]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _gn_step(
    x: torch.Tensor, g: GraphState, nbr, enabled, cons: ConstraintSet,
    damping: float = 1e-6, cg_iters: int = 128, lin: Optional[_Linear] = None,
):
    """One Gauss-Newton step: delta = argmin |J delta + r|^2 over the enabled
    variables, by CG on (P JᵀJ P + lambda I).  Replaces the reference's
    CHOLMOD analyze/factorize/solve (CholeskyDecomp.cpp:36-111).

    The CG runs `cg_iters` iterations; once the residual norm² is <= 1e-12
    its state stays as it is, which is where the reference package's loop
    stops.  Returns (delta, |r0|²) as device tensors."""
    NN = g.pos.shape[0]
    if lin is None:
        lin = _Linear(g, nbr, enabled, cons)
    en = enabled.to(torch.float32)
    vmask = torch.cat([en.repeat_interleave(9), en.repeat_interleave(3)])
    R, _ = _split(x, NN)

    def jtj(v):
        v = v * vmask
        dR, dt = _split(v, NN)
        jR, jt_ = lin.jt(R, lin.jv(R, dR, dt))
        return torch.cat([jR.reshape(-1), jt_.reshape(-1)]) * vmask + damping * v

    r0 = _flat_residual(x, g, nbr, enabled, cons)
    gR, gt = lin.jt(R, r0)
    b = -(torch.cat([gR.reshape(-1), gt.reshape(-1)]) * vmask)

    xk = torch.zeros_like(x)
    rk, pk = b, b
    rs = _dot(b, b)
    for _ in range(cg_iters):
        active = rs > 1e-12
        Ap = jtj(pk)
        alpha = rs / torch.clamp(_dot(pk, Ap), min=1e-20)
        x_n = xk + alpha * pk
        r_n = rk - alpha * Ap
        rs_n = _dot(r_n, r_n)
        p_n = r_n + (rs_n / torch.clamp(rs, min=1e-20)) * pk
        xk = torch.where(active, x_n, xk)
        rk = torch.where(active, r_n, rk)
        pk = torch.where(active, p_n, pk)
        rs = torch.where(active, rs_n, rs)
    return xk, torch.sum(r0 * r0)


# ---------------------------------------------------------------------------
# Per-surfel application (copy_unstable.vert:132-303)
# ---------------------------------------------------------------------------


def _inverse_transpose(R: torch.Tensor) -> torch.Tensor:
    """R^-T of every [3,3] block: the cofactor matrix over the determinant
    (columns c1×c2, c2×c0, c0×c1)."""
    c0, c1, c2 = R[..., 0], R[..., 1], R[..., 2]
    cof = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                       torch.linalg.cross(c0, c1)], dim=-1)
    det = torch.sum(c0 * torch.linalg.cross(c1, c2), dim=-1)
    return cof / det[..., None, None]


def apply_graph_to_surfels(m: SurfelMap, g: GraphState
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deform every surfel (position + normal) through the graph with the
    centered temporal window; normals through the inverse transpose of the
    nodes' rotations (copy_unstable.vert:290-296).  Returns ([3,N], [3,N])."""
    pts = m.pos.T.contiguous()                        # [N, 3]
    nodes, w = weight_points(pts, m.init_t, g, mode="centered")
    new_pos = blend_points(pts, nodes, w, g)
    nrm = _rotate(_inverse_transpose(g.R)[nodes], m.normal.T[:, None, :])
    new_nrm = torch.sum(w[..., None] * nrm, dim=1)
    ln = torch.sqrt(torch.sum(new_nrm * new_nrm, dim=1, keepdim=True))
    new_nrm = new_nrm / torch.clamp(ln, min=1e-12)
    return new_pos.T, new_nrm.T


# ---------------------------------------------------------------------------
# Host-side orchestration (Deformation / DeformationGraph classes)
# ---------------------------------------------------------------------------


class HostConstraint:
    """Deformation::Constraint (Deformation.h): src/target points + times."""

    __slots__ = ("src", "target", "src_time", "target_time", "relative", "pin")

    def __init__(self, src, target, src_time, target_time, relative=False, pin=False):
        self.src = np.asarray(src, np.float64)
        self.target = np.asarray(target, np.float64)
        self.src_time = int(src_time)
        self.target_time = int(target_time)
        self.relative = relative
        self.pin = pin


def _sample_every(pos, init_t, count, rate: int):
    """Every rate-th surfel's (position [M,3], init time [M], live count) —
    the sample.geom pass's equivalent, on the map's device."""
    idx = torch.arange(0, pos.shape[1], rate, device=pos.device)
    return pos[:, idx].T, init_t[idx], count


class Deformation:
    """Host orchestrator mirroring the reference Deformation class: takes a
    node sample of the map every frame (lazily: device handles only),
    accumulates constraints, optimises, and keeps the optimised GraphState
    for the closure repair to apply."""

    def __init__(self, node_capacity: int = 1024, sample_rate: int = 5000,
                 constraint_capacity: int = 1024, device=None):
        self.device = resolve_device(device)
        self.node_capacity = node_capacity
        self.sample_rate = sample_rate
        self.constraint_capacity = constraint_capacity
        self.graph: Optional[GraphState] = None
        self.host_nodes: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.constraints: List[HostConstraint] = []
        self.last_deform_time = 0
        self.deforms = 0
        self._pending = None
        self._pending_from = None
        self._stale = False

    # -- graph (re)initialization -------------------------------------------
    def set_sampled(self, pos_sub, times_sub, count) -> None:
        """Accept a node sample taken inside the frame (device tensors)."""
        self._pending = (pos_sub, times_sub, count)
        self._pending_from = None
        self._stale = True

    def sample_graph_from(self, other: "Deformation") -> None:
        """Resample at 1/5 rate from another deformation's node set
        (sampleGraphFrom, Deformation.cpp:209-230) — lazily."""
        self._pending = None
        self._pending_from = other
        self._stale = True

    def _materialize(self) -> None:
        """Resolve the deferred sampling into an initialised graph; a node
        sample of the map costs one read."""
        if not self._stale:
            return
        self._stale = False
        if self._pending_from is not None:
            other = self._pending_from
            other._materialize()
            if other.graph is None:
                self.graph = None
                return
            pos, times = other.host_nodes
            idx = np.arange(0, len(pos), 5)
            if len(idx) <= K_NEIGHBOURS:
                self.graph = None
                return
            self._init_graph(pos[idx], times[idx])
            return
        if self._pending is None:
            self.graph = None
            return
        pos_sub, times_sub, count = self._pending
        M = pos_sub.shape[0]
        flat = read_back(torch.cat([count.reshape(1).to(torch.float32),
                                    pos_sub.reshape(-1), times_sub]))
        n = int(flat[0])
        n_idx = (n + self.sample_rate - 1) // self.sample_rate
        if n_idx <= K_NEIGHBOURS:
            self.graph = None
            return
        pos = flat[1:1 + 3 * M].reshape(M, 3)[:n_idx][: self.node_capacity]
        times = flat[1 + 3 * M:][:n_idx][: self.node_capacity]
        self._init_graph(pos, times)

    def _init_graph(self, pos: np.ndarray, times: np.ndarray) -> None:
        cap = self.node_capacity
        n = len(pos)
        pos_pad = np.zeros((cap, 3), np.float32)
        pos_pad[:n] = pos
        # dead slots MUST be +inf: weight_points binary-searches the timeline
        times_pad = np.full((cap,), np.inf, np.float32)
        times_pad[:n] = times
        self.host_nodes = (pos_pad[:n].copy(), times_pad[:n].copy())
        dev = self.device
        self.graph = empty_graph(cap, dev)._replace(
            pos=torch.from_numpy(pos_pad).to(dev),
            times=torch.from_numpy(times_pad).to(dev),
            nbr=torch.from_numpy(_neighbours(n, cap)).to(dev),
            n_nodes=torch.tensor(n, dtype=torch.int32, device=dev),
        )

    # -- constraints ---------------------------------------------------------
    def add_constraint(self, src, target, src_time, target_time,
                       pin: bool = False, relative: bool = False) -> None:
        self.constraints.append(
            HostConstraint(src, target, src_time, target_time, relative)
        )
        if pin:
            self.constraints.append(
                HostConstraint(target, target, target_time, target_time,
                               False, pin=True)
            )

    def _constraint_set(self, g: GraphState, cons: List[HostConstraint]):
        dev = self.device
        f32 = lambda a: torch.from_numpy(  # noqa: E731
            np.asarray(a, np.float64).astype(np.float32)).to(dev)
        src_pts = np.array([c.src for c in cons], np.float64)
        tar_pts = np.array([c.target for c in cons], np.float64)
        src_nodes, src_w = weight_points(
            f32(src_pts), f32([c.src_time for c in cons]), g)
        tar_nodes, tar_w = weight_points(
            f32(tar_pts), f32([c.target_time for c in cons]), g)
        pad = self.constraint_capacity - len(cons)
        P = torch.nn.functional.pad
        rows = lambda a: P(a, (0, 0, 0, pad))  # noqa: E731
        rel = torch.tensor([c.relative for c in cons], dtype=torch.bool, device=dev)
        cset = ConstraintSet(
            src=rows(f32(src_pts)), src_nodes=rows(src_nodes), src_w=rows(src_w),
            target=rows(f32(tar_pts)), tar_nodes=rows(tar_nodes), tar_w=rows(tar_w),
            relative=P(rel, (0, pad)),
            valid=P(torch.ones(len(cons), dtype=torch.bool, device=dev), (0, pad)),
        )
        return cset, f32(src_pts), src_nodes, src_w

    # -- the big one ---------------------------------------------------------
    def constrain(
        self,
        fern_poses: List[Tuple[int, np.ndarray]],   # [(srcTime, T_wc)]
        time: int,
        fern_match: bool,
        pose_history: List[Tuple[int, np.ndarray]],
        relax_graph: bool = False,
        collect_relative: bool = False,
    ):
        """Deformation::constrain (Deformation.cpp:88-207).  Returns
        (accepted, new fern poses, new pose history, relative constraints);
        the graph stays in self.graph for the closure repair.

        Host reads: the node sample (one, when it is new), the solve's set-up
        (one), the constraint error before a fern solve (one), one per
        Gauss-Newton step (its error, the new error, |delta| and the new
        constraint error together) and one for the poses on acceptance."""
        self._materialize()
        if self.graph is None or not self.constraints:
            self.constraints.clear()
            return False, fern_poses, pose_history, []

        g = self.graph
        cons = self.constraints[: self.constraint_capacity]
        nc = len(cons)
        cset, src_pts, src_nodes, src_w = self._constraint_set(g, cons)

        # enabled = nodes newer than lastDeformTime (0 for fern/relax)
        last_t = 0 if (fern_match or relax_graph) else self.last_deform_time
        NN = self.node_capacity
        enabled = (g.times > last_t) & (
            torch.arange(NN, device=self.device) < g.n_nodes)
        nbr = g.nbr

        # fern early-out (DeformationGraph.cpp:427-430)
        if fern_match and float(read_back(_mean_cons_error(g, cset, nc))) < 0.06:
            self.constraints.clear()
            return False, fern_poses, pose_history, []

        # <= 3 GN iterations with the reference's convergence gates (cpp:460-476)
        lin = _Linear(g, nbr, enabled, cset)
        x = torch.cat([g.R.reshape(-1), g.t.reshape(-1)])
        last_error = mean_cons = None
        for it in range(1, 4):
            delta, err0 = _gn_step(x, g, nbr, enabled, cset, lin=lin)
            x = x + delta
            R, t = _split(x, NN)
            new_err = torch.sum(torch.square(_flat_residual(x, g, nbr, enabled, cset)))
            err, new_err, dn, mean_cons = (float(v) for v in read_back(torch.stack([
                err0, new_err, torch.sqrt(_dot(delta, delta)),
                _mean_cons_error(g._replace(R=R, t=t), cset, nc)])))
            if it == 1:
                last_error = err
                if fern_match and err > 10.0:
                    break
            if (new_err > last_error or dn < 1e-2 or new_err < 1e-3
                    or abs(new_err - last_error) < 1e-5 * new_err):
                last_error = new_err
                break
            last_error = new_err

        R, t = _split(x, NN)
        g_opt = g._replace(R=R, t=t)
        accept = (not fern_match) or (mean_cons < 0.0003 and last_error < 0.12)
        new_rel: List[HostConstraint] = []
        if accept:
            self.graph = g_opt
            want_rel = collect_relative and not fern_match
            lists = [fern_poses] + ([pose_history] if fern_match else [])
            moved, src_def = _apply_to_poses(
                lists, g_opt, (src_pts, src_nodes, src_w) if want_rel else None)
            fern_poses = moved[0]
            if fern_match:
                pose_history = moved[1]
            if want_rel:
                for i, c in enumerate(cons):
                    if not c.relative and not c.pin:
                        new_rel.append(HostConstraint(
                            src_def[i], c.target, c.src_time, c.target_time,
                            relative=True,
                        ))
            if not fern_match and not relax_graph:
                self.last_deform_time = time
            self.deforms += 1
        self.constraints.clear()
        return accept, fern_poses, pose_history, new_rel


def _mean_cons_error(g: GraphState, cset: ConstraintSet, nc: int) -> torch.Tensor:
    """nonRelativeConstraintError (DeformationGraph.cpp:944-956); like the
    reference it divides by ALL constraints, not just the non-relative ones."""
    phi = blend_points(cset.src, cset.src_nodes, cset.src_w, g)
    err = _norm3(phi - cset.target)
    mask = cset.valid & ~cset.relative
    return torch.sum(torch.where(mask, err, torch.zeros_like(err))) / max(nc, 1)


def _apply_to_poses(pose_lists, g: GraphState, src=None):
    """applyGraphToPoses (DeformationGraph.cpp:98-126) on several pose lists
    in one device pass and one read: blended translation + weight-blended
    rotation, SVD re-orthonormalised.  With `src` = (points, nodes, weights)
    the deformed source points come back too (else None)."""
    poses = [p for lst in pose_lists for p in lst]
    dev = g.pos.device
    parts = []
    if poses:
        times = torch.tensor([float(p[0]) for p in poses], dtype=torch.float32,
                             device=dev)
        trans = torch.from_numpy(np.array(
            [np.asarray(p[1])[:3, 3] for p in poses], np.float64
        ).astype(np.float32)).to(dev)
        nodes, w = weight_points(trans, times, g)
        parts += [blend_points(trans, nodes, w, g).reshape(-1),
                  torch.sum(w[..., None, None] * g.R[nodes], dim=1).reshape(-1)]
    if src is not None:
        parts.append(blend_points(*src, g).reshape(-1))
    flat = read_back(torch.cat(parts)) if parts else np.zeros((0,), np.float32)
    P = len(poses)
    new_t = flat[: 3 * P].reshape(P, 3)
    Rblend = flat[3 * P: 12 * P].reshape(P, 3, 3)
    src_def = flat[12 * P:].reshape(-1, 3) if src is not None else None
    moved, o = [], 0
    for lst in pose_lists:
        out = []
        for ts, T in lst:
            newR = Rblend[o] @ np.asarray(T)[:3, :3]
            U, _, Vt = np.linalg.svd(newR)
            T2 = np.asarray(T).copy()
            T2[:3, :3] = U @ Vt
            T2[:3, 3] = new_t[o]
            out.append((ts, T2))
            o += 1
        moved.append(out if lst else lst)
    return moved, src_def
