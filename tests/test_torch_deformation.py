"""The deformation graph of the port (`elasticfusion_tpu_torch/deformation.py`)
against the reference package's on the CPU: kNN weighting in both window
modes (with a constructed distance tie and dead slots), blending, the
per-surfel application, one Gauss-Newton step, and `Deformation.constrain`
from the same graph and constraints.  The hand-written Jacobian products of
the port are also held against `torch.func`'s."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nn, reference_output, rot_err, tt
from elasticfusion_tpu import deformation as ref_def
from elasticfusion_tpu.surfels import SurfelMap as RefMap
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch import deformation as port_def

NN = 64          # node capacity
N_LIVE = 30      # live nodes
NC = 48          # constraint capacity


def _graph_numpy(seed=0):
    """A live graph of 30 nodes along a gently curving path (times
    nondecreasing, two equal), slightly perturbed rotations and
    translations, dead slots +inf."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((NN, 3), np.float32)
    steps = rng.normal(0.0, 0.03, (N_LIVE, 3)) + np.array([0.1, 0.0, 0.0])
    pos[:N_LIVE] = np.cumsum(steps, axis=0)
    times = np.full((NN,), np.inf, np.float32)
    times[:N_LIVE] = np.arange(10, 10 + 10 * N_LIVE, 10)
    times[7] = times[6]                       # two nodes of one tick
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (NN, 3, 3)).copy()
    R[:N_LIVE] += rng.normal(0.0, 0.02, (N_LIVE, 3, 3)).astype(np.float32)
    t = np.zeros((NN, 3), np.float32)
    t[:N_LIVE] = rng.normal(0.0, 0.02, (N_LIVE, 3))
    return dict(pos=pos, times=times, R=R, t=t,
                nbr=ref_def._neighbours(N_LIVE, NN).astype(np.int32),
                n_nodes=np.int32(N_LIVE))


def _queries(g):
    """Query points and times: near live nodes, one exactly midway between
    two nodes of one window (a distance tie), and times past the last live
    node (the window reaches the dead slots' boundary)."""
    rng = np.random.default_rng(1)
    pos, times = g["pos"], g["times"]
    idx = rng.integers(0, N_LIVE, 40)
    pts = pos[idx] + rng.normal(0.0, 0.05, (40, 3)).astype(np.float32)
    ts = times[idx] + rng.integers(-15, 16, 40).astype(np.float32)
    tie = 0.5 * (pos[12] + pos[13])
    late = pos[N_LIVE - 1] + np.float32(0.02)
    pts = np.concatenate([pts, tie[None], late[None], pos[:1]]).astype(np.float32)
    ts = np.concatenate([ts, [times[12], 1e6, 0.0]]).astype(np.float32)
    return pts, ts


def _constraints(g):
    """Host constraints: absolute ones at the live nodes' times, a third of
    them relative, targets moved by a few cm."""
    rng = np.random.default_rng(2)
    out = []
    for i in range(0, N_LIVE, 1):
        src = g["pos"][i] + rng.normal(0.0, 0.02, 3)
        tgt = g["pos"][i] + rng.normal(0.0, 0.05, 3)
        out.append((src, tgt, g["times"][i], g["times"][min(i + 3, N_LIVE - 1)],
                    i % 3 == 0))
    return out


def _ref_cset(g, cons):
    gj = ref_def.GraphState(**{k: jnp.asarray(v) for k, v in g.items()})
    src = jnp.asarray(np.array([c[0] for c in cons], np.float32))
    tgt = jnp.asarray(np.array([c[1] for c in cons], np.float32))
    sn, sw = ref_def.weight_points(src, jnp.asarray([c[2] for c in cons], jnp.float32), gj)
    tn, tw = ref_def.weight_points(tgt, jnp.asarray([c[3] for c in cons], jnp.float32), gj)
    pad = NC - len(cons)
    p = lambda a: jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))  # noqa: E731
    return gj, ref_def.ConstraintSet(
        src=p(src), src_nodes=p(sn), src_w=p(sw), target=p(tgt), tar_nodes=p(tn),
        tar_w=p(tw), relative=p(jnp.asarray([c[4] for c in cons])),
        valid=p(jnp.ones(len(cons), bool)))


def _surfels():
    rng = np.random.default_rng(3)
    n = 2000
    g = _graph_numpy()
    i = rng.integers(0, N_LIVE, n)
    pos = (g["pos"][i] + rng.normal(0, 0.05, (n, 3))).T.astype(np.float32)
    nrm = rng.normal(0, 1, (3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    init_t = (g["times"][i] + rng.integers(-12, 13, n)).astype(np.float32)
    z1 = np.zeros((n,), np.float32)
    return dict(pos=pos, conf=z1 + 5, color=np.zeros((3, n), np.float32),
                init_t=init_t, last_t=init_t, normal=nrm, radius=z1 + 0.01,
                count=np.int32(n))


@pytest.fixture(scope="module")
def ref():
    """Every reference call of this module in ONE jit."""
    g = _graph_numpy()
    pts, ts = _queries(g)
    cons = _constraints(g)
    surf = _surfels()
    enabled = (g["times"] > 60) & (np.arange(NN) < N_LIVE)

    @jax.jit
    def run(g, pts, ts, surf, enabled):
        gj, cset = _ref_cset(g, cons)
        out = {}
        for mode in ("back", "centered"):
            nodes, w = ref_def.weight_points(jnp.asarray(pts), jnp.asarray(ts), gj, mode=mode)
            out[mode] = (nodes, w, ref_def.blend_points(jnp.asarray(pts), nodes, w, gj))
        out["surfels"] = ref_def.apply_graph_to_surfels(RefMap(**surf), gj)
        x = jnp.concatenate([gj.R.reshape(-1), gj.t.reshape(-1)])
        out["gn"] = ref_def._gn_step(x, gj, gj.nbr, enabled, cset)
        out["cset"] = cset
        return out

    got = jax.tree.map(np.asarray, run(g, pts, ts, surf, enabled))
    return dict(g=g, pts=pts, ts=ts, cons=cons, surf=surf, enabled=enabled, **got)


def _port_graph(g):
    return convert.graph_state_from_numpy(g, "cpu")


def _port_cset(ref):
    c = ref["cset"]
    return port_def.ConstraintSet(
        src=tt(c.src), src_nodes=tt(c.src_nodes).long(), src_w=tt(c.src_w),
        target=tt(c.target), tar_nodes=tt(c.tar_nodes).long(), tar_w=tt(c.tar_w),
        relative=tt(c.relative), valid=tt(c.valid))


@pytest.mark.parametrize("mode", ["back", "centered"])
def test_weight_points_and_blend_match_reference(ref, mode):
    g = _port_graph(ref["g"])
    nodes, w = port_def.weight_points(tt(ref["pts"]), tt(ref["ts"]), g, mode=mode)
    r_nodes, r_w, r_blend = ref[mode]
    # node choice exact (the tie row included); weights and blends: float32
    # norms and divisions in another order, 1e-6 / 1e-5
    np.testing.assert_array_equal(nn(nodes), r_nodes)
    np.testing.assert_allclose(nn(w), r_w, rtol=0, atol=1e-6)
    blend = port_def.blend_points(tt(ref["pts"]), nodes, w, g)
    np.testing.assert_allclose(nn(blend), r_blend, rtol=0, atol=1e-5)
    assert nn(nodes).max() < N_LIVE                      # never a dead slot


def test_distance_tie_goes_to_the_earlier_window_slot():
    """Two nodes equally far from the query: the earlier one comes first,
    as `jax.lax.top_k` orders ties."""
    pos = np.zeros((8, 3), np.float32)
    pos[:6, 0] = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    times = np.full((8,), np.inf, np.float32)
    times[:6] = np.arange(6) * 10.0
    g = port_def.empty_graph(8, "cpu")._replace(
        pos=tt(pos), times=tt(times), n_nodes=torch.tensor(6, dtype=torch.int32))
    nodes, w = port_def.weight_points(tt(np.array([[2.5, 0.0, 0.0]], np.float32)),
                                      tt(np.array([20.0], np.float32)), g,
                                      lookback=6, k=4)
    assert nn(nodes)[0].tolist() == [2, 3, 1, 4]
    assert float(w[0, 0]) == float(w[0, 1])


def test_apply_graph_to_surfels_matches_reference(ref):
    g = _port_graph(ref["g"])
    m = convert.surfel_map_from_numpy(ref["surf"], "cpu")
    pos, nrm = port_def.apply_graph_to_surfels(m, g)
    r_pos, r_nrm = ref["surfels"]
    # float32 blends in another order; the normals through a cofactor inverse
    # instead of an LU one
    np.testing.assert_allclose(nn(pos), r_pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(nn(nrm), r_nrm, rtol=0, atol=1e-5)


def test_gn_step_matches_reference(ref):
    g = _port_graph(ref["g"])
    cset = _port_cset(ref)
    x = torch.cat([g.R.reshape(-1), g.t.reshape(-1)])
    delta, err0 = port_def._gn_step(x, g, g.nbr, tt(ref["enabled"]), cset)
    r_delta, r_err0 = ref["gn"]
    # the residual is one float32 evaluation: 1e-5 relative.  The step is the
    # end of 128 CG iterations on an ill-conditioned system (damping 1e-6)
    # whose float32 roundings differ from the reference's jvp/vjp: 1e-2 of
    # its largest entry (measured 1.5e-3)
    np.testing.assert_allclose(float(err0), float(r_err0), rtol=1e-5)
    scale = np.abs(r_delta).max()
    assert scale > 0.1
    assert np.abs(nn(delta) - r_delta).max() < 1e-2 * scale
    # variables of disabled nodes stay put
    en = np.repeat(ref["enabled"], 9)
    assert not nn(delta)[: NN * 9][~en].any()


def test_hand_jacobians_equal_autodiff(ref):
    """`_Linear.jv` / `jt` against `torch.func.jvp` / `vjp` of the same
    residual (on the CPU, where autodiff's scatter-add is deterministic)."""
    g = _port_graph(ref["g"])
    cset = _port_cset(ref)
    enabled = tt(ref["enabled"])
    x = torch.cat([g.R.reshape(-1), g.t.reshape(-1)])
    f = lambda xv: port_def._flat_residual(xv, g, g.nbr, enabled, cset)  # noqa: E731
    lin = port_def._Linear(g, g.nbr, enabled, cset)
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(x.shape, generator=gen)
    R, _ = port_def._split(x, NN)
    dR, dt = port_def._split(v, NN)
    _, jv_ref = torch.func.jvp(f, (x,), (v,))
    r, vjp = torch.func.vjp(f, x)
    u = torch.randn(r.shape, generator=gen)
    (jt_ref,) = vjp(u)
    jR, jt_ = lin.jt(R, u)
    jt = torch.cat([jR.reshape(-1), jt_.reshape(-1)])
    # the same products summed in another order: 1e-6 of the largest entry
    assert (lin.jv(R, dR, dt) - jv_ref).abs().max() <= 1e-6 * jv_ref.abs().max()
    assert (jt - jt_ref).abs().max() <= 1e-6 * jt_ref.abs().max()


def _constrain_inputs():
    """A fern-match problem that the graph can solve exactly: every
    constraint's target is its source moved by one translation, so the
    solve ends near t = shift, R = I and is accepted."""
    rng = np.random.default_rng(4)
    g = _graph_numpy()
    shift = np.array([0.05, 0.04, 0.03])
    cons = []
    for i in range(2, N_LIVE, 2):
        src = g["pos"][i].astype(np.float64) + rng.normal(0, 0.01, 3)
        cons.append((src, src + shift, int(g["times"][i]), int(g["times"][i])))
    fern_poses, hist = [], []
    for i, ts in enumerate((15, 95, 205)):
        T = np.eye(4)
        T[:3, 3] = g["pos"][i * 10] + 0.01
        fern_poses.append((ts, T))
    for ts in range(10, 300, 25):
        T = np.eye(4)
        T[:3, 3] = g["pos"][ts // 10]
        hist.append((ts, T))
    return g, cons, fern_poses, hist


def _run_constrain(mod, to_graph, g, cons, fern_poses, hist, **dev):
    d = mod.Deformation(node_capacity=NN, constraint_capacity=NC, **dev)
    d._init_graph(g["pos"][:N_LIVE], g["times"][:N_LIVE])
    for src, tgt, ts, tt_ in cons:
        d.add_constraint(src, tgt, ts, tt_)
    ok, poses, new_hist, _ = d.constrain(
        fern_poses, 300, fern_match=True, pose_history=hist, relax_graph=True)
    return ok, poses, new_hist, to_graph(d.graph)


def reference_constrain(out_path):
    """The reference `constrain` on `_constrain_inputs` (its output is
    committed, `REFERENCE_OUTPUTS` below)."""
    out = _run_constrain(ref_def, lambda gr: {k: np.asarray(v) for k, v in gr._asdict().items()},
                         *_constrain_inputs())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# the committed output of this run, read by the tests below (`_torch_parity.reference_output`):
# name -> (function, arguments, cpu_devices)
REFERENCE_OUTPUTS = {"deformation_constrain": ("reference_constrain", (), 1)}


@pytest.fixture(scope="module")
def constrained():
    ref_out = reference_output("deformation_constrain")
    inputs = _constrain_inputs()
    port_out = _run_constrain(port_def, convert.graph_state_to_numpy, *inputs,
                              device="cpu")
    return ref_out, port_out, inputs


def test_constrain_matches_reference(constrained):
    (r_ok, r_poses, r_hist, r_g), (ok, poses, hist, pg), _ = constrained
    assert ok == r_ok and ok, "both accept the fern-match deformation"
    # poses through the optimised graph: 1e-4 m / 1e-4 rad (three GN steps
    # of float32 CG in another order)
    for (ts, T), (rts, rT) in zip(poses + hist, r_poses + r_hist):
        assert ts == rts
        assert np.linalg.norm(T[:3, 3] - rT[:3, 3]) < 1e-4
        assert rot_err(T, rT) < 1e-4
    assert len(hist) == len(r_hist) == 12
    # and the graph moved the late poses by about the shift
    assert np.linalg.norm(hist[-1][1][:3, 3] - constrained[2][3][-1][1][:3, 3]
                          - np.array([0.05, 0.04, 0.03])) < 5e-3
    np.testing.assert_allclose(pg["t"], r_g["t"], rtol=0, atol=1e-4)


def test_constrain_repeats_bit_for_bit_on_the_cpu(constrained):
    _, (ok, poses, hist, pg), inputs = constrained
    again = _run_constrain(port_def, convert.graph_state_to_numpy, *inputs, device="cpu")
    assert again[0] == ok
    for a, b in zip(poses + hist, again[1] + again[2]):
        assert np.array_equal(a[1], b[1])
    for k in ("R", "t"):
        assert np.array_equal(pg[k], again[3][k])


def test_graph_state_round_trip():
    g = _graph_numpy()
    pg = convert.graph_state_from_numpy(g, "cpu")
    assert pg.nbr.dtype == torch.int64 and pg.n_nodes.dtype == torch.int32
    back = convert.graph_state_to_numpy(pg)
    for k, v in g.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("n", [5, 6, 12, 40])
def test_neighbours_match_reference(n):
    np.testing.assert_array_equal(port_def._neighbours(n, 48),
                                  ref_def._neighbours(n, 48))
