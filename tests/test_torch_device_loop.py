"""The device-resident frame on the CPU: the tracker's loops as predicated
launches with their state on the device (tracking.py, ops/odometry.py
`so3_update` / `gn_update`), the frame's gates and conds on the device, one
read a frame (engine.py), and nothing in the frame that a CUDA graph capture
refuses.  At 160x120, against the reference package where it has a
counterpart: every reference call is in ONE `jax.jit` of a module-scoped
fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import SMALL_CAM, both_cams, nn, rot_err, tt
from elasticfusion_tpu import se3 as ref_se3
from elasticfusion_tpu import tracking as ref_tracking
from elasticfusion_tpu.config import EngineConfig as RefConfig
from elasticfusion_tpu.ops import odometry as ref_odo
from elasticfusion_tpu.ops import preprocess as ref_pp
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import _device
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch import tracking as port_tracking
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig
from elasticfusion_tpu_torch.ops import fuse as port_fuse
from elasticfusion_tpu_torch.ops import odometry as port_odo
from elasticfusion_tpu_torch.ops import splat as port_splat

# three frames of a sweep (the motion of chip_smoke.py's, three frames a step)
SWEEP = [pose_from_xyzrpy(x=0.024 * i, yaw=0.009 * i, z=0.006 * i) for i in range(3)]
N_SYSTEMS = 8


def _systems():
    """Seeded SPD normal equations and poses for the update arithmetic."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(N_SYSTEMS):
        J = (rng.standard_normal((6, 40)) * 10.0 ** rng.uniform(-2, 2)).astype(np.float32)
        A6 = (J @ J.T).astype(np.float32)
        b6 = (rng.standard_normal(6) * 1e-2 * np.abs(A6).max()).astype(np.float32)
        A3, b3 = A6[:3, :3].copy(), b6[:3].copy() * 1e-1
        Rt = np.asarray(pose_from_xyzrpy(x=0.01 * i, y=-0.02, yaw=0.03 * i, roll=0.01),
                        np.float32)
        Tp = np.asarray(pose_from_xyzrpy(x=0.3, z=0.1 * i, pitch=0.05), np.float32)
        out.append((A6, b6, A3, b3, Rt, Tp))
    return out


@pytest.fixture(scope="module")
def world():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    ref_cfg = RefConfig(camera=ref_cam, closeLoops=False)
    scene = make_scene(n_side=500)
    frames = [render_frame(scene[0], scene[1], T, ref_cam) for T in SWEEP]
    systems = _systems()

    @jax.jit
    def reference(d0, rgb0, d1, rgb1, Tp, systems):
        def prep(d):
            f = ref_pp.bilateral_filter(d.astype(jnp.float32), 20.0, 6)
            return ref_pp.metricise_depth(f, 3.0)

        f0, f1 = prep(d0), prep(d1)
        # the "model prediction" is the previous frame itself, in its camera frame
        v0 = ref_pp.compute_vmap(f0, ref_cam, 20.0)
        n0 = ref_pp.compute_nmap(v0)
        vm_c, nm_c, im_c, dp_c = ref_tracking.build_current_frame_pyramids(f1, rgb1, ref_cfg)
        vm_g, nm_g, im_m, dp_m = ref_tracking.build_model_pyramids(
            v0, n0, rgb0.astype(jnp.float32), Tp, ref_cfg)
        inputs = ref_tracking.OdometryInputs(
            vmaps_curr=vm_c, nmaps_curr=nm_c, vmaps_prev_g=vm_g, nmaps_prev_g=nm_g,
            last_images=im_m, next_images=im_c, last_depths=dp_m, next_depths=dp_c,
            so3_last_image=im_m[2], T_prev=Tp)
        track = ref_tracking.get_incremental_transformation(inputs, ref_cfg)
        gate = jnp.diag(jnp.linalg.inv(track.A + jnp.eye(6) * 1e-12))
        updates = []
        for A6, b6, A3, b3, Rt, T_prev in systems:
            x = ref_odo.solve_6x6(A6, b6)
            up = jnp.eye(4).at[:3, :3].set(ref_se3.so3_exp(x[3:6])).at[:3, 3].set(x[:3])
            new_rt = up @ Rt
            delta = ref_odo.solve_3x3(A3, b3)
            updates.append(dict(
                x6=x, rt=new_rt, T_curr=T_prev @ ref_se3.invert(new_rt),
                x3=delta, R=ref_se3.so3_exp(delta) @ Rt[:3, :3],
                E6=ref_se3.so3_exp(x[3:6]), E3=ref_se3.so3_exp(delta)))
        return inputs, track, gate, updates

    pairs = []
    for k in (1, 2):
        (d0, rgb0), (d1, rgb1) = frames[k - 1], frames[k]
        inputs, track, gate, updates = reference(
            d0, rgb0, d1, rgb1, jnp.asarray(SWEEP[k - 1], jnp.float32), systems)
        port_inputs = port_tracking.OdometryInputs(**{
            f: (tuple(tt(a) for a in v) if isinstance(v, tuple) else tt(v))
            for f, v in inputs._asdict().items()})
        pairs.append(dict(inputs=port_inputs, track=track, gate=np.asarray(gate),
                          T_next=SWEEP[k]))
    return dict(port_cam=port_cam, pairs=pairs, systems=systems,
                updates=jax.tree.map(np.asarray, updates), frames=frames)


@pytest.mark.parametrize("k", [0, 1])
def test_device_tracker_matches_reference_on_the_sweep(world, k):
    """test_torch_odometry.py's tolerances: 5e-4 m / 5e-4 rad between the
    two packages, both within 5 mm of the rendered pose, the inlier count
    within 1 %, the ICP error within 5 %; and the covariance gate of the
    finishing update against the reference's inverse."""
    p = world["pairs"][k]
    cfg = PortConfig(camera=world["port_cam"], closeLoops=False)
    got = port_tracking.get_incremental_transformation(p["inputs"], cfg)
    ref = p["track"]
    Tg, Tr = nn(got.T_curr), np.asarray(ref.T_curr)
    assert np.linalg.norm(Tg[:3, 3] - Tr[:3, 3]) < 5e-4
    assert rot_err(Tg, Tr) < 5e-4
    assert np.linalg.norm(Tg[:3, 3] - p["T_next"][:3, 3]) < 5e-3
    assert abs(float(got.icp_count) - float(ref.icp_count)) <= 0.01 * float(ref.icp_count)
    np.testing.assert_allclose(float(got.icp_error), float(ref.icp_error), rtol=0.05)
    np.testing.assert_allclose(float(got.so3_count), float(ref.so3_count), rtol=0.01)
    for thresh in (1e-6, 1e-4, 1e-2):
        ok = bool(port_odo.covariance_ok(got.A, thresh))
        want = bool((p["gate"] < thresh).all())
        assert ok == want or np.min(np.abs(p["gate"] - thresh)) < 1e-3 * thresh


def _pack(A6, b6):
    """An ICP-only pack of `A6`, `b6` (the RGB half zero)."""
    pack = torch.zeros(port_odo.PACK)
    pack[0:36] = tt(A6).reshape(-1)
    pack[36:42] = tt(b6)
    pack[42], pack[43] = 2.5, 1000.0
    return pack


@pytest.mark.parametrize("i", range(N_SYSTEMS))
def test_gn_update_matches_the_reference_solve_and_pose_update(world, i):
    """One Gauss-Newton update (plain version) against the reference's
    `solve_6x6` + `so3_exp` + left-multiplied compose + `T_prev @ inv`, and
    one SO(3) update against `solve_3x3` + `so3_exp` @ R, on seeded SPD
    systems.  The same float32 operations in the same order: `so3_exp`
    gives the reference's bits.  The solves do not: XLA on the CPU contracts
    some a*b + c of the Cholesky and Cramer sums into fused multiply-adds
    and takes 1/sqrt as rsqrt (measured: up to 31 ulps on the 6x6 update of
    these systems, 3 on the 3x3), so the updates are held to rtol 1e-5 and
    the composed poses to 1e-6."""
    A6, b6, A3, b3, Rt, Tp = world["systems"][i]
    want = world["updates"][i]
    for w, e in ((want["x6"][3:6], want["E6"]), (want["x3"], want["E3"])):
        np.testing.assert_array_equal(nn(port_odo.so3_exp_ordered(tt(w))), e)
    x6 = nn(port_odo.solve_6x6(tt(A6), tt(b6)))
    np.testing.assert_allclose(x6, want["x6"], rtol=1e-5, atol=1e-7 * np.abs(want["x6"]).max())
    k = port_odo.level_k(world["port_cam"])
    o = port_tracking.gn_options(PortConfig(camera=world["port_cam"], icp_weight=100.0,
                                            gn_plateau_exit=0.0))
    carry = torch.zeros(port_odo.GN_CARRY)
    active = torch.zeros(1, dtype=torch.int32)
    Tp_t = tt(Tp)
    port_odo.gn_update(0, None, carry, active, Tp_t, None, None, k, o)
    carry[port_odo.GN_RT:port_odo.GN_RT + 16] = tt(Rt).reshape(-1)
    port_odo.gn_update(1, _pack(A6, b6), carry, active, Tp_t, None, None, k, o)
    rt = nn(carry[port_odo.GN_RT:port_odo.GN_RT + 16]).reshape(4, 4)
    T_curr = nn(carry[port_odo.GN_TCURR:port_odo.GN_TCURR + 16]).reshape(4, 4)
    np.testing.assert_allclose(rt, want["rt"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(T_curr, want["T_curr"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nn(carry[port_odo.GN_A:port_odo.GN_A + 36]).reshape(6, 6), A6)

    x3 = nn(port_odo.solve_3x3(tt(A3), tt(b3)))
    np.testing.assert_allclose(x3, want["x3"], rtol=1e-5, atol=1e-7 * np.abs(want["x3"]).max())
    R = nn(port_odo.so3_exp_ordered(tt(x3)) @ tt(Rt[:3, :3]))
    np.testing.assert_allclose(R, want["R"], rtol=1e-6, atol=1e-6)


def test_so3_update_follows_the_reference_guards():
    """The SO(3) carry through converged, diverged and ordinary updates:
    an error below the last with the same count converges (R kept), one
    above it by more than 1e-3 diverges (the previous R back), otherwise R
    moves and the loop goes on."""
    k = port_odo.level_k(both_cams(SMALL_CAM)[1].scaled(2))
    carry, active = torch.zeros(port_odo.SO3_CARRY), torch.zeros(1, dtype=torch.int32)
    port_odo.so3_update(0, None, carry, active, k)
    assert int(active) == 1 and float(carry[port_odo.S3_LAST_ERR]) == np.float32(1.7e38)
    rng = np.random.default_rng(3)
    J = rng.standard_normal((3, 30)).astype(np.float32)

    def pack(sum_sq, count):
        p = torch.zeros(port_odo.SO3_PACK)
        p[0:9] = tt(J @ J.T).reshape(-1)
        p[9:12] = tt(rng.standard_normal(3).astype(np.float32) * 0.01)
        p[12], p[13] = sum_sq, count
        return p
    R0 = carry[0:9].clone()
    port_odo.so3_update(1, pack(4.0, 100.0), carry, active, k)      # ordinary
    R1 = carry[0:9].clone()
    assert int(active) == 1 and not torch.equal(R0, R1)
    assert float(carry[port_odo.S3_ERR]) == np.float32(np.sqrt(np.float32(4.0)) / np.float32(100.0))
    port_odo.so3_update(1, pack(100.0, 100.0), carry, active, k)    # diverged
    assert int(active) == 0 and torch.equal(carry[0:9], R0)
    before = carry.clone()
    port_odo.so3_update(1, pack(1.0, 100.0), carry, active, k)      # after the exit
    assert torch.equal(carry, before)
    # converged: a smaller error at the same count keeps R
    port_odo.so3_update(0, None, carry, active, k)
    port_odo.so3_update(1, pack(4.0, 100.0), carry, active, k)
    R1 = carry[0:9].clone()
    port_odo.so3_update(1, pack(1.0, 100.0), carry, active, k)
    assert int(active) == 0 and torch.equal(carry[0:9], R1)


def test_inactive_steps_and_updates_write_nothing(world):
    """With `active` 0 every step returns before computing and leaves its
    `out` slice as it was, and a Gauss-Newton update leaves its carry's
    state (all but the next iteration's matrices) alone."""
    i, c = world["pairs"][0]["inputs"], world["port_cam"]
    off = torch.zeros(1, dtype=torch.int32)
    pack = torch.full((port_odo.PACK,), float("nan"))
    T = tt(np.asarray(SWEEP[0], np.float32))
    assert port_odo.icp_step(T, i.vmaps_curr[0], i.nmaps_curr[0], T, i.vmaps_prev_g[0],
                             i.nmaps_prev_g[0], c.fx, c.fy, c.cx, c.cy,
                             out=pack[0:44], active=off) is None
    corres = port_odo.compute_rgb_residual(
        0.1, i.last_images[0], i.last_images[0], i.last_depths[0], i.next_depths[0],
        i.last_images[0], i.next_images[0], torch.zeros(3), torch.eye(3),
        out=pack[86:88], active=off)
    assert corres is None
    assert port_odo.rgb_step(corres, None, i.vmaps_curr[0], c.fx, c.fy, i.last_images[0],
                             i.last_images[0], out=pack[44:86], active=off) is None
    so3_pack = torch.full((port_odo.SO3_PACK,), float("nan"))
    assert port_odo.so3_step(i.last_images[2], i.next_images[2], torch.eye(3), torch.eye(3),
                             torch.eye(3), out=so3_pack, active=off) is None
    assert torch.isnan(pack).all() and torch.isnan(so3_pack).all()

    o = port_tracking.gn_options(PortConfig(camera=c))
    k = port_odo.level_k(c)
    carry = torch.zeros(port_odo.GN_CARRY)
    active = torch.zeros(1, dtype=torch.int32)
    port_odo.gn_update(0, None, carry, active, T, None, off, k, o)
    assert int(active) == 0
    before = carry.clone()
    port_odo.gn_update(1, torch.rand(port_odo.PACK), carry, active, T, None, None, k, o,
                       last_of_level=True)
    assert int(active) == 0 and torch.equal(carry, before)


def _engine(**kw):
    cam = both_cams(SMALL_CAM)[1]
    return port_engine.Engine(PortConfig(camera=cam, **kw), device="cpu")


def _drive(eng, frames, *, per_frame=None):
    out = []
    for i, (d, rgb) in enumerate(frames):
        r0, k0 = _device.read_calls, len(eng.ferns.frames) if eng.ferns else 0
        res = eng.process_frame(rgb, d, timestamp=i)
        kept = (len(eng.ferns.frames) if eng.ferns else 0) - k0
        out.append((res, _device.read_calls - r0, kept))
        if per_frame:
            per_frame(eng)
    return out


@pytest.mark.parametrize("close_loops", [False, True])
def test_one_read_a_frame_at_depth_0(world, close_loops):
    """A tracked frame reads the host once (its finish vector), plus one
    read of the decimated views when its finish keeps a fern keyframe; the
    first frame reads its map's count."""
    eng = _engine(closeLoops=close_loops)
    runs = _drive(eng, world["frames"])
    assert [r for _, r, _ in runs] == [1] + [1 + kept for _, _, kept in runs[1:]]
    assert all(res.fused and res.tracking_ok for res, _, _ in runs[1:])


class _NoHostSync(TorchDispatchMode):
    """Fails an operation that a CUDA graph capture refuses or that would
    bake a host value: a read of a tensor's value (item / bool / int /
    float, a 0-d tensor as an index), a data-dependent shape (nonzero, a
    boolean mask as an index), a tensor made from host data (torch.tensor).
    The kernel wrappers' plain versions are let through (`suspended`): on a
    card each of those is one launch."""

    BANNED = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
              torch.ops.aten.masked_select.default, torch.ops.aten.lift_fresh.default,
              torch.ops.aten.unique_consecutive.default, torch.ops.aten._unique2.default}

    def __init__(self):
        super().__init__()
        self.suspended = 0
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.suspended:
            bad = func in self.BANNED
            if func in (torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default,
                        torch.ops.aten.index_put.default):
                bad |= any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                           for t in args[1] if t is not None)
            if bad:
                self.seen.append(str(func))
                raise AssertionError(f"host sync in the frame: {func}")
        return func(*args, **(kwargs or {}))


def _suspending(mode, fn):
    def call(*a, **k):
        mode.suspended += 1
        try:
            return fn(*a, **k)
        finally:
            mode.suspended -= 1
    return call


@pytest.mark.parametrize("kw", [dict(closeLoops=False), dict(closeLoops=True),
                                dict(closeLoops=True, reloc_mode=True)],
                         ids=["plain", "closeLoops", "reloc_mode"])
def test_the_frame_makes_no_host_sync_outside_its_kernels(world, monkeypatch, kw):
    """What the CUDA graph capture needs of `_frame_main`, checked on the
    CPU: with the conds in the device form every one-device frame takes,
    nothing outside the kernel wrappers reads a value, sizes by data, or
    makes a tensor from host data; and the frame's results equal those of
    the host-branching form (the sharded frame's, forced here through
    `_branches_on_host`)."""
    frames = world["frames"]
    mode = _NoHostSync()
    wrappers = [(port_tracking, n) for n in ("icp_step", "compute_rgb_residual", "rgb_step",
                                             "so3_step", "so3_update", "gn_update")]
    wrappers += [(port_splat, "splat_resolve"), (port_fuse, "fuse_window")]
    results = {}
    for on_host in (True, False):
        eng = _engine(**kw)
        eng.process_frame(frames[0][1], frames[0][0], timestamp=0)
        with monkeypatch.context() as m:
            if on_host:
                m.setattr(port_engine, "_branches_on_host", lambda mp: True)
            args = dict(map=eng.map, T=eng._T_f32, so3=eng._so3_hist, pred=eng._pred,
                        fill=eng._fill, dense=eng._dense_dev)
            d = torch.from_numpy(frames[1][0].astype(np.float32))
            rgb = torch.from_numpy(frames[1][1])
            tick = torch.full((), 2.0)
            fern = eng._fern_inputs()
            if not on_host:
                for mod, name in wrappers:
                    m.setattr(mod, name, _suspending(mode, getattr(mod, name)))
            with (mode if not on_host else _Nothing()):
                out = port_engine._frame_main(
                    args["map"], args["T"], args["so3"], args["pred"].vertex,
                    args["pred"].normal, args["pred"].image, *args["fill"], args["dense"],
                    d, rgb, tick, tick, False, torch.full((), 1.0), fern, eng.cfg)
        results[on_host] = out
    assert mode.seen == []
    a, b = results[True], results[False]
    assert torch.equal(a["finish_vec"], b["finish_vec"])
    for x, y in zip(a["map"], b["map"]):
        assert torch.equal(x, y)


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_a_failed_tracking_gate_leaves_the_map_as_it_came(world, monkeypatch):
    """reloc_mode with a covariance limit no frame meets: the gate fails on
    the device, and — as under the reference's `lax.cond` — the map and the
    fused count come out exactly as they went in, in the device form of the
    cond (both branches run, the gate selects) as in the host form (the
    sharded frame's, forced through `_branches_on_host`)."""
    frames = world["frames"]
    for on_host in (True, False):
        eng = _engine(closeLoops=False, reloc_mode=True, reloc_cov_threshold=1e-30)
        eng.process_frame(frames[0][1], frames[0][0], timestamp=0)
        before = [x.clone() for x in eng.map]
        with monkeypatch.context() as m:
            if on_host:
                m.setattr(port_engine, "_branches_on_host", lambda mp: True)
            res = eng.process_frame(frames[1][1], frames[1][0], timestamp=1)
        assert not res.tracking_ok and not res.fused
        for x, y in zip(before, eng.map):
            assert torch.equal(x, y)
