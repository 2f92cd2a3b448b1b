"""ops/odometry and tracking parity on the CPU: every step's normal-equation
floats (A 6x6, b 6, Σr², count — the 29 + 1 of ICP and RGB, the 11 + 1 of
SO(3)) and the pack layouts the tracker reads, the small solves, and a whole tracking solve against the reference,
all on one pair of rendered 160x120 frames.  The reference side is one jitted
function for the steps and the reference's own jitted tracker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, nn, rot_err, tt
from elasticfusion_tpu import tracking as ref_tracking
from elasticfusion_tpu.config import EngineConfig as RefConfig
from elasticfusion_tpu.ops import odometry as ref_odo
from elasticfusion_tpu.ops import preprocess as ref_pp
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import _device
from elasticfusion_tpu_torch import tracking as port_tracking
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig
from elasticfusion_tpu_torch.ops import odometry as port_odo

T_PREV = pose_from_xyzrpy(x=0.02, yaw=0.01)
T_NEXT = pose_from_xyzrpy(x=0.035, y=0.004, yaw=0.018, pitch=-0.004)
# the pose the steps are linearised at: between the two, so residuals are real
T_GUESS = pose_from_xyzrpy(x=0.03, yaw=0.015)


@pytest.fixture(scope="module")
def world():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    ref_cfg = RefConfig(camera=ref_cam, closeLoops=False)
    port_cfg = PortConfig(camera=port_cam, closeLoops=False)
    scene = make_scene(n_side=500)
    d0, rgb0 = render_frame(scene[0], scene[1], T_PREV, ref_cam)
    d1, rgb1 = render_frame(scene[0], scene[1], T_NEXT, ref_cam)
    Tp = np.asarray(T_PREV, np.float32)
    Tg = np.asarray(T_GUESS, np.float32)
    c = SMALL_CAM
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    Rt = np.linalg.inv(np.linalg.inv(T_PREV) @ T_GUESS).astype(np.float32)
    krkinv = (K @ Rt[:3, :3] @ Kinv).astype(np.float32)
    kt = (K @ Rt[:3, 3]).astype(np.float32)
    c2 = ref_cam.scaled(2)
    K2 = np.array([[c2.fx, 0, c2.cx], [0, c2.fy, c2.cy], [0, 0, 1]], np.float32)
    K2inv = np.linalg.inv(K2.astype(np.float64)).astype(np.float32)
    Rso3 = np.asarray(pose_from_xyzrpy(yaw=0.004, pitch=0.002), np.float32)[:3, :3]
    basis = (K2 @ Rso3 @ K2inv).astype(np.float32)
    krlr = (K2 @ Rso3).astype(np.float32)
    rng = np.random.default_rng(5)
    J = rng.standard_normal((6, 40)).astype(np.float32)
    A6 = (J @ J.T).astype(np.float32)
    b6 = rng.standard_normal(6).astype(np.float32)
    A3, b3 = A6[:3, :3].copy(), b6[:3].copy()
    min_grad2 = 25.0 / (ref_pp.SOBEL_SCALE ** 2)

    @jax.jit
    def reference(d0, rgb0, d1, rgb1, Tp, Tg, krkinv, kt, basis, K2inv, krlr,
                  A6, b6, A3, b3):
        def prep(d):
            f = ref_pp.bilateral_filter(d.astype(jnp.float32), 20.0, 6)
            return ref_pp.metricise_depth(f, 3.0)

        f0, f1 = prep(d0), prep(d1)
        # the "model prediction" is frame 0 itself, in its camera frame
        v0 = ref_pp.compute_vmap(f0, ref_cam, 20.0)
        n0 = ref_pp.compute_nmap(v0)
        vm_c, nm_c, im_c, dp_c = ref_tracking.build_current_frame_pyramids(f1, rgb1, ref_cfg)
        vm_g, nm_g, im_m, dp_m = ref_tracking.build_model_pyramids(
            v0, n0, rgb0.astype(jnp.float32), Tp, ref_cfg)
        inputs = ref_tracking.OdometryInputs(
            vmaps_curr=vm_c, nmaps_curr=nm_c, vmaps_prev_g=vm_g, nmaps_prev_g=nm_g,
            last_images=im_m, next_images=im_c, last_depths=dp_m, next_depths=dp_c,
            so3_last_image=im_m[2], T_prev=Tp)
        gi = ref_odo.icp_step(Tg, vm_c[0], nm_c[0], Tp, vm_g[0], nm_g[0],
                              ref_cam.fx, ref_cam.fy, ref_cam.cx, ref_cam.cy)
        dIdx, dIdy = ref_pp.compute_derivatives(im_c[0])
        cloud = ref_odo.project_to_point_cloud(dp_m[0], ref_cam.fx, ref_cam.fy,
                                               ref_cam.cx, ref_cam.cy)
        corres = ref_odo.compute_rgb_residual(
            min_grad2, dIdx, dIdy, dp_m[0], dp_c[0], im_m[0], im_c[0], kt, krkinv)
        sigma = jnp.sqrt(corres.count)
        gr = ref_odo.rgb_step(corres, sigma, cloud, ref_cam.fx, ref_cam.fy, dIdx, dIdy)
        gs = ref_odo.so3_step(im_m[2], im_c[2], basis, K2inv, krlr)
        return dict(
            inputs=inputs, dIdx=dIdx, dIdy=dIdy, cloud=cloud, sigma=sigma,
            icp=gi, rgb=gr, so3=gs,
            corres_count=corres.count, corres_sigma=corres.sigma_sum,
            corres_valid=corres.valid, corres_diff=corres.diff,
            solve6=ref_odo.solve_6x6(A6, b6), solve3=ref_odo.solve_3x3(A3, b3),
        )

    out = reference(*[jnp.asarray(a) for a in (
        d0, rgb0, d1, rgb1, Tp, Tg, krkinv, kt, basis, K2inv, krlr, A6, b6, A3, b3)])
    track = ref_tracking.get_incremental_transformation(out["inputs"], ref_cfg)
    inputs_port = port_tracking.OdometryInputs(**{
        f: (tuple(tt(a) for a in v) if isinstance(v, tuple) else tt(v))
        for f, v in out["inputs"]._asdict().items()})
    return dict(port_cam=port_cam, port_cfg=port_cfg, ref=out, track=track,
                inputs=inputs_port, Tp=Tp, Tg=Tg, krkinv=krkinv, kt=kt, basis=basis,
                K2inv=K2inv, krlr=krlr, A6=A6, b6=b6, A3=A3, b3=b3, min_grad2=min_grad2)


def _assert_gram(got, ref, n_floats):
    """The step's floats against the reference: 1e-4 of the largest entry of
    each block (float32 sums over 19200 pixels in another order).  The inlier
    count is exact up to pixels on a gate's edge (<= 0.1 %); where it does
    differ, each such pixel moves the sums too, and the bound is 1e-3."""
    A, b = nn(got.A), nn(got.b)
    assert A.size + b.size + 1 == n_floats
    assert float(ref.count) > 1000, "step found too few pixels to be a test"
    assert abs(float(got.count) - float(ref.count)) <= 1e-3 * float(ref.count)
    rel = 1e-4 if float(got.count) == float(ref.count) else 1e-3
    for g, r in ((A, np.asarray(ref.A)), (b, np.asarray(ref.b)),
                 (nn(got.sum_sq), np.asarray(ref.sum_sq))):
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * max(np.abs(r).max(), 1e-12))


def test_icp_step_29_floats(world):
    w, i, c = world, world["inputs"], world["port_cam"]
    got = port_odo.icp_step(tt(w["Tg"]), i.vmaps_curr[0], i.nmaps_curr[0], tt(w["Tp"]),
                            i.vmaps_prev_g[0], i.nmaps_prev_g[0], c.fx, c.fy, c.cx, c.cy)
    _assert_gram(got, w["ref"]["icp"], 43)   # 36 + 6 + 1: 29 distinct


def test_rgb_residual_and_step_29_floats(world):
    w, i, c = world, world["inputs"], world["port_cam"]
    r = w["ref"]
    dIdx, dIdy = tt(r["dIdx"]), tt(r["dIdy"])
    corres = port_odo.compute_rgb_residual(
        w["min_grad2"], dIdx, dIdy, i.last_depths[0], i.next_depths[0],
        i.last_images[0], i.next_images[0], tt(w["kt"]), tt(w["krkinv"]))
    assert float(r["corres_count"]) > 1000
    # a reprojection that lands within rounding of x.5 may pick the next pixel
    assert abs(float(corres.count) - float(r["corres_count"])) <= 1e-3 * float(r["corres_count"])
    assert (nn(corres.valid) != np.asarray(r["corres_valid"])).mean() < 1e-3
    np.testing.assert_allclose(float(corres.sigma_sum), float(r["corres_sigma"]), rtol=2e-3)
    got = port_odo.rgb_step(corres, tt(r["sigma"]), tt(r["cloud"]), c.fx, c.fy, dIdx, dIdy)
    _assert_gram(got, r["rgb"], 43)


def test_plain_path_fills_the_pack_in_the_tracker_s_layout(world):
    """`out=` slices of one 88-float buffer, as `tracking.py` passes them:
    ICP A|b|Σr²|count at 0|36|42|43, RGB A|b at 44|80, Σdiff²|count at 86|87."""
    w, i, c = world, world["inputs"], world["port_cam"]
    dIdx, dIdy = tt(w["ref"]["dIdx"]), tt(w["ref"]["dIdy"])
    pack = torch.full((88,), float("nan"))
    gi = port_odo.icp_step(tt(w["Tg"]), i.vmaps_curr[0], i.nmaps_curr[0], tt(w["Tp"]),
                           i.vmaps_prev_g[0], i.nmaps_prev_g[0], c.fx, c.fy, c.cx, c.cy,
                           out=pack[0:44])
    corres = port_odo.compute_rgb_residual(
        w["min_grad2"], dIdx, dIdy, i.last_depths[0], i.next_depths[0],
        i.last_images[0], i.next_images[0], tt(w["kt"]), tt(w["krkinv"]),
        out=pack[86:88])
    gr = port_odo.rgb_step(corres, None, tt(w["ref"]["cloud"]), c.fx, c.fy, dIdx, dIdy,
                           out=pack[44:86])
    got = nn(pack)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0:36].reshape(6, 6), nn(gi.A))
    np.testing.assert_array_equal(got[36:42], nn(gi.b))
    assert got[42] == float(gi.sum_sq) and got[43] == float(gi.count)
    np.testing.assert_array_equal(got[44:80].reshape(6, 6), nn(gr.A))
    np.testing.assert_array_equal(got[80:86], nn(gr.b))
    assert got[86] == float(corres.sigma_sum) and got[87] == float(corres.count)
    # sigma=None is the reference's sqrt(count) on this frame
    _assert_gram(gr, w["ref"]["rgb"], 43)
    # the same calls without `out` return the same numbers
    plain = port_odo.icp_step_plain(
        tt(w["Tg"]), i.vmaps_curr[0], i.nmaps_curr[0], tt(w["Tp"]),
        i.vmaps_prev_g[0], i.nmaps_prev_g[0], c.fx, c.fy, c.cx, c.cy)
    np.testing.assert_array_equal(nn(plain.A), nn(gi.A))


@pytest.mark.parametrize("count,sigma_sum,want", [
    (0.0, 0.0, 0.0),          # no correspondence at all
    (0.0, 7.5, 0.0),
    (1234.0, 0.0, 1.0),       # identical images: sqrt(1)
    (1234.0, 98.5, np.sqrt(np.float32(1234.0))),   # ordinary: sqrt(count)
])
def test_rgb_sigma_val_keeps_the_reference_quirk(count, sigma_sum, want):
    got = port_odo.rgb_sigma_val(torch.tensor(count), torch.tensor(sigma_sum))
    assert got.dtype == torch.float32 and float(got) == np.float32(want)


def test_icp_step_plain_rejects_a_projection_beyond_every_integer():
    """A vertex with a tiny positive z projects to ~1e22 pixels, which no
    integer type holds; it must count as outside the image (the kernel tests
    the bounds on the float for the same reason), and the sums stay finite."""
    H, W, f = 6, 8, 10.0
    cx, cy = (W - 1) / 2, (H - 1) / 2
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    vmap = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)]).astype(np.float32)
    nmap = np.zeros_like(vmap)
    nmap[2] = -1.0
    eye = torch.eye(4)

    def step(vm):
        return port_odo.icp_step_plain(eye, tt(vm), tt(nmap), eye, tt(vmap), tt(nmap),
                                       f, f, cx, cy)

    assert float(step(vmap).count) == H * W
    for z in (1e-20, 1e-36):
        bad = vmap.copy()
        bad[:, 2, 3] = (1.0, 0.5, z)
        g = step(bad)
        assert float(g.count) == H * W - 1
        assert np.isfinite(nn(g.A)).all() and np.isfinite(nn(g.b)).all()


def test_so3_step_11_floats(world):
    w, i = world, world["inputs"]
    got = port_odo.so3_step(i.last_images[2], i.next_images[2], tt(w["basis"]),
                            tt(w["K2inv"]), tt(w["krlr"]))
    _assert_gram(got, w["ref"]["so3"], 13)


def test_so3_step_fills_the_pack_in_the_tracker_s_layout(world):
    """`out=` a 14-float buffer, as `tracking._so3_prealign` passes it:
    A (row-major 3x3) | b | Σr² | count at 0|9|12|13, the same numbers the
    call returns, and still the reference's step."""
    w, i = world, world["inputs"]
    args = (i.last_images[2], i.next_images[2], tt(w["basis"]), tt(w["K2inv"]),
            tt(w["krlr"]))
    pack = torch.full((14,), float("nan"))
    g = port_odo.so3_step(*args, out=pack)
    got = nn(pack)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0:9].reshape(3, 3), nn(g.A))
    np.testing.assert_array_equal(got[9:12], nn(g.b))
    assert got[12] == float(g.sum_sq) and got[13] == float(g.count)
    plain = port_odo.so3_step_plain(*args)
    for x, y in zip(g, plain):
        np.testing.assert_array_equal(nn(x), nn(y))
    _assert_gram(g, w["ref"]["so3"], 13)


def test_small_solves_match_reference(world):
    w = world
    x6 = port_odo.solve_6x6(tt(w["A6"]), tt(w["b6"]))
    x3 = port_odo.solve_3x3(tt(w["A3"]), tt(w["b3"]))
    assert x6.dtype == torch.float32 and x3.dtype == torch.float32
    # the same unrolled float32 arithmetic; rsqrt may differ in its last bit
    np.testing.assert_allclose(nn(x6), np.asarray(w["ref"]["solve6"]), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(nn(x3), np.asarray(w["ref"]["solve3"]), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(w["A6"].astype(np.float64) @ nn(x6), w["b6"], atol=1e-3)


def test_solve_6x6_survives_an_empty_frame():
    """No valid pixel: A = 0, b = 0 — the damping keeps the solve finite."""
    x = nn(port_odo.solve_6x6(torch.zeros((6, 6)), torch.zeros(6)))
    assert np.isfinite(x).all() and np.abs(x).max() == 0.0


def test_tracking_solve_matches_reference(world):
    """Iteration counts may differ by one where ‖update‖ sits at the exit
    threshold (3e-4), so the tolerance is on the pose: 5e-4 m / 5e-4 rad
    between the two packages, and both within 5 mm of the rendered pose."""
    w = world
    reads0 = _device.host_reads
    got = port_tracking.get_incremental_transformation(w["inputs"], w["port_cfg"])
    assert _device.host_reads == reads0        # CPU tensors: nothing to sync
    ref = w["track"]
    Tg, Tr = nn(got.T_curr), np.asarray(ref.T_curr)
    assert np.linalg.norm(Tg[:3, 3] - Tr[:3, 3]) < 5e-4
    assert rot_err(Tg, Tr) < 5e-4
    assert np.linalg.norm(Tg[:3, 3] - T_NEXT[:3, 3]) < 5e-3
    assert np.linalg.norm(Tr[:3, 3] - T_NEXT[:3, 3]) < 5e-3
    assert abs(float(got.icp_count) - float(ref.icp_count)) <= 0.01 * float(ref.icp_count)
    np.testing.assert_allclose(float(got.icp_error), float(ref.icp_error), rtol=0.05)
    assert got.A.shape == (6, 6) and got.b.shape == (6,)


def _count_updates(monkeypatch):
    """Count the tracker's update launches (plain versions on the CPU)."""
    calls = {"so3_update": [], "gn_update": []}
    for name in calls:
        real = getattr(port_tracking, name)
        monkeypatch.setattr(port_tracking, name,
                            lambda *a, _n=name, _r=real, **k: (calls[_n].append(a[0]),
                                                               _r(*a, **k))[1])
    return calls


def test_tracking_reads_back_once_per_iteration(world, monkeypatch):
    """The solve reads nothing back: its loops are fixed sequences of
    updates on the device — one SO(3) start and one update per SO(3)
    iteration of the budget, one Gauss-Newton start, one update per
    iteration of the (10, 5, 4) budget and one finish."""
    calls = _count_updates(monkeypatch)
    cfg = world["port_cfg"]
    reads0 = _device.read_calls
    port_tracking.get_incremental_transformation(world["inputs"], cfg)
    assert _device.read_calls == reads0
    assert calls["so3_update"] == [0] + [1] * cfg.so3_iterations
    assert calls["gn_update"] == [0] + [1] * sum(cfg.gn_iterations) + [2]


def test_tracking_raises_for_unported_tables(world, monkeypatch):
    """`fx16_tables` once raised here; the tracker now runs on the u16
    fixed-point model tables, reads nothing back and runs the whole
    iteration budget as on the float32 ones, and lands within 5 mm of the
    rendered pose
    (tests/test_torch_fx16_tables.py holds it against the reference)."""
    calls = _count_updates(monkeypatch)
    cfg = world["port_cfg"].with_(fx16_tables=True)
    reads0 = _device.read_calls
    got = port_tracking.get_incremental_transformation(world["inputs"], cfg)
    assert _device.read_calls == reads0
    assert len(calls["gn_update"]) == sum(cfg.gn_iterations) + 2
    assert np.linalg.norm(nn(got.T_curr)[:3, 3] - T_NEXT[:3, 3]) < 5e-3
