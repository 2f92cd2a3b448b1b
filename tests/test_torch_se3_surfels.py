"""se3, surfels, config, utils and convert of the port against the reference
package on the CPU.  The JAX side is one jitted function per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, nn, tt
from elasticfusion_tpu import config as ref_config
from elasticfusion_tpu import se3 as ref_se3
from elasticfusion_tpu import surfels as ref_surfels
from elasticfusion_tpu.utils import synthetic as ref_syn
from elasticfusion_tpu_torch import config as port_config
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch import se3 as port_se3
from elasticfusion_tpu_torch import surfels as port_surfels
from elasticfusion_tpu_torch.utils import synthetic as port_syn

XI = np.array([0.03, -0.02, 0.05, 0.11, -0.07, 0.04], np.float32)
XI_SMALL = np.array([1e-3, 2e-3, -1e-3, 3e-5, -2e-5, 1e-5], np.float32)   # θ² < 1e-8
T0 = ref_syn.pose_from_xyzrpy(x=0.3, y=-0.1, z=0.2, roll=0.2, pitch=-0.1, yaw=0.3)


@pytest.fixture(scope="module")
def ref_se3_out():
    @jax.jit
    def run(xi, xi_s, T):
        drift = T.at[:3, :3].multiply(1.0 + 1e-4)
        return dict(
            so3_exp=ref_se3.so3_exp(xi[3:]), so3_exp_small=ref_se3.so3_exp(xi_s[3:]),
            se3_exp=ref_se3.se3_exp(xi), se3_exp_small=ref_se3.se3_exp(xi_s),
            apply_update=ref_se3.apply_update(T, xi), invert=ref_se3.invert(T),
            orthonormalize=ref_se3.orthonormalize(drift),
            se3_log_norm=ref_se3.se3_log_norm(T),
            se3_log_rot_norm=ref_se3.se3_log_rot_norm(T),
        )

    return {k: np.asarray(v) for k, v in run(
        jnp.asarray(XI), jnp.asarray(XI_SMALL), jnp.asarray(T0, jnp.float32)).items()}


def _port_se3(name):
    xi, xi_s, T = tt(XI), tt(XI_SMALL), tt(T0)
    drift = T.clone()
    drift[:3, :3] *= 1.0 + 1e-4
    return {
        "so3_exp": lambda: port_se3.so3_exp(xi[3:]),
        "so3_exp_small": lambda: port_se3.so3_exp(xi_s[3:]),
        "se3_exp": lambda: port_se3.se3_exp(xi),
        "se3_exp_small": lambda: port_se3.se3_exp(xi_s),
        "apply_update": lambda: port_se3.apply_update(T, xi),
        "invert": lambda: port_se3.invert(T),
        "orthonormalize": lambda: port_se3.orthonormalize(drift),
        "se3_log_norm": lambda: port_se3.se3_log_norm(T),
        "se3_log_rot_norm": lambda: port_se3.se3_log_rot_norm(T),
    }[name]()


@pytest.mark.parametrize("name", [
    "so3_exp", "so3_exp_small", "se3_exp", "se3_exp_small", "apply_update",
    "invert", "orthonormalize", "se3_log_norm", "se3_log_rot_norm"])
def test_se3_matches_reference(name, ref_se3_out):
    # a handful of float32 operations on O(1) values: atol 2e-6
    np.testing.assert_allclose(nn(_port_se3(name)), ref_se3_out[name], atol=2e-6)


def test_np_helpers_match_reference():
    R = T0[:3, :3]
    q = port_se3.np_rotation_to_quaternion(R)
    np.testing.assert_array_equal(q, ref_se3.np_rotation_to_quaternion(R))
    np.testing.assert_array_equal(port_se3.np_quaternion_to_rotation(q),
                                  ref_se3.np_quaternion_to_rotation(q))
    noisy = T0.copy()
    noisy[:3, :3] *= 1.001
    np.testing.assert_array_equal(port_se3.np_orthonormalize(noisy),
                                  ref_se3.np_orthonormalize(noisy))


# --- config / utils ---------------------------------------------------------


def test_config_fields_and_defaults_are_identical():
    for ref_cls, port_cls in ((ref_config.CameraConfig, port_config.CameraConfig),
                              (ref_config.EngineConfig, port_config.EngineConfig)):
        ref_f = {f.name: f for f in dataclasses.fields(ref_cls)}
        port_f = {f.name: f for f in dataclasses.fields(port_cls)}
        assert list(ref_f) == list(port_f)
    assert dataclasses.asdict(ref_config.EngineConfig()) == \
        dataclasses.asdict(port_config.EngineConfig())
    assert dataclasses.asdict(ref_config.CameraConfig().scaled(2)) == \
        dataclasses.asdict(port_config.CameraConfig().scaled(2))


def test_one_dict_builds_both_configs():
    d = dict(camera=SMALL_CAM, closeLoops=False, confidence_threshold=0.3,
             gn_iterations=[4, 3, 2], initial_surfels=1 << 16)
    port = convert.config_from_dict(d)
    ref = ref_config.EngineConfig(**{**d, "camera": ref_config.CameraConfig(**SMALL_CAM),
                                     "gn_iterations": (4, 3, 2)})
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.with_(so3=False).so3 is False and port.gn_iterations == (4, 3, 2)


def test_synthetic_frames_are_byte_identical():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    ps, cs = port_syn.make_scene(n_side=300, seed=3)
    pr, cr = ref_syn.make_scene(n_side=300, seed=3)
    assert ps.tobytes() == pr.tobytes() and cs.tobytes() == cr.tobytes()
    for kind in ("sweep", "there_back", "orbit"):
        for Tp, Tr in zip(port_syn.synthetic_trajectory(kind, 5),
                          ref_syn.synthetic_trajectory(kind, 5)):
            assert Tp.tobytes() == Tr.tobytes()
    T = port_syn.pose_from_xyzrpy(x=0.05, yaw=0.02, pitch=0.01)
    dp, rp = port_syn.render_frame(ps, cs, T, port_cam)
    dr, rr = ref_syn.render_frame(pr, cr, T, ref_cam)
    assert dp.tobytes() == dr.tobytes() and rp.tobytes() == rr.tobytes()
    da, ra = port_syn.render_analytic(T, port_cam, iters=10)
    db, rb = ref_syn.render_analytic(T, ref_cam, iters=10)
    assert da.tobytes() == db.tobytes() and ra.tobytes() == rb.tobytes()


def test_stopwatch_copy_packs_like_the_reference():
    from elasticfusion_tpu.utils.stopwatch import Stopwatch as RefSW
    from elasticfusion_tpu_torch.utils.stopwatch import Stopwatch as PortSW

    a, b = RefSW(), PortSW()
    for sw in (a, b):
        sw.timings["Run"] = 12.5
        sw.timings["frame"] = 3.25
    assert a.pack() == b.pack()


# --- surfels -----------------------------------------------------------------

CAP = 1 << 15


@pytest.fixture(scope="module")
def surfel_world():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    scene = ref_syn.make_scene(n_side=400)
    depth_mm, rgb = ref_syn.render_frame(scene[0], scene[1], np.eye(4), ref_cam)
    depth_m = np.where(depth_mm < 300, 0, depth_mm).astype(np.float32) / 1000.0
    rng = np.random.default_rng(11)
    keep = rng.uniform(size=CAP) > 0.3
    H, W = ref_cam.height, ref_cam.width

    @jax.jit
    def run(depth_m, rgb, keep):
        u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
        v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
        normal, valid = ref_surfels.central_diff_normals(depth_m, ref_cam)
        m = ref_surfels.init_map_from_frame(CAP, depth_m, depth_m, rgb, ref_cam, 3.0)
        tight = ref_surfels.init_map_from_frame(1000, depth_m, depth_m, rgb, ref_cam, 3.0)
        return dict(
            normal=normal, valid=valid,
            radius=ref_surfels.surfel_radius(depth_m, normal[2], ref_cam),
            confidence=ref_surfels.pixel_confidence(u, v, 0.7, ref_cam),
            init=m, tight=tight, compact=ref_surfels.compact(m, keep),
        )

    out = run(jnp.asarray(depth_m), jnp.asarray(rgb), jnp.asarray(keep))
    return dict(port_cam=port_cam, depth_m=depth_m, rgb=rgb, keep=keep, ref=out)


def _map_equal(got, ref, atol):
    assert int(got.count) == int(ref.count)
    for f in ("pos", "conf", "color", "init_t", "last_t", "normal", "radius"):
        np.testing.assert_allclose(nn(getattr(got, f)), np.asarray(getattr(ref, f)),
                                   atol=atol, err_msg=f)


def test_measurement_model_matches_reference(surfel_world):
    w = surfel_world
    cam, d = w["port_cam"], tt(w["depth_m"])
    normal, valid = port_surfels.central_diff_normals(d, cam)
    np.testing.assert_array_equal(nn(valid), np.asarray(w["ref"]["valid"]))
    np.testing.assert_allclose(nn(normal), np.asarray(w["ref"]["normal"]), atol=1e-5)
    np.testing.assert_allclose(
        nn(port_surfels.surfel_radius(d, tt(np.asarray(w["ref"]["normal"]))[2], cam)),
        np.asarray(w["ref"]["radius"]), rtol=1e-6, atol=1e-9)
    u, v = port_surfels.pixel_grid(cam.height, cam.width, "cpu")
    np.testing.assert_allclose(nn(port_surfels.pixel_confidence(u, v, 0.7, cam)),
                               np.asarray(w["ref"]["confidence"]), atol=1e-6)


@pytest.mark.parametrize("which,cap", [("init", CAP), ("tight", 1000)])
def test_init_map_matches_reference(surfel_world, which, cap):
    w = surfel_world
    got = port_surfels.init_map_from_frame(
        cap, tt(w["depth_m"]), tt(w["depth_m"]), tt(w["rgb"]), w["port_cam"], 3.0)
    assert got.capacity == cap and int(got.count) > 900
    _map_equal(got, w["ref"][which], atol=1e-5)


def test_compact_keeps_order_and_matches_reference(surfel_world):
    w = surfel_world
    m_np = {f: np.asarray(getattr(w["ref"]["init"], f)) for f in w["ref"]["init"]._fields}
    m = convert.surfel_map_from_numpy(m_np, "cpu")
    got = port_surfels.compact(m, tt(w["keep"]))
    _map_equal(got, w["ref"]["compact"], atol=0.0)       # a pure permutation
    n = int(got.count)
    assert 0 < n < int(m.count)
    # creation order survives: positions are the kept columns, in order
    kept = np.nonzero(w["keep"][: int(m.count)])[0]
    np.testing.assert_array_equal(nn(got.pos)[:, :n], m_np["pos"][:, kept])
    assert float(got.conf[n:].abs().sum()) == 0.0


def test_convert_round_trips_and_device_rules(surfel_world):
    m_np = {f: np.asarray(getattr(surfel_world["ref"]["init"], f))
            for f in surfel_world["ref"]["init"]._fields}
    m = convert.surfel_map_from_numpy(m_np, "cpu")
    assert m.count.dtype == torch.int32 and m.pos.dtype == torch.float32
    back = convert.surfel_map_to_numpy(m)
    for f, a in m_np.items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    # NamedTuples of the reference package go in as they are
    m2 = convert.surfel_map_from_numpy(surfel_world["ref"]["init"], "cpu")
    assert torch.equal(m2.pos, m.pos)
    state = dict(T=np.eye(4), so3_hist=np.ones((30, 40)),
                 pred=dict(image=np.zeros((4, 5, 3)), vertex=np.zeros((3, 4, 5)),
                           conf=np.zeros((4, 5)), normal=np.zeros((3, 4, 5)),
                           radius=np.zeros((4, 5)), time=np.zeros((4, 5)),
                           depth=np.zeros((4, 5))),
                 fill=(np.zeros((3, 4, 5)), np.zeros((3, 4, 5)), np.zeros((4, 5, 3))))
    s = convert.engine_state_from_numpy(state, "cpu")
    out = convert.engine_state_to_numpy(s)
    assert out["T"].dtype == np.float32 and out["pred"]["image"].shape == (4, 5, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # no silent fall-back to the CPU
            convert.surfel_map_from_numpy(m_np)
        with pytest.raises(RuntimeError):
            port_surfels.empty_map(16)
    assert port_surfels.empty_map(16, "cpu").capacity == 16
