"""`fx16_tables` on the CPU: the u16 fixed-point ICP model table
(`ops/odometry.icp_prev_table(..., fx16=True)`) and `icp_step` /
the tracker on it, against the reference package, on the rendered 160x120
pair of `tests/test_torch_odometry.py`.

  (i)   the table — words, `los`, `scales` — equals the reference's bit for bit;
  (ii)  `icp_step_plain` on it against the reference's `icp_step` on its
        fx16 table: the Gram blocks within 1e-4 of each block's largest entry
        (`test_torch_odometry._assert_gram`);
  (iii) `get_incremental_transformation` with `fx16_tables=True` against the
        reference's, within 5e-4 m / 5e-4 rad (the f32 solve's bound);
  (iv)  the port's solve with fx16 on against off, within the reference's
        0.5 mm / 0.05 deg (`tests/test_gatherpack.py`);
  (v)   the validity test of the fixed-point form on a constructed 5x5 case:
        a model vertex at exactly zero with a unit normal is accepted (the
        float32 form rejects it), a normal quantized from zero (|n|^2 ~
        scale^2, above the float32 form's 1e-12) is rejected — as in the
        reference, which counts the same pixels.

Every reference call of the module is in ONE `jax.jit`."""

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
from elasticfusion_tpu.utils.synthetic import make_scene, render_frame
from elasticfusion_tpu_torch import tracking as port_tracking
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig
from elasticfusion_tpu_torch.ops import odometry as port_odo
from test_torch_odometry import T_GUESS, T_NEXT, T_PREV, _assert_gram

# the constructed validity case: a 5x5 camera, both poses 5 cm behind the
# world origin, so the centre pixel's current point is the origin itself
VAL_CAM = dict(fx=5.0, fy=5.0, cx=2.0, cy=2.0)
VAL_H = VAL_W = 5
ZERO_VERTEX_PX = (2, 2)          # model vertex exactly (0, 0, 0), unit normal
ZERO_NORMAL_PX = (0, 0)          # model normal exactly (0, 0, 0)
RANGE_PX = {(0, 4): (1.0, 0.0, 0.0), (4, 0): (-1.0, 0.0, 0.0),
            (4, 4): (0.0, 1.0, 0.0), (1, 4): (0.0, -1.0, 0.0)}


def _validity_case():
    """(T, vmap_curr, nmap_curr, vmap_model_world, nmap_model_world): every
    current pixel re-projects onto itself and matches its model pixel; the
    four range-setting model normals (unit x / y) fail the angle gate."""
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.05
    v = np.zeros((3, VAL_H, VAL_W), np.float32)
    for y in range(VAL_H):
        for x in range(VAL_W):
            z = 0.05 if (y, x) == ZERO_VERTEX_PX else 1.0
            v[:, y, x] = ((x - VAL_CAM["cx"]) * z / VAL_CAM["fx"],
                          (y - VAL_CAM["cy"]) * z / VAL_CAM["fy"], z)
    n = np.zeros((3, VAL_H, VAL_W), np.float32)
    n[2] = -1.0
    vg = v.copy()
    vg[2] -= np.float32(0.05)                      # world = camera + t
    assert not vg[:, ZERO_VERTEX_PX[0], ZERO_VERTEX_PX[1]].any()
    ng = n.copy()
    ng[:, ZERO_NORMAL_PX[0], ZERO_NORMAL_PX[1]] = 0.0
    for (y, x), nrm in RANGE_PX.items():
        ng[:, y, x] = nrm
    return T, v, n, vg, ng


@pytest.fixture(scope="module")
def world():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    ref_cfg = RefConfig(camera=ref_cam, closeLoops=False, fx16_tables=True)
    port_cfg = PortConfig(camera=port_cam, closeLoops=False)
    scene = make_scene(n_side=500)
    d0, rgb0 = render_frame(scene[0], scene[1], T_PREV, ref_cam)
    d1, rgb1 = render_frame(scene[0], scene[1], T_NEXT, ref_cam)
    Tp = np.asarray(T_PREV, np.float32)
    Tg = np.asarray(T_GUESS, np.float32)
    val = _validity_case()

    @jax.jit
    def reference(d0, rgb0, d1, rgb1, Tp, Tg, vT, vv, vn, vvg, vng):
        def prep(d):
            f = ref_pp.bilateral_filter(d.astype(jnp.float32), 20.0, 6)
            return ref_pp.metricise_depth(f, 3.0)

        f0, f1 = prep(d0), prep(d1)
        v0 = ref_pp.compute_vmap(f0, ref_cam, 20.0)
        n0 = ref_pp.compute_nmap(v0)
        vm_c, nm_c, im_c, dp_c = ref_tracking.build_current_frame_pyramids(f1, rgb1, ref_cfg)
        vm_g, nm_g, im_m, dp_m = ref_tracking.build_model_pyramids(
            v0, n0, rgb0.astype(jnp.float32), Tp, ref_cfg)
        inputs = ref_tracking.OdometryInputs(
            vmaps_curr=vm_c, nmaps_curr=nm_c, vmaps_prev_g=vm_g, nmaps_prev_g=nm_g,
            last_images=im_m, next_images=im_c, last_depths=dp_m, next_depths=dp_c,
            so3_last_image=im_m[2], T_prev=Tp)
        table = ref_odo.icp_prev_table(vm_g[0], nm_g[0], fx16=True)
        gi = ref_odo.icp_step(Tg, vm_c[0], nm_c[0], Tp, vm_g[0], nm_g[0],
                              ref_cam.fx, ref_cam.fy, ref_cam.cx, ref_cam.cy,
                              prev_table=table)
        val_counts = [
            ref_odo.icp_step(vT, vv, vn, vT, vvg, vng, VAL_CAM["fx"], VAL_CAM["fy"],
                             VAL_CAM["cx"], VAL_CAM["cy"],
                             prev_table=ref_odo.icp_prev_table(vvg, vng, fx16=fx16)).count
            for fx16 in (False, True)]
        return dict(
            inputs=inputs, icp=gi, val_counts=val_counts,
            words=jax.lax.bitcast_convert_type(table[1], jnp.uint32),
            los=table[2], scales=table[3],
            track=ref_tracking.get_incremental_transformation(inputs, ref_cfg),
        )

    out = reference(*[jnp.asarray(a) for a in (d0, rgb0, d1, rgb1, Tp, Tg, *val)])
    inputs_port = port_tracking.OdometryInputs(**{
        f: (tuple(tt(a) for a in v) if isinstance(v, tuple) else tt(v))
        for f, v in out["inputs"]._asdict().items()})
    return dict(port_cam=port_cam, port_cfg=port_cfg, ref=out, inputs=inputs_port,
                Tp=Tp, Tg=Tg, val=val)


def _port_table(w):
    return port_odo.icp_prev_table(w["inputs"].vmaps_prev_g[0],
                                   w["inputs"].nmaps_prev_g[0], fx16=True)


def test_fx16_table_equals_the_references(world):
    tag, words, los, scales = _port_table(world)
    ref = world["ref"]
    assert tag == "fx16" and words.dtype == torch.int32
    assert words.shape == (3, SMALL_CAM["width"] * SMALL_CAM["height"])
    assert np.array_equal(nn(words).view(np.uint32), np.asarray(ref["words"]))
    assert np.array_equal(nn(los), np.asarray(ref["los"]))
    assert np.array_equal(nn(scales), np.asarray(ref["scales"]))


def test_icp_step_on_the_fx16_table_matches_the_references(world):
    w, c = world, world["port_cam"]
    inp = w["inputs"]
    table = _port_table(w)
    got = port_odo.icp_step_plain(tt(w["Tg"]), inp.vmaps_curr[0], inp.nmaps_curr[0],
                                  tt(w["Tp"]), inp.vmaps_prev_g[0], inp.nmaps_prev_g[0],
                                  c.fx, c.fy, c.cx, c.cy, prev_table=table)
    _assert_gram(got, w["ref"]["icp"], 43)
    # the wrapper on CPU tensors is the plain version, `out=` filled
    out = torch.zeros(44)
    again = port_odo.icp_step(tt(w["Tg"]), inp.vmaps_curr[0], inp.nmaps_curr[0],
                              tt(w["Tp"]), inp.vmaps_prev_g[0], inp.nmaps_prev_g[0],
                              c.fx, c.fy, c.cx, c.cy, prev_table=table, out=out)
    assert torch.equal(again.A, got.A) and float(out[43]) == float(got.count)


def test_fx16_solve_matches_the_references(world):
    w = world
    got = port_tracking.get_incremental_transformation(
        w["inputs"], w["port_cfg"].with_(fx16_tables=True))
    ref = w["ref"]["track"]
    Tg, Tr = nn(got.T_curr), np.asarray(ref.T_curr)
    assert np.linalg.norm(Tg[:3, 3] - Tr[:3, 3]) < 5e-4
    assert rot_err(Tg, Tr) < 5e-4
    assert np.linalg.norm(Tg[:3, 3] - T_NEXT[:3, 3]) < 5e-3
    assert abs(float(got.icp_count) - float(ref.icp_count)) <= 0.01 * float(ref.icp_count)


def test_fx16_on_against_off_is_within_the_references_bound(world):
    w = world
    on = nn(port_tracking.get_incremental_transformation(
        w["inputs"], w["port_cfg"].with_(fx16_tables=True)).T_curr).astype(np.float64)
    off = nn(port_tracking.get_incremental_transformation(
        w["inputs"], w["port_cfg"]).T_curr).astype(np.float64)
    assert np.linalg.norm(on[:3, 3] - off[:3, 3]) < 5e-4
    assert rot_err(on, off) < np.deg2rad(0.05)


def test_fixed_point_validity_keeps_zero_vertices_and_drops_zero_normals(world):
    T, v, n, vg, ng = (tt(a) for a in world["val"])
    c = VAL_CAM
    counts = {}
    for fx16 in (False, True):
        table = port_odo.icp_prev_table(vg, ng, fx16=fx16)
        counts[fx16] = float(port_odo.icp_step_plain(
            T, v, n, T, vg, ng, c["fx"], c["fy"], c["cx"], c["cy"],
            prev_table=table).count)
    # 25 pixels: the four range-setting normals fail the angle gate and the
    # zero normal fails validity in both forms; the zero vertex fails the
    # float32 form's |v|^2 > 0 only
    assert counts == {False: 19.0, True: 20.0}
    assert [float(x) for x in world["ref"]["val_counts"]] == [19.0, 20.0]
    # the quantized zero normal is noise above the float32 form's threshold
    from elasticfusion_tpu_torch.ops.gatherpack import gather_fx16

    y, x = ZERO_NORMAL_PX
    dec = gather_fx16(port_odo.icp_prev_table(vg, ng, fx16=True),
                      torch.tensor([y * VAL_W + x]))
    n2 = sum(float(d[0]) ** 2 for d in dec[3:6])
    assert 1e-12 < n2 < 1e-2
