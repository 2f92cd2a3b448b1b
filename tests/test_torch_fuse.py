"""K3 and ops/fuse parity on the CPU.

The port's plain window search goes against the reference Pallas kernel in
interpret mode, and `fuse` + `clean` against the reference functions, on the
one-tile scene of tests/test_fuse_pallas.py (merges, a hole, appends).  The
CUDA kernel cannot run here: `chip_smoke.py` holds it against the plain
version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import TILE_CAM, both_cams, nn, tt
from _torch_kernels import kernel_calls  # noqa: F401
from elasticfusion_tpu.ops import fuse as ref_fuse
from elasticfusion_tpu.ops.fuse_pallas import fuse_window as ref_fuse_window
from elasticfusion_tpu.ops.splat import predict_indices as ref_predict_indices
from elasticfusion_tpu.surfels import (
    central_diff_normals as ref_normals,
    init_map_from_frame as ref_init_map,
    pixel_confidence as ref_confidence,
    surfel_radius as ref_radius,
)
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch.ops import fuse as port_fuse
from elasticfusion_tpu_torch.ops.fuse_window import fuse_window, fuse_window_plain

CAP = 1 << 13
TICK = 2.0
STALE_TICK, STALE_CONF = 30.0, 1.2


ROT = np.array([[0.999, -0.04, 0.02], [0.04, 0.999, 0.01], [-0.02, -0.01, 0.9997]],
               np.float32)
PARAMS = np.concatenate([ROT.reshape(-1), [0.1, -0.2, 0.05]]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """Everything the reference computes comes from ONE jitted function: the
    first-frame map, its index prediction, K3's input channels, the Pallas
    kernel in interpret mode, `fuse` and both flavours of `clean`."""
    ref_cam, port_cam = both_cams(TILE_CAM)
    H, W = ref_cam.height, ref_cam.width
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth0 = 1.5 + 0.3 * np.sin(xx / 19.0) + 0.2 * np.cos(yy / 9.0)
    depth1 = depth0 + 0.004 * np.sin(xx / 7.0)
    depth1[:, :16] = 0.0        # a hole: measuring=False there
    depth1[:, 96:] = 0.9        # new surface: fails the 5 cm gate -> appends
    rng = np.random.default_rng(7)
    rgb0 = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    rgb1 = np.clip(rgb0.astype(np.int32) + rng.integers(-20, 20, rgb0.shape),
                   0, 255).astype(np.uint8)
    T = np.eye(4, dtype=np.float32)
    c = TILE_CAM

    @jax.jit
    def reference(depth0, rgb0, depth1, rgb1, T, params):
        m = ref_init_map(CAP, depth0, depth0, rgb0, ref_cam, 3.0)
        tick = jnp.float32(TICK)
        pred = ref_predict_indices(m, T, ref_cam, tick, 200, 20.0)
        chan = _window_inputs(ref_cam, pred, depth1, rgb1)
        window = ref_fuse_window(chan, params, c["fx"], c["fy"], c["cx"], c["cy"],
                                 CAP, interpret=True)
        m2, stats, upd = ref_fuse.fuse(
            m, pred, T, tick, rgb1, depth1, depth1, ref_cam, 20.0, jnp.float32(1.0),
            return_updated_pred=True, use_pallas=True)
        m3 = ref_fuse.clean(m2, upd, T, tick, ref_cam, 0.5, 200, 20.0, 20,
                            do_compact=True)
        m3n = ref_fuse.clean(m2, upd, T, tick, ref_cam, 0.5, 200, 20.0, 20,
                             do_compact=False)
        # 28 ticks later with a threshold between merged and unmerged
        # confidences: the stale-unstable rule culls part of the map
        m3s = ref_fuse.clean(m2, upd, T, jnp.float32(STALE_TICK), ref_cam, STALE_CONF,
                             200, 20.0, 20, do_compact=True)
        return m, pred, chan, window, (m2, stats, upd, m3, m3n, m3s)

    m, pred, chan, window, run = reference(
        jnp.asarray(depth0), jnp.asarray(rgb0), jnp.asarray(depth1.astype(np.float32)),
        jnp.asarray(rgb1), jnp.asarray(T), jnp.asarray(PARAMS))
    to_np = lambda t: {f: np.asarray(getattr(t, f)) for f in t._fields}  # noqa: E731
    return dict(
        ref_cam=ref_cam, port_cam=port_cam, depth1=depth1.astype(np.float32),
        rgb1=rgb1, T=T, m_ref_np=to_np(m), chan=np.array(chan),
        window=np.asarray(window), ref_run=run,
        m_port=convert.surfel_map_from_numpy(to_np(m), "cpu"),
        pred_port=convert.index_prediction_from_numpy(to_np(pred), "cpu"),
    )


@pytest.fixture(scope="module")
def ref_run(scene):
    return scene["ref_run"]


def _window_inputs(cam, pred, z, rgb1):
    """chan [18,H,W] as the reference `fuse` assembles it (traced)."""
    H, W = cam.height, cam.width
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    n_local, n_valid = ref_normals(z, cam)
    rad_new = ref_radius(z, n_local[2], cam)
    conf_new = ref_confidence(u, v, 1.0, cam)
    par = int(TICK) % 2
    sub = ((u.astype(jnp.int32) % 2) == par) & ((v.astype(jnp.int32) % 2) == par)
    zp = jnp.pad(z, 1)
    nb_ok = ((zp[1:-1, :-2] > 0) & (zp[:-2, 1:-1] > 0) & (zp[1:-1, 2:] > 0)
             & (zp[2:, 1:-1] > 0))
    measuring = sub & nb_ok & (z > 0) & (z <= 20.0) & n_valid
    return jnp.concatenate([
        (pred.index + 1).astype(jnp.float32)[None], pred.vert, pred.normal,
        pred.radius[None], z[None], n_local, measuring.astype(jnp.float32)[None],
        conf_new[None], rad_new[None],
        jnp.moveaxis(rgb1.astype(jnp.float32), -1, 0)], axis=0)


def test_fuse_window_plain_vs_pallas_interpret(scene):
    chan, params, ref = scene["chan"], PARAMS, scene["window"]
    c = TILE_CAM
    got = nn(fuse_window_plain(tt(chan), tt(params), c["fx"], c["fy"], c["cx"], c["cy"], CAP))
    assert (ref[3] > 0).sum() > 50 and ((chan[12] > 0) & (ref[3] == 0)).sum() > 10
    # association decisions exact: best_id, best_off, matched
    for k in (0, 1, 3):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"channel {k}")
    # best_rad and the 12 contribution images: float32 sums of <= 9 terms in
    # the same order, atol 1e-5 (colour contributions reach 255, hence rtol)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6)
    np.testing.assert_allclose(got[4:], ref[4:], rtol=1e-5, atol=1e-5)


def test_fuse_window_wrapper_takes_plain_on_cpu(scene, kernel_calls):
    chan, params = scene["chan"], PARAMS
    c = TILE_CAM
    a = fuse_window(tt(chan), tt(params), c["fx"], c["fy"], c["cx"], c["cy"], CAP)
    b = fuse_window_plain(tt(chan), tt(params), c["fx"], c["fy"], c["cx"], c["cy"], CAP)
    np.testing.assert_array_equal(nn(a), nn(b))
    assert kernel_calls == []
    with pytest.raises(ValueError):     # ids must stay exact in float32
        fuse_window(tt(chan), tt(params), c["fx"], c["fy"], c["cx"], c["cy"], 1 << 24)
    with pytest.raises(ValueError):
        fuse_window(tt(chan[:17]), tt(params), c["fx"], c["fy"], c["cx"], c["cy"], CAP)


@pytest.fixture(scope="module")
def port_run(scene):
    m2, stats, upd = port_fuse.fuse(
        scene["m_port"], scene["pred_port"], tt(scene["T"]), TICK, tt(scene["rgb1"]),
        tt(scene["depth1"]), tt(scene["depth1"]), scene["port_cam"], 20.0, 1.0,
        return_updated_pred=True)
    args = (m2, upd, tt(scene["T"]), TICK, scene["port_cam"], 0.5, 200, 20.0, 20)
    stale = (m2, upd, tt(scene["T"]), STALE_TICK, scene["port_cam"], STALE_CONF, 200,
             20.0, 20)
    return (m2, stats, upd, port_fuse.clean(*args, do_compact=True),
            port_fuse.clean(*args, do_compact=False),
            port_fuse.clean(*stale, do_compact=True))


def _assert_maps_close(got, ref, n):
    for f in ("pos", "conf", "color", "init_t", "last_t", "normal", "radius"):
        a, b = nn(getattr(got, f))[..., :n], nn(getattr(ref, f))[..., :n]
        # colours are 0..255: atol 1e-5 on unit-scale fields, rtol 1e-5 above
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)


def test_fuse_matches_reference(ref_run, port_run):
    m_r, s_r, u_r = ref_run[:3]
    m_p, s_p, u_p = port_run[:3]
    assert int(s_r.matched) > 50 and int(s_r.added) > 10
    assert int(s_p.matched) == int(s_r.matched)
    assert int(s_p.added) == int(s_r.added)
    assert int(s_p.count) == int(s_r.count)
    _assert_maps_close(m_p, m_r, int(s_r.count))
    np.testing.assert_array_equal(nn(u_p.index), nn(u_r.index))
    for f in ("vert", "normal", "radius", "conf", "init_t", "last_t"):
        np.testing.assert_allclose(nn(getattr(u_p, f)), nn(getattr(u_r, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("which", ["compact", "mark_dead", "stale_compact"])
def test_clean_matches_reference(ref_run, port_run, which):
    i = {"compact": 3, "mark_dead": 4, "stale_compact": 5}[which]
    m_r, m_p = ref_run[i], port_run[i]
    assert int(m_p.count) == int(m_r.count)
    if which == "stale_compact":
        assert 100 < int(m_r.count) < int(ref_run[1].count) - 100, "no partial cull"
    n = int(m_r.count)
    fin = np.isfinite(nn(m_r.init_t)[:n])          # dead-in-place rows hold +inf
    np.testing.assert_array_equal(np.isfinite(nn(m_p.init_t)[:n]), fin)
    for f in ("pos", "conf", "color", "last_t", "normal", "radius"):
        a, b = nn(getattr(m_p, f))[..., :n], nn(getattr(m_r, f))[..., :n]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(nn(m_p.init_t)[:n][fin], nn(m_r.init_t)[:n][fin])


def test_fuse_leaves_its_input_map_untouched(scene, port_run):
    m0 = scene["m_port"]
    for f, a in convert.surfel_map_to_numpy(m0).items():
        np.testing.assert_array_equal(a, scene["m_ref_np"][f], err_msg=f)


def test_clean_raises_for_the_unported_fixed_point_patch(scene, port_run):
    """The u16 fixed-point patch is ported now (held against the reference's
    in tests/test_torch_fx16.py): on this frame it makes the exact patch's
    decisions, and the surviving rows are the exact patch's."""
    m2, _, upd = port_run[:3]
    args = (m2, upd, tt(scene["T"]), TICK, scene["port_cam"], 0.5, 200, 20.0, 20)
    fx16 = port_fuse.clean(*args, fx16_patch=True)
    exact = port_fuse.clean(*args)
    assert int(fx16.count) == int(exact.count) > 0
    for f, a in convert.surfel_map_to_numpy(fx16).items():
        np.testing.assert_array_equal(a, convert.surfel_map_to_numpy(exact)[f], err_msg=f)


def _kernel_constant(name):
    """A `#define` of csrc/fuse_window.cu (a float literal, or a product of
    literals and other such defines) as the float32 the kernel computes,
    multiplied left to right."""
    import os
    import re
    src = os.path.join(os.path.dirname(port_fuse.__file__), "..", "csrc",
                       "fuse_window.cu")
    with open(src, encoding="utf-8") as f:
        defines = dict(re.findall(r"#define (EF_\w+) ([^/\n]+)", f.read()))
    value = None
    for term in defines[name].strip().strip("()").split("*"):
        term = term.strip()
        x = (_kernel_constant(term) if term in defines
             else np.float32(float(term.rstrip("f"))))
        value = x if value is None else np.float32(value * x)
    return value


def test_k3_squared_sum_shortcuts_decide_as_the_plain_divisions():
    """K3 settles `sqrt(sq)/lam < sqrt(best_sq)/lam` (or < 1000) and the
    normal test `nn / max(sqrt(ncn)*sqrt(nl_sq), 1e-12) > cos(0.5)` on
    squared sums with margins; emulated in float32 (every operation rounded
    as on the card, no FMA), the shortcuts never disagree with the plain
    version's roundings — also for sums within a few ulps of a tie."""
    f32 = np.float32
    shrink = _kernel_constant("EF_SQ_SHRINK")
    cos = _kernel_constant("EF_COS_HALF")
    hi, lo = _kernel_constant("EF_COS2_HI"), _kernel_constant("EF_COS2_LO")
    rng = np.random.default_rng(11)
    n = 200_000
    lam = (1 + rng.random(n)).astype(f32)
    best = (10.0 ** rng.uniform(-36, 7, n)).astype(f32)
    # sums from far below the best one's to a few ulps under it
    k = rng.integers(1, 4000, n)
    sq = np.where(rng.random(n) < 0.5, best * f32(1 - 2.0 ** -24) ** k,
                  best * rng.random(n).astype(f32)).astype(f32)
    sq = np.minimum(sq, np.nextafter(best, f32(0)))
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        exact = (np.sqrt(sq) / lam) < (np.sqrt(best) / lam)
        fast = (best >= f32(1e-30)) & (sq < best * shrink)
        assert not (fast & ~exact).any()
        far = lam * lam * f32(1e6) * f32(0.999)
        none_yet = (sq < far) & ~((np.sqrt(sq) / lam) < f32(1000))
        assert not none_yet.any()

        ncn = (10.0 ** rng.uniform(-12, 6, n)).astype(f32)
        nl_sq = (10.0 ** rng.uniform(-12, 6, n)).astype(f32)
        denom = np.maximum(np.sqrt(ncn) * np.sqrt(nl_sq), f32(1e-12))
        # quotients from far off the threshold to a few ulps around it
        q = np.where(rng.random(n) < 0.5,
                     float(cos) * (1 + rng.integers(-3000, 3000, n) * 2.0 ** -24),
                     rng.uniform(-2, 2, n)).astype(f32)
        nn = (q * denom).astype(f32)
        plain = nn / denom > cos
        p, nn2 = ncn * nl_sq, nn * nn
        settled = (nn > 0) & (p >= f32(1e-20)) & (p <= f32(1e30)) & (nn2 <= f32(1e30))
        says_yes = settled & (nn2 > hi * p)
        says_no = (~(nn > 0)) | (settled & (nn2 < lo * p))
    assert not (says_yes & ~plain).any() and not (says_no & plain).any()
    # the shortcuts decide most cases (else they would save nothing)
    assert fast.mean() > 0.4 and (says_yes | says_no).mean() > 0.9
