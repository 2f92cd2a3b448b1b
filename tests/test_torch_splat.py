"""K2 and ops/splat parity on the CPU.

The port's plain splat-resolve goes against the reference Pallas kernel in
interpret mode on the winner channels of a plausible surfel map; the point
raster, `predict_indices` and `combined_predict` go against the reference
functions, including a constructed raster tie.  The CUDA kernel cannot run
here: `chip_smoke.py` holds it against the plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import SMALL_CAM, both_cams, frac_differing, nn, tt
from _torch_kernels import kernel_calls  # noqa: F401
from elasticfusion_tpu.ops import splat as ref_splat
from elasticfusion_tpu.ops.preprocess import metricise_depth as ref_metricise
from elasticfusion_tpu.ops.splat_pallas import splat_resolve as ref_splat_resolve
from elasticfusion_tpu.surfels import SurfelMap as RefMap
from elasticfusion_tpu.surfels import init_map_from_frame as ref_init_map
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch.ops import splat as port_splat
from elasticfusion_tpu_torch.ops.splat_resolve import splat_resolve, splat_resolve_plain

KW = dict(time=5.0, max_time=5.0, time_delta=200, conf_threshold=0.5, max_depth=20.0)


@pytest.fixture(scope="module")
def world():
    """The scene of tests/test_splat_pallas.py: a map back-projected from a
    rendered frame, confidences aged so the threshold gate has both outcomes,
    seen from a slightly moved camera.  Everything the reference computes
    (the map, K2's input channels, the Pallas kernel in interpret mode,
    `predict_indices`, `combined_predict`) comes from ONE jitted function."""
    ref_cam, port_cam = both_cams(SMALL_CAM)
    scene = make_scene(n_side=400)
    depth_mm, rgb = render_frame(scene[0], scene[1], np.eye(4), ref_cam)
    rng = np.random.default_rng(0)
    conf = rng.uniform(0.0, 3.0, 1 << 15).astype(np.float32)
    T = np.asarray(pose_from_xyzrpy(x=0.02, yaw=0.01), np.float32)
    c = SMALL_CAM

    @jax.jit
    def reference(depth_mm, rgb, conf, T):
        raw = ref_metricise(depth_mm.astype(jnp.float32), 3.0)
        m = ref_init_map(1 << 15, raw, raw, rgb, ref_cam, 3.0)
        m = m._replace(conf=jnp.where(m.conf > 0, conf, 0.0))
        pos_c, normal_c = ref_splat._camera_frame(m, T)
        slot = jnp.arange(m.capacity)
        gate = ((pos_c[2] <= KW["max_depth"]) & (m.conf >= KW["conf_threshold"])
                & ((KW["time"] - m.last_t) <= KW["time_delta"])
                & (m.last_t <= KW["max_time"]))
        pid = ref_splat._point_raster(pos_c, gate, ref_cam, slot < m.count)
        ch = ref_splat._gather_surfel_channels(m, pos_c, normal_c, pid)
        valid = (~ch["empty"] & (ch["p"][2] > 0)).astype(jnp.float32)
        chan = jnp.concatenate(
            [ch["p"], ch["n"], ch["rad"][None], ch["conf"][None], ch["col"],
             ch["it"][None], valid[None]], axis=0)
        resolved = ref_splat_resolve(chan, c["fx"], c["fy"], c["cx"], c["cy"],
                                     interpret=True)
        pidx = ref_splat.predict_indices(m, T, ref_cam, 5.0, 200, 20.0)
        pred = ref_splat.combined_predict(m, T, ref_cam, use_pallas=True, **KW)
        return m, chan, resolved, pidx, pred

    m, chan, resolved, pidx, pred = reference(
        jnp.asarray(depth_mm), jnp.asarray(rgb), jnp.asarray(conf), jnp.asarray(T))
    m_np = {f: np.asarray(getattr(m, f)) for f in m._fields}
    return dict(ref_cam=ref_cam, port_cam=port_cam, T=T,
                chan=np.array(chan), resolved=np.asarray(resolved),
                pidx=pidx, pred=pred,
                m_port=convert.surfel_map_from_numpy(m_np, "cpu"))


@pytest.fixture(scope="module")
def chan(world):
    """[13,H,W] winner channels as the reference assembles them for K2."""
    return world["chan"]


def test_splat_resolve_plain_vs_pallas_interpret(world, chan):
    c = SMALL_CAM
    ref = world["resolved"]
    got = nn(splat_resolve_plain(tt(chan), c["fx"], c["fy"], c["cx"], c["cy"]))
    assert (got[12] > 0).sum() > 0.5 * got[12].size, "scene predicted too little"
    # hit / front decisions as a count: a pixel whose candidate sits exactly on
    # `d2 <= rad²` or on the 0.01 m front cutoff may flip between two
    # compilations of the same arithmetic (FMA contraction); such pixels must
    # be rare (< 0.2 %, the bound the reference's own Pallas-vs-XLA test uses)
    flipped = (got[12] > 0) != (ref[12] > 0)
    assert flipped.mean() < 2e-3
    bad = ~np.isclose(got, ref, rtol=1e-5, atol=1e-5).all(axis=0)
    assert bad.mean() < 2e-3, f"{bad.mean() * 100:.3f}% of pixels differ"
    # everything else: atol 1e-5 (colours are 0..255, hence the rtol)
    ok = ~bad
    np.testing.assert_allclose(got[:, ok], ref[:, ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[11][ok], ref[11][ok])     # time: exact


def test_splat_resolve_wrapper_takes_plain_on_cpu(chan, kernel_calls):
    c = SMALL_CAM
    a = splat_resolve(tt(chan), c["fx"], c["fy"], c["cx"], c["cy"])
    b = splat_resolve_plain(tt(chan), c["fx"], c["fy"], c["cx"], c["cy"])
    np.testing.assert_array_equal(nn(a), nn(b))
    assert kernel_calls == []
    with pytest.raises(ValueError):
        splat_resolve(tt(chan[:12]), c["fx"], c["fy"], c["cx"], c["cy"])


def test_predict_indices_matches_reference(world):
    ref = world["pidx"]
    got = port_splat.predict_indices(
        world["m_port"], tt(world["T"]), world["port_cam"], 5.0, 200, 20.0)
    ri, gi = nn(ref.index), nn(got.index)
    assert (ri >= 0).sum() > 5000
    # a surfel whose projection lands within float rounding of a pixel edge
    # may fall into the neighbouring pixel: at most 0.1 % of pixels
    assert (ri != gi).mean() < 1e-3
    same = ri == gi
    for f in ("vert", "normal", "radius", "conf", "init_t", "last_t"):
        a, b = nn(getattr(ref, f)), nn(getattr(got, f))
        np.testing.assert_allclose(b[..., same], a[..., same], atol=1e-5,
                                   err_msg=f)


def test_combined_predict_matches_reference(world):
    kw = dict(KW)
    ref = world["pred"]
    got = port_splat.combined_predict(
        world["m_port"], tt(world["T"]), world["port_cam"], **kw)
    assert float((nn(got.depth) > 0).sum()) > 100
    for f in ref._fields:
        # same bound as the reference's own kernel-vs-XLA test: pixels on a
        # decision edge may flip, everything else agrees to 1e-4
        assert frac_differing(getattr(got, f), getattr(ref, f), 1e-4, 1e-4) < 2e-3, f


def test_raster_tie_goes_to_lowest_id():
    """Two surfels on one pixel in the same 13-bit depth bucket (2.44 mm):
    the lower id wins although the higher one is nearer; a third surfel in a
    nearer bucket beats both."""
    ref_cam, port_cam = both_cams(SMALL_CAM)
    cap = 8

    def make(zs):
        pos = np.zeros((3, cap), np.float32)
        pos[2, :len(zs)] = zs
        z1 = np.zeros((cap,), np.float32)
        live = (np.arange(cap) < len(zs)).astype(np.float32)
        nrm = np.zeros((3, cap), np.float32)
        nrm[2] = -live
        return dict(pos=pos, conf=live, color=np.zeros((3, cap), np.float32),
                    init_t=live, last_t=live, normal=nrm, radius=0.01 * live,
                    count=np.int32(len(zs)))

    T = np.eye(4, dtype=np.float32)
    ref_predict = jax.jit(
        lambda m, T: ref_splat.predict_indices(m, T, ref_cam, 1.0, 200, 20.0))
    # bucket 410 of z * 8192 / 20 spans [1.000977, 1.003418) m
    for zs, want in (([1.0030, 1.0012], 0), ([1.0030, 1.0012, 0.9900], 2)):
        d = make(zs)
        ref = ref_predict(
            RefMap(**{k: jnp.asarray(v) for k, v in d.items()}), jnp.asarray(T))
        got = port_splat.predict_indices(
            convert.surfel_map_from_numpy(d, "cpu"), tt(T), port_cam, 1.0, 200, 20.0)
        y, x = int(SMALL_CAM["cy"]), int(SMALL_CAM["cx"])
        assert int(nn(ref.index)[y, x]) == want
        assert int(nn(got.index)[y, x]) == want
        np.testing.assert_array_equal(nn(got.index), nn(ref.index))
        assert (nn(got.index) == -1).sum() == got.index.numel() - 1


def _resolve_in_kernel_order(chan, fx, fy, cx, cy):
    """csrc/splat_resolve.cu in numpy float32, operation for operation: p.n and
    rad² once per SOURCE pixel (with `valid` folded into rad² as −1), every
    candidate's division once (pass 1 keeps depth and hit bit), pass 2 over the
    hits only with the miss distance recomputed from the kept depth."""
    f = np.float32
    C, H, W = chan.shape
    pad = np.zeros((C, H + 4, W + 4), f)
    pad[:, 2:-2, 2:-2] = chan
    pn = pad[0] * pad[3] + pad[1] * pad[4] + pad[2] * pad[5]
    r2 = np.where(pad[12] > 0, pad[6] * pad[6], f(-1.0)).astype(f)
    out = np.zeros((13, H, W), f)
    for y in range(H):
        for x in range(W):
            lx, ly = (f(x) - f(cx)) / f(fx), (f(y) - f(cy)) / f(fy)
            zc, hits, zmin = {}, [], f(3.4e38)
            for dy in range(5):
                for dx in range(5):
                    sy, sx = y + dy, x + dx
                    if not r2[sy, sx] >= 0:
                        continue
                    ln = lx * pad[3, sy, sx] + ly * pad[4, sy, sx] + pad[5, sy, sx]
                    ln_ok = abs(ln) > f(1e-12)
                    z = pn[sy, sx] / (ln if ln_ok else f(1.0))
                    ex, ey, ez = z * lx - pad[0, sy, sx], z * ly - pad[1, sy, sx], z - pad[2, sy, sx]
                    d2 = ex * ex + ey * ey + ez * ez
                    if ln_ok and z > 0 and d2 <= r2[sy, sx]:
                        zc[(dy, dx)] = z
                        hits.append((dy, dx))
                        zmin = min(zmin, z)
            front_z = zmin + f(0.01)
            wsum = wbest = it_best = f(0.0)
            acc = [f(0.0)] * 9
            for dy, dx in hits:
                z = zc[(dy, dx)]
                if not z <= front_z:
                    continue
                sy, sx = y + dy, x + dx
                ex, ey, ez = z * lx - pad[0, sy, sx], z * ly - pad[1, sy, sx], z - pad[2, sy, sx]
                d2 = ex * ex + ey * ey + ez * ez
                gauss = f(1.0) - d2 / max(r2[sy, sx], f(1e-12))
                conf = pad[7, sy, sx]
                w = max(conf, f(1e-3)) * max(gauss, f(0.05))
                wsum = wsum + w
                src = (z, conf, pad[3, sy, sx], pad[4, sy, sx], pad[5, sy, sx],
                       pad[6, sy, sx], pad[8, sy, sx], pad[9, sy, sx], pad[10, sy, sx])
                acc = [a + w * v for a, v in zip(acc, src)]
                if w > wbest:
                    it_best, wbest = pad[11, sy, sx], w
            found = wsum > 0
            inv_w = f(1.0) / max(wsum, f(1e-12)) if found else f(0.0)
            zed = acc[0] * inv_w
            n = [acc[2] * inv_w, acc[3] * inv_w, acc[4] * inv_w]
            nlen = np.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
            ns = f(1.0) / max(nlen, f(1e-12)) if found and nlen > f(1e-12) else f(0.0)
            out[:, y, x] = [acc[6] * inv_w, acc[7] * inv_w, acc[8] * inv_w,
                            zed * lx, zed * ly, zed, acc[1] * inv_w,
                            n[0] * ns, n[1] * ns, n[2] * ns, acc[5] * inv_w,
                            it_best, zed]
    return out


def test_kernel_order_of_splat_resolve_is_bit_equal_to_plain():
    """The CUDA kernel hoists, caches and skips where the plain version
    recomputes all 25 candidates in both passes.  On a constructed 16x12 frame
    (a tilted back wall, a nearer patch that occludes part of it, disks of
    2-3 pixels that overlap, holes, a few out-of-reach and zero-radius
    sources) the kernel's order of operations gives the plain version's bits:
    a skipped non-hit would have added w = 0, and 0·x adds nothing for finite
    x."""
    H, W, fx, fy, cx, cy = 12, 16, 20.0, 21.0, 7.5, 5.5
    rng = np.random.default_rng(11)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    z = (1.0 + 0.01 * u + 0.004 * v).astype(np.float32)
    z[3:8, 5:10] = 0.8                                     # the occluder
    z = (z + rng.uniform(-0.004, 0.004, z.shape)).astype(np.float32)
    jit = rng.uniform(-0.3, 0.3, (2, H, W)).astype(np.float32)
    chan = np.zeros((13, H, W), np.float32)
    chan[0] = (u + jit[0] - cx) / fx * z
    chan[1] = (v + jit[1] - cy) / fy * z
    chan[2] = z
    nrm = np.stack([0.1 * rng.standard_normal((H, W)), 0.1 * rng.standard_normal((H, W)),
                    -np.ones((H, W))])
    chan[3:6] = (nrm / np.linalg.norm(nrm, axis=0)).astype(np.float32)
    chan[6] = rng.uniform(2.0, 3.0, (H, W)) * z / fx       # rad: 2-3 pixels
    chan[7] = rng.uniform(0.0, 5.0, (H, W))                # conf (some below 1e-3 floor)
    chan[7][rng.random((H, W)) < 0.1] = 0.0
    chan[8:11] = rng.uniform(0, 255, (3, H, W))
    chan[11] = rng.integers(1, 40, (H, W))                 # init time
    valid = rng.random((H, W)) > 0.2                       # holes
    chan[12] = valid
    chan[6][1, 1] = 0.0                                    # a zero-radius source
    chan[3:6, 10, 2] = (1.0, 0.0, 0.0)                     # a normal across the rays
    chan = chan.astype(np.float32)

    plain = nn(splat_resolve_plain(tt(chan), fx, fy, cx, cy))
    got = _resolve_in_kernel_order(chan, fx, fy, cx, cy)
    covered = plain[12] > 0
    assert covered.mean() > 0.8 and (covered & ~valid).sum() > 10, "disks must fill holes"
    assert (plain[12][3:8, 5:10] < 0.9).all(), "the occluder must win its pixels"
    np.testing.assert_array_equal(got, plain)
