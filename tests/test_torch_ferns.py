"""Fern place recognition of the port (`elasticfusion_tpu_torch/ferns.py`)
against the reference package's on the CPU: the seeded tables, the device
encoding and retrieval scoring, and an add/find flow at 160x120 (keyframe
ids, the retrieved keyframe, the fern-resolution ICP pose, the surface
constraints)."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, nn, reference_output, rot_err, tt
from elasticfusion_tpu import ferns as ref_ferns
from elasticfusion_tpu.config import EngineConfig as RefConfig
from elasticfusion_tpu.ops.preprocess import compute_nmap, compute_vmap, metricise_depth
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch import ferns as port_ferns
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig

# fern resolution at 160x120 / 8 = 20x15 = 300 px: inlier gates scaled down
# as the reference package's own fern test does
FERN_CFG = dict(fern_min_age=5, fern_inlier_count=100, lost_inlier_relax=60)
ADD_POSES = [pose_from_xyzrpy(x=0.25 * i, yaw=0.10 * i) for i in range(6)]
REVISIT = pose_from_xyzrpy(x=0.01, yaw=0.004)


def _views(ref_cam):
    """Full-resolution views (image, vertex map, normal map) of the six
    keyframe candidates and the revisit, from one reference jit."""
    scene = make_scene(n_side=700)
    frames = [render_frame(scene[0], scene[1], T, ref_cam) for T in ADD_POSES + [REVISIT]]

    @jax.jit
    def to_views(depth_mm, rgb):
        depth = metricise_depth(depth_mm.astype(jnp.float32), 20.0)
        vmap = compute_vmap(depth, ref_cam, 20.0)
        return rgb.astype(jnp.float32), vmap, compute_nmap(vmap)

    return [jax.tree.map(np.asarray, to_views(jnp.asarray(d), jnp.asarray(r)))
            for d, r in frames]


def _flow(ferns, views):
    added = [ferns.add_frame(img, v, n, T, src_time=i + 1)
             for i, (T, (img, v, n)) in enumerate(zip(ADD_POSES, views[:-1]))]
    img, v, n = views[-1]
    T_found, cons = ferns.find_frame(img, v, n, REVISIT, time=100, lost=False)
    return added, ferns.last_closest, T_found, cons


def reference_flow(out_path):
    """The views and the reference `Ferns` add/find flow (its output is
    committed, `REFERENCE_OUTPUTS` below)."""
    ref_cam, _ = both_cams(SMALL_CAM)
    views = _views(ref_cam)
    ferns = ref_ferns.Ferns(RefConfig(camera=ref_cam, **FERN_CFG))
    added, closest, T, cons = _flow(ferns, views)
    out = dict(views=views, added=added, closest=closest, T=T,
               cons=[(c.source_point, c.target_point) for c in cons],
               frames=[dataclasses.asdict(f) for f in ferns.frames])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# the committed output of this run, read by the tests below (`_torch_parity.reference_output`):
# name -> (function, arguments, cpu_devices)
REFERENCE_OUTPUTS = {"ferns_flow": ("reference_flow", (), 1)}


@pytest.fixture(scope="module")
def flows():
    ref = reference_output("ferns_flow")
    port = port_ferns.Ferns(PortConfig(camera=both_cams(SMALL_CAM)[1], **FERN_CFG), "cpu")
    return ref, port, _flow(port, ref["views"])


@pytest.fixture(scope="module")
def views(flows):
    return both_cams(SMALL_CAM)[1], flows[0]["views"]


@pytest.mark.parametrize("cam,seed", [(None, 0), (SMALL_CAM, 0), (SMALL_CAM, 7)])
def test_fern_tables_equal_reference(cam, seed):
    kw = {} if cam is None else dict(camera=both_cams(cam)[0])
    ref = ref_ferns.Ferns(RefConfig(fern_seed=seed, **kw))
    kw = {} if cam is None else dict(camera=both_cams(cam)[1])
    port = port_ferns.Ferns(PortConfig(fern_seed=seed, **kw), "cpu")
    np.testing.assert_array_equal(port.pos, ref.pos)
    np.testing.assert_array_equal(port.rgbd, ref.rgbd)
    assert port.fern_cam == dataclasses.replace(port.fern_cam, **dataclasses.asdict(ref.fern_cam))
    flat, rgbd = port.encode_tables()
    np.testing.assert_array_equal(nn(flat), ref.pos[:, 1] * ref.width + ref.pos[:, 0])
    np.testing.assert_array_equal(nn(rgbd), ref.rgbd.astype(np.float32))


def test_encode_and_score_match_reference(views):
    """`fern_encode_device` on the decimated views and `fern_score_device`
    against a DB of their codes: codes exact; add_min, best_d, block_hd
    within 1e-6 (float32 ratios of integer counts); best_id exact."""
    port_cam, vs = views
    port = port_ferns.Ferns(PortConfig(camera=port_cam, **FERN_CFG), "cpu")
    flat, rgbd = (nn(t) for t in port.encode_tables())
    small = [port_ferns.decimate_views(tt(img), tt(v), tt(n), port.factor)
             for img, v, n in vs]
    imgs = np.stack([nn(s[0]) for s in small])
    verts = np.stack([nn(s[1]) for s in small])
    times = np.array([1, 2, 3, 4, np.inf, np.inf, np.inf, np.inf], np.float32)

    @jax.jit
    def ref(imgs, verts):
        enc = [ref_ferns.fern_encode_device(i, v, jnp.asarray(flat, jnp.int32), rgbd)
               for i, v in zip(imgs, verts)]
        db = jnp.full((8, port.num), 255, jnp.int32).at[:4].set(jnp.stack([c for c, _ in enc[:4]]))
        db_good = jnp.zeros((8,), jnp.float32).at[:4].set(
            jnp.stack([g for _, g in enc[:4]]).astype(jnp.float32))
        scores = [ref_ferns.fern_score_device(c, g, db, db_good, jnp.asarray(times),
                                              jnp.int32(4), jnp.float32(t), 1)
                  for (c, g), t in zip(enc, (2.5, 9.0, 9.0, 9.0, 9.0, 9.0, 50.0))]
        return enc, scores, db, db_good

    enc, scores, db, db_good = jax.tree.map(np.asarray, ref(imgs, verts))
    for i, (img, v) in enumerate(zip(imgs, verts)):
        codes, good = port_ferns.fern_encode_device(tt(img), tt(v), tt(flat), tt(rgbd))
        np.testing.assert_array_equal(nn(codes), enc[i][0])
        assert int(good) == int(enc[i][1]) > 0
    for (c, g), t, r in zip(enc, (2.5, 9.0, 9.0, 9.0, 9.0, 9.0, 50.0), scores):
        got = port_ferns.fern_score_device(tt(c), torch.tensor(int(g)), tt(db), tt(db_good),
                                           tt(times), 4, torch.tensor(t), 1)
        assert int(got[1]) == int(r[1])
        for a, b in zip((got[0], got[2], got[3]), (r[0], r[2], r[3])):
            assert (np.isinf(b) and np.isinf(float(a))) or abs(float(a) - float(b)) <= 1e-6


def test_score_tie_returns_the_first_keyframe():
    """Two keyframes with the same codes: `torch.argmin` returns the first
    least dissimilarity, as `jnp.argmin` does."""
    codes = torch.tensor([1, 2, 3, 255, 5], dtype=torch.int32)
    db = torch.tensor([[9, 9, 9, 9, 9], [1, 2, 3, 4, 0], [1, 2, 3, 4, 0]],
                      dtype=torch.int32)
    good = torch.tensor([5.0, 5.0, 5.0])
    times = torch.tensor([1.0, 1.0, 1.0])
    add_min, best_id, best_d, block_hd = port_ferns.fern_score_device(
        codes, torch.tensor(4), db, good, times, 3, torch.tensor(10.0), 1)
    assert int(best_id) == 1 and float(best_d) == float(add_min) == 0.25
    assert float(block_hd) == 0.75


def test_add_find_flow_matches_reference(flows):
    ref, port, (added, closest, T, cons) = flows
    r_T, r_cons = ref["T"], ref["cons"]
    assert added == ref["added"] and sum(added) >= 2
    assert [f.id for f in port.frames] == [f["id"] for f in ref["frames"]]
    assert [f.src_time for f in port.frames] == [f["src_time"] for f in ref["frames"]]
    for pf, rf in zip(port.frames, ref["frames"]):
        np.testing.assert_array_equal(pf.codes, rf["codes"])
        np.testing.assert_array_equal(pf.rgb, rf["rgb"])
    assert closest == ref["closest"] == 0
    # fern ICP: 10 Gauss-Newton iterations of float32 sums in another order
    assert np.linalg.norm(T[:3, 3] - r_T[:3, 3]) < 5e-4
    assert rot_err(T, r_T) < 5e-4
    assert np.linalg.norm(T[:3, 3] - REVISIT[:3, 3]) < 0.02
    # constraints: the same fern pixels, through poses equal to 5e-4 → 1e-5
    # on the source side (the same host pose), 1e-3 on the target side
    assert len(cons) == len(r_cons) > 10
    for c, (r_src, r_tgt) in zip(cons, r_cons):
        np.testing.assert_allclose(c.source_point, r_src, rtol=0, atol=1e-5)
        np.testing.assert_allclose(c.target_point, r_tgt, rtol=0, atol=1e-3)


def test_min_age_gate(views):
    port_cam, vs = views
    port = port_ferns.Ferns(PortConfig(camera=port_cam, **FERN_CFG), "cpu")
    img, v, n = vs[0]
    port.add_frame(img, v, n, np.eye(4), src_time=1)
    T_found, _ = port.find_frame(img, v, n, np.eye(4), time=3, lost=False)
    assert port.last_closest == -1 and T_found is None


def test_loaded_db_retrieves_like_the_reference(flows, views):
    """Keyframes of the reference DB loaded through `convert.load_fern_db`
    give the same device DB rows and the same retrieval."""
    ref = flows[0]
    port_cam, vs = views
    port = port_ferns.Ferns(PortConfig(camera=port_cam, **FERN_CFG), "cpu")
    convert.load_fern_db(port, ref["frames"])
    codes, good, times, count = port.device_db()
    assert count == len(ref["frames"])
    for i, f in enumerate(ref["frames"]):
        np.testing.assert_array_equal(nn(codes[i]), f["codes"].astype(np.int32))
        assert float(good[i]) == f["good_codes"] and float(times[i]) == f["src_time"]
    img, v, n = vs[-1]
    T, _ = port.find_frame(img, v, n, REVISIT, time=100, lost=False)
    assert port.last_closest == ref["closest"]
    assert np.linalg.norm(T[:3, 3] - ref["T"][:3, 3]) < 5e-4


def test_db_grows_and_keeps_its_rows(views):
    port_cam, vs = views
    port = port_ferns.Ferns(PortConfig(camera=port_cam, max_fern_keyframes=2,
                                       **FERN_CFG), "cpu")
    port.device_db()
    img, v, n = vs[0]
    for i in range(5):
        port.add_frame(img, v, n, np.eye(4), src_time=i + 1, threshold=-1.0)
    codes, good, times, count = port.device_db()
    assert port.db_capacity == 8 and codes.shape[0] == 8 and count == 5
    assert nn(times).tolist()[:5] == [1, 2, 3, 4, 5]
    assert np.isinf(nn(times)[5:]).all() and (nn(codes)[5:] == 255).all()


def test_device_views_are_read_in_one_copy(views, monkeypatch):
    """`add_frame` / `find_frame` take full-resolution views through the
    engine's device path: `decimate_views` samples the output-pixel centres,
    the codes and scores come back in one read, and a kept keyframe's views
    in one more (`_to_small`)."""
    port_cam, vs = views
    img, v, n = vs[0]
    small = port_ferns.decimate_views(tt(img), tt(v), tt(n), 8)
    want = (img[4::8, 4::8], v[:, 4::8, 4::8], n[:, 4::8, 4::8])
    for x, y in zip(small, want):
        np.testing.assert_array_equal(nn(x), y)
    got = port_ferns._to_small(*small)
    np.testing.assert_array_equal(got[0], np.clip(want[0], 0, 255).astype(np.uint8))
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x, y)

    reads = []
    real = port_ferns.read_back
    monkeypatch.setattr(port_ferns, "read_back", lambda t: reads.append(t.numel()) or real(t))
    port = port_ferns.Ferns(PortConfig(camera=port_cam, **FERN_CFG), "cpu")
    assert port.add_frame(img, v, n, np.eye(4), src_time=1)
    num, views_px = port.num, sum(t.numel() for t in small)
    assert reads == [num + 5, views_px]
    reads.clear()
    assert not port.add_frame(img, v, n, np.eye(4), src_time=2)
    assert reads == [num + 5]
