"""Externally supplied poses (`process_frame(..., in_T_wc=T)` after the first
frame: fuse at the given pose, no tracking, no loop closure) through the
port and the reference engine (its committed output), on the frames of
`tests/test_engine.py:63-73` and on a slower camera whose velocity weight is
not clamped.

Both packages run `clean` on the exact float32 patch (`fx16_clean=False`):
the port's external-pose path always does, as both packages' tracked frames
do; the reference's external-pose path follows the flag."""

import pickle

import numpy as np
import pytest

from _torch_parity import SMALL_CAM, both_cams, reference_output
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch.config import CameraConfig as PortCam
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig

CFG = dict(max_surfels=1 << 16, fx16_clean=False)
MOTIONS = {
    # tests/test_engine.py:63-73: 2 cm a frame, the velocity weight clamps at 0.5
    "test_engine": [dict(x=0.02 * i) for i in range(3)],
    # 4 mm and 2 mrad a frame: weight 1 - |log T| / 0.01, then x0.7
    "slow": [dict(x=0.004 * i, yaw=0.002 * i) for i in range(3)],
}
MULTIPLIER = [1.0, 1.0, 0.7]
FIELDS = ("pos", "conf", "color", "init_t", "last_t", "normal", "radius")


def _frames(motion):
    ref_cam, _ = both_cams(SMALL_CAM)
    scene = make_scene(n_side=700)
    out = []
    for kw in MOTIONS[motion]:
        T = pose_from_xyzrpy(**kw)
        d, r = render_frame(scene[0], scene[1], T, ref_cam)
        out.append((r, d, T))
    return out


def _drive(eng, module, fuse_name, motion, after_first=None):
    """Run the frames with their poses; record the poses returned, the
    fusion weight handed to the fuse + clean program, counts and the map
    (and the map after the first frame)."""
    weights, first = [], None
    real = getattr(module, fuse_name)

    def kept(m, T, tick, rgb, raw, filt, weighting, *rest):
        weights.append(np.float32(np.asarray(weighting)))
        return real(m, T, tick, rgb, raw, filt, weighting, *rest)
    setattr(module, fuse_name, kept)
    try:
        poses, counts = [], []
        for i, (r, d, T) in enumerate(_frames(motion)):
            res = eng.process_frame(r, d, timestamp=i, weight_multiplier=MULTIPLIER[i],
                                    in_T_wc=T)
            if i == 0:
                first = {f: np.asarray(getattr(eng.map, f)).copy() for f in eng.map._fields}
                if after_first is not None:
                    after_first(eng)
            poses.append(np.asarray(res.T_wc))
            counts.append(res.surfel_count)
    finally:
        setattr(module, fuse_name, real)
    n = counts[-1]
    return dict(poses=poses, counts=counts, weights=weights, tick=eng.tick,
                fused=res.fused, stamps=[ts for ts, _ in eng.poses], first=first,
                map={f: np.asarray(getattr(eng.map, f))[..., :n].copy() for f in FIELDS})


def reference_runs(out_path):
    from elasticfusion_tpu import engine as ref_engine
    from elasticfusion_tpu.config import EngineConfig as RefConfig

    ref_cam, _ = both_cams(SMALL_CAM)
    out = {m: _drive(ref_engine.Engine(RefConfig(camera=ref_cam, **CFG)), ref_engine,
                     "_fuse_and_clean", m) for m in MOTIONS}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# the committed output of this run, read by the tests below (`_torch_parity.reference_output`):
# name -> (function, arguments, cpu_devices)
REFERENCE_OUTPUTS = {"external_pose_runs": ("reference_runs", (), 1)}


@pytest.fixture(scope="module")
def runs():
    ref = reference_output("external_pose_runs")
    port, tracked = {}, []
    real = port_engine.get_incremental_transformation
    port_engine.get_incremental_transformation = (
        lambda *a, **k: (tracked.append(1), real(*a, **k))[1])

    def reference_first_map(motion):
        def put(eng):
            eng.map = convert.surfel_map_from_numpy(ref[motion]["first"], "cpu")
        return put
    try:
        for m in MOTIONS:
            eng = port_engine.Engine(PortConfig(camera=PortCam(**SMALL_CAM), **CFG),
                                     device="cpu")
            port[m] = _drive(eng, port_engine, "_fuse_clean", m, reference_first_map(m))
    finally:
        port_engine.get_incremental_transformation = real
    return port, ref, tracked


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_returned_poses_are_the_given_ones(runs, motion):
    port, ref, _ = runs
    for got, want, (_, _, T) in zip(port[motion]["poses"], ref[motion]["poses"],
                                    _frames(motion)):
        np.testing.assert_allclose(got, T, rtol=0, atol=1e-9)
        np.testing.assert_allclose(want, T, rtol=0, atol=1e-9)
    assert port[motion]["tick"] == ref[motion]["tick"] == 4
    assert port[motion]["stamps"] == ref[motion]["stamps"] == [0, 1, 2]
    assert port[motion]["fused"] and ref[motion]["fused"]


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_fusion_weight_is_the_reference_host_value(runs, motion):
    """The velocity weight is computed on the host in float64 and handed over
    as float32: equal to the reference's, bit for bit."""
    port, ref, _ = runs
    got, want = port[motion]["weights"], ref[motion]["weights"]
    assert len(got) == len(want) == 2
    assert [float(w) for w in got] == [float(w) for w in want]
    if motion == "slow":
        assert 0.5 < float(got[0]) < 1.0 and float(got[1]) < 0.5


@pytest.mark.parametrize("motion", list(MOTIONS))
def test_map_matches_the_reference(runs, motion):
    """The external-pose frames of both packages from the same map (the
    reference's after its first frame, put into the port's engine — each
    package's own first frame is held to the reference in
    `test_torch_closure.py`): surfel counts equal after every frame, and
    every field of a surfel within 1e-5 (rtol and atol) for all but 1 % of
    the live surfels.  XLA:CPU contracts `a*b + c` into fused multiply-adds,
    so where a measurement's two nearest candidate surfels lie within an
    ulp of each other (fuse's `dist < best_dist`) it may merge into the
    other one: on the 2 cm frames, from bit-identical filtered depth, the
    first external fuse merges 2 measurements into the neighbouring surfel
    (pixel row 38, columns 3-4), and by the end of the second frame 90 of
    18,703 surfels (0.48 %) differ; on the slow frames 2 of 18,644."""
    port, ref, _ = runs
    assert port[motion]["counts"] == ref[motion]["counts"]
    n = port[motion]["counts"][-1]
    assert n > 1000
    off = np.zeros(n, bool)
    for f in FIELDS:
        got, want = port[motion]["map"][f], ref[motion]["map"][f]
        assert np.isfinite(got).all(), f
        close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
        off |= ~close.reshape(-1, n).all(axis=0)
    assert off.sum() <= 0.01 * n, f"{int(off.sum())} of {n} surfels differ beyond 1e-5"


def test_no_tracking_after_the_first_frame(runs):
    """External poses run no tracker (no tracker read) on any frame."""
    _, _, tracked = runs
    assert tracked == []
