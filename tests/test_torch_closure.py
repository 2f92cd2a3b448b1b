"""The loop-closure engine of the port against the reference package's on the
CPU, on the scenarios of the reference's own tests:

- `test_closeloop.py::test_engine_local_loop_closure` — a there-and-back
  trajectory whose return registers the active model against the inactive
  one (model-to-model), deforms the map and corrects the pose;
- `test_pipeline.py::test_fern_teleport_recovery[0]` — relocalization: a
  sensor blackout trips the tracking gates, the engine is lost, a revisited
  view is retrieved from the fern DB, the engine teleports and recovers.

Each engine runs from its own first frame.  The first frame's surfels
project exactly onto pixel corners in the first prediction, where one float32
rounding of a position decides the pixel a surfel lands in, so the port
multiplies by the float32 reciprocal wherever the reference divides by a
constant (XLA folds `x / c` into `x * (1/c)`): the first-frame positions are
bit-identical.  The per-frame poses agree to the tolerances below; the
frames from the first closure on are held to a wider one, and the closure's
model-to-model solve to a narrow one on the reference's own inputs."""

import pickle

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    SMALL_CAM,
    both_cams,
    frac_differing,
    nn,
    reference_output,
    rot_err,
    tt,
)
from elasticfusion_tpu.config import EngineConfig as RefConfig
from elasticfusion_tpu.engine import Engine as RefEngine
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import _device, convert
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch import tracking as port_tracking
from elasticfusion_tpu_torch.config import CameraConfig as PortCam
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig
from elasticfusion_tpu_torch.ops.splat import synthesize_depth, synthesize_info

SCENARIOS = {
    # test_closeloop.py:76-86
    "local": dict(max_surfels=1 << 17, confidence_threshold=0.3, time_delta=6,
                  icp_count_threshold=2000, icp_error_threshold=5e-4,
                  cov_threshold=1e-4, fern_min_age=1000, def_graph_sample_rate=500),
    # test_pipeline.py:113-125 at pipeline depth 0
    "teleport": dict(max_surfels=1 << 17, confidence_threshold=0.3, reloc_mode=True,
                     fern_min_age=3, fern_inlier_count=100, lost_inlier_relax=50,
                     fern_threshold=0.12, fern_icp_error=2e-3, pipeline_depth=0),
}


def _cams(scale=1):
    """The scenarios' camera at `scale` times its resolution (reference, port)."""
    return both_cams({k: v * scale for k, v in SMALL_CAM.items()})


def _frames(name, scale=1):
    """(rgb, depth_mm, timestamp) of a scenario, and for the teleport one the
    index from which a frame ends the run as soon as the engine is not lost."""
    ref_cam, _ = _cams(scale)
    scene = make_scene(n_side=700 * scale)
    if name == "local":
        out = []
        for i in range(16):
            s = i if i < 8 else (2 * 8 - i - 1)
            T = pose_from_xyzrpy(x=0.035 * s, yaw=0.012 * s)
            d, r = render_frame(scene[0], scene[1], T, ref_cam)
            out.append((r, d, i * 33000, T))
        return out, None
    views = []
    for i in range(8):
        T = pose_from_xyzrpy(x=0.03 * i, yaw=0.01 * i)
        d, r = render_frame(scene[0], scene[1], T, ref_cam)
        views.append((r, d, i, T))
    blank = [(np.zeros_like(views[0][0]), np.zeros_like(views[0][1]), 100 + i, None)
             for i in range(14)]
    r0, d0, _, T0 = views[0]
    revisit = [(r0, d0, 200 + i, T0) for i in range(4)]
    return views + blank + revisit, len(views) + len(blank)


def _drive(eng, frames, stop_from, after_first=None):
    """Run the frames; record what the comparison reads after every frame."""
    rec = []
    for i, (r, d, ts, _) in enumerate(frames):
        res = eng.process_frame(r, d, timestamp=ts)
        if i == 0 and after_first is not None:
            after_first(eng)
        rec.append(dict(T=np.asarray(res.T_wc), tick=eng.tick, lost=eng.lost,
                        ok=bool(res.tracking_ok), count=res.surfel_count,
                        deforms=eng.deforms, fern_deforms=eng.fern_deforms,
                        keyframes=[f.src_time for f in eng.ferns.frames]))
        if stop_from is not None and i >= stop_from and not eng.lost:
            break
    return dict(frames=rec, poses=[(ts, np.asarray(T)) for ts, T in eng.poses])


def _first_state(eng):
    """The reference engine's carried state after its first frame."""
    host = lambda t: {f: np.asarray(getattr(t, f)) for f in t._fields}  # noqa: E731
    return dict(map=host(eng.map), pred=host(eng._pred),
                fill=[np.asarray(a) for a in eng._fill],
                dense=float(eng._dense_dev), so3=np.asarray(eng._so3_hist))


def reference_engines(out_path, name):
    """One scenario through the reference `Engine` and the inputs and result
    of its first two model-to-model solves that found inliers; for `local`,
    the extras on the first of them (its output is committed,
    `REFERENCE_OUTPUTS` below)."""
    ref_cam, _ = both_cams(SMALL_CAM)
    m2m = []
    finish = RefEngine._finish

    def keep_m2m(self, rec):
        o = rec["out"]
        if "m2m" in o and float(o["m2m"].icp_count) > 0 and len(m2m) < 2:
            host = lambda t: {f: np.asarray(getattr(t, f)) for f in t._fields}  # noqa: E731
            m2m.append(dict(tick=rec["tick"], map=host(o["map"]), pred=host(o["pred"]),
                            T=np.asarray(o["T"]), m2m=host(o["m2m"])))
        return finish(self, rec)
    RefEngine._finish = keep_m2m
    frames, stop_from = _frames(name)
    eng = RefEngine(RefConfig(camera=ref_cam, **SCENARIOS[name]))
    first = {}
    out = _drive(eng, frames, stop_from, lambda e: first.update(_first_state(e)))
    out.update(first=first, m2m=m2m)
    if name == "local" and m2m:
        out["extras"] = _reference_extras(m2m[0], RefConfig(camera=ref_cam, **SCENARIOS[name]))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# the committed outputs of this run, one a scenario, read by the tests below
# (`_torch_parity.reference_output`): name -> (function, arguments, cpu_devices)
REFERENCE_OUTPUTS = {f"closure_{name}": ("reference_engines", (name,), 1) for name in SCENARIOS}


def _reference_extras(c, cfg):
    """`synthesize_info`, `synthesize_depth` and
    `build_current_model_pyramids` of the reference on a captured
    model-to-model frame, in one jit."""
    from elasticfusion_tpu.ops.splat import Prediction, synthesize_depth, synthesize_info
    from elasticfusion_tpu.surfels import SurfelMap
    from elasticfusion_tpu.tracking import build_current_model_pyramids

    tick = float(c["tick"])

    @jax.jit
    def run(mp, pp, T):
        m, p = SurfelMap(**mp), Prediction(**pp)
        return dict(
            info=synthesize_info(m, T, cfg.camera, cfg.confidence_threshold,
                                 cfg.max_depth_processed)._asdict(),
            depth=synthesize_depth(m, T, cfg.camera, tick, tick - cfg.time_delta, 65535,
                                   cfg.confidence_threshold, cfg.max_depth_processed),
            pyramids=build_current_model_pyramids(p.vertex, p.normal, p.image, cfg))
    return jax.tree.map(np.asarray, run(c["map"], c["pred"], c["T"]))


@pytest.fixture(scope="module")
def runs():
    port = {}
    for name, kw in SCENARIOS.items():
        frames, stop_from = _frames(name)
        eng = port_engine.Engine(PortConfig(camera=PortCam(**SMALL_CAM), **kw), device="cpu")
        first = {}
        port[name] = _drive(eng, frames, stop_from, lambda e: first.update(_first_state(e)))
        port[name].update(engine=eng, first=first)
    ref = {name: reference_output(f"closure_{name}") for name in SCENARIOS}
    ref["m2m"] = [c for name in SCENARIOS for c in ref[name]["m2m"]][:2]
    ref["extras"] = ref["local"]["extras"]
    return ref, port


def _events(run, key):
    """Ticks at which a counter went up."""
    ticks, prev = [], 0
    for f in run["frames"]:
        if f[key] > prev:
            ticks.append(f["tick"])
        prev = f[key]
    return ticks


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference(runs, name):
    ref, port = (r[name] for r in runs)
    rf, pf = ref["frames"], port["frames"]
    assert len(pf) == len(rf)
    closing = sorted(_events(ref, "deforms") + _events(ref, "fern_deforms"))
    for i, (p, r) in enumerate(zip(pf, rf)):
        # per frame: 1e-3 m / 1e-3 rad (float32 solves summed in another
        # order; measured 3.9e-5 m, 1.9e-5 rad before any closure and on
        # the whole teleport run), 1 % of surfels.  From the first closure
        # on, 3e-3: XLA:CPU contracts a*b+c into fused multiply-adds and
        # sums in another order; by the first closure those one-ulp
        # differences have flipped some of fusion's association and merge
        # decisions, so the two maps, their inactive predictions and the
        # model-to-model solutions over them differ, and the frames tracked
        # from a closure inherit that (measured 1.16 mm, 0.95 mrad).  On the
        # same inputs the two solves agree to 1e-5
        # (`test_model_to_model_matches_reference_on_its_inputs`).
        tol = 3e-3 if closing and r["tick"] >= closing[0] else 1e-3
        assert np.linalg.norm(p["T"][:3, 3] - r["T"][:3, 3]) < tol, f"frame {i}"
        assert rot_err(p["T"], r["T"]) < tol, f"frame {i}"
        assert abs(p["count"] - r["count"]) <= 0.01 * r["count"], f"frame {i}"
        assert (p["tick"], p["lost"], p["ok"]) == (r["tick"], r["lost"], r["ok"]), f"frame {i}"
        assert p["keyframes"] == r["keyframes"], f"frame {i}"
    for key in ("deforms", "fern_deforms"):
        assert _events(port, key) == _events(ref, key), key
    # the trajectory log, deformation-corrected poses included
    assert [ts for ts, _ in port["poses"]] == [ts for ts, _ in ref["poses"]]
    for (_, T), (_, rT) in zip(port["poses"], ref["poses"]):
        assert np.linalg.norm(T[:3, 3] - rT[:3, 3]) < 3e-3


def test_model_to_model_matches_reference_on_its_inputs(runs):
    """The INACTIVE prediction and the model-to-model solve of the port on
    the reference engine's map, prediction and pose of the frames where the
    solve found inliers: the pose within 1e-5 m / 1e-5 rad
    (measured 1.6e-7 m), the inlier count equal, the error within 1e-4
    relative (float32 sums in another order)."""
    ref, _ = runs
    cfg = PortConfig(camera=PortCam(**SMALL_CAM), **SCENARIOS["local"])
    assert len(ref["m2m"]) == 2
    for c in ref["m2m"]:
        m = convert.surfel_map_from_numpy(c["map"], "cpu")
        pred = convert.prediction_from_numpy(c["pred"], "cpu")
        T = tt(c["T"])
        old = port_engine.combined_predict(
            m, T, cfg.camera, 0.0, float(c["tick"] - cfg.time_delta), cfg.time_delta,
            cfg.confidence_threshold, cfg.max_depth_processed)
        got = port_engine._model_to_model(pred.vertex, pred.normal, pred.image,
                                          old.vertex, old.normal, old.image, T, cfg)
        want = c["m2m"]
        got_T = nn(got.T_curr)
        assert np.linalg.norm(got_T[:3, 3] - want["T_curr"][:3, 3]) < 1e-5
        assert rot_err(got_T, want["T_curr"]) < 1e-5
        assert float(got.icp_count) == float(want["icp_count"]) > 0
        np.testing.assert_allclose(float(got.icp_error), float(want["icp_error"]), rtol=1e-4)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_first_prediction_on_the_reference_map(runs, name):
    """The first frame's prediction of the port on the reference's
    first-frame map agrees with the reference's (the splat parity bound;
    measured: no depth pixel differs)."""
    ref, _ = runs
    first = ref[name]["first"]
    cfg = PortConfig(camera=PortCam(**SMALL_CAM), **SCENARIOS[name])
    m = convert.surfel_map_from_numpy(first["map"], "cpu")
    got = port_engine.combined_predict(
        m, torch.eye(4), cfg.camera, 1.0, 1.0, cfg.time_delta,
        cfg.confidence_threshold, cfg.max_depth_processed)
    for f in got._fields:
        assert frac_differing(getattr(got, f), first["pred"][f], 1e-4, 1e-4) < 2e-3, f
    assert frac_differing(got.depth, first["pred"]["depth"], 1e-4, 1e-4) == 0.0


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_first_frame_state_matches_reference(runs, name):
    """The port's own first frame against the reference's: positions, colours
    and times bit-identical (constant divisors as float32 reciprocals, as
    XLA computes them); normals and radii from the bilateral-filtered depth
    within 1e-4 but at its 1 mm rounding flips (< 0.1 % of the surfels);
    confidences within 1e-6; the first prediction within the splat parity
    bound, no depth pixel beyond 1e-4."""
    ref, port = (r[name]["first"] for r in runs)
    n = int(port["map"]["count"])
    assert n == int(ref["map"]["count"]) > 5000
    for f in ("pos", "color", "init_t", "last_t"):
        np.testing.assert_array_equal(port["map"][f][..., :n], ref["map"][f][..., :n], f)
    for f in ("normal", "radius"):
        assert frac_differing(port["map"][f][..., :n], ref["map"][f][..., :n], 1e-4, 1e-4) < 1e-3, f
    np.testing.assert_allclose(port["map"]["conf"][:n], ref["map"]["conf"][:n], rtol=0, atol=1e-6)
    for f in ref["pred"]:
        assert frac_differing(port["pred"][f], ref["pred"][f], 1e-4, 1e-4) < 2e-3, f
    assert frac_differing(port["pred"]["depth"], ref["pred"]["depth"], 1e-4, 1e-4) == 0.0


def test_synthesize_and_model_pyramids_match_reference(runs):
    """`synthesize_info` / `synthesize_depth` (combinedPredict without a time
    window / with the closure repair's window) and
    `build_current_model_pyramids` on the reference's map and prediction of
    a model-to-model frame."""
    ref, _ = runs
    c, want = ref["m2m"][0], ref["extras"]
    cfg = PortConfig(camera=PortCam(**SMALL_CAM), **SCENARIOS["local"])
    m = convert.surfel_map_from_numpy(c["map"], "cpu")
    pred = convert.prediction_from_numpy(c["pred"], "cpu")
    T, tick = tt(c["T"]), float(c["tick"])
    info = synthesize_info(m, T, cfg.camera, cfg.confidence_threshold,
                           cfg.max_depth_processed)
    depth = synthesize_depth(m, T, cfg.camera, tick, tick - cfg.time_delta, 65535,
                             cfg.confidence_threshold, cfg.max_depth_processed)
    # the bound of the splat parity tests: pixels on a decision edge may
    # flip, everything else agrees to 1e-4
    for f in info._fields:
        assert frac_differing(getattr(info, f), want["info"][f], 1e-4, 1e-4) < 2e-3, f
    assert frac_differing(depth, want["depth"], 1e-4, 1e-4) < 2e-3
    assert float((depth > 0).sum()) > 0.5 * depth.numel()
    # resize / verticesToDepth / Gauss pyramid / intensity: float32 averages
    # in the same order, 1e-5
    got = port_tracking.build_current_model_pyramids(
        pred.vertex, pred.normal, pred.image, cfg)
    for g_lv, w_lv in zip(got, want["pyramids"]):
        for g, w in zip(g_lv, w_lv):
            np.testing.assert_allclose(nn(g), w, rtol=1e-5, atol=1e-5)


def test_local_closure_fires_and_keeps_the_map_sane(runs):
    _, port = runs
    run, eng = port["local"], port["local"]["engine"]
    assert eng.deforms >= 1 and run["frames"][-1]["deforms"] == eng.deforms
    assert eng.surfel_count > 5000
    assert torch.isfinite(eng.map.pos[:, : eng.surfel_count]).all()
    gt = _frames("local")[0][-1][3]
    assert np.linalg.norm(eng.T_wc[:3, 3] - gt[:3, 3]) < 0.06


def test_teleport_recovers(runs):
    _, port = runs
    run, eng = port["teleport"], port["teleport"]["engine"]
    frames = run["frames"]
    assert len(eng.ferns.frames) >= 1 and not frames[7]["lost"]
    assert frames[8 + 13]["lost"], "lost after the blackout"
    assert not eng.lost and len(frames) <= 8 + 14 + 4
    T0 = _frames("teleport")[0][0][3]
    assert np.linalg.norm(eng.T_wc[:3, 3] - T0[:3, 3]) < 0.05
    # the tick stands still while lost
    lost_ticks = [f["tick"] for f in frames if f["lost"]]
    assert len(set(lost_ticks)) == 1


def test_closure_frame_reads():
    """Host reads of a closure frame: its finish vector alone (the tracker,
    the tracking gate and the inactive-surfel predicate stay on the device),
    plus the decimated views of a keyframe the finish keeps.  On the CPU
    nothing syncs, so the reads are counted where they are made
    (`_device.read_calls`), the finish vector's length at its `PendingRead`."""
    cam = PortCam(**SMALL_CAM)
    eng = port_engine.Engine(PortConfig(camera=cam), device="cpu")
    ref_cam, _ = both_cams(SMALL_CAM)
    scene = make_scene(n_side=500)
    finish = []
    real = port_engine.PendingRead

    class Counting(real):
        def __init__(self, t):
            finish.append(t.numel())
            super().__init__(t)
    port_engine.PendingRead = Counting
    reads, kept = [], []
    try:
        for i in range(3):
            d, r = render_frame(scene[0], scene[1], pose_from_xyzrpy(x=0.01 * i), ref_cam)
            r0, k0 = _device.read_calls, len(eng.ferns.frames)
            eng.process_frame(r, d, timestamp=i)
            reads.append(_device.read_calls - r0)
            kept.append(len(eng.ferns.frames) - k0)
    finally:
        port_engine.PendingRead = real
    F, hw = eng.ferns.num, (-(-cam.height // 20)) * (-(-cam.width // 20))
    assert finish == [21 + F + 1 + 16 + 2 + 36 + 1 + 4 * hw + 4] * 2
    assert reads[1:] == [1 + k for k in kept[1:]] and kept[1] == 1


def gate_log(which: str, scale: str = "2") -> None:
    """Run by hand, not collected: the local scenario at `scale` times its
    resolution through one package ("ref" or "port"), its gates scaled by the
    pixel ratio as `chip_smoke.closure_config` scales them.  Prints each
    frame's model-to-model inliers, error and max diag(A^-1), and whether it
    closed:  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_closure.py ref 2
    (the reference takes ~8 minutes at 320x240 on a CPU)."""
    r = int(scale) ** 2
    kw = dict(SCENARIOS["local"])
    kw.update(max_surfels=kw["max_surfels"] * r, icp_count_threshold=2000 * r,
              icp_error_threshold=5e-4 / r ** 0.5, cov_threshold=1e-4 / r,
              def_graph_sample_rate=500 * r)
    ref_cam, port_cam = _cams(int(scale))
    if which == "ref":
        eng = RefEngine(RefConfig(camera=ref_cam, **kw))
    else:
        eng = port_engine.Engine(PortConfig(camera=port_cam, **kw), device="cpu")
    real = type(eng)._close_loops

    def logged(self, rec, *args):
        before = self.deforms
        real(self, rec, *args)
        err, cnt, A, inact = args[6:10]
        if inact > 0:
            try:
                cov = float(np.diag(np.linalg.inv(np.asarray(A, np.float64))).max())
            except np.linalg.LinAlgError:
                cov = float("inf")
            print(f"tick {rec['tick']}: inliers {cnt:.0f}, error {err:.4e}, max diag(A^-1) "
                  f"{cov:.4e}{' -> closed' if self.deforms > before else ''}", flush=True)
    type(eng)._close_loops = logged
    _drive(eng, _frames("local", int(scale))[0], None)


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    gate_log(*sys.argv[1:])
