"""Checkpoints of the port (`elasticfusion_tpu_torch/checkpoint.py`) on the
CPU: the round trip of `tests/test_checkpoint.py` within the port, the
loop-closure carry state of a real closure, the version gate, and the npz
schema across packages — a checkpoint written by the reference (in a child
interpreter) loads in the port with the same state and tracks on, and one
written by the port loads in the reference with the same fields."""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, run_reference_child
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch.checkpoint import FORMAT_VERSION, load_checkpoint, save_checkpoint
from elasticfusion_tpu_torch.config import CameraConfig as PortCam
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig

# tests/test_checkpoint.py:14-15
ROUND_TRIP = dict(max_surfels=1 << 16, confidence_threshold=0.3)
# tests/test_pipeline.py:22-37 at depth 0: a local closure at tick 7
CLOSURE = dict(max_surfels=1 << 17, confidence_threshold=0.3, time_delta=6,
               icp_count_threshold=2000, icp_error_threshold=5e-4, cov_threshold=1e-4,
               fern_min_age=1000, def_graph_sample_rate=500)
MAP_FIELDS = ("pos", "conf", "color", "init_t", "last_t", "normal", "radius")
FERN_FIELDS = ("codes", "good_codes", "T_wc", "src_time", "rgb", "verts", "norms")
# the reference checkpoint: a first frame at this pose, then keyframes and
# closure carry state put in as a closure would leave them
REF_T0 = pose_from_xyzrpy(x=0.05, y=-0.02, yaw=0.03)


def _sweep(n, step=(0.015, 0.006)):
    ref_cam, _ = both_cams(SMALL_CAM)
    scene = make_scene(n_side=700)
    out = []
    for i in range(n):
        T = pose_from_xyzrpy(x=step[0] * i, yaw=step[1] * i)
        d, r = render_frame(scene[0], scene[1], T, ref_cam)
        out.append((r, d, i * 33000, T))
    return out


def _there_back(n=16):
    ref_cam, _ = both_cams(SMALL_CAM)
    scene = make_scene(n_side=700)
    out = []
    for i in range(n):
        s = i if i < n // 2 else (n - i - 1)
        T = pose_from_xyzrpy(x=0.035 * s, yaw=0.012 * s)
        d, r = render_frame(scene[0], scene[1], T, ref_cam)
        out.append((r, d, i * 33000, T))
    return out


def engine_state(eng) -> dict:
    """What a checkpoint holds of an engine of either package, as numpy."""
    n = int(np.asarray(eng.map.count))
    fields = {f: np.asarray(getattr(eng.map, f))[..., :n].copy() for f in MAP_FIELDS}
    return dict(
        tick=eng.tick, T_wc=np.asarray(eng.T_wc), lost=eng.lost,
        tracking_count=eng.tracking_count, deforms=eng.deforms,
        fern_deforms=eng.fern_deforms, count=n, capacity=eng.map.capacity, map=fields,
        tick_poses=[(t, np.asarray(T)) for t, T in eng.tick_poses],
        pose_times=list(eng.pose_times),
        ferns=[{k: np.asarray(getattr(f, k)) for k in FERN_FIELDS} for f in eng.ferns.frames],
        relative=[(c.src, c.target, c.src_time, c.target_time, c.relative)
                  for c in eng.relative_cons],
        clocks=(eng.local_deformation.last_deform_time, eng.local_deformation.deforms,
                eng.global_deformation.last_deform_time, eng.global_deformation.deforms),
    )


def reference_checkpoints(out_path, port_ckpt, ref_ckpt):
    """In the child: load the port's checkpoint into the reference, and
    write a reference checkpoint (first frame at REF_T0, one fern keyframe
    of its prediction, closure carry state as `tests/test_checkpoint.py`
    puts it in)."""
    from elasticfusion_tpu.checkpoint import load_checkpoint as ref_load
    from elasticfusion_tpu.checkpoint import save_checkpoint as ref_save
    from elasticfusion_tpu.config import EngineConfig as RefConfig
    from elasticfusion_tpu.deformation import HostConstraint
    from elasticfusion_tpu.engine import Engine as RefEngine

    ref_cam, _ = both_cams(SMALL_CAM)
    out = dict(loaded=engine_state(ref_load(port_ckpt, RefConfig(camera=ref_cam, **CLOSURE))))
    eng = RefEngine(RefConfig(camera=ref_cam, **ROUND_TRIP))
    r, d, _, _ = _sweep(1)[0]
    eng.process_frame(r, d, timestamp=7, in_T_wc=REF_T0)
    eng.ferns.add_frame(eng._pred.image, eng._pred.vertex, eng._pred.normal, REF_T0, 1)
    eng.relative_cons = [
        HostConstraint([0.1, 0.2, 1.9], [0.11, 0.19, 1.9], 2, 1, relative=True),
        HostConstraint([-0.3, 0.0, 2.1], [-0.29, 0.01, 2.1], 3, 1, relative=True),
    ]
    eng.local_deformation.last_deform_time = 2
    eng.local_deformation.deforms = 1
    eng.global_deformation.deforms = 3
    eng.deforms = 1
    ref_save(ref_ckpt, eng)
    out["written"] = engine_state(eng)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _port(**kw):
    return port_engine.Engine(PortConfig(camera=PortCam(**SMALL_CAM), **kw), device="cpu")


def _load(path, **kw):
    return load_checkpoint(path, PortConfig(camera=PortCam(**SMALL_CAM), **kw), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    # a real local closure (tick 7), checkpointed after frame 9
    closing = _port(**CLOSURE)
    for r, d, ts, _ in _there_back()[:9]:
        closing.process_frame(r, d, timestamp=ts)
    save_checkpoint(tmp / "port_closure.npz", closing)
    # the reference's child runs in the background while the port runs on
    pool = ThreadPoolExecutor(1)
    child = pool.submit(run_reference_child, "test_torch_checkpoint:reference_checkpoints",
                        tmp / "ref.pkl", str(tmp / "port_closure.npz"), str(tmp / "ref.npz"),
                        timeout=150.0)
    pool.shutdown(wait=False)
    # tests/test_checkpoint.py:13-44 within the port
    frames = _sweep(9)
    eng = _port(**ROUND_TRIP)
    for r, d, ts, _ in frames[:6]:
        eng.process_frame(r, d, timestamp=ts)
    save_checkpoint(tmp / "port.npz", eng)
    eng2 = _load(tmp / "port.npz", **ROUND_TRIP)
    loaded = engine_state(eng2)
    for r, d, ts, _ in frames[6:]:
        eng2.process_frame(r, d, timestamp=ts)
    return dict(tmp=tmp, saved=engine_state(eng), loaded=loaded, resumed=eng2,
                frames=frames, closing=closing, child=child)


@pytest.fixture(scope="module")
def ref(runs):
    return runs["child"].result()


def _same_state(got, want, exact_capacity=True):
    for k in ("tick", "lost", "tracking_count", "deforms", "fern_deforms", "count",
              "pose_times", "clocks"):
        assert got[k] == want[k], k
    if exact_capacity:
        assert got["capacity"] == want["capacity"]
    assert np.array_equal(got["T_wc"], want["T_wc"])
    for f in MAP_FIELDS:
        assert np.array_equal(got["map"][f], want["map"][f]), f
    assert [t for t, _ in got["tick_poses"]] == [t for t, _ in want["tick_poses"]]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got["tick_poses"],
                                                                want["tick_poses"]))
    assert len(got["ferns"]) == len(want["ferns"])
    for a, b in zip(got["ferns"], want["ferns"]):
        for k in FERN_FIELDS:
            assert np.array_equal(a[k], b[k]), k
    assert len(got["relative"]) == len(want["relative"])
    for a, b in zip(got["relative"], want["relative"]):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def test_round_trip_within_the_port(runs):
    """The state comes back exactly (capacity: the bucket of twice the
    count), and the resumed engine tracks on: under 2 cm after 3 frames
    (tests/test_checkpoint.py:43-44)."""
    saved, loaded = runs["saved"], runs["loaded"]
    _same_state(loaded, saved, exact_capacity=False)
    assert loaded["capacity"] == port_engine._next_bucket(2 * saved["count"], 1 << 16)
    assert len(loaded["ferns"]) >= 1
    eng2 = runs["resumed"]
    assert eng2.tick == saved["tick"] + 3 and len(eng2.poses) == 9
    T = runs["frames"][-1][3]
    assert np.linalg.norm(eng2.T_wc[:3, 3] - T[:3, 3]) < 0.02


def test_restored_fern_db_is_on_the_device(runs):
    """The keyframes go back into the engine's device DB (what the frame
    scores against), row by row."""
    eng2 = runs["resumed"]
    codes, good, times, n = eng2.ferns.device_db()
    assert n == len(eng2.ferns.frames) >= 1
    for i, f in enumerate(eng2.ferns.frames):
        assert torch.equal(codes[i], torch.from_numpy(f.codes.astype(np.int32)))
        assert float(good[i]) == f.good_codes and float(times[i]) == f.src_time


def test_loop_closure_state_is_carried(runs):
    """A real local closure's carry state — relative constraints and both
    deformations' clocks — survives the round trip."""
    closing = runs["closing"]
    assert closing.deforms >= 1 and closing.relative_cons
    eng2 = _load(runs["tmp"] / "port_closure.npz", **CLOSURE)
    _same_state(engine_state(eng2), engine_state(closing), exact_capacity=False)
    assert all(c.relative for c in eng2.relative_cons)
    assert eng2.local_deformation.last_deform_time == closing.local_deformation.last_deform_time > 0


def test_version_gate(tmp_path):
    np.savez_compressed(tmp_path / "bad.npz", version=FORMAT_VERSION + 98, tick=1)
    with pytest.raises(ValueError, match="version"):
        _load(tmp_path / "bad.npz")


def test_restore_needs_a_card_unless_the_cpu_is_asked_for(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(runs["tmp"] / "port.npz", PortConfig(camera=PortCam(**SMALL_CAM)))


def test_port_checkpoint_loads_in_the_reference(runs, ref):
    """The reference's `load_checkpoint` of the port's npz: every field equal
    to the port engine's (the capacity is each loader's own bucket)."""
    _same_state(ref["loaded"], engine_state(runs["closing"]), exact_capacity=False)


def test_reference_checkpoint_loads_in_the_port_and_tracks_on(runs, ref, tmp_path):
    """The reference's npz in the port: tick, count, pose, positions, fern DB
    and carry state exactly; the capacity the reference's rule gives; then
    the restored engine regenerates its prediction from the next frame and
    tracks 3 frames of a sweep starting at the restored pose to under 2 cm."""
    want = ref["written"]
    eng = _load(runs["tmp"] / "ref.npz", **ROUND_TRIP)
    got = engine_state(eng)
    _same_state(got, want, exact_capacity=False)
    assert got["capacity"] == port_engine._next_bucket(2 * want["count"], 1 << 16)
    assert eng._pred is None and eng._T_f32 is None
    ref_cam, _ = both_cams(SMALL_CAM)
    scene = make_scene(n_side=700)
    for i in range(1, 4):
        T = REF_T0 @ pose_from_xyzrpy(x=0.01 * i, yaw=0.004 * i)
        d, r = render_frame(scene[0], scene[1], T, ref_cam)
        res = eng.process_frame(r, d, timestamp=7 + i)
    assert res.tracking_ok and eng.tick == want["tick"] + 3
    assert np.linalg.norm(eng.T_wc[:3, 3] - T[:3, 3]) < 0.02
