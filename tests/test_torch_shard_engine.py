"""The `mesh_shape` engine of both packages on the CPU, and loop closure on
sub-maps.

  - `EngineConfig(mesh_shape=(2,))` (fx16_clean on, the default, which both
    packages' sharded clean honours), 160x120, three frames with a capacity
    growth before the first tracked one: the port against the reference's
    engine on an 8-device virtual CPU mesh at the slice's tolerance (1e-3 m,
    1e-3 rad, 1 % of the surfels a frame) and the same capacities;
  - which patch the `Engine`'s frame cleans on: the fx16 one exactly when
    the map is sharded and `fx16_clean` is on, as in the reference (its
    one-device `_frame_main` cleans on the exact patch, engine.py:404-415;
    its shard region with `cfg.fx16_clean`, shard_step.py:335);
  - the there-and-back run of `tests/test_torch_closure.py` ("local": the
    test_closeloop.py gates) at S = 1 and 2, shards on the CPU: the closure
    decisions, the repair (`_apply_closure` on sub-maps) and the node sample
    run; S = 1 is the one-device engine bit for bit, S = 2 closes and ends
    within 1 cm of the truth and of S = 1.

The reference engine's output comes from a run on an 8-device virtual CPU
mesh, committed (`REFERENCE_OUTPUTS` below)."""

import pickle

import numpy as np
import pytest

from _torch_parity import SMALL_CAM, both_cams, reference_output, rot_err
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig
from elasticfusion_tpu_torch.parallel import shard_step
from elasticfusion_tpu_torch.parallel.shard_step import ShardedMap

MESH = dict(closeLoops=False, confidence_threshold=0.3, mesh_shape=(2,))
N_FRAMES = 3
LOCAL = dict(max_surfels=1 << 17, confidence_threshold=0.3, time_delta=6,
             icp_count_threshold=2000, icp_error_threshold=5e-4,
             cov_threshold=1e-4, fern_min_age=1000, def_graph_sample_rate=500)


def _sweep(cam):
    from elasticfusion_tpu_torch.utils.synthetic import (
        make_scene,
        render_frame,
        synthetic_trajectory,
    )

    scene = make_scene(n_side=500)
    poses = synthetic_trajectory("sweep", 120)[:N_FRAMES]
    return poses, [render_frame(scene[0], scene[1], T, cam) for T in poses]


def _drive_growing(eng, rendered):
    """The frames, with the growth trigger set before the first tracked one
    (as when the fullest shard nears capacity): one growth, and one compile
    of each frame program in the reference."""
    out = []
    for i, (d, rgb) in enumerate(rendered):
        if i == 1:
            S = eng.cfg.mesh_shape[0]
            cap_l = eng.map.capacity // S
            eng._count_finished = int(0.9 * cap_l) * S
            eng._count_max_finished = int(0.9 * cap_l)
        res = eng.process_frame(rgb, d, timestamp=i)
        out.append(dict(T=res.T_wc.copy(), count=res.surfel_count,
                        capacity=eng.map.capacity))
    return out


def reference_mesh_engine(out_path):
    """In the child (8 virtual CPU devices): the reference's engine."""
    from elasticfusion_tpu import engine as ref_engine
    from elasticfusion_tpu.config import EngineConfig as RefConfig

    ref_cam, _ = both_cams(SMALL_CAM)
    _, rendered = _sweep(ref_cam)
    run = _drive_growing(ref_engine.Engine(RefConfig(camera=ref_cam, **MESH)), rendered)
    with open(out_path, "wb") as f:
        pickle.dump(run, f)


# the committed output of this run, read by the tests below (`_torch_parity.reference_output`):
# name -> (function, arguments, cpu_devices)
REFERENCE_OUTPUTS = {"shard_engine_mesh": ("reference_mesh_engine", (), 8)}


def _local_frames(cam):
    from elasticfusion_tpu_torch.utils.synthetic import (
        make_scene,
        pose_from_xyzrpy,
        render_frame,
    )

    scene = make_scene(n_side=700)
    out = []
    for i in range(16):
        s = i if i < 8 else (2 * 8 - i - 1)
        T = pose_from_xyzrpy(x=0.035 * s, yaw=0.012 * s)
        d, r = render_frame(scene[0], scene[1], T, cam)
        out.append((r, d, T))
    return out


@pytest.fixture(scope="module")
def closures():
    """The local-closure run at one device, S = 1 and S = 2."""
    _, cam = both_cams(SMALL_CAM)
    frames = _local_frames(cam)
    runs = {}
    for S in (None, 1, 2):
        cfg = PortConfig(camera=cam, fx16_clean=False,
                         mesh_shape=None if S is None else (S,), **LOCAL)
        eng = port_engine.Engine(cfg, device="cpu")
        poses = [eng.process_frame(r, d, timestamp=i).T_wc.copy()
                 for i, (r, d, _) in enumerate(frames)]
        runs[S] = dict(engine=eng, poses=poses)
    return frames, runs


def test_closures_on_sub_maps(closures):
    frames, runs = closures
    one, s1, s2 = runs[None], runs[1], runs[2]
    assert one["engine"].deforms >= 1
    # S = 1: the one-device engine through every closure, bit for bit
    assert s1["engine"].deforms == one["engine"].deforms
    for a, b in zip(one["poses"], s1["poses"]):
        assert np.array_equal(a, b)
    ma, mb = one["engine"].export_map(), s1["engine"].export_map()
    n = int(ma.count)
    assert n == int(mb.count)
    for f in ("pos", "conf", "init_t", "last_t", "normal"):
        assert np.array_equal(getattr(ma, f)[..., :n].numpy(),
                              getattr(mb, f)[..., :n].numpy()), f
    # S = 2: closes on sub-maps and ends where the truth and S = 1 end
    eng = s2["engine"]
    assert isinstance(eng.map, ShardedMap) and eng.deforms >= 1
    truth = frames[-1][2]
    assert np.linalg.norm(s2["poses"][-1][:3, 3] - truth[:3, 3]) < 1e-2
    assert np.linalg.norm(s2["poses"][-1][:3, 3] - one["poses"][-1][:3, 3]) < 1e-2
    assert abs(eng.surfel_count - one["engine"].surfel_count) <= 0.02 * eng.surfel_count


def test_mesh_engine_matches_the_references_mesh_engine():
    _, cam = both_cams(SMALL_CAM)
    _, rendered = _sweep(cam)
    port = _drive_growing(port_engine.Engine(PortConfig(camera=cam, **MESH),
                                             device="cpu"), rendered)
    want = reference_output("shard_engine_mesh")
    assert [r["capacity"] for r in port] == [r["capacity"] for r in want]
    assert port[-1]["capacity"] > port[0]["capacity"]
    for i, (p, r) in enumerate(zip(port, want)):
        assert np.linalg.norm(p["T"][:3, 3] - r["T"][:3, 3]) < 1e-3, f"frame {i}"
        assert rot_err(p["T"], r["T"]) < 1e-3, f"frame {i}"
        assert abs(p["count"] - r["count"]) <= 0.01 * r["count"], f"frame {i}"


@pytest.mark.parametrize("mesh,fx16", [(None, True), ((2,), True), ((2,), False)])
def test_engine_frame_cleans_on_the_references_patch(monkeypatch, mesh, fx16):
    seen = []

    def spy(real):
        def clean(*a, fx16_patch=False, **kw):
            seen.append(fx16_patch)
            return real(*a, fx16_patch=fx16_patch, **kw)
        return clean
    monkeypatch.setattr(port_engine, "clean", spy(port_engine.clean))
    monkeypatch.setattr(shard_step, "clean", spy(shard_step.clean))
    _, cam = both_cams(SMALL_CAM)
    _, rendered = _sweep(cam)
    cfg = PortConfig(camera=cam, closeLoops=False, confidence_threshold=0.3,
                     fx16_clean=fx16, mesh_shape=mesh)
    eng = port_engine.Engine(cfg, device="cpu")
    for i, (d, rgb) in enumerate(rendered[:2]):
        eng.process_frame(rgb, d, timestamp=i)
    eng.flush()
    shards = 1 if mesh is None else mesh[0]
    assert seen == [fx16 and mesh is not None] * shards
