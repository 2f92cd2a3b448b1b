"""The slice as a whole on the CPU: closure-free SLAM frames at 160x120
through the reference `slam_step` and the port's, both started from the same
converted state; the port's `Engine.process_frame` against its own
`slam_step` chain; and the rules around the slice (flags that raise, the
loop-closure and pipelined configurations, external poses and checkpoints
that run, no CPU fall-back, nothing of JAX imported by the port).

Held against the reference's `slam_step` with `fx16_clean=False` (the exact
float32 `clean`; both `slam_step`s honour the flag, which
tests/test_torch_fx16.py holds at its default, and both `Engine`s ignore it
in `_frame_main`)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, nn, rot_err, tt
from elasticfusion_tpu import engine as ref_engine
from elasticfusion_tpu.config import EngineConfig as RefConfig
from elasticfusion_tpu.utils.synthetic import make_scene, render_frame, synthetic_trajectory
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig

N_FRAMES = 4            # the first initialises the map, three are tracked
CAP = 1 << 16
CFG = dict(closeLoops=False, confidence_threshold=0.3, fx16_clean=False,
           initial_surfels=CAP, max_surfels=CAP)
WEIGHT = 0.5            # the velocity weight of a camera moving >= 1 cm a frame


@pytest.fixture(scope="module")
def frames():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    scene = make_scene(n_side=500)
    poses = synthetic_trajectory("sweep", 120)[:N_FRAMES]     # ~1 cm a frame
    rendered = [render_frame(scene[0], scene[1], T, ref_cam) for T in poses]
    return ref_cam, port_cam, poses, rendered


@pytest.fixture(scope="module")
def ref_chain(frames):
    """The reference: first-frame state, then `slam_step` per frame."""
    ref_cam, _, poses, rendered = frames
    cfg = RefConfig(camera=ref_cam, **CFG)

    @jax.jit
    def first(depth_mm, rgb, T):
        raw_m, filt_m = ref_engine._preprocess(depth_mm, cfg)
        m = ref_engine._init_map(raw_m, filt_m, rgb, cfg, CAP)
        one = jnp.float32(1.0)
        pred, fill, dense, _ = ref_engine._predict_only(
            m, T, one, one, filt_m, rgb, jnp.bool_(False), cfg)
        return m, ref_engine._coarse_intensity(rgb, cfg), pred, fill

    d0, rgb0 = rendered[0]
    T = jnp.asarray(poses[0], jnp.float32)
    m, so3, pred, fill = first(jnp.asarray(d0), jnp.asarray(rgb0), T)
    to_np = lambda t: {f: np.asarray(getattr(t, f)) for f in t._fields}  # noqa: E731
    state0 = dict(map=to_np(m), T=np.asarray(T), so3_hist=np.asarray(so3),
                  pred=to_np(pred), fill=tuple(np.asarray(a) for a in fill))
    steps = []
    for i in range(1, N_FRAMES):
        d, rgb = rendered[i]
        m, T, so3, fill, pred, dense, res = ref_engine.slam_step(
            m, T, so3, fill[0], fill[1], fill[2], jnp.asarray(d), jnp.asarray(rgb),
            jnp.float32(i + 1), jnp.float32(WEIGHT), cfg)
        steps.append(dict(T=np.asarray(T), count=int(m.count), dense=float(dense),
                          icp_count=float(res.icp_count)))
    return state0, steps


def _port_chain(port_cfg, rendered, m, state, select_by_dense=False, dense=None):
    """The port's `slam_step` per frame from a given state."""
    T, so3, pred, fill = state.T, state.so3_hist, state.pred, state.fill
    steps = []
    for i in range(1, N_FRAMES):
        d, rgb = rendered[i]
        if select_by_dense and float(dense) >= 0.75:      # as `_frame_main` selects
            target = (pred.vertex, pred.normal, pred.image)
        else:
            target = fill
        m, T, so3, fill, pred, dense, res = port_engine.slam_step(
            m, T, so3, target[0], target[1], target[2],
            tt(d.astype(np.float32)), tt(rgb), float(i + 1), WEIGHT, port_cfg)
        steps.append(dict(T=nn(T), count=int(m.count), dense=float(dense),
                          icp_count=float(res.icp_count), map=m))
    return steps


def test_slice_matches_reference_slam_step(frames, ref_chain):
    _, port_cam, poses, rendered = frames
    state0, ref_steps = ref_chain
    port_cfg = PortConfig(camera=port_cam, **CFG)
    m = convert.surfel_map_from_numpy(state0["map"], "cpu")
    state = convert.engine_state_from_numpy(state0, "cpu")
    port_steps = _port_chain(port_cfg, rendered, m, state)
    for i, (p, r) in enumerate(zip(port_steps, ref_steps)):
        # per frame: 1e-3 m, 1e-3 rad, 1 % of the surfels
        assert np.linalg.norm(p["T"][:3, 3] - r["T"][:3, 3]) < 1e-3, f"frame {i + 1}"
        assert rot_err(p["T"], r["T"]) < 1e-3, f"frame {i + 1}"
        assert abs(p["count"] - r["count"]) <= 0.01 * r["count"], f"frame {i + 1}"
        assert abs(p["dense"] - r["dense"]) < 0.01
        assert r["count"] > 10000 and r["icp_count"] > 5000
        # and both follow the rendered trajectory (1 cm a frame) to 5 mm
        gt = np.asarray(poses[i + 1])
        assert np.linalg.norm(p["T"][:3, 3] - gt[:3, 3]) < 5e-3
        assert np.linalg.norm(r["T"][:3, 3] - gt[:3, 3]) < 5e-3


def test_engine_equals_its_own_slam_step_chain(frames):
    """`Engine.process_frame` (first frame + `_frame_main`) against a chain
    of the port's `slam_step` fed what the engine would feed it: bit-equal
    poses and maps.  compact_every=1 because `slam_step` always compacts."""
    _, port_cam, poses, rendered = frames
    cfg = PortConfig(camera=port_cam, compact_every=1, **CFG)
    eng = port_engine.Engine(cfg, device="cpu")
    results = [eng.process_frame(rgb, d, timestamp=i, in_T_wc=poses[0] if i == 0 else None)
               for i, (d, rgb) in enumerate(rendered)]

    d0, rgb0 = rendered[0]
    raw_m, filt_m = port_engine._preprocess(tt(d0.astype(np.float32)), cfg)
    m = port_engine._init_map(raw_m, filt_m, tt(rgb0), cfg, CAP)
    T0 = tt(np.asarray(poses[0], np.float32))
    one = torch.tensor(1.0)
    pred, fill, dense, _ = port_engine._predict_only(
        m, T0, one, one, filt_m, tt(rgb0), False, cfg)
    state = convert.EngineState(
        T=T0, so3_hist=port_engine._coarse_intensity(tt(rgb0), cfg), pred=pred, fill=fill)
    steps = _port_chain(cfg, rendered, m, state, select_by_dense=True, dense=dense)

    assert eng.map.capacity == CAP and eng.tick == N_FRAMES + 1
    for res, step in zip(results[1:], steps):
        np.testing.assert_array_equal(res.T_wc[:3, 3].astype(np.float32), step["T"][:3, 3])
        assert res.surfel_count == step["count"] and res.fused and res.tracking_ok
    for f in ("pos", "conf", "color", "normal", "radius", "init_t", "last_t"):
        assert torch.equal(getattr(eng.map, f), getattr(steps[-1]["map"], f)), f
    assert [ts for ts, _ in eng.poses] == list(range(N_FRAMES))
    assert eng.surfel_count == steps[-1]["count"]


def test_engine_grows_the_map_before_it_overflows(frames):
    _, port_cam, poses, rendered = frames
    cfg = PortConfig(camera=port_cam, closeLoops=False, confidence_threshold=0.3)
    eng = port_engine.Engine(cfg, device="cpu")
    d, rgb = rendered[0]
    eng.process_frame(rgb, d)
    cap0 = eng.map.capacity
    assert cap0 == port_engine._next_bucket(19200 + 4800, cfg.max_surfels) == 1 << 16
    eng._count_finished = int(0.9 * cap0)           # pretend the map filled up
    eng.process_frame(rendered[1][1], rendered[1][0])
    assert eng.map.capacity > cap0 and eng.map.capacity % 8192 == 0
    assert eng.surfel_count < cap0 and np.isfinite(eng.T_wc).all()


@pytest.mark.parametrize("flags,item", [
    # mesh_shape is ported now: tests/test_torch_shard.py
    pytest.param(dict(fx16_tables=True), "M12", id="flags1-M12"),
])
def test_unported_flags_raise(frames, flags, item):
    """The flags that once raised (ROADMAP `item`) are ported: the Engine with
    each runs two frames, its pose within the reference's fx16 on/off bound
    (0.5 mm / 0.05 deg, tests/test_gatherpack.py) of the Engine without it."""
    _, port_cam, poses, rendered = frames
    got = {}
    for on in (False, True):
        cfg = PortConfig(**{"camera": port_cam, "closeLoops": False,
                            **(flags if on else {})})
        eng = port_engine.Engine(cfg, device="cpu")
        for i in range(2):
            d, rgb = rendered[i]
            res = eng.process_frame(rgb, d, timestamp=i)
        assert res.tracking_ok and not res.lost and eng.tick == 3
        got[on] = res.T_wc
    assert np.linalg.norm(got[True][:3, 3] - got[False][:3, 3]) < 5e-4
    assert rot_err(got[True], got[False]) < np.deg2rad(0.05)
    assert np.linalg.norm(got[True][:3, 3] - poses[1][:3, 3]) < 5e-3


@pytest.mark.parametrize("flags", [dict(), dict(reloc_mode=True)],
                         ids=["closeLoops", "reloc_mode"])
def test_pipelined_configs_construct_and_run(frames, flags):
    """`pipeline_depth=2` with the default `closeLoops` and with
    `reloc_mode`: two frames stay in flight until `flush` finishes them, and
    with nothing to close the poses and the map equal depth 0's bit for
    bit."""
    _, port_cam, poses, rendered = frames
    engines = {}
    for depth in (0, 2):
        eng = port_engine.Engine(
            PortConfig(camera=port_cam, pipeline_depth=depth, **flags), device="cpu")
        for i, (d, rgb) in enumerate(rendered):
            eng.process_frame(rgb, d, timestamp=i)
        engines[depth] = eng
    eng = engines[2]
    assert len(eng._inflight) == 2 and len(eng.tick_poses) == N_FRAMES - 2
    assert eng.tick == N_FRAMES + 1                   # the tick advances at dispatch
    eng.flush()
    assert not eng._inflight and [ts for ts, _ in eng.poses] == list(range(N_FRAMES))
    for (_, T), (_, T0) in zip(eng.poses, engines[0].poses):
        assert np.array_equal(T, T0)
    assert eng.surfel_count == engines[0].surfel_count
    assert torch.equal(eng.map.pos, engines[0].map.pos)
    # a frame is scored against the keyframe DB as it stood at its dispatch,
    # so frames dispatched before the first keyframe was added become
    # keyframes too (as in the reference at depth 2)
    assert len(eng.ferns.frames) >= len(engines[0].ferns.frames) >= 1


@pytest.mark.parametrize("flags", [dict(), dict(reloc_mode=True)],
                         ids=["defaults", "reloc_mode"])
def test_loop_closure_configs_construct_and_run(frames, flags):
    """`Engine(EngineConfig(camera=...))` — the defaults, `closeLoops=True` —
    and the same with `reloc_mode` construct and process two frames."""
    _, port_cam, poses, rendered = frames
    cfg = PortConfig(camera=port_cam, **flags)
    assert cfg.closeLoops
    eng = port_engine.Engine(cfg, device="cpu")
    for i in range(2):
        d, rgb = rendered[i]
        res = eng.process_frame(rgb, d, timestamp=i)
    assert eng.tick == 3 and res.tracking_ok and not res.lost and res.fused
    assert np.linalg.norm(res.T_wc[:3, 3] - poses[1][:3, 3]) < 5e-3
    assert len(eng.ferns.frames) == 1 and eng.local_deformation is not None


def test_unported_entry_points_raise(frames):
    """The entry points that once raised run: `slam_step` with fx16_clean
    (the default) and with `fx16_tables` tracks the next frame from the
    first one's state, its pose within the reference's fx16 on/off bound of
    the float32 tables' and its map the same size within 1 %."""
    _, port_cam, poses, rendered = frames
    cfg = PortConfig(camera=port_cam, closeLoops=False)
    eng = port_engine.Engine(cfg, device="cpu")
    d, rgb = rendered[0]
    eng.process_frame(rgb, d, in_T_wc=poses[0])
    d1, rgb1 = rendered[1]
    out = {}
    for on in (False, True):
        out[on] = port_engine.slam_step(eng.map, eng._T_f32, eng._so3_hist, *eng._fill,
                                        tt(d1.astype(np.float32)), tt(rgb1), 2.0, 1.0,
                                        cfg.with_(fx16_tables=on))
    (m16, T16), (m32, T32) = out[True][:2], out[False][:2]
    T16, T32 = nn(T16).astype(np.float64), nn(T32).astype(np.float64)
    assert np.linalg.norm(T16[:3, 3] - T32[:3, 3]) < 5e-4
    assert rot_err(T16, T32) < np.deg2rad(0.05)
    assert np.linalg.norm(T16[:3, 3] - poses[1][:3, 3]) < 5e-3
    assert abs(int(m16.count) - int(m32.count)) <= 0.01 * int(m32.count)


def test_external_poses_after_the_first_frame_run(frames):
    """`in_T_wc` on every frame: the given poses come back, the map fuses,
    no frame is tracked."""
    _, port_cam, poses, rendered = frames
    eng = port_engine.Engine(PortConfig(camera=port_cam, closeLoops=False), device="cpu")
    counts = []
    for i, (d, rgb) in enumerate(rendered):
        res = eng.process_frame(rgb, d, timestamp=i, in_T_wc=poses[i])
        np.testing.assert_allclose(res.T_wc, poses[i], rtol=0, atol=1e-9)
        counts.append(res.surfel_count)
    assert res.fused and eng.tick == N_FRAMES + 1 and counts[-1] > counts[0]


def test_checkpoint_restores_and_tracks_on(frames, tmp_path):
    """`save_checkpoint` after two frames, `load_checkpoint` on the CPU,
    then the last two frames through the restored engine."""
    from elasticfusion_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    _, port_cam, poses, rendered = frames
    cfg = PortConfig(camera=port_cam, **CFG)
    eng = port_engine.Engine(cfg, device="cpu")
    for i, (d, rgb) in enumerate(rendered[:2]):
        eng.process_frame(rgb, d, timestamp=i, in_T_wc=poses[0] if i == 0 else None)
    save_checkpoint(tmp_path / "ck.npz", eng)
    eng2 = load_checkpoint(tmp_path / "ck.npz", cfg, device="cpu")
    assert eng2.tick == eng.tick and eng2.surfel_count == eng.surfel_count
    for i, (d, rgb) in enumerate(rendered[2:], start=2):
        eng2.process_frame(rgb, d, timestamp=i)
    assert [ts for ts, _ in eng2.poses] == list(range(N_FRAMES))
    assert np.linalg.norm(eng2.T_wc[:3, 3] - poses[-1][:3, 3]) < 5e-3


def test_engine_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engine.Engine(PortConfig(closeLoops=False))


def test_port_imports_neither_jax_nor_the_reference_package():
    code = (
        "import sys\n"
        "import elasticfusion_tpu_torch\n"
        "import elasticfusion_tpu_torch.engine, elasticfusion_tpu_torch.convert\n"
        "import elasticfusion_tpu_torch.utils.synthetic, elasticfusion_tpu_torch.utils.stopwatch\n"
        "import elasticfusion_tpu_torch.checkpoint, elasticfusion_tpu_torch.io\n"
        "from elasticfusion_tpu_torch.tools import camera, eval_suite, report, run_slam, view_map\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'elasticfusion_tpu' or m.startswith('elasticfusion_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('clean')\n"
    )
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
