"""`tools/scaling_bench.py` of the port on the CPU (every sub-map on the CPU
device), at `-n 2 -cap 14 -frames 2`:

  - `main` and `-crossover` print JSON with the reference tool's keys, and
    the collectives per step are the group's `calls` over the timed steps
    divided by the steps;
  - the S = 1 leg is the one-device `slam_step` bit for bit;
  - the S = 2 leg, booted as the reference boots it (the first frame in
    shard 0), against the reference's S = 2 `make_shardmap_step` leg run the
    same way on a 2-device virtual CPU mesh (its committed output): the
    bounds of
    `test_torch_shard.py::test_shardmap_step_matches_the_one_device_step`,
    poses < 1e-3 m and 1e-3 on each rotation element, and per-shard counts
    within 1 % (the bound of `chip_smoke.py` phase 7 (c))."""

import contextlib
import io
import json
import pickle

import numpy as np
import pytest
import torch

from _torch_parity import reference_output
from elasticfusion_tpu_torch.parallel import shard_step
from elasticfusion_tpu_torch.tools import scaling_bench

ARGS = ["-n", "2", "-cap", "14", "-frames", "2", "-device", "cpu"]
N, CAP_LOG2, FRAMES = 2, 14, 2

# the keys of the reference tool's JSON (elasticfusion_tpu/tools/scaling_bench.py)
MAIN_KEYS = {"backend", "capacity", "gspmd", "shard_map"}
LEG_KEYS = {"ms_per_step", "speedup", "efficiency", "collectives"}
CROSSOVER_KEYS = {"capacity", "live", "camera", "backend", "results",
                  "work_ratio_Nway_vs_1"}
RESULT_KEYS = {"wall_ms_per_step", "cpu_s_per_step", "cpu_us_per_Msurfel"}


def reference_shard_leg(out_path, n, cap_log2, frames):
    """In the child (n virtual CPU devices): the shard_map leg of the
    reference's `scaling_bench.main` at n sub-maps — its boot (the first
    frame into shard 0) and `frames` steps — returning the per-shard counts
    and the poses."""
    import jax
    import jax.numpy as jnp

    from elasticfusion_tpu.config import CameraConfig, EngineConfig
    from elasticfusion_tpu.ops.preprocess import metricise_depth
    from elasticfusion_tpu.parallel.shard_step import make_shardmap_step, shard_empty_map
    from elasticfusion_tpu.parallel.sharding import make_mesh, replicate
    from elasticfusion_tpu.surfels import init_map_from_frame
    from elasticfusion_tpu.utils.synthetic import make_scene, render_frame

    n, cap_log2, frames = int(n), int(cap_log2), int(frames)
    w, h = 320, 240
    cam = CameraConfig(width=w, height=h, fx=264.0, fy=264.0, cx=160.0, cy=120.0)
    cfg = EngineConfig(camera=cam, max_surfels=1 << cap_log2, confidence_threshold=0.3)
    scene = make_scene(n_side=900)
    depth_mm, rgb = render_frame(scene[0], scene[1], np.eye(4), cam)
    raw = metricise_depth(jnp.asarray(depth_mm, jnp.float32), cfg.depth_cutoff)
    m0 = init_map_from_frame(cfg.max_surfels, raw, raw, jnp.asarray(rgb), cam,
                             cfg.depth_cutoff)
    mesh = make_mesh(n)
    step = make_shardmap_step(cfg, mesh)
    cap_l = cfg.max_surfels // n
    n0 = int(m0.count)
    ms = shard_empty_map(cfg.max_surfels, mesh)
    upd = {}
    for k in ("pos", "conf", "color", "init_t", "last_t", "normal", "radius"):
        full = np.zeros(getattr(ms, k).shape, np.float32)
        keep = min(n0, cap_l)
        full[..., :keep] = np.asarray(jax.device_get(getattr(m0, k)))[..., :keep]
        upd[k] = jax.device_put(jnp.asarray(full), getattr(ms, k).sharding)
    counts = np.zeros((n,), np.int32)
    counts[0] = min(n0, cap_l)
    upd["count"] = jax.device_put(jnp.asarray(counts), ms.count.sharding)
    mm = ms._replace(**upd)
    mk = lambda x: replicate(x, mesh)  # noqa: E731
    poses = []
    for i in range(frames):
        out = step(mm, mk(jnp.eye(4, dtype=jnp.float32)),
                   mk(jnp.zeros((h >> 2, w >> 2), jnp.float32)),
                   mk(jnp.zeros((3, h, w), jnp.float32)),
                   mk(jnp.zeros((3, h, w), jnp.float32)),
                   mk(jnp.zeros((h, w, 3), jnp.float32)),
                   mk(jnp.asarray(depth_mm)), mk(jnp.asarray(rgb)),
                   mk(jnp.float32(2.0 + i)), mk(jnp.float32(1.0)))
        mm = out[0]
        poses.append(np.asarray(out[1]))
    with open(out_path, "wb") as f:
        pickle.dump(dict(counts=np.asarray(jax.device_get(mm.count)), poses=poses), f)


# the committed output of this run, read by the tests below (`_torch_parity.reference_output`):
# name -> (function, arguments, cpu_devices)
REFERENCE_OUTPUTS = {"scaling_bench_shard_leg": ("reference_shard_leg",
                                                 (str(N), str(CAP_LOG2), str(FRAMES)), N)}


@pytest.fixture(scope="module")
def runs():
    kept = {}

    def keep(fn, key):
        def wrapper(*a, **k):
            kept[key] = fn(*a, **k)
            return kept[key]
        return wrapper

    printed = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scaling_bench, "bench", keep(scaling_bench.bench, "main"))
        mp.setattr(scaling_bench, "crossover_bench",
                   keep(scaling_bench.crossover_bench, "crossover"))
        for key, argv in (("main", ARGS), ("crossover", ["-crossover"] + ARGS)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert scaling_bench.main(argv) == 0
            printed[key] = json.loads(buf.getvalue())
    return dict(printed=printed, kept=kept, ref=reference_output("scaling_bench_shard_leg"))


def _check_collectives(collectives, calls, steps):
    want = {}
    for k, v in calls.items():
        name = scaling_bench.COLLECTIVE_NAMES[k]
        want[name] = want.get(name, 0.0) + v / steps
    assert collectives == want and sum(calls.values()) > 0


def test_main_prints_the_references_keys_and_the_groups_calls(runs):
    out, (_, legs) = runs["printed"]["main"], runs["kept"]["main"]
    assert out == json.loads(json.dumps(runs["kept"]["main"][0]))
    assert MAIN_KEYS <= set(out) and out["capacity"] == 1 << CAP_LOG2
    for leg in ("gspmd", "shard_map"):
        assert LEG_KEYS <= set(out[leg])
    g = out["gspmd"]
    assert g["ms_per_step"]["1"] > 0 and g["ms_per_step"]["2"] is None
    assert g["speedup"] is None and g["efficiency"] is None and g["note"]
    sm = out["shard_map"]
    assert set(sm["ms_per_step"]) == {"1", "2"} and sm["speedup"] > 0
    assert sm["efficiency"] == pytest.approx(sm["speedup"] / N)
    for s in (1, N):
        # the calls of the timed steps are what the group counted
        assert sm["calls"][str(s)] == dict(legs[s].map.group.calls)
        _check_collectives(sm["collectives"][str(s)], sm["calls"][str(s)], FRAMES)


def test_crossover_prints_the_references_keys_and_the_groups_calls(runs):
    out, (_, legs) = runs["printed"]["crossover"], runs["kept"]["crossover"]
    assert CROSSOVER_KEYS <= set(out) and out["camera"] == "64x48"
    assert out["live"] == int((1 << CAP_LOG2) * 0.9)
    assert set(out["results"]) == {"1", "2"}
    for s in (1, N):
        r = out["results"][str(s)]
        assert RESULT_KEYS <= set(r) and r["wall_ms_per_step"] > 0
        _check_collectives(r["collectives"], dict(legs[s].map.group.calls), FRAMES)
        assert int(legs[s].map.count) > 0
    assert out["work_ratio_Nway_vs_1"] > 0


def test_one_sub_map_is_the_one_device_step(runs):
    _, legs = runs["kept"]["main"]
    one, s1 = legs["one_device"], legs[1]
    g = shard_step.gather(s1.map)
    assert int(g.count) == int(one.map.count) > 0
    for f in ("pos", "conf", "color", "init_t", "last_t", "normal", "radius"):
        assert torch.equal(getattr(g, f), getattr(one.map, f)), f
    assert all(np.array_equal(a, b) for a, b in zip(one.poses, s1.poses))


def test_two_sub_maps_match_the_references_leg(runs):
    _, legs = runs["kept"]["main"]
    got, ref = legs[N], runs["ref"]
    counts = [int(m.count) for m in got.map.shards]
    assert counts == got.map.counts.tolist()
    for c, r in zip(counts, ref["counts"]):
        assert abs(c - int(r)) <= 0.01 * max(int(r), 1), (counts, ref["counts"])
    assert len(got.poses) == len(ref["poses"]) == FRAMES
    for a, b in zip(got.poses, ref["poses"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3
        assert np.abs(a[:3, :3] - b[:3, :3]).max() < 1e-3


def test_the_default_device_raises_without_a_card(monkeypatch):
    """`-device` defaults to the card; without one the tool raises, it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_bench.main(["-n", "1", "-cap", "12", "-frames", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_bench.main(["-crossover", "-n", "1", "-cap", "12", "-frames", "1"])
