"""The harness's arithmetic and bookkeeping, on the CPU in seconds."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from efbench import devtrace, harness, roofline, scene
from efbench.timeline import Timeline, percentile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _window(stall_at=None, n=100, step=0.02, stall=0.5, depth=2):
    """A synthetic closed-loop timeline: each call takes `step` s (plus
    `stall` at call `stall_at`) and finishes the frame `depth` calls back;
    the flush finishes the rest."""
    t = 0.0
    tl = Timeline(0.0, 0)
    for i in range(n):
        tl.started(t)
        t += step + (stall if i == stall_at else 0.0)
        tl.call_ended(t, max(0, i + 1 - depth))
    t += step
    tl.call_ended(t, n)
    return tl, t


def test_fps_and_p95_come_from_every_frame_and_a_stall_moves_both():
    tl, t_end = _window()
    lat = tl.latencies_ms()
    assert len(lat) == 100
    assert tl.fps(t_end) == pytest.approx(100 / (100 * 0.02 + 0.02))
    assert percentile(lat, 95) == pytest.approx(60.0)       # three calls at depth 2
    tl2, t2 = _window(stall_at=50)
    lat2 = tl2.latencies_ms()
    assert tl2.fps(t2) < tl.fps(t_end)
    # the stalled call holds up its own frame and the two finished in it
    assert sum(x > 500 for x in lat2) == 3
    assert percentile(lat2, 95) == pytest.approx(60.0)
    tl3, t3 = _window(stall_at=20, n=40)
    assert percentile(tl3.latencies_ms(), 95) > 500          # 3 of 40 frames: in the tail


def test_percentile_interpolates_like_numpy():
    xs = list(np.random.default_rng(1).normal(size=257))
    for q in (5, 50, 95, 99):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_roofline_arithmetic_against_hand_computed_shares():
    H, W = 480, 640
    # K2: 26 * 307200 * 4 B = 31.9488 MB at 3.35 TB/s = 9.5370 us; operations
    # 25*2*40*307200 = 614.4 M at 67 TFLOP/s = 9.1701 us: bound by bytes
    assert roofline.launch_bound_s("splat_resolve", H, W) == pytest.approx(
        26 * 307200 * 4 / 3.35e12)
    # K3: 34 * 307200 * 4 B = 12.4713 us; (9*45+60+9*13)*307200 = 178.1760 M
    # operations = 2.6594 us: bound by bytes
    assert roofline.launch_bound_s("fuse_window", H, W) == pytest.approx(
        34 * 307200 * 4 / 3.35e12)
    assert roofline.launch_bound_s("icp_step", H, W) is None
    assert roofline.kernel_of("void splat_resolve_kernel(float const*, float*, int)") \
        == "splat_resolve"
    assert roofline.kernel_of("_Z18fuse_window_kernelPKf") == "fuse_window"
    assert roofline.kernel_of("void icp_step_kernel<false>(int const*)") == "icp_step"
    assert roofline.kernel_of("elementwise_kernel") is None
    # the reader: 2 K2 launches of 20 us and one K3 launch of 25 us
    metric = harness.load_metric("kernels.roofline")
    sl = devtrace.Slice(window_s=1.0, busy_s=0.5, kernels=3, gaps=[], by_name={
        "splat_resolve_kernel": (2, 40e-6), "fuse_window_kernel": (1, 25e-6),
        "icp_step_kernel<false>": (19, 1e-3)})
    ctx = type("C", (), dict(slice=sl, height=H, width=W, slice_frames=1))
    want = (2 * 26 + 34) * 307200 * 4 / 3.35e12 / 65e-6 * 100
    assert metric.read(ctx) == pytest.approx(want)
    # each kernel's own share, and none for a kernel that did not run
    k2 = harness.load_metric("splat_resolve_roofline")
    k3 = harness.load_metric("fuse_window_roofline")
    assert k2.read(ctx) == pytest.approx(2 * 26 * 307200 * 4 / 3.35e12 / 40e-6 * 100)
    assert k3.read(ctx) == pytest.approx(34 * 307200 * 4 / 3.35e12 / 25e-6 * 100)
    ctx.slice = sl._replace(by_name={"splat_resolve_kernel": (2, 40e-6)})
    assert k3.read(ctx) is None
    assert metric.read(ctx) == pytest.approx(k2.read(ctx))


def test_the_idle_share_is_the_untraced_frame_less_the_device_busy_time():
    metric = harness.load_metric("device.idle_share")
    # 96 ms busy over an 8-frame slice is 12 ms a frame; the untraced window
    # ran 16 ms a frame: 25 % idle (the slice's own 50 ms a frame, slowed by
    # the profiler, does not count)
    sl = devtrace.Slice(window_s=0.4, busy_s=0.096, kernels=800, by_name={}, gaps=[])
    ctx = type("C", (), dict(slice=sl, slice_frames=8, frames=100,
                             untraced_ms_per_frame=16.0))
    assert metric.read(ctx) == pytest.approx(25.0)
    ctx.slice = None
    assert metric.read(ctx) is None


def test_the_check_counts_what_it_was_due_to_compare():
    chk = dict(frames=4, closures=3)
    full = dict(frames=[{}] * 4, solves=[{}], repairs=[])
    assert set(harness.unchecked(full, chk, 900, 1, 0).values()) == {0}
    none = dict(frames=[], solves=[], repairs=[])
    assert harness.unchecked(none, chk, 900, 5, 2) == dict(
        frames_unchecked=4, solves_unchecked=3, repairs_unchecked=2)
    # a window shorter than the reservoir is due all of its frames
    assert harness.unchecked(dict(none, frames=[{}]), chk, 2, 0, 0)["frames_unchecked"] == 1


class _Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return type("D", (), {"name": self._d})

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_slice_busy_is_the_union_of_device_intervals_and_gaps_are_named():
    ev = [_Ev(devtrace.SLICE, "CPU", 0, 1000), _Ev("efbench.finish", "CPU", 600, 900),
          _Ev("aten::item", "CPU", 650, 880),
          _Ev("k1", "CUDA", 100, 300), _Ev("k2", "CUDA", 200, 500),
          _Ev("MemcpyDtoH", "CUDA", 900, 950), _Ev("early", "CUDA", 0, 50),
          _Ev("efbench.finish", "CUDA", 600, 900)]
    sl = devtrace.read_slice(ev)
    assert sl.window_s == pytest.approx(1e-6)
    assert sl.busy_s == pytest.approx((50 + 400 + 50) * 1e-9)
    assert sl.kernels == 3
    assert sl.gaps[0] == ("efbench.finish / aten::item", pytest.approx(400e-9))


def test_the_traffic_alone_makes_the_frames():
    """The same traffic renders the same frames; another jitter seed in the
    traffic renders others; every run flies the same path."""
    t = harness.load_json("traffic", "scan")
    t["scene"]["n_side"] = 300
    t["path"]["period"] = 4
    cam = type("Cam", (), dict(width=80, height=60, fx=66.0, fy=66.0, cx=40.0, cy=30.0))
    a, pa = scene.render_period(t, cam, "cpu")
    b, pb = scene.render_period(t, cam, "cpu")
    t["scene"]["jitter_seed"] += 1
    c, pc = scene.render_period(t, cam, "cpu")
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert all(np.array_equal(x, y) for x, y in zip(pa, pc))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    assert a[0][0].dtype == np.uint16 and a[0][1].dtype == np.uint8
    assert (a[0][0] > 0).mean() > 0.9


def test_the_seed_draws_the_frames_the_check_compares():
    from efbench.check import Sampler

    def kept(seed):
        s = Sampler(4, np.random.default_rng([seed, 0xEF]))
        out = []
        for i in range(500):
            if s.wants():
                s.record("after", i)
        return sorted(x["after"] for x in s.complete())

    assert kept(2**31 + 7) == kept(2**31 + 7)
    assert kept(2**31 + 7) != kept(2**31 + 8)
    assert len(kept(5)) == 4


def test_the_renderer_keeps_the_nearest_point():
    pts = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 1.5], [0.0, 0.0, 1.5]])
    cols = torch.tensor([[1, 1, 1], [2, 2, 2], [3, 3, 3]], dtype=torch.uint8)
    cam = type("Cam", (), dict(width=4, height=4, fx=4.0, fy=4.0, cx=2.0, cy=2.0))
    d, c = scene.render(pts, cols, np.eye(4), cam)
    assert int(d[2, 2]) == 1500 and c[2, 2].tolist() == [3, 3, 3]
    assert int((d > 0).sum()) == 1


def test_configurations_traffics_and_metrics_are_found_by_name():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        conf = harness.load_json("configs", c["name"])
        assert c["file"] == f"efbench/configs/{c['name']}.json"
        assert conf["reduced"] == c["reduced"] == []
        harness.engine_config(conf)
        harness.reference_config(conf)
    for w in bench["workloads"]:
        harness.load_json("traffic", w["traffic"])
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for m in bench["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
    # an unknown name is refused, not guessed
    with pytest.raises(SystemExit):
        harness.cell_of(bench, "no-such-cell")


def test_every_configuration_holds_every_field_of_the_engine_config():
    import dataclasses

    from efbench.reference.config import EngineConfig

    fields = {f.name for f in dataclasses.fields(EngineConfig)} - {"camera"}
    for path in glob.glob(os.path.join(HERE, "configs", "*.json")):
        with open(path) as f:
            assert set(json.load(f)["engine"]) == fields, path


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("elasticfusion_tpu_torch", "elasticfusion_tpu",
                                             "jax"), (path, mod)
    code = ("import sys; sys.path.insert(0, %r); import efbench.check, "
            "efbench.reference.frame; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"elasticfusion_tpu_torch", "elasticfusion_tpu", "jax", "jaxlib"}


def test_nothing_reads_the_old_benchmark():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        text = open(path).read()
        for word in ("bench.py", "bench_cache", "BENCH_", "BASELINE", "MULTICHIP_"):
            assert word not in text, (path, word)


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    import elasticfusion_tpu_torch  # noqa: F401  the port's name begins with the JAX package's

    before = harness.forbidden_modules()
    assert "elasticfusion_tpu" not in before
    monkeypatch.setitem(sys.modules, "elasticfusion_tpu.engine", object())
    assert "elasticfusion_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
