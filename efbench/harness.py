"""The benchmark of `elasticfusion_tpu_torch` (the PyTorch/CUDA port): one
run of one cell.

A cell is a configuration (`efbench/configs/<name>.json`) under a traffic
(`efbench/traffic/<name>.json`), as `BENCHMARK.json` pairs them; per-layer
metrics are readers in `efbench/metrics/<name>.py`.  All are found by name.

A run renders one period of the cell's camera path from the seed on the
card, warms the engine up through whole periods of it, then replays the path
(periodically continued) into `Engine.process_frame` in a closed loop for
`--seconds`, as a user replays a `.klg` log; `flush()` and a synchronise end
the window.  With `--trace 1` the same run profiles a fixed slice of frames
and prints the per-layer metrics instead of the end-to-end ones.  After the
window, frames sampled from it are recomputed by the plain reference
(`check.py`), which decides `correct`.
"""

from __future__ import annotations

import argparse
import copy
import gc
import importlib.util
import inspect
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "elasticfusion_tpu")


def fail(code: int, why: str):
    print(f"efbench: {why}", file=sys.stderr, flush=True)
    sys.exit(code)


# ---------------------------------------------------------------------------
# what the harness finds by name


def load_benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        fail(2, f"no {path}")
    with open(path) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"efbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(2, f"no workload {workload!r} in BENCHMARK.json")
    return cells[workload]


def metrics_for(entries: List[dict], workload: str) -> List[dict]:
    return [m for m in entries if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: the port's name begins with the latter)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the engine, its configuration and the window


def engine_config(conf: dict):
    """The program's `EngineConfig` of a configuration file (every field as
    run; lists back to tuples)."""
    from elasticfusion_tpu_torch.config import CameraConfig, EngineConfig

    eng = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["engine"].items()}
    return EngineConfig(camera=CameraConfig(**conf["camera"]), **eng)


def reference_config(conf: dict):
    from efbench.reference.config import CameraConfig, EngineConfig

    eng = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["engine"].items()}
    return EngineConfig(camera=CameraConfig(**conf["camera"]), **eng)


class Instruments:
    """The harness's hooks on one engine: snapshots of sampled frames around
    the frame's run and of sampled loop closures around their solve and
    repair, and (traced runs) profiler annotations around the engine's host
    stages.  Nothing of the program is changed.  The hooks sit on the
    program's attributes; what they miss (a frame or a closure run round
    them) is counted against the window's frames and the engine's own
    record of closures by `unchecked`, and makes the run not correct."""

    def __init__(self, eng, samplers: dict, traced: bool):
        import torch

        from efbench.check import snapshot_state

        self.take = False       # the frame being dispatched is sampled
        self.window = False     # closures are sampled inside the window only
        runner = eng.runner
        rf = torch.profiler.record_function
        frames, solves, repairs = samplers["frames"], samplers["solves"], samplers["repairs"]

        def run_hooked(key, frame, run=runner.run):
            if not self.take:
                return run(key, frame)
            frames.record("key", dict(capacity=key[0], do_compact=key[1], lost=key[2]))
            frames.record("before", snapshot_state(runner.state))
            out = run(key, frame)
            frames.record("after", snapshot_state(runner.state))
            return out

        runner.run = run_hooked

        def hook_solve(d):
            constrain = d.constrain
            sig = inspect.signature(constrain)

            def constrain_hooked(*a, **k):
                if not (self.window and solves.wants()):
                    return constrain(*a, **k)
                kw = dict(sig.bind(*a, **k).arguments)
                d._materialize()
                if d.graph is None:
                    solves.drop()
                    return constrain(*a, **k)
                solves.record("before", dict(
                    graph=snapshot_state(dict(map=d.graph))["map"],
                    constraints=[dict(src=c.src.copy(), target=c.target.copy(),
                                      src_time=c.src_time, target_time=c.target_time,
                                      relative=c.relative, pin=c.pin)
                                 for c in d.constraints],
                    last_deform_time=d.last_deform_time,
                    kw=copy.deepcopy(kw)))
                out = constrain(*a, **k)
                solves.record("after", dict(
                    ok=out[0], poses=copy.deepcopy(out[1]), history=copy.deepcopy(out[2]),
                    graph=snapshot_state(dict(map=d.graph))["map"]))
                return out

            d.constrain = constrain_hooked

        if eng.ferns is not None:
            hook_solve(eng.local_deformation)
            hook_solve(eng.global_deformation)
            dispatch = eng._dispatch_closure

            def dispatch_hooked(rec, T_target, graph, fern_accepted):
                if not (self.window and repairs.wants()):
                    return dispatch(rec, T_target, graph, fern_accepted)
                filt, rgb = eng._last_frame
                repairs.record("before", dict(
                    snapshot_state(dict(map=eng.map, T=eng._T_f32, so3=eng._so3_hist)),
                    graph=snapshot_state(dict(map=graph))["map"],
                    T_target=np.array(T_target, np.float64), T_wc=eng.T_wc.copy(),
                    closure_tick=float(rec["tick"]),
                    tick_now=float(max(eng.tick - 1, rec["tick"])),
                    filt=filt.clone(), rgb=rgb.clone(), fern_accepted=fern_accepted))
                out = dispatch(rec, T_target, graph, fern_accepted)
                repairs.record("after", snapshot_state(dict(
                    map=eng.map, T=eng._T_f32, so3=eng._so3_hist, pred=eng._pred,
                    fill=eng._fill, dense=eng._dense_dev)))
                return out

            eng._dispatch_closure = dispatch_hooked
        if not traced:
            return

        def mark(obj, attr, label):
            fn = getattr(obj, attr)

            def wrapped(*a, **k):
                with rf(label):
                    return fn(*a, **k)
            setattr(obj, attr, wrapped)

        mark(runner, "run", "efbench.frame_run")
        mark(eng, "_finish", "efbench.finish")
        mark(eng, "_maybe_grow", "efbench.grow")
        if eng.ferns is not None:
            mark(eng, "_close_loops", "efbench.closure_decide")
            mark(eng, "_dispatch_closure", "efbench.closure_apply")
        mark(eng, "process_frame", "efbench.process_frame")


def unchecked(kept: dict, chk: dict, frames: int, solves: int, repairs: int) -> dict:
    """How many of the window's events that the check was due to compare it
    did not: min(reservoir size, events in the window) less those compared,
    for frames, closure solves and closure repairs.  `solves` and `repairs`
    are the engine's own record (global retrievals that reached a solve plus
    local closures applied; closures applied), not the hooks'."""
    due = dict(frames=min(chk["frames"], frames), solves=min(chk["closures"], solves),
               repairs=min(chk["closures"], repairs))
    return {f"{k}_unchecked": max(0, due[k] - len(kept[k])) for k in due}


def ate_mm(eng, truth: List[np.ndarray]) -> float:
    """RMS distance of the logged camera positions from the synthetic ones
    (both relative to the first frame), in mm."""
    P0 = np.linalg.inv(truth[0])
    errs = []
    for i, (_, T) in enumerate(eng.tick_poses):
        G = P0 @ truth[i % len(truth)]
        errs.append(np.sum((T[:3, 3] - G[:3, 3]) ** 2))
    return float(np.sqrt(np.mean(errs))) * 1e3 if errs else float("nan")


def main(argv=None, t_start: float = None, device=None, overrides=None,
         control=None) -> dict:
    """One run.  `device` and `overrides` are for the CPU tests: the
    configuration's camera / scene scaled down and the card not looked for.
    `control` (a `check.Reference` in a lower precision) stands in for the
    program in the check (`test_efbench_control.py`).  Returns the result
    line's object (after printing it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="efbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cell = cell_of(bench, args.workload)
    conf = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    for patch in (overrides or {}).get("config", []):
        patch(conf)
    for patch in (overrides or {}).get("traffic", []):
        patch(traffic)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            fail(3, f"needs {cell['chips']} CUDA device(s); "
                    f"available: {torch.cuda.is_available()}, "
                    f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda:0")
    device = torch.device(device)
    on_card = device.type == "cuda"
    try:
        from elasticfusion_tpu_torch import _device as port_device
        from elasticfusion_tpu_torch.engine import Engine
    except ImportError as e:
        fail(4, f"the program is not in this checkout: {e}")
    from efbench import check, devtrace, scene
    from efbench.timeline import Timeline, percentile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    rng = np.random.default_rng([args.seed & (2**64 - 1), 0xEF])

    cfg = engine_config(conf)
    t_render = time.perf_counter()
    frames, truth = scene.render_period(traffic, cfg.camera, device)
    period = len(frames)
    t_render = time.perf_counter() - t_render
    eng = Engine(cfg, device=device)
    chk = traffic["check"]
    samplers = dict(frames=check.Sampler(chk["frames"], rng),
                    solves=check.Sampler(chk["closures"], rng),
                    repairs=check.Sampler(chk["closures"], rng))
    inst = Instruments(eng, samplers, traced=bool(args.trace))

    # --- set-up: the first frame (the start of the check), whole periods ---
    d0, c0 = frames[0]
    eng.process_frame(c0, d0, timestamp=0)
    first = dict(state=check.snapshot_state(dict(
        map=eng.map, T=eng._T_f32, so3=eng._so3_hist, pred=eng._pred,
        fill=eng._fill, dense=eng._dense_dev)),
        depth=torch.from_numpy(d0.astype(np.float32)), rgb=torch.from_numpy(c0),
        capacity=eng.map.capacity)
    n_warm = period * int(traffic["warmup_periods"])
    for i in range(1, n_warm):
        d, c = frames[i % period]
        eng.process_frame(c, d, timestamp=i)
    eng.flush()
    if on_card:
        torch.cuda.synchronize()
    captures0 = eng.runner.frames_run
    setup_s = time.perf_counter() - t_start

    # --- the window ---
    sw = eng.stopwatch
    dispatch_ms, finish_ms = [], []
    closures0 = eng.deforms + eng.fern_deforms
    local0 = eng.deforms
    fern_solves = 0         # finished frames whose fern retrieval reached a solve
    reads0 = port_device.host_reads
    inst.window = True
    tl = Timeline(time.perf_counter(), len(eng.tick_poses))
    i = n_warm
    while time.perf_counter() - tl.t0 < args.seconds:
        inst.take = samplers["frames"].wants()
        d, c = frames[i % period]
        tl.started(time.perf_counter())
        logged = len(eng.tick_poses)
        eng.process_frame(c, d, timestamp=i)
        tl.call_ended(time.perf_counter(), len(eng.tick_poses))
        inst.take = False
        # the frame this call finished (one a call in the steady state)
        if (eng.ferns is not None and len(eng.tick_poses) > logged
                and eng.ferns.last_closest != -1 and not eng.lost):
            fern_solves += 1
        dispatch_ms.append(sw.timings["dispatch"])
        finish_ms.append(sw.timings.get("finish", 0.0))
        i += 1
    eng.flush()
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    tl.call_ended(t_end, len(eng.tick_poses))
    inst.window = False
    n = len(tl.starts)
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    closures = eng.deforms + eng.fern_deforms - closures0
    solves = fern_solves + eng.deforms - local0
    captures = eng.runner.frames_run - captures0
    host_reads = port_device.host_reads - reads0

    # --- traced runs: after the window, the path continues to the slice's
    # phase (at least 3 frames on, to refill the pipeline) and the profiler
    # records `frames` frames from there ---
    prof = None
    slice_frames = int(traffic["profile"]["frames"])
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        s0 = i + 3 + (traffic["profile"]["start"] - (i + 3)) % period
        for j in range(i, s0):
            d, c = frames[j % period]
            eng.process_frame(c, d, timestamp=j)
        i = s0
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(devtrace.SLICE):
                for j in range(slice_frames):
                    d, c = frames[(i + j) % period]
                    eng.process_frame(c, d, timestamp=i + j)
                if on_card:
                    torch.cuda.synchronize()
        eng.flush()

    # --- after the window: what the program did ---
    lat = tl.latencies_ms()
    failed = n - len(lat)
    info = dict(
        frames=n, ate_mm=ate_mm(eng, truth), surfels=eng.surfel_count,
        capacity=eng.map.capacity, closures=closures, solves=solves,
        deforms=eng.deforms, fern_deforms=eng.fern_deforms,
        fern_keyframes=len(eng.ferns.frames) if eng.ferns else 0,
        captures_in_window=captures,
        capture_seconds={str(k_): v for k_, v in eng.runner.capture_seconds.items()},
        replays={str(k_): v for k_, v in eng.runner.replays_of.items()},
        memory_peak_bytes=mem_peak, setup_s=setup_s, render_s=t_render,
        warmup_frames=n_warm,
        latency_ms={f"p{q}": percentile(lat, q) for q in (50, 90, 95, 99, 100)} if lat else None,
        frames_over_100ms=sum(x > 100.0 for x in lat),
        # where in the period the slow frames fall
        slow_phases=sorted({(j + n_warm) % period for j, x in enumerate(lat) if x > 100.0}),
        window_s=t_end - tl.t0)
    ctx = SimpleNamespace(
        frames=n, dispatch_ms=dispatch_ms, finish_ms=finish_ms, host_reads=host_reads,
        untraced_ms_per_frame=(t_end - tl.t0) / n * 1e3 if n else 0.0,
        slice=None, slice_frames=slice_frames, height=cfg.camera.height, width=cfg.camera.width)
    if prof is not None:
        ctx.slice = devtrace.read_slice(prof.profiler.kineto_results.events())
        from efbench.roofline import share

        # the profiler costs the host time (most of it at each graph launch):
        # the window gives the untraced pace beside the slice's
        info["untraced_ms_per_frame"] = ctx.untraced_ms_per_frame
        info["slice_ms_per_frame"] = ctx.slice.window_s / slice_frames * 1e3
        info["slice_busy_ms_per_frame"] = ctx.slice.busy_s / slice_frames * 1e3
        info["roofline_by_kernel"] = {
            name[:80]: dict(launches=cnt, ms=sec * 1e3,
                            share=share({name: (cnt, sec)}, ctx.height, ctx.width))
            for name, (cnt, sec) in ctx.slice.by_name.items()
            if share({name: (cnt, sec)}, ctx.height, ctx.width) is not None}
        prof = None
    print("efbench info " + json.dumps(info, default=str), flush=True)

    # --- the program's state is freed before the reference runs ---
    kept = {k_: v.complete() for k_, v in samplers.items()}
    missed = unchecked(kept, chk, n, solves, closures)
    del eng, inst, frames
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rcfg = reference_config(conf)
    t_ref = time.perf_counter()
    rows = [check.check_start(first, rcfg, device)]
    rows += check.check_frames(kept["frames"], rcfg, device, control)
    rows += check.check_solves(kept["solves"], rcfg, device, control)
    rows += check.check_repairs(kept["repairs"], rcfg, device, control)
    numbers = check.worst(rows)
    correct = (all(numbers[k_] <= lim for k_, lim in check.LIMITS.items()) and failed == 0
               and not any(missed.values()))
    print(f"efbench reference: the start, " + ", ".join(
        f"{len(v)} {k_}" for k_, v in kept.items()) + " of the window in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)

    found = forbidden_modules()
    if found:
        fail(5, f"modules of JAX or the JAX package are loaded: {found}")

    # --- the result line ---
    if args.trace:
        metrics = {}
        for m in metrics_for(bench["per_layer"], args.workload):
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = dict(fps=tl.fps(t_end), frame_ms_p95=percentile(lat, 95) if lat else None,
                   setup_s=setup_s)
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in metrics_for(bench["end_to_end"], args.workload)
                   if e2e.get(m["name"]) is not None}
    dev_info = dict(platform="gpu" if on_card else device.type,
                    kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                    count=cell["chips"] if on_card else 1, memory_peak_bytes=mem_peak)
    result = dict(correct=bool(correct), attempted=n, failed=failed, metrics=metrics,
                  device=dev_info)
    if ctx.slice is not None:
        dev_info.update(busy_s=ctx.slice.busy_s, window_s=ctx.slice.window_s)
        top = sorted(ctx.slice.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = dict(
            device_ops=[[name[:120], sec] for name, (_, sec) in top],
            idle_gaps=[[name[:120], sec] for name, sec in ctx.slice.gaps[:10]])
    result["compared"] = {k_: dict(value=numbers[k_], limit=lim)
                          for k_, lim in check.LIMITS.items()}
    result["compared"]["frames_without_pose"] = dict(value=failed, limit=0)
    for k_, v in missed.items():
        result["compared"][k_] = dict(value=v, limit=0)
    for k_, v in result["compared"].items():
        print(f"compared {k_} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result
