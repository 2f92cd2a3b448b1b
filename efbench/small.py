"""A cell scaled down for the CPU tests: 160x120 at the same field of view,
a smaller scene and a 16-frame period.  Only the tests use it."""

import time

from efbench.harness import main


def small_camera(conf):
    conf["camera"] = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
    conf["engine"]["max_surfels"] = 1 << 17


def small_traffic(t):
    t["scene"]["n_side"] = 500
    t["path"]["period"] = 16
    t["profile"] = dict(start=2, frames=2)
    t["check"] = dict(frames=3, closures=2)


def run_small(workload="default-scan", seed=3_000_000_001, seconds=2.0, trace=0,
              **kw) -> dict:
    return main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", str(trace)], t_start=time.perf_counter(), device="cpu",
                overrides=dict(config=[small_camera], traffic=[small_traffic]), **kw)


def closure_gates(conf):
    """The loop-closure test scenario's gates at 160x120
    (tests/test_closeloop.py: a 6-tick window, the ICP gates scaled by the
    pixel ratio 16, a node every 500 surfels, ferns kept out)."""
    conf["engine"].update(confidence_threshold=0.3, time_delta=6,
                          icp_count_threshold=2000, icp_error_threshold=5e-4,
                          cov_threshold=1e-4, fern_min_age=1000,
                          def_graph_sample_rate=500)


def small_loop(t):
    """A cut-down desk loop: an ellipse wider than the view, so that bands of
    the wall go unseen for more than `time_delta` ticks, go inactive and
    return (no cell of the benchmark runs such a traffic yet)."""
    small_traffic(t)
    t["warmup_periods"] = 1
    t["path"].update(period=24, ax=0.2, ay=0.05, sway_deg=[6.0, 2.0])


def run_small_loop(seed=3_000_000_001, seconds=8.0, **kw) -> dict:
    """`ef-default` on the cut-down loop, with the closure test's gates."""
    return main(["--workload", "default-scan", "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", "0"], t_start=time.perf_counter(), device="cpu",
                overrides=dict(config=[small_camera, closure_gates],
                               traffic=[small_loop]), **kw)
