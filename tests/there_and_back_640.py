"""The there-and-back run of `chip_smoke.py` phase 5 (b) at 640x480 on the
CPU, with `chip_smoke.closure_config`'s gates (the 160x120 test's scaled by
the pixel ratio 16), in the reference package or in the port:

    JAX_PLATFORMS=cpu python tests/there_and_back_640.py ref out_ref.pkl
    python tests/there_and_back_640.py port out_port.pkl

Prints, per frame, the error of the finished pose against the rendered one,
the surfel count and the local closures so far, and pickles them with the
model-to-model gate values of every frame that had an inactive prediction.
Not a test: a run takes ~2 minutes (port) or ~4 minutes (reference, most of
it XLA compiles) on an 8-core CPU."""

import os
import pickle
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OUT, PIXEL_RATIO = 12, 16


def main(which: str, out: str) -> None:
    sys.path.insert(0, REPO)
    if which == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from elasticfusion_tpu.config import CameraConfig, EngineConfig
        from elasticfusion_tpu.engine import Engine
        from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
    else:
        from elasticfusion_tpu_torch.config import CameraConfig, EngineConfig
        from elasticfusion_tpu_torch.engine import Engine
        from elasticfusion_tpu_torch.utils.synthetic import (
            make_scene,
            pose_from_xyzrpy,
            render_frame,
        )

    cam, r = CameraConfig(), PIXEL_RATIO
    cfg = EngineConfig(camera=cam, closeLoops=True, pipeline_depth=0,
                       initial_surfels=1 << 19, max_surfels=1 << 21,
                       confidence_threshold=0.3, time_delta=6,
                       icp_error_threshold=5e-4 / r ** 0.5, cov_threshold=1e-4 / r,
                       icp_count_threshold=2000 * r, fern_min_age=1000,
                       def_graph_sample_rate=500 * r)
    scene = make_scene(n_side=1400)
    steps = [i if i < N_OUT else 2 * N_OUT - i - 1 for i in range(2 * N_OUT)]
    poses = [pose_from_xyzrpy(x=0.035 * s, yaw=0.012 * s) for s in steps]
    frames = [render_frame(scene[0], scene[1], T, cam) for T in poses]
    eng = Engine(cfg) if which == "ref" else Engine(cfg, device="cpu")
    gates, real = [], Engine._close_loops

    def logged(self, rec, *args, **kwargs):
        m2m_err, m2m_cnt, m2m_A, inact_px = args[6:10]
        n0 = self.deforms
        real(self, rec, *args, **kwargs)
        if inact_px > 0:
            gates.append(dict(tick=rec["tick"], count=float(m2m_cnt), err=float(m2m_err),
                              inact_px=int(inact_px), closed=self.deforms > n0))

    Engine._close_loops = logged
    log = []
    for i, (d, rgb) in enumerate(frames):
        t0 = time.time()
        res = eng.process_frame(rgb, d, timestamp=i)
        err = float(np.linalg.norm(res.T_wc[:3, 3] - poses[i][:3, 3]))
        log.append(dict(i=i, tick=i + 1, err=err, count=res.surfel_count,
                        deforms=eng.deforms, fern_deforms=eng.fern_deforms))
        print(f"tick {i + 1}: error {err * 1e3:.2f} mm, {res.surfel_count} surfels, "
              f"{eng.deforms} local closures ({time.time() - t0:.1f} s)", flush=True)
    with open(out, "wb") as f:
        pickle.dump(dict(log=log, gates=gates), f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
