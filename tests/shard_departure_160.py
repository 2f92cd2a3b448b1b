"""How far the `mesh_shape` engine at S = 2 and 4 goes from its own S = 1 on
the 160x120 sweep of `tests/test_torch_shard.py` (six frames, `closeLoops`,
confidence 0.3, the exact clean, a growth before the first tracked frame),
in the reference package or in the port:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/shard_departure_160.py ref out_ref.pkl
    python tests/shard_departure_160.py port out_port.pkl

Prints, per S and frame, the translation distance (m), the largest element
of the rotation blocks' difference and the surfel counts against S = 1, and
pickles the poses and counts.  Not a test: the reference's run takes a few
minutes on an 8-core CPU, most of it XLA compiles."""

import os
import pickle
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES, GROW_AT = 6, 1


def main(which: str, out: str) -> None:
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    if which == "ref":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from elasticfusion_tpu.config import CameraConfig, EngineConfig
        from elasticfusion_tpu.engine import Engine
        from elasticfusion_tpu.utils.synthetic import (
            make_scene,
            render_frame,
            synthetic_trajectory,
        )
    else:
        from elasticfusion_tpu_torch.config import CameraConfig, EngineConfig
        from elasticfusion_tpu_torch.engine import Engine
        from elasticfusion_tpu_torch.utils.synthetic import (
            make_scene,
            render_frame,
            synthetic_trajectory,
        )
    from _torch_parity import SMALL_CAM

    cam = CameraConfig(**SMALL_CAM)
    scene = make_scene(n_side=500)
    poses = synthetic_trajectory("sweep", 120)[:N_FRAMES]
    frames = [render_frame(scene[0], scene[1], T, cam) for T in poses]
    runs = {}
    for S in (1, 2, 4):
        cfg = EngineConfig(camera=cam, confidence_threshold=0.3, fx16_clean=False,
                           mesh_shape=(S,))
        eng = Engine(cfg) if which == "ref" else Engine(cfg, device="cpu")
        run = []
        for i, (d, rgb) in enumerate(frames):
            if i == GROW_AT:   # as when the fullest shard nears capacity
                cap_l = eng.map.capacity // S
                eng._count_finished = int(0.9 * cap_l) * S
                eng._count_max_finished = int(0.9 * cap_l)
            res = eng.process_frame(rgb, d, timestamp=i)
            run.append((res.T_wc.copy(), res.surfel_count))
        runs[S] = run
    for S in (2, 4):
        for i, ((Ta, na), (Tb, nb)) in enumerate(zip(runs[1], runs[S])):
            print(f"{which} S={S} frame {i}: "
                  f"dt={np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]):.3e} m "
                  f"dR={np.abs(Ta[:3, :3] - Tb[:3, :3]).max():.3e} "
                  f"count {nb} vs {na}", flush=True)
    with open(out, "wb") as f:
        pickle.dump(runs, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
