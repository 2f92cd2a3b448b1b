"""Configuration for the PyTorch/CUDA port of the ElasticFusion engine.

Own copy of the reference package's `config.py`: identical field names and
defaults, so one dict of overrides builds both packages' `EngineConfig`
(see `convert.config_from_dict`).  Defaults follow the original system's
MainController.cpp:69-94 / ElasticFusion.h:42-58.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Sensor geometry (640x480, fx=fy=528, cx=320, cy=240 by default)."""

    width: int = 640
    height: int = 480
    fx: float = 528.0
    fy: float = 528.0
    cx: float = 320.0
    cy: float = 240.0

    def scaled(self, factor: int) -> "CameraConfig":
        """Intrinsics at a pyramid level (per-level halving,
        RGBDOdometry.cpp:77-93)."""
        return dataclasses.replace(
            self,
            width=self.width >> factor,
            height=self.height >> factor,
            fx=self.fx / (1 << factor),
            fy=self.fy / (1 << factor),
            cx=self.cx / (1 << factor),
            cy=self.cy / (1 << factor),
        )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs: the reference's names and defaults, every one honoured
    by the port."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # --- tracking (RGBDOdometry) ---
    num_pyramid_levels: int = 3          # NUM_PYRS, RGBDOdometry.h:114
    so3_iterations: int = 10             # RGBDOdometry.cpp:305
    gn_iterations: Tuple[int, int, int] = (10, 5, 4)   # fine→coarse, cpp:371
    # fastOdom only drops the FINE level 10 -> 3 (RGBDOdometry.cpp:371-373)
    fast_odom_iterations: Tuple[int, int, int] = (3, 5, 4)
    icp_weight: float = 10.0             # -i flag, MainController.cpp:74
    rgb_only: bool = False
    pyramid: bool = True
    fast_odom: bool = False
    so3: bool = True
    dist_threshold: float = 0.10         # m, RGBDOdometry.h:41
    angle_threshold_sin: float = 0.342020143  # sin 20°, RGBDOdometry.h:42
    # per-level squared gradient-magnitude thresholds {5,3,1}² (cpp:111-114)
    rgb_grad_thresholds: Tuple[float, float, float] = (25.0, 9.0, 1.0)
    translation_sanity: float = 0.3      # m, reject jumps (cpp:555-558)
    # stop GN iterations once the pose update drops below this norm (m/rad)
    gn_early_exit: float = 3e-4
    # also stop when the per-pixel residual stops changing relatively (0 = off)
    gn_plateau_exit: float = 0.0
    # u16 fixed-point ICP model tables (ops/gatherpack.pack_fx16; decode
    # error <= scale/2, ~0.08 mm over a 10 m range); off by default, as in
    # the reference
    fx16_tables: bool = False

    # --- depth preprocessing ---
    depth_factor: float = 1000.0         # uint16 mm → m
    max_depth_processed: float = 20.0    # m, ElasticFusion.cpp:83
    depth_cutoff: float = 3.0            # -d flag, MainController.cpp:73
    bilateral_sigma_space: float = 4.5   # depth_bilateral.frag constants
    bilateral_sigma_depth: float = 0.0275
    bilateral_radius: int = 6

    # --- surfel map (GlobalModel) ---
    max_surfels: int = 1 << 22           # capacity ceiling
    # starting capacity bucket (None = auto: first frame's pixel count plus
    # slack, engine._next_bucket)
    initial_surfels: Optional[int] = None
    confidence_threshold: float = 10.0   # -c flag
    time_delta: int = 200                # -t flag: active window, ticks
    unstable_age: int = 20               # copy_unstable.vert:120-123
    fuse_window_multiplier: int = 2      # data.vert search window scale
    max_deformation_nodes: int = 1024    # GlobalModel.cpp:25-26
    # clean() culls every frame but compacts only every Nth frame; in
    # between, culled surfels are marked dead in place (see ops/fuse.clean)
    compact_every: int = 4
    # u16 fixed-point window patch in clean (the port has the exact f32 path
    # only; `Engine` ignores this flag exactly as the reference's
    # `_frame_main` does, `slam_step` raises when it is set)
    fx16_clean: bool = True

    # --- loop closure / relocalization ---
    icp_error_threshold: float = 4e-5    # -ie
    icp_count_threshold: int = 40000     # -ic
    cov_threshold: float = 1e-5          # -cv
    photo_threshold: float = 115.0       # -pt
    fern_threshold: float = 0.3095       # -ft
    num_ferns: int = 500                 # ElasticFusion.cpp:53
    fern_pyramid_factor: int = 8         # 640/8=80, Ferns.cpp:24-26
    fern_min_age: int = 300              # Ferns.cpp:218
    fern_seed: int = 0
    max_fern_keyframes: int = 2048
    closeLoops: bool = True
    reloc_mode: bool = False             # -rl
    frame_to_frame_rgb: bool = False     # -ftf
    lost_inlier_relax: int = 1400        # Ferns.cpp:256
    fern_inlier_count: int = 2400
    fern_icp_error: float = 3e-4
    reloc_icp_error: float = 1e-4
    reloc_cov_threshold: float = 1e-4

    # --- deformation graph ---
    def_graph_sample_rate: int = 5000    # every Nth surfel, sample.geom
    def_graph_k: int = 4                 # kNN blend, DeformationGraph.cpp
    def_graph_lookback: int = 20
    w_rot: float = 1.0
    w_reg: float = 10.0
    w_con: float = 100.0
    def_gn_iterations: int = 3           # DeformationGraph.cpp:460

    # --- multi-device ---
    mesh_shape: Optional[Tuple[int, ...]] = None  # None → single device
    mesh_axes: Tuple[str, ...] = ("map",)

    # --- host/device pipelining ---
    # frames the host lets run ahead before reading a frame's results
    # (0 = synchronous, the only mode the port has so far)
    pipeline_depth: int = 0

    # --- misc ---
    seed: int = 0

    def with_(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig()
