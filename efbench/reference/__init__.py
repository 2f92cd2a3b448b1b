"""The plain reference of the benchmark's check: ElasticFusion's per-frame
main path in plain PyTorch, a frozen copy of the port's plain versions
(`elasticfusion_tpu_torch`: `config.py`, `se3.py`, `surfels.py`,
`tracking.py`, `ops/{preprocess,odometry,gram,gatherpack,fuse,fuse_window,
splat,splat_resolve,fillin}.py`) with every kernel launch taken out, and the
frame itself in `frame.py`.  It imports nothing of the program."""
