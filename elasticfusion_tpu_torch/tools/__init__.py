"""Command-line tools of the port: `run_slam` (the SLAM runner), `eval_suite`
(the synthetic battery), `report`, `view_map`, and the live-camera layer."""
