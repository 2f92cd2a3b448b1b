"""Run report (own copy of the reference package's `tools/report.py`) — the
headless equivalent of the original GUI's residual / inlier health plots
(GUI.h:88-102, MainController.cpp:304-311).

Consumes the per-frame JSONL written by `run_slam -stats`, prints a
threshold-aware summary table, and (when matplotlib is available) renders
the residual/inlier time series against their loop-closure thresholds.

Usage:
    python -m elasticfusion_tpu_torch.tools.report stats.jsonl [-png report.png]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def load(path):
    rows = [json.loads(ln) for ln in Path(path).read_text().splitlines() if ln.strip()]
    if not rows:
        raise SystemExit(f"{path}: empty stats file")
    return rows


def summarize(rows) -> str:
    import numpy as np

    icp_err = np.array([r.get("icp_error", 0.0) for r in rows])
    icp_cnt = np.array([r.get("icp_count", 0.0) for r in rows])
    run_ms = np.array([r.get("run_ms", 0.0) for r in rows])
    lost = np.array([r.get("lost", False) for r in rows])
    fused = np.array([r.get("fused", False) for r in rows])
    err_thr = rows[-1].get("icp_err_thresh", 5e-5)
    cnt_thr = rows[-1].get("icp_count_thresh", 40000)

    def pct(x, q):
        return float(np.percentile(x, q))

    lines = [
        f"frames: {len(rows)}   fused: {int(fused.sum())}   "
        f"lost: {int(lost.sum())}   deforms: {rows[-1].get('deforms', 0)}"
        f"+{rows[-1].get('fern_deforms', 0)} fern",
        f"icp residual  med {pct(icp_err, 50):.2e}  p95 {pct(icp_err, 95):.2e}"
        f"  (closure gate < {err_thr:.0e}: "
        f"{float((icp_err < err_thr).mean()) * 100:.0f}% of frames)",
        f"icp inliers   med {pct(icp_cnt, 50):.0f}  p5 {pct(icp_cnt, 5):.0f}"
        f"  (closure gate > {cnt_thr}: "
        f"{float((icp_cnt > cnt_thr).mean()) * 100:.0f}% of frames)",
        f"frame time    med {pct(run_ms, 50):.1f} ms  p95 {pct(run_ms, 95):.1f} ms"
        f"  (budget 33.3 ms: {float((run_ms <= 33.3).mean()) * 100:.0f}% within)",
    ]
    return "\n".join(lines)


def plot(rows, png: str) -> bool:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return False
    import numpy as np

    t = np.array([r.get("tick", i) for i, r in enumerate(rows)])
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    axes[0].plot(t, [r.get("icp_error", 0) for r in rows], lw=0.8)
    axes[0].axhline(rows[-1].get("icp_err_thresh", 5e-5), ls="--", c="r")
    axes[0].set_yscale("log")
    axes[0].set_ylabel("ICP residual")
    axes[1].plot(t, [r.get("icp_count", 0) for r in rows], lw=0.8)
    axes[1].axhline(rows[-1].get("icp_count_thresh", 40000), ls="--", c="r")
    axes[1].set_ylabel("ICP inliers")
    axes[2].plot(t, [r.get("run_ms", 0) for r in rows], lw=0.8)
    axes[2].axhline(33.3, ls="--", c="r")
    axes[2].set_ylabel("frame ms")
    axes[2].set_xlabel("tick")
    fig.tight_layout()
    fig.savefig(png, dpi=110)
    plt.close(fig)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("stats")
    p.add_argument("-png", default=None)
    args = p.parse_args(argv)
    rows = load(args.stats)
    print(summarize(rows))
    if args.png:
        if plot(rows, args.png):
            print(f"wrote {args.png}")
        else:
            print("matplotlib unavailable; skipped plot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
