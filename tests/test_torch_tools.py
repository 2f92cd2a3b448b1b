"""The port's command-line tools on the CPU: `run_slam` end to end on a
160x120 `.klg` against the same frames through `Engine`, its flags that are
not ported yet, the live-camera layer (`tests/test_camera.py`), `report`,
`view_map` on a port-written map, one shortened `eval_suite`
configuration, and `fetch_datasets` with its download replaced by a local
copy (no network is touched).  Everything is written under the test's
temporary directory."""

import json

import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM
from elasticfusion_tpu_torch.config import CameraConfig
from elasticfusion_tpu_torch.engine import Engine
from elasticfusion_tpu_torch.io import Frame, load_ply, read_freiburg, write_klg
from elasticfusion_tpu_torch.tools import eval_suite, report, run_slam, view_map
from elasticfusion_tpu_torch.tools.camera import FrameRingBuffer, LiveLogReader, SyntheticCamera
from elasticfusion_tpu_torch.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame

CAM = CameraConfig(**SMALL_CAM)
N = 6


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A .klg of N sweep frames (raw RGB, zlib depth), its TUM ground truth
    and calibration, written by the port."""
    d = tmp_path_factory.mktemp("seq")
    scene = make_scene(n_side=700)
    frames, gt = [], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(N):
        T = pose_from_xyzrpy(x=0.01 * i, yaw=0.004 * i)
        depth, rgb = render_frame(scene[0], scene[1], T, CAM)
        ts = 1_000_000 + 33_333 * i
        frames.append((ts, depth, rgb))
        gt.append(f"{ts / 1e6:.6f} {T[0, 3]} {T[1, 3]} {T[2, 3]} 0 {np.sin(0.002 * i)} 0 "
                  f"{np.cos(0.002 * i)}")
    write_klg(d / "seq.klg", frames)
    (d / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    (d / "cal.txt").write_text("132 132 80 60\n")
    return d, frames


def _argv(d, *extra):
    return ["-l", str(d / "seq.klg"), "-res", "160x120", "-cal", str(d / "cal.txt"),
            "-c", "0.3", *extra]


@pytest.fixture(scope="module")
def slam_run(sequence, tmp_path_factory):
    d, frames = sequence
    out = tmp_path_factory.mktemp("out")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_slam.main(_argv(d, "-o", str(out / "run"), "-gt", str(d / "groundtruth.txt"),
                                 "-stats", str(out / "stats.jsonl"), "-device", "cpu"))
    # the same frames through Engine with the configuration run_slam builds
    cfg = run_slam.make_config(run_slam.build_parser().parse_args(_argv(d)))
    assert cfg.camera == CAM and cfg.confidence_threshold == 0.3 and cfg.closeLoops
    eng = Engine(cfg, device="cpu")
    for ts, depth, rgb in frames:
        eng.process_frame(rgb, depth, timestamp=ts)
    eng.save_trajectory(out / "direct.freiburg")
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), out, eng


def test_run_slam_trajectory_equals_the_engine_run(slam_run):
    rc, stats, out, _ = slam_run
    assert rc == 0
    text = (out / "run.freiburg").read_text()
    assert len(text.splitlines()) == N
    assert text == (out / "direct.freiburg").read_text()


def test_run_slam_writes_map_and_stats(slam_run, sequence):
    rc, stats, out, eng = slam_run
    assert stats["frames"] == N and stats["trajectory"] == str(out / "run.freiburg")
    assert stats["surfels"] == eng.surfel_count
    assert stats["ply_vertices"] == len(load_ply(out / "run.ply")) > 0
    assert 0 <= stats["ate_rmse_m"] < 0.01 and stats["fps"] > 0
    rows = [json.loads(ln) for ln in (out / "stats.jsonl").read_text().splitlines()]
    assert len(rows) == N and {"run_ms", "dispatch_ms", "drain_ms", "icp_error"} <= set(rows[-1])
    T_last = read_freiburg(out / "run.freiburg")[-1][1]
    assert np.linalg.norm(T_last[:3, 3] - pose_from_xyzrpy(x=0.01 * (N - 1))[:3, 3]) < 0.01


@pytest.mark.parametrize("flags", [["-mesh", "2"], ["-dist-rank", "0"],
                                   ["-dist-coordinator", "localhost:1234"]])
def test_run_slam_multi_device_flags_raise(sequence, flags, tmp_path, capsys):
    """The multi-device flags are ported: `-mesh 2` runs the map as two
    sub-maps, a rank alone is one process (as in the reference), and a
    coordinator without the process count and the rank raises."""
    d, _ = sequence
    if flags[0] == "-dist-coordinator":
        with pytest.raises(ValueError, match="coordinator"):
            run_slam.main(_argv(d, "-device", "cpu", *flags))
        return
    assert run_slam.main(_argv(d, "-device", "cpu", "-o", str(tmp_path / "m"),
                               *flags)) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == N
    assert stats.get("mesh") == ([2] if flags[0] == "-mesh" else None)


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(sequence, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    d, _ = sequence
    with pytest.raises(RuntimeError, match="CUDA"):
        run_slam.main(_argv(d, "-o", str(tmp_path / "x")))
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_suite.main(["-synth-only", "-o", str(tmp_path / "R.md")])
    assert not list(tmp_path.iterdir())


def test_report_summarises_and_plots(slam_run, capsys):
    _, _, out, _ = slam_run
    assert report.main([str(out / "stats.jsonl"), "-png", str(out / "report.png")]) == 0
    text = capsys.readouterr().out
    assert f"frames: {N}" in text and "icp residual" in text
    assert (out / "report.png").stat().st_size > 1000


def test_view_map_renders_the_port_map(slam_run, capsys):
    from PIL import Image

    _, _, out, _ = slam_run
    png = out / "view.png"
    assert view_map.main([str(out / "run.ply"), "-traj", str(out / "run.freiburg"),
                          "-o", str(png), "-size", "320x240"]) == 0
    img = np.asarray(Image.open(png))
    assert img.shape == (240, 320, 3) and (img.sum(axis=2) > 0).mean() > 0.05


def test_eval_suite_one_configuration(tmp_path, capsys):
    """One synthetic configuration of `-quick` (30 frames) at pipeline depth
    2 on the CPU; the table goes to the given file only (measured ATE
    2.1 cm: at 30 frames the sweep moves 4 cm a frame)."""
    out = tmp_path / "RESULTS.md"
    assert eval_suite.main(["-synth-only", "-quick", "-device", "cpu", "-configs",
                            "synth_sweep_openloop", "-o", str(out),
                            "-dir", str(tmp_path / "none")]) == 0
    rows = [ln for ln in out.read_text().splitlines() if ln.startswith("| synth_")]
    assert len(rows) == 1 and "SYNTHETIC sweep x30" in rows[0]
    ate = float(rows[0].split("|")[3])
    assert 0 <= ate < 0.03
    assert sorted(p.name for p in tmp_path.iterdir()) == ["RESULTS.md"]


def test_ring_buffer_handoff():
    ring = FrameRingBuffer()
    assert ring.wait_for(-1, timeout=0.05) is None
    f = Frame(timestamp=7, depth_mm=np.zeros((2, 2), np.uint16),
              rgb=np.zeros((2, 2, 3), np.uint8))
    ring.push(f)
    assert ring.wait_for(-1, timeout=0.5) is f
    for i in range(5):
        ring.push(Frame(timestamp=i, depth_mm=f.depth_mm, rgb=f.rgb))
    ring.wait_for(0, timeout=0.5)
    assert ring.dropped >= 3


def test_live_reader_streams():
    rdr = LiveLogReader(SyntheticCamera(CAM, fps=60.0, n_frames=6))
    try:
        f0 = rdr.get_next(timeout=5.0)
        f1 = rdr.get_next(timeout=5.0)
        assert f1.timestamp > f0.timestamp
        assert f0.depth_mm.shape == (CAM.height, CAM.width)
        assert (f0.depth_mm > 0).mean() > 0.5
    finally:
        rdr.close()


# --- fetch_datasets (no network: the download is replaced) -----------------


def _fake_download(src):
    """A stand-in for `urllib.request.urlretrieve` that copies `src`."""
    import shutil

    def fetch(url, fname):
        shutil.copyfile(src, fname)
        return str(fname), None
    return fetch


def test_fetch_datasets_table_is_the_references():
    from elasticfusion_tpu.tools import fetch_datasets as ref_fetch
    from elasticfusion_tpu_torch.tools import fetch_datasets

    assert fetch_datasets.DATASETS == ref_fetch.DATASETS
    assert (fetch_datasets.TUM_BASE, fetch_datasets.ICL_BASE) == (
        ref_fetch.TUM_BASE, ref_fetch.ICL_BASE)
    # eval_suite resolves datasets with this module's helper, not a copy
    assert eval_suite.dataset_dir is fetch_datasets.dataset_dir


def test_fetch_on_a_cached_directory_downloads_nothing(tmp_path, capsys, monkeypatch):
    import urllib.request

    from elasticfusion_tpu_torch.tools import fetch_datasets

    def refuse(*a):
        raise AssertionError("a cached dataset was downloaded")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    (tmp_path / "fr1_desk").mkdir()
    (tmp_path / "fr1_desk" / "depth.txt").write_text("# depth\n")
    assert fetch_datasets.fetch("fr1_desk", tmp_path) == tmp_path / "fr1_desk"
    assert capsys.readouterr().out == f"[cached] fr1_desk -> {tmp_path / 'fr1_desk'}\n"
    assert fetch_datasets.dataset_dir("fr1_desk", tmp_path) == tmp_path / "fr1_desk"
    assert fetch_datasets.main(["-dir", str(tmp_path), "fr1_desk"]) == 0
    assert fetch_datasets.main(["-dir", str(tmp_path), "fr9_nothing"]) == 1
    assert "unknown dataset fr9_nothing" in capsys.readouterr().out


def test_fetch_extracts_a_download_and_finds_the_sequence(tmp_path, capsys, monkeypatch):
    """A `.tgz` of one TUM sequence, built here, stands in for the download:
    it is extracted and removed, and `dataset_dir` finds the sequence's
    directory; a `.klg` download is kept as is and found too."""
    import tarfile
    import urllib.request

    from elasticfusion_tpu_torch.tools import fetch_datasets

    seq = tmp_path / "src" / "rgbd_dataset_freiburg2_xyz"
    seq.mkdir(parents=True)
    for name in ("depth.txt", "rgb.txt", "groundtruth.txt"):
        (seq / name).write_text(f"# {name}\n")
    tgz = tmp_path / "src" / "seq.tgz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(seq, arcname=seq.name)
    root = tmp_path / "datasets"
    monkeypatch.setattr(urllib.request, "urlretrieve", _fake_download(tgz))
    dest = fetch_datasets.fetch("fr2_xyz", root)
    assert dest == root / "fr2_xyz"
    assert sorted(p.name for p in dest.iterdir()) == [seq.name]      # archive removed
    assert (dest / seq.name / "depth.txt").read_text() == "# depth.txt\n"
    assert fetch_datasets.dataset_dir("fr2_xyz", root) == dest / seq.name
    url = fetch_datasets.DATASETS["fr2_xyz"][0]
    assert capsys.readouterr().out == f"[fetch] {url}\n[ok] fr2_xyz -> {dest}\n"

    klg = tmp_path / "src" / "log.klg"
    klg.write_bytes(b"\x00" * 16)
    monkeypatch.setattr(urllib.request, "urlretrieve", _fake_download(klg))
    dest = fetch_datasets.fetch("dyson_lab", root)
    assert fetch_datasets.dataset_dir("dyson_lab", root) == dest / "dyson_lab.klg"
    assert fetch_datasets.dataset_dir("lr_kt0", root) is None


def test_a_failed_download_ends_in_the_references_message(tmp_path, monkeypatch):
    import urllib.request

    from elasticfusion_tpu.tools import fetch_datasets as ref_fetch
    from elasticfusion_tpu_torch.tools import fetch_datasets

    def fail(url, fname):
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", fail)
    said = []
    for mod, root in ((fetch_datasets, tmp_path / "port"), (ref_fetch, tmp_path / "ref")):
        with pytest.raises(SystemExit) as e:
            mod.fetch("lr_kt1", root)
        said.append(str(e.value))
    assert said[0] == said[1]
    assert said[0].startswith("download failed for lr_kt1: no route to host\n"
                              "No network egress?")
