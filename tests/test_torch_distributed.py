"""Multi-process runs of the port (`parallel/distributed.py`) on the CPU.

  - `PartitionedFerns` merge semantics — the three cases of
    `tests/test_fern_merge.py`, with the host all-gather faked: one global
    winner, the accept on the owner's side, identical constraints on every
    rank, a reject after one round; and a round whose hosts are at different
    ticks raises;
  - two `run_slam -mesh 2 -dist-*` processes over gloo (the shape of
    `tests/test_distributed.py`, through the command line): the surfel map's
    two sub-maps span the processes, the fern database is partitioned, and
    both ranks write a trajectory equal, as text, to the one-process
    `-mesh 2` run's — which holds both sub-maps itself.

numpy, torch and subprocesses only: no XLA program is compiled."""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams
from elasticfusion_tpu_torch.config import EngineConfig
from elasticfusion_tpu_torch.ferns import Ferns, decimate_views
from elasticfusion_tpu_torch.io.klg import write_klg
from elasticfusion_tpu_torch.ops.preprocess import compute_nmap, compute_vmap, metricise_depth
from elasticfusion_tpu_torch.parallel import distributed
from elasticfusion_tpu_torch.parallel.distributed import PartitionedFerns

REPO = Path(__file__).resolve().parent.parent


class _FakeAllgather:
    """`process_allgather` for a fixed schedule of the peer's vectors
    (rank 0 = this process, rank 1 = the peer)."""

    def __init__(self, peer_vectors):
        self.peer = list(peer_vectors)
        self.calls = []

    def __call__(self, obj):
        tick, tag, arr = obj
        self.calls.append((tick, tag))
        return [obj, (tick, tag, np.asarray(self.peer.pop(0), np.float64))]


@pytest.fixture(scope="module")
def views():
    from elasticfusion_tpu_torch.utils.synthetic import make_scene, render_frame

    _, cam = both_cams(SMALL_CAM)
    scene = make_scene(n_side=700)
    d_mm, rgb = render_frame(scene[0], scene[1], np.eye(4), cam)
    depth = metricise_depth(torch.from_numpy(d_mm.astype(np.float32)), 20.0)
    vmap = compute_vmap(depth, cam, 20.0)
    return cam, torch.from_numpy(rgb.astype(np.float32)), vmap, compute_nmap(vmap)


def _ferns(cam):
    cfg = EngineConfig(camera=cam, fern_pyramid_factor=8, fern_min_age=0,
                       fern_threshold=0.01, fern_inlier_count=10, fern_icp_error=1.0,
                       photo_threshold=1e6)
    return Ferns(cfg, "cpu")


def _small(f, img, vtx, nrm):
    return decimate_views(img, vtx, nrm, f.cfg.fern_pyramid_factor)


def test_partition_and_single_process_merge():
    """Keyframe ownership is round-robin in the source time; one process
    gathers only its own object and brings up no group."""
    for rank in (0, 1):
        pf = PartitionedFerns(None, 2, rank)
        assert {t for t in range(10) if pf._owns(t)} == set(range(rank, 10, 2))
    assert distributed.world() == (1, 0)
    assert distributed.process_allgather((0.4, 7)) == [(0.4, 7)]
    assert not distributed.initialize_from_env()        # one process: no group


def test_merge_peer_wins_owner_accepts(views, monkeypatch):
    """The peer offers a better candidate it owns: this rank does NOT run its
    accept branch, adopts the broadcast pose, and emits constraints from its
    own (replicated) views."""
    cam, img, vtx, nrm = views
    f = _ferns(cam)
    assert f.add_frame(img, vtx, nrm, np.eye(4), src_time=2)
    pf = PartitionedFerns(f, 2, 0)
    T_peer = np.eye(4)
    T_peer[0, 3] = 0.25
    fake = _FakeAllgather([
        [0.05, 3.0, 0.9],                                      # src 3: rank 1's
        np.concatenate([[1.0], T_peer.reshape(-1), [3.0]]),    # its verdict
    ])
    monkeypatch.setattr(distributed, "process_allgather", fake)
    T_est, cons = pf.find_frame_scored(0, 0.5, 0.9, f.frames[0].codes, 40,
                                       _small(f, img, vtx, nrm), np.eye(4), 10, False)
    assert fake.calls == [(10, "cand"), (10, "verdict")]
    np.testing.assert_allclose(np.asarray(T_est), T_peer)
    assert pf.last_closest != -1 and pf.closest_src_time() == 3
    assert len(cons) > 0
    # constraint targets carry the merged (peer) pose's translation
    assert all(abs((c.target_point - c.source_point)[0] - 0.25) < 1e-6 for c in cons)


def test_merge_reject_is_symmetric(views, monkeypatch):
    """No host has a finite candidate: both reject after ONE round (a second
    would deadlock)."""
    cam, img, vtx, nrm = views
    f = _ferns(cam)
    pf = PartitionedFerns(f, 2, 0)
    fake = _FakeAllgather([[np.inf, -1.0, 0.0]])
    monkeypatch.setattr(distributed, "process_allgather", fake)
    T_est, cons = pf.find_frame_scored(-1, np.inf, 0.0, None, 0,
                                       _small(f, img, vtx, nrm), np.eye(4), 10, False)
    assert T_est is None and cons == [] and len(fake.calls) == 1
    assert pf.last_closest == -1


def test_merge_local_owner_runs_accept(views, monkeypatch):
    """This rank owns the global winner: its accept branch (fern ICP and the
    photometric check) runs and its verdict is all-gathered."""
    cam, img, vtx, nrm = views
    f = _ferns(cam)
    assert f.add_frame(img, vtx, nrm, np.eye(4), src_time=2)
    pf = PartitionedFerns(f, 2, 0)
    fake = _FakeAllgather([[0.9, -1.0, 0.0], np.zeros(18)])
    monkeypatch.setattr(distributed, "process_allgather", fake)
    T_est, cons = pf.find_frame_scored(0, 0.1, 0.9, f.frames[0].codes, 40,
                                       _small(f, img, vtx, nrm), np.eye(4), 10, False)
    assert len(fake.calls) == 2
    assert pf.last_closest != -1 and pf.closest_src_time() == 2
    assert T_est is not None and len(cons) > 0


def test_a_round_out_of_step_raises(views, monkeypatch):
    cam, img, vtx, nrm = views
    pf = PartitionedFerns(_ferns(cam), 2, 0)
    monkeypatch.setattr(distributed, "process_allgather",
                        lambda obj: [obj, (obj[0] + 1, obj[1], obj[2])])
    with pytest.raises(RuntimeError, match="out of step"):
        pf._host_allgather("cand", 10, [1.0, 2.0, 3.0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_are_the_one_process_mesh_run(tmp_path):
    from elasticfusion_tpu_torch.utils.synthetic import (
        make_scene,
        render_frame,
        synthetic_trajectory,
    )

    _, cam = both_cams(SMALL_CAM)
    scene = make_scene(n_side=500)
    frames = []
    for i, T in enumerate(synthetic_trajectory("sweep", 120)[:6]):
        d, rgb = render_frame(scene[0], scene[1], T, cam)
        frames.append((1_000_000 + 33_333 * i, d, rgb))
    log = tmp_path / "sweep.klg"
    write_klg(log, frames)
    cal = tmp_path / "cal.txt"
    cal.write_text(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy}\n")
    base = [sys.executable, "-m", "elasticfusion_tpu_torch.tools.run_slam", "-l", str(log),
            "-res", f"{cam.width}x{cam.height}", "-cal", str(cal), "-c", "0.3",
            "-device", "cpu", "-mesh", "2"]
    env = dict(__import__("os").environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        base + ["-o", str(tmp_path / f"rank{r}"), "-dist-coordinator", coord,
                "-dist-nprocs", "2", "-dist-rank", str(r)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    one = subprocess.run(base + ["-o", str(tmp_path / "one")], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    outs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} timed out")
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        outs.append(out)
    assert one.returncode == 0, one.stderr[-3000:]
    assert '"processes": 2' in outs[0] and '"processes": 1' in one.stdout
    want = (tmp_path / "one.freiburg").read_text()
    assert len(want.splitlines()) == len(frames)
    for r in (0, 1):
        assert (tmp_path / f"rank{r}.freiburg").read_text() == want, f"rank {r}"
