"""The port's readers and writers (`elasticfusion_tpu_torch/io/`) against the
reference package's on the same bytes, at the sizes of `tests/test_io.py`.
numpy only: no XLA program is compiled (the reference's io functions are
pure numpy; its PLY writer gets a map of numpy arrays)."""

import types

import numpy as np
import pytest
import torch

from elasticfusion_tpu import io as ref_io
from elasticfusion_tpu.utils.synthetic import pose_from_xyzrpy
from elasticfusion_tpu_torch import _build, _device
from elasticfusion_tpu_torch import io as port_io
from elasticfusion_tpu_torch.io import ply as port_ply
from elasticfusion_tpu_torch.io.groundtruth import GroundTruthOdometry as PortGT
from elasticfusion_tpu_torch.surfels import SurfelMap

IO = {"ref": ref_io, "port": port_io}
H, W = 24, 32


def _rand_frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(1_000_000 + 33_000 * i,
             rng.integers(0, 5000, (H, W)).astype(np.uint16),
             rng.integers(0, 255, (H, W, 3)).astype(np.uint8)) for i in range(n)]


def _decode_all(mod, path):
    r = mod.KlgLogReader(path, width=W, height=H)
    out = [(f.timestamp, f.depth_mm.copy(), f.rgb.copy()) for f in r]
    r.rewind()
    first = r.get_next().timestamp
    r.fast_forward(3)
    third = r.get_next().timestamp
    r.close()
    return out, first, third


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_klg_decodes_identically_in_both(tmp_path, writer, compress):
    """A .klg written by either package: the same bytes from both writers,
    and both readers decode every frame (timestamp, depth, rgb) exactly,
    rewind and fast-forward alike."""
    frames = _rand_frames(5)
    p = tmp_path / "log.klg"
    IO[writer].write_klg(p, frames, compress_depth=compress)
    other = tmp_path / "other.klg"
    IO["port" if writer == "ref" else "ref"].write_klg(other, frames, compress_depth=compress)
    assert p.read_bytes() == other.read_bytes()
    got = {k: _decode_all(m, p) for k, m in IO.items()}
    for (ts, d, rgb), want in zip(got["port"][0], frames):
        assert ts == want[0]
        np.testing.assert_array_equal(d, want[1])
        np.testing.assert_array_equal(rgb, want[2])
    for a, b in zip(got["port"][0], got["ref"][0]):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert got["port"][1:] == got["ref"][1:] == (frames[0][0], frames[3][0])
    # open_klg takes the port's native decoder where this host builds it
    # (tests/test_torch_native_klg.py holds it), else the Python one
    native = not _build.host_toolchain_missing("klg_decoder")
    r = port_io.open_klg(p, W, H)
    assert type(r) is (port_io.NativeKlgLogReader if native else port_io.KlgLogReader)
    for (ts, d, rgb), f in zip(frames, r):
        assert f.timestamp == ts
        np.testing.assert_array_equal(f.depth_mm, d)
        np.testing.assert_array_equal(f.rgb, rgb)


@pytest.mark.parametrize("cut", [0.5, 0.9], ids=["payload", "tail"])
def test_truncated_klg_raises_in_both(tmp_path, cut):
    frames = _rand_frames(3)
    p = tmp_path / "raw.klg"
    port_io.write_klg(p, frames, compress_depth=False)
    data = p.read_bytes()
    (tmp_path / "trunc.klg").write_bytes(data[: int(len(data) * cut)])
    for mod in IO.values():
        r = mod.KlgLogReader(tmp_path / "trunc.klg", width=W, height=H)
        with pytest.raises(EOFError):
            for _ in range(3):
                r.get_next()
        r.close()


def test_klg_jpeg_frame_decodes_in_both(tmp_path):
    """An image payload that is neither raw nor empty is a JPEG (decoded
    through PIL, imported only then)."""
    import io as _io
    import struct
    import zlib

    from PIL import Image

    rgb = np.random.default_rng(2).integers(0, 255, (H, W, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG")
    depth = zlib.compress(np.zeros((H, W), np.uint16).tobytes())
    p = tmp_path / "jpeg.klg"
    p.write_bytes(struct.pack("<i", 1) + struct.pack("<qii", 5, len(depth), len(buf.getvalue()))
                  + depth + buf.getvalue())
    got = [m.KlgLogReader(p, W, H).get_next().rgb for m in IO.values()]
    assert got[0].shape == (H, W, 3) and np.array_equal(got[0], got[1])


def _tum_dir(root):
    from PIL import Image

    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(4):
        t = 100.0 + i * 0.033
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(np.uint8)).save(
            root / "rgb" / f"{t:.6f}.png")
        Image.fromarray(rng.integers(0, 30000, (H, W)).astype(np.uint16)).save(
            root / "depth" / f"{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
        q = np.sin(0.05 * i)
        gt_lines.append(f"{t:.6f} {0.1 * i} {-0.02 * i} 0.5 0 {q} 0 {np.sqrt(1 - q * q)}")
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(depth_lines))
    (root / "groundtruth.txt").write_text("\n".join(gt_lines))


def test_tum_association_frames_and_groundtruth_agree(tmp_path):
    _tum_dir(tmp_path)
    readers = {k: m.TumLogReader(tmp_path) for k, m in IO.items()}
    assert readers["port"].num_frames == readers["ref"].num_frames == 4
    for _ in range(4):
        a, b = readers["port"].get_next(), readers["ref"].get_next()
        assert a.timestamp == b.timestamp
        assert np.array_equal(a.depth_mm, b.depth_mm) and np.array_equal(a.rgb, b.rgb)
        assert a.depth_mm.max() <= 6000 and a.depth_mm.dtype == np.uint16
    gts = {k: m.read_groundtruth(tmp_path) for k, m in IO.items()}
    assert len(gts["port"]) == 4
    for (ta, Ta), (tb, Tb) in zip(gts["port"], gts["ref"]):
        assert ta == tb and np.array_equal(Ta, Tb)


@pytest.mark.parametrize("max_difference", [0.02, 0.003])
def test_associate_agrees(max_difference):
    rng = np.random.default_rng(4)
    a = [(float(t), f"a{i}") for i, t in enumerate(np.sort(rng.uniform(0, 1, 40)))]
    b = [(float(t), f"b{i}") for i, t in enumerate(np.sort(rng.uniform(0, 1, 35)))]
    got = port_io.associate(a, b, max_difference)
    assert got == ref_io.associate(a, b, max_difference) and len(got) > 0


def test_groundtruth_odometry_agrees(tmp_path):
    from elasticfusion_tpu.io.groundtruth import GroundTruthOdometry as RefGT

    p = tmp_path / "gt.csv"
    p.write_text("# utime,x,y,z,qx,qy,qz,qw\n" + "\n".join(
        f"{1000 * i},{0.1 * i},{0.02 * i},0.3,0,{np.sin(0.1 * i)},0,{np.cos(0.1 * i)}"
        for i in range(6)))
    port, ref = PortGT(p), RefGT(p)
    for utime in (0, 1400, 2600, 5000, 9000):
        assert np.array_equal(port.get_transformation(utime), ref.get_transformation(utime))


@pytest.mark.parametrize("iclnuim", [False, True], ids=["tum", "iclnuim"])
def test_freiburg_is_byte_identical(tmp_path, iclnuim):
    poses = [(1_000_000 + 33_000 * i, pose_from_xyzrpy(x=0.01 * i, yaw=0.02 * i, pitch=-0.3 * i))
             for i in range(10)]
    for k, m in IO.items():
        m.write_freiburg(tmp_path / f"{k}.freiburg", poses, iclnuim=iclnuim)
    text = (tmp_path / "port.freiburg").read_bytes()
    assert text == (tmp_path / "ref.freiburg").read_bytes()
    back = port_io.read_freiburg(tmp_path / "port.freiburg")
    want = ref_io.read_freiburg(tmp_path / "ref.freiburg")
    for (t, T), (t2, T2), (_, T0) in zip(back, want, poses):
        assert t == t2 and np.array_equal(T, T2)
        np.testing.assert_allclose(T[:3, 3], T0[:3, 3], atol=1e-12)


@pytest.mark.parametrize("align", [True, False])
def test_ate_and_horn_agree(align):
    gt = [(i * 0.033, pose_from_xyzrpy(x=0.01 * i, y=0.002 * i)) for i in range(50)]
    off = pose_from_xyzrpy(x=1.0, z=-2.0, yaw=0.8)
    rng = np.random.default_rng(0)
    est = []
    for t, T in gt:
        Te = (off @ T).copy()
        Te[:3, 3] += rng.normal(scale=0.003, size=3)
        est.append((t + 0.004, Te))
    a, b = port_io.ate_rmse(gt, est, align=align), ref_io.ate_rmse(gt, est, align=align)
    assert abs(a - b) <= 1e-12
    x = np.stack([T[:3, 3] for _, T in est], axis=1)
    y = np.stack([T[:3, 3] for _, T in gt], axis=1)
    (R, t), (R2, t2) = port_io.horn_align(x, y), ref_io.horn_align(x, y)
    np.testing.assert_allclose(R, R2, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t, t2, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        port_io.ate_rmse(gt[:1], est[:1])


def _maps(cap=256, n=100):
    rng = np.random.default_rng(1)
    f = dict(pos=rng.normal(size=(3, cap)), conf=np.linspace(0, 20, cap),
             color=rng.integers(0, 255, (3, cap)), init_t=rng.integers(1, 9, cap),
             last_t=rng.integers(1, 9, cap), normal=rng.normal(size=(3, cap)),
             radius=np.full(cap, 0.01))
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    ref = types.SimpleNamespace(count=np.int32(n), **f)
    port = SurfelMap(count=torch.tensor(n, dtype=torch.int32),
                     **{k: torch.from_numpy(v) for k, v in f.items()})
    return ref, port, f, n


def test_ply_is_byte_identical_and_round_trips(tmp_path):
    ref_map, port_map, f, n = _maps()
    got = port_io.save_ply(tmp_path / "port.ply", port_map, conf_threshold=10.0)
    want = ref_io.save_ply(tmp_path / "ref.ply", ref_map, conf_threshold=10.0)
    assert got == want == int((f["conf"][:n] > 10.0).sum())
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    rec = port_io.load_ply(tmp_path / "port.ply")
    assert np.array_equal(rec, ref_io.load_ply(tmp_path / "port.ply"))
    keep = np.where(f["conf"][:n] > 10.0)[0]
    np.testing.assert_array_equal(rec["x"], f["pos"][0, keep])
    np.testing.assert_array_equal(rec["nx"], -f["normal"][0, keep])   # negated on export


def test_map_to_host_is_one_read_of_the_live_surfels(monkeypatch):
    """`save_ply` and `save_checkpoint` read a map in one packed copy: count
    and every field, sliced to the live surfels on the host."""
    _, port_map, f, n = _maps()
    calls = []
    real = _device.read_back
    monkeypatch.setattr(port_ply, "read_back", lambda t: (calls.append(t.numel()), real(t))[1])
    host = port_ply.map_to_host(port_map)
    assert calls == [1 + 13 * 256]
    for got, k in zip(host, ("pos", "conf", "color", "init_t", "last_t", "normal", "radius")):
        np.testing.assert_array_equal(got, f[k][..., :n])
