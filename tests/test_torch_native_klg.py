"""The port's native `.klg` decoder (`csrc/klg_decoder.cpp`, built by g++ from
`_build.host_library`) against its Python path and against the reference
package's `NativeKlgLogReader` on the same file — the three cases of
`tests/test_native_klg.py` — plus the committed JPEG-colour fixture and the
fall-back where the host cannot build the decoder.  Tolerance: bit-exact
everywhere (depth, raw and JPEG colour, timestamps); the fixture's colour is
held to the PIL decode it was committed with, which this host's libjpeg
matches exactly.  numpy and ctypes only: no XLA program is compiled."""

import os

import numpy as np
import pytest

from elasticfusion_tpu.io import klg as ref_klg
from elasticfusion_tpu_torch import _build
from elasticfusion_tpu_torch.io import klg as port_klg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(autouse=True)
def _needs_the_toolchain():
    missing = _build.host_toolchain_missing("klg_decoder")
    if missing:
        pytest.skip(f"this host cannot build the native decoder: {missing}")


def _frames(n=4, h=48, w=64):
    rng = np.random.default_rng(3)
    return [
        (500_000 + 33_000 * i,
         rng.integers(0, 8000, (h, w)).astype(np.uint16),
         rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        for i in range(n)
    ]


def test_native_matches_python_and_reference(tmp_path):
    p = tmp_path / "n.klg"
    port_klg.write_klg(p, _frames())
    readers = [port_klg.NativeKlgLogReader(p, width=64, height=48),
               port_klg.KlgLogReader(p, width=64, height=48)]
    if ref_klg._native_lib() is not None:
        readers.append(ref_klg.NativeKlgLogReader(p, width=64, height=48))
    assert {r.num_frames for r in readers} == {4}
    decoded = [list(r) for r in readers]
    for frames in zip(*decoded):
        for f in frames[1:]:
            assert f.timestamp == frames[0].timestamp
            np.testing.assert_array_equal(f.depth_mm, frames[0].depth_mm)
            np.testing.assert_array_equal(f.rgb, frames[0].rgb)
    readers[0].close()


def test_native_seek_and_errors(tmp_path):
    frames = _frames()
    p = tmp_path / "n.klg"
    port_klg.write_klg(p, frames)
    r = port_klg.NativeKlgLogReader(p, width=64, height=48)
    r.fast_forward(2)
    assert r.get_next().timestamp == frames[2][0]
    r.rewind()
    assert r.get_next().timestamp == frames[0][0]
    r.fast_forward(99)
    assert not r.has_more()
    with pytest.raises(EOFError):
        r.get_next()
    r.close()
    # truncated file: the index shrinks to the complete prefix
    data = p.read_bytes()
    (tmp_path / "t.klg").write_bytes(data[: len(data) - 100])
    rt = port_klg.NativeKlgLogReader(tmp_path / "t.klg", width=64, height=48)
    assert rt.num_frames == 3
    rt.close()
    with pytest.raises(IOError):
        port_klg.NativeKlgLogReader(tmp_path / "missing.klg", width=64, height=48)


def test_open_klg_prefers_native_and_says_so(tmp_path, monkeypatch, capsys):
    p = tmp_path / "n.klg"
    port_klg.write_klg(p, _frames(1))
    monkeypatch.setattr(port_klg, "_ANNOUNCED", False)
    assert isinstance(port_klg.open_klg(p, 64, 48), port_klg.NativeKlgLogReader)
    assert "klg: native" in capsys.readouterr().err
    port_klg.open_klg(p, 64, 48)
    assert capsys.readouterr().err == ""          # said once


def test_without_a_toolchain_open_klg_decodes_in_python(tmp_path, monkeypatch, capsys):
    """Where g++, zlib or libjpeg is missing the reader is the Python one and
    the run says why; raw-RGB logs read exactly as before."""
    frames = _frames(2)
    p = tmp_path / "n.klg"
    port_klg.write_klg(p, frames)
    monkeypatch.setattr(port_klg, "_NATIVE", None)
    monkeypatch.setattr(port_klg, "_NATIVE_WHY", None)
    monkeypatch.setattr(port_klg, "_ANNOUNCED", False)
    monkeypatch.setitem(_build._host_missing, "klg_decoder", "no C++ compiler (g++)")
    r = port_klg.open_klg(p, 64, 48)
    assert type(r) is port_klg.KlgLogReader
    assert "klg: Python" in capsys.readouterr().err
    assert "no C++ compiler" in port_klg.decoder_in_use()
    for f, (ts, d, rgb) in zip(r, frames):
        assert f.timestamp == ts
        np.testing.assert_array_equal(f.depth_mm, d)
        np.testing.assert_array_equal(f.rgb, rgb)
    with pytest.raises(RuntimeError, match="no native .klg decoder"):
        port_klg.NativeKlgLogReader(p, 64, 48)


def test_jpeg_fixture_decodes_exactly():
    """The committed 640x480 JPEG-colour log (`tests/data/make_jpeg_klg.py`):
    depth equals the Python zlib path bit for bit, colour equals PIL's decode
    (the committed rows and the Python path) and the reference's native
    decoder's.  (An nvJPEG build — a host without libjpeg — is held to its
    own tolerance by `chip_smoke.py` phase 7 (a).)"""
    if _build.host_variant("klg_decoder") != "libjpeg":
        pytest.skip("the decoder here is not the libjpeg build")
    path = os.path.join(DATA, "sweep_jpeg.klg")
    rows = np.load(os.path.join(DATA, "sweep_jpeg_rows.npz"))
    step = int(rows["row_step"])
    native = list(port_klg.NativeKlgLogReader(path))
    python = list(port_klg.KlgLogReader(path))
    assert len(native) == len(python) == rows["rows"].shape[0] == 2
    for n, p, want in zip(native, python, rows["rows"]):
        assert n.timestamp == p.timestamp
        np.testing.assert_array_equal(n.depth_mm, p.depth_mm)
        np.testing.assert_array_equal(n.rgb[::step], want)
        np.testing.assert_array_equal(n.rgb, p.rgb)
    if ref_klg._native_lib() is not None:
        for n, r in zip(native, ref_klg.NativeKlgLogReader(path)):
            np.testing.assert_array_equal(n.rgb, r.rgb)
            np.testing.assert_array_equal(n.depth_mm, r.depth_mm)
