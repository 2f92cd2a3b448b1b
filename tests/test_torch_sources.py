"""Static checks of the port's sources, and of every kernel wrapper's contract
that needs no card: the port imports neither JAX nor the JAX package, every
kernel source and launcher symbol a wrapper asks for exists, every wrapper has
a plain version and gets its launcher from `kernel_function`, refuses a tensor
that is neither on the CPU nor on a card before it reaches a kernel, and
importing the package builds nothing and starts no CUDA context."""

import ast
import importlib
import os
import pkgutil
import re

import numpy as np
import pytest
import torch

import elasticfusion_tpu_torch
from _torch_kernels import WRAPPER_MODULES, kernel_calls  # noqa: F401
from elasticfusion_tpu_torch import _build
from elasticfusion_tpu_torch.ops import bilateral as bilateral_mod
from elasticfusion_tpu_torch.ops import fuse_window as fuse_window_mod
from elasticfusion_tpu_torch.ops import gram as gram_mod
from elasticfusion_tpu_torch.ops import odometry as odometry_mod
from elasticfusion_tpu_torch.ops import pyramid as pyramid_mod
from elasticfusion_tpu_torch.ops import splat_resolve as splat_resolve_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "elasticfusion_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "elasticfusion_tpu"}


def _python_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


@pytest.mark.parametrize("path", _python_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_imports_neither_jax_nor_the_jax_package(path):
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path}:{node.lineno} imports {roots}"


def test_the_scan_covers_io_tools_and_checkpoint():
    rel = {os.path.relpath(p, PKG) for p in _python_sources()}
    assert {"checkpoint.py", "io/klg.py", "io/ply.py", "io/trajectory.py", "io/tum.py",
            "io/groundtruth.py", "tools/run_slam.py", "tools/eval_suite.py",
            "tools/camera.py", "tools/report.py", "tools/view_map.py",
            "tools/scaling_bench.py", "tools/fetch_datasets.py"} <= rel


def test_the_scan_covers_the_parallel_modules():
    rel = {os.path.relpath(p, PKG) for p in _python_sources()}
    assert {"parallel/__init__.py", "parallel/sharding.py", "parallel/shard_step.py",
            "parallel/distributed.py", "ops/gatherpack.py"} <= rel


@pytest.mark.parametrize("path", _python_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_reads_no_native_decoder(path):
    """No port module loads the reference's native decoder library
    (`native/libefklg.so`): the port builds its own from
    `csrc/klg_decoder.cpp`."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert "libefklg" not in text
    assert not re.search(r"native[/\\]", text), "names a path in native/"


def test_the_port_carries_its_own_klg_decoder():
    """`csrc/klg_decoder.cpp` with the reference's C interface, built by the
    host compiler into the port's build directory, never from `native/`."""
    assert set(_build.HOST_SOURCES) == {"klg_decoder"}
    with open(os.path.join(PKG, "csrc", "klg_decoder.cpp"), encoding="utf-8") as f:
        text = f.read()
    for symbol in ("ef_klg_open", "ef_klg_num_frames", "ef_klg_read", "ef_klg_close"):
        assert re.search(r"\b" + symbol + r"\(", text), symbol
    assert 'extern "C"' in text
    assert _build._host_target("klg_decoder").startswith(_build.BUILD_DIR)
    libs = [v[2] for v in _build._host_variants("klg_decoder")]
    assert libs[0] == ["-lz", "-ljpeg"]                      # libjpeg first
    assert all("-lz" in v and not any("native" in x for x in v) for v in libs)


def _kernel_function_calls(module):
    """(enclosing function, source name, symbol) of every
    `kernel_function("<source>", "<symbol>", ...)` call of a wrapper module."""
    found = []
    for fn in ast.walk(_tree(module.__file__)):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "kernel_function"):
                name, symbol = node.args[0], node.args[1]
                assert isinstance(name, ast.Constant) and isinstance(symbol, ast.Constant)
                found.append((fn.name, name.value, symbol.value))
    return found


WRAPPERS = [(m, *call) for m in WRAPPER_MODULES for call in _kernel_function_calls(m)]


def test_the_port_has_fourteen_kernel_wrappers():
    """Fourteen wrappers, each of one kernel: seven of the Pallas sites'
    paths (gram_outer, the four tracking steps, splat_resolve, fuse_window),
    the two tracker updates (csrc/tracker_update.cu) that keep the tracker's
    loops on the card, and the five preprocess stencils that XLA fuses for
    the reference: the bilateral filter (csrc/bilateral.cu), and the three
    pyrDowns and the derivatives (csrc/pyramid.cu).  This sorted list is the
    one guard on the set of wrappers."""
    assert sorted(w[1] for w in WRAPPERS) == [
        "bilateral_filter", "compute_derivatives", "compute_rgb_residual", "fuse_window",
        "gn_update", "gram_outer", "icp_step", "pyr_down_depth", "pyr_down_gauss",
        "pyr_down_intensity", "rgb_step", "so3_step", "so3_update", "splat_resolve"]


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_kernel_source_and_its_headers_exist(name):
    files = _build.source_files(name)
    assert files[0].endswith(os.path.join("csrc", name + ".cu"))
    assert all(os.path.isfile(f) for f in files)


def test_a_header_edit_changes_the_library_name(tmp_path, monkeypatch):
    """The library is named by a hash over the source AND the headers it
    includes, so an edited header cannot meet a stale library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "gram.cu").write_text('#include "inner.cuh"\nint x;\n')
    (csrc / "inner.cuh").write_text('  #  include "leaf.cuh"\n')
    (csrc / "leaf.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    assert [os.path.basename(f) for f in _build.source_files("gram")] == [
        "gram.cu", "inner.cuh", "leaf.cuh"]
    before = _build._target("gram")
    (csrc / "leaf.cuh").write_text("// v2\n")
    assert _build._target("gram") != before


@pytest.mark.parametrize("module,function,source,symbol", WRAPPERS,
                         ids=[w[1] for w in WRAPPERS])
def test_wrapper_has_source_symbol_and_plain_version(module, function, source, symbol):
    assert source in _build.SOURCES
    with open(_build.source_files(source)[0], encoding="utf-8") as f:
        text = f.read()
    assert re.search(r'extern\s+"C"\s+int\s+' + re.escape(symbol) + r"\s*\(", text), (
        f"{symbol} is no extern \"C\" launcher of csrc/{source}.cu")
    assert callable(getattr(module, function))
    assert callable(getattr(module, function + "_plain"))
    # `kernel_calls` replaces the launcher by this name in the module
    assert module.kernel_function is _build.kernel_function


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_calls():
    H, W = 4, 6
    N = H * W
    corres = odometry_mod.RgbCorrespondence(
        u0=None, v0=None, diff=_meta(N), valid=None, count=_meta(),
        sigma_sum=_meta(), flat0=_meta(N, dtype=torch.int32))
    return {
        "gram_outer": lambda: gram_mod.gram_outer(_meta(7, 64)),
        "bilateral_filter": lambda: bilateral_mod.bilateral_filter(_meta(H, W)),
        "pyr_down_depth": lambda: pyramid_mod.pyr_down_depth(_meta(H, W)),
        "pyr_down_gauss": lambda: pyramid_mod.pyr_down_gauss(_meta(H, W)),
        "pyr_down_intensity": lambda: pyramid_mod.pyr_down_intensity(_meta(H, W)),
        "compute_derivatives": lambda: pyramid_mod.compute_derivatives(_meta(H, W)),
        "splat_resolve": lambda: splat_resolve_mod.splat_resolve(
            _meta(13, H, W), 5.0, 5.0, 3.0, 2.0),
        "fuse_window": lambda: fuse_window_mod.fuse_window(
            _meta(18, H, W), _meta(12), 5.0, 5.0, 3.0, 2.0, 100),
        "icp_step": lambda: odometry_mod.icp_step(
            _meta(4, 4), _meta(3, H, W), _meta(3, H, W), _meta(4, 4),
            _meta(3, H, W), _meta(3, H, W), 5.0, 5.0, 3.0, 2.0),
        "compute_rgb_residual": lambda: odometry_mod.compute_rgb_residual(
            1.0, _meta(H, W), _meta(H, W), _meta(H, W), _meta(H, W),
            _meta(H, W), _meta(H, W), _meta(3), _meta(3, 3),
            last_table=_meta(2, N), static_gates=_meta(N, dtype=torch.bool)),
        "rgb_step": lambda: odometry_mod.rgb_step(
            corres, None, _meta(3, H, W), 5.0, 5.0, _meta(H, W), _meta(H, W)),
        "so3_step": lambda: odometry_mod.so3_step(
            _meta(H, W), _meta(H, W), _meta(3, 3), _meta(3, 3), _meta(3, 3)),
        "so3_update": lambda: odometry_mod.so3_update(
            1, _meta(14), _meta(odometry_mod.SO3_CARRY), _meta(1, dtype=torch.int32),
            odometry_mod.LevelK(*([1.0] * 8))),
        "gn_update": lambda: odometry_mod.gn_update(
            1, _meta(88), _meta(odometry_mod.GN_CARRY), _meta(1, dtype=torch.int32),
            _meta(4, 4), None, None, odometry_mod.LevelK(*([1.0] * 8)),
            odometry_mod.GNOptions(True, True, False, 10.0, 3e-4, 0.0, 0.3, 1e-4)),
    }


@pytest.mark.parametrize("function", [w[1] for w in WRAPPERS])
def test_wrapper_raises_for_a_tensor_on_neither_cpu_nor_card(function, kernel_calls):
    """Only a CPU tensor gets the plain version; anything else must reach the
    kernel or raise — here a `meta` tensor, which must raise before it
    reaches a kernel."""
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[function]()
    assert kernel_calls == []


def test_icp_step_on_a_fixed_point_table_raises_for_a_meta_tensor(kernel_calls):
    """The fixed-point model table takes the same route: a tensor neither on
    the CPU nor on a card raises before it reaches a kernel."""
    H, W = 4, 6
    table = ("fx16", _meta(3, H * W, dtype=torch.int32), _meta(6), _meta(6))
    with pytest.raises(ValueError, match="unsupported device"):
        odometry_mod.icp_step(_meta(4, 4), _meta(3, H, W), _meta(3, H, W), _meta(4, 4),
                              _meta(3, H, W), _meta(3, H, W), 5.0, 5.0, 3.0, 2.0,
                              prev_table=table)
    assert kernel_calls == []


def test_import_builds_nothing_and_starts_no_cuda_context():
    for info in pkgutil.walk_packages(elasticfusion_tpu_torch.__path__,
                                      "elasticfusion_tpu_torch."):
        importlib.import_module(info.name)
    assert not torch.cuda.is_initialized()
    assert _build._libs == {} and _build.build_log == ""


def _k3_schedule():
    """The tile shape, threads, stages and blocks per SM of `FuseTile` in
    csrc/fuse_window.cu."""
    with open(os.path.join(PKG, "csrc", "fuse_window.cu"), encoding="utf-8") as f:
        text = f.read()
    found = {}
    for name in ("TW", "TH", "NT", "STAGES", "MINB"):
        m = re.search(r"\b" + name + r" = (\d+)[,;]", text)
        assert m, f"FuseTile::{name} not found"
        found[name] = int(m.group(1))
    return found


def test_k3_schedules_keep_both_loops_of_a_tile_at_least_half_busy():
    """K3's one schedule keeps the last pass of step 1 (tile + 1-ring) and of
    step 3 (tile) at least half busy, and its TMA boxes fit the hardware's
    limits: starts and rows on 16 bytes, at most 256 elements a dimension,
    and its stages fit the SM's shared memory as many times as it asks."""
    k = _k3_schedule()
    tw, th, nt, stages, per_sm = k["TW"], k["TH"], k["NT"], k["STAGES"], k["MINB"]
    assert (tw, th, nt, stages, per_sm) == (36, 11, 512, 2, 2)
    for items in ((tw + 2) * (th + 2), tw * th):
        assert items % nt == 0 or items % nt >= nt // 2, items
    # both boxes start 4 columns left of the tile: a TMA box must start on 16
    # bytes, so the tile's own columns must too
    assert tw % 4 == 0
    box_a = (tw + 8, th + 4, 8)
    box_b = (tw + 8, th + 2, 10)
    for box in (box_a, box_b):
        assert box[0] * 4 % 16 == 0 and max(box) <= 256
    # stages of both boxes (each on 128 bytes) plus the 13-channel ring, and
    # 128 bytes of slack for aligning the base
    stage = sum(-(-(bw * bh * bc) // 32) * 32 for bw, bh, bc in (box_a, box_b))
    smem = 4 * (stages * stage + 13 * (tw + 2) * (th + 2)) + 128
    assert per_sm * (smem + 1024) <= 228 * 1024, smem


@pytest.mark.parametrize("H,W", [(480, 640), (120, 160), (70, 100), (70, 102)])
def test_k3_tile_walk_covers_every_pixel_once(H, W):
    """The persistent grid's walk (block b takes tiles b, b + grid, ...; 264
    resident blocks, as on an H100) writes every output pixel exactly once,
    at any image size: step 3 writes the tile's pixels inside the image."""
    k = _k3_schedule()
    tw, th = k["TW"], k["TH"]
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    n_tiles = tiles_x * tiles_y
    grid = min(n_tiles, 2 * 132)
    hits = np.zeros((H, W), np.int64)
    for b in range(grid):
        for t in range(b, n_tiles, grid):
            y0, x0 = (t // tiles_x) * th, (t % tiles_x) * tw
            hits[y0:y0 + th, x0:x0 + tw] += 1
    assert (hits == 1).all()


def test_tma_layout_reads_in_place_or_pads_the_rows():
    """`tma_layout` passes through a tensor whose pitches and base suit the
    TMA loads (the main path's `cat`, an aligned crop of it) and pads any
    other to rows of a multiple of 4 floats, keeping every value."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((18, 48, 64)).astype(np.float32))
    assert fuse_window_mod.tma_layout(full) is full
    crop = full[:, 5:25, 8:30]             # row pitch 64, base 8 floats in
    assert fuse_window_mod.tma_layout(crop) is crop
    for odd in (crop.contiguous(), full[:, 5:25, 9:31]):   # pitch 22 / base 9
        got = fuse_window_mod.tma_layout(odd)
        assert got is not odd and got.shape == odd.shape
        assert got.stride() == (20 * 24, 24, 1)
        assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)
