"""Builds the hand-written CUDA kernels under `csrc/` and loads them.

Each source has a plain C interface (`extern "C"` launchers taking raw
pointers, sizes and the stream) and is compiled by its own `nvcc` process —
all started together — into a shared library that `ctypes` loads.  No source
includes PyTorch's headers, so a build takes seconds.  Libraries go to
`<checkout>/build/elasticfusion_tpu_torch/`, named by a hash of the source,
the `csrc/` headers it includes and the flags, and are reused while that hash
matches.  Nothing happens at import:
the first kernel launch triggers the build, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "elasticfusion_tpu_torch")

_COMMON_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# The stencils and the fused odometry steps decide hits, matches and inliers
# by float comparisons; without FMA contraction every operation rounds as the
# plain PyTorch versions' do, so the decisions agree (the odometry steps spell
# out the FMAs of their matrix products and Gram sums).  The Gram sum alone has
# no decisions and keeps its FMAs.
SOURCES: Dict[str, List[str]] = {
    "gram": [],
    "odometry_steps": ["-fmad=false"],
    "splat_resolve": ["-fmad=false"],
    "fuse_window": ["-fmad=false"],
}

_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], object] = {}
build_seconds: float = 0.0
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> List[str]:
    """`csrc/<name>.cu` and every file under `csrc/` it includes, directly or
    through another header, in a fixed order."""
    todo, seen = [name + ".cu"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(_CSRC, rel), "rb") as f:
            todo.extend(sorted(m.decode() for m in _INCLUDE.findall(f.read())))
    return [os.path.join(_CSRC, rel) for rel in seen]


def _target(name: str) -> str:
    h = hashlib.sha1(" ".join(_COMMON_FLAGS + SOURCES[name]).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all() -> None:
    """Compile every source that has no up-to-date library, in parallel."""
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, extra in SOURCES.items():
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_COMMON_FLAGS, *extra, "-o", tmp,
               os.path.join(_CSRC, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log += f"--- {name}.cu ---\n{log}"
        if p.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")


def kernel_function(name: str, symbol: str, argtypes: Sequence):
    """The launcher `symbol` of `csrc/<name>.cu` with its C signature set
    (it returns cudaGetLastError() as an int); builds and loads on first use."""
    key = (name, symbol)
    if key not in _functions:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(_target(name))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check_launch(code: int, what: str) -> None:
    """Raise on a refused launch: the launcher returns cudaGetLastError(), or
    a negative code when setting the launch up failed before it (a TMA
    descriptor the driver refused, no resident block)."""
    if code > 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {code}")
    if code < 0:
        raise RuntimeError(f"{what}: launch set-up failed with code {code} "
                           "(-CUresult of cuTensorMapEncodeTiled, or -1000xx "
                           "of the launcher)")
