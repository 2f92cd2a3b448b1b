"""Builds the hand-written CUDA kernels under `csrc/`, and the host library
of the native `.klg` decoder, and loads them.

Each source has a plain C interface (`extern "C"` launchers taking raw
pointers, sizes and the stream) and is compiled by its own `nvcc` process —
all started together — into a shared library that `ctypes` loads.  No source
includes PyTorch's headers, so a build takes seconds.  Libraries go to
`<checkout>/build/elasticfusion_tpu_torch/`, named by a hash of the source,
the `csrc/` headers it includes and the flags, and are reused while that hash
matches.  Nothing happens at import:
the first kernel launch triggers the build, and a failed build raises.

The `.klg` decoder (`csrc/klg_decoder.cpp`: zlib, and libjpeg or else the
CUDA toolkit's nvJPEG) is a host library built by `g++` into the same
directory at its first use (`host_library`).  Where the host has no `g++`,
zlib or JPEG library to build it with (`host_toolchain_missing` names what
is absent), `io.klg` decodes in Python; where it has them, a failed build
raises.
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
# out the FMAs of their matrix products and Gram sums); the bilateral filter
# and the pyramid stencils are bit-identical to their plain versions for the
# same reason.  The Gram sum
# alone has no decisions and keeps its FMAs.
SOURCES: Dict[str, List[str]] = {
    "gram": [],
    "odometry_steps": ["-fmad=false"],
    "tracker_update": ["-fmad=false"],
    "splat_resolve": ["-fmad=false"],
    "fuse_window": ["-fmad=false"],
    "bilateral": ["-fmad=false"],
    "pyramid": ["-fmad=false"],
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


# --- host libraries (g++) ----------------------------------------------------

# name: compiler flags common to its variants
HOST_SOURCES: Dict[str, List[str]] = {
    "klg_decoder": ["-O3", "-fPIC", "-std=c++17", "-shared", "-Wall"],
}
_host_libs: Dict[str, ctypes.CDLL] = {}
_host_missing: Dict[str, str] = {}
_host_chosen: Dict[str, Tuple[str, List[str], List[str]]] = {}
host_build_log: str = ""

_JPEG_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n#include <zlib.h>\n"
               "int main() { jpeg_error_mgr e; jpeg_std_error(&e);"
               " return zlibVersion()[0] == 0; }\n")
_NVJPEG_PROBE = ("#include <nvjpeg.h>\n#include <zlib.h>\n"
                 "int main() { nvjpegHandle_t h; return nvjpegCreateSimple(&h) != 0"
                 " && zlibVersion()[0] == 0; }\n")


def _cuda_home() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "include", "nvjpeg.h")):
            return root
    return ""


def _host_variants(name: str):
    """(label, extra flags, libraries, probe program) of each way to build
    `name`, in order of preference.  The `.klg` decoder decodes JPEG with
    libjpeg, as the original system does, or — on a machine that has the
    CUDA toolkit but no libjpeg — with the toolkit's nvJPEG."""
    assert name == "klg_decoder", name
    out = [("libjpeg", [], ["-lz", "-ljpeg"], _JPEG_PROBE)]
    cuda = _cuda_home()
    if cuda:
        lib = os.path.join(cuda, "lib64")
        out.append(("nvJPEG", ["-DEF_KLG_NVJPEG", "-I" + os.path.join(cuda, "include")],
                    ["-lz", "-L" + lib, "-lnvjpeg", "-lcudart", "-Wl,-rpath," + lib],
                    _NVJPEG_PROBE))
    return out


def _gxx() -> str:
    return shutil.which(os.environ.get("CXX", "g++")) or ""


def host_toolchain_missing(name: str) -> str:
    """'' when this host can build the host library `name`, else what it
    lacks: no C++ compiler, or for every variant the compiler output of the
    probe program that needs its headers and libraries.  Asked once per
    process; `host_variant` names the variant found."""
    if name not in _host_missing:
        gxx = _gxx()
        if not gxx:
            _host_missing[name] = "no C++ compiler (g++)"
            return _host_missing[name]
        os.makedirs(BUILD_DIR, exist_ok=True)
        why = []
        for label, flags, libs, probe in _host_variants(name):
            out = os.path.join(BUILD_DIR, f"probe_{name}.{os.getpid()}")
            p = subprocess.run([gxx, "-x", "c++", "-", "-o", out, *flags, *libs],
                               input=probe, capture_output=True, text=True)
            if os.path.exists(out):
                os.remove(out)
            if p.returncode == 0:
                _host_chosen[name] = (label, flags, libs)
                break
            why.append(f"{label}: " + p.stderr.strip().splitlines()[0][-200:]
                       if p.stderr.strip() else f"{label}: the probe did not build")
        _host_missing[name] = "" if name in _host_chosen else "; ".join(why)
    return _host_missing[name]


def host_variant(name: str) -> str:
    """The label of the variant this host builds `name` with ('' if none)."""
    return "" if host_toolchain_missing(name) else _host_chosen[name][0]


def _host_target(name: str) -> str:
    label, flags, libs = _host_chosen.get(name, ("", [], []))
    h = hashlib.sha1(" ".join([_gxx()] + HOST_SOURCES[name] + flags + libs).encode())
    with open(os.path.join(_CSRC, name + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def host_library(name: str) -> ctypes.CDLL:
    """The host library of `csrc/<name>.cpp`, built by g++ on first use into
    the hashed build directory and loaded.  Raises when the build fails; ask
    `host_toolchain_missing` first where a missing toolchain is expected."""
    global host_build_log
    if name not in _host_libs:
        missing = host_toolchain_missing(name)
        if missing:
            raise RuntimeError(f"cannot build {name}: {missing}")
        out = _host_target(name)
        if not os.path.exists(out):
            _, flags, libs = _host_chosen[name]
            tmp = f"{out}.{os.getpid()}.tmp"
            p = subprocess.run(
                [_gxx(), *HOST_SOURCES[name], *flags, "-o", tmp,
                 os.path.join(_CSRC, name + ".cpp"), *libs], capture_output=True, text=True)
            host_build_log += f"--- {name}.cpp ---\n{p.stdout}{p.stderr}"
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed for {name}.cpp:\n{p.stderr}")
            os.replace(tmp, out)
        _host_libs[name] = ctypes.CDLL(out)
    return _host_libs[name]
