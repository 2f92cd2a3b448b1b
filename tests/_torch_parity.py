"""Helpers shared by the tests of the PyTorch port (`tests/test_torch_*.py`).

The same numpy inputs go through a function of the JAX reference package and
its counterpart in `elasticfusion_tpu_torch`; the port runs with tensors on
the CPU, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# the suite runs several worker processes side by side; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing the cores
torch.set_num_threads(1)


def tt(x) -> torch.Tensor:
    """numpy / jax array → CPU tensor (float arrays as float32)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def nn(x) -> np.ndarray:
    """tensor / jax array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frac_differing(a, b, rtol: float, atol: float) -> float:
    """Share of elements outside rtol/atol."""
    return 1.0 - float(np.isclose(nn(a), nn(b), rtol=rtol, atol=atol).mean())


def both_cams(d: dict):
    """One dict of camera fields → (reference CameraConfig, port CameraConfig)."""
    from elasticfusion_tpu.config import CameraConfig as RefCam
    from elasticfusion_tpu_torch.config import CameraConfig as PortCam

    return RefCam(**d), PortCam(**d)


SMALL_CAM = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
TILE_CAM = dict(width=128, height=40, fx=110.0, fy=110.0, cx=64.0, cy=20.0)


def rot_err(Ta: np.ndarray, Tb: np.ndarray) -> float:
    """Angle (rad) between the rotation blocks of two 4x4 transforms, from
    the chord ‖Ra − Rb‖_F = 2√2·sin(θ/2) (arccos of a trace loses half the
    digits near θ = 0)."""
    Ra = np.asarray(Ta, np.float64)[:3, :3]
    Rb = np.asarray(Tb, np.float64)[:3, :3]
    chord = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(chord, 1.0)))


def run_reference_child(func: str, out_path, *args: str, timeout: float,
                        cpu_devices: int = 1):
    """Run `tests/<module>.py::<function>(out_path, *args)` of the reference
    package in a child interpreter and load the pickle it writes
    (`cpu_devices` > 1: a virtual CPU mesh of that many devices, for the
    reference's `mesh_shape` engine).

    A reference run that goes through un-jitted JAX calls (host
    orchestration: `Deformation.constrain`, `Ferns`, `Engine`) compiles one
    XLA program per operation; under `tests/conftest.py`, which forks a
    child for every compile, such a run takes many minutes in the test
    process.  The child compiles in its own process instead, which keeps the
    suite just as safe from an XLA:CPU crash (it ends the child, and the run
    is tried once more).  A child that runs past `timeout` seconds fails its
    caller.  The runs of `REFERENCE_MODULES` are read from committed files
    (`reference_output`); the one live child in tier-1 is the checkpoint
    test's, which loads a checkpoint the port wrote in the same test."""
    import os
    import pickle
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    module, name = func.split(":")
    code = (
        "import resource, sys\n"
        "s, h = resource.getrlimit(resource.RLIMIT_STACK)\n"
        "resource.setrlimit(resource.RLIMIT_STACK, (h, h))\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path.insert(0, {here!r})\n"
        f"import {module} as m\n"
        f"m.{name}(*sys.argv[1:])\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if cpu_devices > 1:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_"
                            f"device_count={cpu_devices}").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(here), here, env.get("PYTHONPATH", "")])
    for attempt in range(2):
        out = subprocess.run([sys.executable, "-c", code, str(out_path), *args],
                             cwd=os.path.dirname(here), env=env, capture_output=True,
                             text=True, timeout=timeout)
        if out.returncode == 0:
            with open(out_path, "rb") as f:
                return pickle.load(f)
        if out.returncode > 0 or attempt == 1:
            raise RuntimeError(f"reference run {func} failed:\n{out.stderr[-4000:]}")


# The port's test modules that read a reference run from a committed file
# instead of running it: each declares REFERENCE_OUTPUTS, name -> (function,
# arguments, cpu_devices) of `run_reference_child`, built from its own
# constants.  Every input of such a run is seeded or fixed.
# `python tests/_torch_parity.py [name ...]` makes the files anew.
REFERENCE_MODULES = ("test_torch_closure", "test_torch_deformation", "test_torch_external_pose",
                     "test_torch_ferns", "test_torch_pipeline", "test_torch_scaling_bench",
                     "test_torch_shard", "test_torch_shard_engine")
REFERENCE_DIR = Path(__file__).resolve().parent / "data" / "torch_reference"
# seconds one reference run may take when its output is made anew
REGENERATE_TIMEOUT = 3600.0


def reference_outputs() -> dict:
    """name -> (module, function, arguments, cpu_devices) of every committed
    output."""
    import importlib

    return {name: (module, *recipe) for module in REFERENCE_MODULES
            for name, recipe in importlib.import_module(module).REFERENCE_OUTPUTS.items()}


def reference_sources(module: str) -> dict:
    """path -> sha256 of every source a reference run of test module
    `module` reads: the reference package, this file, the module (its
    helpers and constants), and the port's synthetic scenes (the shard
    files render their frames with them)."""
    import hashlib

    root = REFERENCE_DIR.parents[2]
    paths = [*sorted((root / "elasticfusion_tpu").rglob("*.py")),
             Path(__file__).resolve(), root / "tests" / f"{module}.py",
             root / "elasticfusion_tpu_torch" / "utils" / "synthetic.py"]
    return {path.relative_to(root).as_posix(): hashlib.sha256(path.read_bytes()).hexdigest()
            for path in paths}


def reference_output(name: str, record: bool = False):
    """The committed output of reference run `name`; with `record`, the
    whole file: `output`, the `sources` it was made from and the `jax` /
    `jaxlib` versions that made it."""
    import gzip
    import pickle

    with gzip.open(REFERENCE_DIR / f"{name}.pkl.gz", "rb") as f:
        whole = pickle.load(f)
    return whole if record else whole["output"]


if __name__ == "__main__":
    import gzip
    import pickle
    import sys
    import tempfile

    # the environment the suite's children inherit (XLA_FLAGS, platform)
    sys.path.insert(0, str(REFERENCE_DIR.parents[2]))
    import conftest  # noqa: F401
    import jax
    import jaxlib

    table = reference_outputs()
    REFERENCE_DIR.mkdir(parents=True, exist_ok=True)
    for name in sys.argv[1:] or table:
        module, func, args, cpu_devices = table[name]
        sources = reference_sources(module)
        with tempfile.TemporaryDirectory() as tmp:
            output = run_reference_child(f"{module}:{func}", Path(tmp) / "out.pkl", *args,
                                         timeout=REGENERATE_TIMEOUT, cpu_devices=cpu_devices)
        path = REFERENCE_DIR / f"{name}.pkl.gz"
        # protocol 4: protocol 5 would load the arrays read-only
        with open(path, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as f:
            pickle.dump(dict(output=output, sources=sources, jax=jax.__version__,
                             jaxlib=jaxlib.__version__), f, protocol=4)
        print(f"{path}: {path.stat().st_size} bytes", flush=True)
