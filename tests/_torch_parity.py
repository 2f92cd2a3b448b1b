"""Helpers shared by the tests of the PyTorch port (`tests/test_torch_*.py`).

The same numpy inputs go through a function of the JAX reference package and
its counterpart in `elasticfusion_tpu_torch`; the port runs with tensors on
the CPU, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

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
    package in a child interpreter and load the `.npz`/pickle it writes
    (`cpu_devices` > 1: a virtual CPU mesh of that many devices, for the
    reference's `mesh_shape` engine).

    A reference run that goes through un-jitted JAX calls (host
    orchestration: `Deformation.constrain`, `Ferns`, `Engine`) compiles one
    XLA program per operation; under `tests/conftest.py`, which forks a
    child for every compile, such a run takes many minutes.  The child
    compiles in its own process instead, which keeps the suite just as safe
    from an XLA:CPU crash (it ends the child, and the run is tried once
    more) at the cost of one interpreter start.  Each caller sets `timeout`
    to about 1.5x the slowest reading of its child within a whole tier-1
    run: a child that hangs fails its own test, not the run."""
    import pickle
    import subprocess
    import sys

    code, env, cwd = _child_command(func, cpu_devices)
    for attempt in range(2):
        out = subprocess.run([sys.executable, "-c", code, str(out_path), *args],
                             cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=timeout)
        if out.returncode == 0:
            with open(out_path, "rb") as f:
                return pickle.load(f)
        if out.returncode > 0 or attempt == 1:
            raise RuntimeError(f"reference run {func} failed:\n{out.stderr[-4000:]}")


def _child_command(func: str, cpu_devices: int = 1):
    """(code, environment, working directory) of a reference child running
    `tests/<module>.py::<function>`."""
    import os

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
    return code, env, os.path.dirname(here)


class ReferenceChild:
    """`run_reference_child` started in the background: the test process
    runs the port while the child compiles and runs the reference, and
    `result()` waits for it (a child killed by a signal is run once more, in
    the foreground).  `timeout` counts from the start; a child still running
    then is killed and its test fails."""

    def __init__(self, func: str, out_path, *args: str, timeout: float,
                 cpu_devices: int = 1):
        import subprocess
        import sys
        import time

        self._call = (func, out_path, args, timeout, cpu_devices)
        self._deadline = time.monotonic() + timeout
        code, env, cwd = _child_command(func, cpu_devices)
        # a file, not a pipe: nobody reads the child's stderr while it runs
        self._err = open(str(out_path) + ".stderr", "w+")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", code, str(out_path), *args], cwd=cwd, env=env,
            stdout=subprocess.DEVNULL, stderr=self._err, text=True)

    def result(self):
        import pickle
        import subprocess
        import time

        func, out_path, args, timeout, cpu_devices = self._call
        try:
            self._proc.wait(timeout=max(self._deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        self._err.seek(0)
        err = self._err.read()
        self._err.close()
        if self._proc.returncode == 0:
            with open(out_path, "rb") as f:
                return pickle.load(f)
        if self._proc.returncode > 0:
            raise RuntimeError(f"reference run {func} failed:\n{err[-4000:]}")
        return run_reference_child(func, out_path, *args, timeout=timeout,
                                   cpu_devices=cpu_devices)

    def kill(self):
        """End the child if it still runs (a no-op once `result()` has
        returned)."""
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._err.close()
