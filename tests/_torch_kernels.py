"""The port's kernel wrapper modules, and a fixture that tells whether a call
reached a kernel.

Every wrapper gets its launcher from `kernel_function`, imported by that name
into its module (`tests/test_torch_sources.py` checks this).  `kernel_calls`
replaces it in every wrapper module by a shim that records the (source,
symbol) asked for and raises `AssertionError`: a CPU tensor that takes the
plain version, or a tensor on another device that the wrapper refuses, leaves
the record empty, and a call that would have launched fails the test on its
own exception."""

import pytest

from elasticfusion_tpu_torch.ops import (bilateral, fuse_window, gram, odometry, pyramid,
                                         splat_resolve)

WRAPPER_MODULES = (gram, odometry, splat_resolve, fuse_window, bilateral, pyramid)


@pytest.fixture
def kernel_calls(monkeypatch):
    """The (source, symbol) of every `kernel_function` call while the test runs."""
    calls = []

    def reached(name, symbol, argtypes):
        calls.append((name, symbol))
        raise AssertionError(f"reached kernel_function({name!r}, {symbol!r})")

    for module in WRAPPER_MODULES:
        monkeypatch.setattr(module, "kernel_function", reached)
    return calls
