"""The committed outputs of the reference runs that the port's tests read in
place of running the reference package (`REFERENCE_OUTPUTS` of the modules
in `_torch_parity.REFERENCE_MODULES`, `tests/data/torch_reference/`):

  - every output has its file and no file lacks its output; each was made
    from the sources as they are now (the reference package, the test
    module, `_torch_parity.py`, the port's synthetic scenes: their sha256)
    and by the installed jax and jaxlib, and holds only numpy arrays and
    plain Python values;
  - (slow, minutes a case) each output made anew, live, in a child
    interpreter equals the committed one: integers, booleans, strings and
    the tick and keyframe lists exactly, floats to rtol 1e-5 / atol 1e-6.

`python tests/_torch_parity.py [name ...]` makes the files anew."""

import jax
import jaxlib
import numpy as np
import pytest

from _torch_parity import (
    REFERENCE_DIR,
    REGENERATE_TIMEOUT,
    reference_output,
    reference_outputs,
    reference_sources,
    run_reference_child,
)

PLAIN = (np.ndarray, np.generic, bool, int, float, str, bytes, type(None))
OUTPUTS = reference_outputs()


def _walk(x, path=""):
    """(path, leaf) of every leaf of nested dicts, lists and tuples."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _walk(v, f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, x


def _compare(got, want, path=""):
    """Assert that two outputs agree; returns whether they are bit-identical."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        return all([_compare(got[k], want[k], f"{path}[{k!r}]") for k in want])
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return all([_compare(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(got, want))])
    if isinstance(want, (np.ndarray, np.generic, float)):
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=path)
            return a.tobytes() == b.tobytes()
        assert np.array_equal(a, b), path
        return True
    assert got == want, path
    return True


def test_reference_outputs_match_the_reference_package():
    assert sorted(p.name for p in REFERENCE_DIR.iterdir()) == sorted(
        f"{name}.pkl.gz" for name in OUTPUTS)
    for name, (module, *_) in OUTPUTS.items():
        record = reference_output(name, record=True)
        now = reference_sources(module)
        changed = sorted(p for p in now.keys() | record["sources"].keys()
                         if now.get(p) != record["sources"].get(p))
        assert not changed, (f"{name}: {changed} changed since its output was made; "
                             f"run `python tests/_torch_parity.py {name}`")
        assert (record["jax"], record["jaxlib"]) == (jax.__version__, jaxlib.__version__), name
        for path, leaf in _walk(record["output"]):
            assert isinstance(leaf, PLAIN), f"{name}{path}: {type(leaf)!r}"


@pytest.mark.slow
@pytest.mark.parametrize("name", list(OUTPUTS))
def test_reference_outputs_are_current(name, tmp_path):
    module, func, args, cpu_devices = OUTPUTS[name]
    got = run_reference_child(f"{module}:{func}", tmp_path / "out.pkl", *args,
                              timeout=REGENERATE_TIMEOUT, cpu_devices=cpu_devices)
    identical = _compare(got, reference_output(name))
    print(f"{name}: {'bit-identical' if identical else 'within tolerance, not bit-identical'}")
