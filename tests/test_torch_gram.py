"""K1 parity on the CPU: the port's plain Gram accumulation against the
reference Pallas kernel in interpret mode and against a float64 product.

The CUDA kernel itself cannot run here; `chip_smoke.py` holds it against the
plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nn, tt
from _torch_kernels import kernel_calls  # noqa: F401
from elasticfusion_tpu.ops.gram_pallas import gram_outer_pallas
from elasticfusion_tpu_torch.ops.gram import gram_outer, gram_outer_plain


def _rows(K, N, seed):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((K, N)).astype(np.float32)
    rows[:, rng.integers(0, N, N // 4)] = 0.0     # masked pixels are zero rows
    return rows


# N is no multiple of any block (4096, 128, 256); sums of <= 19211 float32
# products against float64: rtol 1e-5 of the largest entry
# (each Pallas shape is one more compile, so two of the four cases skip it)
@pytest.mark.parametrize("K,N,with_pallas", [
    (7, 19211, True), (4, 4801, True), (7, 1237, False), (4, 19211, False)])
def test_gram_plain_vs_pallas_and_f64(K, N, with_pallas):
    rows = _rows(K, N, seed=K * 1000 + N)
    ref64 = rows.astype(np.float64) @ rows.astype(np.float64).T
    scale = np.abs(ref64).max()
    plain = nn(gram_outer_plain(tt(rows)))
    wrapped = nn(gram_outer(tt(rows)))          # CPU tensor → plain version
    np.testing.assert_allclose(plain, ref64, rtol=0, atol=1e-5 * scale)
    if with_pallas:
        pallas = nn(gram_outer_pallas(jnp.asarray(rows), interpret=True))
        np.testing.assert_allclose(pallas, ref64, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(plain, pallas, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain, plain.T, rtol=0, atol=1e-6 * scale)


def test_gram_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        gram_outer(torch.zeros((17, 64)))                  # K > 16
    with pytest.raises(ValueError):
        gram_outer(torch.zeros((7, 64), dtype=torch.float64))
    with pytest.raises(ValueError):
        gram_outer(torch.zeros((7,)))


def test_gram_outer_on_the_cpu_reaches_no_kernel(kernel_calls):
    gram_outer(tt(_rows(7, 300, 1)))
    assert kernel_calls == []


def _sum_in_block_order(partials):
    """The former second stage: entry t = partials[0][t] + partials[1][t] + ...
    in float32, block after block."""
    s = np.zeros(partials.shape[1], np.float32)
    for row in partials:
        s = (s + row).astype(np.float32)
    return s


def _sum_by_last_block(partials, stage_floats=8192):
    """The single-launch finish of csrc/gram_reduce.cuh: the last block copies
    the partials into shared memory `stage_floats // T` blocks at a time and
    thread t goes on adding its entries from there, block after block."""
    n_blocks, T = partials.shape
    chunk = stage_floats // T
    s = np.zeros(T, np.float32)
    for first in range(0, n_blocks, chunk):
        stage = partials[first:first + chunk].reshape(-1).copy()
        for b in range(min(chunk, n_blocks - first)):
            s = (s + stage[b * T:(b + 1) * T]).astype(np.float32)
    return s


# T = K(K+1)/2 (+1 for the ICP step's count); 8192 // 136 = 60 blocks per
# round, so K = 16 takes five rounds for 264 blocks and a ragged last one
@pytest.mark.parametrize("T,n_blocks", [(136, 264), (29, 264), (28, 75), (10, 19), (2, 1)])
def test_last_block_sum_equals_two_stage_order(T, n_blocks):
    rng = np.random.default_rng(T * 1000 + n_blocks)
    partials = (rng.standard_normal((n_blocks, T)) * 1e3).astype(np.float32)
    got = _sum_by_last_block(partials)
    np.testing.assert_array_equal(got, _sum_in_block_order(partials))
    ref64 = partials.astype(np.float64).sum(0)
    np.testing.assert_allclose(got, ref64, rtol=0, atol=1e-5 * np.abs(partials).sum(0).max())
