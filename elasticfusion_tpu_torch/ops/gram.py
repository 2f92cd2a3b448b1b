"""K1 — Gram accumulation `rows[K,N] → rows @ rowsᵀ [K,K]`, the reduction of
every ICP / RGB / SO(3) normal-equation step.

Replaces the Pallas kernel `gram_outer_pallas`
(elasticfusion_tpu/ops/gram_pallas.py:24-58).  On a CUDA tensor the wrapper
launches the hand-written kernel `csrc/gram.cu` (two stages, no float
atomics, bit-identical from run to run); on a CPU tensor it takes the plain
version below.  The kernel is bound by bytes: `K·N` floats read once.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel_function

MAX_K = 16
_THREADS = 256
_MAX_BLOCKS = 264          # two blocks for each of the card's 132 SMs
# rows, K, N, partials, n_blocks, out, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)


def gram_outer_plain(rows: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Plain version: outer products summed per chunk of columns in float32,
    then over the chunks."""
    K, N = rows.shape
    pad = (-N) % chunk
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    r = rows.reshape(K, -1, chunk)
    return (r[:, None] * r[None, :]).sum(-1).sum(-1)


def _n_blocks(N: int) -> int:
    return max(1, min(-(-N // _THREADS), _MAX_BLOCKS))


def gram_outer(rows: torch.Tensor) -> torch.Tensor:
    """rows [K<=16, N] f32 → rows @ rowsᵀ [K, K] f32."""
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError(f"gram_outer wants a 2-D float32 tensor, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    K, N = rows.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"gram_outer: K={K} outside 1..{MAX_K}")
    if rows.device.type == "cpu":
        return gram_outer_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"gram_outer: unsupported device {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("gram_outer: rows must be contiguous")

    fn = kernel_function("gram", "ef_gram_outer", _ARGTYPES)
    n_blocks = _n_blocks(N)
    partials = torch.empty((n_blocks, K * (K + 1) // 2), dtype=torch.float32,
                           device=rows.device)
    out = torch.empty((K, K), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        code = fn(rows.data_ptr(), K, N, partials.data_ptr(), n_blocks,
                  out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(code, "gram_outer")
    gram_outer.launches += 1
    return out


gram_outer.launches = 0
