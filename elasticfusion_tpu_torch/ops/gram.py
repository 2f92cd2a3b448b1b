"""K1 — Gram accumulation `rows[K,N] → rows @ rowsᵀ [K,K]`, the reduction of
a normal-equation step whose rows are in memory (the SO(3) pre-alignment; the
ICP / RGB steps of `ops/odometry.py` build their rows inside their own
kernels).

Replaces the Pallas kernel `gram_outer_pallas`
(elasticfusion_tpu/ops/gram_pallas.py:24-58).  On a CUDA tensor the wrapper
launches the hand-written kernel `csrc/gram.cu` (one launch: per-block
partials, summed in block order by the block that ends last; no float
atomics, bit-identical from run to run); on a CPU tensor it takes the plain
version below.  The kernel is bound by bytes: `K·N` floats read once.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .._build import check_launch, kernel_function

MAX_K = 16
_THREADS = 256             # EF_RED_THREADS of csrc/gram_reduce.cuh
_MAX_BLOCKS = 264          # two blocks for each of the card's 132 SMs
_COLUMNS_PER_THREAD = 8    # two 16-byte loads of each row
# rows, K, N, partials, ticket, n_blocks, out, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)

_scratch: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def reduction_grid(n_items: int, items_per_thread: int) -> int:
    """Blocks of a single-launch reduction over `n_items`: enough for
    `items_per_thread` each, at most two per SM (every block costs the last
    one a partial to add)."""
    return max(1, min(-(-n_items // (_THREADS * items_per_thread)), _MAX_BLOCKS))


def reduction_scratch(launcher: str, device: torch.device,
                      floats_per_block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partials, ticket) of one launcher on one card, allocated once: the
    per-block partial sums and the zeroed integer ticket counter that
    `csrc/gram_reduce.cuh` needs.  Launches of one launcher share them, so
    they must follow each other on one stream — the port launches on the
    current stream only."""
    key = (launcher, device.index)
    if key not in _scratch:
        _scratch[key] = (
            torch.empty((_MAX_BLOCKS, floats_per_block), dtype=torch.float32,
                        device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
        )
    return _scratch[key]


def gram_outer_plain(rows: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Plain version: outer products summed per chunk of columns in float32,
    then over the chunks."""
    K, N = rows.shape
    pad = (-N) % chunk
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    r = rows.reshape(K, -1, chunk)
    return (r[:, None] * r[None, :]).sum(-1).sum(-1)


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
    partials, ticket = reduction_scratch("gram_outer", rows.device,
                                         MAX_K * (MAX_K + 1) // 2)
    out = torch.empty((K, K), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        code = fn(rows.data_ptr(), K, N, partials.data_ptr(), ticket.data_ptr(),
                  reduction_grid(N, _COLUMNS_PER_THREAD), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    check_launch(code, "gram_outer")
    return out
