"""Frozen copy of the port's `ops/gram.py` plain path: the Gram
accumulation `rows[K,N] -> rows @ rows^T [K,K]` summed per chunk of columns
in float32, then over the chunks.  No kernel: the reference runs this on any
device."""

from __future__ import annotations

import torch

MAX_K = 16


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
    """rows [K<=16, N] f32 -> rows @ rows^T [K, K] f32."""
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError(f"gram_outer wants a 2-D float32 tensor, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if not 1 <= rows.shape[0] <= MAX_K:
        raise ValueError(f"gram_outer: K={rows.shape[0]} outside 1..{MAX_K}")
    return gram_outer_plain(rows)
