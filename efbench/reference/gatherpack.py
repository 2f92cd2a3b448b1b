"""The u16 fixed-point row-gather — counterpart of `pack_fx16` / `gather_fx16`
in the reference package's `ops/gatherpack.py`.

The reference packs channels into one table before a gather because that is
what its compiler gathers fast; its exact (float32) packed gathers are a
plain indexed gather here, which is all the port needs of them.  What
changes results is the fixed-point form: `pack_fx16` quantizes each channel to u16
codes over its own [min, max], two codes to a 32-bit word, and `gather_fx16`
decodes `code * scale + lo` with one rounding, as the fused multiply-add the
reference's compiler makes of it.  `clean(fx16_patch=True)` compares the decoded
values, so the codes must be the reference's bit for bit: the scale is
`(hi - lo) * (1/65535)` as the reference's compiler folds the constant
divisor, `torch.round` rounds half to even like `jnp.round`, and the words
are int32 tensors built with integer operations (never a float bitcast,
which could canonicalise a NaN-shaped word).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .surfels import recip32

_U16_MAX = 65535.0


def pack_fx16(channels: Sequence[torch.Tensor]
              ) -> Tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack channels two to a 32-bit word as u16 fixed point over each
    channel's own range: `q = round((c - lo) / scale)`, `scale = (hi - lo) /
    65535`.  Decode error <= scale / 2.  Returns ("fx16", words
    `[ceil(C/2), T]` int32, los `[C]`, scales `[C]`)."""
    qs, los, scales = [], [], []
    for c in channels:
        c = c.reshape(-1).to(torch.float32)
        lo, hi = torch.min(c), torch.max(c)
        scale = torch.clamp(hi - lo, min=1e-20) * recip32(_U16_MAX)
        q = torch.clamp(torch.round((c - lo) / scale), 0.0, _U16_MAX)
        qs.append(q.to(torch.int64))
        los.append(lo)
        scales.append(scale)
    if len(qs) % 2:
        qs.append(torch.zeros_like(qs[0]))
    words = []
    for i in range(len(qs) // 2):
        w = qs[2 * i] | (qs[2 * i + 1] << 16)             # u32 value in int64
        words.append(torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32))
    return "fx16", torch.stack(words), torch.stack(los), torch.stack(scales)


def gather_fx16(packed, flat_idx: torch.Tensor) -> List[torch.Tensor]:
    """Gather and decode a `pack_fx16` table at [N] indices (caller clips)."""
    _tag, words, los, scales = packed
    rows = words[:, flat_idx].to(torch.int64) & 0xFFFFFFFF
    out = []
    for i in range(los.shape[0]):
        w = rows[i // 2]
        q = (w & 0xFFFF) if i % 2 == 0 else (w >> 16)
        # one rounding of code * scale + lo, as the fused multiply-add the
        # reference's compiler makes of it (exact in float64: a 16-bit code
        # times a 24-bit scale needs 40 bits)
        out.append((q.to(torch.float64) * scales[i].double() + los[i].double())
                   .to(torch.float32))
    return out
