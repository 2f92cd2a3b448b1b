"""Device selection: the card unless the caller asks for something else."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[torch.device, str]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA card and raises when there is none; the CPU is
    used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


# Device→host reads made by the port's control flow (each one synchronizes
# the stream).  `read_back` is the only place they happen, so the counter
# tells how many host syncs a frame costs.
host_reads = 0


def read_back(t: torch.Tensor):
    """Tensor → numpy array on the host; counts the read when the tensor
    lives on a card."""
    global host_reads
    if t.device.type != "cpu":
        host_reads += 1
    return t.detach().cpu().numpy()
