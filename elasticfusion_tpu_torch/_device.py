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


# Device→host reads made by the port's control flow (each one waits for the
# device).  `read_back` and `PendingRead.get` are the only places they
# happen, so `host_reads` tells how many host waits a frame costs on a card;
# `read_calls` counts the same calls on any device (on the CPU they cost
# nothing, but the count shows the structure).
host_reads = 0
read_calls = 0


def _count(t: torch.Tensor) -> None:
    global host_reads, read_calls
    read_calls += 1
    if t.device.type != "cpu":
        host_reads += 1


def read_back(t: torch.Tensor):
    """Tensor → numpy array on the host; counts the read."""
    _count(t)
    return t.detach().cpu().numpy()


class PendingRead:
    """A device→host copy started now and read later: on a card the tensor
    is copied on the current stream into pinned host memory and an event is
    recorded behind it, so `get` waits for that copy alone and not for the
    work queued after it (what lets a pipelined frame's finish overlap later
    frames).  On the CPU `get` reads the tensor as it is then."""

    def __init__(self, t: torch.Tensor):
        self._src = t
        self._host = self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self):
        _count(self._src)
        if self._event is None:
            return self._src.detach().cpu().numpy()
        self._event.synchronize()
        return self._host.numpy()
