"""The frame as one device program: the counterpart of the reference's
`jax.jit` of `_frame_main` with the map donated
(elasticfusion_tpu/engine.py:315).

`FrameRunner` keeps the carried state of a one-device engine (map, pose,
SO(3) history, prediction, fill-in, coverage) and the frame's inputs (depth,
colour, tick, max_time, weight multiplier) in static tensors, and runs the
frame on them: the frame reads them and writes the new carried state back
into them in place, the counterpart of `donate_argnums=(0,)`.  On a CUDA
device the first frame of every static key runs eagerly (the warm-up, as a
`jit` compiles on its first call), then the frame is captured into a
`torch.cuda.CUDAGraph`; every later frame of that key copies its inputs into
the static tensors and replays the graph.  The key is what the reference's
`jit` treats as static: the capacity bucket, `do_compact`, `lost`, and the
fern keyframe DB's capacity (None without loop closure).  All graphs share
one memory pool.  On the CPU every frame runs eagerly on the same static
tensors.  There is no switch: a capture that fails raises.

What the finish of a frame reads (its finish vector, fern views, deformation
node sample, fused count, filtered depth and colour) is copied on the stream
into one of `pipeline_depth + 2` slots right after the frame, so no later
replay overwrites it while the frame is in flight: d frames in flight, the
one being dispatched, and the last finished one, whose node sample the
deformation graph keeps until the next finish.

`frames_run` counts the frames whose Python ran (eager or captured),
`replays_of` the replays of each key and `capture_seconds` the time of each
capture.  A replay calls no kernel wrapper: a profiler trace counts the
launches on the device by kernel name.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of tuples / NamedTuples / dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree)}")


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree)}")


def copy_into(dst, src) -> None:
    """dst <- src leaf by leaf, skipping a leaf that already is its target."""
    for d, s in zip(leaves(dst), leaves(src)):
        if d.data_ptr() != s.data_ptr() or d.stride() != s.stride():
            d.copy_(s)


def _same_shapes(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    out: dict


class FrameRunner:
    """Static tensors, captured graphs and finish slots of one engine."""

    def __init__(self, device: torch.device, pipeline_depth: int):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.graphs: Dict[tuple, _Captured] = {}
        self.state: Optional[dict] = None
        self.slots: List[Optional[dict]] = [None] * (pipeline_depth + 2)
        self._slot = 0
        self.capture_seconds: Dict[tuple, float] = {}
        self.frames_run = 0
        self.replays_of: Dict[tuple, int] = {}

    def load(self, carried: dict, inputs: dict, scalars: Dict[str, float]) -> dict:
        """Copy the carried state and the frame's inputs into the static
        tensors (a carried tensor that already is its static tensor is left
        alone), fill the static 0-d float32 tensors of `scalars` on the
        device, and return them all by name.  New shapes (a grown map) make
        new static tensors, and the graphs captured on the old ones are
        dropped."""
        new = dict(carried, **inputs)
        if self.state is None or not _same_shapes(
                {k: self.state[k] for k in new}, new):
            self.state = tree_map(torch.clone, new)
            self.state.update({k: torch.empty((), dtype=torch.float32, device=self.device)
                               for k in scalars})
            self.graphs.clear()
        else:
            copy_into({k: self.state[k] for k in new}, new)
        for k, v in scalars.items():
            self.state[k].fill_(v)
        return self.state

    def run(self, key: tuple, frame: Callable[[], dict]) -> dict:
        """Run `frame` (which reads and updates `self.state`) for a frame of
        static key `key`; returns its finish slot."""
        entry = self.graphs.get(key)
        if entry is None:
            out = frame()
            self.frames_run += 1
            if self.pool is not None:
                self._capture(key, frame)
        else:
            entry.graph.replay()
            self.replays_of[key] = self.replays_of.get(key, 0) + 1
            out = entry.out
        return self._keep(out)

    def _capture(self, key: tuple, frame: Callable[[], dict]) -> None:
        # graphs of another fern DB capacity read DB tensors that are gone
        for k in [k for k in self.graphs if k[-1] != key[-1]]:
            del self.graphs[k]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = frame()
        torch.cuda.synchronize()
        self.capture_seconds[key] = time.perf_counter() - t0
        self.frames_run += 1
        self.graphs[key] = _Captured(graph, out)

    def _keep(self, out: dict) -> dict:
        slot = self.slots[self._slot]
        if slot is None or not _same_shapes(slot, out):
            slot = tree_map(torch.empty_like, out)
            self.slots[self._slot] = slot
        copy_into(slot, out)
        self._slot = (self._slot + 1) % len(self.slots)
        return slot
