"""State carried across packages: numpy ⇄ the port's NamedTuples of tensors.

The system has no weights; the surfel map, the carried prediction, the
deformation graph and the fern keyframe DB are its state.  Every `*_from_numpy` takes a dict of arrays keyed by the reference
package's NamedTuple field names (or any object with `_asdict()`, after
`np.asarray` on its fields), so both packages can be started from the same
state; every `*_to_numpy` gives such a dict back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .config import CameraConfig, EngineConfig
from .deformation import GraphState
from .ferns import FernFrame, Ferns
from .ops.splat import IndexPrediction, Prediction
from .surfels import SurfelMap

_INT_FIELDS = {"count": torch.int32, "index": torch.int32,
               "n_nodes": torch.int32, "nbr": torch.int64}


def config_from_dict(d: Mapping[str, Any]) -> EngineConfig:
    """One dict of overrides → `EngineConfig` (`camera` may be a dict of
    `CameraConfig` fields).  The reference package's config has the same
    field names, so the same dict builds both."""
    kw = dict(d)
    cam = kw.get("camera")
    if isinstance(cam, Mapping):
        kw["camera"] = CameraConfig(**cam)
    elif cam is not None and not isinstance(cam, CameraConfig):
        kw["camera"] = CameraConfig(**dataclasses.asdict(cam))
    for k, v in kw.items():
        if isinstance(v, list):
            kw[k] = tuple(v)
    return EngineConfig(**kw)


def _as_dict(src) -> Dict[str, Any]:
    return dict(src._asdict()) if hasattr(src, "_asdict") else dict(src)


def _from_numpy(cls, src, device: DeviceLike):
    dev = resolve_device(device)
    d = _as_dict(src)
    out = {}
    for f in cls._fields:
        dtype = _INT_FIELDS.get(f, torch.float32)
        out[f] = torch.as_tensor(np.array(d[f]), device=dev).to(dtype).contiguous()
    return cls(**out)


def _to_numpy(t: NamedTuple) -> Dict[str, np.ndarray]:
    return {f: getattr(t, f).detach().cpu().numpy() for f in t._fields}


def surfel_map_from_numpy(src, device: DeviceLike = None) -> SurfelMap:
    return _from_numpy(SurfelMap, src, device)


def surfel_map_to_numpy(m: SurfelMap) -> Dict[str, np.ndarray]:
    return _to_numpy(m)


def index_prediction_from_numpy(src, device: DeviceLike = None) -> IndexPrediction:
    return _from_numpy(IndexPrediction, src, device)


def index_prediction_to_numpy(p: IndexPrediction) -> Dict[str, np.ndarray]:
    return _to_numpy(p)


def prediction_from_numpy(src, device: DeviceLike = None) -> Prediction:
    return _from_numpy(Prediction, src, device)


def prediction_to_numpy(p: Prediction) -> Dict[str, np.ndarray]:
    return _to_numpy(p)


class EngineState(NamedTuple):
    """What one frame hands to the next (the arguments `slam_step` carries)."""

    T: torch.Tensor                 # (4,4) f32 world←camera
    so3_hist: torch.Tensor          # coarsest-level intensity of the last frame
    pred: Prediction                # end-of-frame prediction
    fill: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # vertex, normal, image


def engine_state_from_numpy(src: Mapping[str, Any],
                            device: DeviceLike = None) -> EngineState:
    """`src`: {"T", "so3_hist", "pred": Prediction fields, "fill": 3 arrays}."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.array(a), device=dev).to(torch.float32).contiguous()
    return EngineState(
        T=f32(src["T"]), so3_hist=f32(src["so3_hist"]),
        pred=prediction_from_numpy(src["pred"], dev),
        fill=tuple(f32(a) for a in src["fill"]),
    )


def engine_state_to_numpy(s: EngineState) -> Dict[str, Any]:
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {
        "T": host(s.T), "so3_hist": host(s.so3_hist),
        "pred": prediction_to_numpy(s.pred),
        "fill": tuple(host(t) for t in s.fill),
    }


def graph_state_from_numpy(src, device: DeviceLike = None) -> GraphState:
    """A deformation graph from the reference package's `GraphState` fields
    (`nbr` becomes int64, `n_nodes` a 0-d int32)."""
    return _from_numpy(GraphState, src, device)


def graph_state_to_numpy(g: GraphState) -> Dict[str, np.ndarray]:
    return _to_numpy(g)


def load_fern_db(ferns: Ferns, frames: Iterable[Any]) -> None:
    """Append keyframes to a `Ferns` DB (host records and device code rows).
    Each item holds the reference package's `FernFrame` fields (codes, good
    codes, pose, time, decimated views), as a dict or as that dataclass."""
    for fr in frames:
        d = dataclasses.asdict(fr) if dataclasses.is_dataclass(fr) else dict(fr)
        f = FernFrame(
            id=len(ferns.frames),
            codes=np.asarray(d["codes"], np.uint8).reshape(-1),
            good_codes=int(d["good_codes"]),
            T_wc=np.asarray(d["T_wc"], np.float64).copy(),
            src_time=int(d["src_time"]),
            rgb=np.asarray(d["rgb"], np.uint8),
            verts=np.asarray(d["verts"], np.float32),
            norms=np.asarray(d["norms"], np.float32),
        )
        ferns.frames.append(f)
        ferns._db_upload(f.id, f.codes, f.good_codes, f.src_time)
