"""Readers and writers of the port: `.klg` logs, TUM dataset directories,
`.freiburg` trajectories, PLY maps, ground-truth poses.  Pure numpy apart
from `save_ply`'s one read of a torch map."""

from .groundtruth import GroundTruthOdometry
from .klg import Frame, KlgLogReader, NativeKlgLogReader, open_klg, write_klg
from .ply import load_ply, save_ply
from .trajectory import ate_rmse, horn_align, read_freiburg, write_freiburg
from .tum import TumLogReader, associate, read_groundtruth

__all__ = [
    "Frame",
    "GroundTruthOdometry",
    "KlgLogReader",
    "NativeKlgLogReader",
    "open_klg",
    "write_klg",
    "TumLogReader",
    "associate",
    "read_groundtruth",
    "write_freiburg",
    "read_freiburg",
    "ate_rmse",
    "horn_align",
    "save_ply",
    "load_ply",
]
