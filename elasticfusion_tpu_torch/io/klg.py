""".klg RGB-D log format reader/writer (own copy of the reference package's
`io/klg.py`, Python path only) — behavioural equivalent of `RawLogReader`
(Tools/RawLogReader.{h,cpp} of the original system).

Format (RawLogReader.cpp:29, 64-97):
  int32 numFrames
  per frame:
    int64 timestamp (microseconds)
    int32 depthSize, int32 imageSize
    depthSize bytes:  zlib-compressed uint16[H*W] depth in mm if
                      depthSize != H*W*2, else raw
    imageSize bytes:  JPEG RGB if imageSize != H*W*3, else raw u8[H,W,3];
                      0 -> no image (black frame)

Depth is decoded with Python's zlib; a JPEG image needs PIL, imported only
when such a frame is met, so a log with raw RGB reads without it.  Rewind is
a frame-offset list instead of a file-pointer stack (RawLogReader.cpp:47-55).
"""

from __future__ import annotations

import io as _io
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np


@dataclass
class Frame:
    timestamp: int            # microseconds
    depth_mm: np.ndarray      # [H, W] uint16 millimetres
    rgb: np.ndarray           # [H, W, 3] uint8


def _decode_jpeg(buf: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(buf)).convert("RGB"))


def open_klg(path: str | Path, width: int = 640, height: int = 480):
    """Open a .klg for sequential reading (the Python decoder)."""
    return KlgLogReader(path, width, height)


class KlgLogReader:
    """Sequential .klg reader with the LogReader surface
    (LogReader.h:31-89: getNext/hasMore/rewind/fastForward/getNumFrames)."""

    def __init__(self, path: str | Path, width: int = 640, height: int = 480):
        self.path = Path(path)
        self.width = width
        self.height = height
        self._f = open(self.path, "rb")
        (self.num_frames,) = struct.unpack("<i", self._f.read(4))
        self._offsets: List[int] = [self._f.tell()]
        self._i = 0

    # -- LogReader surface ---------------------------------------------------
    def has_more(self) -> bool:
        return self._i < self.num_frames

    def get_next(self) -> Frame:
        if not self.has_more():
            raise EOFError(f"{self.path}: no more frames ({self.num_frames})")
        hdr = self._f.read(16)
        if len(hdr) != 16:
            raise EOFError(f"{self.path}: truncated header at frame {self._i}")
        ts, depth_size, image_size = struct.unpack("<qii", hdr)
        depth_buf = self._f.read(depth_size)
        image_buf = self._f.read(image_size)
        if len(depth_buf) != depth_size or len(image_buf) != image_size:
            raise EOFError(f"{self.path}: truncated payload at frame {self._i}")

        n_px = self.width * self.height
        if depth_size == n_px * 2:
            depth = np.frombuffer(depth_buf, np.uint16)
        else:
            depth = np.frombuffer(zlib.decompress(depth_buf), np.uint16)
        depth = depth.reshape(self.height, self.width)

        if image_size == n_px * 3:
            rgb = np.frombuffer(image_buf, np.uint8).reshape(self.height, self.width, 3)
        elif image_size > 0:
            rgb = _decode_jpeg(image_buf)
        else:
            rgb = np.zeros((self.height, self.width, 3), np.uint8)

        self._i += 1
        if self._i == len(self._offsets):
            self._offsets.append(self._f.tell())
        return Frame(timestamp=ts, depth_mm=depth, rgb=rgb)

    def rewind(self) -> None:
        self._i = 0
        self._f.seek(self._offsets[0])

    def fast_forward(self, frame: int) -> None:
        """Skip to a frame index without decoding (LogReader::fastForward)."""
        if frame <= self._i:
            self.rewind()
        while self._i < min(frame, self.num_frames):
            hdr = self._f.read(16)
            _, ds, i_s = struct.unpack("<qii", hdr)
            self._f.seek(ds + i_s, 1)
            self._i += 1
            if self._i == len(self._offsets):
                self._offsets.append(self._f.tell())

    def __iter__(self) -> Iterator[Frame]:
        while self.has_more():
            yield self.get_next()

    def close(self) -> None:
        self._f.close()


def write_klg(
    path: str | Path,
    frames: List[Tuple[int, np.ndarray, np.ndarray]],
    compress_depth: bool = True,
) -> None:
    """Write a .klg file from (timestamp_us, depth_mm u16 [H,W], rgb u8
    [H,W,3]) tuples.  RGB is stored raw (readers accept raw or JPEG)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(frames)))
        for ts, depth, rgb in frames:
            depth = np.ascontiguousarray(depth, np.uint16)
            rgb = np.ascontiguousarray(rgb, np.uint8)
            dbuf = zlib.compress(depth.tobytes()) if compress_depth else depth.tobytes()
            ibuf = rgb.tobytes()
            f.write(struct.pack("<qii", int(ts), len(dbuf), len(ibuf)))
            f.write(dbuf)
            f.write(ibuf)
