""".klg RGB-D log format reader/writer (own copy of the reference package's
`io/klg.py`) — behavioural equivalent of `RawLogReader`
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

Two decoders.  `NativeKlgLogReader` runs the port's own C++ decoder
(`csrc/klg_decoder.cpp`: zlib, and libjpeg or else the CUDA toolkit's nvJPEG;
the file mmapped and indexed once), built with g++ at its first use;
`open_klg` takes it wherever the host can build it, and says once on stderr
which decoder it uses.  `KlgLogReader`
decodes depth with Python's zlib and a JPEG image with PIL, imported only when
such a frame is met, so a log with raw RGB reads without it.  Rewind is a
frame-offset list instead of a file-pointer stack (RawLogReader.cpp:47-55).
"""

from __future__ import annotations

import io as _io
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class Frame:
    timestamp: int            # microseconds
    depth_mm: np.ndarray      # [H, W] uint16 millimetres
    rgb: np.ndarray           # [H, W, 3] uint8


def _decode_jpeg(buf: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(buf)).convert("RGB"))


# --- the native decoder (csrc/klg_decoder.cpp), built and loaded lazily ------

_NATIVE = None
_NATIVE_WHY = None      # why there is no native decoder, once asked
_ANNOUNCED = False


def _native_lib():
    """The ctypes library of the port's native decoder, or None where this
    host lacks g++, zlib or a JPEG library to build it (`decoder_in_use`
    says which).  A failed build on a host that has them raises."""
    global _NATIVE, _NATIVE_WHY
    if _NATIVE is not None or _NATIVE_WHY is not None:
        return _NATIVE
    import ctypes

    from .._build import host_library, host_toolchain_missing

    missing = host_toolchain_missing("klg_decoder")
    if missing:
        _NATIVE_WHY = missing
        return None
    lib = host_library("klg_decoder")
    lib.ef_klg_open.restype = ctypes.c_void_p
    lib.ef_klg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ef_klg_num_frames.restype = ctypes.c_int
    lib.ef_klg_num_frames.argtypes = [ctypes.c_void_p]
    lib.ef_klg_read.restype = ctypes.c_int
    lib.ef_klg_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ef_klg_close.argtypes = [ctypes.c_void_p]
    _NATIVE = lib
    return lib


def decoder_in_use() -> str:
    """Which decoder `open_klg` takes on this host, in words."""
    if _native_lib() is not None:
        from .._build import host_variant

        return f"native (csrc/klg_decoder.cpp: zlib + {host_variant('klg_decoder')})"
    return (f"Python (zlib; PIL for JPEG colour): no native decoder here, "
            f"{_NATIVE_WHY}")


class NativeKlgLogReader:
    """The C++ decode path (csrc/klg_decoder.cpp): O(1) seek, zlib and a
    JPEG library in native code — the runtime analog of RawLogReader +
    JPEGLoader."""

    def __init__(self, path: str | Path, width: int = 640, height: int = 480):
        import ctypes

        self._ct = ctypes
        lib = _native_lib()
        if lib is None:
            raise RuntimeError(f"no native .klg decoder on this host: {_NATIVE_WHY}")
        self._lib = lib
        self.path = Path(path)
        self.width = width
        self.height = height
        self._h = lib.ef_klg_open(str(self.path).encode(), width, height)
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.num_frames = lib.ef_klg_num_frames(self._h)
        self._i = 0

    def has_more(self) -> bool:
        return self._i < self.num_frames

    def get_next(self) -> Frame:
        if not self.has_more():
            raise EOFError(f"{self.path}: no more frames ({self.num_frames})")
        ct = self._ct
        depth = np.empty((self.height, self.width), np.uint16)
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        ts = ct.c_int64()
        rc = self._lib.ef_klg_read(
            self._h, self._i,
            depth.ctypes.data_as(ct.POINTER(ct.c_uint16)),
            rgb.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            ct.byref(ts),
        )
        if rc != 0:
            raise EOFError(f"{self.path}: decode error {rc} at frame {self._i}")
        self._i += 1
        return Frame(timestamp=ts.value, depth_mm=depth, rgb=rgb)

    def rewind(self) -> None:
        self._i = 0

    def fast_forward(self, frame: int) -> None:
        self._i = min(frame, self.num_frames)

    def __iter__(self) -> Iterator[Frame]:
        while self.has_more():
            yield self.get_next()

    def close(self) -> None:
        if self._h:
            self._lib.ef_klg_close(self._h)
            self._h = None


def open_klg(path: str | Path, width: int = 640, height: int = 480):
    """Open a .klg with the native decoder where this host can build it,
    else with the Python one; the first call says on stderr which."""
    global _ANNOUNCED
    native = _native_lib() is not None
    if not _ANNOUNCED:
        import sys

        sys.stderr.write(f"klg: {decoder_in_use()}\n")
        _ANNOUNCED = True
    if native:
        return NativeKlgLogReader(path, width, height)
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


def _encode_jpeg(rgb: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_klg(
    path: str | Path,
    frames: List[Tuple[int, np.ndarray, np.ndarray]],
    compress_depth: bool = True,
    jpeg_quality: Optional[int] = None,
) -> None:
    """Write a .klg file from (timestamp_us, depth_mm u16 [H,W], rgb u8
    [H,W,3]) tuples.  RGB is stored raw, or as JPEG at `jpeg_quality` (as
    the original Logger writes it; needs PIL)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(frames)))
        for ts, depth, rgb in frames:
            depth = np.ascontiguousarray(depth, np.uint16)
            rgb = np.ascontiguousarray(rgb, np.uint8)
            dbuf = zlib.compress(depth.tobytes()) if compress_depth else depth.tobytes()
            ibuf = (rgb.tobytes() if jpeg_quality is None
                    else _encode_jpeg(rgb, jpeg_quality))
            f.write(struct.pack("<qii", int(ts), len(dbuf), len(ibuf)))
            f.write(dbuf)
            f.write(ibuf)
