"""Live camera layer (own copy of the reference package's `tools/camera.py`)
— equivalent of `LiveLogReader` + `CameraInterface` + `ThreadMutexObject`
(Tools/LiveLogReader.{h,cpp}, CameraInterface.h:17-19, ThreadMutexObject.h
of the original system).

`CameraInterface` is a protocol; hardware backends register frames into the
same thread-safe ring buffer, and `LiveLogReader` presents the standard
LogReader surface to the engine.  `SyntheticCamera` is the in-repo backend
(tests, demos); OpenNI2/RealSense backends plug in by implementing
`CameraInterface`."""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol

from ..io.klg import Frame

RING_SIZE = 10  # CameraInterface.h:17-19


class CameraInterface(Protocol):
    width: int
    height: int

    def start(self, ring: "FrameRingBuffer") -> None: ...
    def stop(self) -> None: ...


class FrameRingBuffer:
    """10-slot frame ring with condvar hand-off (ThreadMutexObject.h:28-128
    semantics: latest-index counter, blocking wait for a newer frame)."""

    def __init__(self, size: int = RING_SIZE):
        self._slots: list[Optional[Frame]] = [None] * size
        self._latest = -1
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.dropped = 0

    def push(self, frame: Frame) -> None:
        with self._cv:
            self._latest += 1
            self._slots[self._latest % len(self._slots)] = frame
            self._cv.notify_all()

    def latest_index(self) -> int:
        with self._lock:
            return self._latest

    def wait_for(self, after_index: int, timeout: float = 1.0) -> Optional[Frame]:
        """Block until a frame newer than `after_index` arrives."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._latest <= after_index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)
            if self._latest - after_index > 1:
                self.dropped += self._latest - after_index - 1
            return self._slots[self._latest % len(self._slots)]


class SyntheticCamera:
    """A camera backend rendering a synthetic scene on a worker thread at a
    fixed rate — stands in for OpenNI2Interface/RealSenseInterface."""

    def __init__(self, cam_cfg, fps: float = 30.0, n_frames: int = 0,
                 motion=lambda i: (0.01 * i, 0.0)):
        from ..utils.synthetic import make_scene

        self.width = cam_cfg.width
        self.height = cam_cfg.height
        self._cfg = cam_cfg
        self._fps = fps
        self._n = n_frames  # 0 = endless
        self._motion = motion
        self._scene = make_scene(n_side=500)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self, ring: FrameRingBuffer) -> None:
        from ..utils.synthetic import pose_from_xyzrpy, render_frame

        def worker():
            i = 0
            while not self._stop.is_set() and (self._n == 0 or i < self._n):
                x, yaw = self._motion(i)
                T = pose_from_xyzrpy(x=x, yaw=yaw)
                depth, rgb = render_frame(self._scene[0], self._scene[1], T, self._cfg)
                ring.push(Frame(timestamp=int(i / self._fps * 1e6),
                                depth_mm=depth, rgb=rgb))
                i += 1
                time.sleep(1.0 / self._fps)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class LiveLogReader:
    """LogReader surface over a live camera (LiveLogReader.{h,cpp}): always
    has_more; get_next blocks for the next ring frame."""

    def __init__(self, camera: CameraInterface):
        self.camera = camera
        self.ring = FrameRingBuffer()
        self._last = -1
        self.num_frames = 1 << 30
        camera.start(self.ring)

    def has_more(self) -> bool:
        return True

    def get_next(self, timeout: float = 5.0) -> Frame:
        f = self.ring.wait_for(self._last, timeout)
        if f is None:
            raise TimeoutError("camera produced no frame")
        self._last = self.ring.latest_index()
        return f

    def close(self) -> None:
        self.camera.stop()
