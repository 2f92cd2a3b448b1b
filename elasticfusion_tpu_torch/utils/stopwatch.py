"""Per-stage timing — equivalent of the reference `Stopwatch` singleton
(Core/Utils/Stopwatch.h).

TICK/TOCK macros become tick()/tock() calls keeping millisecond spans; the
`-fs` frameskip controller in tools/run_slam.py reads timings["Run"] exactly
like MainController.cpp:249-251, so this is load-bearing, not just telemetry.
`send_all()` emits the reference's UDP packet format
([int32 size][uint64 signature][type u8, name\\0, float ms]*,
Stopwatch.h:156-201) so the external StopwatchViewer keeps working.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Dict


class Stopwatch:
    SEND_INTERVAL_S = 10.0

    def __init__(self, signature: int = 12431231, udp: bool = False,
                 addr=("127.0.0.1", 45454)):
        self.timings: Dict[str, float] = {}
        self._starts: Dict[str, float] = {}
        self.signature = signature
        self.udp = udp
        self.addr = addr
        self._sock = None
        self._last_send = 0.0

    def tick(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def tock(self, name: str) -> None:
        t0 = self._starts.pop(name, None)
        if t0 is not None:
            self.timings[name] = (time.perf_counter() - t0) * 1000.0
        if self.udp:
            self._maybe_send()

    def measure(self, name: str):
        sw = self

        class _Ctx:
            def __enter__(self):
                sw.tick(name)

            def __exit__(self, *a):
                sw.tock(name)

        return _Ctx()

    def pack(self) -> bytes:
        """Serialize all timings in the reference's UDP wire format."""
        body = b""
        for name, ms in self.timings.items():
            body += struct.pack("<B", 0) + name.encode() + b"\0" + struct.pack("<f", ms)
        payload = struct.pack("<Q", self.signature) + body
        return struct.pack("<i", 4 + len(payload)) + payload

    def _maybe_send(self) -> None:
        now = time.monotonic()
        if now - self._last_send < self.SEND_INTERVAL_S:
            return
        self._last_send = now
        if self._sock is None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self._sock.sendto(self.pack(), self.addr)
        except OSError:
            pass
