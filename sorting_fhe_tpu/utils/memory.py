"""Memory monitoring: host RSS sampling thread + device memory stats.

Rebuild of the reference's tests/memory_tracker.{h,cpp}: a background
thread samples /proc/self/status VmRSS every `interval` seconds, tracking
the peak and the running average (memory_tracker.cpp:8-98 samples at
500 ms with a CAS-updated peak).  On an accelerator the host RSS is not
the story, so the monitor also snapshots the device's memory_stats()
(bytes_in_use / peak_bytes_in_use).

Usage (the reference's idle/setup/peak protocol,
tests/DirectSortTest.cpp:125-185):

    mon = MemoryMonitor().start()          # idle baseline recorded
    ... build context/keys ...
    mon.mark("setup")
    ... sort ...
    mon.stop()
    report = mon.report()                  # idle/setup/peak/avg + overheads
"""

from __future__ import annotations

import threading
import time


def host_rss_gb() -> float:
    """VmRSS of this process in GB (Linux; 0.0 where unsupported)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return 0.0


def device_mem_bytes(device=None) -> dict[str, int]:
    """bytes_in_use / peak_bytes_in_use of `device` (default: jax device 0).

    A CPU device has no device memory of its own and gives {}; on an
    accelerator a missing reading is an error, never an empty record."""
    if device is None:
        import jax
        device = jax.devices()[0]
    if device.platform == "cpu":
        return {}
    st = device.memory_stats() or {}
    missing = [k for k in ("bytes_in_use", "peak_bytes_in_use")
               if k not in st]
    if missing:
        raise RuntimeError(
            f"{device.device_kind}: memory_stats() lacks {missing}")
    return {"bytes_in_use": int(st["bytes_in_use"]),
            "peak_bytes_in_use": int(st["peak_bytes_in_use"])}


def device_mem_gb(device=None) -> dict[str, float]:
    """device_mem_bytes in GiB, under the MemoryMonitor report's keys."""
    st = device_mem_bytes(device)
    if not st:
        return {}
    return {"in_use_gb": st["bytes_in_use"] / 2 ** 30,
            "peak_gb": st["peak_bytes_in_use"] / 2 ** 30}


class MemoryMonitor:
    """Background RSS sampler (memory_tracker.cpp:8-98 equivalent)."""

    def __init__(self, interval: float = 0.5):
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.idle_gb = 0.0
        self.peak_gb = 0.0
        self._sum = 0.0
        self._count = 0
        self.marks: dict[str, float] = {}

    def _sample(self):
        rss = host_rss_gb()
        if rss > self.peak_gb:
            self.peak_gb = rss
        self._sum += rss
        self._count += 1

    def _run(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval)

    def start(self) -> "MemoryMonitor":
        self.idle_gb = host_rss_gb()
        self.peak_gb = self.idle_gb
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def mark(self, name: str):
        """Record the current RSS under a label (e.g. 'setup')."""
        self._sample()
        self.marks[name] = host_rss_gb()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._sample()

    @property
    def average_gb(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def report(self) -> dict[str, float]:
        """idle/setup/peak/average + derived overheads, the shape the
        reference prints (DirectSortTest.cpp:172-185)."""
        setup = self.marks.get("setup", self.idle_gb)
        out = {
            "idle_gb": self.idle_gb,
            "setup_gb": setup,
            "peak_gb": self.peak_gb,
            "average_gb": self.average_gb,
            "crypto_overhead_gb": max(0.0, setup - self.idle_gb),
            "sorting_overhead_gb": max(0.0, self.peak_gb - setup),
        }
        out.update(device_mem_gb())
        return out
