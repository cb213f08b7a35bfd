"""Tracing / profiling / runtime-health counters.

The reference's observability is: std::chrono per-callback latency macros
(util.h:13-17, the commented prints in every node), a JACK xrun counter
dumped to ~/rosjack_xrun_count.txt at SIGINT (rosjack.cpp:78-82, 290-300),
and out-of-range warnings per output sample (rosjack.cpp:372-374).

Equivalents here:

* RealTimeMonitor — per-chunk wall-clock vs audio-clock accounting with an
  "xrun" counter (a chunk that took longer than the audio it carries misses
  the real-time deadline), dumpable to a file like the reference's counter;
* xrt_report — audio-seconds/second throughput summary;
* trace_to — a context manager around jax.profiler for on-device traces
  (replaces the commented-out latency prints with a real profiler).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class RealTimeMonitor:
    sample_rate: int
    xruns: int = 0
    chunks: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    worst_ratio: float = 0.0
    _t0: Optional[float] = None

    def start_chunk(self):
        self._t0 = time.perf_counter()

    def end_chunk(self, num_samples: int):
        assert self._t0 is not None, "start_chunk() not called"
        wall = time.perf_counter() - self._t0
        self._t0 = None
        audio = num_samples / self.sample_rate
        self.chunks += 1
        self.audio_seconds += audio
        self.wall_seconds += wall
        ratio = wall / audio if audio > 0 else float("inf")
        self.worst_ratio = max(self.worst_ratio, ratio)
        if wall > audio:
            self.xruns += 1   # missed the real-time deadline

    @property
    def xrt(self) -> float:
        return (self.audio_seconds / self.wall_seconds
                if self.wall_seconds > 0 else float("inf"))

    def report(self) -> dict:
        return {
            "chunks": self.chunks,
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "xrt": round(self.xrt, 1),
            "xruns": self.xruns,
            "worst_chunk_ratio": round(self.worst_ratio, 4),
        }

    def write_xrun_count(self, path: str):
        """The SIGINT dump equivalent (rosjack.cpp:290-300)."""
        with open(path, "w") as f:
            f.write(f"{self.xruns}\n")


def xrt_report(audio_seconds: float, wall_seconds: float) -> str:
    xrt = audio_seconds / wall_seconds if wall_seconds else float("inf")
    return json.dumps({"audio_s": round(audio_seconds, 3),
                       "wall_s": round(wall_seconds, 4),
                       "xrt": round(xrt, 1)})


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a JAX profiler trace (view with TensorBoard / xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def require_gpu():
    """The first JAX device, which must be an NVIDIA GPU: measurement
    entry points fail rather than fall back to the CPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind}); this needs an NVIDIA GPU")
    return dev


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports them
    (a card set below its maximum power runs slower under load, so every
    kept number carries this line)."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]
