"""Latency/throughput instrumentation.

The reference's only profiling is an EMA of the audio-pump wall time
(ims/audio.py:60-61,101-103) and ad-hoc drift prints
(livenote_live.py:203-206).  Here: per-insert latency percentiles, a
real-time-factor counter, and the same EMA load metric.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np


class EMACpuLoad:
    """Exponential moving average of per-update wall time, α=0.9 parity with
    ims/audio.py:101-103; ``load`` is in milliseconds like get_cpu_load."""

    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self.cpu_time = 0.0

    def update(self, dt_seconds: float) -> None:
        self.cpu_time = self.alpha * self.cpu_time + (1 - self.alpha) * dt_seconds

    @property
    def load_ms(self) -> float:
        return 1000.0 * self.cpu_time


class LatencyRecorder:
    """Collects per-event wall times; reports percentiles and RTF."""

    def __init__(self, audio_seconds_per_event: float):
        self.audio_seconds_per_event = audio_seconds_per_event
        self.samples: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def time(self, fn, *args, **kwargs):
        self.start()
        out = fn(*args, **kwargs)
        self.stop()
        return out

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        total = float(arr.sum())
        audio = len(arr) * self.audio_seconds_per_event
        return {
            "count": len(arr),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "mean_ms": float(arr.mean() * 1e3),
            "wall_s": total,
            "audio_s": audio,
            "rtf": audio / total if total > 0 else float("inf"),
        }


def trace(log_dir: str):
    """Context manager wrapping ``torch.profiler.profile`` — records host and
    (when a card is present) CUDA activity and writes a Chrome trace
    (``trace.json``, viewable in Perfetto) into ``log_dir`` on exit."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    def _write(prof):
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    return torch.profiler.profile(activities=activities, on_trace_ready=_write)
