"""Tracing / profiling utilities (port of ``formula_vad_tpu/utils/
profiling.py``).

* ``span`` — a context-manager wall-clock timer tree, collected into a
  report (host-side stages: decode, device step, eval).
* ``trace`` — wraps ``torch.profiler.profile`` (CPU and, where a card is
  visible, CUDA activities) and writes a Chrome trace into a directory,
  viewable in Perfetto or chrome://tracing.
* ``realtime_factor`` — the framework's headline derived metric.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch


class Profiler:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["profile:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"  {name:30s} {self.totals[name]*1000:9.1f} ms  (n={self.counts[name]})"
            )
        return "\n".join(lines)


PROFILER = Profiler()
span = PROFILER.span


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace of the block into
    ``log_dir/trace-<pid>.json`` (no-op when None)."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))


def realtime_factor(audio_seconds: float, wall_seconds: float) -> float:
    return audio_seconds / wall_seconds if wall_seconds > 0 else float("inf")
