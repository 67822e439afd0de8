"""Profiling and tracing utilities.

Counterpart of humanoid_mujoco_tpu/utils/profiling.py. The reference
times planner stages (noise, rollout, model and cost derivatives,
backward pass, policy update) with wall-clock segment timers and atomic
accumulation, surfaced as GUI plots (sampling/planner.cc:162-207,
agent.cc:297-300). Here:

  * StageTimers: host-side accumulating section timers. CUDA launches
    return before the card finishes, so a section's host time is the
    enqueue unless `block=True` with a `result` on a card, which
    synchronizes that device inside the section.
  * trace_to: a torch.profiler session (CPU and CUDA activities) that
    writes a Chrome trace (`chrome://tracing`, Perfetto) into `logdir`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimers:
    """Accumulating wall-clock section timers (thread-safe)."""

    def __init__(self):
        self._t: Dict[str, float] = defaultdict(float)
        self._n: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def section(self, name: str, block: bool = False, result=None):
        """Time the block; with `block=True`, first wait for the devices
        that hold `result`'s tensors (`torch.cuda.synchronize`)."""
        t0 = time.perf_counter()
        yield
        if block and result is not None:
            from . import tree_map
            devices = set()
            tree_map(lambda t: devices.add(t.device) if t.is_cuda else None,
                     result)
            for dev in devices:
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        with self._lock:
            self._t[name] += dt
            self._n[name] += 1

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(total_s=round(v, 6), calls=self._n[k],
                            mean_ms=round(1e3 * v / max(self._n[k], 1), 3))
                    for k, v in self._t.items()}

    def reset(self):
        with self._lock:
            self._t.clear()
            self._n.clear()


@contextlib.contextmanager
def trace_to(logdir: str):
    """A device-level trace of the block: torch.profiler with the CPU
    activity, and the CUDA one where a card is present, written as a
    Chrome trace to `logdir/trace.json`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
