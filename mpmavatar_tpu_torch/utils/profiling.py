"""Tracing and profiling utilities (port of
mpmavatar_tpu/utils/profiling.py).

``named_scope`` labels a region in a ``torch.profiler`` trace;
``PhaseTimer`` accumulates host-clock time per phase, waiting for the
device of a given tensor before it stops the clock (the reference's
``wp.ScopedTimer`` phase dict); ``trace`` records a ``torch.profiler``
trace of a block into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

named_scope = torch.profiler.record_function  # labels substep phases


class PhaseTimer:
    """Host-side phase accumulator (print_time_profile equivalent)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; with ``block_on`` (a tensor), the clock stops
        after that tensor's CUDA device has finished its work."""
        t0 = time.perf_counter()
        yield
        if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def print_time_profile(self):
        print("MPM Time profile:")
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            print(f"  {k}: {self.totals[k]:.3f}s over {self.counts[k]} calls")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the CPU, and the
    CUDA device when there is one) into ``log_dir`` as a Chrome trace
    (``trace.json``), viewable in Perfetto or chrome://tracing."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
