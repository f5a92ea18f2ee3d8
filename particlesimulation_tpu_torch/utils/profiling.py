"""Phase-level timing and device profiling (counterpart of the JAX package's
``utils/profiling.py``).

* :class:`PhaseTimer` — host-side phase timing, each phase fenced so that
  the device work it queued is counted in it;
* :func:`trace` — context manager around ``torch.profiler``, writing a
  Chrome trace (viewable in Perfetto or ``chrome://tracing``);
* :func:`bench_fn` — the median wall time of a call, fenced the same way.

The fence is ``torch.cuda.synchronize(device)`` on a CUDA device and
nothing on the CPU, where every torch call has finished when it returns.
With ``device=None`` it synchronises the current CUDA device once CUDA is in
use.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


def _fence(device):
    if device is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    def __init__(self, device=None):
        self.device = device
        self.totals: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        _fence(self.device)
        self.totals[name] = (self.totals.get(name, 0.0)
                             + time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{k:>24s}: {v:8.4f}s ({100*v/total:5.1f}%)"
                 for k, v in self.totals.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block (CPU activity, and CUDA activity for a CUDA
    ``device``) and write its Chrome trace into ``logdir`` as
    ``trace_<pid>_<ns>.json``. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _fence(device)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def bench_fn(fn, *args, warmup: int = 2, iters: int = 10,
             device=None) -> float:
    """Median wall seconds of ``fn(*args)`` with device fences."""
    for _ in range(warmup):
        fn(*args)
        _fence(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _fence(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
