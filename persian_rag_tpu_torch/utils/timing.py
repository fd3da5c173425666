"""Timing and profiling utilities.

The counterpart of ``persian_rag_tpu.utils.timing``: `Timer` accumulates
named wall-clock intervals (its summary keeps the avg_<name>_time /
total_time keys), `timed` prints or collects one interval, and `trace`
records a `torch.profiler` trace, with CUDA activity when the card is
there, written as a Chrome trace into `log_dir`. Where the JAX package's
`trace` goes on silently when its profiler fails to start, this one raises.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Accumulates named wall-clock intervals; .summary() gives the
    avg_<name>_time and total_time keys."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        start = time.time()
        try:
            yield
        finally:
            self._totals[name] += time.time() - start
            self._counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] += seconds
        self._counts[name] += 1

    def total(self, name: str) -> float:
        return self._totals[name]

    def mean(self, name: str) -> float:
        count = self._counts[name]
        return self._totals[name] / count if count else 0.0

    def summary(self, prefix: str = "") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name in self._totals:
            out[f"{prefix}avg_{name}_time"] = self.mean(name)
        out[f"{prefix}total_time"] = sum(
            self.mean(name) for name in self._totals
        )
        return out


@contextlib.contextmanager
def timed(label: str, sink=None) -> Iterator[None]:
    """Print (or collect into `sink`) one wall-clock interval."""
    start = time.time()
    try:
        yield
    finally:
        elapsed = time.time() - start
        if sink is not None:
            sink[label] = elapsed
        else:
            print(f"[{label}] {elapsed:.3f}s")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = "logs/torch_trace") -> Iterator[None]:
    """Record a torch.profiler trace of the block (CPU activity, and CUDA
    activity when CUDA is available) and write it as a Chrome trace,
    ``log_dir/trace_<pid>_<ns>.json`` (Perfetto or chrome://tracing read
    it). A profiler that fails to start raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
