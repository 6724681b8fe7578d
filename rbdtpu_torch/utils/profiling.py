"""Tracing and timing helpers (``rbdtpu.utils.profiling``): a
``torch.profiler`` trace of the host and the card, a wall-clock timer that
waits for the card, and rbdtpu's min-over-batches steady-state timer."""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    """Wait for the current CUDA device's queued work (nothing to wait for
    where CUDA was never started)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the host's operators, and
    the card's kernels where there is a card) and write a chrome trace,
    ``trace.json`` in ``logdir`` (chrome://tracing or Perfetto).  Yields
    the profiler, whose ``key_averages()`` sum the time by operator and
    kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Wall-clock timer of a block.  It waits for the card before it reads
    the clock on entry and on exit, so ``elapsed`` (seconds) covers the
    block's device work, not only its launches.  rbdtpu's ``Timer``
    promises this but never blocks."""

    def __enter__(self):
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self.t0
        return False


def benchmark(fn, *args, reps: int = 3, batches: int = 5) -> float:
    """Steady-state seconds a call: after one warm-up call (which builds
    the kernels), ``batches`` batches of ``reps`` calls, the card
    synchronised after each batch; the minimum over batches of a batch's
    mean, rbdtpu's statistic (the minimum rejects host noise)."""
    fn(*args)
    _sync()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        _sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best
