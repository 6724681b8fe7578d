"""Timing, tracing and run metrics (``rbdtpu.utils``): wall-clock timers
that wait for the card, a ``torch.profiler`` trace, and the aggregate
statistics of a batch of DDP solves."""
from .metrics import SolveMetrics
from .profiling import Timer, benchmark, profile_trace

__all__ = ["profile_trace", "Timer", "benchmark", "SolveMetrics"]
