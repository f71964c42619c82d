"""Tracing/profiling helpers (SURVEY.md §7.1): jax.profiler traces viewable
in TensorBoard/Perfetto, plus a simple stage-timer registry that pairs with
the roofline models.

The reference's equivalent is utils.h CUDA-event timers [R]; here the
profiler trace is the ground truth for per-kernel device time and the wall-clock
harness in utils/timing.py is the benchmark number.
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str = "/tmp/spgemm_trace", host_tracer_level: int = 2):
    """Capture a jax.profiler trace of the enclosed block.

    View with: tensorboard --logdir <logdir>  (or upload to Perfetto).
    """
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir, create_perfetto_trace=True)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Wall-clock stage timer (block_until_ready-based) with a JSONL dump
    that pairs with utils.roofline stage models."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder: list | None = None):
        import jax

        t0 = time.perf_counter()
        yield
        if result_holder:
            jax.block_until_ready(result_holder[-1])
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(self.stages)
