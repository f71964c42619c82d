"""Benchmark timing harness — the equivalent of the reference's utils.h
timers + benchmark loop (SURVEY.md §3 component 7, §4 driver contract:
warmup run then N timed runs, mean time).

Correct timing means block_until_ready around the full dispatch (compile
excluded by the warmup) — the analogue of cudaEventElapsedTime around
kernel launches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax


@dataclasses.dataclass
class BenchResult:
    name: str
    mean_s: float
    min_s: float
    runs: int
    flops: int = 0
    nnz_out: int = 0
    times: tuple = ()  # raw per-run wall seconds

    @property
    def gflops(self) -> float:
        return self.flops / self.mean_s / 1e9 if self.mean_s else 0.0

    @property
    def gflops_best(self) -> float:
        return self.flops / self.min_s / 1e9 if self.min_s else 0.0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz_out / self.mean_s if self.mean_s else 0.0


def runtime_zero_probe(*arrays):
    """Runtime-zero scalar that data-depends on EVERY element of every
    array, order-dependently. Fold into a benchmark loop's carried state so
    XLA cannot dead-code-eliminate pipeline stages whose outputs the loop
    doesn't otherwise consume (e.g. probing only rowptr[-1] of a SpGEMM lets
    XLA drop the compaction sort and the run-sum entirely — measured).
    Parity-masked |x| sums are used because a stride-2 slice probe costs
    more than the pipeline it probes, and sum(sort(x)) may legally fold to
    sum(x)."""
    import jax.numpy as jnp

    acc = jnp.zeros((), jnp.float32)
    for x in arrays:
        par = (jnp.arange(x.shape[0], dtype=jnp.int32) & 1).astype(jnp.float32)
        acc = acc + jnp.abs(x.astype(jnp.float32) * par).sum()
    # acc >= 0 at runtime (or nan); either way the result is zero, but XLA
    # cannot prove it without computing acc
    return jnp.where(jnp.isfinite(acc), jnp.minimum(acc, 0.0), 0.0)


def _block(tree):
    return jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
        tree,
    )


@dataclasses.dataclass
class DeltaResult:
    """Median-of-repeats device time per iteration with spread diagnostics
    (single-shot numbers of short bodies swing; the headline must be a
    median with a recorded spread)."""

    per_s: float  # median per-iteration device seconds
    k2: int  # second scan length (0 = slow body, wall/k1 only)
    spread: float  # (max - min) / median over the per-run estimates
    samples: tuple = ()  # the individual per-iteration estimates

    @property
    def unstable(self) -> bool:
        return self.spread > 0.10


def bench_delta_stats(
    kfac: Callable[[int], Callable],
    vary: Callable[[int], tuple],
    *,
    k1: int = 8,
    name: str = "bench",
    flops: int = 0,
    runs: int = 3,
    t_target: float = 0.15,
    slow_threshold: float = 0.015,
) -> DeltaResult:
    """Per-iteration device seconds of ``kfac(k)`` — a factory returning a
    jitted fn that scans k data-dependent pipeline iterations.

    Times kfac(k1) as wall/k1. When the body is fast enough that the fixed
    per-dispatch cost (launch, argument transfer, synchronisation) would be
    a visible share of that quotient, also times kfac(k2) (k2 sized so
    k2 x body ~ t_target) and returns the two-length delta
    (wall(k2) - wall(k1)) / (k2 - k1): the per-dispatch constant cancels.

    Statistics: both scan lengths run ``runs`` times; per-run pairwise
    deltas give ``runs`` independent estimates, and the reported figure is
    their MEDIAN with (max-min)/median spread. If the delta collapses
    (non-positive or >50% spread), K2 escalates 8x up to 4096 before
    falling back to wall/k1."""
    import statistics

    def _wall_per_iter(r):
        samples = [t / k1 for t in r.times]
        med = statistics.median(samples)
        spread = (max(samples) - min(samples)) / med if med else 0.0
        return DeltaResult(med, 0, spread, tuple(samples))

    r1 = bench(kfac(k1), name=name, warmup=1, runs=runs,
               flops=flops * k1, vary=vary)
    t_est = max(r1.mean_s / k1, 2e-5)
    if t_est >= slow_threshold:
        return _wall_per_iter(r1)
    k2 = int(min(4096, max(4 * k1, round(t_target / t_est))))
    while True:
        r2 = bench(kfac(k2), name=f"{name}_k{k2}", warmup=1, runs=runs,
                   flops=flops * k2, vary=vary)
        samples = [
            (t2 - t1) / (k2 - k1)
            for t1, t2 in zip(r1.times, r2.times)
        ]
        positive = [s for s in samples if s > 0]
        med = statistics.median(positive) if positive else 0.0
        spread = (
            (max(positive) - min(positive)) / med if positive else 0.0
        )
        if positive and (spread <= 0.5 or k2 >= 4096):
            return DeltaResult(med, k2, spread, tuple(samples))
        if k2 >= 4096:
            return _wall_per_iter(r1)
        k2 = int(min(4096, k2 * 8))  # delta drowned in jitter: escalate


def bench_delta(
    kfac: Callable[[int], Callable],
    vary: Callable[[int], tuple],
    **kw,
) -> tuple[float, int]:
    """Back-compat wrapper: (median_per_iteration_s, k2)."""
    r = bench_delta_stats(kfac, vary, **kw)
    return r.per_s, r.k2


def bench(
    fn: Callable,
    *args,
    name: str = "bench",
    warmup: int = 2,
    runs: int = 5,
    flops: int = 0,
    nnz_out: int = 0,
    vary: Callable[[int], tuple] | None = None,
) -> BenchResult:
    """vary: optional run_index -> args tuple. When given, every warmup and
    timed run calls ``fn(*vary(i))`` with a fresh index, so no two runs see
    the same input bits. The per-run args are built and blocked OUTSIDE the
    timed region."""
    idx = 0
    for _ in range(warmup):
        run_args = _block(vary(idx)) if vary else args
        idx += 1
        _block(fn(*run_args))
    times = []
    for _ in range(runs):
        run_args = _block(vary(idx)) if vary else args
        idx += 1
        t0 = time.perf_counter()
        _block(fn(*run_args))
        times.append(time.perf_counter() - t0)
    return BenchResult(
        name=name,
        mean_s=sum(times) / len(times),
        min_s=min(times),
        runs=runs,
        flops=flops,
        nnz_out=nnz_out,
        times=tuple(times),
    )
