"""utils/timing: the two-length delta cancels the per-dispatch cost, and no
fixed time is ever subtracted (a fake clock stands in for the device)."""
import pytest

from benchmark_spgemm_using_csr_tpu.utils import timing


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize(
    "body_s, fixed_s, want",
    [
        # slow body: wall / k1, the fixed cost stays in (no subtraction)
        (0.020, 0.052, 0.020 + 0.052 / 8),
        # fast body: the two-length delta cancels the fixed cost
        (0.001, 0.052, 0.001),
    ],
)
def test_bench_delta_stats_fake_clock(monkeypatch, body_s, fixed_s, want):
    clock = FakeClock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)

    def kfac(k):
        def run(x):
            clock.now += fixed_s + k * body_s
            return x

        return run

    res = timing.bench_delta_stats(kfac, lambda i: (i,), k1=8, runs=3)
    assert res.per_s == pytest.approx(want, rel=1e-9)
    assert res.spread == pytest.approx(0.0, abs=1e-9)
    assert (res.k2 == 0) == (body_s >= 0.015)
