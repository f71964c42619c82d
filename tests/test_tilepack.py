"""Packed-tile ESC SpGEMM vs scipy golden."""
import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.ops.tilepack import (
    make_tilepack_plan,
    spgemm_tilepack,
)
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    random_csr,
    spgemm_reference,
)

MATRICES = {
    "poisson2d": lambda: generators.poisson2d(24),
    "er": lambda: generators.erdos_renyi(300, 300, 6.0, seed=7),
    "banded": lambda: generators.banded(256, bandwidth=3, seed=9),
    "er_dense": lambda: generators.erdos_renyi(128, 128, 12.0, seed=3),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_tilepack_square_vs_scipy(name):
    a = CSR.from_scipy(MATRICES[name]())
    sched = make_tilepack_plan(a, a)
    assert sched is not None
    c = spgemm_tilepack(a, a, sched)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_tilepack_rectangular():
    a = random_csr(100, 60, density=0.1, seed=1)
    b = random_csr(60, 140, density=0.08, seed=2)
    sched = make_tilepack_plan(a, b)
    assert sched is not None
    c = spgemm_tilepack(a, b, sched)
    assert_csr_equal(c, spgemm_reference(a, b), rtol=1e-4, atol=1e-5)


def test_tilepack_empty_rows_mixed():
    import scipy.sparse as sp

    a_sp = sp.random(128, 128, density=0.05, random_state=42,
                     format="csr").astype(np.float32)
    a_sp[30:60, :] = 0
    a_sp.eliminate_zeros()
    a = CSR.from_scipy(a_sp)
    sched = make_tilepack_plan(a, a)
    assert sched is not None
    c = spgemm_tilepack(a, a, sched)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_tilepack_declines_long_rows():
    """A hub row whose products exceed max_w keeps the chunked path."""
    a = CSR.from_scipy(
        generators.power_law(512, 512, alpha=1.6, max_deg=400, seed=2)
    )
    assert make_tilepack_plan(a, a, max_w=256) is None


def test_tilepack_explicit_width():
    a = CSR.from_scipy(MATRICES["er"]())
    sched = make_tilepack_plan(a, a, w=1024)
    assert sched is not None and sched.plan.w == 1024
    c = spgemm_tilepack(a, a, sched)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_facade_tilepack_method():
    import benchmark_spgemm_using_csr_tpu as F

    a = CSR.from_scipy(MATRICES["er"]())
    c = F.spgemm(a, a, method="tilepack")
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_dispatch_includes_tilepack():
    from benchmark_spgemm_using_csr_tpu.ops.dispatch import (
        estimate_tilepack_s,
    )

    a = CSR.from_scipy(MATRICES["er"]())
    assert np.isfinite(estimate_tilepack_s(a))
    hub = CSR.from_scipy(
        generators.power_law(512, 512, alpha=1.6, max_deg=400, seed=2)
    )
    assert estimate_tilepack_s(hub) == float("inf")


def test_tilepack_single_entry():
    import scipy.sparse as sp

    s = sp.csr_matrix(([2.0], ([1], [2])), shape=(4, 4)).astype(np.float32)
    a = CSR.from_scipy(s)
    sched = make_tilepack_plan(a, a)
    if sched is not None:
        c = spgemm_tilepack(a, a, sched)
        assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-6, atol=1e-7)
