"""Tiled (uniform-row, single-dispatch) SpGEMM vs scipy golden."""
import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu import CSR, spgemm
from benchmark_spgemm_using_csr_tpu.ops.tiled import make_tiled_plan, spgemm_tiled
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    random_csr,
    spgemm_reference,
)


def test_tiled_poisson():
    a = CSR.from_scipy(generators.poisson2d(24))
    plan = make_tiled_plan(a, a)
    assert plan is not None and plan.width == 32  # 5x5 products
    c = spgemm_tiled(a, a, plan)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_tiled_banded_small():
    a = CSR.from_scipy(generators.banded(256, bandwidth=2, seed=3))
    plan = make_tiled_plan(a, a)
    assert plan is not None
    c = spgemm_tiled(a, a, plan)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_tiled_rectangular():
    a = random_csr(96, 64, density=0.05, seed=5)
    b = random_csr(64, 120, density=0.05, seed=6)
    plan = make_tiled_plan(a, b)
    if plan is None:
        pytest.skip("regime check rejected the random pair")
    c = spgemm_tiled(a, b, plan)
    assert_csr_equal(c, spgemm_reference(a, b), rtol=1e-4, atol=1e-5)


def test_tiled_regime_rejections():
    # long-row power-law must be rejected (width too large)
    a = CSR.from_scipy(generators.power_law(256, 256, alpha=1.8, max_deg=128, seed=1))
    assert make_tiled_plan(a, a, max_width=64) is None
    # zero matrix rejected
    import scipy.sparse as sp

    z = CSR.from_scipy(sp.csr_matrix((16, 16), dtype=np.float32))
    assert make_tiled_plan(z, z) is None


def test_facade_method_tiled():
    a = CSR.from_scipy(generators.poisson2d(20))
    c = spgemm(a, a, method="tiled")
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        spgemm(
            CSR.from_scipy(
                generators.power_law(256, 256, alpha=1.8, max_deg=128, seed=1)
            ),
            CSR.from_scipy(
                generators.power_law(256, 256, alpha=1.8, max_deg=128, seed=1)
            ),
            method="tiled",
        )
