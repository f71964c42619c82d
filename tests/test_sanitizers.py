"""Sanitizer-mode runs (SURVEY.md §7.2): jax_debug_nans catches NaN
production in the numeric paths."""
import jax
import pytest

from benchmark_spgemm_using_csr_tpu import CSR, make_chunked_plan, spgemm_chunked
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)


def test_chunked_under_debug_nans():
    a = CSR.from_scipy(generators.power_law(200, 200, alpha=1.9, max_deg=64, seed=2))
    jax.config.update("jax_debug_nans", True)
    try:
        plan = make_chunked_plan(a, a)
        c = spgemm_chunked(a, a, plan)
        assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)
    finally:
        jax.config.update("jax_debug_nans", False)


def test_spmv_under_debug_nans():
    import numpy as np
    import jax.numpy as jnp

    from benchmark_spgemm_using_csr_tpu.ops.spmv import spmv

    a = CSR.from_scipy(generators.poisson2d(16))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(a.n).astype(np.float32))
    jax.config.update("jax_debug_nans", True)
    try:
        y = spmv(a, x)
        np.testing.assert_allclose(
            np.asarray(y), a.to_scipy() @ np.asarray(x), rtol=1e-4, atol=1e-5
        )
    finally:
        jax.config.update("jax_debug_nans", False)
