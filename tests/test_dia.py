"""DIA (diagonal-format) SpGEMM / SpMV vs scipy golden.

Dense-compared like the BSR tests to sidestep explicit-zero
canonicalization (DIA planes over-approximate structure the same way BSR
blocks do)."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.sparse.dia import DIA
from benchmark_spgemm_using_csr_tpu.ops.dia import (
    dia_offsets_of,
    dia_spgemm,
    dia_spmv,
    dia_viable,
    spgemm_dia,
)
from benchmark_spgemm_using_csr_tpu.utils import generators


def _dense_check(a_sp, b_sp=None, rtol=1e-4):
    b_sp = a_sp if b_sp is None else b_sp
    c = dia_spgemm(DIA.from_scipy(a_sp), DIA.from_scipy(b_sp))
    want = (a_sp @ b_sp).toarray()
    np.testing.assert_allclose(
        np.asarray(c.to_scipy().toarray()), want, rtol=rtol, atol=1e-5
    )


def test_roundtrip_from_csr():
    a_sp = generators.poisson2d(16)
    a = CSR.from_scipy(a_sp)
    d = DIA.from_csr(a)
    back = d.to_csr(prune=False).to_scipy()
    # structure may widen to full diagonals; values must match densely
    np.testing.assert_allclose(back.toarray(), a_sp.toarray(), rtol=1e-6)


def test_roundtrip_scipy():
    a_sp = generators.banded(64, bandwidth=3, seed=5)
    d = DIA.from_scipy(a_sp)
    np.testing.assert_allclose(
        d.to_scipy().toarray(), a_sp.toarray(), rtol=0
    )


def test_spgemm_poisson():
    _dense_check(generators.poisson2d(16))


def test_spgemm_banded():
    _dense_check(generators.banded(200, bandwidth=5, seed=1))


def test_spgemm_stencil27():
    _dense_check(generators.stencil27(6))


def test_spgemm_rectangular():
    rng = np.random.default_rng(0)
    a = sp.diags(
        [rng.standard_normal(40), rng.standard_normal(40)],
        [0, 3], shape=(40, 43), format="csr",
    ).astype(np.float32)
    b = sp.diags(
        [rng.standard_normal(40), rng.standard_normal(43)],
        [-3, 2], shape=(43, 50), format="csr",
    ).astype(np.float32)
    _dense_check(a, b)


def test_spgemm_single_offdiag():
    a = sp.diags([np.arange(1.0, 30.0)], [-4], shape=(33, 33), format="csr")
    _dense_check(a.astype(np.float32))


def test_spgemm_f64():
    a_sp = generators.poisson2d(12).astype(np.float64)
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("x64 disabled")
    _dense_check(a_sp, rtol=1e-12)


def test_spgemm_jit():
    a_sp = generators.banded(96, bandwidth=2, seed=3)
    d = DIA.from_scipy(a_sp)
    c = jax.jit(dia_spgemm)(d, d)
    want = (a_sp @ a_sp).toarray()
    np.testing.assert_allclose(
        np.asarray(c.to_scipy().toarray()), want, rtol=1e-4, atol=1e-5
    )


def test_spmv():
    a_sp = generators.stencil27(5)
    d = DIA.from_scipy(a_sp)
    x = np.linspace(-1, 1, a_sp.shape[1]).astype(np.float32)
    got = np.asarray(jax.jit(dia_spmv)(d, jnp.asarray(x)))
    np.testing.assert_allclose(got, a_sp @ x, rtol=1e-4, atol=1e-5)


def test_spmv_rectangular():
    rng = np.random.default_rng(1)
    a = sp.diags(
        [rng.standard_normal(30), rng.standard_normal(30)],
        [0, 7], shape=(30, 37), format="csr",
    ).astype(np.float32)
    d = DIA.from_scipy(a)
    x = rng.standard_normal(37).astype(np.float32)
    got = np.asarray(dia_spmv(d, jnp.asarray(x)))
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-5)


def test_offsets_of():
    a = CSR.from_scipy(generators.poisson2d(8))
    offs = dia_offsets_of(a)
    assert set(offs) == {-8, -1, 0, 1, 8}


def test_viable_dispatch():
    assert dia_viable(CSR.from_scipy(generators.poisson2d(32)))
    assert dia_viable(CSR.from_scipy(generators.banded(512, bandwidth=8)))
    # iid random occupies ~every diagonal — DIA must refuse
    assert not dia_viable(
        CSR.from_scipy(generators.erdos_renyi(1024, 1024, 8.0))
    )


def test_spgemm_dia_csr_wrapper():
    a_sp = generators.poisson2d(12)
    a = CSR.from_scipy(a_sp)
    c = spgemm_dia(a, a)
    want = a_sp @ a_sp
    want.eliminate_zeros()
    want.sort_indices()
    got = c.to_scipy()
    got.eliminate_zeros()
    got.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-4, atol=1e-6)


def test_zero_matrix_dia_and_auto_dispatch():
    """All-zero A: auto dispatch must not pick a backend that chokes on an
    empty diagonal set, and the DIA path itself must return an empty C
    (regression: dia_spgemm crashed on max(()) and choose_method returned
    'dia' because every cost estimate ties at ~0 when products == 0)."""
    import scipy.sparse as sp

    from benchmark_spgemm_using_csr_tpu import spgemm
    from benchmark_spgemm_using_csr_tpu.ops.dispatch import choose_method

    z = CSR.from_scipy(sp.csr_matrix((100, 100), dtype=np.float32))
    assert choose_method(z) == "chunked"
    for method in ("auto", "dia"):
        c = spgemm(z, z, method=method)
        assert int(np.asarray(c.rowptr)[-1]) == 0


def _xla_form_check(a_sp, b_sp):
    """dia_spgemm's output planes, read back as CSR, against scipy."""
    got = dia_spgemm(
        DIA.from_scipy(a_sp.todia()), DIA.from_scipy(b_sp.todia())
    ).to_scipy().tocsr()
    np.testing.assert_allclose(
        got.toarray(), (a_sp @ b_sp).toarray(), rtol=1e-4, atol=1e-5
    )


def test_xla_form_poisson():
    a = generators.poisson2d(16)  # offsets +-16, n=256
    _xla_form_check(a, a)


def test_xla_form_banded_asymmetric():
    a = generators.banded(512, bandwidth=3, seed=1)
    b = generators.banded(512, bandwidth=5, seed=2)
    _xla_form_check(a, b)


def test_xla_form_odd_length():
    # n not a power of two: shifted slices end mid-plane
    a = generators.banded(300, bandwidth=2, seed=3)
    _xla_form_check(a, a)
