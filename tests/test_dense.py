"""Dense-matmul SpGEMM path vs scipy golden — exact structural semantics
(pattern-product structure, explicit zeros kept), plus the cost-model
dispatcher."""
import numpy as np
import jax

from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.ops.dense import (
    csr_to_dense,
    make_dense_plan,
    spgemm_dense,
    spgemm_dense_auto,
)
from benchmark_spgemm_using_csr_tpu.ops.dispatch import choose_method
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    random_csr,
    spgemm_reference,
)


def test_csr_to_dense():
    a = random_csr(37, 23, density=0.1, seed=3)
    np.testing.assert_allclose(
        np.asarray(csr_to_dense(a)), a.to_scipy().toarray(), rtol=0
    )


def test_dense_exact_structure():
    a = random_csr(64, 64, density=0.08, seed=0)
    c = spgemm_dense_auto(a, a)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_dense_rect():
    a = random_csr(48, 80, density=0.1, seed=1)
    b = random_csr(80, 32, density=0.15, seed=2)
    c = spgemm_dense_auto(a, b)
    assert_csr_equal(c, spgemm_reference(a, b), rtol=1e-4, atol=1e-5)


def test_dense_high_fill():
    a_sp = generators.dense_rows(96, 96, nnz_per_row=48, seed=4)
    a = CSR.from_scipy(a_sp)
    c = spgemm_dense_auto(a, a)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-4)


def test_dense_jit():
    a = random_csr(40, 40, density=0.1, seed=5)
    plan = make_dense_plan(a, a)
    c = jax.jit(spgemm_dense)(a, a, plan)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_dense_empty_rows():
    import scipy.sparse as sp

    a_sp = sp.csr_matrix((16, 16), dtype=np.float32)
    a_sp[3, 7] = 2.0
    a_sp = a_sp.tocsr()
    a = CSR.from_scipy(a_sp)
    c = spgemm_dense_auto(a, a)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-6)


def test_choose_method_regimes():
    # expectations track the calibration points of ops/dispatch.COST
    # (scripts/calibrate_dispatch.py on the GPU): stencil and banded
    # regimes -> dia, mid-size dense-rows -> bsr, large dense-rows -> dense,
    # short-row ER -> a per-tile/per-group sort path
    assert choose_method(CSR.from_scipy(generators.poisson2d(64))) == "dia"
    assert choose_method(CSR.from_scipy(generators.banded(1024, 8))) == "dia"
    assert choose_method(
        CSR.from_scipy(generators.erdos_renyi(4096, 4096, 8.0))
    ) in ("tilepack", "chunked", "grouped")
    # at er_medium scale tilepack measured fastest of the sort paths
    assert choose_method(
        CSR.from_scipy(generators.SUITE["er_medium"]())
    ) == "tilepack"
    assert (
        choose_method(
            CSR.from_scipy(generators.dense_rows(2048, 2048, nnz_per_row=96))
        )
        == "bsr"
    )
    assert (
        choose_method(CSR.from_scipy(generators.SUITE["dense_rows_8k"]()))
        == "dense"
    )
