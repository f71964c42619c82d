"""BSR (block-matmul path) SpGEMM vs scipy golden, dense-compared to sidestep
explicit-zero canonicalization."""
import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu import CSR, BSR
from benchmark_spgemm_using_csr_tpu.ops.bsr import (
    block_density,
    bsr_spgemm,
    make_bsr_plan,
    spgemm_bsr,
)
from benchmark_spgemm_using_csr_tpu.utils import generators


def _dense_check(a_sp, block_shape=(8, 16), bn=16):
    a = CSR.from_scipy(a_sp)
    c = spgemm_bsr(a, a, block_shape=block_shape, out_block=(block_shape[1], bn))
    want = (a_sp @ a_sp).toarray()
    np.testing.assert_allclose(c.todense(), want, rtol=1e-4, atol=1e-4)


def test_bsr_banded():
    _dense_check(generators.banded(256, bandwidth=4, seed=1).astype(np.float32))


def test_bsr_poisson():
    _dense_check(generators.poisson2d(16))


def test_bsr_random_blocky():
    rng = np.random.default_rng(0)
    import scipy.sparse as sp

    # block-structured random: a few dense 8x16 blocks
    m = 128
    dense = np.zeros((m, m), np.float32)
    for _ in range(30):
        i, j = rng.integers(0, m // 8) * 8, rng.integers(0, m // 16) * 16
        dense[i : i + 8, j : j + 16] = rng.standard_normal((8, 16))
    _dense_check(sp.csr_matrix(dense))


def test_bsr_direct_api():
    a_sp = generators.banded(128, bandwidth=3, seed=2).astype(np.float32)
    a_b = BSR.from_scipy(a_sp, block_shape=(8, 16))
    b_b = BSR.from_scipy(a_sp, block_shape=(16, 16))
    plan = make_bsr_plan(a_b, b_b)
    c_b = bsr_spgemm(a_b, b_b, plan)
    got = np.asarray(c_b.to_scipy().toarray())
    want = (a_sp @ a_sp).toarray()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_block_density_heuristic():
    banded = CSR.from_scipy(generators.banded(256, bandwidth=8, seed=1))
    er = CSR.from_scipy(generators.erdos_renyi(256, 256, 4.0, seed=1))
    assert block_density(banded, (8, 16)) > block_density(er, (8, 16))


def test_bsr_empty():
    import scipy.sparse as sp

    z = sp.csr_matrix((64, 64), dtype=np.float32)
    a = CSR.from_scipy(z)
    c = spgemm_bsr(a, a, block_shape=(8, 16), out_block=(16, 16))
    assert int(np.asarray(c.rowptr)[-1]) == 0
