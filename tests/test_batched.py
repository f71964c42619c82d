"""Row-batched (out-of-core) SpGEMM vs scipy golden."""
import numpy as np

from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.ops.batched import (
    plan_row_batches,
    spgemm_batched,
)
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)


def test_plan_row_batches():
    nnz_ct = np.array([10, 10, 10, 100, 5, 5])
    blocks = plan_row_batches(nnz_ct, 25)
    # contiguous cover of all rows
    assert blocks[0][0] == 0 and blocks[-1][1] == 6
    for (a0, a1), (b0, b1) in zip(blocks, blocks[1:]):
        assert a1 == b0
    for lo, hi in blocks:
        if hi - lo > 1:
            assert nnz_ct[lo:hi].sum() <= 25


def test_batched_matches_unbatched():
    a = CSR.from_scipy(generators.erdos_renyi(400, 400, 6.0, seed=13))
    # force ~8 blocks
    c = spgemm_batched(a, a, stream_budget=2000)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_batched_single_block_fast_path():
    a = CSR.from_scipy(generators.poisson2d(20))
    c = spgemm_batched(a, a)  # fits budget -> plain chunked
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_batched_oversized_single_row():
    import scipy.sparse as sp

    # one dense row whose products alone exceed the budget
    d = np.zeros((64, 64), np.float32)
    d[0, :] = 1.0
    d[:, 0] = 1.0
    np.fill_diagonal(d, 1.0)
    a = CSR.from_dense(d)
    c = spgemm_batched(a, a, stream_budget=100)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_batched_fused_single_dispatch_dense():
    """Round-4 fused fast path: when C fits HBM and blocks share one
    extraction mode, all dense blocks + B densify + assembly ride ONE jit
    (lax.scan) — covers 'gather' (sparse C) and 'shift'/'full'
    (near-dense C, pow2 rows so padding holes stay small)."""
    from benchmark_spgemm_using_csr_tpu.ops import batched

    # sparse-C / gather mode, multi-block
    a = CSR.from_scipy(generators.erdos_renyi(128, 128, 6.0, seed=2))
    c = spgemm_batched(a, a, stream_budget=2_000, method="dense",
                       as_scipy=False)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-3, atol=1e-3)
    plan = batched._cached_plan(a, a, 2_000, "dense")
    assert hasattr(plan, "_fused_stk")  # the fused branch actually ran

    # near-dense C at pow2 rows: full/shift extraction modes
    d = CSR.from_scipy(
        generators.dense_rows(128, 128, nnz_per_row=96, seed=7)
    )
    c2 = spgemm_batched(d, d, stream_budget=100_000, method="dense",
                        as_scipy=False)
    assert_csr_equal(c2, spgemm_reference(d, d), rtol=1e-3, atol=1e-3)


def test_batched_forced_dense_blocks():
    """Dense per-block path (r3 rebuild): forced method, multi-block,
    every extraction mode reachable (full / shift / gather)."""
    a = CSR.from_scipy(generators.dense_rows(96, 96, nnz_per_row=48, seed=5))
    c = spgemm_batched(a, a, stream_budget=50_000, method="dense")
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-4)


def test_batched_forced_grouped_blocks():
    """Grouped-ESC per-block path under unified statics."""
    a = CSR.from_scipy(generators.erdos_renyi(300, 300, 8.0, seed=9))
    c = spgemm_batched(a, a, stream_budget=5_000, method="grouped")
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_batched_auto_dispatches_and_caches():
    """Auto method selection + plan cache reuse across same-structure calls."""
    from benchmark_spgemm_using_csr_tpu.ops import batched as B

    a = CSR.from_scipy(generators.power_law(256, 256, alpha=1.9,
                                            max_deg=96, seed=4))
    B._plan_cache.clear()
    c1 = spgemm_batched(a, a, stream_budget=4_000)
    assert len(B._plan_cache) == 1
    # same structure, new values -> cache hit, fresh numerics
    import jax.numpy as jnp

    a2 = CSR(a.rowptr, a.colidx, a.vals * 2.0, a.shape)
    c2 = spgemm_batched(a2, a2, stream_budget=4_000)
    assert len(B._plan_cache) == 1
    sp1 = c1.to_scipy()
    sp2 = c2.to_scipy()
    np.testing.assert_allclose(sp2.data, 4.0 * sp1.data, rtol=1e-5)


def test_batched_rectangular():
    import scipy.sparse as sp

    a_sp = sp.random(200, 300, density=0.05, format="csr",
                     random_state=3, dtype=np.float32)
    b_sp = sp.random(300, 150, density=0.05, format="csr",
                     random_state=4, dtype=np.float32)
    a, b = CSR.from_scipy(a_sp), CSR.from_scipy(b_sp)
    c = spgemm_batched(a, b, stream_budget=2_000)
    assert_csr_equal(c, (a_sp @ b_sp).tocsr(), rtol=1e-4, atol=1e-5)


def test_batched_as_scipy_roundtrip():
    a = CSR.from_scipy(generators.erdos_renyi(200, 200, 6.0, seed=11))
    c = spgemm_batched(a, a, stream_budget=2_000, as_scipy=True)
    assert hasattr(c, "nnz")
    want = spgemm_reference(a, a)
    got = c.tocsr()
    got.sort_indices()
    np.testing.assert_allclose(
        got.toarray(), want.toarray(), rtol=1e-4, atol=1e-5
    )
