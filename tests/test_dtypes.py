"""Value-dtype coverage: bf16 on the standard path, f64 via x64 subprocess
(SURVEY.md §9 hard-part (b): FP64 configs via XLA x64 mode)."""
import subprocess
import sys

import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu import CSR, make_chunked_plan, spgemm_chunked
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import spgemm_reference


def test_bf16_values():
    import jax.numpy as jnp

    a_sp = generators.erdos_renyi(200, 200, 5.0, seed=9)
    a = CSR.from_scipy(a_sp, dtype=jnp.bfloat16)
    plan = make_chunked_plan(a, a)
    c = spgemm_chunked(a, a, plan)
    assert c.vals.dtype == jnp.bfloat16
    want = (a_sp @ a_sp).toarray()
    # scipy can't densify bf16 — rebuild with f32 values
    import scipy.sparse as sp

    rowptr = np.asarray(c.rowptr)
    nnz = int(rowptr[-1])
    got = sp.csr_matrix(
        (
            np.asarray(c.vals[:nnz]).astype(np.float32),
            np.asarray(c.colidx[:nnz]),
            rowptr,
        ),
        shape=c.shape,
    ).toarray()
    # bf16 product accumulated in f32: ~2-3 decimal digits
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.slow
def test_f64_values_subprocess():
    code = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from benchmark_spgemm_using_csr_tpu import CSR, make_chunked_plan, spgemm_chunked
from benchmark_spgemm_using_csr_tpu.utils import generators

a_sp = generators.erdos_renyi(200, 200, 5.0, seed=9).astype(np.float64)
a = CSR.from_scipy(a_sp)
assert str(a.vals.dtype) == "float64", a.vals.dtype
plan = make_chunked_plan(a, a)
c = spgemm_chunked(a, a, plan)
assert str(c.vals.dtype) == "float64", c.vals.dtype
want = (a_sp @ a_sp).toarray()
np.testing.assert_allclose(np.asarray(c.to_scipy().toarray()), want,
                           rtol=1e-12, atol=1e-12)
print("F64 OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=300,
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "F64 OK" in out.stdout


@pytest.mark.slow
def test_f64_grouped_subprocess():
    """f64 double-word lane through grouped-ESC (VERDICT r2 #7): values
    ride two packed int32 lanes; x64 scipy oracle at rtol 1e-12."""
    code = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.ops.grouped import (
    make_grouped_plan, spgemm_grouped)
from benchmark_spgemm_using_csr_tpu.utils import generators

for al in (0, 8):
    for tail in ("shift", "scan"):
        a_sp = generators.power_law(
            300, 300, alpha=1.9, max_deg=96, seed=6).astype(np.float64)
        a = CSR.from_scipy(a_sp)
        sched = make_grouped_plan(a, a, al=al, tail_mode=tail)
        assert sched is not None, (al, tail)
        c = spgemm_grouped(a, a, sched)
        assert str(c.vals.dtype) == "float64", c.vals.dtype
        want = (a_sp @ a_sp).toarray()
        np.testing.assert_allclose(
            np.asarray(c.to_scipy().toarray()), want,
            rtol=1e-12, atol=1e-12, err_msg=f"al={al} tail={tail}")
print("F64 GROUPED OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=560,
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "F64 GROUPED OK" in out.stdout


@pytest.mark.slow
def test_f64_dia_dense_subprocess():
    """f64 breadth (VERDICT r3 next #3): the DIA plane-FMA and dense-matmul
    paths compute f64 end-to-end under x64 mode; x64 scipy oracle at
    rtol 1e-12."""
    code = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.ops.dia import spgemm_dia
from benchmark_spgemm_using_csr_tpu.ops.dense import spgemm_dense_auto
from benchmark_spgemm_using_csr_tpu.utils import generators

a_sp = generators.poisson2d(24).astype(np.float64)  # 576 rows, 5 diagonals
a_sp.data *= np.random.default_rng(0).standard_normal(a_sp.nnz)
a = CSR.from_scipy(a_sp)
c = spgemm_dia(a, a)
assert str(c.vals.dtype) == "float64", c.vals.dtype
want = (a_sp @ a_sp).tocsr()
want.sort_indices(); want.eliminate_zeros()
got = c.to_scipy().tocsr(); got.sort_indices(); got.eliminate_zeros()
assert got.nnz == want.nnz
np.testing.assert_allclose(got.toarray(), want.toarray(),
                           rtol=1e-12, atol=1e-14)

d_sp = generators.dense_rows(96, 96, nnz_per_row=24, seed=2).astype(np.float64)
d = CSR.from_scipy(d_sp)
cd = spgemm_dense_auto(d, d)
assert str(cd.vals.dtype) == "float64", cd.vals.dtype
wd = (d_sp @ d_sp).toarray()
np.testing.assert_allclose(cd.to_scipy().toarray(), wd,
                           rtol=1e-12, atol=1e-14)
print("F64 DIA+DENSE OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=560,
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "F64 DIA+DENSE OK" in out.stdout


@pytest.mark.slow
def test_f64_bsr_subprocess():
    """f64 BSR lane (round 5, VERDICT r4 #4): the emulated-f64 block
    einsum + f64 scatter-add accumulate end-to-end under x64 mode; x64
    scipy oracle at rtol 1e-12."""
    code = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from benchmark_spgemm_using_csr_tpu.sparse.csr import BSR
from benchmark_spgemm_using_csr_tpu.ops.bsr import bsr_spgemm, make_bsr_plan
from benchmark_spgemm_using_csr_tpu.utils import generators

a_sp = generators.banded(1024, bandwidth=6, seed=4).astype(np.float64)
a_b = BSR.from_scipy(a_sp, block_shape=(8, 128))
b_b = BSR.from_scipy(a_sp, block_shape=(128, 128))
assert str(a_b.blocks.dtype) == "float64", a_b.blocks.dtype
plan = make_bsr_plan(a_b, b_b)
c = bsr_spgemm(a_b, b_b, plan)
assert str(c.blocks.dtype) == "float64", c.blocks.dtype
got = c.to_scipy().tocsr()
got.eliminate_zeros(); got.sort_indices()
want = (a_sp @ a_sp).tocsr()
want.eliminate_zeros(); want.sort_indices()
diff = abs(got - want).tocoo()
scale = float(np.abs(want.data).max())
assert diff.nnz == 0 or float(diff.data.max()) <= 1e-12 * max(scale, 1.0)
print("F64 BSR OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=560,
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "F64 BSR OK" in out.stdout
