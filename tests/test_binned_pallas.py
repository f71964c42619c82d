"""Binned SpGEMM (per-bin sort + merge, ops/sortmerge) vs scipy golden."""
import pytest

from benchmark_spgemm_using_csr_tpu import CSR, pad_bucket, spgemm_flops
from benchmark_spgemm_using_csr_tpu.ops.binned import spgemm_binned_host
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    spgemm_reference,
)

MATRICES = {
    "er": lambda: generators.erdos_renyi(200, 200, 5.0, seed=7),
    "poisson2d": lambda: generators.poisson2d(16),
    "powerlaw": lambda: generators.power_law(200, 200, alpha=1.9, max_deg=96, seed=8),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_binned_pallas_backend(name):
    a = CSR.from_scipy(MATRICES[name]())
    cap = pad_bucket(spgemm_flops(a, a) // 2)
    c = spgemm_binned_host(a, a, prod_capacity=cap)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)
