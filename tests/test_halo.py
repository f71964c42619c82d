"""Halo-exchange distributed SpGEMM tests (B-row exchange over a padded
all_to_all, BASELINE.json config #5) on the 8-virtual-device CPU mesh."""
import numpy as np
import pytest
from jax.sharding import Mesh

from benchmark_spgemm_using_csr_tpu import CSR
from benchmark_spgemm_using_csr_tpu.parallel.dist import dist_spgemm
from benchmark_spgemm_using_csr_tpu.parallel.halo import (
    build_halo_plan,
    spgemm_halo,
)
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.oracle import (
    assert_csr_equal,
    random_csr,
    spgemm_reference,
)


def _mesh(devs, n):
    return Mesh(np.array(devs[:n]), ("rows",))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_halo_square_er(eight_devices, n_dev):
    a = CSR.from_scipy(generators.erdos_renyi(96, 96, 5.0, seed=11))
    c = spgemm_halo(a, a, _mesh(eight_devices, n_dev))
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_halo_powerlaw(eight_devices):
    a = CSR.from_scipy(generators.power_law(128, 128, alpha=1.9, max_deg=64, seed=12))
    c = spgemm_halo(a, a, _mesh(eight_devices, 4))
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_halo_rectangular(eight_devices):
    a = random_csr(64, 48, density=0.1, seed=5)
    b = random_csr(48, 72, density=0.12, seed=6)
    c = spgemm_halo(a, b, _mesh(eight_devices, 4))
    assert_csr_equal(c, spgemm_reference(a, b), rtol=1e-4, atol=1e-5)


def test_halo_via_dist_spgemm(eight_devices):
    a = CSR.from_scipy(generators.poisson2d(12))
    c = dist_spgemm(a, a, _mesh(eight_devices, 4), schedule="halo")
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_halo_plan_traffic_less_than_replication(eight_devices):
    """The point of the halo: per-device B traffic is O(halo nnz) < nnz(B)
    for banded locality."""
    a = CSR.from_scipy(generators.banded(256, bandwidth=3, seed=2))
    plan = build_halo_plan(a, a, 8)
    nnz_b = int(np.asarray(a.rowptr)[-1])
    recv_per_dev = np.asarray(plan.recv_sizes).sum(axis=1)
    assert recv_per_dev.max() < nnz_b / 2  # banded halo is ~local rows only
    c = spgemm_halo(a, a, _mesh(eight_devices, 8))
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)


def test_halo_empty_shard(eight_devices):
    """Shards whose A rows are all empty must still participate."""
    import scipy.sparse as sp

    m = 64
    a_sp = sp.lil_matrix((m, m), dtype=np.float32)
    a_sp[: m // 4, : m // 4] = np.random.default_rng(0).random((m // 4, m // 4))
    a = CSR.from_scipy(a_sp.tocsr())
    c = spgemm_halo(a, a, _mesh(eight_devices, 4))
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)
