import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu.sparse.csr import CSR
from benchmark_spgemm_using_csr_tpu.utils import generators
from benchmark_spgemm_using_csr_tpu.utils.roofline import (
    H100_SXM,
    chip_spec,
    chunked_stage_models,
    roofline_report,
    spgemm_stage_models,
    tilepack_stage_models,
)


def test_stage_models_positive():
    sm = spgemm_stage_models(nnz_a=1000, nnz_b=1000, m=100, total_products=5000, nnz_c=3000)
    assert set(sm) == {"symbolic", "expand", "sort", "compress"}
    for v in sm.values():
        assert v.bytes_moved > 0
        assert v.sol_time_s(H100_SXM) > 0


def _stats(a):
    rowptr = np.asarray(a.rowptr)
    nnz_a = int(rowptr[-1])
    cols = np.asarray(a.colidx)[:nnz_a]
    f = int(np.diff(rowptr)[cols].sum())
    pat = a.to_scipy().astype(bool)
    nnz_c = int((pat @ pat).nnz)
    return nnz_a, f, nnz_c


def test_chunked_plan_aware_bound_positive_and_descriptor_scaled():
    """The plan-aware chunked bound must (a) be positive, (b) charge FEWER
    expansion descriptors for an al-aligned plan than for the narrow k=1
    plan of the same matrix — the round-1 defect was charging 1 descriptor
    per product regardless of plan (sol_fraction > 1 on aligned paths)."""
    from benchmark_spgemm_using_csr_tpu.ops.chunked import make_chunked_plan

    a = CSR.from_scipy(generators.erdos_renyi(512, 512, 8.0, seed=3))
    nnz_a, f, nnz_c = _stats(a)

    plan_n = make_chunked_plan(a, a, k=1)
    plan_a = make_chunked_plan(a, a, al=8)
    sm_n = chunked_stage_models(plan_n, nnz_a, nnz_a, a.m, nnz_c)
    sm_a = chunked_stage_models(plan_a, nnz_a, nnz_a, a.m, nnz_c)
    for sm in (sm_n, sm_a):
        assert set(sm) == {"metadata", "expand", "sort", "runsum", "compact"}
        for v in sm.values():
            assert v.sol_time_s(H100_SXM) > 0
    # narrow: one descriptor per padded product; aligned: one per al-chunk
    # (plus the table build) — structurally fewer on a mean-8-row matrix
    assert sm_a["expand"].descriptors < sm_n["expand"].descriptors


def test_tilepack_plan_aware_bound():
    from benchmark_spgemm_using_csr_tpu.ops.tilepack import make_tilepack_plan

    a = CSR.from_scipy(generators.erdos_renyi(512, 512, 8.0, seed=3))
    nnz_a, f, nnz_c = _stats(a)
    sched = make_tilepack_plan(a, a)
    assert sched is not None
    sm = tilepack_stage_models(sched.plan, nnz_a, nnz_a, a.m, nnz_c)
    assert set(sm) == {"metadata", "expand", "tile_sort_merge", "compact"}
    total = sum(v.sol_time_s(H100_SXM) for v in sm.values())
    assert total > 0
    # the kernel stage is tile-lane-rate bound, not descriptor bound
    assert sm["tile_sort_merge"].tile_lanes == sched.plan.t_cap * sched.plan.w
    # tilepack was chosen over narrow chunked BECAUSE it does fewer
    # descriptors: its expand bound must not exceed the generic
    # one-descriptor-per-product charge that produced sol_fraction > 1
    generic = spgemm_stage_models(nnz_a, nnz_a, a.m, f, nnz_c)
    assert sm["expand"].sol_time_s(H100_SXM) <= generic["expand"].sol_time_s(
        H100_SXM
    )


def test_report_fractions():
    sm = spgemm_stage_models(1000, 1000, 100, 5000, 3000)
    times = {k: v.sol_time_s(H100_SXM) * 2 for k, v in sm.items()}  # 50% of SoL
    rep = roofline_report(
        sm, times, total_time_s=sum(times.values()), chip=H100_SXM
    )
    for k in sm:
        assert abs(rep[k]["sol_fraction"] - 0.5) < 1e-9
    assert abs(rep["_total"]["sol_fraction"] - 0.5) < 1e-9


def test_chip_spec_by_device_kind():
    spec = chip_spec("NVIDIA H100 80GB HBM3")
    assert spec is H100_SXM
    assert spec.hbm_gbps == 3350.0 and spec.peak_f32_tflops == 67.0
    assert spec.peak_bf16_tflops == 989.0 and spec.peak_f64_tflops == 67.0
    # unmeasured ceilings stay unset and do not bound anything
    assert spec.gather_desc_per_s is None and spec.tile_sort_lanes_per_s is None


@pytest.mark.parametrize(
    "kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"]
)
def test_chip_spec_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        chip_spec(kind)


def test_report_without_chip_has_no_sol():
    sm = spgemm_stage_models(1000, 1000, 100, 5000, 3000)
    rep = roofline_report(sm, total_time_s=1e-3, chip=None)
    assert all(rep[k]["sol_time_s"] is None for k in sm)
    assert rep["_total"]["sol_time_s"] is None and rep["_total"]["chip"] is None
    assert "sol_fraction" not in rep["_total"]
