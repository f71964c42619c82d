"""scripts/calibrate_dispatch.py: its pick scoring must agree with
ops/dispatch.choose_method, and its fit must recover a cost table that
generated the times exactly."""
import importlib.util
import os

import pytest

from benchmark_spgemm_using_csr_tpu.ops import dispatch as D
from benchmark_spgemm_using_csr_tpu.sparse.csr import CSR
from benchmark_spgemm_using_csr_tpu.utils import generators

_PATH = os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "calibrate_dispatch.py")
_spec = importlib.util.spec_from_file_location("calibrate_dispatch", _PATH)
cal = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cal)

MATRICES = {
    "poisson2d_32": lambda: generators.poisson2d(32),
    "er_1k": lambda: generators.erdos_renyi(1024, 1024, 8.0),
    "dense_rows_256": lambda: generators.dense_rows(256, 256,
                                                    nnz_per_row=24),
    "powerlaw_2k": lambda: generators.power_law(2048, 2048, alpha=2.0,
                                                max_deg=128),
}


def _records(name, a):
    return [dict(matrix=name, backend=label, method=method, terms=terms,
                 seconds=1.0)
            for label, method, _, terms in cal.candidates(D, a)
            if terms is not None]


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_pick_is_choose_methods(name):
    a = CSR.from_scipy(MATRICES[name]())
    pick = cal.picks(D, _records(name, a), D.COST)[name][0]
    assert pick.split("/")[0] == D.choose_method(a)


def test_fit_recovers_generating_table():
    recs = []
    for name, make in MATRICES.items():
        recs += _records(name, CSR.from_scipy(make()))
    truth = {k: v * 1.7 for k, v in D.COST.items()}
    for method in ("grouped", "tilepack", "chunked"):
        rows = [(r["terms"], D.price(r["terms"], truth)) for r in recs
                if r["method"] == method]
        got = cal.fit(rows, dict(D.COST))
        table = {**D.COST, **got}
        for terms, sec in rows:
            assert D.price(terms, table) == pytest.approx(sec, rel=1e-6)
