"""benchmark_spgemm_using_csr_tpu — a sparse linear-algebra
framework with the capabilities of the Liu–Vinter bhSPARSE CSR SpGEMM
benchmark (weifengliu-ssslab/Benchmark_SpGEMM_using_CSR), re-designed from
scratch for JAX/XLA. See SURVEY.md for the blueprint and the
reference-availability caveats (the mount was empty; behavior is built to
the published IPDPS14/JPDC15 algorithm spec and BASELINE.json).
"""
from .sparse.csr import CSR, COO, BSR, csr_transpose, csr_gather_rows, pad_bucket
from .sparse.dia import DIA
from .ops.dia import dia_spgemm, dia_spmv, dia_viable, spgemm_dia
from .ops.dense import make_dense_plan, spgemm_dense, spgemm_dense_auto
from .ops.dispatch import choose_method
from .api import spgemm, spgemm_flops, nnz_upper_bound
from .ops.esc import spgemm_esc_padded
from .ops.binned import spgemm_binned_host
from .ops.chunked import make_chunked_plan, spgemm_chunked
from .ops.fused import make_plan as make_fused_plan, spgemm_fused
from .ops.hash import spgemm_hash
from .ops.batched import spgemm_batched
from .ops.spadd import spadd
from .ops.sptrsv import sptrsv, make_trsv_plan, sptrsv_planned
from .ops.reuse import make_numeric_plan, spgemm_numeric
from .compat import BhSparse

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "COO",
    "BSR",
    "DIA",
    "dia_spgemm",
    "dia_spmv",
    "dia_viable",
    "spgemm_dia",
    "make_dense_plan",
    "spgemm_dense",
    "spgemm_dense_auto",
    "choose_method",
    "csr_transpose",
    "csr_gather_rows",
    "pad_bucket",
    "spgemm",
    "spgemm_flops",
    "nnz_upper_bound",
    "spgemm_esc_padded",
    "spgemm_binned_host",
    "make_chunked_plan",
    "spgemm_chunked",
    "make_fused_plan",
    "spgemm_fused",
    "spgemm_hash",
    "spadd",
    "sptrsv",
    "make_trsv_plan",
    "sptrsv_planned",
    "make_numeric_plan",
    "spgemm_numeric",
]
