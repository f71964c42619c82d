"""Framework facade — the equivalent of the reference's
``bhsparse`` class (SURVEY.md §2/§3: bhsparse.h exposing initPlatform /
initData / spgemm / get_nnzC / get_C [R]).

Being JAX, the facade is functional: ``spgemm(A, B) -> CSR``. The stateful
init/get dance of the reference collapses into pytree containers + jit. The
host wrapper below handles the one genuinely dynamic quantity — output size —
with the reference's own two-buffer idea recast as power-of-two growth
buckets so jit recompiles are logarithmic (SURVEY.md §9 hard-part (a)).
"""
from __future__ import annotations


import jax

import numpy as np

from .sparse.csr import CSR, pad_bucket
from .ops import symbolic
from .ops.esc import spgemm_esc_padded

_symbolic_total = jax.jit(symbolic.total_products)
_symbolic_rows = jax.jit(symbolic.nnz_upper_bound)


def spgemm(
    a: CSR,
    b: CSR,
    *,
    method: str | None = None,
    trim: bool | None = None,
    config=None,
) -> CSR:
    """C = A @ B (host-facing; runs the jitted pipeline with bucketed sizes).

    method: 'esc' (global expand-sort-compress), 'binned' (per-bin fast
    path), or 'auto'. Explicit kwargs override ``config`` (a SpGemmConfig).
    trim: shrink C's padded buffers to pad_bucket(nnzC) on the host.
    """
    from .config import DEFAULT

    config = config or DEFAULT
    method = method if method is not None else config.method
    trim = trim if trim is not None else config.trim
    if a.n != b.m:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    total = int(_symbolic_total(a, b))
    prod_capacity = pad_bucket(total)
    auto = method == "auto"
    if auto:
        # cost-model dispatch over all measured backends (ops/dispatch.py —
        # the stage-2 analogue, measured constants), for ANY A @ B pair:
        # the AMG Galerkin chain (models/amg.py) rides the same dispatch
        # as the reference's C = A @ A benchmark mode. Methods like 'tiled'
        # remain available explicitly.
        from .ops.dispatch import choose_method

        method = choose_method(a, b)
    if method == "chunked":
        from .ops.chunked import make_chunked_plan, spgemm_chunked

        c = spgemm_chunked(a, b, make_chunked_plan(a, b))
    elif method == "bsr":
        from .ops.bsr import spgemm_bsr

        c = spgemm_bsr(a, b)
    elif method == "dia":
        from .ops.dia import spgemm_dia

        c = spgemm_dia(a, b)
    elif method == "dense":
        from .ops.dense import spgemm_dense_auto

        c = spgemm_dense_auto(a, b)
    elif method == "fused":
        from .ops.fused import make_plan as _make_fused_plan, spgemm_fused

        c = spgemm_fused(a, b, _make_fused_plan(a, b, widths=config.bin_widths))
    elif method == "binned":
        from .ops.binned import spgemm_binned_host

        c = spgemm_binned_host(
            a, b, prod_capacity=prod_capacity, widths=config.bin_widths
        )
    elif method == "esc":
        c = spgemm_esc_padded(a, b, prod_capacity, prod_capacity)
    elif method == "hash":
        from .ops.hash import spgemm_hash

        c = spgemm_hash(a, b)
    elif method == "tiled":
        from .ops.tiled import make_tiled_plan, spgemm_tiled

        tplan = make_tiled_plan(a, b)
        if tplan is None:
            raise ValueError(
                "matrix outside the tiled regime (uniform short rows)"
            )
        c = spgemm_tiled(a, b, tplan)
    elif method == "tilepack":
        from .ops.tilepack import make_tilepack_plan, spgemm_tilepack

        sched = make_tilepack_plan(a, b)
        if sched is None:
            # auto mode: the cost model and the plan builder share regime
            # gates, but the builder sees statics the estimator
            # approximates — fall back to chunked if it rejects after all
            if auto:
                return spgemm(a, b, method="chunked", trim=trim, config=config)
            raise ValueError(
                "matrix outside the packed-tile regime (short rows)"
            )
        c = spgemm_tilepack(a, b, sched)
    elif method == "grouped":
        from .ops.grouped import make_grouped_plan, spgemm_grouped

        gsched = make_grouped_plan(a, b)
        if gsched is None:
            if auto:
                return spgemm(a, b, method="chunked", trim=trim, config=config)
            raise ValueError(
                "matrix outside the grouped regime (packable values, "
                "nonzero products)"
            )
        c = spgemm_grouped(a, b, gsched)
    else:
        raise ValueError(f"unknown method {method!r}")
    if trim:
        nnz_c = int(np.asarray(c.rowptr)[-1])
        c = c.with_capacity(pad_bucket(nnz_c))
    return c


def spgemm_flops(a: CSR, b: CSR) -> int:
    """Canonical flop count 2 * sum_i nnzCt[i] (BASELINE.md definition)."""
    return 2 * int(_symbolic_total(a, b))


def nnz_upper_bound(a: CSR, b: CSR):
    return _symbolic_rows(a, b)
