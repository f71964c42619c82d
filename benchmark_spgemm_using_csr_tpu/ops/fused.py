"""Single-dispatch fused SpGEMM: all four reference stages (symbolic →
binning → per-bin numeric → compaction, SURVEY.md §4) compiled into ONE
XLA executable.

Motivation: the reference's host-orchestrated stage-2 (D2H binning,
per-bin launches — SURVEY.md §5.2) would cost 10+ host round trips per
SpGEMM. The answer here is a **shape plan**: the only genuinely host-side quantities are buffer
*capacities* (static shapes). ``make_plan`` computes them once per
matrix-profile (one device sync); ``spgemm_fused`` then runs the whole
pipeline — including on-device binning via fixed-capacity ``jnp.nonzero`` —
as a single jitted call. Row *membership* of each bin is computed on device
every call; only the paddings are baked into the compilation, exactly like
the reference's compile-time bin constants in common.h [R].

Capacities are bucket-padded so matrices with similar profiles share one
compilation.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, csr_gather_rows, pad_bucket
from .binned import _bin_numeric
from .esc import gather_products, sort_compress
from .symbolic import nnz_upper_bound

DEFAULT_WIDTHS = (8, 32, 128, 512)


@dataclasses.dataclass(frozen=True)
class SpGemmPlan:
    """Static shape plan for one matrix profile (all entries are paddings)."""

    widths: Tuple[int, ...]
    bin_rows: Tuple[int, ...]  # padded row capacity per width bin (0 = bin off)
    tail_rows: int  # padded rows with nnzCt > widths[-1] (0 = no tail)
    tail_nnz_a: int  # padded nnz(A) restricted to tail rows
    tail_prod: int  # padded products of tail rows
    out_cap: int  # padded nnzC upper bound

    def cache_key(self):
        return dataclasses.astuple(self)


def make_plan(
    a: CSR, b: CSR, widths: Tuple[int, ...] = DEFAULT_WIDTHS
) -> SpGemmPlan:
    """One device sync: stage-1 bounds → bucket-padded static capacities."""
    nnz_ct = np.asarray(jax.jit(nnz_upper_bound)(a, b))
    a_rowptr = np.asarray(a.rowptr)
    bin_rows = []
    prev = 0
    for w in widths:
        cnt = int(((nnz_ct > prev) & (nnz_ct <= w)).sum())
        bin_rows.append(pad_bucket(cnt) if cnt else 0)
        prev = w
    tail_mask = nnz_ct > widths[-1]
    tail = np.nonzero(tail_mask)[0]
    if tail.size:
        tail_rows = pad_bucket(tail.size)
        tail_nnz_a = pad_bucket(int((a_rowptr[tail + 1] - a_rowptr[tail]).sum()))
        tail_prod = pad_bucket(int(nnz_ct[tail].sum()))
    else:
        tail_rows = tail_nnz_a = tail_prod = 0
    # nnzC <= min(total products, m * n); products is the usable bound here
    out_cap = pad_bucket(int(np.minimum(nnz_ct, b.n).sum()))
    return SpGemmPlan(
        widths=tuple(widths),
        bin_rows=tuple(bin_rows),
        tail_rows=tail_rows,
        tail_nnz_a=tail_nnz_a,
        tail_prod=tail_prod,
        out_cap=out_cap,
    )


@partial(jax.jit, static_argnames=("plan",))
def spgemm_fused(a: CSR, b: CSR, plan: SpGemmPlan) -> CSR:
    """C = A @ B in one dispatch. Falls back to garbage (silently truncated
    bins) if the plan's capacities are exceeded — call through the facade,
    which validates plans against the matrix."""
    m, n = a.m, b.n
    nnz_ct = nnz_upper_bound(a, b)
    prodstart = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(nnz_ct).astype(INDEX_DTYPE)]
    )

    # --- stage 2 on device: fixed-capacity bin membership ------------------
    pieces = []
    prev = 0
    for w, cap in zip(plan.widths, plan.bin_rows):
        if cap:
            mask = (nnz_ct > prev) & (nnz_ct <= w)
            rows = jnp.nonzero(mask, size=cap, fill_value=m)[0].astype(INDEX_DTYPE)
            cols_t, vals_t, counts = _bin_numeric(
                a, b, rows, nnz_ct, prodstart, width=w
            )
            pieces.append((rows, cols_t, vals_t, counts))
        prev = w

    # --- tail: rows beyond the largest width via flat expand-sort-compress -
    c_tail = None
    tail_rows = None
    if plan.tail_rows:
        tail_mask = nnz_ct > plan.widths[-1]
        tail_rows = jnp.nonzero(tail_mask, size=plan.tail_rows, fill_value=m)[
            0
        ].astype(INDEX_DTYPE)
        a_tail = csr_gather_rows(a, tail_rows, plan.tail_nnz_a)
        trow, tcol, tval = _expand(a_tail, b, plan.tail_prod)
        t_rowptr, t_col, t_val = sort_compress(
            trow, tcol, tval, plan.tail_rows, plan.tail_prod, a.vals.dtype
        )
        c_tail = CSR(t_rowptr, t_col, t_val, (plan.tail_rows, n))

    # --- stage 4: exact counts → rowptr → scatter compaction ---------------
    counts_full = jnp.zeros(m, INDEX_DTYPE)
    for rows, _, _, counts in pieces:
        counts_full = counts_full.at[rows].add(counts, mode="drop")
    if c_tail is not None:
        counts_full = counts_full.at[tail_rows].add(
            c_tail.row_lengths().astype(INDEX_DTYPE), mode="drop"
        )
    rowptr = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(counts_full).astype(INDEX_DTYPE)]
    )

    colidx_buf = jnp.zeros(plan.out_cap, INDEX_DTYPE)
    vals_buf = jnp.zeros(plan.out_cap, a.vals.dtype)
    for rows, cols_t, vals_t, counts in pieces:
        width = cols_t.shape[1]
        lane = jnp.arange(width, dtype=INDEX_DTYPE)
        valid = lane[None, :] < counts[:, None]
        base = rowptr[jnp.minimum(rows, m)]
        tgt = jnp.where(valid, base[:, None] + lane[None, :], plan.out_cap)
        colidx_buf = colidx_buf.at[tgt].set(cols_t, mode="drop")
        vals_buf = vals_buf.at[tgt].set(vals_t, mode="drop")
    if c_tail is not None:
        local_row = c_tail.row_ids()
        local_c = jnp.minimum(local_row, plan.tail_rows - 1)
        valid = local_row < plan.tail_rows
        offset = (
            jnp.arange(c_tail.capacity, dtype=INDEX_DTYPE)
            - c_tail.rowptr[local_c]
        )
        orig = tail_rows[local_c]
        in_range = valid & (orig < m)
        tgt = jnp.where(in_range, rowptr[jnp.minimum(orig, m - 1)] + offset, plan.out_cap)
        colidx_buf = colidx_buf.at[tgt].set(c_tail.colidx, mode="drop")
        vals_buf = vals_buf.at[tgt].set(c_tail.vals, mode="drop")

    return CSR(rowptr=rowptr, colidx=colidx_buf, vals=vals_buf, shape=(m, n))


def _expand(a: CSR, b: CSR, prod_capacity: int):
    """Flat product expansion (row, col, val) — shares gather_products."""
    m = a.m
    from .symbolic import products_per_nz

    total = jnp.sum(products_per_nz(a, b))
    p = jnp.arange(prod_capacity, dtype=INDEX_DTYPE)
    valid = p < total
    src_c, col, val = gather_products(a, b, jnp.where(valid, p, 0), valid)
    row = jnp.where(valid, a.row_ids()[src_c], m).astype(INDEX_DTYPE)
    return row, col, val
