"""Global ESC (Expand–Sort–Compress) SpGEMM — the baseline numeric path.

The reference's stage-3 numeric phase uses three per-bin GPU methods (heap /
bitonic-ESC / merge-path, SURVEY.md §4). The data-parallel analogue of the
ESC method here is *global*: materialize every intermediate product as a (row,
col, val) triple in one padded buffer, lexicographically sort by (row, col)
with XLA's fused multi-operand sort, and compress duplicates with a
segmented scan — all static shapes, no per-row launches, no heaps.

This path is correct for every row-size regime (long power-law rows are just
more entries in the same sort) and serves as the fallback for the binned
fast path in ``binned.py``. The two-buffer upper-bound→exact design of the
reference (Ct → C, SURVEY.md §4 stage 4) maps exactly onto the padded
``prod_capacity`` buffer → exact ``rowptr`` produced here.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..sparse.csr import CSR, INDEX_DTYPE
from .symbolic import products_per_nz


def gather_products(a: CSR, b: CSR, g, valid):
    """Map global product indices ``g`` (any shape) to their (a_entry, col,
    val) triples. Product ``g`` belongs to A-entry k iff
    ``starts[k] <= g < ends[k]`` where starts/ends are the exclusive/
    inclusive cumsum of per-entry product counts. Invalid lanes yield
    (col=0, val=0) — callers re-sentinel as needed.

    The ragged expansion is a two-level gather driven by a searchsorted —
    O(|g| log nnzA), fully vectorized; this replaces the reference's
    per-thread expansion loops (SURVEY.md §4 stage 3).
    """
    per_nz = products_per_nz(a, b)
    ends = jnp.cumsum(per_nz)
    starts = ends - per_nz
    src = jnp.searchsorted(ends, g, side="right").astype(INDEX_DTYPE)
    src_c = jnp.minimum(src, a.capacity - 1)
    inner = g - starts[src_c]
    acol = a.colidx[src_c]
    bptr = b.rowptr[acol] + inner
    bptr_c = jnp.clip(bptr, 0, b.capacity - 1)
    col = jnp.where(valid, b.colidx[bptr_c], 0).astype(INDEX_DTYPE)
    val = jnp.where(valid, a.vals[src_c] * b.vals[bptr_c], 0)
    return src_c, col, val


def expand_products(a: CSR, b: CSR, prod_capacity: int):
    """Stage-3a expansion: enumerate all intermediate products.

    Returns (row, col, val) of shape (prod_capacity,). Products beyond the
    true total get sentinel row == m (sorts to the tail, masked downstream).
    """
    m, n = a.shape
    total = jnp.sum(products_per_nz(a, b))
    p = jnp.arange(prod_capacity, dtype=INDEX_DTYPE)
    valid = p < total
    src_c, col, val = gather_products(a, b, p, valid)
    row = jnp.where(valid, a.row_ids()[src_c], m).astype(INDEX_DTYPE)
    return row, col, val


def sort_compress(row, col, val, m: int, out_capacity: int, val_dtype=None):
    """Stage-3b/4: sort products by (row, col), merge duplicates, emit CSR
    arrays. Returns (rowptr, out_col, out_val)."""
    val_dtype = val_dtype or val.dtype
    row, col, val = jax.lax.sort(
        (row, col, val), num_keys=2, is_stable=False
    )
    valid = row < m
    prev_row = jnp.concatenate([jnp.full((1,), -1, row.dtype), row[:-1]])
    prev_col = jnp.concatenate([jnp.full((1,), -1, col.dtype), col[:-1]])
    is_head = (row != prev_row) | (col != prev_col)
    seg = jnp.cumsum(is_head.astype(INDEX_DTYPE)) - 1

    head_valid = is_head & valid
    counts = jax.ops.segment_sum(
        head_valid.astype(INDEX_DTYPE), row, num_segments=m + 1
    )[:m]
    rowptr = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(counts).astype(INDEX_DTYPE)]
    )

    seg_sum = jnp.where(valid, seg, out_capacity)
    out_val = jax.ops.segment_sum(
        jnp.where(valid, val, 0), seg_sum, num_segments=out_capacity + 1
    )[:out_capacity].astype(val_dtype)
    tgt = jnp.where(head_valid, seg, out_capacity)
    out_col = jnp.zeros(out_capacity, INDEX_DTYPE).at[tgt].set(col, mode="drop")
    return rowptr, out_col, out_val


@partial(jax.jit, static_argnames=("prod_capacity", "out_capacity"))
def spgemm_esc_padded(a: CSR, b: CSR, prod_capacity: int, out_capacity: int) -> CSR:
    """Fully-jittable C = A @ B with static buffer sizes.

    ``prod_capacity`` must be >= total intermediate products (stage-1 bound);
    ``out_capacity`` must be >= nnz(C) (prod_capacity always suffices).
    """
    row, col, val = expand_products(a, b, prod_capacity)
    rowptr, out_col, out_val = sort_compress(
        row, col, val, a.m, out_capacity, a.vals.dtype
    )
    return CSR(rowptr=rowptr, colidx=out_col, vals=out_val, shape=(a.m, b.n))
