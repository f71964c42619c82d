"""Stage 2+3 — binned numeric path: a re-design of the reference's
heap / bitonic-ESC / merge trio (SURVEY.md §4).

The reference bins rows by intermediate-product count into 38 bins and
dispatches three GPU methods (heap for small rows, bitonic ESC in shared
memory for mid rows, merge-path in global memory for long rows). This
re-design keeps the *binning* idea — it is the load-balancing story — but
replaces all three methods with one shape-specialized primitive: gather each
bin's rows into a dense (rows x width) tile, sort every row along the lane
axis with XLA's batched sort, and compress duplicates with a per-row
segmented scan (ops/sortmerge.bin_sort_compress) — BASELINE.json:5: "tile
CSR rows into dense blocks with segmented-scan merges instead of per-thread
heaps".

Rows whose product count exceeds the largest tile width go through the
global ESC sort on just their products (the merge-method analogue); rows
with zero products are never touched.

Cost intuition: sorting R rows of width W costs R * W log W, versus the
global path's F log F with F = sum of all products — binning wins by the
log-factor *and* by sorting 2-tuples per row instead of 3-tuples globally.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, csr_gather_rows, pad_bucket
from .esc import gather_products, spgemm_esc_padded
from .sortmerge import bin_sort_compress
from .symbolic import nnz_upper_bound

DEFAULT_WIDTHS = (8, 32, 128, 512)

_nnz_upper_bound = jax.jit(nnz_upper_bound)


@partial(jax.jit, static_argnames=("width",))
def _bin_numeric(a: CSR, b: CSR, rows, nnz_ct, prodstart, *, width: int):
    """Numeric kernel for one bin: rows with 1 <= nnzCt <= width.

    rows: (r_pad,) row indices, padded with sentinel a.m.
    Returns (cols_tile, vals_tile, counts): per-row sorted unique columns,
    merged values, and exact per-row nnzC.
    """
    m, n = a.m, b.n  # sentinel col must exceed every valid B column
    r_pad = rows.shape[0]
    rows_c = jnp.minimum(rows, m - 1)
    in_range = rows < m
    lens = jnp.where(in_range, nnz_ct[rows_c], 0)
    start = jnp.where(in_range, prodstart[rows_c], 0)

    lane = jnp.arange(width, dtype=INDEX_DTYPE)
    valid = lane[None, :] < lens[:, None]
    g = start[:, None] + lane[None, :]
    _, col, val = gather_products(a, b, jnp.where(valid, g, 0), valid)

    col = jnp.where(valid, col, n)  # sentinel sorts to the end of each row
    cols_t, vals_t, pos, counts = bin_sort_compress(col, val, n_sentinel=n)
    # compact each row's run tails to its first counts[r] lanes
    row2d = jax.lax.broadcasted_iota(INDEX_DTYPE, (r_pad, width), 0)
    out_cols = jnp.zeros((r_pad, width), INDEX_DTYPE).at[row2d, pos].set(
        cols_t, mode="drop"
    )
    out_vals = jnp.zeros((r_pad, width), val.dtype).at[row2d, pos].set(
        vals_t, mode="drop"
    )
    return out_cols, out_vals, counts


@jax.jit
def _scatter_bin(colidx_buf, vals_buf, rowptr, rows, cols_t, vals_t, counts):
    """Stage-4 compaction for one bin: copy each row's unique entries into
    the final CSR at rowptr[row]. (copyCt2C analogue, SURVEY.md §4 stage 4)."""
    out_capacity = colidx_buf.shape[0]
    width = cols_t.shape[1]
    lane = jnp.arange(width, dtype=INDEX_DTYPE)
    valid = lane[None, :] < counts[:, None]
    base = rowptr[rows]  # rows padded with m -> rowptr[m] is fine, masked out
    tgt = jnp.where(valid, base[:, None] + lane[None, :], out_capacity)
    colidx_buf = colidx_buf.at[tgt].set(cols_t, mode="drop")
    vals_buf = vals_buf.at[tgt].set(vals_t, mode="drop")
    return colidx_buf, vals_buf


@jax.jit
def _scatter_tail(colidx_buf, vals_buf, rowptr, tail_rows, c_tail: CSR):
    """Copy the long-row tail product (computed as a compact sub-matrix via
    global ESC) into the final CSR."""
    out_capacity = colidx_buf.shape[0]
    r_tail = c_tail.m
    local_row = c_tail.row_ids()  # (cap,), padding -> r_tail
    local_row_c = jnp.minimum(local_row, r_tail - 1)
    valid = local_row < r_tail
    offset = jnp.arange(c_tail.capacity, dtype=INDEX_DTYPE) - c_tail.rowptr[local_row_c]
    orig = tail_rows[local_row_c]
    tgt = jnp.where(valid, rowptr[orig] + offset, out_capacity)
    colidx_buf = colidx_buf.at[tgt].set(c_tail.colidx, mode="drop")
    vals_buf = vals_buf.at[tgt].set(c_tail.vals, mode="drop")
    return colidx_buf, vals_buf


@jax.jit
def _counts_add(counts_full, rows, counts):
    return counts_full.at[rows].add(counts, mode="drop")


@jax.jit
def _rowptr_from_counts(counts_full):
    return jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(counts_full).astype(INDEX_DTYPE)]
    )


def make_plan(nnz_ct: np.ndarray, widths=DEFAULT_WIDTHS):
    """Host-side stage 2: assign rows to width bins. Returns
    {width: padded row-index array} plus the long-row tail rows.

    The reference runs binning on the host too (SURVEY.md §5.2 stage 2).
    Padded to power-of-two buckets so per-bin jit shapes are reused across
    matrices of similar profile.
    """
    m = nnz_ct.shape[0]
    bins = {}
    prev = 0
    for w in widths:
        mask = (nnz_ct > prev) & (nnz_ct <= w)
        rows = np.nonzero(mask)[0].astype(np.int32)
        if rows.size:
            padded = np.full(pad_bucket(rows.size), m, np.int32)
            padded[: rows.size] = rows
            bins[w] = padded
        prev = w
    tail = np.nonzero(nnz_ct > widths[-1])[0].astype(np.int32)
    return bins, tail


def spgemm_binned_host(
    a: CSR,
    b: CSR,
    prod_capacity: int,
    out_capacity: int | None = None,
    widths=DEFAULT_WIDTHS,
) -> CSR:
    """Full binned SpGEMM (host-orchestrated over jitted stages)."""
    m, n = a.m, b.n
    out_capacity = out_capacity or prod_capacity
    nnz_ct_dev = _nnz_upper_bound(a, b)
    nnz_ct = np.asarray(nnz_ct_dev)
    prodstart_dev = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(nnz_ct_dev).astype(INDEX_DTYPE)]
    )

    bins, tail = make_plan(nnz_ct, widths)

    pieces = []
    for w, rows in bins.items():
        rows_dev = jnp.asarray(rows)
        cols_t, vals_t, counts = _bin_numeric(
            a, b, rows_dev, nnz_ct_dev, prodstart_dev, width=w
        )
        pieces.append((rows_dev, cols_t, vals_t, counts))

    c_tail = None
    tail_dev = None
    if tail.size:
        tail_dev = jnp.asarray(tail)
        nnz_a_tail = int(
            np.asarray(a.rowptr)[tail + 1].sum() - np.asarray(a.rowptr)[tail].sum()
        )
        a_tail = csr_gather_rows(a, tail_dev, pad_bucket(nnz_a_tail))
        prod_tail = pad_bucket(int(nnz_ct[tail].sum()))
        c_tail = spgemm_esc_padded(a_tail, b, prod_tail, prod_tail)

    counts_full = jnp.zeros(m, INDEX_DTYPE)
    for rows_dev, _, _, counts in pieces:
        counts_full = _counts_add(counts_full, rows_dev, counts)
    if c_tail is not None:
        counts_full = _counts_add(
            counts_full, tail_dev, c_tail.row_lengths().astype(INDEX_DTYPE)
        )
    rowptr = _rowptr_from_counts(counts_full)

    colidx_buf = jnp.zeros(out_capacity, INDEX_DTYPE)
    vals_buf = jnp.zeros(out_capacity, a.vals.dtype)
    for rows_dev, cols_t, vals_t, counts in pieces:
        colidx_buf, vals_buf = _scatter_bin(
            colidx_buf, vals_buf, rowptr, rows_dev, cols_t, vals_t, counts
        )
    if c_tail is not None:
        colidx_buf, vals_buf = _scatter_tail(
            colidx_buf, vals_buf, rowptr, tail_dev, c_tail
        )
    return CSR(rowptr=rowptr, colidx=colidx_buf, vals=vals_buf, shape=(m, n))
