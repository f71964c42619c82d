"""Hash-path numeric kernel — a re-design of the reference's
hash/merge method for long power-law rows (BASELINE.json config #4
"mouse_gene / dense-ish power-law matrix (long rows, hash-kernel path)";
SURVEY.md §9 step 5 "hash-path variant ... per-row hash table").

On a GPU the hash method builds a per-row open-addressing table in shared
memory with linear probing. Here the table is the *perfect* hash — a dense accumulator row of width
n in HBM — so no probing is needed:

    acc[r, col] += val        (one scatter-add over all products)
    occ[r, col] |= True       (structural-occupancy mask)

followed by a per-row prefix-sum compaction of the occupied slots back into
CSR. No sort anywhere: total work is O(F) scatter + O(R * n) sweep, versus
the ESC path's O(F log F) sort — a clear win whenever rows are long/dense-ish
(F large) and n is moderate, exactly the power-law regime the hash method
targets in the reference.

The occupancy mask (not ``acc != 0``) preserves structural zeros produced by
numeric cancellation, matching CSR SpGEMM semantics of the golden path.

Memory: each row tile costs R * n * (itemsize + 1) bytes in HBM; ``spgemm_hash``
picks R from a byte budget and loops tiles host-side (the same
host-orchestration pattern as the binned dispatcher).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, csr_gather_rows, pad_bucket
from .esc import gather_products
from .symbolic import nnz_upper_bound


@partial(jax.jit, static_argnames=("prod_cap", "out_width"))
def _hash_numeric_tile(a_tile: CSR, b: CSR, *, prod_cap: int, out_width: int):
    """Dense-accumulator numeric kernel for one row tile.

    a_tile: CSR of the tile's rows (shape (R, k), from csr_gather_rows).
    Returns (cols, vals, counts): (R, out_width) compacted unique columns in
    ascending order, merged values, and exact per-row nnzC.
    """
    r, _ = a_tile.shape
    n = b.n

    total = jnp.sum(
        jnp.where(a_tile.row_ids() < r, b.row_lengths()[a_tile.colidx], 0)
    )
    g = jnp.arange(prod_cap, dtype=INDEX_DTYPE)
    valid = g < total
    src, col, val = gather_products(a_tile, b, jnp.where(valid, g, 0), valid)
    row = jnp.minimum(a_tile.row_ids()[src], r - 1)
    row_s = jnp.where(valid, row, r)  # sentinel row drops out of the scatter

    acc = jnp.zeros((r, n), a_tile.vals.dtype).at[row_s, col].add(
        val, mode="drop"
    )
    occ = jnp.zeros((r, n), jnp.bool_).at[row_s, col].set(True, mode="drop")

    pos = jnp.cumsum(occ.astype(INDEX_DTYPE), axis=1) - 1
    counts = jnp.sum(occ, axis=1).astype(INDEX_DTYPE)

    row2d = jax.lax.broadcasted_iota(INDEX_DTYPE, (r, n), 0)
    col2d = jax.lax.broadcasted_iota(INDEX_DTYPE, (r, n), 1)
    tgt = jnp.where(occ, pos, out_width)
    cols = (
        jnp.zeros((r, out_width), INDEX_DTYPE).at[row2d, tgt].set(col2d, mode="drop")
    )
    vals = (
        jnp.zeros((r, out_width), a_tile.vals.dtype)
        .at[row2d, tgt]
        .set(acc, mode="drop")
    )
    return cols, vals, counts


def hash_tile_rows(
    a: CSR, b: CSR, rows: np.ndarray, nnz_ct: np.ndarray
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Run the dense-accumulator kernel on an arbitrary row subset.

    rows: concrete int array of row indices (no sentinels).
    Returns device (cols, vals, counts) tiles; width = pad_bucket(min(max
    nnzCt, n)).
    """
    m = a.m
    rows_pad = np.full(pad_bucket(rows.size), m, np.int32)
    rows_pad[: rows.size] = rows
    rowptr = np.asarray(a.rowptr)
    nnz_a_rows = int(rowptr[rows + 1].sum() - rowptr[rows].sum())
    a_tile = csr_gather_rows(a, jnp.asarray(rows_pad), pad_bucket(nnz_a_rows))
    prod_cap = pad_bucket(int(nnz_ct[rows].sum()))
    out_width = pad_bucket(min(int(nnz_ct[rows].max(initial=1)), b.n))
    cols, vals, counts = _hash_numeric_tile(
        a_tile, b, prod_cap=prod_cap, out_width=out_width
    )
    return cols, vals, counts


def spgemm_hash(
    a: CSR,
    b: CSR,
    tile_bytes_budget: int = 512 * 1024 * 1024,
    out_capacity: int | None = None,
) -> CSR:
    """Full SpGEMM via the dense-accumulator hash path (host-orchestrated).

    Routes every non-empty row through dense-accumulator tiles; rows are
    processed in tiles of R rows where R * n * (itemsize + 4) fits the HBM
    byte budget. Right for power-law / dense-ish matrices; for very large n
    with short rows prefer the binned path.
    """
    m, n = a.m, b.n
    itemsize = np.dtype(a.vals.dtype).itemsize
    r_tile = max(int(tile_bytes_budget // (n * (itemsize + 4 + 4))), 8)
    r_tile = min(pad_bucket(r_tile), pad_bucket(m))

    nnz_ct = np.asarray(jax.jit(nnz_upper_bound)(a, b))
    nonempty = np.nonzero(nnz_ct > 0)[0].astype(np.int32)

    pieces = []
    for lo in range(0, nonempty.size, r_tile):
        rows = nonempty[lo : lo + r_tile]
        cols_t, vals_t, counts = hash_tile_rows(a, b, rows, nnz_ct)
        rows_pad = np.full(pad_bucket(rows.size), m, np.int32)
        rows_pad[: rows.size] = rows
        pieces.append((jnp.asarray(rows_pad), cols_t, vals_t, counts))

    from .binned import _counts_add, _rowptr_from_counts, _scatter_bin

    counts_full = jnp.zeros(m, INDEX_DTYPE)
    for rows_dev, _, _, counts in pieces:
        counts_full = _counts_add(counts_full, rows_dev, counts)
    rowptr = _rowptr_from_counts(counts_full)

    nnz_c_bound = int(np.asarray(counts_full).sum())
    out_capacity = out_capacity or pad_bucket(nnz_c_bound)
    colidx_buf = jnp.zeros(out_capacity, INDEX_DTYPE)
    vals_buf = jnp.zeros(out_capacity, a.vals.dtype)
    for rows_dev, cols_t, vals_t, counts in pieces:
        colidx_buf, vals_buf = _scatter_bin(
            colidx_buf, vals_buf, rowptr, rows_dev, cols_t, vals_t, counts
        )
    return CSR(rowptr=rowptr, colidx=colidx_buf, vals=vals_buf, shape=(m, n))
