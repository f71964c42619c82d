"""Stage 1 — symbolic pass: per-row intermediate-product upper bounds.

Reference behavior (SURVEY.md §4 stage 1; kernel ``compute_nnzCt_*`` in
bhsparse_cuda.h [R]): for each row i of C,
``nnzCt[i] = sum_{j in cols(A[i,:])} nnz(B[j,:])``.

Design: a gather of B row lengths at A's column indices followed by a
segment-sum over A's row ids — two fused XLA ops, no kernel launch per row.
``2 * sum(nnzCt)`` is the canonical flop count used for GFlops
(BASELINE.md metric definitions).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..sparse.csr import CSR, INDEX_DTYPE


def products_per_nz(a: CSR, b: CSR) -> jax.Array:
    """Intermediate products contributed by each stored entry of A.

    Shape (a.capacity,); padding slots contribute 0.
    """
    b_len = b.row_lengths()
    per_nz = b_len[a.colidx]
    valid = a.row_ids() < a.m
    return jnp.where(valid, per_nz, 0).astype(INDEX_DTYPE)


def nnz_upper_bound(a: CSR, b: CSR) -> jax.Array:
    """Per-row intermediate-product count nnzCt, shape (m,)."""
    per_nz = products_per_nz(a, b)
    return jax.ops.segment_sum(per_nz, a.row_ids(), num_segments=a.m + 1)[: a.m]


def total_products(a: CSR, b: CSR) -> jax.Array:
    """Total intermediate products (== flops / 2)."""
    return jnp.sum(products_per_nz(a, b))


def flops(a: CSR, b: CSR) -> jax.Array:
    """Canonical SpGEMM flop count: one mul + one add per product."""
    return 2 * total_products(a, b).astype(jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)


def nnz_exact(a: CSR, b: CSR, prod_capacity: int) -> jax.Array:
    """Exact per-row nnz(C) — the symbolic-exact variant (SURVEY.md §9
    step 3): materialize (row, col) product keys (values untouched), sort,
    and count unique keys per row. Costs one 2-key sort of the product
    stream; use when the stage-1 upper bound over-allocates badly (highly
    overlapping rows)."""
    from .esc import gather_products

    m = a.m
    total = total_products(a, b)
    p = jnp.arange(prod_capacity, dtype=INDEX_DTYPE)
    valid = p < total
    src_c, col, _ = gather_products(a, b, jnp.where(valid, p, 0), valid)
    row = jnp.where(valid, a.row_ids()[src_c], m).astype(INDEX_DTYPE)
    row, col = jax.lax.sort((row, col), num_keys=2, is_stable=False)
    prev_row = jnp.concatenate([jnp.full((1,), -1, row.dtype), row[:-1]])
    prev_col = jnp.concatenate([jnp.full((1,), -1, col.dtype), col[:-1]])
    is_head = (row < m) & ((row != prev_row) | (col != prev_col))
    return jax.ops.segment_sum(
        is_head.astype(INDEX_DTYPE), row, num_segments=m + 1
    )[:m]
