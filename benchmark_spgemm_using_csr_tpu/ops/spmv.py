"""SpMV / SpMM on the shared CSR/BSR substrate (BASELINE.json:5 "also cover
SpMV/SpMM"; the reference itself has no SpMV — this is required new surface).

Two designs:
- CSR gather–multiply–segment-sum: bandwidth-bound, one fused XLA graph.
  Right for very sparse rows.
- BSR x dense via batched ``jnp.dot``: routes the FLOPs through dense
  (bm, bn) block matmuls — the path for blocky matrices.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..sparse.csr import BSR, CSR


@jax.jit
def spmv(a: CSR, x: jax.Array) -> jax.Array:
    """y = A @ x for dense x of shape (n,)."""
    prod = a.vals * x[a.colidx]
    return jax.ops.segment_sum(prod, a.row_ids(), num_segments=a.m + 1)[: a.m]


@jax.jit
def spmm(a: CSR, x: jax.Array) -> jax.Array:
    """Y = A @ X for dense X of shape (n, k)."""
    prod = a.vals[:, None] * x[a.colidx]
    return jax.ops.segment_sum(prod, a.row_ids(), num_segments=a.m + 1)[: a.m]


@jax.jit
def bsr_spmm(a: BSR, x: jax.Array) -> jax.Array:
    """Y = A @ X with A in BSR — each (bm, bn) block is one matmul of a
    batched dot over stored blocks, then a segment-sum over block rows."""
    bm, bn = a.block_shape
    mb = a.shape[0] // bm
    k = x.shape[1]
    xb = x.reshape(a.shape[1] // bn, bn, k)
    gathered = xb[a.colidx]  # (nnzb_cap, bn, k)
    partial_blocks = jnp.einsum(
        "zab,zbk->zak",
        a.blocks,
        gathered,
        preferred_element_type=jnp.float32
        if a.blocks.dtype in (jnp.bfloat16, jnp.float16)
        else a.blocks.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    from ..sparse.csr import row_ids_from_rowptr

    brow = row_ids_from_rowptr(a.rowptr, a.colidx.shape[0])
    summed = jax.ops.segment_sum(partial_blocks, brow, num_segments=mb + 1)[:mb]
    return summed.reshape(mb * bm, k)


@partial(jax.jit, static_argnames=("transpose_out_n",))
def spmv_t(a: CSR, y: jax.Array, transpose_out_n: int) -> jax.Array:
    """x = A^T @ y without materializing the transpose (scatter-add form)."""
    valid = a.row_ids() < a.m
    contrib = jnp.where(valid, a.vals * y[jnp.minimum(a.row_ids(), a.m - 1)], 0)
    return jnp.zeros(transpose_out_n, a.vals.dtype).at[a.colidx].add(
        jnp.where(valid, contrib, 0), mode="drop"
    )
