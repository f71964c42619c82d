"""Tiled single-dispatch SpGEMM for uniform-short-row matrices — the
stencil/FEM regime (poisson2d, cant/consph analogues) where every row's
intermediate-product count fits one narrow power-of-two width.

This is the reference's small-bin (heap-method) regime in ONE dispatch:
gather each row's products into an (m, W) lane tile (scatter+cumsum entry
map, packed gathers — the chunked expansion machinery), then run the
per-row sort + segmented-merge + position pass
(ops/sortmerge.bin_sort_compress) over all rows at once, and scatter
run-tails straight into C. No global product sort at all: per-row W-lane
networks replace the two full-stream sorts of the chunked path — the win
when W is small and fill is high (uniform rows).

Dispatched automatically by the facade when pad_bucket(max nnzCt) <= 64 and
mean fill >= 30%; the chunked path remains the general fallback.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, pad_bucket
from .chunked import pad_gentle
from .symbolic import nnz_upper_bound

F32 = jnp.float32


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    width: int  # lane width (pow2) >= max nnzCt
    prod_cap: int  # padded total products (entry-map domain)
    out_cap: int  # padded nnzC bound


def make_tiled_plan(a: CSR, b: CSR, max_width: int = 512) -> TiledPlan | None:
    """Returns a plan, or None when this matrix doesn't fit the regime."""
    nnz_ct = np.asarray(jax.jit(nnz_upper_bound)(a, b))
    mx = int(nnz_ct.max(initial=0))
    if mx == 0:
        return None
    width = pad_bucket(mx)
    if width > max_width:
        return None
    total = int(nnz_ct.sum())
    fill = total / (a.m * width)
    if fill < 0.3:
        return None
    return TiledPlan(
        width=width,
        prod_cap=pad_gentle(total),
        out_cap=pad_gentle(int(np.minimum(nnz_ct, b.n).sum())),
    )


@partial(jax.jit, static_argnames=("plan",))
def spgemm_tiled(a: CSR, b: CSR, plan: TiledPlan) -> CSR:
    """C = A @ B in one dispatch via per-row lane tiles + per-row sorts."""
    from .sortmerge import bin_sort_compress

    m, n = a.m, b.n
    W = plan.width

    # --- stage 1 + entry map (scatter+cumsum; see ops/chunked.py) ----------
    b_len = b.row_lengths().astype(INDEX_DTYPE)
    a_rows = a.row_ids()
    entry_valid = a_rows < m
    per_nz = jnp.where(entry_valid, b_len[a.colidx], 0).astype(INDEX_DTYPE)
    ends = jnp.cumsum(per_nz)
    starts = ends - per_nz
    hits = jnp.zeros(plan.prod_cap, INDEX_DTYPE).at[starts].add(1, mode="drop")
    src = jnp.clip(jnp.cumsum(hits) - 1, 0, a.capacity - 1)

    nnz_ct = jax.ops.segment_sum(per_nz, a_rows, num_segments=m + 1)[:m]
    prodstart = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(nnz_ct).astype(INDEX_DTYPE)]
    )

    # --- expansion into the (m, W) lane tile -------------------------------
    lane = jnp.arange(W, dtype=INDEX_DTYPE)
    valid = lane[None, :] < nnz_ct[:, None]
    g = jnp.clip(prodstart[:m, None] + lane[None, :], 0, plan.prod_cap - 1)
    e = src[g]  # (m, W) A-entry ids
    # packed per-entry meta: (a_val bitcast, delta = b_start - prod_start)
    meta = jnp.stack(
        [
            jax.lax.bitcast_convert_type(a.vals.astype(F32), jnp.int32),
            (b.rowptr[a.colidx].astype(jnp.int32) - starts),
        ],
        axis=1,
    )
    meta_t = meta[e]  # (m, W, 2)
    a_val = jax.lax.bitcast_convert_type(meta_t[:, :, 0], F32)
    bpos = jnp.clip(g + meta_t[:, :, 1], 0, b.capacity - 1)
    b_packed = jnp.stack(
        [
            b.colidx.astype(jnp.int32),
            jax.lax.bitcast_convert_type(b.vals.astype(F32), jnp.int32),
        ],
        axis=1,
    )
    tile = b_packed[bpos]  # (m, W, 2)
    col = jnp.where(valid, tile[:, :, 0], n)
    val = jnp.where(valid, jax.lax.bitcast_convert_type(tile[:, :, 1], F32)
                    * a_val, 0.0)

    # --- per-row sort + merge + positions ----------------------------------
    cols_t, vals_t, pos, counts = bin_sort_compress(col, val, n_sentinel=n)

    # --- stage 4: rowptr + pos-scatter compaction --------------------------
    rowptr = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(counts).astype(INDEX_DTYPE)]
    )
    in_tile = pos < W
    tgt = jnp.where(in_tile, rowptr[:m, None] + pos, plan.out_cap)
    colidx_buf = jnp.zeros(plan.out_cap, INDEX_DTYPE).at[tgt].set(
        cols_t, mode="drop"
    )
    vals_buf = jnp.zeros(plan.out_cap, a.vals.dtype).at[tgt].set(
        vals_t.astype(a.vals.dtype), mode="drop"
    )
    return CSR(rowptr=rowptr, colidx=colidx_buf, vals=vals_buf, shape=(m, n))
