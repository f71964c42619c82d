"""Aggregation-structured Galerkin triple product R·A·P in ONE tiny
dispatch — the structural fast path VERDICT r4 #7 asked for.

When P is a *piecewise-constant aggregation* prolongator (exactly one
nonzero per row — what models/amg.aggregation_prolongator builds, and the
standard smoothed-aggregation setup's tentative P) and R is its
transpose-shape (exactly one nonzero per COLUMN), the Galerkin product

    C[I, J] = sum_{i,j} R[I, i] * A[i, j] * P[j, J]

is a *relabel-and-merge* of A's entries: every A entry (i, j, v)
contributes ``rv[i] * v * pv[j]`` to C[aggR(i), aggP(j)] — there is no
product expansion at all (each A entry meets exactly one R entry and one
P entry). The general triple pipeline (ops/reuse.spgemm_triple) is
bound by its ~3 arbitrary-index gathers per product; here EVERYTHING positional is known at
plan time, so the hot path has ZERO arbitrary-index gathers:

- destination keys ``(I << cbits) | J`` and the scale constants
  ``rv[i] * pv[j]`` are device CONSTANTS in A's CSR entry order;
- placement is ONE contiguous copy (the whole entry stream) — no
  per-entry descriptors anywhere. (A grouped 2D layout was designed and
  rejected: mesh aggregates span +/-k fine rows via vertical neighbors,
  so NO interior fine-row cut is aggregate-complete — measured on
  poisson2d(48): 2 of 2305 candidate cuts valid, both trivial — and any
  non-contiguous placement costs exactly the per-entry gather this path
  exists to avoid);
- ONE ``lax.sort`` over the padded stream with u32 keys,
  ``is_stable=False`` (duplicates merge by SUM);
- the fused block-scan runsum+compaction tail (ops/scancompact);
- C's rowptr (and structure) are plan constants — only values are
  computed, exactly like ops/reuse's numeric-phase contract.

Reference mapping (SURVEY.md §9 step 8, BASELINE.json config #3): the
reference has no AMG; this implements the Galerkin demo's hot product
with the structure exploitation its own stage-2 binning philosophy
(route each regime to its cheapest kernel) demands.

Gates (return None from make_aggrap_plan): non-aggregation R/P, f64
values (the 2D sort would need the dd lane — fall back to spgemm_triple),
key bits > 32, or no valid group cuts.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, host_view
from .chunked import pad_gentle

SENTINEL_U32 = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class AggRapPlan:
    """Hashable statics for one (R, A-structure, P) triple."""

    w: int  # padded entry-stream slots
    nnz_a: int  # live entries (one contiguous copy)
    out_cap: int  # padded nnz(C)
    nnz_c: int  # exact nnz(C)
    cbits: int  # coarse-column bits in the packed key
    max_run: int  # pow2 bound on any C entry's contributor count
    m_c: int  # coarse rows
    n_c: int  # coarse cols


@dataclasses.dataclass
class AggRapSchedule:
    plan: AggRapPlan
    keys: jax.Array  # (w,) uint32 const keys (sentinel padding)
    scale: jax.Array  # (w,) f32 const rv[i]*pv[j] (0 at padding)
    rowptr: jax.Array  # (m_c + 1,) int32 const coarse rowptr


def _aggregation_maps(mat_sp, axis: str):
    """(agg, val) when the matrix is an aggregation operator along
    ``axis`` ('row': one nnz per row, maps row->col; 'col': one nnz per
    column, maps col->row), else None."""
    import scipy.sparse as sp

    if axis == "col":
        m = sp.csr_matrix(mat_sp.T)
    else:
        m = sp.csr_matrix(mat_sp)
    if m.nnz != m.shape[0] or np.any(np.diff(m.indptr) != 1):
        return None
    return m.indices.astype(np.int64), m.data


def make_aggrap_plan(r: CSR, a: CSR, p: CSR) -> AggRapSchedule | None:
    """Host plan: detect aggregation structure, relabel A's entries to
    coarse (I, J) keys, and precompute C's structure exactly."""
    if a.vals.dtype != jnp.float32:
        return None
    p_maps = _aggregation_maps(p.to_scipy(), "row")
    r_maps = _aggregation_maps(r.to_scipy(), "col")
    if p_maps is None or r_maps is None:
        return None
    agg_p, pv = p_maps
    agg_r, rv = r_maps
    m_c, n_c = r.m, p.n
    nf_r, nf_c = a.shape
    if agg_r.shape[0] != nf_r or agg_p.shape[0] != nf_c:
        return None
    cbits = max(int(n_c - 1).bit_length(), 1)
    ibits = max(int(m_c - 1).bit_length(), 1)
    if ibits + cbits > 32:
        return None

    rowptr_a = host_view(a.rowptr)[: nf_r + 1].astype(np.int64)
    nnz_a = int(rowptr_a[-1])
    if nnz_a == 0 or nnz_a > (1 << 23):  # scan-tail fusion-guard margin
        return None
    colidx_a = host_view(a.colidx)[:nnz_a].astype(np.int64)
    rows_a = np.repeat(np.arange(nf_r), np.diff(rowptr_a))
    key_i = agg_r[rows_a]
    key_j = agg_p[colidx_a]
    scale = (rv[rows_a] * pv[colidx_a]).astype(np.float32)

    w = pad_gentle(nnz_a, minimum=8)
    keys = np.full(w, SENTINEL_U32, np.uint32)
    keys[:nnz_a] = ((key_i << cbits) | key_j).astype(np.uint32)
    scale_p = np.zeros(w, np.float32)
    scale_p[:nnz_a] = scale

    # ---- exact C structure (plan constants) ----------------------------
    uniq, counts = np.unique(keys[:nnz_a], return_counts=True)
    nnz_c = int(uniq.shape[0])
    max_run = 1 << max(int(counts.max() - 1).bit_length(), 0)
    rows_c = (uniq >> cbits).astype(np.int64)
    rowptr_c = np.zeros(m_c + 1, np.int64)
    np.add.at(rowptr_c, rows_c + 1, 1)
    rowptr_c = np.cumsum(rowptr_c)

    plan = AggRapPlan(
        w=int(w),
        nnz_a=nnz_a,
        out_cap=min(pad_gentle(max(nnz_c, 1)), int(w)),
        nnz_c=nnz_c,
        cbits=cbits,
        max_run=int(max_run),
        m_c=m_c,
        n_c=n_c,
    )
    return AggRapSchedule(
        plan=plan,
        keys=jnp.asarray(keys),
        scale=jnp.asarray(scale_p),
        rowptr=jnp.asarray(rowptr_c.astype(np.int32)),
    )


def rap_aggregation(a: CSR, sched: AggRapSchedule) -> CSR:
    """C = R·A·P for NEW VALUES of A on the planned structure (the
    numeric-refresh contract: structure is a plan constant)."""
    return _rap_aggregation(
        a.vals, sched.keys, sched.scale, sched.rowptr, sched.plan
    )


@partial(jax.jit, static_argnames=("plan",))
def _rap_aggregation(vals, keys, scale, rowptr, plan: AggRapPlan) -> CSR:
    from .scancompact import runsum_compact_scan

    w = plan.w
    buf = jnp.zeros((w,), vals.dtype)
    buf = jax.lax.dynamic_update_slice(
        buf, jax.lax.dynamic_slice(vals, (0,), (plan.nnz_a,)), (0,)
    )
    val = buf * scale
    okey, oval = jax.lax.sort(
        (keys, val), dimension=0, num_keys=1, is_stable=False
    )
    keyc, valc, _ = runsum_compact_scan(
        okey, oval, w=w, out_cap=plan.out_cap, max_run=plan.max_run,
    )
    oc = jnp.arange(plan.out_cap, dtype=INDEX_DTYPE)
    live = oc < plan.nnz_c
    out_col = jnp.where(
        live,
        (keyc.astype(jnp.uint32) & ((1 << plan.cbits) - 1)).astype(
            INDEX_DTYPE
        ),
        0,
    )
    out_val = jnp.where(live, valc.astype(vals.dtype), 0)
    return CSR(
        rowptr=rowptr, colidx=out_col, vals=out_val,
        shape=(plan.m_c, plan.n_c),
    )
