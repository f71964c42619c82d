"""Structure-reuse numeric SpGEMM — recompute C = A @ B values when the
sparsity structures of A, B (and therefore C) are fixed.

The reference's 4-stage pipeline (SURVEY.md §4 [K]) re-derives C's
structure on every call because the benchmark treats each multiply as
independent. Production workloads that repeat a product on a fixed
pattern — AMG re-coarsening with updated operator values, iterative
refactorization, Jacobian refills on a fixed mesh — only need stage 3
(numeric) once the pattern is known: the cusparse ``spgemm_reuse`` /
MKL two-stage ("numeric phase with known pattern") capability.

Design: the host plan enumerates the full product stream
(every (A[i,k], B[k,j]) pair) *sorted by destination slot in C*, so the
device pass is completely sort-free and scatter-free:

- two value gathers (``a.vals[a_idx]``, ``b.vals[b_idx]``) build the
  product stream in destination order;
- one segmented associative scan (reset at precomputed segment starts)
  + a gather at the segment tails reduces each C slot's products; the
  log-depth pairwise combine keeps rounding error per-segment (a global
  cumsum-then-diff was measurably outside f32 golden tolerance on
  mixed-sign streams), while scan cost stays far below the
  gather-descriptor wall (CLAUDE.md);
- results land directly in C's final layout: no compaction pass at all.

Everything dynamic is resolved at plan time; the hot call is one jitted
dispatch with static shapes, reusable across any number of value
updates.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, pad_bucket
from .chunked import pad_gentle


@dataclasses.dataclass(frozen=True)
class NumericPlan:
    """Hashable statics for one (A-structure, B-structure) pair."""

    m: int
    n: int
    total: int  # exact intermediate-product count
    nnz_c: int  # exact nnz(C)
    prod_cap: int  # padded product-stream length
    out_cap: int  # padded C capacity


@dataclasses.dataclass
class NumericSchedule:
    """Plan + device arrays: the precomputed product->C mapping."""

    plan: NumericPlan
    a_idx: jax.Array  # (prod_cap,) int32 into a.vals, dest-sorted
    b_idx: jax.Array  # (prod_cap,) int32 into b.vals, dest-sorted
    starts: jax.Array  # (prod_cap,) bool, True at each segment start
    tails: jax.Array  # (out_cap,) int32 exclusive segment ends, pad=total
    rowptr: jax.Array  # (m+1,) C row pointers
    colidx: jax.Array  # (out_cap,) C column indices, pad=0


def make_numeric_plan(a: CSR, b: CSR) -> NumericSchedule:
    """Host symbolic phase: C pattern + dest-ordered product mapping.

    One-time O(total_products log) numpy work; the returned schedule is
    valid for any values placed in the same A/B sparsity structures.
    """
    m, k_dim = a.shape
    k2, n = b.shape
    if k_dim != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    a_rowptr = np.asarray(a.rowptr)[: m + 1].astype(np.int64)
    nnz_a = int(a_rowptr[-1])
    a_colidx = np.asarray(a.colidx)[:nnz_a].astype(np.int64)
    b_rowptr = np.asarray(b.rowptr)[: k2 + 1].astype(np.int64)
    nnz_b = int(b_rowptr[-1])
    b_colidx = np.asarray(b.colidx)[:nnz_b].astype(np.int64)

    a_row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(a_rowptr))
    lens = (b_rowptr[a_colidx + 1] - b_rowptr[a_colidx])  # products per A entry
    total = int(lens.sum())

    # Product stream in natural (A-entry-major) order.
    a_idx_nat = np.repeat(np.arange(nnz_a, dtype=np.int64), lens)
    starts = np.cumsum(lens) - lens
    b_idx_nat = (
        np.arange(total, dtype=np.int64)
        - np.repeat(starts, lens)
        + np.repeat(b_rowptr[a_colidx], lens)
    )
    i_prod = np.repeat(a_row_of, lens)
    j_prod = b_colidx[b_idx_nat]

    # C pattern from the structural product (scipy; canonical sorted cols).
    import scipy.sparse as sp

    pa = sp.csr_matrix(
        (np.ones(nnz_a, np.float64), a_colidx.astype(np.int32), a_rowptr),
        shape=(m, k_dim),
    )
    pb = sp.csr_matrix(
        (np.ones(nnz_b, np.float64), b_colidx.astype(np.int32), b_rowptr),
        shape=(k2, n),
    )
    pc = (pa @ pb).tocsr()
    pc.sort_indices()
    nnz_c = int(pc.nnz)

    # Global (row-major, col-sorted) C keys are strictly increasing, so a
    # single vectorized searchsorted maps every product to its C slot.
    c_row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(pc.indptr))
    c_key = c_row_of * n + pc.indices.astype(np.int64)
    dest = np.searchsorted(c_key, i_prod * n + j_prod)

    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=nnz_c)
    ends = np.cumsum(counts)

    prod_cap = pad_gentle(max(total, 8))
    out_cap = pad_bucket(max(nnz_c, 8))
    a_idx = np.zeros(prod_cap, np.int32)
    b_idx = np.zeros(prod_cap, np.int32)
    a_idx[:total] = a_idx_nat[order]
    b_idx[:total] = b_idx_nat[order]
    starts = np.ones(prod_cap, bool)  # pad slots: singleton segments
    if total:
        dest_sorted = dest[order]
        starts[1:total] = dest_sorted[1:] != dest_sorted[:-1]
    tails = np.full(out_cap, total, np.int64)  # pad tails masked to zero
    tails[:nnz_c] = ends
    colidx = np.zeros(out_cap, np.int32)
    colidx[:nnz_c] = pc.indices

    plan = NumericPlan(
        m=m, n=n, total=total, nnz_c=nnz_c, prod_cap=prod_cap, out_cap=out_cap
    )
    return NumericSchedule(
        plan=plan,
        a_idx=jnp.asarray(a_idx),
        b_idx=jnp.asarray(b_idx),
        starts=jnp.asarray(starts),
        tails=jnp.asarray(tails, INDEX_DTYPE),
        rowptr=jnp.asarray(pc.indptr, INDEX_DTYPE),
        colidx=jnp.asarray(colidx),
    )


@partial(jax.jit, static_argnames=("plan",))
def _numeric(a_vals, b_vals, a_idx, b_idx, starts, tails, plan: NumericPlan):
    dt = jnp.promote_types(a_vals.dtype, b_vals.dtype)
    valid = jnp.arange(plan.prod_cap, dtype=INDEX_DTYPE) < plan.total
    prod = jnp.where(
        valid, a_vals.astype(dt)[a_idx] * b_vals.astype(dt)[b_idx], 0
    )
    acc = dt if dt != jnp.bfloat16 else jnp.float32

    # Segmented inclusive scan: value carries reset at segment starts, so
    # the element at each segment tail holds that segment's sum.
    def comb(x, y):
        xf, xv = x
        yf, yv = y
        return xf | yf, yv + jnp.where(yf, 0, xv)

    _, s = jax.lax.associative_scan(comb, (starts, prod.astype(acc)))
    seg = s[jnp.maximum(tails - 1, 0)]
    c_valid = jnp.arange(plan.out_cap, dtype=INDEX_DTYPE) < plan.nnz_c
    return jnp.where(c_valid, seg, 0).astype(dt)


def spgemm_numeric(a: CSR, b: CSR, sched: NumericSchedule) -> CSR:
    """Numeric-only C = A @ B on a prebuilt structure plan.

    ``a``/``b`` may carry different values than at plan time but MUST have
    the exact sparsity structures the plan was built from (not checked on
    the hot path). Output structure is bitwise identical across calls.
    """
    c_vals = _numeric(
        a.vals, b.vals, sched.a_idx, sched.b_idx, sched.starts, sched.tails,
        plan=sched.plan,
    )
    return CSR(sched.rowptr, sched.colidx, c_vals, (sched.plan.m, sched.plan.n))


# ---------------------------------------------------------------------------
# Fused Galerkin triple product  RAP = R @ A @ P  on a fixed structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TriplePlan:
    """Hashable statics for one (R, A, P) structure triple."""

    m: int  # rows of RAP (= rows of R)
    n: int  # cols of RAP (= cols of P)
    total: int  # exact triple-product count
    nnz_c: int  # exact nnz(RAP)
    prod_cap: int
    out_cap: int
    nnz_r: int  # value-vector offsets for the concatenated gather table
    nnz_a: int


@dataclasses.dataclass
class TripleSchedule:
    plan: TriplePlan
    idx3: jax.Array  # (prod_cap, 3) int32 into concat(r.vals, a.vals, p.vals)
    starts: jax.Array  # (prod_cap,) bool segment starts (dest-sorted)
    tails: jax.Array  # (out_cap,) int32 exclusive segment ends
    rowptr: jax.Array  # (m+1,)
    colidx: jax.Array  # (out_cap,)


def make_triple_plan(
    r: CSR, a: CSR, p: CSR, max_products: int = 1 << 26
) -> TripleSchedule | None:
    """Host symbolic phase for the fused Galerkin product RAP = R @ A @ P.

    Enumerates every triple (R[q,i], A[i,k], P[k,j]) sorted by destination
    slot of RAP, so the device pass is ONE packed 3-wide value gather, one
    multiply, and one segmented scan — no sort, no scatter, no
    intermediate AP materialization. For aggregation-style P/R (one nnz
    per row/column, models/amg.py) the triple stream is exactly nnz(A)
    products — the chained two-SpGEMM pipeline it replaces streams,
    sorts and compacts ~2x that (VERDICT r3 next #5 / weak #5: the
    rap_poisson2d_256 point was latency-bound on two full pipelines).

    Returns None when the triple stream exceeds ``max_products`` (dense
    P/R blow the cartesian expansion — chain two NumericSchedules
    instead).
    """
    import scipy.sparse as sp

    mq, mi = r.shape
    mi2, mk = a.shape
    mk2, n = p.shape
    if mi != mi2 or mk != mk2:
        raise ValueError(f"chain mismatch: {r.shape} @ {a.shape} @ {p.shape}")

    a_rowptr = np.asarray(a.rowptr)[: mi + 1].astype(np.int64)
    nnz_a = int(a_rowptr[-1])
    a_colidx = np.asarray(a.colidx)[:nnz_a].astype(np.int64)
    p_rowptr = np.asarray(p.rowptr)[: mk + 1].astype(np.int64)
    nnz_p = int(p_rowptr[-1])
    p_colidx = np.asarray(p.colidx)[:nnz_p].astype(np.int64)
    r_rowptr = np.asarray(r.rowptr)[: mq + 1].astype(np.int64)
    nnz_r = int(r_rowptr[-1])
    r_colidx = np.asarray(r.colidx)[:nnz_r].astype(np.int64)

    # R by COLUMN i (CSC-style) with data = value indices into r.vals
    r_rows = np.repeat(np.arange(mq, dtype=np.int64), np.diff(r_rowptr))
    rT = sp.csr_matrix(
        (np.arange(nnz_r, dtype=np.int64), (r_colidx, r_rows)), shape=(mi, mq)
    )
    rT.sort_indices()
    rt_rowptr = rT.indptr.astype(np.int64)
    rt_q = rT.indices.astype(np.int64)  # RAP row per rT entry
    rt_vidx = rT.data.astype(np.int64)  # r.vals index per rT entry

    a_rows = np.repeat(np.arange(mi, dtype=np.int64), np.diff(a_rowptr))
    deg_r = (rt_rowptr[a_rows + 1] - rt_rowptr[a_rows])  # per A entry
    deg_p = (p_rowptr[a_colidx + 1] - p_rowptr[a_colidx])
    cnt = deg_r * deg_p
    total = int(cnt.sum())
    if total == 0 or total > max_products:
        return None

    e = np.repeat(np.arange(nnz_a, dtype=np.int64), cnt)  # A-entry id
    starts_e = np.cumsum(cnt) - cnt
    t = np.arange(total, dtype=np.int64) - starts_e[e]
    dpe = deg_p[e]
    ri = rt_rowptr[a_rows[e]] + t // dpe
    pi = p_rowptr[a_colidx[e]] + t % dpe

    q = rt_q[ri]
    j = p_colidx[pi]

    # RAP pattern (scipy; canonical) and destination mapping
    ones = lambda k: np.ones(k, np.float64)
    pr = sp.csr_matrix((ones(nnz_r), r_colidx.astype(np.int32), r_rowptr),
                       shape=(mq, mi))
    pa = sp.csr_matrix((ones(nnz_a), a_colidx.astype(np.int32), a_rowptr),
                       shape=(mi, mk))
    pp = sp.csr_matrix((ones(nnz_p), p_colidx.astype(np.int32), p_rowptr),
                       shape=(mk, n))
    pc = (pr @ (pa @ pp)).tocsr()
    pc.sort_indices()
    nnz_c = int(pc.nnz)
    c_row_of = np.repeat(np.arange(mq, dtype=np.int64), np.diff(pc.indptr))
    c_key = c_row_of * n + pc.indices.astype(np.int64)
    dest = np.searchsorted(c_key, q * n + j)

    order = np.argsort(dest, kind="stable")
    ends = np.cumsum(np.bincount(dest, minlength=nnz_c))

    prod_cap = pad_gentle(max(total, 8))
    out_cap = pad_bucket(max(nnz_c, 8))
    # packed 3-wide gather table into concat(r.vals, a.vals, p.vals):
    # ONE descriptor fetches all three operand values of a triple
    idx3 = np.zeros((prod_cap, 3), np.int32)
    idx3[:total, 0] = rt_vidx[ri][order]
    idx3[:total, 1] = nnz_r + e[order]
    idx3[:total, 2] = nnz_r + nnz_a + pi[order]
    starts = np.ones(prod_cap, bool)
    if total:
        ds = dest[order]
        starts[1:total] = ds[1:] != ds[:-1]
    tails = np.full(out_cap, total, np.int64)
    tails[:nnz_c] = ends
    colidx = np.zeros(out_cap, np.int32)
    colidx[:nnz_c] = pc.indices

    plan = TriplePlan(
        m=mq, n=n, total=total, nnz_c=nnz_c, prod_cap=prod_cap,
        out_cap=out_cap, nnz_r=nnz_r, nnz_a=nnz_a,
    )
    return TripleSchedule(
        plan=plan,
        idx3=jnp.asarray(idx3),
        starts=jnp.asarray(starts),
        tails=jnp.asarray(tails, INDEX_DTYPE),
        rowptr=jnp.asarray(pc.indptr, INDEX_DTYPE),
        colidx=jnp.asarray(colidx),
    )


@partial(jax.jit, static_argnames=("plan",))
def _triple_numeric(r_vals, a_vals, p_vals, idx3, starts, tails,
                    plan: TriplePlan):
    dt = jnp.promote_types(jnp.promote_types(r_vals.dtype, a_vals.dtype),
                           p_vals.dtype)
    cat = jnp.concatenate([
        r_vals.astype(dt)[: plan.nnz_r],
        a_vals.astype(dt)[: plan.nnz_a],
        p_vals.astype(dt),
    ])
    v3 = cat[idx3]  # (prod_cap, 3) — one packed descriptor per triple
    valid = jnp.arange(plan.prod_cap, dtype=INDEX_DTYPE) < plan.total
    prod = jnp.where(valid, v3[:, 0] * v3[:, 1] * v3[:, 2], 0)
    acc = dt if dt != jnp.bfloat16 else jnp.float32

    def comb(x, y):
        xf, xv = x
        yf, yv = y
        return xf | yf, yv + jnp.where(yf, 0, xv)

    _, s = jax.lax.associative_scan(comb, (starts, prod.astype(acc)))
    seg = s[jnp.maximum(tails - 1, 0)]
    c_valid = jnp.arange(plan.out_cap, dtype=INDEX_DTYPE) < plan.nnz_c
    return jnp.where(c_valid, seg, 0).astype(dt)


def spgemm_triple(r: CSR, a: CSR, p: CSR, sched: TripleSchedule) -> CSR:
    """Numeric-only RAP = R @ A @ P on a prebuilt triple plan (jit-able;
    single dispatch, no intermediate AP)."""
    vals = _triple_numeric(
        r.vals, a.vals, p.vals, sched.idx3, sched.starts, sched.tails,
        plan=sched.plan,
    )
    return CSR(sched.rowptr, sched.colidx, vals, (sched.plan.m, sched.plan.n))
