"""Exact sparse triangular solve (SpTRSV) — level-scheduled.

The reference repo is the SpGEMM benchmark of the bhSPARSE line, whose
kernel family also covers synchronization-free GPU SpTRSV; this is the
XLA counterpart. Those CUDA designs spin on per-row "ready" flags — not
expressible under XLA. Design:

- Host symbolic phase: compute each row's dependency *level* (longest
  chain in the triangular-solve DAG; `native/levels.cpp`, C++ with a
  numpy fallback). Rows of one level are independent.
- Device numeric phase: one `lax.scan` over a static row *stream* —
  rows sorted by level, each level padded to a multiple of the chunk
  width so no scan step mixes levels. Every step solves `chunk` rows at
  once: masked gather of the rows' entries (one packed (colidx, vals)
  table lookup — gathers are descriptor-bound, CLAUDE.md), dot with the
  already-solved x, divide by the diagonal, scatter-SET (sentinel rows
  drop). Static shapes throughout; the schedule is reusable across
  value updates on the same structure (the ILU0 use case).

Entries outside the requested triangle are ignored, so the combined LU
storage of an ILU0 factor can be solved directly (L = unit diag +
strictly-lower part, U = upper incl. diagonal).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, pad_bucket
from ..native.levels import csr_levels


@dataclasses.dataclass(frozen=True)
class TrsvPlan:
    """Static (hashable) shape/config info for one triangular structure."""

    m: int
    chunk: int
    n_steps: int
    maxlen: int
    lower: bool
    unit_diag: bool
    n_levels: int


@dataclasses.dataclass
class TrsvSchedule:
    """Plan + device arrays (row stream, diagonal positions)."""

    plan: TrsvPlan
    stream: jax.Array  # (n_steps * chunk,) int32 row ids, sentinel m = pad
    diag_pos: jax.Array  # (m,) int32 positions into vals (zeros if unit)


def make_trsv_plan(
    a: CSR, lower: bool = True, unit_diag: bool = False,
    chunk: int | None = None,
) -> TrsvSchedule:
    """Host symbolic phase: levels -> padded level-ordered row stream."""
    m, n = a.shape
    if m != n:
        raise ValueError(f"triangular solve needs a square matrix, got {a.shape}")
    rowptr = np.asarray(a.rowptr)[: m + 1]
    nnz = int(rowptr[-1])
    colidx = np.asarray(a.colidx)[:nnz]

    levels = csr_levels(rowptr, colidx, m, upper=not lower)
    n_levels = int(levels.max()) + 1 if m else 1

    if chunk is None:
        chunk = int(np.clip(pad_bucket(max(-(-m // max(n_levels, 1)), 1)), 8, 1024))
    counts = np.bincount(levels, minlength=n_levels)
    padded = -(-counts // chunk) * chunk
    offsets = np.concatenate([[0], np.cumsum(padded)])
    stream = np.full(int(offsets[-1]), m, np.int32)
    order = np.argsort(levels, kind="stable")  # rows sorted by level, asc row
    pos = offsets[levels[order]] + (
        np.arange(m) - np.concatenate([[0], np.cumsum(counts)])[levels[order]]
    )
    stream[pos] = order

    row_of = np.repeat(np.arange(m), np.diff(rowptr))
    diag_pos = np.zeros(m, np.int32)
    if not unit_diag:
        hit = np.flatnonzero(colidx == row_of)
        covered = np.zeros(m, bool)
        covered[row_of[hit]] = True
        if not covered.all():
            missing = int(np.flatnonzero(~covered)[0])
            raise ValueError(
                f"matrix is singular for SpTRSV: row {missing} has no "
                "stored diagonal entry (pass unit_diag=True for unit L)"
            )
        diag_pos[row_of[hit]] = hit
        dvals = np.asarray(a.vals)[:nnz][diag_pos]
        if not np.all(dvals != 0):
            bad = int(np.flatnonzero(dvals == 0)[0])
            raise ValueError(f"zero diagonal at row {bad}: matrix is singular")

    maxlen = pad_bucket(int(np.diff(rowptr).max()) if m else 1)
    plan = TrsvPlan(
        m=m, chunk=chunk, n_steps=stream.size // chunk, maxlen=maxlen,
        lower=lower, unit_diag=unit_diag, n_levels=n_levels,
    )
    return TrsvSchedule(
        plan=plan,
        stream=jnp.asarray(stream),
        diag_pos=jnp.asarray(diag_pos),
    )


@partial(jax.jit, static_argnames=("plan",))
def _solve(a: CSR, b, stream, diag_pos, plan: TrsvPlan):
    m = plan.m
    dt = jnp.promote_types(a.dtype, b.dtype)
    if not jnp.issubdtype(dt, jnp.floating):
        dt = jnp.float32
    bvec = b.astype(dt)
    vals = a.vals.astype(dt)
    nnz_cap = a.capacity
    if plan.unit_diag:
        dinv = jnp.ones((m,), dt)
    else:
        dinv = 1.0 / vals[diag_pos]

    # Packed (colidx, vals) table: one gather descriptor set per step
    # instead of two (gathers are descriptor-rate-bound, CLAUDE.md).
    pack = dt == jnp.float32
    if pack:
        table = jnp.stack(
            [a.colidx.astype(jnp.int32),
             jax.lax.bitcast_convert_type(vals, jnp.int32)],
            axis=1,
        )

    lane = jnp.arange(plan.maxlen, dtype=INDEX_DTYPE)
    multi_rhs = bvec.ndim == 2

    def step(x, rows):
        rvalid = rows < m
        r = jnp.where(rvalid, rows, 0)
        start = a.rowptr[r]
        length = a.rowptr[r + 1] - start
        pos = jnp.minimum(start[:, None] + lane[None, :], nnz_cap - 1)
        emask = lane[None, :] < length[:, None]
        if pack:
            g = table[pos]  # (chunk, maxlen, 2)
            cols = g[..., 0]
            v = jax.lax.bitcast_convert_type(g[..., 1], jnp.float32)
        else:
            cols = a.colidx[pos]
            v = vals[pos]
        intri = cols < r[:, None] if plan.lower else cols > r[:, None]
        keep = emask & intri
        if multi_rhs:
            contrib = jnp.where(keep[..., None], v[..., None] * x[cols], 0)
            s = contrib.sum(axis=1)  # (chunk, k)
            xi = (bvec[r] - s) * dinv[r][:, None]
        else:
            contrib = jnp.where(keep, v * x[cols], 0)
            s = contrib.sum(axis=1)
            xi = (bvec[r] - s) * dinv[r]
        rows_scatter = jnp.where(rvalid, rows, m)  # m is OOB -> dropped
        x = x.at[rows_scatter].set(xi, mode="drop")
        return x, None

    x0 = jnp.zeros_like(bvec)
    x, _ = jax.lax.scan(step, x0, stream.reshape(plan.n_steps, plan.chunk))
    return x


def sptrsv_planned(a: CSR, b, sched: TrsvSchedule):
    """Solve T x = b using a prebuilt schedule (values may differ from the
    plan-time matrix as long as the structure — and diagonal positions —
    are unchanged, e.g. successive ILU0 factors)."""
    return _solve(a, b, sched.stream, sched.diag_pos, plan=sched.plan)


def sptrsv(a: CSR, b, lower: bool = True, unit_diag: bool = False):
    """Exact triangular solve T x = b, where T is the lower (upper)
    triangle of ``a`` including the diagonal (or a unit diagonal).
    Host-facing: builds the level schedule, then runs the jitted solve."""
    return sptrsv_planned(a, b, make_trsv_plan(a, lower, unit_diag))


def ilu0_apply_exact(f: CSR, r, sched_l: TrsvSchedule | None = None,
                     sched_u: TrsvSchedule | None = None):
    """z = U^{-1} L^{-1} r on combined ILU0 storage ``f`` via two exact
    level-scheduled solves (the exact counterpart of models.ilu0's Jacobi
    ``ilu0_apply``)."""
    sched_l = sched_l or make_trsv_plan(f, lower=True, unit_diag=True)
    sched_u = sched_u or make_trsv_plan(f, lower=False)
    y = sptrsv_planned(f, r, sched_l)
    return sptrsv_planned(f, y, sched_u)
