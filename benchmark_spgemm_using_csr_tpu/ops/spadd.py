"""Sparse matrix addition C = alpha*A + beta*B on CSR — csrgeam parity.

The reference repo is SpGEMM-only, but its parent bhSPARSE project ships
the full CSR kernel family (SpMV / SpGEMM / addition); sparse addition is
also what AMG setup uses to assemble I + omega*S smoothers. Design:
addition is a degenerate merge — concatenate the two operands'
(row, col, val) streams and reuse the chunked pipeline's sort-merge core
(ops/chunked.merge_products), where every (row, col) run has length <= 2,
so the segmented run-sum is a single shift-add pass. One dispatch, static
shapes from a frozen AddPlan (same growth-bucket convention as ChunkedPlan).

Requires canonical CSR inputs (sorted, duplicate-free columns per row —
what CSR.validate()/from_scipy produce); a duplicated column inside ONE
operand would break the max_run=2 bound.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE
from .chunked import _rc_pack_bits, merge_products, pad_gentle


@dataclasses.dataclass(frozen=True)
class AddPlan:
    """Static capacities for one (A, B) structural profile."""

    out_cap: int
    pack_u32: bool = False
    disp_bits: int = 0


def make_add_plan(a: CSR, b: CSR) -> AddPlan:
    """One host sync; exact union size via a boolean host-side add (cheap —
    O(nnz), same gate as make_chunked_plan's duplicate bound)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} + {b.shape}")
    nnz_a = int(np.asarray(a.rowptr)[-1])
    nnz_b = int(np.asarray(b.rowptr)[-1])
    total = nnz_a + nnz_b
    disp_bits = 0
    union = min(total, a.m * a.n)
    if 0 < total <= (1 << 27):
        pat_a = a.to_scipy().astype(bool)
        pat_b = pat_a if b is a else b.to_scipy().astype(bool)
        union = int((pat_a + pat_b).nnz)
        disp_bits = max(int(total - union).bit_length(), 1)

    m, n = a.shape
    pack_u32 = False
    if _rc_pack_bits(m, n) == 0 and m >= 2 and n >= 2:
        cbits = max(int(n - 1).bit_length(), 1)
        rbits = max(int(m - 1).bit_length(), 1)
        pack_u32 = cbits + rbits <= 32  # corner splice handles the sentinel
    return AddPlan(
        # never exceed the concatenated stream length (tiny-matrix corner)
        out_cap=min(pad_gentle(max(union, 1)), a.capacity + b.capacity),
        pack_u32=pack_u32,
        disp_bits=disp_bits,
    )


@partial(jax.jit, static_argnames=("plan",))
def spadd_planned(
    a: CSR, b: CSR, plan: AddPlan, alpha=1.0, beta=1.0
) -> CSR:
    """C = alpha*A + beta*B, one dispatch. alpha/beta trace as scalars, so
    scaling changes re-use the compiled executable."""
    m, n = a.shape
    dt = jnp.promote_types(a.dtype, b.dtype)
    row = jnp.concatenate([a.row_ids(), b.row_ids()]).astype(INDEX_DTYPE)
    col = jnp.concatenate([a.colidx, b.colidx]).astype(INDEX_DTYPE)
    val = jnp.concatenate(
        [a.vals.astype(dt) * jnp.asarray(alpha, dt),
         b.vals.astype(dt) * jnp.asarray(beta, dt)]
    )
    # padding slots already carry row == m (CSR convention) = invalid marker
    prodstart = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE),
         jnp.cumsum(a.row_lengths() + b.row_lengths())]
    ).astype(INDEX_DTYPE)
    return merge_products(
        row, col, val, m, n, plan.out_cap, max_run=2, val_dtype=dt,
        prodstart=prodstart, pack_u32=plan.pack_u32,
        disp_bits=plan.disp_bits,
    )


def spadd(a: CSR, b: CSR, alpha=1.0, beta=1.0) -> CSR:
    """Host-facing C = alpha*A + beta*B (builds the plan, runs one dispatch)."""
    return spadd_planned(a, b, make_add_plan(a, b), alpha, beta)
