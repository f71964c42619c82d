"""Dense-matmul SpGEMM for small high-fill matrices — scatter, matmul, extract.

When C = A @ B is nearly structurally dense (mouse_gene / dense_rows regime,
SURVEY.md §8: every row hundreds of nnz, fill of C ~1), the reference's
merge kernels and our sort-based paths pay per-product irregular-memory cost
for structure that is almost all-ones. The answer is to put the FLOPs
where the hardware is fastest — one dense matmul:

  1. scatter CSR values into dense operand tiles (one collision-free
     scatter-SET per matrix, ~nnz descriptors — cheap at this regime's nnz),
  2. one dense matmul (`precision=HIGHEST` to hold f32 golden tolerances:
     the default may run float32 in TF32),
  3. extract C's values at the *static* structural positions computed at
     plan time. Extraction mode chosen by hole fraction:
     'identity' at zero holes; 'shift' (monotone log2(holes)-pass
     compaction) when holes < slots/8, where few passes beat the
     one-pass scan's append machinery; 'scan' (ops/scancompact on
     plan-constant keys, max_run=1) for sparser C, where log2(holes)
     approaches log2(slots) and the single pass wins.

Unlike the BSR/DIA format paths, the output matches the scalar paths'
structural semantics exactly: the plan's rowptr/colidx are the boolean
pattern product (what merge-based SpGEMM produces), so entries that
numerically cancel stay as explicit zeros, same as scipy's golden
(utils/oracle.spgemm_reference).

Reference analogue: the merge-method bin of stage 3 (SURVEY.md §4) at its
densest extreme; dispatch decided by the measured cost model in
ops/dispatch.choose_method.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, pad_bucket
from .chunked import _shift_compact


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Static structural plan for the dense path.

    rowptr/colidx: C's structural CSR pattern (pattern product, host-built).
    mode 'shift': p1/p2 = per-slot keep flag / left-displacement (holes
    before the slot). mode 'scan': p1 = uint32 compaction keys (flat slot
    index at structural slots, sentinel at holes), p2 empty. mode
    'identity': C structurally full, no extraction.
    """

    rowptr: jax.Array
    colidx: jax.Array
    p1: jax.Array
    p2: jax.Array
    nnz_c: int = dataclasses.field(metadata=dict(static=True))
    cap_c: int = dataclasses.field(metadata=dict(static=True))
    mode: str = dataclasses.field(metadata=dict(static=True))
    disp_bits: int = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))


def make_dense_plan(a: CSR, b: CSR) -> DensePlan:
    """Host symbolic pass: boolean pattern product -> static structure."""
    import scipy.sparse as sp

    sa = a.to_scipy()
    sb = b.to_scipy()
    pat_a = sp.csr_matrix(
        (np.ones(sa.nnz, np.float64), sa.indices, sa.indptr), shape=sa.shape
    )
    pat_b = sp.csr_matrix(
        (np.ones(sb.nnz, np.float64), sb.indices, sb.indptr), shape=sb.shape
    )
    pat_c = (pat_a @ pat_b).tocsr()
    pat_c.sort_indices()
    m, n = pat_c.shape
    nnz_c = int(pat_c.nnz)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(pat_c.indptr))
    flat = rows * n + pat_c.indices.astype(np.int64)
    slots = m * n
    holes = slots - nnz_c
    empty_i32 = jnp.zeros((0,), jnp.int32)
    if holes == 0:
        mode, p1, p2, disp_bits = "identity", empty_i32, empty_i32, 0
    elif holes < slots // 8:  # near-full: shift passes beat one scan pass
        kept = np.zeros(slots, np.bool_)
        kept[flat] = True
        disp = (np.cumsum(~kept) - ~kept).astype(np.int32)
        mode, p1, p2 = "shift", jnp.asarray(kept), jnp.asarray(disp)
        disp_bits = max(int(holes).bit_length(), 1)
    else:
        ckeys = np.full(slots, np.uint32(0xFFFFFFFF), np.uint32)
        ckeys[flat] = flat.astype(np.uint32)  # slots < 2^32 by dispatch
        mode, p1, p2, disp_bits = "scan", jnp.asarray(ckeys), empty_i32, 0
    cap_c = pad_bucket(nnz_c)
    rowptr = jnp.asarray(pat_c.indptr.astype(np.int32))
    colidx = np.zeros(cap_c, np.int32)
    colidx[:nnz_c] = pat_c.indices
    return DensePlan(
        rowptr=rowptr,
        colidx=jnp.asarray(colidx),
        p1=p1,
        p2=p2,
        nnz_c=nnz_c,
        cap_c=cap_c,
        mode=mode,
        disp_bits=disp_bits,
        shape=(m, n),
    )


def csr_to_dense(a: CSR) -> jax.Array:
    """Collision-free scatter-SET densification (padding slots write 0 to
    the (m, 0) sentinel cell of an extra guard row, then sliced off)."""
    rows = a.row_ids()  # padding -> m
    dense = jnp.zeros((a.m + 1, a.n), a.vals.dtype)
    dense = dense.at[rows, a.colidx].set(a.vals, mode="drop")
    return dense[: a.m]


def spgemm_dense(a: CSR, b: CSR, plan: DensePlan) -> CSR:
    """C = A @ B by one dense matmul (jit-able). Structure comes from the plan; only
    values are computed on device."""
    da = csr_to_dense(a)
    # C = A @ A squaring: trace one densification scatter, not two (XLA CSE
    # dedupes the identical scatter anyway — measured no-op — but the single
    # trace keeps the HLO smaller)
    db = da if b is a else csr_to_dense(b)
    cd = jnp.matmul(da, db, precision=jax.lax.Precision.HIGHEST)
    vals = cd.reshape(-1)
    if plan.mode == "shift":
        (vals,) = _shift_compact(
            plan.p1, plan.p2, [vals], plan.disp_bits
        )
    elif plan.mode == "scan":
        from .scancompact import runsum_compact_scan

        # one-pass scan compaction on plan-constant keys; max_run=1 makes
        # the segmented run-sum a structural no-op (all runs singleton)
        _, vals, _ = runsum_compact_scan(
            plan.p1, vals, w=vals.shape[0], out_cap=plan.cap_c,
            max_run=1,
        )
    pad = plan.cap_c - vals.shape[0]
    if pad > 0:
        vals = jnp.concatenate([vals, jnp.zeros(pad, vals.dtype)])
    vals = vals[: plan.cap_c]
    vals = jnp.where(
        jnp.arange(plan.cap_c) < plan.nnz_c, vals, jnp.zeros((), vals.dtype)
    )
    return CSR(plan.rowptr, plan.colidx, vals, plan.shape)


def spgemm_dense_auto(a: CSR, b: CSR) -> CSR:
    """Host-facing convenience wrapper (plan built per call)."""
    return spgemm_dense(a, b, make_dense_plan(a, b))
