"""Block-sparse (BSR) SpGEMM — the block-matmul numeric path.

The BASELINE north-star asks for kernels that "tile CSR rows into dense
blocks". For matrices with block-local structure (banded, FEM
stencils, power-law hub columns), converting to BSR and multiplying dense
(bm x bk)·(bk x bn) blocks converts the irregular
gather/sort problem into a *batched matmul* problem:

1. **block-pair expansion** — the block-level analogue of the scalar
   chunked expansion (scatter+cumsum entry map; block rows are short so
   chunk width 1 suffices);
2. **batched block matmul**: ``einsum('pij,pjk->pik')`` over all
   pairs at once — this is where the FLOPs go, at matmul speed;
3. **duplicate merge** by (block-row, block-col) key: one small sort over
   pair *metadata* (never the block payloads), then a scatter-add of
   product blocks into their unique output slots (contiguous bm*bn-sized
   updates).

Trade-off: FLOPs are inflated by the inverse block density (zeros inside
blocks are multiplied too), but dense block matmuls run far above the
gather/sort pipeline's rate, so this path wins on block-dense matrices.
The cost model in ops/dispatch decides, the analogue of the reference's
per-regime method dispatch (heap/ESC/merge, SURVEY.md §4 stage 3).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import BSR, CSR, INDEX_DTYPE, host_view, row_ids_from_rowptr
from .chunked import pad_gentle

F32 = jnp.float32


@dataclasses.dataclass(frozen=True)
class BsrPlan:
    """Static capacities for one block-profile."""

    pairs_cap: int  # padded block-pair count
    out_blocks_cap: int  # padded unique output-block count


def make_bsr_plan(a: BSR, b: BSR) -> BsrPlan:
    a_rp = host_view(a.rowptr)
    b_rp = host_view(b.rowptr)
    nnzb_a = int(a_rp[-1])
    b_len = np.diff(b_rp)
    pairs = int(b_len[host_view(a.colidx)[:nnzb_a]].sum()) if nnzb_a else 0
    # unique C blocks per block row <= min(pairs in row, nb)
    nb = b.shape[1] // b.blocks.shape[2]
    colidx = host_view(a.colidx)[:nnzb_a]
    per_entry = b_len[colidx]
    cs = np.concatenate([[0], np.cumsum(per_entry)])
    per_row_pairs = cs[np.minimum(a_rp[1:], nnzb_a)] - cs[np.minimum(a_rp[:-1], nnzb_a)]
    uniq_bound = int(np.minimum(per_row_pairs, nb).sum())
    return BsrPlan(
        pairs_cap=pad_gentle(max(pairs, 1)),
        out_blocks_cap=pad_gentle(max(uniq_bound, 1)),
    )


@partial(jax.jit, static_argnames=("plan",))
def bsr_spgemm(a: BSR, b: BSR, plan: BsrPlan) -> BSR:
    """C = A @ B with A (bm, bk) and B (bk, bn) blocks; C gets (bm, bn)."""
    bm, bk = a.blocks.shape[1], a.blocks.shape[2]
    bk2, bn = b.blocks.shape[1], b.blocks.shape[2]
    assert bk == bk2, f"block inner dims mismatch: {bk} vs {bk2}"
    mb = a.shape[0] // bm
    nb = b.shape[1] // bn
    P = plan.pairs_cap

    # --- 1. block-pair expansion (scatter+cumsum entry map) ---------------
    a_brows = row_ids_from_rowptr(a.rowptr, a.colidx.shape[0])
    entry_valid = a_brows < mb
    b_len = (b.rowptr[1:] - b.rowptr[:-1]).astype(INDEX_DTYPE)
    per = jnp.where(entry_valid, b_len[a.colidx], 0).astype(INDEX_DTYPE)
    ends = jnp.cumsum(per)
    starts = ends - per
    total = ends[-1]
    hits = jnp.zeros(P, INDEX_DTYPE).at[starts].add(1, mode="drop")
    src = jnp.clip(jnp.cumsum(hits) - 1, 0, a.colidx.shape[0] - 1)
    pid = jnp.arange(P, dtype=INDEX_DTYPE)
    pair_valid = pid < total
    # packed per-ENTRY metadata table -> ONE (P, 3) pair-stream gather
    # (round 5): the separate starts[src] / b.rowptr[a.colidx[src]] /
    # a_brows[src] chains issued 3-4 gather streams per pair; one packed
    # table gather replaces them.
    ent_tbl = jnp.stack(
        [
            a_brows.astype(INDEX_DTYPE),
            b.rowptr[a.colidx].astype(INDEX_DTYPE),
            starts,
        ],
        axis=1,
    )  # (cap_e, 3) — entry-level gathers are nnzb_a-sized, not P-sized
    meta = ent_tbl[src, :]
    inner = pid - meta[:, 2]
    b_idx = jnp.clip(meta[:, 1] + inner, 0, b.colidx.shape[0] - 1)
    brow = jnp.where(pair_valid, meta[:, 0], mb).astype(INDEX_DTYPE)
    bcol = jnp.where(pair_valid, b.colidx[b_idx], 0).astype(INDEX_DTYPE)

    # --- 2. batched block matmul -------------------------------------------
    a_blk = a.blocks[src]  # (P, bm, bk) — contiguous block-sized gathers
    b_blk = b.blocks[b_idx]  # (P, bk, bn)
    # HIGHEST keeps f32 products at f32 accuracy (the default may round
    # inputs to TF32, which fails the scipy-golden tolerance). The f64
    # lane keeps accumulator and output blocks f64 end-to-end.
    acc_dt = (
        jnp.float64 if a.blocks.dtype == jnp.float64 else F32
    )
    prod = jnp.einsum(
        "pij,pjk->pik",
        a_blk,
        b_blk,
        preferred_element_type=acc_dt,
        precision=jax.lax.Precision.HIGHEST,
    )  # (P, bm, bn)
    prod = jnp.where(pair_valid[:, None, None], prod, 0.0)

    # --- 3. merge duplicates by (brow, bcol) — metadata sort only ----------
    key = jnp.where(pair_valid, brow * nb + bcol, mb * nb).astype(INDEX_DTYPE)
    key_s, pid_s = jax.lax.sort((key, pid), num_keys=1, is_stable=False)
    prev = jnp.concatenate([jnp.full((1,), -1, key_s.dtype), key_s[:-1]])
    is_head = (key_s != prev) & (key_s < mb * nb)
    uniq_s = jnp.cumsum(is_head.astype(INDEX_DTYPE)) - 1
    n_uniq = jnp.sum(is_head.astype(INDEX_DTYPE))
    slot_s = jnp.where(key_s < mb * nb, uniq_s, plan.out_blocks_cap)
    # back to pair order
    slot = jnp.zeros(P, INDEX_DTYPE).at[pid_s].set(slot_s)

    out_blocks = jnp.zeros((plan.out_blocks_cap, bm, bn), acc_dt)
    out_blocks = out_blocks.at[slot].add(prod, mode="drop")

    # output structure: heads carry (brow, bcol) at slot uniq_s
    head_slot = jnp.where(is_head, uniq_s, plan.out_blocks_cap)
    brow_s = key_s // nb
    bcol_s = key_s - brow_s * nb
    out_colidx = jnp.zeros(plan.out_blocks_cap, INDEX_DTYPE).at[head_slot].set(
        bcol_s, mode="drop"
    )
    out_brow = jnp.full(plan.out_blocks_cap, mb, INDEX_DTYPE).at[head_slot].set(
        brow_s, mode="drop"
    )
    needles = jnp.arange(mb + 1, dtype=INDEX_DTYPE)
    rowptr = jnp.searchsorted(out_brow, needles, side="left").astype(INDEX_DTYPE)
    rowptr = jnp.minimum(rowptr, n_uniq)
    return BSR(
        rowptr=rowptr,
        colidx=out_colidx,
        blocks=out_blocks.astype(a.blocks.dtype),
        shape=(a.shape[0], b.shape[1]),
    )


def spgemm_bsr(a_csr: CSR, b_csr: CSR, block_shape=(8, 128), out_block=(8, 128)) -> CSR:
    """Host-facing CSR→BSR→multiply→CSR convenience wrapper.

    block_shape = (bm, bk) for A; B gets (bk, bn) with bn = out_block[1].
    """
    bm, bk = block_shape
    bn = out_block[1]
    a_b = BSR.from_scipy(a_csr.to_scipy(), block_shape=(bm, bk))
    b_b = BSR.from_scipy(b_csr.to_scipy(), block_shape=(bk, bn))
    plan = make_bsr_plan(a_b, b_b)
    c_b = bsr_spgemm(a_b, b_b, plan)
    # in-block zeros are structurally absent in the true C (they compute to
    # exactly 0.0); drop them so the CSR structure matches the scalar paths
    c = c_b.to_scipy().tocsr()
    c.eliminate_zeros()
    c.sort_indices()
    from ..sparse.csr import CSR as _CSR

    return _CSR.from_scipy(c)


def block_density(a: CSR, block_shape=(8, 128)) -> float:
    """Mean nnz density inside occupied blocks — the BSR-vs-CSR dispatch
    heuristic (fraction of useful flops if multiplied block-dense)."""
    import scipy.sparse as sp

    bm, bn = block_shape
    sp_a = a.to_scipy()
    m, n = sp_a.shape
    if m % bm or n % bn:
        return 0.0
    b = sp.bsr_matrix(sp_a, blocksize=(bm, bn))
    nblocks = b.indptr[-1]
    if not nblocks:
        return 1.0
    return sp_a.nnz / (nblocks * bm * bn)


def bsr_viable(
    a: CSR,
    block_shape=(8, 128),
    max_pair_bytes: int = 2 << 30,
    chunked_ns_per_product: float = 15.0,
    bsr_ns_per_pair: float = 50.0,
) -> bool:
    """Cost-model dispatch for C = A @ A: shape divisibility, product-block
    memory, and a time comparison — a per-product cost on the chunked
    sort/gather path vs a per-(8,128)x(128,128)-block-pair cost on the
    block-matmul path. The defaults are coarse and uncalibrated;
    api.spgemm's auto dispatch uses the calibrated model in ops/dispatch
    instead. Pure numpy — no scipy BSR conversion."""
    bm, bk = block_shape
    m, n = a.shape
    if m % bm or n % bk or m % bk or n % bk:
        return False
    rowptr = host_view(a.rowptr)
    nnz = int(rowptr[-1])
    if not nnz:
        return True
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rowptr))
    cols = host_view(a.colidx)[:nnz].astype(np.int64)
    nbk = n // bk

    # A's occupied (bm, bk) blocks; B(==A)'s occupied (bk, bk) block rows
    a_keys = np.unique((rows // bm) * nbk + cols // bk)
    b_keys = np.unique((rows // bk) * nbk + cols // bk)
    b_blen = np.bincount(b_keys // nbk, minlength=m // bk)
    pairs = int(b_blen[a_keys % nbk].sum())
    if pairs * bm * bk * 4 > max_pair_bytes:
        return False

    row_lens = np.diff(rowptr)
    products = int(row_lens[cols].sum())
    return pairs * bsr_ns_per_pair < products * chunked_ns_per_product
