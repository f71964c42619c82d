"""Distributed SpGEMM: 1D row partitioning of A and C over a device mesh.

The reference is single-GPU (SURVEY.md §3: no distributed backend exists);
the distribution story is mandated new design (BASELINE.json:5): A and C
row-sharded, B replicated or row-sharded, remote B rows exchanged over
ICI/DCN. Two schedules:

- ``dist_spgemm_replicated``: B replicated on every device; pure local
  compute under ``jax.shard_map``. The correctness + scaling harness.
- ``dist_spgemm_ring``: B row-sharded; B blocks rotate around the ring via
  ``ppermute`` while each device multiplies its local A entries against the
  resident block (the memory-scalable path — the structural analogue of
  ring attention's KV rotation, SURVEY.md §7.7). Every intermediate product
  lands at a precomputed position in the local product buffer, so a single
  sort-compress at the end produces local C rows — no per-step CSR merging.

Sharded representation: per-shard blocks stacked on a leading axis
(``rowptr: (P, m_loc+1)``, ``colidx/vals: (P, cap)``), equal static padding
per shard so shard_map sees uniform blocks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse.csr import CSR, INDEX_DTYPE, host_view, pad_bucket
from ..ops.chunked import (
    ChunkedPlan,
    _expand_chunks,
    _propagate_entry_consts,
    make_chunked_plan,
    merge_products,
    pad_gentle,
    row_product_offsets,
    spgemm_chunked,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-sharded CSR. Uniform partition (bounds is None): shard i holds
    rows [i*m_loc, (i+1)*m_loc). Product-balanced partition (round 4,
    VERDICT r3 next #4): shard i holds rows [bounds[i], bounds[i+1]) at
    local positions 0..cnt_i, trailing local rows empty — every shard
    still sees the same static m_loc, but the unified-statics CAPACITIES
    (chunk stream, group count, output) shrink from max-shard to
    ~mean-shard because products are equalized."""

    rowptr: jax.Array  # (P, m_loc + 1) — local rowptrs (start at 0)
    colidx: jax.Array  # (P, cap)
    vals: jax.Array  # (P, cap)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    bounds: Tuple[int, ...] | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def n_shards(self) -> int:
        return self.rowptr.shape[0]

    @property
    def m_loc(self) -> int:
        return self.rowptr.shape[1] - 1

    @property
    def cap(self) -> int:
        return self.colidx.shape[1]


def balanced_row_bounds(a: CSR, b: CSR | None = None,
                        n_shards: int = 1) -> np.ndarray:
    """Product-balanced contiguous row boundaries (n_shards + 1,): rows are
    assigned by cumulative intermediate-product count so every shard
    carries ~total/P products — the greedy fill grouped-ESC already uses
    per group, applied across shards (VERDICT r3 next #4)."""
    b = a if b is None else b
    rowptr = host_view(a.rowptr).astype(np.int64)[: a.m + 1]
    nnz = int(rowptr[-1])
    b_len = np.diff(host_view(b.rowptr).astype(np.int64)[: b.m + 1])
    lens = b_len[host_view(a.colidx)[:nnz].astype(np.int64)]
    cs = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
    row_prod = cs[rowptr]  # (m + 1,) products before each row
    targets = row_prod[-1] * np.arange(1, n_shards) // n_shards
    cuts = np.searchsorted(row_prod, targets, side="left")
    bounds = np.concatenate([[0], cuts, [a.m]])
    return np.maximum.accumulate(bounds)  # monotone even on degenerate input


def shard_rows(
    a: CSR, n_shards: int, cap: int | None = None,
    bounds: np.ndarray | None = None,
) -> ShardedCSR:
    """Host-side 1D row partition. Uniform (bounds None): m padded up to a
    multiple of n_shards with empty rows. Non-uniform: explicit boundaries
    (from balanced_row_bounds); every shard is padded to the max row count
    with empty trailing rows. Padding rows produce empty C rows, trimmed
    on unshard."""
    m, n = a.shape
    rowptr = np.asarray(a.rowptr)
    colidx = np.asarray(a.colidx)
    vals = np.asarray(a.vals)
    if bounds is None:
        m_pad = ((m + n_shards - 1) // n_shards) * n_shards
        m_loc = m_pad // n_shards
        row_bounds = np.arange(n_shards + 1, dtype=np.int64) * m_loc
        bounds_t = None
    else:
        row_bounds = np.asarray(bounds, np.int64)
        assert len(row_bounds) == n_shards + 1
        m_loc = int(np.diff(row_bounds).max(initial=1))
        bounds_t = tuple(int(x) for x in row_bounds)
    rowptr_full = np.concatenate(
        [rowptr[: m + 1],
         np.full(max(row_bounds[-1] - m, 0), rowptr[m], rowptr.dtype)]
    )
    starts = rowptr_full[np.minimum(row_bounds[:-1], m)]
    ends = rowptr_full[np.minimum(row_bounds[1:], m)]
    if cap is None:
        cap = pad_bucket(int((ends - starts).max()) if n_shards else 1)
    rp = np.zeros((n_shards, m_loc + 1), np.int32)
    ci = np.zeros((n_shards, cap), np.int32)
    va = np.zeros((n_shards, cap), vals.dtype)
    for i in range(n_shards):
        lo, hi = int(starts[i]), int(ends[i])
        cnt = int(row_bounds[i + 1] - row_bounds[i])
        rp[i, : cnt + 1] = (
            rowptr_full[row_bounds[i] : row_bounds[i + 1] + 1] - lo
        )
        rp[i, cnt + 1 :] = rp[i, cnt]  # trailing empty rows
        ci[i, : hi - lo] = colidx[lo:hi]
        va[i, : hi - lo] = vals[lo:hi]
    return ShardedCSR(
        jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(va), (m, n),
        bounds=bounds_t,
    )


def on_mesh(x: ShardedCSR, mesh: Mesh, axis: str = "rows") -> ShardedCSR:
    """Place shard i of every field on device i of ``mesh``. Arrays built on
    the host land on the default device, and a shard_map call would move
    them from there on every call."""
    sharding = NamedSharding(mesh, P(axis))
    return dataclasses.replace(
        x,
        rowptr=jax.device_put(x.rowptr, sharding),
        colidx=jax.device_put(x.colidx, sharding),
        vals=jax.device_put(x.vals, sharding),
    )


def unshard(c: ShardedCSR, trim: bool = True) -> CSR:
    """Host-side inverse of shard_rows (concatenate + repack); honors a
    non-uniform bounds partition."""
    m, n = c.shape
    P_, m_loc = c.n_shards, c.m_loc
    rp = np.asarray(c.rowptr)
    ci = np.asarray(c.colidx)
    va = np.asarray(c.vals)
    if c.bounds is not None:
        cnts = np.diff(np.asarray(c.bounds, np.int64))
    else:
        cnts = np.full(P_, m_loc, np.int64)
    nnz_per = rp[np.arange(P_), cnts]  # nnz within each shard's REAL rows
    total = int(nnz_per.sum())
    colidx = np.zeros(pad_bucket(total), np.int32)
    vals = np.zeros(pad_bucket(total), va.dtype)
    rowptr = np.zeros(int(cnts.sum()) + 1, np.int32)
    off = 0
    row0 = 0
    for i in range(P_):
        k = int(nnz_per[i])
        cnt = int(cnts[i])
        colidx[off : off + k] = ci[i, :k]
        vals[off : off + k] = va[i, :k]
        rowptr[row0 + 1 : row0 + cnt + 1] = rp[i, 1 : cnt + 1] + off
        off += k
        row0 += cnt
    rowptr_out = rowptr[: m + 1] if trim else rowptr
    return CSR(
        jnp.asarray(rowptr_out), jnp.asarray(colidx), jnp.asarray(vals), (m, n)
    )


# ---------------------------------------------------------------------------
# Per-shard tuned local plan (VERDICT r1 weak #3: the distributed local
# kernel must run the SAME tuned machinery as the single-chip core)
# ---------------------------------------------------------------------------


def make_dist_local_plan(
    a: CSR, b: CSR, n_shards: int, halo_lens: list | None = None,
    bounds: np.ndarray | None = None,
) -> ChunkedPlan:
    """Tuned ChunkedPlan for the shard_map local kernel: the GLOBAL plan's
    mode decisions (k / al-aligned tables / wide split / scatter-SET /
    pack_u32 / disp_bits — all per-matrix, so identical on every shard) with
    CAPACITIES recomputed as the max over row shards, since shard_map runs
    one static program per shard.

    halo_lens: per-shard arrays of assembled-halo B row lengths (halo
    schedule) — sizes the in-graph aligned/wide table builds against the
    halo instead of the full B.

    bounds: optional explicit row boundaries (n_shards + 1,) for NON-uniform
    row blocks — the out-of-core path's product-balanced blocks
    (ops/batched) reuse this unification verbatim, per VERDICT r2 next #3.
    """
    base = make_chunked_plan(a, b)
    if base.al_min:  # mixed mode is never auto-picked; keep dist plans pure
        base = make_chunked_plan(a, b, al=base.al)

    m = a.m
    m_loc = -(-m // n_shards)
    rowptr = host_view(a.rowptr).astype(np.int64)
    nnz_a = int(rowptr[-1])
    rowptr_full = np.concatenate(
        [rowptr, np.full(n_shards * m_loc - m, rowptr[-1], np.int64)]
    )
    if bounds is None:
        row_bounds = np.arange(n_shards + 1) * m_loc
    else:
        row_bounds = np.asarray(bounds, np.int64)
        assert len(row_bounds) == n_shards + 1
    bounds_e = rowptr_full[row_bounds]
    b_len = np.diff(host_view(b.rowptr)).astype(np.int64)
    lens_all = b_len[host_view(a.colidx)[:nnz_a]]

    def seg_sum(x):  # per-shard sums of an entry-level array
        cs = np.concatenate([[0], np.cumsum(x, dtype=np.int64)])
        return cs[bounds_e[1:]] - cs[bounds_e[:-1]]

    wide = lens_all >= base.wide_min if base.wide_min else np.zeros(
        lens_all.shape, bool
    )
    lens_s = np.where(wide, 0, lens_all)  # short-row substream lengths
    q = base.al or base.k
    chunks_e = -(-lens_s // q)
    if base.scatter_set:  # every real entry owns >= 1 chunk (dummies)
        chunks_e = np.maximum(chunks_e, 1)
    chunks_max = int(seg_sum(chunks_e).max(initial=1))
    wchunks_max = int(
        seg_sum(-(-np.where(wide, lens_all, 0) // base.wide_lanes)).max(initial=1)
    ) if base.wide_min else 0

    # per-shard output bound: sum over shard rows of min(row products, n)
    prod_row = np.concatenate([[0], np.cumsum(lens_all, dtype=np.int64)])
    row_prod = prod_row[rowptr_full[1:]] - prod_row[rowptr_full[:-1]]
    out_row = np.minimum(row_prod, b.n)
    oc = np.concatenate([[0], np.cumsum(out_row, dtype=np.int64)])
    out_max = int(
        (oc[np.minimum(row_bounds[1:], m)]
         - oc[np.minimum(row_bounds[:-1], m)]).max(initial=1)
    )

    abpad_cap, bpad_cap = base.abpad_cap, base.bpad_cap
    if halo_lens is not None:
        # table builds run against the per-shard assembled halo B
        if base.al:
            def _abpad(hl):
                sel = hl < base.wide_min if base.wide_min else np.ones(
                    hl.shape, bool
                )
                return int((-(-hl[sel] // base.al) * base.al).sum())

            abpad = max(_abpad(hl) if hl.size else 0 for hl in halo_lens)
            abpad_cap = max(
                -(-pad_gentle(max(abpad, 1) + base.al) // base.al) * base.al,
                base.al,
            )
        if base.wide_min:
            bpad = max(
                int((np.ceil(hl[hl >= base.wide_min] / base.wide_lanes)
                     * base.wide_lanes).sum()) if hl.size else 0
                for hl in halo_lens
            )
            bpad_cap = max(
                -(-pad_gentle(max(bpad, 1)) // base.wide_lanes)
                * base.wide_lanes,
                base.wide_lanes,
            )

    return dataclasses.replace(
        base,
        chunks_cap=pad_gentle(chunks_max),
        wchunks_cap=pad_gentle(wchunks_max) if base.wide_min else 0,
        out_cap=pad_gentle(out_max),
        abpad_cap=abpad_cap,
        bpad_cap=bpad_cap,
        nchunks_cap=0,
        al_min=0,
    )


# ---------------------------------------------------------------------------
# Per-shard grouped-ESC local plan (same dispatch as the single-chip core)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistGroupedPlan:
    """Unified grouped statics + per-shard schedule arrays stacked on a
    leading shard axis (shard_map runs ONE static program, so every
    shard's GroupedSchedule is rebuilt under the max statics)."""

    plan: object  # ops.grouped.GroupedPlan (hashable statics)
    slot0: jax.Array  # (P, m_loc)
    first_rank: jax.Array  # (P, g_cap)
    sorted_off: jax.Array  # (P, m_loc + 1)
    fill_end: jax.Array  # (P, g_cap)


def make_dist_grouped_plan(
    a: CSR, b: CSR, n_shards: int, bounds: np.ndarray | None = None
) -> DistGroupedPlan | None:
    """Per-shard grouped schedules under unified statics: pass 1 plans each
    row shard with the GLOBAL plan's mode + group-size target, pass 2
    rebuilds every shard under the max statics (ops.grouped's `fixed`).

    bounds: product-balanced boundaries (balanced_row_bounds) — equalizes
    per-shard products so the unified max statics sit near the mean."""
    from ..ops.grouped import make_grouped_plan

    base = make_grouped_plan(a, b)
    if base is None:
        return None
    bp = base.plan
    a_sh = shard_rows(a, n_shards, bounds=bounds)
    m_loc, kdim = a_sh.m_loc, a.n
    subs = [
        CSR(a_sh.rowptr[d], a_sh.colidx[d], a_sh.vals[d], (m_loc, kdim))
        for d in range(n_shards)
    ]
    p1 = [
        make_grouped_plan(
            s, b, al=bp.al, target_slots=bp.cs * bp.lanes,
            force_scatter_set=bp.scatter_set,
        )
        for s in subs
    ]
    live = [p.plan for p in p1 if p is not None]
    if not live:
        return None
    cs_u = max(p.cs for p in live)
    g_u = max(p.g_cap for p in live)
    prod_u = g_u * cs_u * bp.lanes
    nnz_max = max(p.nnz_c for p in live)
    unified = dataclasses.replace(
        bp,
        cs=cs_u,
        g_cap=g_u,
        out_cap=min(pad_gentle(max(nnz_max, 1)), prod_u),
        nnz_c=nnz_max,
        disp_bits=max(
            max(int(prod_u - p.nnz_c).bit_length(), 1) for p in live
        ),
        max_run=max(p.max_run for p in live),
        lbits=max(p.lbits for p in live),
    )
    scheds = [make_grouped_plan(s, b, fixed=unified) for s in subs]
    return DistGroupedPlan(
        plan=unified,
        slot0=jnp.stack([s.slot0 for s in scheds]),
        first_rank=jnp.stack([s.first_rank for s in scheds]),
        sorted_off=jnp.stack([s.sorted_off for s in scheds]),
        fill_end=jnp.stack([s.fill_end for s in scheds]),
    )


# ---------------------------------------------------------------------------
# Replicated-B schedule
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _replicated_exec_grouped(mesh, axis, m_loc, kdim, n, plan):
    """Cached grouped-local-kernel executable (see _replicated_exec)."""
    from ..ops.grouped import _spgemm_grouped

    def local_fn(a_rp, a_ci, a_va, s0, fr, so, fe, b_rp, b_ci, b_va):
        a_loc = CSR(a_rp[0], a_ci[0], a_va[0], (m_loc, kdim))
        b_full = CSR(b_rp, b_ci, b_va, (kdim, n))
        c_loc = _spgemm_grouped(
            a_loc, b_full, s0[0], fr[0], so[0], fe[0], plan
        )
        return c_loc.rowptr[None], c_loc.colidx[None], c_loc.vals[None]

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axis),) * 7 + (P(), P(), P()),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )


@functools.lru_cache(maxsize=128)
def _replicated_exec(mesh, axis, m_loc, kdim, n, plan: ChunkedPlan):
    """Cached compiled executable — re-tracing shard_map per call costs
    seconds of compile time; cache key = mesh + static shape plan."""

    def local_fn(a_rp, a_ci, a_va, b_rp, b_ci, b_va):
        a_loc = CSR(a_rp[0], a_ci[0], a_va[0], (m_loc, kdim))
        b_full = CSR(b_rp, b_ci, b_va, (kdim, n))
        # full tuned single-chip pipeline per shard (aligned tables, wide
        # split, scatter-SET, packed keys, bounded compaction)
        c_loc = spgemm_chunked(a_loc, b_full, plan)
        return c_loc.rowptr[None], c_loc.colidx[None], c_loc.vals[None]

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )


def dist_spgemm_replicated(
    a: ShardedCSR,
    b: CSR,
    mesh: Mesh,
    prod_cap: int | None = None,
    out_cap: int | None = None,
    axis: str = "rows",
    chunk_k: int | None = None,
    plan: ChunkedPlan | None = None,
    a_full: CSR | None = None,
    grouped_plan: DistGroupedPlan | None = None,
) -> ShardedCSR:
    """C = A @ B with A,C row-sharded over ``mesh[axis]`` and B replicated.

    The local kernel is the per-shard tuned chunked pipeline (pass ``plan``
    from make_dist_local_plan) or the grouped-ESC pipeline (pass
    ``grouped_plan`` from make_dist_grouped_plan); or pass ``a_full`` so a
    chunked plan can be built here. Legacy prod_cap/out_cap/chunk_k args
    are accepted for explicit capacity control (narrow-mode plan)."""
    m, k = a.shape
    n = b.n
    if grouped_plan is not None:
        fn = _replicated_exec_grouped(
            mesh, axis, a.m_loc, k, n, grouped_plan.plan
        )
        rowptr, colidx, vals = fn(
            a.rowptr, a.colidx, a.vals,
            grouped_plan.slot0, grouped_plan.first_rank,
            grouped_plan.sorted_off, grouped_plan.fill_end,
            b.rowptr, b.colidx, b.vals,
        )
        return ShardedCSR(rowptr, colidx, vals, (m, n), bounds=a.bounds)
    if plan is None:
        if a_full is not None:
            plan = make_dist_local_plan(
                a_full, b, a.n_shards,
                bounds=np.asarray(a.bounds) if a.bounds else None,
            )
        else:
            chunk_k = chunk_k or 8
            plan = ChunkedPlan(
                k=chunk_k,
                chunks_cap=pad_gentle((prod_cap or 1) // chunk_k + a.cap + 1),
                out_cap=out_cap or prod_cap,
            )
    fn = _replicated_exec(mesh, axis, a.m_loc, k, n, plan)
    rowptr, colidx, vals = fn(
        a.rowptr, a.colidx, a.vals, b.rowptr, b.colidx, b.vals
    )
    return ShardedCSR(rowptr, colidx, vals, (m, n), bounds=a.bounds)


# ---------------------------------------------------------------------------
# Ring schedule (B row-sharded, blocks rotate via ppermute)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RingStatics:
    """Hashable static shapes for one (A, B, P) ring schedule."""

    k: int  # chunk width (products per metadata slot)
    chunks_cap: int  # per-device full chunk-stream capacity
    cap_step: int  # max chunks any (device, super-block) pair holds
    out_cap: int
    m_loc: int
    k_loc: int
    n_shards: int
    max_run: int = 0
    # hop width H (round 5, VERDICT r4 #5): each device keeps H
    # consecutive B blocks resident and the ring runs P/H hops of an
    # H-block super-buffer — same total comm volume (H-1 subgroup-rotate
    # prologue sends + P/H - 1 super-hops move P-1 block-equivalents),
    # 1/H of the per-step schedule overhead (the measured 3.42x eater on
    # the one-core CPU mesh), at H x resident-B memory.
    hop: int = 1


@dataclasses.dataclass
class RingPlan:
    """Host-built ring schedule (VERDICT r1 weak #4 rebuild): local A
    entries are REORDERED by the owner block of their column, so ring step
    s touches one contiguous chunk slice instead of re-scanning the whole
    product buffer every step — per-step work drops from O(prod_cap) to
    O(cap_step) and expansion is chunk-shaped (k products per metadata
    slot) like the single-chip core."""

    statics: RingStatics
    a_col: jax.Array  # (P, cap_e) reordered local A colidx
    a_val: jax.Array  # (P, cap_e) reordered local A values
    a_row: jax.Array  # (P, cap_e) local row id per reordered entry
    chunkptr: jax.Array  # (P, P + 1) chunk boundaries per owner block
    rp_glob_pad: jax.Array  # (P * k_loc + 1,) padded global B rowptr
    bounds: tuple | None = None  # non-uniform A-row partition (if any)


def make_ring_plan(
    a: CSR, b: CSR, n_shards: int, bounds: np.ndarray | None = None,
    hop: int = 1,
) -> RingPlan:
    """Group each shard's A entries by the B shard owning their column and
    quantize the per-entry product segments into k-wide chunks (host, one
    structure pass — the ring analogue of make_chunked_plan).

    bounds: product-balanced A-row boundaries (balanced_row_bounds).
    hop: blocks per resident super-buffer (RingStatics.hop); must divide
    n_shards."""
    a_sh = shard_rows(a, n_shards, bounds=bounds)
    m_loc, cap_e = a_sh.m_loc, a_sh.cap
    k_pad = ((b.m + n_shards - 1) // n_shards) * n_shards
    k_loc = k_pad // n_shards
    b_rowptr = host_view(b.rowptr).astype(np.int64)
    b_len = np.diff(b_rowptr)
    rp_glob_pad = np.concatenate(
        [b_rowptr, np.full(k_pad - b.m, b_rowptr[-1], np.int64)]
    )

    base = make_chunked_plan(a, b)
    k = base.al or base.k  # narrow chunk width from the global cost sweep

    rp = np.asarray(a_sh.rowptr)
    ci = np.asarray(a_sh.colidx)
    va = np.asarray(a_sh.vals)
    a_col = np.zeros((n_shards, cap_e), np.int32)
    a_val = np.zeros((n_shards, cap_e), va.dtype)
    a_row = np.full((n_shards, cap_e), m_loc, np.int32)
    chunkptr = np.zeros((n_shards, n_shards + 1), np.int64)
    out_bounds = []
    for d in range(n_shards):
        nnz_d = int(rp[d, -1])
        cols = ci[d, :nnz_d].astype(np.int64)
        rows = np.repeat(
            np.arange(m_loc, dtype=np.int64), np.diff(rp[d].astype(np.int64))
        )
        owner = cols // k_loc
        order = np.argsort(owner, kind="stable")
        a_col[d, :nnz_d] = cols[order]
        a_val[d, :nnz_d] = va[d, :nnz_d][order]
        a_row[d, :nnz_d] = rows[order]
        chunks_e = -(-b_len[cols[order]] // k)
        ccum = np.concatenate([[0], np.cumsum(chunks_e)])
        # chunk boundary of owner block j = first entry with owner >= j
        firsts = np.searchsorted(owner[order], np.arange(n_shards + 1))
        chunkptr[d] = ccum[firsts]
        pcum = np.concatenate([[0], np.cumsum(b_len[cols])])
        row_prod = pcum[rp[d, 1:]] - pcum[rp[d, :-1]]
        out_bounds.append(int(np.minimum(row_prod, b.n).sum()) or 1)

    if n_shards % hop:
        raise ValueError(f"hop {hop} must divide n_shards {n_shards}")
    chunks_cap = pad_gentle(int(chunkptr[:, -1].max(initial=1)))
    # super-window spans: chunks between H-aligned owner boundaries
    super_bounds = chunkptr[:, ::hop]
    cap_step = pad_gentle(int(np.diff(super_bounds, axis=1).max(initial=1)))
    statics = RingStatics(
        k=k,
        chunks_cap=chunks_cap,
        cap_step=cap_step,
        out_cap=pad_gentle(max(out_bounds + [1])),
        m_loc=m_loc,
        k_loc=k_loc,
        n_shards=n_shards,
        max_run=base.max_run,
        hop=hop,
    )
    return RingPlan(
        statics=statics,
        a_col=jnp.asarray(a_col),
        a_val=jnp.asarray(a_val),
        a_row=jnp.asarray(a_row),
        chunkptr=jnp.asarray(chunkptr.astype(np.int32)),
        rp_glob_pad=jnp.asarray(rp_glob_pad.astype(np.int32)),
        bounds=a_sh.bounds,
    )


@functools.lru_cache(maxsize=128)
def _ring_exec(mesh, axis, n, st: RingStatics, val_dtype):
    """Cached compiled ring executable (see _replicated_exec).

    Step body: (1) kick off the ppermute of the resident B block to the
    right neighbour, (2) expand the chunk slice of the block HELD NOW, (3)
    carry the permuted block — the collective depends only on the held
    block, so XLA's async collectives overlap it with the expansion
    (double-buffering)."""
    P_, k, cap_step = st.n_shards, st.k, st.cap_step
    H = st.hop
    G = P_ // H
    perm = [(i, (i + H) % P_) for i in range(P_)]

    def local_fn(a_col, a_val, a_row, chunkptr, b_ci, b_va, rp_glob):
        my = jax.lax.axis_index(axis)
        a_col0, a_row0 = a_col[0], a_row[0]
        cptr = chunkptr[0]
        cap_e = a_col0.shape[0]
        entry_valid = a_row0 < st.m_loc

        # ---- full chunk-stream metadata, ONCE per call (chunk-shaped:
        # same delta-propagation machinery as the single-chip core) -------
        b_len = (rp_glob[1:] - rp_glob[:-1]).astype(INDEX_DTYPE)
        bl = jnp.where(entry_valid, b_len[a_col0], 0)
        n_chunks = (bl + (k - 1)) // k
        ends = jnp.cumsum(n_chunks)
        starts = ends - n_chunks
        total = ends[-1] if cap_e else jnp.zeros((), INDEX_DTYPE)
        # BLOCK-LOCAL position basis + owner block per entry (round 5):
        # the step body indexes the resident super-buffer, so positions
        # are pre-rebased to the owning block and the owner id rides the
        # same propagation machinery (one more 1D scatter+cumsum pair —
        # CLAUDE.md: separate propagations beat packed operands)
        owner0 = jnp.clip(
            a_col0.astype(INDEX_DTYPE) // st.k_loc, 0, P_ - 1
        )
        bbase0 = rp_glob[owner0 * st.k_loc].astype(INDEX_DTYPE)
        gpos0 = rp_glob[a_col0].astype(INDEX_DTYPE)  # global B pos of entry
        q_posb = (gpos0 - bbase0) - k * starts
        q_remb = bl + k * starts
        q_row = a_row0.astype(INDEX_DTYPE)
        q_owner = owner0
        if val_dtype in (jnp.float32, jnp.bfloat16, jnp.float16):
            q_aval = jax.lax.bitcast_convert_type(
                a_val[0].astype(jnp.float32), jnp.int32
            )
            posb, remb, rowc, own_c, avalb = _propagate_entry_consts(
                starts, (q_posb, q_remb, q_row, q_owner, q_aval),
                st.chunks_cap,
            )
            aval_c = jax.lax.bitcast_convert_type(avalb, jnp.float32)
        else:
            posb, remb, rowc, own_c = _propagate_entry_consts(
                starts, (q_posb, q_remb, q_row, q_owner), st.chunks_cap
            )
            hits = jnp.zeros(st.chunks_cap, INDEX_DTYPE).at[starts].add(
                1, mode="drop"
            )
            src = jnp.clip(jnp.cumsum(hits) - 1, 0, cap_e - 1)
            aval_c = a_val[0][src]
        c_ids = jnp.arange(st.chunks_cap, dtype=INDEX_DTYPE)
        pos_c = posb + k * c_ids  # block-local B position per chunk
        rem_c = remb - k * c_ids
        cvalid = c_ids < total
        rowc = jnp.where(cvalid, rowc, st.m_loc)

        # resident block as ONE packed (cap_b, 2) int32 array: colidx +
        # bitcast values ride a single ppermute and a single per-lane gather
        if val_dtype in (jnp.float32, jnp.bfloat16, jnp.float16):
            bpk = jnp.stack(
                [
                    b_ci[0].astype(jnp.int32),
                    jax.lax.bitcast_convert_type(
                        b_va[0].astype(jnp.float32), jnp.int32
                    ),
                ],
                axis=1,
            )
            unpack = lambda t: (
                t[..., 0],
                jax.lax.bitcast_convert_type(t[..., 1], jnp.float32),
            )
        else:
            bpk = (b_ci[0].astype(jnp.int32), b_va[0])
            unpack = None
        cap_b = b_ci[0].shape[0]
        lane = jnp.arange(k, dtype=INDEX_DTYPE)

        # ---- resident super-buffer: H consecutive blocks of my subgroup
        # (aligned to H boundaries), assembled by H-1 subgroup-cyclic
        # rotations. parts[t] on device d holds block base + (d%H + t)%H,
        # i.e. block base+u sits at slot (u - d%H) % H — the step body
        # folds that rotation into its index.
        parts = [bpk]
        for t in range(1, H):
            perm_sub = [
                (i, (i // H) * H + (i % H - 1) % H) for i in range(P_)
            ]
            parts.append(jax.lax.ppermute(parts[-1], axis, perm=perm_sub))
        if H == 1:
            resident = bpk
        elif unpack:
            resident = jnp.concatenate(parts, axis=0)  # (H*cap_b, 2)
        else:
            resident = tuple(
                jnp.concatenate([p[j] for p in parts], axis=0)
                for j in range(len(bpk))
            )
        my_rot = my % H

        S = G * cap_step * k
        out_row = jax.lax.pcast(
            jnp.full(S, st.m_loc, INDEX_DTYPE), (axis,), to="varying"
        )
        out_col = jax.lax.pcast(jnp.zeros(S, INDEX_DTYPE), (axis,), to="varying")
        out_val = jax.lax.pcast(
            jnp.zeros(S, jnp.float32 if unpack else val_dtype),
            (axis,), to="varying",
        )

        def step(s, carry):
            cur, out_row, out_col, out_val = carry
            # (1) prefetch: rotate the held super-buffer now; XLA overlaps
            # the collective with (2) since both read only `cur`
            nxt = jax.lax.ppermute(cur, axis, perm=perm)
            sg = (my // H - s) % G  # super-block processed this hop
            off_chunk = cptr[sg * H]
            n_here = cptr[sg * H + H] - off_chunk
            idx = off_chunk + jnp.arange(cap_step, dtype=INDEX_DTYPE)
            live = jnp.arange(cap_step, dtype=INDEX_DTYPE) < n_here
            idxc = jnp.clip(idx, 0, st.chunks_cap - 1)
            # (2) expand this super-window's chunk slice against the
            # resident buffer: block base+u sits at slot (u - my%H) % H
            slot = (own_c[idxc] - sg * H - my_rot) % H if H > 1 else 0
            pos_s = pos_c[idxc] + slot * cap_b
            rem_s = rem_c[idxc]
            row_s = jnp.where(live, rowc[idxc], st.m_loc)
            aval_s = aval_c[idxc]
            gidx = jnp.clip(
                pos_s[None, :] + lane[:, None], 0, H * cap_b - 1
            )  # (k, cap_step)
            lane_valid = live[None, :] & (lane[:, None] < rem_s[None, :])
            if unpack:
                tile = cur[gidx, :]
                colk, bvalk = unpack(tile)
                valk = bvalk * aval_s[None, :]
            else:
                colk = cur[0][gidx]
                valk = cur[1][gidx] * aval_s[None, :]
            rowk = jnp.where(lane_valid, row_s[None, :], st.m_loc)
            colk = jnp.where(lane_valid, colk, 0)
            valk = jnp.where(lane_valid, valk, 0)
            o = s * (cap_step * k)
            out_row = jax.lax.dynamic_update_slice(
                out_row, rowk.reshape(-1).astype(INDEX_DTYPE), (o,)
            )
            out_col = jax.lax.dynamic_update_slice(
                out_col, colk.reshape(-1).astype(INDEX_DTYPE), (o,)
            )
            out_val = jax.lax.dynamic_update_slice(
                out_val, valk.reshape(-1).astype(out_val.dtype), (o,)
            )
            return nxt, out_row, out_col, out_val

        _, row_t, col_t, val_t = jax.lax.fori_loop(
            0, G, step, (resident, out_row, out_col, out_val)
        )
        c_loc = merge_products(
            row_t, col_t, val_t, st.m_loc, n, st.out_cap,
            max_run=st.max_run, val_dtype=val_dtype,
        )
        return c_loc.rowptr[None], c_loc.colidx[None], c_loc.vals[None]

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(
                P(axis), P(axis), P(axis), P(axis),  # ring-plan A arrays
                P(axis), P(axis),  # B shards
                P(),  # padded global B rowptr (replicated, tiny)
            ),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )


def dist_spgemm_ring(
    a: ShardedCSR,
    b: ShardedCSR,
    b_rowptr_global: jax.Array,
    mesh: Mesh,
    prod_cap: int | None = None,
    out_cap: int | None = None,
    axis: str = "rows",
    ring_plan: RingPlan | None = None,
    a_full: CSR | None = None,
    b_full: CSR | None = None,
) -> ShardedCSR:
    """C = A @ B with both A and B row-sharded; B blocks ride the ring.

    Pass ``ring_plan`` (make_ring_plan) or (a_full, b_full) to build one;
    the legacy (prod_cap, out_cap) form reconstructs the full operands from
    the shards first. Per-step work is one contiguous chunk slice of the
    owner-grouped stream (RingPlan docstring), double-buffered via
    ppermute-before-compute."""
    m, kdim = a.shape
    n = b.shape[1]
    if ring_plan is None:
        if a_full is None:
            a_full = unshard(a, trim=True)
        if b_full is None:
            b_full = unshard(ShardedCSR(b.rowptr, b.colidx, b.vals, b.shape))
        ring_plan = make_ring_plan(a_full, b_full, a.n_shards)
    st = ring_plan.statics
    fn = _ring_exec(mesh, axis, n, st, b.vals.dtype)
    rowptr, colidx, vals = fn(
        ring_plan.a_col, ring_plan.a_val, ring_plan.a_row,
        ring_plan.chunkptr, b.colidx, b.vals, ring_plan.rp_glob_pad,
    )
    return ShardedCSR(rowptr, colidx, vals, (m, n), bounds=ring_plan.bounds)


# ---------------------------------------------------------------------------
# Distributed sparse addition (row-sharded, communication-free)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _spadd_exec(mesh, axis, m_loc, n, out_cap, dt):
    """Cached compiled row-sharded C = alpha*A + beta*B executable.

    Addition under a matching 1D row partition needs NO communication:
    every output row depends only on the same row of both operands, so the
    local kernel is the single-chip degenerate sort-merge (max_run=2)."""

    def local_fn(a_rp, a_ci, a_va, b_rp, b_ci, b_va, alpha, beta):
        a_loc = CSR(a_rp[0], a_ci[0], a_va[0], (m_loc, n))
        b_loc = CSR(b_rp[0], b_ci[0], b_va[0], (m_loc, n))
        row = jnp.concatenate([a_loc.row_ids(), b_loc.row_ids()])
        col = jnp.concatenate([a_loc.colidx, b_loc.colidx]).astype(INDEX_DTYPE)
        val = jnp.concatenate(
            [a_loc.vals.astype(dt) * alpha.astype(dt),
             b_loc.vals.astype(dt) * beta.astype(dt)]
        )
        prodstart = jnp.concatenate(
            [jnp.zeros((1,), INDEX_DTYPE),
             jnp.cumsum(a_loc.row_lengths() + b_loc.row_lengths())]
        ).astype(INDEX_DTYPE)
        c_loc = merge_products(
            row.astype(INDEX_DTYPE), col, val, m_loc, n, out_cap,
            max_run=2, val_dtype=dt, prodstart=prodstart,
        )
        return c_loc.rowptr[None], c_loc.colidx[None], c_loc.vals[None]

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axis),) * 6 + (P(), P()),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )


def dist_spadd(
    a: CSR, b: CSR, mesh: Mesh, alpha=1.0, beta=1.0, axis: str = "rows"
) -> CSR:
    """Host-facing distributed C = alpha*A + beta*B: shard rows, local
    merge on every device (no collectives), unshard."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} + {b.shape}")
    n_shards = mesh.shape[axis]
    a_sh = shard_rows(a, n_shards)
    b_sh = shard_rows(b, n_shards)
    if b_sh.m_loc != a_sh.m_loc:  # same m, same shard count -> always equal
        raise AssertionError("row partitions disagree")
    out_cap = pad_bucket(a_sh.cap + b_sh.cap)
    dt = jnp.promote_types(a.dtype, b.dtype)
    fn = _spadd_exec(mesh, axis, a_sh.m_loc, a.n, out_cap, dt)
    rowptr, colidx, vals = fn(
        a_sh.rowptr, a_sh.colidx, a_sh.vals,
        b_sh.rowptr, b_sh.colidx, b_sh.vals,
        jnp.asarray(alpha, dt), jnp.asarray(beta, dt),
    )
    return unshard(ShardedCSR(rowptr, colidx, vals, a.shape))


def make_mesh(n_devices: int | None = None, axis: str = "rows") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


# host-side caches keyed on the operand's buffer ids: re-sharding (an O(P)
# host copy loop) and plan building are structure-only and reusable across
# calls on the same matrix (VERDICT r1 weak #3: dist_spgemm re-sharded A/B
# from scratch on every call)
_SHARD_CACHE: dict = {}
_PLAN_CACHE: dict = {}


def shard_rows_cached(a: CSR, mesh: Mesh, axis: str = "rows") -> ShardedCSR:
    """``shard_rows`` over the mesh's ``axis``, placed on the mesh, cached
    per (matrix, mesh)."""
    key = (id(a.rowptr), id(a.colidx), id(a.vals), mesh, axis)
    hit = _SHARD_CACHE.get(key)
    if hit is None:
        if len(_SHARD_CACHE) > 64:
            _SHARD_CACHE.clear()
        # hold the keyed buffers: id() values recycle after GC and a stale
        # hit would return another matrix's sharded form (same bug class as
        # ops/dispatch._stats)
        sharded = on_mesh(shard_rows(a, mesh.shape[axis]), mesh, axis)
        hit = _SHARD_CACHE[key] = (sharded, (a.rowptr, a.colidx, a.vals))
    return hit[0]


def dist_spgemm(
    a: CSR, b: CSR, mesh: Mesh, *, schedule: str = "replicated",
    axis: str = "rows", ring_hop: int | None = None,
) -> CSR:
    """Host-facing distributed C = A @ B: shard, run, unshard.

    schedule: 'replicated' (B on every device), 'ring' (B row-sharded,
    ppermute rotation) or 'halo' (B row-sharded, remote rows fetched by a
    padded all-to-all).
    Sharded forms and local plans are cached per (matrix, P).

    ring_hop: blocks per resident ring super-buffer (None = P//4 when it
    divides P, else 1 — the round-5 coarsened schedule; H x B-shard
    memory for 1/H of the per-hop schedule overhead)."""
    n_shards = mesh.shape[axis]
    if schedule == "halo":
        from .halo import spgemm_halo

        return spgemm_halo(a, b, mesh, axis)
    a_sh = shard_rows_cached(a, mesh, axis)
    pkey = (id(a.rowptr), id(a.colidx), id(b.rowptr), n_shards, schedule)
    hit = _PLAN_CACHE.get(pkey)
    plan = hit[0] if hit is not None else None

    def _remember(p):
        if len(_PLAN_CACHE) > 64:
            _PLAN_CACHE.clear()
        # hold the keyed buffers (see shard_rows_cached)
        _PLAN_CACHE[pkey] = (p, (a.rowptr, a.colidx, b.rowptr))
        return p

    if schedule == "replicated":
        if plan is None:
            # local kernel by measured cost model: grouped wins the
            # reference-scale row mixes (webbase/scircuit/econ regimes),
            # chunked the rest — same dispatch the single-chip core uses
            from ..ops.dispatch import (
                estimate_chunked_s,
                estimate_grouped_s,
            )

            gp = None
            if estimate_grouped_s(a) < estimate_chunked_s(a):
                gp = make_dist_grouped_plan(a, b, n_shards)
            plan = _remember(
                gp if gp is not None
                else make_dist_local_plan(a, b, n_shards)
            )
        if isinstance(plan, DistGroupedPlan):
            c_sh = dist_spgemm_replicated(
                a_sh, b, mesh, axis=axis, grouped_plan=plan
            )
        else:
            c_sh = dist_spgemm_replicated(a_sh, b, mesh, axis=axis, plan=plan)
    elif schedule == "ring":
        if ring_hop is None:
            ring_hop = (
                n_shards // 4 if n_shards % 4 == 0 and n_shards >= 8 else 1
            )
        pkey = pkey + (ring_hop,)
        hit = _PLAN_CACHE.get(pkey)
        plan = hit[0] if hit is not None else None
        if plan is None:
            plan = _remember(make_ring_plan(a, b, n_shards, hop=ring_hop))
        b_sh = shard_rows_cached(b, mesh, axis)
        c_sh = dist_spgemm_ring(
            a_sh, b_sh, b.rowptr, mesh, axis=axis, ring_plan=plan
        )
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return unshard(c_sh)
