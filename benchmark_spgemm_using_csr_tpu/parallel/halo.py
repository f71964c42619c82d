"""Halo-exchange distributed SpGEMM: B row-sharded, remote B rows fetched
by a padded ``all_to_all`` exchange (BASELINE.json config #5 and
north-star: "exchanging remote B rows (the halo of A's column indices) via
ragged all-to-all collectives"; SURVEY.md §7.8/§9 step 7 phase B). The
exchange is ragged in content and padded in shape: ``jax.lax.
ragged_all_to_all`` is not implemented on XLA:CPU and returned wrong halo
rows on four H100s at webbase_1m scale (PERF.md), so it is not used.

The reference is single-GPU — this subsystem is new design. Structure:

1. **Host halo plan** (off the hot path, like the reference's host-side
   stage-2 binning): for each shard j, the sorted unique global B rows its
   local A columns touch (the *halo*); for each owner/requester pair (i, j)
   the payload slice owner i must send requester j. All slice offsets /
   sizes are host-precomputed into (P, P) tables, and local A's column ids
   are remapped to halo-local row indices so the device-side compute is a
   plain local SpGEMM against the assembled halo-B.

2. **Device exchange + compute** under ``shard_map``: gather the send
   payload rows from local B (one ragged row gather), two exchanges
   (colidx + vals) land every requested row
   contiguously in global-row order on the requester, then expand–sort–
   compress the local product stream. XLA overlaps the collective with the
   local expansion automatically (both depend only on inputs).

Unlike the replicated schedule, per-device B traffic is O(halo nnz), not
O(nnz B) — the memory- and bandwidth-scalable path for B too large to
replicate.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..sparse.csr import CSR, INDEX_DTYPE, pad_bucket
from ..ops.chunked import (
    ChunkedPlan,
    _expand_chunks,
    merge_products,
    pad_gentle,
    row_product_offsets,
    spgemm_chunked,
)
from .dist import (
    ShardedCSR,
    make_dist_local_plan,
    on_mesh,
    shard_rows,
    unshard,
)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-precomputed exchange plan for one (A, B, mesh-size) triple."""

    a_sh: ShardedCSR  # local A with colidx remapped to halo-local B rows
    send_rows: jax.Array  # (P, send_rows_cap) local B row ids, dest-major, pad k_loc
    input_offsets: jax.Array  # (P, P) offsets into the send payload per dest
    send_sizes: jax.Array  # (P, P)
    recv_sizes: jax.Array  # (P, P)
    recv_offsets: jax.Array  # (P, P) [j, i]: where i's slice lands in j's halo
    halo_rowptr: jax.Array  # (P, halo_rows_cap + 1) rowptr of assembled halo B
    send_payload_cap: int
    halo_nnz_cap: int
    chunk_cap: int  # max single (i -> j) slice: the padded exchange width
    prod_cap: int
    out_cap: int
    shape_b: Tuple[int, int]
    # tuned per-shard local-kernel plan (make_dist_local_plan): the local
    # SpGEMM runs the full single-chip chunked machinery, not a fixed k
    local_plan: ChunkedPlan | None = None


def build_halo_plan(
    a: CSR, b: CSR, n_shards: int, bounds: np.ndarray | None = None
) -> HaloPlan:
    """Compute the halo plan on the host (plan once, run many).

    bounds: product-balanced A-row boundaries (dist.balanced_row_bounds) —
    non-uniform contiguous row blocks per shard (VERDICT r3 next #4)."""
    m, k = a.shape
    n = b.n
    a_rowptr = np.asarray(a.rowptr)
    a_colidx = np.asarray(a.colidx)
    b_rowptr = np.asarray(b.rowptr)
    b_len = np.diff(b_rowptr)

    a_sh = shard_rows(a, n_shards, bounds=bounds)
    m_loc = a_sh.m_loc
    k_pad = ((k + n_shards - 1) // n_shards) * n_shards
    k_loc = k_pad // n_shards

    # --- per-shard halo: sorted unique B rows touched by local A ----------
    # Fully vectorized (VERDICT r2 weak #7: the pairwise O(P^2) Python
    # loops were a minutes-long host stall at pod scale): one global
    # (shard, col) unique gives every shard's sorted halo at once, and the
    # (owner, requester) exchange tables fall out of bincounts + exclusive
    # cumsums over the (P, P) size matrix.
    nnz_a = int(a_rowptr[-1])
    if bounds is None:
        m_padded = n_shards * m_loc
        rowptr_full = np.concatenate(
            [a_rowptr, np.full(m_padded - m, a_rowptr[-1], a_rowptr.dtype)]
        ).astype(np.int64)
        entry_shard = np.repeat(
            np.arange(m_padded, dtype=np.int64) // m_loc,
            np.diff(rowptr_full),
        )
    else:
        row_of_shard = (
            np.searchsorted(np.asarray(bounds, np.int64), np.arange(m),
                            side="right") - 1
        )
        entry_shard = np.repeat(
            row_of_shard, np.diff(a_rowptr.astype(np.int64)[: m + 1])
        )
    uk = np.unique(entry_shard * (k + 1) + a_colidx[:nnz_a].astype(np.int64))
    req = uk // (k + 1)  # requester shard of each unique halo row (sorted)
    hrow = uk % (k + 1)  # global B row id (sorted within each requester)
    halo_starts = np.searchsorted(req, np.arange(n_shards + 1))
    halo_sizes = np.diff(halo_starts)
    hlen = b_len[hrow].astype(np.int64)  # nnz of each halo row
    halo_nnz = np.bincount(req, weights=hlen, minlength=n_shards).astype(
        np.int64
    )
    halo_rows_cap = pad_bucket(int(halo_sizes.max(initial=1)) or 1)
    halo_nnz_cap = pad_bucket(int(halo_nnz.max(initial=1)) or 1)

    # halo rowptr per shard (rows in sorted global order): scatter lengths
    # into the padded (P, cap) grid, cumsum along rows
    within = np.arange(len(uk), dtype=np.int64) - halo_starts[req]
    lens_grid = np.zeros((n_shards, halo_rows_cap), np.int64)
    lens_grid[req, within] = hlen
    halo_rowptr = np.zeros((n_shards, halo_rows_cap + 1), np.int32)
    halo_rowptr[:, 1:] = np.cumsum(lens_grid, axis=1)

    # --- exchange tables: owner i -> requester j ---------------------------
    # halo of j is sorted by global row id == owner-major; the slice j needs
    # from owner i is contiguous in both j's halo and i's send buffer.
    owner = hrow // k_loc
    szmat = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(szmat, (owner, req), hlen)
    send_sizes = szmat.astype(np.int32)
    recv_sizes = szmat.T.copy().astype(np.int32)
    # input_offsets[i, j]: exclusive cumsum over j within owner i's buffer
    input_offsets = (np.cumsum(szmat, axis=1) - szmat).astype(np.int32)
    # recv_offsets[j, i]: where i's slice lands in j's halo (exclusive
    # cumsum over owners i)
    recv_offsets = (np.cumsum(szmat, axis=0) - szmat).T.astype(np.int32)

    # send row lists, owner-major then requester-major then row-sorted:
    # exactly the (owner, requester, row) lexicographic order of the
    # unique halo entries
    order = np.lexsort((hrow, req, owner))
    o_s, h_s = owner[order], hrow[order]
    send_counts = np.bincount(owner, minlength=n_shards)
    send_starts = np.concatenate([[0], np.cumsum(send_counts)])
    send_within = np.arange(len(uk), dtype=np.int64) - send_starts[o_s]
    send_rows_cap = pad_bucket(int(send_counts.max(initial=1)) or 1)
    send_rows = np.full((n_shards, send_rows_cap), k_loc, np.int32)
    send_rows[o_s, send_within] = (h_s - o_s * k_loc).astype(np.int32)
    send_payload_cap = pad_bucket(
        int((input_offsets[:, -1] + szmat[:, -1]).max(initial=1)) or 1
    )

    # --- remap local A colidx -> halo-local row index -----------------------
    # one searchsorted over the global (shard, col) key space: uk is sorted,
    # so positions within each shard's halo are global positions minus the
    # shard's halo start
    rp = np.asarray(a_sh.rowptr)
    ci = np.asarray(a_sh.colidx).astype(np.int64)
    lane = np.arange(ci.shape[1], dtype=np.int64)
    valid = lane[None, :] < rp[:, -1:].astype(np.int64)
    keys = np.where(
        valid,
        np.arange(n_shards, dtype=np.int64)[:, None] * (k + 1) + ci,
        0,
    )
    pos = np.searchsorted(uk, keys.reshape(-1)).reshape(keys.shape)
    local = pos - halo_starts[np.arange(n_shards)][:, None]
    ci = np.where(valid, local, ci).astype(np.int32)
    a_remap = ShardedCSR(
        a_sh.rowptr, jnp.asarray(ci), a_sh.vals, (m, k), bounds=a_sh.bounds
    )

    # --- per-shard product bound for static capacities ----------------------
    prods = np.bincount(
        entry_shard, weights=b_len[a_colidx[:nnz_a]], minlength=n_shards
    ).astype(np.int64)
    prod_cap = pad_bucket(int(prods.max(initial=1)) or 1)

    local_plan = make_dist_local_plan(
        a, b, n_shards,
        halo_lens=[
            hlen[halo_starts[j]:halo_starts[j + 1]]
            for j in range(n_shards)
        ],
        bounds=bounds,
    )

    return HaloPlan(
        local_plan=local_plan,
        a_sh=a_remap,
        send_rows=jnp.asarray(send_rows),
        input_offsets=jnp.asarray(input_offsets),
        send_sizes=jnp.asarray(send_sizes),
        recv_sizes=jnp.asarray(recv_sizes),
        recv_offsets=jnp.asarray(recv_offsets),
        halo_rowptr=jnp.asarray(halo_rowptr),
        send_payload_cap=send_payload_cap,
        halo_nnz_cap=halo_nnz_cap,
        chunk_cap=pad_bucket(int(send_sizes.max(initial=1))),
        prod_cap=prod_cap,
        out_cap=prod_cap,
        shape_b=(k, n),
    )


def _padded_a2a_exchange(
    data, out, in_off, send_sz, recv_off, recv_sz, axis: str, chunk_cap: int
):
    """The B-row exchange: a ragged all-to-all carried by a padded one.

    Each (sender, receiver) slice is padded to the static ``chunk_cap``; the
    dense (P, chunk_cap) tensor rides one ``all_to_all``, then slices land at
    their receiver-side offsets via a masked scatter. Extra bytes moved:
    sum(chunk_cap - size) — the price of raggedness.
    """
    n_shards = in_off.shape[0]
    lane = jnp.arange(chunk_cap, dtype=INDEX_DTYPE)
    src = in_off[:, None] + lane[None, :]
    valid = lane[None, :] < send_sz[:, None]
    send = jnp.where(
        valid, data[jnp.clip(src, 0, data.shape[0] - 1)], 0
    )  # (P, chunk_cap)
    recv = jax.lax.all_to_all(
        send, axis, split_axis=0, concat_axis=0, tiled=True
    )  # (P, chunk_cap): slot i = slice from device i
    rvalid = lane[None, :] < recv_sz[:, None]
    tgt = jnp.where(rvalid, recv_off[:, None] + lane[None, :], out.shape[0])
    return out.at[tgt.reshape(-1)].set(recv.reshape(-1), mode="drop")


def dist_spgemm_halo(
    plan: HaloPlan,
    b: ShardedCSR,
    mesh: Mesh,
    axis: str = "rows",
) -> ShardedCSR:
    """Run the halo-exchange schedule: exchange B rows, local SpGEMM."""
    m, k = plan.a_sh.shape
    n = plan.shape_b[1]
    fn = _halo_exec(
        mesh, axis, plan.a_sh.m_loc, b.m_loc, n,
        plan.halo_rowptr.shape[1] - 1, plan.send_payload_cap,
        plan.halo_nnz_cap, plan.chunk_cap, plan.prod_cap, plan.out_cap,
        plan.local_plan,
    )
    rowptr, colidx, vals = fn(
        plan.a_sh.rowptr, plan.a_sh.colidx, plan.a_sh.vals,
        b.rowptr, b.colidx, b.vals,
        plan.send_rows, plan.input_offsets, plan.send_sizes,
        plan.recv_sizes, plan.recv_offsets,
        plan.halo_rowptr,
    )
    return ShardedCSR(rowptr, colidx, vals, (m, n), bounds=plan.a_sh.bounds)


@functools.lru_cache(maxsize=128)
def _halo_exec(
    mesh, axis, m_loc, k_loc, n, halo_rows_cap, send_payload_cap,
    halo_nnz_cap, chunk_cap, prod_cap, out_cap,
    local_plan: ChunkedPlan | None = None,
):
    """Cached compiled halo executable (re-tracing shard_map per call costs
    seconds; key = mesh + the plan's static capacities)."""

    def local_fn(
        a_rp, a_ci, a_va, b_rp, b_ci, b_va,
        send_rows, in_off, send_sz, recv_sz, recv_off, halo_rp,
    ):
        # 1. gather send payload rows from local B (dest-major concatenation)
        b_loc = CSR(b_rp[0], b_ci[0], b_va[0], (k_loc, n))
        from ..sparse.csr import csr_gather_rows

        payload = csr_gather_rows(b_loc, send_rows[0], send_payload_cap)

        # 2. exchange of colidx + vals
        halo_ci = _padded_a2a_exchange(
            payload.colidx, jnp.zeros(halo_nnz_cap, INDEX_DTYPE), in_off[0],
            send_sz[0], recv_off[0], recv_sz[0], axis, chunk_cap,
        )
        halo_va = _padded_a2a_exchange(
            payload.vals, jnp.zeros(halo_nnz_cap, a_va.dtype), in_off[0],
            send_sz[0], recv_off[0], recv_sz[0], axis, chunk_cap,
        )

        # 3. local SpGEMM against the assembled halo-B: the FULL tuned
        # single-chip chunked pipeline when a local plan is given (aligned
        # tables / wide split / scatter-SET / bounded compaction), else the
        # legacy fixed-k core
        a_loc = CSR(a_rp[0], a_ci[0], a_va[0], (m_loc, halo_rows_cap))
        b_halo = CSR(halo_rp[0], halo_ci, halo_va, (halo_rows_cap, n))
        if local_plan is not None:
            c_loc = spgemm_chunked(a_loc, b_halo, local_plan)
        else:
            chunk_k = 8
            chunks_cap = pad_gentle(prod_cap // chunk_k + a_loc.capacity + 1)
            row, col, val = _expand_chunks(a_loc, b_halo, chunk_k, chunks_cap)
            c_loc = merge_products(
                row, col, val, m_loc, n, out_cap, val_dtype=a_va.dtype,
                prodstart=row_product_offsets(a_loc, b_halo),
            )
        return c_loc.rowptr[None], c_loc.colidx[None], c_loc.vals[None]

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(
                P(axis), P(axis), P(axis),  # A
                P(axis), P(axis), P(axis),  # B
                P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            ),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )


def spgemm_halo(a: CSR, b: CSR, mesh: Mesh, axis: str = "rows") -> CSR:
    """Host-facing halo-schedule C = A @ B: plan, shard B, run, unshard."""
    n_shards = mesh.shape[axis]
    plan = build_halo_plan(a, b, n_shards)
    plan = dataclasses.replace(plan, a_sh=on_mesh(plan.a_sh, mesh, axis))
    b_sh = on_mesh(shard_rows(b, n_shards), mesh, axis)
    c_sh = dist_spgemm_halo(plan, b_sh, mesh, axis)
    return unshard(c_sh)
