"""Grouped-ESC SpGEMM — product-balanced ROW GROUPS turn the global product
sort into one (G, S) 2D sort with group-LOCAL packed keys.

Why: the chunked path's product sort pays for its GLOBAL scope twice —

- comparator depth: a bitonic sort runs log2(N)^2/2 stages over the whole
  stream (N = 10.9M slots at circuit_64k);
- the sort-key pack cliff: matrices with rbits + cbits > 32 (webbase_1m,
  scircuit_256k, econ-sized and up) cannot pack (row, col) into one int32
  key and fall back to the slower 3-operand 2-key sort.

But SpGEMM never needs a global sort: products only ever merge within one
C row. This path assigns whole rows to product-balanced groups of a static
slot capacity S (host plan, like ops/tilepack's greedy tile fill), lays the
chunk stream out group-strided, and sorts all groups INDEPENDENTLY with a
single 2D `jax.lax.sort` over (G, S):

- depth falls to log2(S)^2/2 (S ~ 2^14..2^17: 2-4x fewer stages);
- the key packs (local_row << cbits) | col into uint32 for ANY matrix
  size: local row ids only need bits for the rows of ONE group, chosen at
  plan time so lbits + cbits <= 32 — the pack cliff disappears.

Pipeline (one dispatch; stage numbers = reference SURVEY.md §4 — this is
the ESC method with the E and S stages reorganized around per-group sorts):

1. host plan: quantize per-entry products to chunks (narrow k == 1 or
   al-aligned), greedily fill rows into groups of `cs` chunk slots under
   the rows-per-group key-bit cap, build per-row slot offsets (stage 2
   binning analogue);
2. in-graph: propagate per-entry constants onto the group-strided chunk
   stream (ops/chunked scatter+cumsum machinery; k == 1 needs no
   remaining-length operand), expand products via the packed narrow
   (capB, 2) gather or whole aligned-table rows (ops/chunked
   _expand_aligned's trick with ops/tilepack's sentinel table);
3. ONE 2D sort of (key, val) along the group axis (stage 3 ESC);
4. segmented run-sum keyed on (group, key) equality; rowptr via an
   (m+1)-gather into the tail cumsum at HOST-KNOWN sorted offsets (group
   base + within-group product prefix — deterministic because the sort is
   per-group and rows are packed in order); monotone shift compaction
   (stage 4).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, host_view
from .chunked import (
    _propagate_entry_consts,
    _segmented_runsum,
    _shift_compact,
    pad_gentle,
)

F32 = jnp.float32
U32 = jnp.uint32
SENTINEL_U32 = np.uint32(0xFFFFFFFF)

@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """Hashable statics for one matrix structure profile."""

    k: int  # chunk width: 1 (narrow) or al (aligned table rows)
    al: int  # 0 = narrow per-pair gathers; >0 = al-aligned table (k == al)
    cs: int  # chunk slots per group
    g_cap: int  # padded group count
    abpad_cap: int  # aligned-table capacity in pairs (0 when al == 0)
    out_cap: int  # padded exact nnzC
    nnz_c: int  # exact nnz(C) (host structural product)
    cbits: int  # column bits in the packed (local_row, col) key
    lbits: int  # local-row bits (max rows per group fits)
    disp_bits: int  # compaction displacement bits (padding + duplicates)
    max_run: int  # run-sum pass bound (max nnz of any A row, padded)
    scatter_set: bool  # collision-free scatter-SET propagation
    # post-sort tail implementation: 'shift' = global runsum + log(holes)
    # shift compaction; 'scan' = fused block-scan runsum+compaction
    # (ops/scancompact — one stream pass instead of ~disp_bits passes).
    # scan won every grouped suite matrix in A/Bs on the first platform, so
    # it is the default; not yet re-measured on the GPU.
    tail_mode: str = "scan"

    @property
    def s_cap(self) -> int:  # chunk-slot stream length
        return self.g_cap * self.cs

    @property
    def lanes(self) -> int:
        return self.al if self.al else self.k

    @property
    def prod_cap(self) -> int:  # product-slot stream length
        return self.s_cap * self.lanes


def estimate_mode_ns(
    m: int, nnz_a: int, slots: int, desc: int, abpad: int
) -> float:
    """Grouped-pipeline cost of one mode in ns: the calibrated model of
    ops/dispatch.grouped_mode_terms."""
    from .dispatch import grouped_mode_terms, price

    return price(grouped_mode_terms(m, nnz_a, slots, desc, abpad)) * 1e9


@dataclasses.dataclass
class GroupedSchedule:
    """Plan + structure-derived device arrays (host-built once per
    structure, the stage-2 binning result)."""

    plan: GroupedPlan
    slot0: jax.Array  # (m,) int32 first chunk slot per row (group-strided)
    first_rank: jax.Array  # (g_cap,) int32 nonempty rows before each group
    sorted_off: jax.Array  # (m + 1,) int32 product-slot offset of each
    # row's sorted position: group_base + within-group product prefix
    fill_end: jax.Array  # (g_cap,) int32 absolute first PADDING slot per
    # group (group base + fill) — the -BIG injection targets


def make_grouped_plan(
    a: CSR, b: CSR, al: int | None = None, target_slots: int | None = None,
    fixed: GroupedPlan | None = None,
    force_scatter_set: bool | None = None,
    tail_mode: str = "scan",
) -> GroupedSchedule | None:
    """Host stage-2: chunk quantization -> greedy row->group packing.

    al: None sweeps {narrow k=1, aligned al=8} with the measured cost
    model; 0 forces narrow; >0 forces that table alignment. Returns None
    when the matrix doesn't fit the regime (empty, f64 values, a single
    row's products exceed any viable group, or the structural product is
    too large to count exactly on the host).

    fixed: build this matrix's schedule under ANOTHER plan's statics
    (mode, cs, g_cap, capacities) — shard_map runs one static program per
    shard, so distributed schedules unify per-shard plans this way
    (parallel/dist.make_dist_grouped_plan). The fixed statics must cover
    this matrix (asserted).
    """
    m, n = a.m, b.n
    if m == 0 or n == 0:
        return None
    if fixed is not None:
        al = fixed.al
    if a.vals.dtype not in (
        jnp.float32, jnp.bfloat16, jnp.float16, jnp.float64
    ):
        return None  # value bits must pack into int32 lanes (f64 uses two)
    a_rowptr = host_view(a.rowptr)[: m + 1].astype(np.int64)
    nnz_a = int(a_rowptr[-1])
    b_rowptr = host_view(b.rowptr).astype(np.int64)
    b_len = np.diff(b_rowptr)
    lens = b_len[host_view(a.colidx)[:nnz_a]]
    total = int(lens.sum())
    if fixed is None and (total == 0 or total > (1 << 27)):
        return None
    assert total <= (1 << 27), "fixed statics cannot cover this stream"

    cbits = max(int(n - 1).bit_length(), 1)
    if cbits > 31:
        return None
    # mode selection: narrow k=1 (1 product per descriptor, no padding)
    # vs al-aligned tables (al pairs per descriptor, ceil(len/al) padding)
    # over al in {2, 4, 8} — tiny-row matrices (webbase: mean B row 4.4)
    # waste ~2x slots at al=8 but only ~1.3x at al=2 while still halving
    # the descriptor count. The calibrated cost (estimate_mode_ns) picks
    # per matrix.
    if al is None:
        al, best = 0, estimate_mode_ns(m, nnz_a, total, total, 0)
        for cand in (2, 4, 8):
            slots_c = int((-(-lens // cand)).sum()) * cand
            abpad_c = int((-(-b_len // cand) * cand).sum())
            # table-build guard: the (nrows_tbl, al, 1+vw) gather output
            # pads its trailing dims to (8, 128) tiles when XLA fails to
            # fuse it — measured OOM at al=2 with 11.5M table rows (11 GB,
            # 64x expansion). al=8 has fused reliably up to ~1M rows
            # (webbase r2); keep small-al tables under 512k rows.
            nrows_c = abpad_c // cand
            if nrows_c > (512 << 10 if cand < 8 else 2 << 20):
                continue
            cost_c = estimate_mode_ns(
                m, nnz_a, slots_c, slots_c // cand, abpad_c
            )
            if cost_c < best:
                al, best = cand, cost_c
    lanes = al if al else 1

    # per-entry chunk counts and per-row chunk sums
    chunks_e = -(-lens // lanes)
    if fixed is not None:
        scatter_set = fixed.scatter_set
    elif force_scatter_set is not None:
        scatter_set = force_scatter_set
    else:
        n_zero = int((chunks_e == 0).sum())
        scatter_set = n_zero <= max(nnz_a // 16, 64)
    if scatter_set:
        chunks_e = np.maximum(chunks_e, 1)
    cce = np.concatenate([[0], np.cumsum(chunks_e)])
    row_chunks = (cce[a_rowptr[1:]] - cce[a_rowptr[:-1]]).astype(np.int64)
    max_chunks = int(row_chunks.max(initial=1))
    total_chunks = int(cce[-1])

    # group capacity cap: rows per group are limited so the packed key
    # (local_row << cbits) | col stays a uint32 BELOW the all-ones
    # sentinel; the chunk cap is SWEPT to minimize padded stream size,
    # because the two caps interact (tiny-row regions close groups on the
    # row cap at low fill while fat-row regions fill the chunk cap —
    # a single fixed cap left webbase_1m groups 40% empty)
    max_rows_cap = (1 << min(32 - cbits, 30)) - 1
    if max_rows_cap < 1:
        return None

    cum_chunks = cce[a_rowptr]  # (m + 1,) chunks before each row
    ne_flag = (row_chunks > 0).astype(np.int64)
    cum_ne = np.concatenate([[0], np.cumsum(ne_flag)])

    def greedy(cap: int):
        """Greedy row->group boundaries under chunk cap + row-key cap,
        O(G log m) via searchsorted (row order preserved -> flat sorted
        stream is globally row-ordered)."""
        bounds = [0]
        b = 0
        while b < m:
            nb_c = int(
                np.searchsorted(cum_chunks, cum_chunks[b] + cap, "right") - 1
            )
            nb_r = int(
                np.searchsorted(cum_ne, cum_ne[b] + max_rows_cap, "right") - 1
            )
            nb = min(max(nb_c, b + 1), max(nb_r, b + 1), m)
            bounds.append(nb)
            b = nb
        return np.asarray(bounds, np.int64)

    if fixed is not None:
        bounds = greedy(fixed.cs)
        fills = cum_chunks[bounds[1:]] - cum_chunks[bounds[:-1]]
        cs = fixed.cs
        assert int(fills.max(initial=0)) <= cs, "fixed cs too small"
    else:
        if target_slots is None:
            cap0 = int(
                np.clip(total_chunks * lanes / 64, 1 << 13, 1 << 17)
            ) // lanes
        else:
            cap0 = -(-target_slots // lanes)
        best = None
        for cap in {max(cap0, max_chunks), max(cap0 // 2, max_chunks),
                    max(cap0 // 4, max_chunks), max(cap0 * 2, max_chunks)}:
            bounds = greedy(cap)
            fills = cum_chunks[bounds[1:]] - cum_chunks[bounds[:-1]]
            cs_try = int(fills.max(initial=1))
            padded = pad_gentle(len(bounds) - 1, minimum=1) * cs_try
            # depth-aware cost: every padded slot rides the whole pipeline
            # plus a bitonic sort whose per-element cost grows with
            # log2(width)^2 (relative weights from the first platform; not
            # re-measured on the GPU)
            w_try = cs_try * lanes
            sort_ns = 0.0035 * 0.5 * max(int(w_try - 1).bit_length(), 1) ** 2
            cost = padded * (8.0 + sort_ns)
            if best is None or cost < best[0]:
                best = (cost, bounds, fills, cs_try)
        _, bounds, fills, cs = best
    n_groups = len(bounds) - 1
    tile_of = np.searchsorted(bounds, np.arange(m), "right") - 1
    base_chunk = cum_chunks[:m] - cum_chunks[bounds[tile_of]]
    if fixed is not None:
        assert n_groups <= fixed.g_cap, "fixed g_cap too small"
        g_cap = fixed.g_cap
    else:
        g_cap = pad_gentle(n_groups, minimum=1)
    first_rank_l = list(cum_ne[bounds[:-1]])
    rank = int(cum_ne[m])
    fill_end = np.zeros(g_cap, np.int64)
    fill_end[:n_groups] = fills
    fill_end += np.arange(g_cap, dtype=np.int64) * cs  # absolute slot
    first_rank = np.zeros(g_cap, np.int32)
    first_rank[: len(first_rank_l)] = first_rank_l
    first_rank[len(first_rank_l):] = rank
    ranks = np.asarray(first_rank_l + [rank])
    max_rows_group = int(np.diff(ranks).max(initial=1))
    lbits = max(int(max_rows_group - 1).bit_length(), 1)
    if lbits + cbits > 32:
        return None

    prod_cap = g_cap * cs * lanes
    if fixed is None:
        # exact nnzC; padding + duplicates bound every kept element's
        # compaction displacement (group-tail padding precedes later
        # groups' kept slots, unlike the global-sort path where all
        # padding tails)
        pat_a = a.to_scipy().astype(bool)
        pat_b = pat_a if b is a else b.to_scipy().astype(bool)
        nnz_c = int((pat_a @ pat_b).nnz)
        disp_bits = max(int(prod_cap - nnz_c).bit_length(), 1)

        abpad_cap = 0
        if al:
            abpad = int((-(-b_len // al) * al).sum())
            # +al guarantees >= 1 all-sentinel table row past the aligned
            # region for dummy chunks of zero-length B rows
            abpad_cap = max(-(-pad_gentle(abpad + al) // al) * al, al)

    # per-row sorted product offset: group base + within-group VALID
    # product prefix. The sort is per-group with rows packed in rank
    # order and every pad lane carrying the max sentinel, so each row's
    # valid products occupy a HOST-KNOWN span: after all previous rows'
    # valid products, before the group's sentinel tail.
    lens_prefix = np.concatenate([[0], np.cumsum(lens)])
    row_vp = lens_prefix[a_rowptr]  # (m + 1,) valid products before row r
    # subtract each group's first nonempty row's prefix
    seen = np.full(n_groups, -1, np.int64)
    for r in range(m - 1, -1, -1):
        if row_chunks[r] > 0:
            seen[tile_of[r]] = row_vp[r]
    # groups with no nonempty row keep -1 -> their rows sit at the group
    # base; empty rows BEFORE a group's first nonempty row clamp to 0
    sg = seen[tile_of]
    within = np.where(sg >= 0, np.maximum(row_vp[:m] - sg, 0), 0)
    sorted_off = (tile_of * (cs * lanes) + within).astype(np.int64)
    # empty rows point at where their (empty) run would start; rows after
    # the last nonempty row of a group point at the group's fill end,
    # which is <= the next group's base — monotone enough for the
    # exclusive-gather rowptr (their count is 0 either way)
    sorted_off_full = np.concatenate(
        [sorted_off, [int(prod_cap)]]
    ).astype(np.int32)

    if fixed is not None:
        max_run = 1 << max(
            int(np.diff(a_rowptr).max(initial=1) - 1).bit_length(), 0
        )
        assert max_run <= fixed.max_run, "fixed max_run too small"
        plan = fixed  # verbatim: shard_map needs ONE static program
    else:
        plan = GroupedPlan(
            k=lanes,
            al=al,
            cs=int(cs),
            g_cap=int(g_cap),
            abpad_cap=int(abpad_cap),
            out_cap=min(pad_gentle(max(nnz_c, 1)), prod_cap),
            nnz_c=nnz_c,
            cbits=cbits,
            lbits=lbits,
            disp_bits=disp_bits,
            max_run=int(
                1 << max(
                    int(np.diff(a_rowptr).max(initial=1) - 1).bit_length(), 0
                )
            ),
            scatter_set=bool(scatter_set),
            tail_mode=tail_mode,
        )
    slot0 = (tile_of * cs + base_chunk).astype(np.int32)
    return GroupedSchedule(
        plan=plan,
        slot0=jnp.asarray(slot0),
        first_rank=jnp.asarray(first_rank),
        sorted_off=jnp.asarray(sorted_off_full),
        fill_end=jnp.asarray(fill_end.astype(np.int32)),
    )


def spgemm_grouped(a: CSR, b: CSR, sched: GroupedSchedule) -> CSR:
    """C = A @ B in one dispatch via grouped per-row sorts."""
    return _spgemm_grouped(
        a, b, sched.slot0, sched.first_rank, sched.sorted_off,
        sched.fill_end, sched.plan
    )


@partial(jax.jit, static_argnames=("plan",))
def _spgemm_grouped(
    a: CSR, b: CSR, slot0, first_rank, sorted_off, fill_end,
    plan: GroupedPlan
) -> CSR:
    m, n = a.m, b.n
    al, lanes = plan.al, plan.lanes
    S = plan.s_cap  # chunk slots
    W = plan.cs * lanes  # product slots per group
    # f64 double-word lane (VERDICT r2 #7): values ride TWO packed int32
    # lanes end-to-end (gather tables, propagation, sort operands) and are
    # reconstituted to f64 only for the product multiply and run-sum — the
    # descriptor/sort machinery never widens. Representation: hi/lo f32
    # SPLIT (48 mantissa bits, ~2e-15 relative — inside the x64 oracle's
    # rtol 1e-12), NOT a raw f64<->2xi32 bitcast, which the first
    # platform's compiler could not lower. The GPU has native f64, so this
    # lane is a candidate for removal (ROADMAP Reach 2).
    dd = a.vals.dtype == jnp.float64
    vdt = jnp.float64 if dd else F32
    vw = 2 if dd else 1  # value int32 lanes

    def _v_bits(x):  # (…,) vdt -> (…, vw) int32
        if not dd:
            return jax.lax.bitcast_convert_type(
                x.astype(F32), jnp.int32
            )[..., None]
        hi = x.astype(jnp.float32)
        lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
        return jnp.stack(
            [
                jax.lax.bitcast_convert_type(hi, jnp.int32),
                jax.lax.bitcast_convert_type(lo, jnp.int32),
            ],
            axis=-1,
        )

    def _v_from(bits):  # (…, vw) int32 -> (…,) vdt
        if not dd:
            return jax.lax.bitcast_convert_type(bits[..., 0], F32)
        hi = jax.lax.bitcast_convert_type(bits[..., 0], jnp.float32)
        lo = jax.lax.bitcast_convert_type(bits[..., 1], jnp.float32)
        return hi.astype(jnp.float64) + lo.astype(jnp.float64)

    # ---- per-entry chunk metadata -> group-strided slot destinations ----
    a_rows = a.row_ids()
    entry_valid = a_rows < m
    if al:
        nrows_tbl = plan.abpad_cap // al
        # aligned packed B table with sentinel pad lanes (col == -1), the
        # ops/tilepack build: lane validity comes from the table, not from
        # a remaining-length propagation
        b_len_all = b.row_lengths().astype(INDEX_DTYPE)
        ws = ((b_len_all + al - 1) // al) * al
        pstart = jnp.concatenate(
            [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(ws)]
        )[:-1]
        tstart = pstart // al
        hits_t = jnp.zeros(nrows_tbl, INDEX_DTYPE).at[tstart[1:]].add(
            1, mode="drop"
        )
        rowid = jnp.cumsum(hits_t)
        rp = b.rowptr.astype(INDEX_DTYPE)
        tmeta = jnp.stack([rp[:-1] - pstart, rp[1:]], axis=1)
        tm = tmeta[rowid, :]
        t_ids = jnp.arange(nrows_tbl, dtype=INDEX_DTYPE)
        src0 = tm[:, 0] + t_ids * al
        lane = jnp.arange(al, dtype=INDEX_DTYPE)
        src_l = src0[:, None] + lane[None, :]
        valid_tbl = src_l < tm[:, 1:2]
        src2 = jnp.clip(src_l, 0, b.capacity - 1)
        b_packed = jnp.concatenate(
            [b.colidx.astype(jnp.int32)[:, None], _v_bits(b.vals)], axis=1
        )  # (cap, 1 + vw)
        raw = b_packed[src2.reshape(-1), :].reshape(nrows_tbl, al, 1 + vw)
        tbl = jnp.concatenate(
            [
                jnp.where(valid_tbl, raw[:, :, 0], -1)[:, :, None],
                jnp.where(valid_tbl[:, :, None], raw[:, :, 1:], 0),
            ],
            axis=2,
        ).reshape(nrows_tbl, (1 + vw) * al)
        meta_pair = jnp.stack([pstart, b_len_all], axis=1)
        pair = meta_pair[a.colidx, :]
        p_start0 = pair[:, 0]
        per_nz = jnp.where(entry_valid, pair[:, 1], 0)
        # zero-product entries (dummy chunks under scatter-SET) read the
        # guaranteed all-sentinel pad region past the aligned table
        p_start = jnp.where(per_nz > 0, p_start0, plan.abpad_cap - al)
    else:
        rp = b.rowptr.astype(INDEX_DTYPE)
        rp_pair = jnp.stack([rp[:-1], rp[1:]], axis=1)
        pair = rp_pair[a.colidx, :]
        per_nz = jnp.where(entry_valid, pair[:, 1] - pair[:, 0], 0)
        # k == 1: dummy/invalid chunks are marked through pos's SIGN
        # (ops/chunked._expand_chunks' k == 1 special case)
        p_start = jnp.where(
            per_nz > 0, pair[:, 0], jnp.asarray(-1, INDEX_DTYPE)
        )

    n_chunks_per = (per_nz + (lanes - 1)) // lanes
    if plan.scatter_set:
        n_chunks_per = jnp.where(
            entry_valid, jnp.maximum(n_chunks_per, 1), 0
        )
    ends = jnp.cumsum(n_chunks_per)
    starts = ends - n_chunks_per
    arp = a.rowptr.astype(INDEX_DTYPE)
    row_chunk_start = jnp.where(arp > 0, ends[jnp.maximum(arp - 1, 0)], 0)

    # first slot per entry: fs = starts + (slot0[row] - row_chunk_start),
    # the bracket spread to entries by row-boundary delta scatter
    g_row = slot0.astype(INDEX_DTYPE) - row_chunk_start[:-1]
    d_g = g_row - jnp.concatenate([jnp.zeros((1,), g_row.dtype), g_row[:-1]])
    spread = jnp.zeros(a.capacity, INDEX_DTYPE).at[arp[:-1]].add(
        d_g, mode="drop"
    )
    fs = starts + jnp.cumsum(spread)

    # posb propagation with GROUP-BOUNDARY liveness injections: every slot
    # past a group's fill carries pos < 0 until the next group's base,
    # because -BIG lands at each group's fill end and +BIG at each group
    # base (g >= 1). Empty groups net to -BIG through their whole span,
    # full groups cancel exactly at the next base — so `pos >= 0` is the
    # complete liveness mask (dummy chunks already propagate pos == -1)
    # and the ROW-granularity rend scatter + S-cumsum of the first cut
    # (one m-descriptor scatter + a full-stream cumsum) disappear.
    BIG = jnp.asarray(1 << 30, INDEX_DTYPE)  # dominates lanes * s_ids
    # (prod_cap <= ~2.5e8 < 2^30) without int32 overflow
    q_posb = p_start - lanes * fs
    d_pb = q_posb - jnp.concatenate(
        [jnp.zeros((1,), q_posb.dtype), q_posb[:-1]]
    )
    acc = jnp.zeros(S, INDEX_DTYPE)
    if plan.scatter_set:
        acc = acc.at[fs].set(d_pb, mode="drop")
    else:
        acc = acc.at[fs].add(d_pb, mode="drop")
    g_bases = jnp.arange(1, plan.g_cap, dtype=INDEX_DTYPE) * plan.cs
    acc = acc.at[g_bases].add(BIG, mode="drop")
    acc = acc.at[fill_end.astype(INDEX_DTYPE)].add(-BIG, mode="drop")
    posb = jnp.cumsum(acc)

    q_aval = _v_bits(a.vals)  # (cap, vw)
    aval_bits = _propagate_entry_consts(
        fs, tuple(q_aval[:, j] for j in range(vw)), S,
        use_set=plan.scatter_set,
    )
    a_val = _v_from(jnp.stack(aval_bits, axis=-1))
    s_ids = jnp.arange(S, dtype=INDEX_DTYPE)
    pos = posb + lanes * s_ids
    row_chunks = row_chunk_start[1:] - row_chunk_start[:-1]

    # ---- expansion ------------------------------------------------------
    if al:
        trow = jnp.clip(pos // al, 0, nrows_tbl - 1)
        out = tbl[trow, :].reshape(-1, al, 1 + vw)
        col = out[:, :, 0]  # (S, al) triples-per-descriptor when dd
        b_val = _v_from(out[:, :, 1:])
        val = b_val * a_val[:, None]
        lv = (pos >= 0)[:, None] & (col >= 0)
    else:
        gidx = jnp.clip(pos, 0, b.capacity - 1)
        b_packed = jnp.concatenate(
            [b.colidx.astype(jnp.int32)[:, None], _v_bits(b.vals)], axis=1
        )
        tile = b_packed[gidx, :]  # (S, 1 + vw)
        col = tile[:, 0:1]
        b_val = _v_from(tile[:, 1:])[:, None]
        val = b_val * a_val[:, None]
        lv = (pos >= 0)[:, None]

    # ---- group-local packed keys ----------------------------------------
    # nonempty-row rank per slot (scatter +1 at each nonempty row's first
    # slot, cumsum) minus the group's first rank = local row id
    hits_r = jnp.zeros(S + 1, INDEX_DTYPE).at[
        jnp.where(row_chunks > 0, slot0.astype(INDEX_DTYPE), S)
    ].add(1, mode="drop")
    rank = jnp.cumsum(hits_r[:S])  # 1-based
    fr_b = jnp.broadcast_to(
        first_rank.astype(INDEX_DTYPE)[:, None], (plan.g_cap, plan.cs)
    ).reshape(-1)
    lr = rank - 1 - fr_b
    key_hi = (lr.astype(U32) << plan.cbits)
    key = jnp.where(
        lv, key_hi[:, None] | col.astype(U32), SENTINEL_U32
    )
    valm = jnp.where(lv, val, jnp.zeros((), val.dtype))

    key2 = key.reshape(plan.g_cap, W)
    # ---- ONE 2D sort: every group independently, log2(W)^2/2 depth ------
    if dd:
        # f64 values ride as two int32 sort operands (the sort unit never
        # sees a wide dtype); reconstituted after via the hi/lo split
        vb = _v_bits(valm)
        hi2 = vb[..., 0].reshape(plan.g_cap, W)
        lo2 = vb[..., 1].reshape(plan.g_cap, W)
        okey, ohi, olo = jax.lax.sort(
            (key2, hi2, lo2), dimension=1, num_keys=1, is_stable=False
        )
        okey = okey.reshape(-1)
        oval = _v_from(
            jnp.stack([ohi.reshape(-1), olo.reshape(-1)], axis=-1)
        )
    else:
        val2 = valm.reshape(plan.g_cap, W)
        # is_stable=False: a stable sort costs more, and duplicates are
        # merged by SUM so tie order among equal keys is irrelevant, and
        # pad slots all carry one sentinel.
        okey, oval = jax.lax.sort(
            (key2, val2), dimension=1, num_keys=1, is_stable=False
        )
        okey = okey.reshape(-1)
        oval = oval.reshape(-1)

    if plan.tail_mode == "scan":
        # ---- fused block-scan runsum + compaction (ops/scancompact) -----
        from .scancompact import runsum_compact_scan

        keyc_o, valc_o, tails_cum = runsum_compact_scan(
            okey, oval, w=W, out_cap=plan.out_cap, max_run=plan.max_run
        )
        exc = jnp.concatenate([jnp.zeros((1,), INDEX_DTYPE), tails_cum])
        rowptr = exc[jnp.clip(sorted_off, 0, exc.shape[0] - 1)]
        out_col = (
            keyc_o.astype(U32) & ((1 << plan.cbits) - 1)
        ).astype(INDEX_DTYPE)
        out_val = valc_o.astype(a.vals.dtype)
    else:
        # ---- segmented run-sum + tails ----------------------------------
        # runs never straddle groups: reuse the chunked run-sum with row :=
        # group id (a broadcasted iota — no gather) and col := packed key
        gid = jax.lax.broadcasted_iota(
            jnp.int32, (plan.g_cap, W), 0
        ).reshape(-1)
        run = _segmented_runsum(gid, okey.astype(jnp.int32), oval,
                                max_run=plan.max_run)
        valid_s = okey != SENTINEL_U32
        nxt_same = jnp.concatenate(
            [
                (okey[1:] == okey[:-1]) & (gid[1:] == gid[:-1]),
                jnp.zeros((1,), jnp.bool_),
            ]
        )
        kept = valid_s & ~nxt_same  # run tails

        # ---- rowptr: (m+1)-gather into the tail cumsum at host-known
        # sorted offsets (valid products of each row occupy a
        # deterministic span) ---------------------------------------------
        tails_cum = jnp.cumsum(kept.astype(INDEX_DTYPE))
        exc = jnp.concatenate([jnp.zeros((1,), INDEX_DTYPE), tails_cum])
        rowptr = exc[jnp.clip(sorted_off, 0, exc.shape[0] - 1)]

        # ---- monotone shift compaction ----------------------------------
        disp = (
            jnp.arange(plan.prod_cap, dtype=INDEX_DTYPE)
            - (tails_cum - kept.astype(INDEX_DTYPE))
        )
        keyc, valc = _shift_compact(
            kept, jnp.where(kept, disp, 0),
            [okey.astype(jnp.int32), run], plan.disp_bits,
        )
        out_col = (
            keyc[: plan.out_cap].astype(U32) & ((1 << plan.cbits) - 1)
        ).astype(INDEX_DTYPE)
        out_val = valc[: plan.out_cap].astype(a.vals.dtype)
    oc = jnp.arange(plan.out_cap, dtype=INDEX_DTYPE)
    nnz_rt = rowptr[-1]
    out_col = jnp.where(oc < nnz_rt, out_col, 0)
    out_val = jnp.where(oc < nnz_rt, out_val, jnp.zeros((), out_val.dtype))
    return CSR(rowptr=rowptr, colidx=out_col, vals=out_val, shape=(m, n))
