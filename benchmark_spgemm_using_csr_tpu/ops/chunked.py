"""Chunked-ESC SpGEMM — the general sort-based numeric core.

Design premises (from microbenchmarks on the platform the library was first
built for; not yet re-measured on the GPU):

- the whole pipeline is ONE jitted program (plan/capacities static, like
  ops/fused.py), so a call pays one dispatch;
- a gather of K-contiguous slices moves K elements per descriptor, so the
  product expansion is *slice-shaped*, not element-shaped;
- multi-operand sorts and log-shift segmented scans are comparatively
  cheap, so sort-based merge/compaction is used throughout.

Pipeline (all static shapes, one dispatch):

1. **Chunk split.** Each A entry (i, j, a_v) contributes len(B_j) products
   (b_start and length arrive via ONE packed (m_b, 2) rowptr-pair gather
   per entry). Split that segment into ceil(len/K) chunks of K: the chunk
   stream is the ragged dimension, built with one small scatter + cumsum
   (never searchsorted, which measured far slower). Per-chunk metadata
   (row, B-position, remaining-len, f32 a_val bits) is *delta-propagated* —
   scatter each entry's delta at its first chunk, cumsum — because wide-row
   meta gathers are slow.
2. **Packed-gather expansion.** Chunk c reads B's (colidx, val-bitcast)
   pairs at [start_c, start_c + K) with ONE packed (capB, 2) advanced-index
   gather in transposed (k, chunks) index layout (lanes = the big chunk
   axis). Long B rows (len >= wide_min) instead ride _expand_wide: B is
   scattered once into a wide_lanes-ALIGNED padded copy and each long row's
   products arrive as whole table rows (~1 descriptor per wide_lanes
   products). Invalid lanes get sentinel row m.
3. **Sort** the flat (row, col, val) product stream by (row, col) — one
   3-operand 2-key bitonic sort (packed single int32 key when (m, n) fit).
4. **Segmented run-sum** of duplicate (row, col) runs via log-shift
   shift-add passes (bounded by max A-row nnz); run tails hold exact sums.
5. **Monotone shift compaction** left-packs run tails in log2(cap)
   conditional shifts (_shift_compact; the compaction sort remains as
   compact="sort"); slice [0:out_cap] is C's value/col stream. rowptr is
   one (m+1)-gather into the tail-count cumsum at the per-row product
   offsets — the sorted stream groups rows in order, no binary search.

This is the data-parallel answer to the reference's heap/ESC/merge trio: one
shape-generic path whose cost is ~2 slice-gathers + 2 sorts over the padded
product stream, with *no* per-row method dispatch at all. Binning survives
only in the plan: K is chosen from the matrix's B-row-length profile.

Reference parity: stages 1-4 of SURVEY.md §4; 'Ct buffer' == the padded
product stream; 'progressive allocation' == pad_bucket growth buckets.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, host_view, pad_bucket
from .symbolic import nnz_upper_bound

F32 = jnp.float32


WIDE_LANES = 128  # padded-B table row width (first platform's lane tile)


@dataclasses.dataclass(frozen=True)
class ChunkedPlan:
    """Static capacities for one matrix profile (one host sync to build)."""

    k: int  # chunk width (products per slice-gather)
    chunks_cap: int  # padded number of chunks
    out_cap: int  # padded nnzC bound
    max_run: int = 0  # padded max duplicates per (row, col); 0 = unbounded
    # (col,val) pairs per gather descriptor. >1 cuts descriptor count but
    # materializes a (chunks, rows, 2*b_pack) tile whose small trailing dims
    # were padded to (8,128) tiles on the first platform — a 70x memory
    # blowup. Keep 1; >1 is tested only on CPU.
    b_pack: int = 1
    # Wide-row path (the reference's long-row merge-method regime): A entries whose B row has len >= wide_min expand via
    # 128-lane ALIGNED gathers from a padded copy of B — ~1 descriptor per
    # 128 products instead of 1 per product. 0 disables.
    wide_min: int = 0
    wchunks_cap: int = 0  # padded count of wide_lanes-wide chunks
    bpad_cap: int = 0  # padded-B capacity (multiple of wide_lanes)
    wide_lanes: int = WIDE_LANES  # padded-B table row width
    # uint32 single-key sort for (m, n) that miss int31 but fit 32 bits
    # (a real corner product colliding with the 0xFFFFFFFF sentinel is
    # handled at runtime by merge_products' corner splice)
    pack_u32: bool = False
    # Scatter-SET delta propagation (no read-modify-write, unlike
    # scatter-add). Requires collision-free scatter targets,
    # which make_chunked_plan guarantees by granting every REAL
    # zero-product entry (empty B row / wide-split) one all-invalid dummy
    # chunk of k lanes; capacity-padding entries collide only at the
    # never-valid slot `total`. Enabled only when the dummies stay a small
    # fraction of the stream, else the colliding-delta ADD scheme is kept.
    scatter_set: bool = False
    # Static bound on shift-compaction displacement bits. In the sorted
    # stream invalid slots sort past every valid one, so a kept (run-tail)
    # element is displaced only by the duplicate (non-tail) slots before it
    # — at most total_products - nnz(C), which make_chunked_plan computes
    # EXACTLY via a host-side structural product. log2 of that bounds the
    # conditional-shift pass count (24 -> ~14 on er-like streams where
    # squaring creates almost no duplicates). 0 = unbounded (log2(cap)).
    disp_bits: int = 0
    # Aligned short-row expansion: when al > 0 (must equal k), short rows
    # expand from an al-ALIGNED packed (col,val) copy of B, fetched as whole
    # (2*al)-int32 table rows — al pairs per gather descriptor instead of 1.
    # The price is stream inflation (each B row
    # padded to a multiple of al); make_chunked_plan picks narrow vs aligned
    # per matrix from exact host-side stream sizes. Requires 32-bit-packable
    # values (f32/bf16/f16); the table is built IN-GRAPH by one pair-gather
    # of abpad_cap descriptors (scatter builds cost 2*nnzB descriptors).
    al: int = 0
    abpad_cap: int = 0  # aligned-table capacity in pairs (multiple of al)
    # Mixed-mode expansion: when al > 0 AND al_min > 0, entries whose B row
    # has len < al_min expand via the NARROW per-pair path (k=1, zero
    # padding waste) while al_min <= len < wide_min rides the aligned
    # table. Power-law matrices mix many len-1..4 B rows (which would
    # inflate 2-8x under al=8 padding) with mid rows where the 8-pair
    # descriptor pays off; the plan picks al_min from the exact length
    # histogram. 0 = single-mode (all short rows take one path).
    al_min: int = 0
    nchunks_cap: int = 0  # narrow-substream chunk capacity (k=1 chunks)
    # post-sort tail implementation: 'shift' = global runsum + disp_bits
    # shift-compaction passes; 'scan' = fused block-scan runsum+compaction
    # (ops/scancompact — one stream pass; packed single-key sorts only)
    tail_mode: str = "shift"

    @property
    def prod_cap(self) -> int:
        return (
            self.chunks_cap * self.k
            + self.nchunks_cap
            + self.wchunks_cap * self.wide_lanes
        )


def pad_gentle(n: int, minimum: int = 8) -> int:
    """Round up to the next m * 2^e with m in [8, 15] — ~6% worst-case waste
    (vs 2x for pow2 buckets) while keeping compile-reuse buckets logarithmic."""
    n = max(int(n), minimum)
    e = max(n.bit_length() - 4, 0)
    return -(-n >> e) << e


def make_chunked_plan(
    a: CSR, b: CSR, k: int | None = None, wide_min: int | None = None,
    wide_lanes: int = WIDE_LANES, al: int | None = None,
    al_min: int | None = None,
) -> ChunkedPlan:
    nnz_ct = np.asarray(jax.jit(nnz_upper_bound)(a, b))
    b_len = np.diff(host_view(b.rowptr))
    nnz_a = int(host_view(a.rowptr)[-1])
    total = int(nnz_ct.sum())
    lens_all = b_len[host_view(a.colidx)[:nnz_a]]

    # Wide-row split: entries with len >= wide_min take the 128-lane aligned
    # path. Enabled when those entries carry enough products to amortize the
    # in-graph padded-B build (~2 scatters over nnzB).
    explicit_wide = wide_min is not None
    if wide_min is None:
        wide_min = 96
    wide_mask = lens_all >= wide_min if wide_min else np.zeros(0, bool)
    wide_products = int(lens_all[wide_mask].sum()) if wide_min else 0
    mean_wide_len = wide_products / max(int(wide_mask.sum()), 1)
    # Auto-gate (from A/Bs on the first platform): wide wins only when long
    # rows are LONG — repeated gathers of popular mid-length B rows hit
    # locality and already beat random gathers (circuit-like matrices
    # gained, powerlaw-like ones lost). Require dominant share and strong
    # per-row descriptor amortization.
    use_wide = (
        wide_min > 0
        and wide_products > 0
        and (
            explicit_wide
            or (wide_products >= total * 0.3 and mean_wide_len >= 1024)
        )
    )
    if use_wide:
        lens_w = lens_all[wide_mask]
        lens = lens_all[~wide_mask]
        wchunks = int(np.ceil(lens_w / wide_lanes).sum())
        blen_wide = b_len[b_len >= wide_min]
        bpad = int((np.ceil(blen_wide / wide_lanes) * wide_lanes).sum())
        wchunks_cap = pad_gentle(max(wchunks, 1))
        bpad_cap = max(
            -(-pad_gentle(max(bpad, 1)) // wide_lanes) * wide_lanes,
            wide_lanes,
        )
    else:
        wide_min = 0
        lens = lens_all
        wchunks_cap = 0
        bpad_cap = 0

    # Short-row expansion mode: narrow per-pair gather (chunk width k) vs
    # AL-ALIGNED packed-table row gather (al pairs per descriptor). The
    # weights below (per padded slot: sort+runsum+compact; per descriptor:
    # narrow and aligned gathers; per chunk: propagation; per product: the
    # aligned output's relayout) only rank the modes against each other.
    # They come from the first platform and are not re-measured on the GPU
    # (ROADMAP Speed 3); the total-time model is ops/dispatch.
    AL_DESC_RATES = {8: 1.82e8, 16: 1.23e8}
    SORT_NS, PAIR_NS, CHUNK_NS = 3.9, 5.5, 1.0
    al_packable = a.vals.dtype in (jnp.float32, jnp.bfloat16, jnp.float16)
    abpad_cap = 0
    blen_nw = b_len[b_len < wide_min] if use_wide else b_len

    def _narrow_cost(c):
        ch = int(np.ceil(lens / c).sum())
        return (SORT_NS + PAIR_NS) * ch * c + CHUNK_NS * ch

    if al:  # explicit aligned width
        if k is None:
            k = al
        if al_min is None:
            al_min = 0
    elif k is None and lens.size:
        mean_len = max(float(lens.mean()), 1.0)
        n_cands = sorted(
            {1, 2}
            | {int(np.clip(round(mean_len * f), 4, 256))
               for f in (0.5, 0.75, 1.0, 1.5, 2.0)}
        )
        best = min((_narrow_cost(c), 0, c) for c in n_cands)
        if al is None and al_packable:
            # Mixed mode (al_min > 0: tiny rows narrow, mid rows aligned)
            # is deliberately NOT swept here: its second propagation
            # substream roughly doubles the metadata stage and forfeits
            # scatter-SET (dummy-slot blowup), and it lost to the best pure
            # mode in every A/B on the first platform. It remains available
            # via explicit al/al_min arguments.
            for w, rate in AL_DESC_RATES.items():
                ch = int(np.ceil(lens / w).sum())
                bpad_w = int((np.ceil(blen_nw / w) * w).sum())
                layout_ns = 0.085 * (128 / (2 * w))
                cost = (
                    (SORT_NS + 1e9 / (w * rate) + layout_ns) * ch * w
                    + CHUNK_NS * ch
                    + PAIR_NS * bpad_w
                )
                if cost < best[0]:
                    best = (cost, w, w)
        _, al, k = best
        al_min = 0
    al = al or 0
    al_min = (al_min or 0) if al else 0
    if al and not al_packable:
        raise ValueError("aligned expansion requires 32-bit-packable values")
    if k is None:
        k = 1
    k = min(k, b.capacity)
    if al:
        al = k
        mask_mid = blen_nw >= al_min if al_min else np.ones(
            blen_nw.shape, bool
        )
        bpad = int((np.ceil(blen_nw[mask_mid] / al) * al).sum())
        abpad_cap = max(
            -(-pad_gentle(max(bpad, 1)) // al) * al, al
        )
    # chunks: per A entry ceil(len(B_col)/K); bound via per-row sums.
    # Mixed mode: aligned chunks over len >= al_min, narrow k=1 chunks over
    # len < al_min (a separate substream with its own capacity).
    if al and al_min:
        chunks = int(np.ceil(lens[lens >= al_min] / al).sum())
        nchunks = int(lens[lens < al_min].sum())
    else:
        chunks = int(np.ceil(lens / k).sum()) if nnz_a else 0
        nchunks = 0
    # scatter-SET propagation needs every entry (incl. capacity padding) to
    # own >= 1 chunk IN EACH substream it is propagated over; enable when
    # those dummy slots stay a small fraction of the product stream
    n_zero_len = int((lens == 0).sum()) if nnz_a else 0
    n_wide_e = int(wide_mask.sum()) if wide_min else 0
    if al and al_min:
        nd_aligned = int((lens < al_min).sum()) + n_wide_e
        nd_narrow = int((lens >= al_min).sum()) + n_zero_len + n_wide_e
        extra_slots = nd_aligned * al + nd_narrow
        total_slots = chunks * al + nchunks
        scatter_set = extra_slots <= max(total_slots // 16, 64)
        if scatter_set:
            chunks += nd_aligned
            nchunks += nd_narrow
    else:
        extra_chunks = n_zero_len + n_wide_e  # capacity padding: no dummy
        scatter_set = extra_chunks <= max(chunks // 16, 64)
        if scatter_set:
            chunks += extra_chunks
    # duplicates of one (row, col) are bounded by that A-row's nnz
    a_len_max = int(np.diff(host_view(a.rowptr)).max(initial=1))

    # uint32 single-key sort eligibility: (m, n) miss the int31 pack but
    # fit 32 bits, AND no real product can land on the (m-1, n-1) corner
    # when that packed key would equal the 0xFFFFFFFF invalid sentinel.
    pack_u32 = False
    if _rc_pack_bits(a.m, b.n) == 0 and a.m >= 2 and b.n >= 2:
        cbits = max(int(b.n - 1).bit_length(), 1)
        rbits = max(int(a.m - 1).bit_length(), 1)
        # Always eligible when (row, col) fit 32 bits: a real (m-1, n-1)
        # product whose key equals the 0xFFFFFFFF sentinel is handled at
        # runtime by merge_products' corner splice (masked direct
        # reduction pre-sort, O(1) re-insertion post-compaction), so no
        # host-side corner-existence proof is needed.
        pack_u32 = cbits + rbits <= 32

    # Exact duplicate count (total products - structural nnzC) bounds the
    # shift-compaction displacement of every kept element (see
    # ChunkedPlan.disp_bits). One host-side boolean product; gated by size
    # so plan building stays sub-second for out-of-core-scale inputs.
    disp_bits = 0
    if 0 < total <= (1 << 27):
        import scipy.sparse as sp

        pat_a = a.to_scipy().astype(bool)
        pat_b = pat_a if b is a else b.to_scipy().astype(bool)
        dups = total - int((pat_a @ pat_b).nnz)
        disp_bits = max(int(dups).bit_length(), 1)

    return ChunkedPlan(
        k=k,
        chunks_cap=pad_gentle(max(chunks, 1)),
        out_cap=pad_gentle(max(min(total, int(np.minimum(nnz_ct, b.n).sum())), 1)),
        max_run=pad_bucket(a_len_max),
        wide_min=wide_min,
        wchunks_cap=wchunks_cap,
        bpad_cap=bpad_cap,
        wide_lanes=wide_lanes,
        pack_u32=pack_u32,
        scatter_set=scatter_set,
        disp_bits=disp_bits,
        al=al,
        abpad_cap=abpad_cap,
        al_min=al_min,
        nchunks_cap=pad_gentle(max(nchunks, 1)) if (al and al_min) else 0,
        # fused block-scan tail (ops/scancompact); packed-key branches
        # only — the unpacked 2-key stream falls back to shift inside
        # merge_products
        tail_mode="scan",
    )


def _propagate_entry_consts(starts, deltas_src, chunks_cap: int,
                            use_set: bool = False):
    """Broadcast per-entry int32 constants onto the chunk stream WITHOUT a
    per-chunk gather: scatter each entry's *delta vs the previous entry*
    at its first chunk, then cumsum. Values telescope exactly (int32), and
    entries with zero chunks collide additively at the next entry's start —
    their deltas sum to the correct skip. It replaces a packed (capA, 4)
    row gather: the scatter is one descriptor per A entry and cumsum is
    bandwidth-cheap.

    use_set: scatter-SET instead of scatter-add (no read-modify-write).
    ONLY valid when
    `starts` is strictly increasing, i.e. every entry owns >= 1 chunk
    (ChunkedPlan.scatter_set guarantees this via dummy chunks).
    """
    outs = []
    for q in deltas_src:
        d = q - jnp.concatenate([jnp.zeros((1,), q.dtype), q[:-1]])
        ref = jnp.zeros(chunks_cap, q.dtype)
        if use_set:
            acc = ref.at[starts].set(d, mode="drop")
        else:
            acc = ref.at[starts].add(d, mode="drop")
        outs.append(jnp.cumsum(acc))
    return outs


def _expand_chunks(
    a: CSR, b: CSR, k: int, chunks_cap: int, b_pack: int = 1,
    wide_min: int = 0, scatter_set: bool = False,
):
    """Stages 1-2: chunk metadata + slice-gather product expansion.

    Returns flat (row, col, val) of shape (chunks_cap * k,); invalid slots
    carry row == m. wide_min > 0 skips entries whose B row has
    len >= wide_min (they expand via _expand_wide instead).
    """
    m = a.m
    a_rows = a.row_ids()
    entry_valid = a_rows < m
    # ONE packed (m_b, 2) rowptr-pair gather per A entry gives b_start AND
    # the row length (rowptr[j+1]-rowptr[j]) — halves the per-entry
    # metadata descriptors vs separate b_len / rowptr gathers.
    rp = b.rowptr.astype(INDEX_DTYPE)
    rp_pair = jnp.stack([rp[:-1], rp[1:]], axis=1)  # (m_b, 2)
    pair = rp_pair[a.colidx, :]
    b_start = pair[:, 0]
    per_nz = jnp.where(entry_valid, pair[:, 1] - pair[:, 0], 0)
    if wide_min:
        per_nz = jnp.where(per_nz >= wide_min, 0, per_nz)
    n_chunks_per = (per_nz + (k - 1)) // k
    if scatter_set:
        # every REAL entry owns >= 1 chunk -> real starts are strictly
        # increasing -> scatter-SET propagation is collision-free (plan
        # guarantees the dummy-chunk overhead is small). Capacity-padding
        # entries keep 0 chunks: they collide only at slot `total`, which
        # is never a valid chunk, so their lost deltas touch only the
        # masked tail.
        n_chunks_per = jnp.where(
            entry_valid, jnp.maximum(n_chunks_per, 1), 0
        )

    # ragged chunk -> entry map: scatter 1s at chunk starts, cumsum
    ends = jnp.cumsum(n_chunks_per)
    starts = ends - n_chunks_per
    total_chunks = ends[-1] if a.capacity else jnp.zeros((), INDEX_DTYPE)
    # unconditional stacked +1 per entry (zero-chunk entries — empty B rows —
    # stack at the same start; cumsum then skips their ids exactly, the same
    # trick as csr.row_ids_from_rowptr)
    c_ids = jnp.arange(chunks_cap, dtype=INDEX_DTYPE)
    chunk_valid = c_ids < total_chunks

    # Row ids via ROW-granularity propagation: entries are row-ordered, so
    # chunks of row i occupy [chunk_start(i), chunk_start(i+1)) and one
    # m-sized scatter (+1 at each row's first chunk; empty rows stack
    # additively, the usual trick) replaces the nnzA-sized q_row delta
    # propagation — ~9x fewer scatter descriptors for that operand.
    arp = a.rowptr.astype(INDEX_DTYPE)
    row_chunk_start = jnp.where(arp > 0, ends[jnp.maximum(arp - 1, 0)], 0)
    hits_r = jnp.zeros(chunks_cap, INDEX_DTYPE).at[row_chunk_start[1:]].add(
        1, mode="drop"
    )
    row = jnp.cumsum(hits_r)

    # Remaining per-chunk metadata via entry-delta propagation:
    # pos[c] = b_start[e] + (c - starts[e])*k = (b_start - k*starts)[e] + k*c
    # rem[c] = per_nz[e]  - (c - starts[e])*k = (per_nz  + k*starts)[e] - k*c
    # — both brackets are entry-constant: two int32 propagations.
    # (k*starts fits int32 because k*starts <= prod_cap, which the batched
    # driver bounds well below 2^31.) 32-bit A values ride a THIRD
    # propagation as bitcast int32 — two's-complement add-deltas wrap and
    # telescope exactly, so the reconstructed bits are bit-identical and
    # the per-chunk a_val gather disappears. Wider dtypes (f64) gather.
    #
    # k == 1 special case: every real chunk is exactly one real product, so
    # the only invalid-within-chunk_valid slots are scatter-SET dummy chunks
    # (zero-product entries). Mark those through pos's SIGN — the dummy's
    # entry constant propagates pos = -1 — and drop the rem propagation
    # entirely: one fewer nnzA-scatter + chunks_cap-cumsum over the full
    # stream.
    need_rem = k > 1
    if need_rem:
        q_posb = b_start - k * starts
    else:
        q_posb = jnp.where(
            per_nz > 0, b_start, jnp.asarray(-1, INDEX_DTYPE)
        ) - starts
    q_remb = per_nz + k * starts
    prop_aval = a.vals.dtype in (jnp.float32, jnp.bfloat16, jnp.float16)
    deltas = (q_posb, q_remb) if need_rem else (q_posb,)
    if prop_aval:
        q_aval = jax.lax.bitcast_convert_type(a.vals.astype(F32), jnp.int32)
        outs = _propagate_entry_consts(
            starts, deltas + (q_aval,), chunks_cap, use_set=scatter_set,
        )
        a_val = jax.lax.bitcast_convert_type(outs[-1], F32)
    else:
        outs = _propagate_entry_consts(
            starts, deltas, chunks_cap, use_set=scatter_set,
        )
        # chunk -> A-entry id map (scatter 1s at chunk starts, cumsum), only
        # needed for the wide-dtype value gather
        hits = jnp.zeros(chunks_cap, INDEX_DTYPE).at[starts].add(
            1, mode="drop"
        )
        src = jnp.clip(jnp.cumsum(hits) - 1, 0, a.capacity - 1)
        a_val = a.vals[src]
    posb = outs[0]
    pos = posb + k * c_ids
    if need_rem:
        rem = outs[1] - k * c_ids  # per-chunk remaining valid lanes
    else:
        rem = jnp.where(pos >= 0, 1, 0)  # dummy chunks propagate pos == -1

    # slice-gather of B's (col, val) per chunk, in TRANSPOSED (k, chunks)
    # index layout: lanes = the big chunk axis. Product order comes out
    # lane-major (permuted), which is fine: the stream goes straight into a
    # global sort. Advanced-index gather, not vmap(dynamic_slice), which
    # measured far slower.
    lane = jnp.arange(k, dtype=INDEX_DTYPE)
    if b_pack > 1 and b.capacity % b_pack == 0:
        # CPU-only option (Plan.b_pack docs): pack b_pack (col, val-bitcast)
        # pairs per table row so each descriptor fetches 8*b_pack bytes,
        # then realign the per-chunk window with static slices + select.
        lane_valid = chunk_valid[:, None] & (lane[None, :] < rem[:, None])
        b_packed = jnp.stack(
            [
                b.colidx.astype(jnp.int32),
                jax.lax.bitcast_convert_type(b.vals.astype(F32), jnp.int32),
            ],
            axis=1,
        )  # (capacityB, 2) int32
        nrows_tbl = b.capacity // b_pack
        tbl = b_packed.reshape(nrows_tbl, 2 * b_pack)
        pos_nn = jnp.maximum(pos, 0)
        base = pos_nn // b_pack
        off = pos_nn % b_pack
        rows_needed = (k + b_pack - 1) // b_pack + 1
        gidx2 = jnp.clip(
            base[:, None] + jnp.arange(rows_needed, dtype=INDEX_DTYPE)[None, :],
            0,
            nrows_tbl - 1,
        )
        raw = tbl[gidx2]  # (chunks, rows_needed, 2*b_pack)
        flat = raw.reshape(chunks_cap, rows_needed * b_pack, 2)
        off3 = off[:, None, None]
        sel = flat[:, 0:k, :]
        for s in range(1, b_pack):
            sel = jnp.where(off3 == s, flat[:, s : s + k, :], sel)
        col = sel[:, :, 0]
        b_val = jax.lax.bitcast_convert_type(sel[:, :, 1], F32)
        val = b_val * a_val[:, None]
        row_t = jnp.where(lane_valid, row[:, None], m)
        col_t = jnp.where(lane_valid, col, 0)
        val_t = jnp.where(lane_valid, val, 0.0)
    else:
        # NEVER clip the segment start: a valid B segment may begin within
        # k of the buffer end (nnzB == capacity) and clipping would shift
        # its reads. Clip per-lane indices instead — valid lanes always
        # index < capacity, only masked out-of-segment lanes get clamped.
        lane_valid = chunk_valid[None, :] & (lane[:, None] < rem[None, :])
        gidx = jnp.clip(pos[None, :] + lane[:, None], 0, b.capacity - 1)
        pack_vals = b.vals.dtype in (jnp.float32, jnp.bfloat16, jnp.float16)
        if pack_vals:
            # ONE (capB, 2) packed gather delivers both fields per
            # descriptor (half the descriptors of two separate 1D
            # gathers). Values ride as int32 bitcasts
            # (f32 packing of small ints would denormal-flush to zero).
            b_packed = jnp.stack(
                [
                    b.colidx.astype(jnp.int32),
                    jax.lax.bitcast_convert_type(
                        b.vals.astype(F32), jnp.int32
                    ),
                ],
                axis=1,
            )
            tile = b_packed[gidx, :]  # (k, chunks, 2)
            col = tile[:, :, 0]
            b_val = jax.lax.bitcast_convert_type(tile[:, :, 1], F32)
        else:
            # wide dtypes (f64 path): two separate gathers
            col = b.colidx[gidx].astype(jnp.int32)  # (k, chunks)
            b_val = b.vals[gidx]
        val = b_val * a_val[None, :]
        row_t = jnp.where(lane_valid, row[None, :], m)
        col_t = jnp.where(lane_valid, col, 0)
        val_t = jnp.where(lane_valid, val, 0.0)
    return (
        row_t.reshape(-1).astype(INDEX_DTYPE),
        col_t.reshape(-1).astype(INDEX_DTYPE),
        val_t.reshape(-1),
    )


def _expand_aligned(
    a: CSR, b: CSR, al: int, chunks_cap: int, abpad_cap: int,
    wide_min: int = 0, scatter_set: bool = False, al_min: int = 0,
):
    """Stages 1-2 via the al-ALIGNED packed-table row gather.

    Same chunk-metadata propagation as _expand_chunks, but products arrive
    as whole (2*al)-int32 rows of an al-aligned interleaved (col, val-bits)
    copy of B — al pairs per gather descriptor instead of one pair per
    descriptor. The aligned table is built IN-GRAPH by one pair-gather of
    abpad_cap descriptors plus two m_b-sized scatters (a scatter build
    would cost 2*nnzB descriptors). Alignment pad lanes read neighbouring
    garbage and are masked by rem exactly like narrow-chunk tails.
    Requires 32-bit-packable values (the plan guarantees this).

    Returns flat (row, col, val) of shape (chunks_cap * al,); invalid slots
    carry row == m. wide_min > 0 skips entries whose B row has
    len >= wide_min (they expand via _expand_wide instead); al_min > 0
    skips entries with len < al_min (the narrow k=1 substream takes them —
    mixed mode, ChunkedPlan.al_min).
    """
    m = a.m
    nrows_tbl = abpad_cap // al

    # ---- aligned packed table (in-graph: values are runtime data) --------
    b_len_all = b.row_lengths().astype(INDEX_DTYPE)  # (m_b,)
    sel = (b_len_all < wide_min) if wide_min else jnp.ones_like(
        b_len_all, jnp.bool_
    )
    if al_min:
        sel = sel & (b_len_all >= al_min)
    ws = jnp.where(sel, ((b_len_all + al - 1) // al) * al, 0)
    pstart = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(ws)]
    )[:-1]  # (m_b,) aligned start (in pairs) per B row
    # table row -> B row map: one m_b-sized scatter (+1 at each row's first
    # table row; ws==0 rows stack at the next start, cumsum skips them)
    tstart = pstart // al
    hits = jnp.zeros(nrows_tbl, INDEX_DTYPE).at[tstart[1:]].add(
        1, mode="drop"
    )
    rowid = jnp.cumsum(hits)  # (nrows_tbl,)
    base_off = b.rowptr[:-1].astype(INDEX_DTYPE) - pstart  # per-B-row const
    t_ids = jnp.arange(nrows_tbl, dtype=INDEX_DTYPE)
    src0 = base_off[rowid] + t_ids * al  # first source pair per table row
    lane = jnp.arange(al, dtype=INDEX_DTYPE)
    src2 = jnp.clip(src0[:, None] + lane[None, :], 0, b.capacity - 1)
    b_packed = jnp.stack(
        [
            b.colidx.astype(jnp.int32),
            jax.lax.bitcast_convert_type(b.vals.astype(F32), jnp.int32),
        ],
        axis=1,
    )  # (capB, 2)
    tbl = b_packed[src2.reshape(-1), :].reshape(nrows_tbl, 2 * al)

    # ---- chunk stream over A entries (same delta propagation) ------------
    a_rows = a.row_ids()
    entry_valid = a_rows < m
    # ONE packed (m_b, 2) gather per A entry gives the aligned start AND the
    # row length (the narrow path's rowptr-pair analogue)
    meta_pair = jnp.stack([pstart, b_len_all], axis=1)  # (m_b, 2)
    pair = meta_pair[a.colidx, :]
    p_start = pair[:, 0]
    per_nz = jnp.where(entry_valid, pair[:, 1], 0)
    if wide_min:
        per_nz = jnp.where(per_nz >= wide_min, 0, per_nz)
    if al_min:
        per_nz = jnp.where(per_nz < al_min, 0, per_nz)
    n_chunks_per = (per_nz + (al - 1)) // al
    if scatter_set:
        n_chunks_per = jnp.where(
            entry_valid, jnp.maximum(n_chunks_per, 1), 0
        )
    ends = jnp.cumsum(n_chunks_per)
    starts = ends - n_chunks_per
    total_chunks = ends[-1] if a.capacity else jnp.zeros((), INDEX_DTYPE)
    c_ids = jnp.arange(chunks_cap, dtype=INDEX_DTYPE)
    chunk_valid = c_ids < total_chunks

    arp = a.rowptr.astype(INDEX_DTYPE)
    row_chunk_start = jnp.where(arp > 0, ends[jnp.maximum(arp - 1, 0)], 0)
    hits_r = jnp.zeros(chunks_cap, INDEX_DTYPE).at[row_chunk_start[1:]].add(
        1, mode="drop"
    )
    row = jnp.cumsum(hits_r)

    q_posb = p_start - al * starts
    q_remb = per_nz + al * starts
    q_aval = jax.lax.bitcast_convert_type(a.vals.astype(F32), jnp.int32)
    posb, remb, aval_bits = _propagate_entry_consts(
        starts, (q_posb, q_remb, q_aval), chunks_cap, use_set=scatter_set
    )
    a_val = jax.lax.bitcast_convert_type(aval_bits, F32)
    pos = posb + al * c_ids  # al-aligned for valid chunks
    rem = remb - al * c_ids

    trow = jnp.clip(pos // al, 0, nrows_tbl - 1)
    out = tbl[trow, :]  # (chunks_cap, 2*al) — al pairs per descriptor
    col = out[:, 0::2]
    b_val = jax.lax.bitcast_convert_type(out[:, 1::2], F32)
    val = b_val * a_val[:, None]
    lane_valid = chunk_valid[:, None] & (lane[None, :] < rem[:, None])
    row_t = jnp.where(lane_valid, row[:, None], m)
    col_t = jnp.where(lane_valid, col, 0)
    # products stay f32 like the narrow path (runsum accumulates in f32 for
    # bf16/f16 inputs; merge_products casts back at the end)
    val_t = jnp.where(lane_valid, val, 0.0)
    return (
        row_t.reshape(-1).astype(INDEX_DTYPE),
        col_t.reshape(-1).astype(INDEX_DTYPE),
        val_t.reshape(-1),
    )


def _expand_wide(a: CSR, b: CSR, wide_min: int, wchunks_cap: int,
                 bpad_cap: int, wide_lanes: int = WIDE_LANES):
    """Long-B-row expansion — the reference's merge-method regime.

    Scatter B's long rows once into a 128-lane-ALIGNED padded copy, then
    fetch each long row's products as whole 128-lane table rows: ~1 gather
    descriptor per 128 products instead of 1 per product; alignment makes
    the realign (the expensive part of generic wide fetches) vanish.
    Returns a flat (row, col, val) stream of wchunks_cap * 128 slots;
    invalid slots carry row == m.
    """
    m = a.m
    L = wide_lanes
    nrows_tbl = bpad_cap // L

    # ---- padded-B tables (in-graph: values are runtime data) -------------
    b_len = b.row_lengths().astype(INDEX_DTYPE)  # (m_b,)
    ws = jnp.where(b_len >= wide_min, ((b_len + L - 1) // L) * L, 0)
    pstart = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(ws)]
    )[:-1]
    b_rows = b.row_ids()  # (capB,)
    b_rows_c = jnp.minimum(b_rows, b.m - 1)
    entry_wide = (b_rows < b.m) & (b_len[b_rows_c] >= wide_min)
    off = jnp.arange(b.capacity, dtype=INDEX_DTYPE) - b.rowptr[b_rows_c]
    tgt = jnp.where(entry_wide, pstart[b_rows_c] + off, bpad_cap)
    tblc = (
        jnp.zeros(bpad_cap, INDEX_DTYPE)
        .at[tgt].set(b.colidx.astype(INDEX_DTYPE), mode="drop")
        .reshape(nrows_tbl, L)
    )
    acc_dt = (
        F32 if b.vals.dtype in (jnp.bfloat16, jnp.float16) else b.vals.dtype
    )
    tblv = (
        jnp.zeros(bpad_cap, acc_dt)
        .at[tgt].set(b.vals.astype(acc_dt), mode="drop")
        .reshape(nrows_tbl, L)
    )

    # ---- wide chunk stream over A entries (same delta-propagation) -------
    a_rows = a.row_ids()
    av = a_rows < m
    # written identically to _expand_chunks' rowptr-pair gather so XLA CSEs
    # the two into one descriptor stream
    rp = b.rowptr.astype(INDEX_DTYPE)
    rp_pair = jnp.stack([rp[:-1], rp[1:]], axis=1)
    pair = rp_pair[a.colidx, :]
    per_nz = jnp.where(av, pair[:, 1] - pair[:, 0], 0)
    wide_e = av & (per_nz >= wide_min)
    pn = jnp.where(wide_e, per_nz, 0)
    n_w = (pn + L - 1) // L
    wends = jnp.cumsum(n_w)
    wstarts = wends - n_w
    wtotal = wends[-1] if a.capacity else jnp.zeros((), INDEX_DTYPE)
    wc = jnp.arange(wchunks_cap, dtype=INDEX_DTYPE)
    wvalid = wc < wtotal

    p0 = jnp.where(wide_e, pstart[a.colidx], 0)  # 128-aligned base
    # row ids via row-granularity scatter (entries are row-ordered, so a
    # row's wide chunks are contiguous) — m descriptors instead of nnzA
    arp = a.rowptr.astype(INDEX_DTYPE)
    row_wstart = jnp.where(arp > 0, wends[jnp.maximum(arp - 1, 0)], 0)
    hits_r = jnp.zeros(wchunks_cap, INDEX_DTYPE).at[row_wstart[1:]].add(
        1, mode="drop"
    )
    row = jnp.cumsum(hits_r)
    q_posb = p0 - L * wstarts
    q_remb = pn + L * wstarts
    prop_aval = a.vals.dtype in (jnp.float32, jnp.bfloat16, jnp.float16)
    if prop_aval:
        q_aval = jax.lax.bitcast_convert_type(a.vals.astype(F32), jnp.int32)
        posb, remb, avalb = _propagate_entry_consts(
            wstarts, (q_posb, q_remb, q_aval), wchunks_cap
        )
        a_val = jax.lax.bitcast_convert_type(avalb, F32)
    else:
        posb, remb = _propagate_entry_consts(
            wstarts, (q_posb, q_remb), wchunks_cap
        )
        hits = jnp.zeros(wchunks_cap, INDEX_DTYPE).at[wstarts].add(
            1, mode="drop"
        )
        src = jnp.clip(jnp.cumsum(hits) - 1, 0, a.capacity - 1)
        a_val = a.vals[src]
    # posb + L*wc is 128-aligned for valid chunks (pstart and L*wstarts both
    # are); garbage in invalid slots is clipped then masked
    trow = jnp.clip((posb + L * wc) // L, 0, nrows_tbl - 1)
    rem = remb - L * wc
    lane = jnp.arange(L, dtype=INDEX_DTYPE)
    lv = wvalid[:, None] & (lane[None, :] < rem[:, None])
    col = tblc[trow]  # (wchunks_cap, 128) — lane-exact, no padding
    b_val = tblv[trow]
    val = b_val * a_val[:, None]
    row_t = jnp.where(lv, row[:, None], m)
    col_t = jnp.where(lv, col, 0)
    val_t = jnp.where(lv, val, 0.0)
    return (
        row_t.reshape(-1).astype(INDEX_DTYPE),
        col_t.reshape(-1).astype(INDEX_DTYPE),
        val_t.reshape(-1),
    )


def _segmented_runsum(row, col, val, max_run: int = 0):
    """Sum duplicate (row, col) runs in a sorted stream; tails hold totals.

    max_run: static bound on run length (max nnz of any A row) — caps the
    number of log-shift passes at log2(max_run) instead of log2(capacity).
    """
    cap = row.shape[0]
    bound = min(max_run, cap) if max_run else cap
    run = val
    k = 1
    while k < bound:
        same = jnp.concatenate(
            [
                jnp.zeros(k, jnp.bool_),
                (row[k:] == row[:-k]) & (col[k:] == col[:-k]),
            ]
        )
        shifted = jnp.concatenate([jnp.zeros(k, val.dtype), run[:-k]])
        run = run + jnp.where(same, shifted, 0)
        k *= 2
    return run


def _shift_compact(kept, disp, arrays, max_bits: int = 0):
    """Stable left-compaction of `kept` elements to their `disp`-displaced
    targets via log2(cap) conditional shifts — replaces the compaction SORT.
    max_bits > 0 caps the pass count when the caller can prove every kept
    element's displacement fits that many bits (ChunkedPlan.disp_bits).

    Correctness: targets (i - disp[i]) are strictly increasing over kept
    elements, so after processing displacement bits LSB->MSB the partially
    shifted positions p - (disp & (2^(b+1)-1)) remain strictly increasing
    at every stage (masked deltas never exceed position deltas when disp is
    non-decreasing) — no two kept elements ever collide. Slots a kept
    element vacates retain a stale copy; the kept flag is cleared for
    movers so stale copies are never consulted. Slots past the compacted
    prefix end up with garbage, exactly like the sort-based compaction.
    """
    cap = disp.shape[0]
    b, s = 0, 1
    while s < cap and (not max_bits or b < max_bits):
        move = kept & (((disp >> b) & 1) == 1)
        inc = jnp.concatenate([move[s:], jnp.zeros((s,), jnp.bool_)])

        def shl(x, s=s, inc=inc):
            return jnp.where(inc, jnp.concatenate([x[s:], x[:s]]), x)

        arrays = [shl(x) for x in arrays]
        disp = shl(disp)
        kept = jnp.where(
            inc,
            jnp.concatenate([kept[s:], jnp.zeros((s,), jnp.bool_)]),
            kept & ~move,
        )
        s <<= 1
        b += 1
    return arrays


def row_product_offsets(a: CSR, b: CSR):
    """(m+1,) cumulative per-row product counts: offsets[i] = # products
    with row < i. Feeds merge_products(prodstart=...) for the O(1) rowptr
    derivation (the sorted stream groups rows in ascending order, so row
    boundaries are exactly these offsets — no binary search). Inside one
    jit, XLA CSEs the per_nz computation with the expansion's own (the
    rowptr-pair gather below is written identically for that reason)."""
    a_rows = a.row_ids()
    rp = b.rowptr.astype(INDEX_DTYPE)
    rp_pair = jnp.stack([rp[:-1], rp[1:]], axis=1)
    pair = rp_pair[a.colidx, :]
    per_nz = jnp.where(a_rows < a.m, pair[:, 1] - pair[:, 0], 0)
    cum = jnp.cumsum(per_nz)
    rp = a.rowptr.astype(INDEX_DTYPE)
    return jnp.where(rp > 0, cum[jnp.maximum(rp - 1, 0)], 0)


def _rc_pack_bits(m: int, n: int) -> int:
    """Bits for the packed (row << bits | col) int32 key, or 0 if it
    doesn't fit. Fitting cuts sort operands 3→2 and 4→3 (sorts dominate)."""
    col_bits = max(int(n).bit_length(), 1)
    return col_bits if (m + 1) << col_bits < (1 << 31) else 0


def merge_products(row, col, val, m: int, n: int, out_cap: int,
                   max_run: int = 0, val_dtype=None,
                   pack: bool | None = None, prodstart=None,
                   compact: str = "shift", pack_u32: bool = False,
                   disp_bits: int = 0) -> CSR:
    """Stages 3-4 on a flat product stream (row==m marks invalid slots):
    sort by (row, col) → segmented run-sum → sort-based compaction →
    rowptr. Shared by single-chip and distributed paths.

    pack: force (True) / disable (False) the packed-int32 key fast path;
    None = auto by whether (m, n) fit in 31 bits.
    pack_u32: (m, n) fit 32 bits unsigned. A real (m-1, n-1) product whose
    key equals the 0xFFFFFFFF invalid sentinel is reduced directly before
    the sort and spliced back after compaction (corner splice below).
    Cuts the main sort from 3 operands / 2 keys to 2 / 1 for matrices that
    just miss the int31 pack (e.g. 65536 x 65536).
    prodstart: optional (m+1,) cumulative per-row product counts of the
    stream (prodstart[i] = # valid products with row < i). When given, the
    rowptr comes from one (m+1)-gather instead of an (m+1)-needle binary
    search over the sorted stream."""
    val_dtype = val_dtype or val.dtype
    cap = row.shape[0]
    bits = _rc_pack_bits(m, n)
    if pack is False:
        bits = 0
    elif pack is True and not bits:
        raise ValueError(f"(m={m}, n={n}) does not fit a packed int32 key")

    corner_cnt = corner_sum = None
    if not bits and pack_u32:
        cbits = max(int(n - 1).bit_length(), 1)
        u32max = jnp.uint32(0xFFFFFFFF)
        rc = (row.astype(jnp.uint32) << cbits) | col.astype(jnp.uint32)
        rc = jnp.where(row >= m, u32max, rc)
        if (((m - 1) << cbits) | (n - 1)) == (1 << 32) - 1:
            # Corner splice: a real (m-1, n-1) product keys to the invalid
            # sentinel. Its duplicates could interleave with the (huge)
            # padding run after the sort, breaking the max_run-bounded
            # runsum — so reduce corner products DIRECTLY pre-sort (one
            # masked reduction), demote their slots to padding (val 0),
            # and re-insert the single corner entry after compaction.
            corner_mask = (row < m) & (rc == u32max)
            corner_cnt = jnp.sum(corner_mask.astype(INDEX_DTYPE))
            corner_sum = jnp.sum(
                jnp.where(corner_mask, val, jnp.zeros((), val.dtype))
            )
            val = jnp.where(corner_mask, jnp.zeros((), val.dtype), val)
        rc, val = jax.lax.sort((rc, val), num_keys=1, is_stable=False)
        row_sorted = jnp.minimum(rc >> cbits, jnp.uint32(m)).astype(
            INDEX_DTYPE
        )
        if compact == "scan":
            from .scancompact import runsum_compact_scan

            rc_ci, val_c, tails = runsum_compact_scan(
                rc, val, w=cap, out_cap=out_cap,
                max_run=max_run or cap,
            )
            uniq_pos = tails - 1
            n_uniq = tails[-1]
            rc_c = rc_ci
            col_c = (
                rc_ci.astype(jnp.uint32) & jnp.uint32((1 << cbits) - 1)
            ).astype(INDEX_DTYPE)
        else:
            run_val = _segmented_runsum(rc, rc, val, max_run)
            valid = rc != u32max
            next_rc = jnp.concatenate(
                [rc[1:], jnp.full((1,), u32max, rc.dtype)]
            )
            is_tail = valid & (rc != next_rc)
            uniq_pos = jnp.cumsum(is_tail.astype(INDEX_DTYPE)) - 1
            if compact == "shift":
                disp = jnp.arange(cap, dtype=INDEX_DTYPE) - uniq_pos
                rc_c, val_c = _shift_compact(
                    is_tail, disp, [rc, run_val], disp_bits
                )
            else:
                key = jnp.where(is_tail, uniq_pos, cap).astype(INDEX_DTYPE)
                _, rc_c, val_c = jax.lax.sort(
                    (key, rc, run_val), num_keys=1, is_stable=False
                )
            n_uniq = jnp.sum(is_tail.astype(INDEX_DTYPE))
            col_c = (rc_c & jnp.uint32((1 << cbits) - 1)).astype(INDEX_DTYPE)
    elif bits:
        rc = (row.astype(INDEX_DTYPE) << bits) | col.astype(INDEX_DTYPE)
        rc, val = jax.lax.sort((rc, val), num_keys=1, is_stable=False)
        valid = rc < (m << bits)
        row_sorted = jnp.minimum(rc >> bits, m)
        if compact == "scan":
            from .scancompact import SENTINEL_U32, runsum_compact_scan

            key_u = jnp.where(
                valid, rc.astype(jnp.uint32), jnp.uint32(SENTINEL_U32)
            )  # invalids already sort to the tail; remap preserves order
            rc_ci, val_c, tails = runsum_compact_scan(
                key_u, val, w=cap, out_cap=out_cap,
                max_run=max_run or cap,
            )
            uniq_pos = tails - 1
            n_uniq = tails[-1]
            col_c = rc_ci & ((1 << bits) - 1)
        else:
            run_val = _segmented_runsum(rc, rc, val, max_run)
            next_rc = jnp.concatenate(
                [rc[1:], jnp.full((1,), -1, rc.dtype)]
            )
            is_tail = valid & (rc != next_rc)
            uniq_pos = jnp.cumsum(is_tail.astype(INDEX_DTYPE)) - 1
            if compact == "shift":
                disp = jnp.arange(cap, dtype=INDEX_DTYPE) - uniq_pos
                rc_c, val_c = _shift_compact(
                    is_tail, disp, [rc, run_val], disp_bits
                )
            else:
                key = jnp.where(is_tail, uniq_pos, cap).astype(INDEX_DTYPE)
                _, rc_c, val_c = jax.lax.sort(
                    (key, rc, run_val), num_keys=1, is_stable=False
                )
            n_uniq = jnp.sum(is_tail.astype(INDEX_DTYPE))
            col_c = rc_c & ((1 << bits) - 1)
    else:
        # stage 3: sort by (row, col); sentinel rows (m) sink to tail
        row, col, val = jax.lax.sort(
            (row, col, val), num_keys=2, is_stable=False
        )
        run_val = _segmented_runsum(row, col, val, max_run)
        valid = row < m
        next_row = jnp.concatenate([row[1:], jnp.full((1,), -1, row.dtype)])
        next_col = jnp.concatenate([col[1:], jnp.full((1,), -1, col.dtype)])
        is_tail = valid & ((row != next_row) | (col != next_col))
        row_sorted = row
        uniq_pos = jnp.cumsum(is_tail.astype(INDEX_DTYPE)) - 1
        # rowptr is derived from the pre-compaction stream (below), so the
        # compaction does not carry the row array. (The scan tail needs a
        # single packed key; the 2-key stream falls back to shift.)
        if compact in ("shift", "scan"):
            disp = jnp.arange(cap, dtype=INDEX_DTYPE) - uniq_pos
            col_c, val_c = _shift_compact(is_tail, disp, [col, run_val], disp_bits)
        else:
            key = jnp.where(is_tail, uniq_pos, cap).astype(INDEX_DTYPE)
            _, col_c, val_c = jax.lax.sort(
                (key, col, run_val), num_keys=1, is_stable=False
            )
        n_uniq = jnp.sum(is_tail.astype(INDEX_DTYPE))

    out_col = col_c[:out_cap].astype(INDEX_DTYPE)
    out_val = val_c[:out_cap].astype(val_dtype)
    if corner_cnt is not None:
        # splice the (m-1, n-1) entry back in: globally the largest key, so
        # it belongs at position n_uniq (end of the compacted stream); when
        # it exists, n_uniq < nnzC <= out_cap so the slot is in range
        has_corner = (corner_cnt > 0).astype(INDEX_DTYPE)
        idx = jnp.minimum(n_uniq, out_cap - 1)
        out_col = out_col.at[idx].set(
            jnp.where(corner_cnt > 0, n - 1, out_col[idx])
        )
        out_val = out_val.at[idx].set(
            jnp.where(corner_cnt > 0, corner_sum.astype(val_dtype),
                      out_val[idx])
        )

    # rowptr from the sorted (pre-compaction) stream: rowptr[i] = number of
    # unique tails strictly before the first element with row >= i.
    cum_tails = uniq_pos + 1  # inclusive tail count
    if prodstart is not None:
        # The sort groups rows in ascending order with invalid slots (row m)
        # at the tail, so row i's products occupy exactly
        # [prodstart[i], prodstart[i+1]) — no binary search needed, just one
        # (m+1)-element gather into the tail-count cumsum.
        first_ge = jnp.clip(prodstart.astype(INDEX_DTYPE), 0, cap)
    else:
        needles = jnp.arange(m + 1, dtype=INDEX_DTYPE)
        first_ge = jnp.searchsorted(row_sorted, needles, side="left")
    rowptr = jnp.where(
        first_ge > 0,
        cum_tails[jnp.maximum(first_ge - 1, 0)],
        0,
    ).astype(INDEX_DTYPE)
    rowptr = jnp.minimum(rowptr, n_uniq)
    if corner_cnt is not None:
        # cum_tails excluded the corner run (its slots are sentinel-keyed);
        # only rowptr[m] — the total unique count — needs the correction
        rowptr = rowptr.at[-1].set(n_uniq + has_corner)
    return CSR(rowptr=rowptr, colidx=out_col, vals=out_val, shape=(m, n))


@partial(jax.jit, static_argnames=("plan",))
def spgemm_chunked(a: CSR, b: CSR, plan: ChunkedPlan) -> CSR:
    """C = A @ B, one dispatch, sort-based merge (see module docstring)."""
    m, n = a.m, b.n
    if plan.al:
        row, col, val = _expand_aligned(
            a, b, plan.al, plan.chunks_cap, plan.abpad_cap,
            wide_min=plan.wide_min, scatter_set=plan.scatter_set,
            al_min=plan.al_min,
        )
        if plan.al_min:
            # mixed mode: B rows with len < al_min ride the narrow k=1
            # per-pair gather (zero padding waste for tiny rows)
            row_n, col_n, val_n = _expand_chunks(
                a, b, 1, plan.nchunks_cap, wide_min=plan.al_min,
                scatter_set=plan.scatter_set,
            )
            row = jnp.concatenate([row, row_n])
            col = jnp.concatenate([col, col_n])
            val = jnp.concatenate([val, val_n.astype(val.dtype)])
    else:
        row, col, val = _expand_chunks(
            a, b, plan.k, plan.chunks_cap, b_pack=plan.b_pack,
            wide_min=plan.wide_min, scatter_set=plan.scatter_set,
        )
    if plan.wide_min:
        row_w, col_w, val_w = _expand_wide(
            a, b, plan.wide_min, plan.wchunks_cap, plan.bpad_cap,
            plan.wide_lanes,
        )
        row = jnp.concatenate([row, row_w])
        col = jnp.concatenate([col, col_w])
        val = jnp.concatenate([val, val_w.astype(val.dtype)])
    prodstart = row_product_offsets(a, b)
    return merge_products(
        row, col, val, m, n, plan.out_cap, plan.max_run, a.vals.dtype,
        prodstart=prodstart, pack_u32=plan.pack_u32,
        disp_bits=plan.disp_bits, compact=plan.tail_mode,
    )
