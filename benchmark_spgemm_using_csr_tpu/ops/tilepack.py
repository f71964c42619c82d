"""Packed-tile ESC SpGEMM — per-tile sorts replace the global product sort
for short-row matrices.

The chunked path sorts the whole (row, col) product stream at once, which
costs log2(stream) comparator stages. But the product stream is already
grouped by C row (chunks are emitted in A-entry order), so only *within-row*
order is missing. This path packs several complete C rows into each
(width)-lane tile row and sorts every tile independently
(ops/sortmerge.tile_sort_merge): log2(width) stages on short rows that the
sort keeps in fast memory.

Pipeline (one dispatch; stage numbers = reference SURVEY.md §4):

1. host plan (stage-2 analogue, structure-only like the reference's host
   binning): quantize every A entry's products to al-aligned chunks,
   greedy-fill rows into tiles of ``width`` lanes (a row never straddles a
   tile), build per-row slot offsets + (tile, local-row) ids;
2. in-graph: propagate per-entry constants onto the tile-slot stream
   (scatter+cumsum, ops/chunked machinery) and fetch products as whole
   (2*al)-int32 rows of the al-aligned packed B copy — al pairs per
   gather descriptor (ops/chunked._expand_aligned's trick);
3. per-tile sort of packed (local_row << cbits | col) keys + segmented
   duplicate merge + tail positions + per-local-row counts (stage-3 ESC);
4. rowptr from per-(tile, local_row) counts (one m-gather + cumsum);
   monotone shift compaction of run tails into the exact CSR (stage 4).

Applicability (make_tilepack_plan returns None otherwise): values are at
most 32 bits wide, every C row's padded product count fits one tile (long-row matrices keep the chunked
path), local-row + column bits fit the int32 key, and the structural
product is small enough to count exactly on the host.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.csr import CSR, INDEX_DTYPE, host_view
from .chunked import _propagate_entry_consts, _shift_compact, pad_gentle

F32 = jnp.float32
SENTINEL = 1 << 30


@dataclasses.dataclass(frozen=True)
class TilePackPlan:
    """Hashable statics for one matrix structure profile."""

    w: int  # tile lane width (pow2)
    al: int  # chunk quantum (pairs per gather descriptor)
    t_cap: int  # padded tile count
    abpad_cap: int  # aligned-B table capacity in pairs (multiple of al)
    out_cap: int  # padded exact nnzC
    nnz_c: int  # exact nnz(C) (host structural product)
    cbits: int  # column bits in the packed (local_row, col) key
    disp_bits: int  # bits of the max compaction displacement
    scatter_set: bool  # collision-free scatter-SET propagation
    # pow2 >= the ACTUAL max rows packed in any tile (not the w/al upper
    # bound): sizes the per-local-row count reduction and the key's
    # local-row bits — er-like tiles hold ~4-6 rows
    wlr_eff: int = 0

    @property
    def wlr(self) -> int:
        return self.w // self.al

    @property
    def s_cap(self) -> int:  # chunk-slot stream length
        return self.t_cap * self.wlr


@dataclasses.dataclass
class TilePackSchedule:
    """Plan + structure-derived device arrays (the stage-2 binning result,
    host-built once per structure like the reference's binning and this
    repo's reuse.NumericSchedule)."""

    plan: TilePackPlan
    slot0: jax.Array  # (m,) int32 first chunk-slot per row
    q: jax.Array  # (m,) int32 flat tile*wlr+lr per row; empty -> t_cap*wlr
    first_rank: jax.Array  # (t_cap,) int32 nonempty rows before each tile


def make_tilepack_plan(
    a: CSR, b: CSR, w: int | None = None, al: int = 8, max_w: int = 2048,
) -> TilePackSchedule | None:
    """Host stage-2: quantized chunk counts -> greedy row->tile packing.

    Returns None when the matrix doesn't fit the regime (a row exceeds
    max_w padded products, keys overflow int32, or the structural product
    is too large to count exactly)."""
    m, n = a.m, b.n
    if m == 0 or n == 0:
        return None
    if max(np.dtype(a.vals.dtype).itemsize, np.dtype(b.vals.dtype).itemsize) > 4:
        return None  # values ride as float32 bits in the packed B table
    a_rowptr = host_view(a.rowptr)[: m + 1].astype(np.int64)
    nnz_a = int(a_rowptr[-1])
    b_rowptr = host_view(b.rowptr).astype(np.int64)
    b_len = np.diff(b_rowptr)
    lens = b_len[host_view(a.colidx)[:nnz_a]]
    total = int(lens.sum())
    if total == 0 or total > (1 << 27):
        return None

    chunks_e = -(-lens // al)
    n_zero = int((chunks_e == 0).sum())
    scatter_set = n_zero <= max(nnz_a // 16, 64)
    if scatter_set:
        chunks_e = np.maximum(chunks_e, 1)
    cce = np.concatenate([[0], np.cumsum(chunks_e)])
    row_chunks = cce[a_rowptr[1:]] - cce[a_rowptr[:-1]]  # (m,)
    max_chunks = int(row_chunks.max(initial=0))
    if w is None:
        w = max(128, 1 << int(al * max(max_chunks, 1) - 1).bit_length())
    if al * max_chunks > w or w > max_w or w & (w - 1):
        return None
    wlr = w // al
    cbits = max(int(n - 1).bit_length(), 1)

    # greedy sequential fill (row order preserved -> compacted stream is
    # globally (row, col)-ordered)
    tile_of = np.zeros(m, np.int64)
    base_chunk = np.zeros(m, np.int64)
    lr_of = np.zeros(m, np.int64)
    first_rank_l = [0]
    cur = 0  # chunks used in current tile
    cur_lr = 0
    t = 0
    rank = 0
    for r in range(m):
        c = int(row_chunks[r])
        if c == 0:
            tile_of[r] = t
            base_chunk[r] = cur
            lr_of[r] = -1
            continue
        if cur + c > wlr:
            t += 1
            first_rank_l.append(rank)
            cur = 0
            cur_lr = 0
        tile_of[r] = t
        base_chunk[r] = cur
        lr_of[r] = cur_lr
        cur += c
        cur_lr += 1
        rank += 1
    n_tiles = t + 1
    t_cap = pad_gentle(n_tiles)
    first_rank = np.zeros(t_cap, np.int32)
    first_rank[: len(first_rank_l)] = first_rank_l
    first_rank[len(first_rank_l):] = rank
    ranks = np.asarray(first_rank_l + [rank])
    max_rows_tile = int(np.diff(ranks).max(initial=1))
    wlr_eff = max(1 << max(int(max_rows_tile - 1).bit_length(), 0), 1)
    lrbits = int(wlr_eff - 1).bit_length()
    if lrbits + cbits > 30:  # sentinel is 1 << 30
        return None

    # exact nnzC (also bounds the compaction displacement)
    import scipy.sparse as sp

    pat_a = a.to_scipy().astype(bool)
    pat_b = pat_a if b is a else b.to_scipy().astype(bool)
    nnz_c = int((pat_a @ pat_b).nnz)

    abpad = int((-(-b_len // al) * al).sum())
    # +al guarantees >= 1 all-sentinel table row past the aligned region:
    # dummy chunks of zero-length B rows point there (see _spgemm_tilepack)
    abpad_cap = max(-(-pad_gentle(abpad + al) // al) * al, al)

    slot0 = (tile_of * wlr + base_chunk).astype(np.int32)
    q = np.where(
        lr_of >= 0, tile_of * wlr_eff + lr_of, t_cap * wlr_eff
    ).astype(np.int32)

    plan = TilePackPlan(
        w=w,
        al=al,
        t_cap=t_cap,
        abpad_cap=abpad_cap,
        out_cap=pad_gentle(max(nnz_c, 1)),
        nnz_c=nnz_c,
        cbits=cbits,
        disp_bits=max(int(t_cap * w - nnz_c).bit_length(), 1),
        scatter_set=scatter_set,
        wlr_eff=wlr_eff,
    )
    return TilePackSchedule(
        plan=plan,
        slot0=jnp.asarray(slot0),
        q=jnp.asarray(q),
        first_rank=jnp.asarray(first_rank),
    )


def spgemm_tilepack(a: CSR, b: CSR, sched: TilePackSchedule) -> CSR:
    """C = A @ B in one dispatch via packed tiles (see module docstring)."""
    return _spgemm_tilepack(
        a, b, sched.slot0, sched.q, sched.first_rank, sched.plan
    )


@partial(jax.jit, static_argnames=("plan",))
def _spgemm_tilepack(
    a: CSR, b: CSR, slot0, q, first_rank, plan: TilePackPlan
) -> CSR:
    from .sortmerge import tile_sort_merge

    m, n = a.m, b.n
    al, W, wlr = plan.al, plan.w, plan.wlr
    S = plan.s_cap
    nrows_tbl = plan.abpad_cap // al

    # ---- aligned packed B table (ops/chunked._expand_aligned's build,
    # plus SENTINEL masking: alignment-pad lanes store col == -1, which
    # replaces the per-entry remaining-length propagation entirely — lane
    # validity is read out of the table instead of recomputed per chunk) --
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
    base_off = rp[:-1] - pstart
    # ONE packed (m_b, 2) gather per table row: B-source offset + row end
    tmeta = jnp.stack([base_off, rp[1:]], axis=1)
    tm = tmeta[rowid, :]
    t_ids = jnp.arange(nrows_tbl, dtype=INDEX_DTYPE)
    src0 = tm[:, 0] + t_ids * al
    lane = jnp.arange(al, dtype=INDEX_DTYPE)
    src_l = src0[:, None] + lane[None, :]
    valid_tbl = src_l < tm[:, 1:2]  # pad lanes + the pad region sort out
    src2 = jnp.clip(src_l, 0, b.capacity - 1)
    b_packed = jnp.stack(
        [
            b.colidx.astype(jnp.int32),
            jax.lax.bitcast_convert_type(b.vals.astype(F32), jnp.int32),
        ],
        axis=1,
    )
    raw = b_packed[src2.reshape(-1), :].reshape(nrows_tbl, al, 2)
    tbl = jnp.stack(
        [
            jnp.where(valid_tbl, raw[:, :, 0], -1),
            jnp.where(valid_tbl, raw[:, :, 1], 0),
        ],
        axis=2,
    ).reshape(nrows_tbl, 2 * al)

    # ---- per-entry chunk metadata -> tile-slot destinations --------------
    a_rows = a.row_ids()
    entry_valid = a_rows < m
    meta_pair = jnp.stack([pstart, b_len_all], axis=1)
    pair = meta_pair[a.colidx, :]
    per_nz = jnp.where(entry_valid, pair[:, 1], 0)
    # zero-product entries (dummy chunks under scatter-SET) read the
    # guaranteed all-sentinel pad region past the aligned table
    p_start = jnp.where(per_nz > 0, pair[:, 0], plan.abpad_cap - al)
    n_chunks_per = (per_nz + (al - 1)) // al
    if plan.scatter_set:
        n_chunks_per = jnp.where(
            entry_valid, jnp.maximum(n_chunks_per, 1), 0
        )
    ends = jnp.cumsum(n_chunks_per)
    starts = ends - n_chunks_per
    arp = a.rowptr.astype(INDEX_DTYPE)
    row_chunk_start = jnp.where(arp > 0, ends[jnp.maximum(arp - 1, 0)], 0)

    # first tile-slot per entry: fs = starts + (slot0[row] -
    # row_chunk_start[row]), the bracket spread to entries by row-boundary
    # delta scatter (m descriptors, ops/chunked row-granularity trick)
    g_row = slot0.astype(INDEX_DTYPE) - row_chunk_start[:-1]
    d_g = g_row - jnp.concatenate([jnp.zeros((1,), g_row.dtype), g_row[:-1]])
    spread = jnp.zeros(a.capacity, INDEX_DTYPE).at[arp[:-1]].add(
        d_g, mode="drop"
    )
    fs = starts + jnp.cumsum(spread)

    q_posb = p_start - al * fs
    q_aval = jax.lax.bitcast_convert_type(a.vals.astype(F32), jnp.int32)
    posb, aval_bits = _propagate_entry_consts(
        fs, (q_posb, q_aval), S, use_set=plan.scatter_set
    )
    a_val = jax.lax.bitcast_convert_type(aval_bits, F32)
    s_ids = jnp.arange(S, dtype=INDEX_DTYPE)
    pos = posb + al * s_ids

    # slot validity at ROW granularity (one m-scatter + cumsum instead of
    # the per-entry remaining-length propagation): slot s is live iff
    # s < slot0[row] + row_chunks[row]; alignment-pad lanes inside live
    # slots carry the table's col == -1 sentinel
    row_chunks = row_chunk_start[1:] - row_chunk_start[:-1]
    rend = slot0.astype(INDEX_DTYPE) + row_chunks
    d_re = rend - jnp.concatenate([jnp.zeros((1,), rend.dtype), rend[:-1]])
    re_acc = jnp.zeros(S, INDEX_DTYPE).at[
        jnp.minimum(slot0.astype(INDEX_DTYPE), S - 1)
    ].add(d_re, mode="drop")
    rend_slot = jnp.cumsum(re_acc)
    slot_live = s_ids < rend_slot

    # ---- expansion gather (al pairs per descriptor) ----------------------
    trow = jnp.clip(pos // al, 0, nrows_tbl - 1)
    out = tbl[trow, :]  # (S, 2*al)
    col = out[:, 0::2]
    b_val = jax.lax.bitcast_convert_type(out[:, 1::2], F32)
    val = b_val * a_val[:, None]
    lv = slot_live[:, None] & (col >= 0)

    # ---- local-row ids + packed keys -------------------------------------
    hits_r = jnp.zeros(S + 1, INDEX_DTYPE).at[
        jnp.where(row_chunks > 0, slot0.astype(INDEX_DTYPE), S)
    ].add(1, mode="drop")
    rank = jnp.cumsum(hits_r[:S])  # 1-based nonempty-row rank per slot
    fr_b = jnp.broadcast_to(
        first_rank.astype(INDEX_DTYPE)[:, None], (plan.t_cap, wlr)
    ).reshape(-1)
    lr = rank - 1 - fr_b
    key_hi = lr << plan.cbits
    key = jnp.where(lv, key_hi[:, None] | col, SENTINEL)
    valm = jnp.where(lv, val, 0.0)

    key2 = key.reshape(plan.t_cap, W)
    val2 = valm.reshape(plan.t_cap, W)

    # ---- per-tile sort + merge + positions + local-row counts ------------
    okey, oval, pos_t, cnt_lr = tile_sort_merge(
        key2, val2, sentinel=SENTINEL, wlr=plan.wlr_eff, cbits=plan.cbits,
    )

    # ---- rowptr from per-(tile, local-row) counts ------------------------
    counts_flat = jnp.concatenate(
        [cnt_lr.reshape(-1), jnp.zeros((1,), jnp.int32)]
    )
    counts_row = counts_flat[q].astype(INDEX_DTYPE)
    rowptr = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(counts_row)]
    )

    # ---- monotone shift compaction (stage 4) -----------------------------
    cnt_tile = jnp.sum(cnt_lr, axis=1)
    tprefix = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt_tile)]
    )[:-1]
    tprefix_b = jnp.broadcast_to(
        tprefix[:, None], (plan.t_cap, W)
    ).reshape(-1)
    posf = pos_t.reshape(-1)
    kept = posf < W
    uniq = tprefix_b + posf
    disp = jnp.arange(plan.t_cap * W, dtype=INDEX_DTYPE) - uniq
    keyc, valc = _shift_compact(
        kept, jnp.where(kept, disp, 0),
        [okey.reshape(-1), oval.reshape(-1)], plan.disp_bits,
    )
    out_col = (keyc[: plan.out_cap] & ((1 << plan.cbits) - 1)).astype(
        INDEX_DTYPE
    )
    out_val = valc[: plan.out_cap].astype(a.vals.dtype)
    return CSR(rowptr=rowptr, colidx=out_col, vals=out_val, shape=(m, n))
