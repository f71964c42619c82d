"""Cost-model method dispatch for C = A @ B — the stage-2 analogue.

The reference decides per-ROW which numeric kernel runs (38-bin binning,
SURVEY.md §4 stage 2). Here the decision is taken per-MATRIX and per-FORMAT:
the backends have qualitatively different cost shapes,

  chunked   global sort/gather ESC      ~ products
  grouped   per-group 2D sort ESC       ~ slots * log2(width)^2 + gathers
  tilepack  per-tile sort ESC           ~ lanes * log2(width)^2 + gathers
  bsr       batched block matmuls       ~ block pairs
  dia       static-shift plane FMAs     ~ plane slots + per-term overhead
  dense     dense f32 matmul            ~ m*k*n + scatter-in + extraction
  hash      dense-accumulator tiles     ~ products + accumulator slots

``choose_method`` estimates each and returns the argmin — one host-side
O(nnz) numpy pass at plan time, like the reference's host-side binning.

Every estimate is a linear model: a sum of cost constants, each times a
term computed from the matrix pair (the ``*_terms`` functions below).
scripts/calibrate_dispatch.py times each backend on the device and fits
the constants from those same terms.

All estimators take an (A, B) pair (B defaults to A, the reference's
C = A @ A squaring mode): the AMG Galerkin triple product R·A·P
(models/amg.py) routes its rectangular chained products through the exact
same cost models.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR, host_view

# Device time per unit of each term: *_FIXED_S* in seconds, *_NS_* in ns.
# Fitted by scripts/calibrate_dispatch.py on CALIBRATION_DEVICE.
CALIBRATION_DEVICE = "NVIDIA H100 80GB HBM3, power limit 400.00 W, 2026-10-16"
# Terms with one or two timed points (dense, hash) and coefficients the
# non-negative fit drove to 0 are weakly determined: PERF.md lists the
# residuals of every point. A second run (same card at 700.00 W, every
# backend the model priced under 2 s, 17 matrices, 3 held out) kept this
# table: its picks were within 1.16x of the measured fastest at each
# matrix, while that run's own refit picked worse (chunked's form).
COST = {
    "CHUNKED_FIXED_S": 0.00729988,
    "CHUNKED_NS_PER_PRODUCT": 0.233403,
    "CHUNKED_NS_PER_PRODUCT_UNPACKED": 0.484648,
    "CHUNKED_NS_PER_ROW_UNPACKED": 0.0,
    "BSR_FIXED_S": 0.00116156,
    "BSR_NS_PER_PAIR": 142.628,
    "DIA_FIXED_S": 0.000242029,
    "DIA_NS_PER_SLOT": 0.00577509,
    "DIA_NS_PER_TERM": 481.257,
    "DENSE_FIXED_S": 0.0582811,
    "DENSE_NS_PER_FLOP": 0.0,
    "DENSE_NS_PER_SCATTER": 0.0,
    "DENSE_NS_PER_EXTRACT_BYTE": 0.0,
    "TILEPACK_FIXED_S": 0.000239299,
    "TILEPACK_NS_PER_ENTRY": 0.905379,
    "TILEPACK_NS_PER_GATHER_ROW": 0.280236,
    "TILEPACK_NS_PER_SORT_LANE_STAGE": 0.000717966,
    "TILEPACK_NS_PER_COUNT_LANE": 0.010181,
    "TILEPACK_NS_PER_COMPACT_LANE_PASS": 0.00441372,
    "HASH_FIXED_S_PER_TILE": 0.0380357,
    "HASH_NS_PER_PRODUCT": 0.0,
    "HASH_NS_PER_SLOT": 0.0,
    "GROUPED_FIXED_S": 0.000943344,
    "GROUPED_NS_PER_SLOT": 0.0,
    "GROUPED_NS_PER_SLOT_LB2": 0.00185697,
    "GROUPED_NS_PER_DESC": 0.0116227,
    "GROUPED_NS_PER_ENTRY": 0.0,
    "GROUPED_NS_PER_ROW": 2.7406,
}
# f64 grouped values ride two int32 lanes (3-operand sort, doubled value
# traffic, emulated multiply/run-sum); a flat factor, not calibrated here
GROUPED_F64_FACTOR = 2.2
# memory caps inherited from a 16 GB device; not re-derived for 80 GB yet
DENSE_MEM_BYTES = 1 << 30
DIA_PLANE_BYTES = 512 << 20
BSR_PAIR_BYTES = 2 << 30


def price(terms: dict | None, cost: dict | None = None) -> float:
    """Seconds for a term dict ({cost name: multiplier}) under ``cost``
    (default COST); None = infeasible."""
    if terms is None:
        return float("inf")
    cost = COST if cost is None else cost
    return sum(
        cost[k] * v * (1.0 if "FIXED_S" in k else 1e-9)
        for k, v in terms.items()
    )


def _mstats(x: CSR, _cache={}):
    """One host pull of (rowptr, colidx) + per-matrix derived stats,
    memoized on the CSR object's buffer ids: choose_method calls seven
    estimators, and each would otherwise pull the matrix from the device
    again. A small LRU (AMG hierarchies cycle A/P/R per level)."""
    key = (id(x.rowptr), id(x.colidx))
    hit = _cache.get(key)
    if hit is not None:
        # true LRU: refresh recency on hit (plain pop-front is FIFO and an
        # AMG hierarchy cycling >8 matrices would evict its hot entries)
        _cache[key] = _cache.pop(key)
        return hit[0]
    rowptr = host_view(x.rowptr)
    nnz = int(rowptr[-1])
    row_lens = np.diff(rowptr).astype(np.int64)
    cols = host_view(x.colidx)[:nnz].astype(np.int64)
    if len(_cache) >= 8:
        _cache.pop(next(iter(_cache)))
    # hold the keyed buffers: id() values recycle after GC, and a stale hit
    # returns another matrix's stats (caught by test_choose_method_regimes)
    _cache[key] = ((rowptr, nnz, row_lens, cols), (x.rowptr, x.colidx))
    return _cache[key][0]


def _stats(a: CSR, b: CSR | None = None):
    """Pair stats for C = A @ B: A's host arrays + the intermediate-product
    count sum_i |B[A.colidx[i], :]| (== the flop count / 2)."""
    b = a if b is None else b
    a_rowptr, nnz_a, a_row_lens, a_cols = _mstats(a)
    _, _, b_row_lens, _ = _mstats(b)
    products = int(b_row_lens[a_cols].sum()) if nnz_a else 0
    return a_rowptr, nnz_a, a_row_lens, a_cols, products


def chunked_terms(a: CSR, b: CSR | None = None, products: int | None = None):
    b = a if b is None else b
    if products is None:
        *_, products = _stats(a, b)
    from .chunked import _rc_pack_bits

    m, n = a.m, b.n
    cbits = max(int(max(n - 1, 1)).bit_length(), 1)
    rbits = max(int(max(m - 1, 1)).bit_length(), 1)
    if _rc_pack_bits(m, n) > 0 or cbits + rbits <= 32:
        # single-int32 sort key
        return {"CHUNKED_FIXED_S": 1.0, "CHUNKED_NS_PER_PRODUCT": products}
    # (m, n) miss both key packs: 3-operand 2-key sort, wider compaction,
    # and m-sized scatters
    return {
        "CHUNKED_FIXED_S": 1.0,
        "CHUNKED_NS_PER_PRODUCT_UNPACKED": products,
        "CHUNKED_NS_PER_ROW_UNPACKED": m,
    }


def estimate_chunked_s(
    a: CSR, b: CSR | None = None, products: int | None = None
) -> float:
    return price(chunked_terms(a, b, products))


def bsr_terms(a: CSR, b: CSR | None = None, block_shape=(8, 128),
              bn: int = 128):
    """Block-pair count model (mirrors ops/bsr.bsr_viable): A blocked at
    (bm, bk), B at (bk, bn) as in ops/bsr.spgemm_bsr."""
    b = a if b is None else b
    bm, bk = block_shape
    if a.m % bm or a.n % bk or b.m % bk or b.n % bn:
        return None
    a_rowptr, nnz_a, _, a_cols = _mstats(a)
    b_rowptr, nnz_b, _, b_cols = _mstats(b)
    if not nnz_a or not nnz_b:
        return {}
    a_rows = np.repeat(np.arange(a.m, dtype=np.int64), np.diff(a_rowptr))
    a_keys = np.unique((a_rows // bm) * (a.n // bk) + a_cols // bk)
    b_rows = np.repeat(np.arange(b.m, dtype=np.int64), np.diff(b_rowptr))
    b_keys = np.unique((b_rows // bk) * (b.n // bn) + b_cols // bn)
    b_blen = np.bincount(b_keys // (b.n // bn), minlength=b.m // bk)
    pairs = int(b_blen[a_keys % (a.n // bk)].sum())
    if pairs * bm * bk * 4 > BSR_PAIR_BYTES:
        return None
    return {"BSR_FIXED_S": 1.0, "BSR_NS_PER_PAIR": pairs}


def estimate_bsr_s(
    a: CSR, b: CSR | None = None, block_shape=(8, 128), bn: int = 128
) -> float:
    return price(bsr_terms(a, b, block_shape, bn))


def _dia_offsets(x: CSR) -> np.ndarray:
    rowptr, nnz, _, cols = _mstats(x)
    if not nnz:
        return np.zeros(0, np.int64)
    rows = np.repeat(np.arange(x.m, dtype=np.int64), np.diff(rowptr))
    return np.unique(cols - rows)


def dia_terms(a: CSR, b: CSR | None = None):
    b = a if b is None else b
    _, nnz_a, *_ = _mstats(a)
    _, nnz_b, *_ = _mstats(b)
    if not nnz_a or not nnz_b:
        return {}
    offs_a = _dia_offsets(a)
    offs_b = offs_a if b is a else _dia_offsets(b)
    nd_a, nd_b = len(offs_a), len(offs_b)
    # nd_a * nd_b is the number of slice-FMA ops in the jitted graph
    # (dia_spgemm unrolls terms statically): cap it so auto dispatch never
    # builds a minutes-to-compile program. A large term count is accepted
    # only when the product stream is large enough (>= 4M products) for
    # the per-call win to amortize the compile; tiny products (e.g. AMG's
    # tall-skinny P with O(m) diagonals) keep the strict cap.
    *_, products = _stats(a, b)
    term_cap = 16384 if products >= (1 << 22) else 8192
    slots = nd_a * nd_b * b.n
    if (
        slots * COST["DIA_NS_PER_SLOT"] * 1e-9 > 10.0
        or nd_a > 4096
        or nd_b > 4096
        or nd_a * nd_b > term_cap
    ):
        return None
    n_off_c = len(np.unique(offs_a[:, None] + offs_b[None, :]))
    itemsize = np.dtype(a.vals.dtype).itemsize
    if n_off_c * b.n * itemsize > DIA_PLANE_BYTES:
        return None
    # per-term op overhead amortizes over the plane sums: the A@A form
    # nd * overhead generalizes as terms / max(nd_a, nd_b)
    return {
        "DIA_FIXED_S": 1.0,
        "DIA_NS_PER_SLOT": slots,
        "DIA_NS_PER_TERM": nd_a * nd_b / max(nd_a, nd_b, 1),
    }


def estimate_dia_s(a: CSR, b: CSR | None = None) -> float:
    return price(dia_terms(a, b))


def dense_terms(a: CSR, b: CSR | None = None):
    b = a if b is None else b
    m, k = a.shape
    n = b.n
    itemsize = np.dtype(a.vals.dtype).itemsize
    if (m * k + k * n + m * n) * itemsize > DENSE_MEM_BYTES:
        return None
    _, nnz_a, *_ = _mstats(a)
    _, nnz_b, *_ = _mstats(b)
    # extraction: ~log2(holes) conditional-shift passes over the dense C
    passes = max(int(m * n).bit_length() - 8, 1)  # holes unknown pre-plan
    return {
        "DENSE_FIXED_S": 1.0,
        "DENSE_NS_PER_FLOP": 2.0 * m * k * n,
        "DENSE_NS_PER_SCATTER": nnz_a + nnz_b,
        "DENSE_NS_PER_EXTRACT_BYTE": passes * m * n * (2 * itemsize + 1),
    }


def estimate_dense_s(a: CSR, b: CSR | None = None) -> float:
    return price(dense_terms(a, b))


def tilepack_terms(a: CSR, b: CSR | None = None):
    """Packed-tile ESC model (ops/tilepack.py) priced off the EXACT plan
    (the regime gate rejects long-row matrices before the greedy fill, so
    building it here is cheap where it matters): propagation scatters per
    A entry, table + slot gathers, the per-tile sort (lanes x bitonic
    stage count), its per-local-row count reduction, and the shift
    compaction passes."""
    b = a if b is None else b
    _, nnz, *_rest, products = _stats(a, b)
    if not nnz:
        return {}
    if products > (1 << 27):
        return None
    from .tilepack import make_tilepack_plan

    sched = make_tilepack_plan(a, b)
    if sched is None:
        return None
    p = sched.plan
    lanes = p.t_cap * p.w
    lw = max(int(p.w - 1).bit_length(), 1)
    passes = max(int(max(lanes // 4, 1)).bit_length(), 1)
    return {
        "TILEPACK_FIXED_S": 1.0,
        "TILEPACK_NS_PER_ENTRY": nnz,
        "TILEPACK_NS_PER_GATHER_ROW": p.abpad_cap + p.s_cap,
        "TILEPACK_NS_PER_SORT_LANE_STAGE": lanes * lw * (lw + 1) / 2,
        "TILEPACK_NS_PER_COUNT_LANE": lanes * p.wlr_eff,
        "TILEPACK_NS_PER_COMPACT_LANE_PASS": passes * lanes,
    }


def estimate_tilepack_s(a: CSR, b: CSR | None = None) -> float:
    return price(tilepack_terms(a, b))


def hash_terms(
    a: CSR, b: CSR | None = None, tile_bytes_budget: int = 512 * 1024 * 1024
):
    """Dense-accumulator hash path model (ops/hash.py): every product is one
    scatter-add into the (R, n) accumulator plus one scatter-SET into the
    occupancy mask and one expansion gather; each row tile pays an (R, n)
    prefix-sum sweep and two (R, n) compaction scatters, and one
    host-orchestrated dispatch."""
    b = a if b is None else b
    rowptr, nnz, _, _, products = _stats(a, b)
    if not nnz:
        return {}
    m, n = a.m, b.n
    itemsize = np.dtype(a.vals.dtype).itemsize
    r_tile = max(int(tile_bytes_budget // (n * (itemsize + 4 + 4))), 8)
    m_ne = int((np.diff(rowptr) > 0).sum())
    n_tiles = -(-m_ne // max(min(r_tile, m_ne), 1)) if m_ne else 0
    slots = n_tiles * min(r_tile, max(m_ne, 1)) * n
    return {
        "HASH_FIXED_S_PER_TILE": max(n_tiles, 1),
        "HASH_NS_PER_PRODUCT": products,
        "HASH_NS_PER_SLOT": slots,
    }


def estimate_hash_s(
    a: CSR, b: CSR | None = None, tile_bytes_budget: int = 512 * 1024 * 1024
) -> float:
    return price(hash_terms(a, b, tile_bytes_budget))


def grouped_mode_terms(m: int, nnz_a: int, slots: int, desc: int, abpad: int):
    """Grouped-pipeline terms for one mode (ops/grouped.py): per-slot cost
    with a log2(group width)^2 sort-depth term, expansion + aligned-table
    descriptors, per-entry metadata (rowptr-pair gather, propagation
    scatters, spread), per-row work (rank scatter, sorted-off gather,
    rowptr)."""
    w_est = int(np.clip(slots / 64, 1 << 13, 1 << 17))
    lb = max(int(w_est - 1).bit_length(), 1)
    return {
        "GROUPED_NS_PER_SLOT": slots,
        "GROUPED_NS_PER_SLOT_LB2": slots * lb * lb,
        "GROUPED_NS_PER_DESC": desc + abpad,
        "GROUPED_NS_PER_ENTRY": nnz_a,
        "GROUPED_NS_PER_ROW": m,
    }


def grouped_terms(a: CSR, b: CSR | None = None, al: int | None = None):
    """Terms of the cheapest grouped mode (narrow, or al-aligned tables for
    al in {2, 4, 8}); ``al`` pins one mode (0 = narrow)."""
    b = a if b is None else b
    rowptr, nnz, _, cols, products = _stats(a, b)
    if not nnz or products == 0:
        return {}
    if products > (1 << 27):
        return None
    dtype = str(a.vals.dtype)
    if dtype not in ("float32", "bfloat16", "float16", "float64"):
        return None  # value bits must pack into int32 lanes
    m, n = a.m, b.n
    if max(int(n - 1).bit_length(), 1) > 31:
        return None
    _, _, b_row_lens, _ = _mstats(b)
    lens = b_row_lens[cols]
    modes = {0: grouped_mode_terms(m, nnz, products, products, 0)}
    for cand in (2, 4, 8):
        abpad_c = int((-(-b_row_lens // cand) * cand).sum())
        slots_c = int((-(-lens // cand)).sum()) * cand
        # mirror make_grouped_plan's table-build memory guard
        if abpad_c // cand > (512 << 10 if cand < 8 else 2 << 20):
            continue
        modes[cand] = grouped_mode_terms(
            m, nnz, slots_c, slots_c // cand, abpad_c
        )
    if al is not None:
        terms = modes.get(al)
    else:
        terms = min(modes.values(), key=price)
    if terms is None:
        return None
    scale = GROUPED_F64_FACTOR if dtype == "float64" else 1.0
    return {"GROUPED_FIXED_S": 1.0, **{k: v * scale for k, v in terms.items()}}


def estimate_grouped_s(a: CSR, b: CSR | None = None) -> float:
    """Grouped-ESC model (ops/grouped.py): best of the narrow / aligned
    modes under the shared cost (``grouped_mode_terms``)."""
    return price(grouped_terms(a, b))


def choose_method(a: CSR, b: CSR | None = None) -> str:
    """Pick the fastest backend for C = A @ B by the calibrated cost model
    (B defaults to A — the reference's squaring benchmark mode)."""
    b = a if b is None else b
    *_, products = _stats(a, b)
    if products == 0:
        return "chunked"  # degenerate product; every estimate ties at ~0
    est = {
        "chunked": estimate_chunked_s(a, b, products),
        "bsr": estimate_bsr_s(a, b),
        "dia": estimate_dia_s(a, b),
        "dense": estimate_dense_s(a, b),
        "tilepack": estimate_tilepack_s(a, b),
        "grouped": estimate_grouped_s(a, b),
        "hash": estimate_hash_s(a, b),
    }
    return min(est, key=est.get)
