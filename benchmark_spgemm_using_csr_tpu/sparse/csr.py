"""Sparse matrix containers: CSR / COO / BSR as JAX pytrees.

Re-design of the reference's host CSR arrays
(reference: SpGEMM_cuda/main.cpp host arrays ``csrRowPtrA/csrColIdxA/csrValA``
and bhsparse.h ``initData`` [R — reconstructed, see SURVEY.md §0/§3]).

Key departure from the reference: XLA requires static shapes, so every
container carries *padded* ``colidx``/``vals`` buffers plus an exact
``rowptr``; ``nnz = rowptr[-1]`` is a (possibly traced) value while
``capacity = colidx.shape[0]`` is static.  Padding entries hold
``colidx == 0`` and ``vals == 0`` so they are always safe to gather
through; masking is done via row ids (padding maps to virtual row ``m``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Shape = Tuple[int, int]

INDEX_DTYPE = jnp.int32


_HOST_MIRROR: dict = {}


def host_view(x) -> np.ndarray:
    """Host numpy view of a possibly-device array, memoized — and the
    memo HOLDS the device array so its id() can't recycle (the stale-hit
    bug class of ops/dispatch._stats). Plan builders must never re-pull
    what the host already has: every device->host fetch synchronizes."""
    if isinstance(x, np.ndarray):
        return x
    key = id(x)
    hit = _HOST_MIRROR.get(key)
    if hit is not None and hit[1] is x:
        return hit[0]
    v = np.asarray(x)
    if len(_HOST_MIRROR) > 256:
        _HOST_MIRROR.clear()
    _HOST_MIRROR[key] = (v, x)
    return v


def _remember_host(dev, host) -> None:
    """Pre-populate the host mirror at construction time (from_scipy)."""
    if len(_HOST_MIRROR) > 256:
        _HOST_MIRROR.clear()
    _HOST_MIRROR[id(dev)] = (host, dev)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1). Used for growth-bucket padding."""
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def pad_bucket(n: int, minimum: int = 8) -> int:
    """Padding bucket policy: power-of-two growth buckets so recompiles are
    logarithmic in problem size (SURVEY.md §9 step 4)."""
    return max(next_pow2(n), minimum)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed Sparse Row matrix of static shape ``shape=(m, n)``.

    rowptr: (m+1,) int32, exact: rowptr[-1] == nnz.
    colidx: (capacity,) int32, entries [nnz:] are 0 (padding).
    vals:   (capacity,) float dtype, entries [nnz:] are 0 (padding).
    """

    rowptr: jax.Array
    colidx: jax.Array
    vals: jax.Array
    shape: Shape = dataclasses.field(metadata=dict(static=True))

    # ---- basic properties ------------------------------------------------
    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return self.colidx.shape[0]

    @property
    def nnz(self) -> jax.Array:
        """Exact number of stored entries (traced value under jit)."""
        return self.rowptr[-1]

    @property
    def dtype(self):
        return self.vals.dtype

    def row_lengths(self) -> jax.Array:
        return self.rowptr[1:] - self.rowptr[:-1]

    def row_ids(self) -> jax.Array:
        """Row id of every slot in colidx/vals; padding slots map to ``m``.

        Built with a scatter-add + cumsum instead of searchsorted: one
        (m,)-sized scatter and one (capacity,)-sized scan — both are cheap,
        fully-parallel XLA ops.
        """
        return row_ids_from_rowptr(self.rowptr, self.capacity)

    # ---- conversions -----------------------------------------------------
    def to_scipy(self):
        import scipy.sparse as sp

        # copies: jax array views are read-only and scipy may sort in place
        rowptr = host_view(self.rowptr).copy()
        nnz = int(rowptr[-1])
        mat = sp.csr_matrix(
            (
                host_view(self.vals)[:nnz].copy(),
                host_view(self.colidx)[:nnz].copy(),
                rowptr,
            ),
            shape=self.shape,
        )
        return mat

    @staticmethod
    def from_scipy(mat, capacity: int | None = None, dtype=None) -> "CSR":
        mat = mat.tocsr()
        mat.sort_indices()
        nnz = mat.nnz
        cap = capacity if capacity is not None else pad_bucket(nnz)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        dtype = dtype or mat.data.dtype
        colidx = np.zeros(cap, np.int32)
        vals = np.zeros(cap, dtype)
        colidx[:nnz] = mat.indices
        vals[:nnz] = mat.data
        rowptr_h = np.asarray(mat.indptr, np.int32)
        out = CSR(
            rowptr=jnp.asarray(rowptr_h),
            colidx=jnp.asarray(colidx),
            vals=jnp.asarray(vals),
            shape=tuple(mat.shape),
        )
        # the host already HAS these arrays: mirror them so plan builders
        # never pay a device->host pull (host_view docstring)
        _remember_host(out.rowptr, rowptr_h)
        _remember_host(out.colidx, colidx)
        if out.vals.dtype == vals.dtype:  # jnp may downcast (x64 off)
            _remember_host(out.vals, vals)
        return out

    @staticmethod
    def from_dense(arr, capacity: int | None = None) -> "CSR":
        import scipy.sparse as sp

        return CSR.from_scipy(sp.csr_matrix(np.asarray(arr)), capacity)

    def todense(self) -> np.ndarray:
        return np.asarray(self.to_scipy().todense())

    def to_coo(self) -> "COO":
        return COO(
            row=self.row_ids().astype(INDEX_DTYPE),
            col=self.colidx,
            vals=self.vals,
            shape=self.shape,
            nnz_hint=None,
        )

    def with_capacity(self, capacity: int) -> "CSR":
        """Grow/shrink the padded buffers (host-side; concrete arrays)."""
        nnz = int(np.asarray(self.rowptr)[-1])
        if capacity < nnz:
            raise ValueError(f"capacity {capacity} < nnz {nnz}")
        colidx = np.zeros(capacity, np.int32)
        vals = np.zeros(capacity, np.asarray(self.vals).dtype)
        colidx[:nnz] = np.asarray(self.colidx)[:nnz]
        vals[:nnz] = np.asarray(self.vals)[:nnz]
        return CSR(self.rowptr, jnp.asarray(colidx), jnp.asarray(vals), self.shape)

    def validate(self) -> "CSR":
        """Host-side structural validation with precise errors (the facade's
        guard against malformed user input). Returns self for chaining."""
        rowptr = np.asarray(self.rowptr)
        colidx = np.asarray(self.colidx)
        m, n = self.shape
        if rowptr.shape != (m + 1,):
            raise ValueError(f"rowptr shape {rowptr.shape} != ({m + 1},)")
        if rowptr[0] != 0:
            raise ValueError(f"rowptr[0] = {rowptr[0]} != 0")
        if (np.diff(rowptr) < 0).any():
            bad = int(np.argmax(np.diff(rowptr) < 0))
            raise ValueError(f"rowptr not non-decreasing at row {bad}")
        nnz = int(rowptr[-1])
        if nnz > self.capacity:
            raise ValueError(f"nnz {nnz} exceeds capacity {self.capacity}")
        if nnz and (colidx[:nnz] < 0).any():
            raise ValueError("negative column index")
        if nnz and (colidx[:nnz] >= n).any():
            bad = int(np.argmax(colidx[:nnz] >= n))
            raise ValueError(
                f"colidx[{bad}] = {colidx[bad]} out of range for n = {n}"
            )
        if self.vals.shape != self.colidx.shape:
            raise ValueError(
                f"vals shape {self.vals.shape} != colidx shape {self.colidx.shape}"
            )
        return self

    # ---- persistence (SURVEY.md §7.4: checkpoint/resume) ------------------
    def save(self, path: str) -> None:
        np.savez(
            path,
            rowptr=np.asarray(self.rowptr),
            colidx=np.asarray(self.colidx),
            vals=np.asarray(self.vals),
            shape=np.asarray(self.shape),
        )

    @staticmethod
    def load(path: str) -> "CSR":
        with np.load(path) as z:
            return CSR(
                rowptr=jnp.asarray(z["rowptr"], INDEX_DTYPE),
                colidx=jnp.asarray(z["colidx"], INDEX_DTYPE),
                vals=jnp.asarray(z["vals"]),
                shape=tuple(int(s) for s in z["shape"]),
            )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format matrix; padding entries have row == m (sentinel)."""

    row: jax.Array
    col: jax.Array
    vals: jax.Array
    shape: Shape = dataclasses.field(metadata=dict(static=True))
    nnz_hint: int | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    def to_csr(self, sort: bool = True, sum_duplicates: bool = False) -> "CSR":
        """COO→CSR fully inside JAX (jittable). Padding rows (== m) fall off
        the end of rowptr naturally."""
        return coo_to_csr(self, sort=sort, sum_duplicates=sum_duplicates)

    @staticmethod
    def from_arrays(row, col, vals, shape, capacity: int | None = None) -> "COO":
        row = np.asarray(row)
        col = np.asarray(col)
        vals = np.asarray(vals)
        nnz = row.shape[0]
        cap = capacity if capacity is not None else pad_bucket(nnz)
        m = shape[0]
        r = np.full(cap, m, np.int32)
        c = np.zeros(cap, np.int32)
        v = np.zeros(cap, vals.dtype)
        r[:nnz] = row
        c[:nnz] = col
        v[:nnz] = vals
        return COO(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), tuple(shape), nnz)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block CSR with dense (bm, bn) blocks — the block-matmul container.

    blocks: (nblocks_capacity, bm, bn) dense value blocks.
    rowptr/colidx index *block* rows/cols. Shape is in scalar elements and
    must be divisible by the block size.
    """

    rowptr: jax.Array
    colidx: jax.Array
    blocks: jax.Array
    shape: Shape = dataclasses.field(metadata=dict(static=True))

    @property
    def block_shape(self) -> Shape:
        return tuple(self.blocks.shape[1:])

    @property
    def mb(self) -> int:
        return self.shape[0] // self.blocks.shape[1]

    @property
    def nb(self) -> int:
        return self.shape[1] // self.blocks.shape[2]

    @property
    def nnzb(self) -> jax.Array:
        return self.rowptr[-1]

    def to_scipy(self):
        import scipy.sparse as sp

        rowptr = np.asarray(self.rowptr)
        nnzb = int(rowptr[-1])
        return sp.bsr_matrix(
            (np.asarray(self.blocks)[:nnzb], np.asarray(self.colidx)[:nnzb], rowptr),
            shape=self.shape,
        )

    @staticmethod
    def from_scipy(mat, block_shape=(8, 128), capacity: int | None = None) -> "BSR":
        import scipy.sparse as sp

        bm, bn = block_shape
        mat = sp.bsr_matrix(mat.tocsr(), blocksize=(bm, bn))
        nnzb = mat.indptr[-1]
        cap = capacity if capacity is not None else pad_bucket(max(nnzb, 1))
        blocks = np.zeros((cap, bm, bn), mat.data.dtype)
        colidx = np.zeros(cap, np.int32)
        blocks[:nnzb] = mat.data
        colidx[:nnzb] = mat.indices
        return BSR(
            rowptr=jnp.asarray(mat.indptr, INDEX_DTYPE),
            colidx=jnp.asarray(colidx),
            blocks=jnp.asarray(blocks),
            shape=tuple(mat.shape),
        )

    def to_csr(self, capacity: int | None = None) -> "CSR":
        return CSR.from_scipy(self.to_scipy().tocsr(), capacity)


# ---------------------------------------------------------------------------
# Pure-JAX structural helpers shared by the whole framework
# ---------------------------------------------------------------------------


def row_ids_from_rowptr(rowptr: jax.Array, capacity: int) -> jax.Array:
    """Expand a rowptr into per-slot row ids; slots >= nnz map to row m.

    scatter-add ones at each row start (skipping row 0's start at 0), then
    prefix-sum. Rows of length 0 contribute stacked increments at the same
    position, which cumsum handles exactly.
    """
    m = rowptr.shape[0] - 1
    hits = jnp.zeros(capacity, INDEX_DTYPE).at[rowptr[1:]].add(
        1, mode="drop", indices_are_sorted=True
    )
    # slots at index >= nnz accumulate all remaining row boundaries, including
    # rowptr[-1] itself => their cumsum reaches m.
    return jnp.minimum(jnp.cumsum(hits), m)


def coo_to_csr(coo: COO, sort: bool = True, sum_duplicates: bool = False) -> CSR:
    """Jittable COO→CSR. Padding entries (row == m) sort to the tail and are
    excluded from rowptr by construction."""
    m, n = coo.shape
    row, col, vals = coo.row, coo.col, coo.vals
    if sort:
        row, col, vals = jax.lax.sort(
            (row, col, vals), num_keys=2, is_stable=False
        )
    if sum_duplicates:
        valid = row < m
        prev_row = jnp.concatenate([jnp.full((1,), -1, row.dtype), row[:-1]])
        prev_col = jnp.concatenate([jnp.full((1,), -1, col.dtype), col[:-1]])
        is_head = (row != prev_row) | (col != prev_col)
        seg = jnp.cumsum(is_head.astype(INDEX_DTYPE)) - 1
        cap = row.shape[0]
        seg_for_sum = jnp.where(valid, seg, cap)
        new_vals = jax.ops.segment_sum(
            jnp.where(valid, vals, 0), seg_for_sum, num_segments=cap + 1
        )[:cap].astype(vals.dtype)
        head_and_valid = is_head & valid
        tgt = jnp.where(head_and_valid, seg, cap)
        new_row = (
            jnp.full(cap, m, INDEX_DTYPE).at[tgt].set(row, mode="drop")
        )
        new_col = jnp.zeros(cap, INDEX_DTYPE).at[tgt].set(col, mode="drop")
        row, col, vals = new_row, new_col, new_vals
    counts = jax.ops.segment_sum(
        (row < m).astype(INDEX_DTYPE), row, num_segments=m + 1
    )[:m]
    rowptr = jnp.concatenate(
        [jnp.zeros((1,), INDEX_DTYPE), jnp.cumsum(counts).astype(INDEX_DTYPE)]
    )
    return CSR(rowptr=rowptr, colidx=col, vals=vals, shape=coo.shape)


def csr_gather_rows(a: CSR, rows: jax.Array, nnz_capacity: int) -> CSR:
    """Extract a row subset of ``a`` as a new CSR of shape (len(rows), a.n).

    ``rows`` may be padded with sentinel ``a.m`` (those become empty rows).
    Jittable for static ``nnz_capacity``. This ragged gather is the workhorse
    for the long-row tail path (ops/binned.py) and the distributed B-row
    halo exchange (parallel/) — the analogue of the reference's
    per-bin row-permutation arrays (SURVEY.md §4 stage 2).
    """
    m, n = a.shape
    r = rows.shape[0]
    rows_c = jnp.minimum(rows, m - 1)
    in_range = rows < m
    lens = jnp.where(in_range, a.row_lengths()[rows_c], 0).astype(INDEX_DTYPE)
    starts_src = jnp.where(in_range, a.rowptr[rows_c], 0).astype(INDEX_DTYPE)
    ends = jnp.cumsum(lens)
    starts_dst = ends - lens
    total = ends[-1] if r > 0 else jnp.zeros((), INDEX_DTYPE)

    t = jnp.arange(nnz_capacity, dtype=INDEX_DTYPE)
    # scatter+cumsum slot->row map (cheaper than searchsorted; stacked +1
    # at each row's start skips empty rows exactly)
    hits = jnp.zeros(nnz_capacity, INDEX_DTYPE).at[starts_dst].add(
        1, mode="drop"
    )
    j = jnp.cumsum(hits) - 1
    j_c = jnp.clip(j, 0, r - 1)
    valid = t < total
    src = starts_src[j_c] + (t - starts_dst[j_c])
    src_c = jnp.clip(src, 0, a.capacity - 1)
    colidx = jnp.where(valid, a.colidx[src_c], 0).astype(INDEX_DTYPE)
    vals = jnp.where(valid, a.vals[src_c], 0)
    rowptr = jnp.concatenate([jnp.zeros((1,), INDEX_DTYPE), ends.astype(INDEX_DTYPE)])
    return CSR(rowptr=rowptr, colidx=colidx, vals=vals, shape=(r, n))


def csr_transpose(a: CSR) -> CSR:
    """Jittable CSR transpose via COO sort — needed for AMG R = P^T."""
    coo = a.to_coo()
    t = COO(row=coo.col, col=coo.row, vals=coo.vals, shape=(a.n, a.m))
    # padding currently has col-as-row == 0 which would pollute row counts;
    # remap padding slots to sentinel row a.n first.
    pad = coo.row >= a.m
    t = COO(
        row=jnp.where(pad, a.n, t.row).astype(INDEX_DTYPE),
        col=jnp.where(pad, 0, t.col).astype(INDEX_DTYPE),
        vals=jnp.where(pad, 0, t.vals),
        shape=t.shape,
    )
    return t.to_csr(sort=True)
