"""Per-row sort + duplicate merge over dense (rows, width) product tiles.

This is the ESC stage-3 primitive of the reference (its shared-memory
bitonic ESC, SURVEY.md §4) for tiles whose rows are short enough to sort
independently. Input lanes hold (key, value) products; invalid lanes carry
a sentinel key that is larger than every valid key. Each row is:

1. sorted by key along the lane axis (``lax.sort``; XLA's GPU sort works on
   one short row at a time, so no global product sort is paid);
2. run-summed over equal keys (a segmented inclusive scan);
3. reduced to its run tails, each with its position among the row's tails,
   so callers scatter straight into C without a compacted intermediate.

``tile_sort_merge`` is the variant for PACKED tiles (several complete C rows
per tile row, key = local_row << cbits | col) and also returns per-local-row
tail counts, from which the caller derives C.rowptr.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..sparse.csr import INDEX_DTYPE


def _segmented_add(left, right):
    """Combine for a segmented inclusive sum: (head flag, running value)."""
    lf, lv = left
    rf, rv = right
    return lf | rf, jnp.where(rf, rv, lv + rv)


def sort_merge_rows(key: jax.Array, val: jax.Array, sentinel: int):
    """Sort every row of ``key``/``val`` by key and merge equal keys.

    Returns (keys, vals, pos, is_tail): run tails keep their key and the
    run's summed value (other lanes: ``sentinel`` / 0); ``pos`` is each
    tail's index among its row's tails (``width`` for non-tail lanes)."""
    width = key.shape[1]
    key, val = jax.lax.sort((key, val), dimension=1, num_keys=1)
    prev = jnp.concatenate(
        [jnp.full((key.shape[0], 1), -1, key.dtype), key[:, :-1]], axis=1
    )
    nxt = jnp.concatenate(
        [key[:, 1:], jnp.full((key.shape[0], 1), sentinel, key.dtype)], axis=1
    )
    _, run_val = jax.lax.associative_scan(
        _segmented_add, (key != prev, val), axis=1
    )
    is_tail = (key < sentinel) & (key != nxt)
    pos = jnp.cumsum(is_tail.astype(jnp.int32), axis=1) - 1
    return (
        jnp.where(is_tail, key, sentinel).astype(key.dtype),
        jnp.where(is_tail, run_val, jnp.zeros((), val.dtype)),
        jnp.where(is_tail, pos, width).astype(jnp.int32),
        is_tail,
    )


def _check_width(width: int) -> None:
    if width & (width - 1):
        raise ValueError(f"width {width} must be a power of two")


@functools.partial(jax.jit, static_argnames=("n_sentinel",))
def bin_sort_compress(col: jax.Array, val: jax.Array, *, n_sentinel: int):
    """Sort + duplicate-merge + positions over a (rows, width) product tile
    (width a power of two; invalid lanes carry ``n_sentinel``).

    Returns (cols, vals, pos, counts):
      cols/vals: run-tail entries (unique columns, merged values), others
                 sentinel / 0;
      pos:       per-entry unique index within its row (width => drop);
      counts:    (rows,) exact per-row nnzC.
    """
    _check_width(col.shape[1])
    ocol, oval, pos, is_tail = sort_merge_rows(col, val, n_sentinel)
    counts = jnp.sum(is_tail, axis=1).astype(INDEX_DTYPE)
    return ocol, oval, pos, counts


@functools.partial(jax.jit, static_argnames=("sentinel", "wlr", "cbits"))
def tile_sort_merge(
    key: jax.Array, val: jax.Array, *, sentinel: int, wlr: int, cbits: int
):
    """Sort + duplicate-merge + positions + per-local-row counts over a
    (tiles, width) PACKED product tile (several complete C rows per tile
    row, key = local_row << cbits | col; invalid lanes carry ``sentinel``).

    Returns (keys, vals, pos, counts):
      keys/vals: run-tail entries (merged values), others sentinel / 0;
      pos:       per-entry tail index within its tile (width => drop);
      counts:    (tiles, wlr) exact per-(tile, local_row) nnzC.
    """
    _check_width(key.shape[1])
    okey, oval, pos, is_tail = sort_merge_rows(key, val, sentinel)
    # sentinel lanes fail is_tail, so the local-row id needs no masking
    lr = jax.lax.shift_right_logical(okey, cbits)
    onehot = (lr[:, :, None] == jnp.arange(wlr, dtype=lr.dtype)) & is_tail[
        :, :, None
    ]
    return okey, oval, pos, jnp.sum(onehot, axis=1, dtype=jnp.int32)
