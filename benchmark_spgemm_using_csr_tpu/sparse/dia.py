"""DIA (diagonal) sparse container — the format for stencil / banded
matrices.

The reference benchmark stores everything in CSR (SURVEY.md §1) and pays the
irregular gather/sort cost even for perfectly regular stencil matrices
(cant/consph FEM, mc2depi 5-point, banded regimes — SURVEY.md §8's suite).
The structurally right answer for diagonal-structured matrices is to store
the diagonals densely so every kernel becomes *static-shift vector
arithmetic*: no gathers, no sorts, pure HBM-bandwidth work. This is the same
format-specialization move the bhSPARSE project family applies on GPUs
(CSR5/DIA-style formats), re-derived for XLA: offsets are static Python
metadata, so every shift is a compile-time `lax.slice` and the whole SpGEMM
fuses into one elementwise pipeline.

Storage convention (matches ``scipy.sparse.dia_matrix``): ``data[s, j]``
holds entry ``M[j - offsets[s], j]`` — column-indexed planes of width n.
Invariant: plane slots outside the matrix (row or column out of range) are
exactly 0, so kernels never need masks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Shape = Tuple[int, int]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal-storage matrix of static shape ``shape=(m, n)``.

    data:    (ndiag, n) value planes, column-indexed (scipy convention).
    offsets: static tuple of diagonal offsets (col - row), sorted ascending.
    """

    data: jax.Array
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Shape = dataclasses.field(metadata=dict(static=True))

    # ---- basic properties ------------------------------------------------
    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype

    def valid_mask(self) -> np.ndarray:
        """(ndiag, n) bool: slot (s, j) is inside the matrix — row
        ``j - offsets[s]`` in [0, m) and column j in [0, n)."""
        j = np.arange(self.n)
        offs = np.asarray(self.offsets)[:, None]
        row = j[None, :] - offs
        return (row >= 0) & (row < self.m)

    # ---- conversions -----------------------------------------------------
    def to_scipy(self):
        import scipy.sparse as sp

        data = np.asarray(self.data)
        return sp.dia_matrix(
            (data, np.asarray(self.offsets)), shape=self.shape
        )

    def to_csr(self, prune: bool = True):
        """Host conversion to this package's CSR. ``prune`` drops
        numerically-zero slots (DIA planes over-approximate structure the
        same way BSR blocks do — see ops/bsr.spgemm_bsr)."""
        from .csr import CSR

        c = self.to_scipy().tocsr()
        if prune:
            c.eliminate_zeros()
        c.sort_indices()
        return CSR.from_scipy(c)

    @staticmethod
    def from_scipy(mat, dtype=None) -> "DIA":
        mat = mat.todia()
        m, n = mat.shape
        offsets = np.asarray(mat.offsets, dtype=np.int64)
        order = np.argsort(offsets)
        offsets = offsets[order]
        src = np.asarray(mat.data)[order]
        dtype = dtype or src.dtype
        data = np.zeros((len(offsets), n), dtype)
        w = min(src.shape[1], n)
        data[:, :w] = src[:, :w]
        # enforce the zero-outside-matrix invariant (scipy leaves garbage in
        # out-of-range slots when constructed from raw planes)
        j = np.arange(n)
        row = j[None, :] - offsets[:, None]
        data[(row < 0) | (row >= m)] = 0
        return DIA(jnp.asarray(data), tuple(int(o) for o in offsets), (m, n))

    @staticmethod
    def from_csr(a, offsets=None, dtype=None) -> "DIA":
        """Host CSR→DIA. ``offsets`` (static tuple) defaults to the set of
        occupied diagonals; entries off the given diagonals are an error."""
        sp_a = a.to_scipy().tocoo()
        m, n = sp_a.shape
        occ = sp_a.col.astype(np.int64) - sp_a.row.astype(np.int64)
        if offsets is None:
            offsets = np.unique(occ)
        else:
            offsets = np.asarray(sorted(offsets), dtype=np.int64)
        slot_of = {int(d): s for s, d in enumerate(offsets)}
        try:
            slots = np.array([slot_of[int(d)] for d in occ], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"entry on diagonal {e} not in offsets") from e
        dtype = dtype or sp_a.data.dtype
        data = np.zeros((len(offsets), n), dtype)
        data[slots, sp_a.col] = sp_a.data
        return DIA(jnp.asarray(data), tuple(int(o) for o in offsets), (m, n))
