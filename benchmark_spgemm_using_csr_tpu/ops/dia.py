"""SpGEMM / SpMV on DIA (diagonal) storage — static-shift vector kernels.

For diagonal-structured matrices (stencils, bands — the cant/consph/mc2depi
regimes of the reference suite, SURVEY.md §8) the product's structure is
known at trace time: ``C`` lives on the offset-sums ``d1 + d2``. Every term

    C[dc, j] += A[d1, j - d2] * B[d2, j]        (dc = d1 + d2)

is a *compile-time-shifted* elementwise multiply-add over length-n planes:
zero gathers, zero sorts, pure HBM-bandwidth work that XLA fuses into a
handful of vector ops. The reference's CSR kernels (bin dispatcher + heap/
ESC/merge, SURVEY.md §4) pay irregular-memory cost even on these matrices;
format dispatch avoids it (same move as the BSR path in ops/bsr.py).

All offsets are static Python ints → shifts lower to ``lax.slice`` and the
kernel jit-compiles to one fused pipeline. Dispatch from CSR is decided by
the measured cost model in ``dia_viable`` (host, plan time — the analogue
of the reference's stage-2 binning decision).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..sparse.csr import CSR, host_view
from ..sparse.dia import DIA


def dia_spgemm(a: DIA, b: DIA) -> DIA:
    """C = A @ B entirely on diagonal planes (jit-able; offsets static).

    Cost: ndiag(A) * ndiag(B) length-n fused FMAs — bandwidth-bound, no
    data-dependent memory access. Invalid slots stay exactly 0 because both
    inputs honor the DIA zero-outside-matrix invariant.
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    off_c = sorted({d1 + d2 for d1 in a.offsets for d2 in b.offsets})
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if not off_c:  # either operand all-zero (no stored diagonals)
        return DIA(jnp.zeros((1, n), out_dtype), (0,), (m, n))

    # pad A's planes so every shifted read A[d1, j - d2], j in [0, n) is a
    # static in-bounds slice; out-of-plane reads are zeros by construction
    d2_max = max(b.offsets)
    d2_min = min(b.offsets)
    pad_l = max(0, d2_max)
    pad_r = max(0, n - k - d2_min)
    a_pad = jnp.pad(a.data.astype(out_dtype), ((0, 0), (pad_l, pad_r)))

    # GATHER form: each C plane is an independent sum of its (d1, d2) terms
    # (d1 + d2 == dc). A scatter-add accumulator would read-modify-write the
    # FULL (nd_c, n) stack once per B diagonal; summing per output plane
    # lets XLA fuse each plane into one pass with no read-modify-write.
    a_slot = {d: s for s, d in enumerate(a.offsets)}
    terms: dict[int, list] = {dc: [] for dc in off_c}
    for s2, d2 in enumerate(b.offsets):
        for d1 in a.offsets:
            terms[d1 + d2].append((a_slot[d1], s2, d2))
    b_data = b.data.astype(out_dtype)
    planes = []
    for dc in off_c:
        acc = None
        for s1, s2, d2 in terms[dc]:
            start = pad_l - d2
            a_sh = jax.lax.slice(a_pad, (s1, start), (s1 + 1, start + n))
            prod = a_sh[0] * b_data[s2]
            acc = prod if acc is None else acc + prod
        planes.append(acc)
    return DIA(jnp.stack(planes), tuple(off_c), (m, n))


def dia_spmv(a: DIA, x: jax.Array) -> jax.Array:
    """y = A @ x via static-shift multiply-adds: y[i] = sum_s (A_s * x)[i + d_s]."""
    m, k = a.shape
    out_dtype = jnp.result_type(a.dtype, x.dtype)
    t = a.data.astype(out_dtype) * x[None, :].astype(out_dtype)  # (nd, k)
    d_min = min(a.offsets)
    d_max = max(a.offsets)
    pad_l = max(0, -d_min)
    pad_r = max(0, m + d_max - k)
    t_pad = jnp.pad(t, ((0, 0), (pad_l, pad_r)))
    y = jnp.zeros((m,), out_dtype)
    for s, d in enumerate(a.offsets):
        start = pad_l + d
        y = y + jax.lax.slice(t_pad[s], (start,), (start + m,))
    return y


def dia_offsets_of(a: CSR) -> np.ndarray:
    """Occupied diagonals of a CSR matrix (host, plan time)."""
    rowptr = host_view(a.rowptr)
    nnz = int(rowptr[-1])
    rows = np.repeat(
        np.arange(a.m, dtype=np.int64), np.diff(rowptr).astype(np.int64)
    )
    cols = host_view(a.colidx)[:nnz].astype(np.int64)
    return np.unique(cols - rows)


def dia_viable(
    a: CSR,
    max_plane_bytes: int = 512 << 20,
    chunked_ns_per_product: float = 15.0,
    dia_ns_per_slot: float = 0.1,
    op_overhead_s: float = 25e-6,
) -> bool:
    """Cost-model dispatch for C = A @ A (the analogue of ops/bsr.bsr_viable).

    DIA work is ndiag^2 * n plane-slot FMAs plus a per-diagonal op
    overhead, versus a per-product cost on the chunked sort/gather path.
    The defaults are coarse and uncalibrated; api.spgemm's auto dispatch
    uses the calibrated model in ops/dispatch instead. Memory: the C
    accumulator holds <= ndiag^2 planes of n values.
    """
    offs = dia_offsets_of(a)
    nd = len(offs)
    if nd == 0:
        return True
    # early out before the O(nd^2) offset-sum table: many-diagonal matrices
    # can never win on the nd^2*n cost (and the table itself would be huge)
    if nd > 4096 or nd * nd * a.n * dia_ns_per_slot * 1e-9 > 10.0:
        return False
    # C plane count: at most nd^2 distinct offset sums, at most the full
    # span; bound memory by the true count
    n_off_c = len(np.unique(offs[:, None] + offs[None, :]))
    itemsize = np.dtype(a.vals.dtype).itemsize
    if n_off_c * a.n * itemsize > max_plane_bytes:
        return False
    rowptr = host_view(a.rowptr)
    nnz = int(rowptr[-1])
    row_lens = np.diff(rowptr).astype(np.int64)
    cols = host_view(a.colidx)[:nnz].astype(np.int64)
    products = int(row_lens[cols].sum())
    dia_s = nd * nd * a.n * dia_ns_per_slot * 1e-9 + nd * op_overhead_s
    return dia_s < products * chunked_ns_per_product * 1e-9


def spgemm_dia(a_csr: CSR, b_csr: CSR) -> CSR:
    """Host-facing CSR→DIA→multiply→CSR convenience wrapper.

    Mirrors ops/bsr.spgemm_bsr: plane slots that compute to exactly 0.0 are
    structurally absent in the true C and are pruned so the CSR structure
    matches the scalar paths.
    """
    a_d = DIA.from_csr(a_csr)
    b_d = a_d if b_csr is a_csr else DIA.from_csr(b_csr)
    return dia_spgemm(a_d, b_d).to_csr(prune=True)
