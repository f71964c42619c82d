"""Fused runsum + tail-compaction as ONE sequential block scan.

The production tail (ops/chunked._segmented_runsum + _shift_compact +
global tails cumsum) costs ~#disp_bits full-stream passes (23 at
scircuit_256k's 46.1M-slot stream). The pass count is log2(total holes) —
irreducible for any global shift compaction.

This variant processes the sorted stream in blocks under ``lax.scan``:

- per block: segmented run-sum (log2(max_run) local passes + a carried
  cross-block prefix), tail detection (one-element lookahead via the next
  block's first key), local shift-compaction (log2(B) bits — block-local
  displacements only), and an inclusive kept-count cumsum;
- compacted block prefixes are appended at a RUNTIME offset with
  ``dynamic_update_slice`` on the loop-carried output buffers (XLA updates
  them in place), so cross-block compaction costs one write — not
  log2(holes) passes.

Total data movement ~ one read + one write of the stream plus
register-local pass work, vs ~23 full-stream memory passes. Correctness
for runs straddling any number of blocks is carried via (last key, last
group, running sum); group boundaries break chains exactly like the
production path (runs never straddle groups).

Block size: larger blocks amortize the scan-iteration overhead (carry
plumbing + the two dynamic_update_slice appends) against log2(B) extra
local passes. Default 262144, inherited from the first platform's sweep
and not yet re-derived on the GPU.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL_U32 = np.uint32(0xFFFFFFFF)


def _seg_scan(flag, x, passes):
    """Segmented inclusive sum within a block (log passes). The flag
    shifts in TRUE: its window clips at the block start, and shifting in
    False would cut the first elements' connectivity and drop the
    cross-block carry."""
    f = flag
    for p in (1 << np.arange(passes)):
        xs = jnp.concatenate([jnp.zeros(p, x.dtype), x[:-p]])
        fs = jnp.concatenate([jnp.ones(p, jnp.bool_), f[:-p]])
        x = x + jnp.where(f, xs, 0)
        f = f & fs
    return x, f  # f = connected-to-block-start


def _cumsum_pow2(x, passes):
    for p in (1 << np.arange(passes)):
        x = x + jnp.concatenate([jnp.zeros(p, x.dtype), x[:-p]])
    return x  # inclusive


def _local_compact(kept, disp, arrays, bits):
    """Block-local stable shift compaction (ops/chunked._shift_compact
    restricted to a block; displacements < B by construction)."""
    b, s = 0, 1
    cap = disp.shape[0]
    while s < cap and b < bits:
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


@functools.partial(
    jax.jit, static_argnames=("w", "out_cap", "max_run", "block")
)
def runsum_compact_scan(
    okey, oval, *, w: int, out_cap: int, max_run: int, block: int = 262144
):
    """(keyc[out_cap], valc[out_cap], tails_cum[S]) from the sorted grouped
    stream — drop-in for the production runsum + compaction + tails path.

    okey: (S,) uint32 sorted within each w-slot group, SENTINEL padding.
    oval: (S,) f32 product values in the same order.
    """
    # MISCOMPILE GUARD: when the sorted stream is
    # produced inside the same jit (the production pipeline: 2D sort ->
    # reshape(-1) -> this scan), streams LARGER THAN 2^23 slots whose group
    # width w is NOT a multiple of `block` compute garbage tails on XLA:CPU
    # (and on the first platform's compiler), deterministically,
    # content-dependent (found via
    # the circuit_64k heavy-row split, W=131040, s=9.43M: kept 6.95M vs
    # 8.82M true; regression test tests/test_scancompact_fusion.py).
    # Bisected: s <= 2^23 ok, flat params ok, returning the sort output
    # alongside ok, and an optimization_barrier between producer and scan
    # ok — i.e. a fusion-dependent XLA bug, not a semantics bug in the
    # scan (the same stream passed as a device array gives exact results).
    # The barrier forces the sorted stream to materialize before the scan
    # consumes it; the stream is HBM-resident either way, so this costs
    # nothing measurable.
    okey, oval = jax.lax.optimization_barrier((okey, oval))
    s = okey.shape[0]
    b = int(min(block, s))
    nb = -(-s // b)
    pad = nb * b - s
    if pad:
        okey = jnp.concatenate(
            [okey, jnp.full(pad, SENTINEL_U32, jnp.uint32)]
        )
        oval = jnp.concatenate([oval, jnp.zeros(pad, oval.dtype)])
    lb = max(int(b - 1).bit_length(), 1)
    rb = min(lb, max(int(max_run - 1).bit_length(), 1))
    k2 = okey.reshape(nb, b)
    v2 = oval.reshape(nb, b)
    firsts_next = jnp.concatenate(
        [k2[1:, 0], jnp.full((1,), SENTINEL_U32, jnp.uint32)]
    )
    iota = jnp.arange(b, dtype=jnp.int32)
    blk_ids = jnp.arange(nb, dtype=jnp.int32)
    # group id per slot = slot // w; only equality across consecutive
    # slots matters, i.e. whether a group boundary falls between them
    sent = jnp.uint32(SENTINEL_U32)

    def body(carry, xs):
        out_col, out_val, off, ckey, crun = carry
        k, v, fnext, i = xs
        base = i * b
        gb = ((base + iota) % w) == 0  # slot starts a group
        first_chain = (iota == 0) & (k[0] == ckey) & (base % w != 0)
        same = (
            jnp.concatenate(
                [jnp.zeros((1,), jnp.bool_), k[1:] == k[:-1]]
            )
            & ~gb
        ) | first_chain
        run, conn = _seg_scan(same, v, rb)
        run = run + jnp.where(conn & (k == ckey), crun, 0.0)
        valid = k != sent
        nxt_same = jnp.concatenate(
            [
                (k[1:] == k[:-1]) & ~gb[1:],
                ((k[b - 1:] == fnext) & (((base + b) % w) != 0)),
            ]
        )
        kept = valid & ~nxt_same
        csum = _cumsum_pow2(kept.astype(jnp.int32), lb)
        cnt = csum[-1]
        disp = iota - (csum - kept.astype(jnp.int32))
        colc, valc = _local_compact(
            kept, jnp.where(kept, disp, 0),
            [k.astype(jnp.int32), run], lb,
        )
        out_col = jax.lax.dynamic_update_slice(out_col, colc, (off,))
        out_val = jax.lax.dynamic_update_slice(out_val, valc, (off,))
        tails = off + csum
        return (
            (out_col, out_val, off + cnt, k[b - 1], run[b - 1]),
            tails,
        )

    # carry inits derive from the inputs (x * 0 terms) so that under
    # shard_map they inherit the inputs' varying manual axes — plain
    # constants are unvarying and lax.scan rejects the carry type
    # mismatch once the body's outputs become varying (hit by the
    # distributed grouped kernel)
    zero_i = (okey[0] ^ okey[0]).astype(jnp.int32)
    zero_v = oval[0] * jnp.zeros((), oval.dtype)
    out_col0 = jnp.zeros(out_cap + b, jnp.int32) + zero_i
    out_val0 = jnp.zeros(out_cap + b, oval.dtype) + zero_v
    (out_col, out_val, _, _, _), tails = jax.lax.scan(
        body,
        (out_col0, out_val0, zero_i, sent ^ okey[0] ^ okey[0], zero_v),
        (k2, v2, firsts_next, blk_ids),
    )
    return (
        out_col[:out_cap],
        out_val[:out_cap],
        tails.reshape(-1)[:s],
    )
