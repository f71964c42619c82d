"""Regression: runsum_compact_scan fused behind an in-jit producer.

Finding: with the sorted stream PRODUCED inside the
same jit (2D sort -> reshape(-1) -> scan, the production grouped pipeline),
streams > 2^23 slots whose group width is not a multiple of the scan block
computed garbage tails on XLA:CPU (and on the first platform's compiler)
— deterministic and
content-dependent (a uniform-random stream did NOT trigger it; the
realistic multi-local-row key structure below does). Flat device-array
inputs were always correct, implicating a fusion-dependent XLA miscompile;
ops/scancompact.py now pins its inputs with jax.lax.optimization_barrier.

This test reproduces the trigger shape end-to-end and must stay green.
~35 MB stream, ~20 s on CPU -> marked slow.
"""
import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu.ops.scancompact import (
    SENTINEL_U32,
    runsum_compact_scan,
)


@pytest.mark.slow
def test_fused_producer_large_nonaligned_groups():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    w = 131040  # NOT a multiple of the scan block (65536 or 262144)
    g = 72  # s = 9.43M > 2^23
    key2 = np.full((g, w), SENTINEL_U32, np.uint32)
    for gi in range(16):
        fill = int(rng.integers(15800, w // 8))
        lrs = np.sort(rng.integers(0, 64, size=fill).astype(np.uint64))
        cols = rng.integers(0, 65536, size=fill).astype(np.uint64)
        key2[gi, :fill] = np.sort((lrs << 16) | cols).astype(np.uint32)
    val2 = np.where(
        key2 != np.uint32(SENTINEL_U32), 1.0, 0.0
    ).astype(np.float32)

    okey_np = np.sort(key2, axis=1).reshape(-1)
    s = len(okey_np)
    gid = np.arange(s) // w
    valid = okey_np != np.uint32(SENTINEL_U32)
    nxt = np.zeros(s, bool)
    nxt[:-1] = (okey_np[1:] == okey_np[:-1]) & (gid[1:] == gid[:-1])
    want_cum = np.cumsum(valid & ~nxt)

    @jax.jit
    def fused(k, v):
        okey, oval = jax.lax.sort((k, v), dimension=1, num_keys=1)
        return runsum_compact_scan(
            okey.reshape(-1), oval.reshape(-1),
            w=w, out_cap=g * w, max_run=2048,
        )

    _, _, tails = fused(jnp.asarray(key2), jnp.asarray(val2))
    np.testing.assert_array_equal(np.asarray(tails), want_cum)
