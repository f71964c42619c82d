"""Per-row sort + duplicate-merge tests (ops/sortmerge) against numpy."""
import numpy as np
import pytest

from benchmark_spgemm_using_csr_tpu.ops.sortmerge import bin_sort_compress


def _golden(col, val, n):
    """Per-row sorted-unique merge, numpy reference."""
    r, w = col.shape
    cols_out = []
    vals_out = []
    counts = np.zeros(r, np.int32)
    for i in range(r):
        mask = col[i] < n
        c, inv = np.unique(col[i][mask], return_inverse=True)
        v = np.zeros(len(c), val.dtype)
        np.add.at(v, inv, val[i][mask])
        cols_out.append(c)
        vals_out.append(v)
        counts[i] = len(c)
    return cols_out, vals_out, counts


@pytest.mark.parametrize("width", [8, 32, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_compress_vs_numpy(width, seed):
    rng = np.random.default_rng(seed)
    r, n = 16, 50
    lens = rng.integers(0, width + 1, size=r)
    col = np.full((r, width), n, np.int32)
    val = np.zeros((r, width), np.float32)
    for i in range(r):
        col[i, : lens[i]] = rng.integers(0, n, size=lens[i])
        val[i, : lens[i]] = rng.standard_normal(lens[i]).astype(np.float32)

    ocol, oval, pos, cnt = bin_sort_compress(col, val, n_sentinel=n)
    ocol, oval, pos, cnt = map(np.asarray, (ocol, oval, pos, cnt))

    gcols, gvals, gcnt = _golden(col, val, n)
    np.testing.assert_array_equal(cnt, gcnt)
    for i in range(r):
        tails = pos[i] < width
        got_pos = pos[i][tails]
        order = np.argsort(got_pos)
        np.testing.assert_array_equal(np.sort(got_pos), np.arange(gcnt[i]))
        np.testing.assert_array_equal(ocol[i][tails][order], gcols[i])
        np.testing.assert_allclose(oval[i][tails][order], gvals[i], rtol=1e-5, atol=1e-6)


def test_all_duplicates_one_column():
    r, w, n = 8, 16, 10
    col = np.full((r, w), 3, np.int32)
    val = np.ones((r, w), np.float32)
    ocol, oval, pos, cnt = bin_sort_compress(col, val, n_sentinel=n)
    assert np.all(np.asarray(cnt) == 1)
    tails = np.asarray(pos) < w
    assert np.all(np.asarray(oval)[tails] == w)


def test_empty_rows():
    r, w, n = 8, 8, 10
    col = np.full((r, w), n, np.int32)
    val = np.zeros((r, w), np.float32)
    _, _, pos, cnt = bin_sort_compress(col, val, n_sentinel=n)
    assert np.all(np.asarray(cnt) == 0)
    assert np.all(np.asarray(pos) == w)


def _tile_golden(key, val, sentinel, cbits, wlr):
    """Per-tile sorted-unique merge + per-local-row counts, numpy."""
    out = []
    for t in range(key.shape[0]):
        live = key[t] < sentinel
        uk, inv = np.unique(key[t][live], return_inverse=True)
        uv = np.zeros(len(uk), np.float64)
        np.add.at(uv, inv, val[t][live])
        cnt = np.bincount(uk >> cbits, minlength=wlr)[:wlr]
        out.append((uk, uv, cnt))
    return out


@pytest.mark.parametrize("width,wlr,cbits", [(16, 2, 4), (64, 4, 6),
                                             (256, 8, 9)])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_sort_merge_vs_numpy(width, wlr, cbits, seed):
    from benchmark_spgemm_using_csr_tpu.ops.sortmerge import tile_sort_merge

    rng = np.random.default_rng(seed)
    tiles, sentinel = 12, 1 << 30
    lr = rng.integers(0, wlr, size=(tiles, width))
    col = rng.integers(0, 1 << cbits, size=(tiles, width))
    key = ((lr << cbits) | col).astype(np.int32)
    key[rng.random((tiles, width)) < 0.3] = sentinel
    key[0] = sentinel  # an all-padding tile
    val = rng.standard_normal((tiles, width)).astype(np.float32)

    okey, oval, pos, cnt = map(np.asarray, tile_sort_merge(
        key, val, sentinel=sentinel, wlr=wlr, cbits=cbits))
    for t, (uk, uv, gcnt) in enumerate(
            _tile_golden(key, val, sentinel, cbits, wlr)):
        tails = pos[t] < width
        order = np.argsort(pos[t][tails])
        np.testing.assert_array_equal(np.sort(pos[t][tails]),
                                      np.arange(len(uk)))
        np.testing.assert_array_equal(okey[t][tails][order], uk)
        np.testing.assert_allclose(oval[t][tails][order], uv, rtol=1e-5,
                                   atol=1e-5)
        assert np.all(okey[t][~tails] == sentinel)
        assert np.all(oval[t][~tails] == 0)
        np.testing.assert_array_equal(cnt[t], gcnt)


def test_sort_compress_rejects_non_power_of_two_width():
    col = np.zeros((2, 12), np.int32)
    with pytest.raises(ValueError, match="power of two"):
        bin_sort_compress(col, col.astype(np.float32), n_sentinel=5)
