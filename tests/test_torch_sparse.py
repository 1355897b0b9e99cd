"""Port data layer vs the reference: synthetic ratings and padded/binned
layouts must be bit-equal (same seed, same arrays)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sparse import padded as ref_padded  # noqa: E402
from repro.sparse import synth as ref_synth  # noqa: E402
from repro_torch.sparse import padded as port_padded  # noqa: E402
from repro_torch.sparse import synth as port_synth  # noqa: E402

MINI = dict(name="netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)


def _assert_ell_equal(a, b):
    assert a.n_cols == b.n_cols
    np.testing.assert_array_equal(a.idx, b.idx)
    np.testing.assert_array_equal(a.val, b.val)
    np.testing.assert_array_equal(a.cnt, b.cnt)
    assert a.idx.dtype == b.idx.dtype and a.val.dtype == b.val.dtype
    assert a.cnt.dtype == b.cnt.dtype


def _assert_binned_equal(a, b):
    assert a.m == b.m and a.n_cols == b.n_cols and a.K_list == b.K_list
    for ba, bb, ra, rb in zip(a.bins, b.bins, a.rows, b.rows):
        _assert_ell_equal(ba, bb)
        np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(a.perm, b.perm)
    np.testing.assert_array_equal(a.inv_perm, b.inv_perm)


# netflix-mini fits in one chunk of the default PLANTED_CHUNK; a small
# chunk (7, 13, 1000) drives the generators through many ragged chunks
@pytest.mark.parametrize("seed,alpha_user,chunk", [
    (0, 0.0, port_synth.PLANTED_CHUNK),
    (2, 0.0, 7),
    (1, 0.7, port_synth.PLANTED_CHUNK),
    (3, 0.5, 1000),
])
def test_make_synthetic_ratings_bit_equal(monkeypatch, seed, alpha_user, chunk):
    monkeypatch.setattr(port_synth, "PLANTED_CHUNK", chunk)
    ref = ref_synth.make_synthetic_ratings(
        ref_synth.SynthSpec(**MINI), seed=seed, alpha_user=alpha_user)
    port = port_synth.make_synthetic_ratings(
        port_synth.SynthSpec(**MINI), seed=seed, alpha_user=alpha_user)
    for a, b in zip(ref[:3], port[:3]):
        _assert_ell_equal(a, b)
    for a, b in zip(ref[3], port[3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,alpha_user,n_bins,chunk", [
    (0, 0.0, 4, 13),
    (2, 0.6, 8, port_synth.PLANTED_CHUNK),
])
def test_make_synthetic_ratings_binned_bit_equal(monkeypatch, seed, alpha_user,
                                                 n_bins, chunk):
    monkeypatch.setattr(port_synth, "PLANTED_CHUNK", chunk)
    ref = ref_synth.make_synthetic_ratings_binned(
        ref_synth.SynthSpec(**MINI), n_bins, seed=seed, alpha_user=alpha_user)
    port = port_synth.make_synthetic_ratings_binned(
        port_synth.SynthSpec(**MINI), n_bins, seed=seed, alpha_user=alpha_user)
    _assert_binned_equal(ref[0], port[0])
    _assert_binned_equal(ref[1], port[1])
    _assert_ell_equal(ref[2], port[2])


def test_planted_dots_equal_one_shot_einsum():
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((50, 100)).astype(np.float32)
    ts = rng.standard_normal((30, 100)).astype(np.float32)
    rows = rng.integers(0, 50, 1001)
    cols = rng.integers(0, 30, 1001)
    want = np.einsum("kf,kf->k", xs[rows], ts[cols])
    for chunk in (1, 64, 1001, 5000):
        np.testing.assert_array_equal(
            port_synth.planted_dots(xs, ts, rows, cols, chunk), want)


def test_datasets_and_scaled_match():
    assert {k: tuple(vars(v).values()) for k, v in port_synth.DATASETS.items()} \
        == {k: tuple(vars(v).values()) for k, v in ref_synth.DATASETS.items()}
    for scale in (1e-3, 0.25):
        a = ref_synth.scaled(ref_synth.DATASETS["netflix"], scale, f=16)
        b = port_synth.scaled(port_synth.DATASETS["netflix"], scale, f=16)
        assert tuple(vars(a).values()) == tuple(vars(b).values())
        assert (a.bytes_R, a.bytes_factors, a.bytes_hermitian_all) == \
            (b.bytes_R, b.bytes_factors, b.bytes_hermitian_all)


def _ragged_csr(seed, m=60, n=37):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, m) * (rng.random(m) < 0.85)
    deg[rng.integers(0, m)] = 200              # one heavy row
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    cols = rng.integers(0, n, int(ptr[-1])).astype(np.int32)
    vals = rng.standard_normal(int(ptr[-1])).astype(np.float32)
    return ptr, cols, vals, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pad_and_bin_match_reference_on_ragged_csr(seed):
    ptr, cols, vals, n = _ragged_csr(seed)
    for k_cap in (None, 17):
        _assert_ell_equal(ref_padded.pad_csr_fast(ptr, cols, vals, n, k_cap=k_cap),
                          port_padded.pad_csr_fast(ptr, cols, vals, n, k_cap=k_cap))
        _assert_ell_equal(port_padded.pad_csr(ptr, cols, vals, n, k_cap=k_cap),
                          port_padded.pad_csr_fast(ptr, cols, vals, n, k_cap=k_cap))
    for n_bins, km in ((1, 8), (4, 8), (8, 16)):
        a = ref_padded.bin_rows(ptr, cols, vals, n, n_bins=n_bins, k_multiple=km)
        b = port_padded.bin_rows(ptr, cols, vals, n, n_bins=n_bins, k_multiple=km)
        _assert_binned_equal(a, b)
        _assert_ell_equal(a.to_padded(), b.to_padded())
        assert port_padded.bin_caps(200, n_bins, km) == ref_padded.bin_caps(200, n_bins, km)
        ell = port_padded.pad_csr_fast(ptr, cols, vals, n)
        _assert_binned_equal(ref_padded.bin_padded(ell, n_bins, km),
                             port_padded.bin_padded(ell, n_bins, km))
        _assert_binned_equal(a.row_slice(7, 41), b.row_slice(7, 41))


def test_row_slice_pad_rows_and_coo_match_reference():
    ptr, cols, vals, n = _ragged_csr(4)
    a = ref_padded.pad_csr_fast(ptr, cols, vals, n)
    b = port_padded.pad_csr_fast(ptr, cols, vals, n)
    _assert_ell_equal(ref_padded.row_slice(a, 3, 20), port_padded.row_slice(b, 3, 20))
    _assert_ell_equal(ref_padded.pad_rows(a, 70), port_padded.pad_rows(b, 70))
    for x, y in zip(a.transpose_coo(), b.transpose_coo()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.mask(), b.mask())
    assert (a.fill, a.padded_slots, a.nnz) == (b.fill, b.padded_slots, b.nnz)
    rows, cc, vv = np.array([3, 0, 3, 1]), np.array([2, 1, 0, 2]), np.ones(4)
    for x, y in zip(ref_padded.csr_from_coo(rows, cc, vv, 5),
                    port_padded.csr_from_coo(rows, cc, vv, 5)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        port_padded.row_slice(b, 5, 2)
    with pytest.raises(ValueError):
        port_padded.pad_rows(b, 3)


def test_make_rating_batches_match():
    r = port_synth.make_synthetic_ratings(port_synth.SynthSpec(**MINI), seed=0)[0]
    got = list(port_synth.make_rating_batches(r, 100))
    want = list(ref_synth.make_rating_batches(r, 100))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for x, y in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(x, y)
