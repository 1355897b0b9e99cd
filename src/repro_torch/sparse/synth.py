"""Synthetic rating matrices at the paper's data-set scales (Table 5).

The port's own copy of the reference generator: for the same arguments it
returns bit-equal arrays.  Recipe: draw a planted low-rank model X*,
Theta*, sample Nz (user, item) pairs with power-law item popularity,
observe r_uv = <x*_u, theta*_v>/sqrt(f) + noise, and hold out a test split.

One repair over the reference: the planted ratings are computed in row
chunks of :data:`PLANTED_CHUNK` ratings, so the host never holds the two
``[nnz, f]`` gathers ``x_star[rows]`` and ``t_star[cols]`` at once (20 GB
at quarter-Netflix scale, 79 GB at full Netflix).  The noise is still
drawn in one call, so the RNG sequence, and every array, is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.sparse.padded import (BinnedELL, PaddedELL, bin_rows,
                                       csr_from_coo, pad_csr_fast)

#: ratings per chunk of the planted dot products (~200 MB of gathers at f=100)
PLANTED_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """Scale recipe for one paper data set (Table 5)."""

    name: str
    m: int              # rows (users)
    n: int              # cols (items)
    nnz: int            # number of ratings
    f: int              # latent dimension used by the paper
    lam: float          # lambda (weighted-lambda regularization)

    @property
    def bytes_R(self) -> int:
        # CSR: 2*Nz + m + 1 fp32/int32 words (paper Table 3)
        return 4 * (2 * self.nnz + self.m + 1)

    @property
    def bytes_factors(self) -> int:
        return 4 * self.f * (self.m + self.n)

    @property
    def bytes_hermitian_all(self) -> int:
        return 4 * self.m * self.f * self.f


# Table 5 of the paper, verbatim.
DATASETS: Dict[str, SynthSpec] = {
    "netflix":    SynthSpec("netflix",    480_189,       17_770,    99_000_000,       100, 0.05),
    "yahoomusic": SynthSpec("yahoomusic", 1_000_990,     624_961,   252_800_000,      100, 1.4),
    "hugewiki":   SynthSpec("hugewiki",   50_082_603,    39_780,    3_100_000_000,    100, 0.05),
    "sparkals":   SynthSpec("sparkals",   660_000_000,   2_400_000, 3_500_000_000,    10,  0.05),
    "factorbird": SynthSpec("factorbird", 229_000_000,   195_000_000, 38_500_000_000, 5,   0.05),
    "facebook":   SynthSpec("facebook",   1_000_000_000, 48_000_000, 112_000_000_000, 16,  0.05),
    "cumf_max":   SynthSpec("cumf_max",   1_056_000_000, 48_000_000, 112_000_000_000, 100, 0.05),
}


def scaled(spec: SynthSpec, scale: float, f: int | None = None) -> SynthSpec:
    """Shrink a recipe by ``scale`` in every dimension (CPU-fit testing)."""
    return SynthSpec(
        name=f"{spec.name}@{scale:g}",
        m=max(16, int(spec.m * scale)),
        n=max(16, int(spec.n * scale)),
        nnz=max(64, int(spec.nnz * scale * scale)),
        f=f if f is not None else spec.f,
        lam=spec.lam,
    )


def _power_law_probs(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    rng.shuffle(p)
    return p / p.sum()


def planted_dots(x_star: np.ndarray, t_star: np.ndarray, rows: np.ndarray,
                 cols: np.ndarray, chunk: int = PLANTED_CHUNK) -> np.ndarray:
    """``einsum("kf,kf->k", x_star[rows], t_star[cols])`` computed
    ``chunk`` ratings at a time; each rating's dot product depends only on
    its own two rows, so the result is bit-equal to the one-shot einsum."""
    out = np.empty(len(rows), dtype=np.result_type(x_star, t_star))
    for lo in range(0, len(rows), chunk):
        hi = min(lo + chunk, len(rows))
        out[lo:hi] = np.einsum("kf,kf->k", x_star[rows[lo:hi]],
                               t_star[cols[lo:hi]])
    return out


def _planted_coo(spec: SynthSpec, seed: int, noise: float, alpha: float,
                 test_frac: float, alpha_user: float):
    """The reference's RNG sequence: planted factors, de-duplicated COO,
    noisy ratings, and the test/train permutation split."""
    rng = np.random.default_rng(seed)
    f = spec.f
    x_star = rng.standard_normal((spec.m, f)).astype(np.float32)
    t_star = rng.standard_normal((spec.n, f)).astype(np.float32)

    if alpha_user > 0.0:
        user_p = _power_law_probs(spec.m, alpha_user, rng)
        rows = rng.choice(spec.m, size=spec.nnz, p=user_p).astype(np.int64)
    else:
        rows = rng.integers(0, spec.m, size=spec.nnz, dtype=np.int64)
    item_p = _power_law_probs(spec.n, alpha, rng)
    cols = rng.choice(spec.n, size=spec.nnz, p=item_p).astype(np.int64)
    # de-duplicate (u, v) pairs
    key = rows * spec.n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    dots = planted_dots(x_star, t_star, rows, cols, PLANTED_CHUNK)
    vals = (dots / np.sqrt(f)
            + noise * rng.standard_normal(len(rows))).astype(np.float32)

    n_test = int(len(rows) * test_frac)
    perm = rng.permutation(len(rows))
    test_sel, train_sel = perm[:n_test], perm[n_test:]
    return rows, cols, vals, train_sel, test_sel, (x_star, t_star)


def make_synthetic_ratings(
    spec: SynthSpec,
    seed: int = 0,
    noise: float = 0.1,
    alpha: float = 0.8,
    test_frac: float = 0.1,
    k_multiple: int = 8,
    alpha_user: float = 0.0,
) -> Tuple[PaddedELL, PaddedELL, PaddedELL, Tuple[np.ndarray, np.ndarray]]:
    """Return (R_train as PaddedELL rows=users, R_train^T as PaddedELL
    rows=items, R_test, (X*, Theta*)) for a planted low-rank model.

    Items are power-law (``alpha``); users are uniform unless
    ``alpha_user > 0``.
    """
    rows, cols, vals, train_sel, test_sel, planted = _planted_coo(
        spec, seed, noise, alpha, test_frac, alpha_user)

    def _build(r, c, v, m, n):
        ptr, cc, vv = csr_from_coo(r, c, v, m)
        return pad_csr_fast(ptr, cc, vv, n, k_multiple=k_multiple)

    r_tr = _build(rows[train_sel], cols[train_sel], vals[train_sel], spec.m, spec.n)
    r_tr_T = _build(cols[train_sel], rows[train_sel], vals[train_sel], spec.n, spec.m)
    r_te = _build(rows[test_sel], cols[test_sel], vals[test_sel], spec.m, spec.n)
    return r_tr, r_tr_T, r_te, planted


def make_synthetic_ratings_binned(
    spec: SynthSpec,
    n_bins: int,
    seed: int = 0,
    noise: float = 0.1,
    alpha: float = 0.8,
    test_frac: float = 0.1,
    k_multiple: int = 8,
    alpha_user: float = 0.0,
) -> Tuple[BinnedELL, BinnedELL, PaddedELL, Tuple[np.ndarray, np.ndarray]]:
    """The same planted problem as :func:`make_synthetic_ratings`
    (identical RNG sequence, identical COO), with R and R^T built straight
    from CSR as :class:`BinnedELL`.  The test split stays a PaddedELL."""
    rows, cols, vals, train_sel, test_sel, planted = _planted_coo(
        spec, seed, noise, alpha, test_frac, alpha_user)

    def _build_binned(r, c, v, m, n):
        ptr, cc, vv = csr_from_coo(r, c, v, m)
        return bin_rows(ptr, cc, vv, n, n_bins=n_bins, k_multiple=k_multiple)

    r_tr = _build_binned(rows[train_sel], cols[train_sel], vals[train_sel],
                         spec.m, spec.n)
    r_tr_T = _build_binned(cols[train_sel], rows[train_sel], vals[train_sel],
                           spec.n, spec.m)
    ptr, cc, vv = csr_from_coo(rows[test_sel], cols[test_sel], vals[test_sel],
                               spec.m)
    r_te = pad_csr_fast(ptr, cc, vv, spec.n, k_multiple=k_multiple)
    return r_tr, r_tr_T, r_te, planted


def make_rating_batches(ell: PaddedELL, batch_rows: int):
    """Yield (row_offset, idx, val, cnt) batches of ``batch_rows`` rows —
    cuMF's q-batching / out-of-core streaming unit."""
    m = ell.m
    for lo in range(0, m, batch_rows):
        hi = min(lo + batch_rows, m)
        yield lo, ell.idx[lo:hi], ell.val[lo:hi], ell.cnt[lo:hi]
