"""Synthetic Table-5 rating matrices, made on the device from a seed.

The recipe is the port's ``sparse/synth.py`` one, rewritten in torch so
that a full-size matrix takes seconds and not minutes: a planted model X*,
Theta* (standard normal, width f), users uniform, items drawn by a power
law of exponent ``alpha``, duplicate (user, item) pairs removed, ratings
``rating_scale * (<x*_u, theta*_v> / sqrt(f) + noise * N(0, 1))``, and a
test split.  ``rating_scale`` puts the ratings on their data set's scale,
against which the paper's lambda was chosen.

Three departures:

- the configuration's ``nnz`` is the paper's count of training ratings;
  the test split (``test_nnz``, the data set's published probe or
  validation size) is drawn in addition, from the same distribution;
- pairs are drawn until exactly ``nnz + test_nnz`` distinct ones remain,
  instead of drawing a count and losing the duplicates;
- the sparsity pattern and the test split come from the configuration's
  fixed ``pattern_seed``; the run's seed draws the planted model, the
  noise and the initial factors.  Every seed therefore has the same
  pattern, so the same degree bins, blocks and slot collisions, and does
  the same work.

The program is handed what cuMF takes as input: the CSR of R (train), the
CSR of R^T (train) and the CSR of the test split, as host numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: ratings per chunk of the planted dot products (two [chunk, f] gathers)
DOT_CHUNK = 1 << 22
#: draw rounds before the pair sampler gives up (nnz too close to m * n)
MAX_ROUNDS = 64


@dataclasses.dataclass
class Csr:
    """One sparse matrix in CSR form on the host."""

    ptr: np.ndarray    # [rows + 1] int64
    cols: np.ndarray   # [nnz] int32
    vals: np.ndarray   # [nnz] float32
    n_cols: int

    @property
    def rows(self) -> int:
        return self.ptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return int(self.ptr[-1])


@dataclasses.dataclass
class Problem:
    """What one run factorizes: train R, train R^T, the test split, and the
    initial factors (on the device)."""

    r: Csr
    rt: Csr
    test: Csr
    x0: torch.Tensor
    theta0: torch.Tensor


def stream_seed(seed: int, purpose: int) -> int:
    """A 63-bit generator seed for one purpose of one run seed, so that each
    draw has its own stream whatever the sizes of the others."""
    if seed < 0:
        raise ValueError(f"seed must be a whole number >= 0, got {seed}")
    return int(np.random.SeedSequence([seed, purpose]).generate_state(2, np.uint64)[0] >> 1)


def _gen(device: torch.device, seed: int, purpose: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, purpose))


def power_law_cdf(n: int, alpha: float, device) -> torch.Tensor:
    """Cumulative item probabilities ``rank^-alpha`` (float64, ends at 1)."""
    p = torch.arange(1, n + 1, dtype=torch.float64, device=device).pow_(-alpha)
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def draw_pattern(m: int, n: int, nnz: int, alpha: float, gen: torch.Generator,
                 device) -> torch.Tensor:
    """Exactly ``nnz`` distinct keys ``user * n + item``, ascending: users
    uniform, items by the power law, drawn in rounds until enough distinct
    pairs exist, then a uniform random subset of exactly ``nnz``."""
    if nnz > m * n:
        raise ValueError(f"{nnz} ratings do not fit a {m} x {n} matrix")
    cdf = power_law_cdf(n, alpha, device)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    for _ in range(MAX_ROUNDS):
        short = nnz - keys.numel()
        if short <= 0:
            break
        draw = short + short // 4 + 1024
        users = torch.randint(0, m, (draw,), generator=gen, device=device)
        u = torch.rand(draw, generator=gen, dtype=torch.float64, device=device)
        items = torch.searchsorted(cdf, u).clamp_(max=n - 1)
        keys = torch.unique(torch.cat([keys, users * n + items]))
        del users, u, items
    else:
        raise RuntimeError(f"{MAX_ROUNDS} rounds drew fewer than {nnz} distinct pairs")
    if keys.numel() > nnz:
        keep = torch.randperm(keys.numel(), generator=gen, device=device)[:nnz]
        keys = torch.sort(keys[keep]).values
    return keys


def _csr(major: torch.Tensor, minor: torch.Tensor, vals: torch.Tensor,
         n_major: int, n_minor: int) -> Csr:
    """CSR with rows ``major``, sorted by (major, minor), copied to the host."""
    key, order = torch.sort(major * n_minor + minor)
    counts = torch.bincount(major, minlength=n_major)
    ptr = torch.zeros(n_major + 1, dtype=torch.int64, device=major.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    cols = (key % n_minor).to(torch.int32)
    out = Csr(ptr=ptr.cpu().numpy(), cols=cols.cpu().numpy(),
              vals=vals[order].cpu().numpy(), n_cols=n_minor)
    return out


def make_problem(cfg: dict, seed: int, device) -> Problem:
    """The run's ratings and initial factors from ``cfg`` (a configuration
    file's dict) and the run's ``seed``."""
    device = torch.device(device)
    m, n, f = int(cfg["m"]), int(cfg["n"]), int(cfg["f"])
    n_train, n_test = int(cfg["nnz"]), int(cfg["test_nnz"])
    nnz = n_train + n_test
    pat = _gen(device, int(cfg["pattern_seed"]), 0)
    keys = draw_pattern(m, n, nnz, float(cfg["alpha"]), pat, device)
    test = torch.zeros(nnz, dtype=torch.bool, device=device)
    test[torch.randperm(nnz, generator=pat, device=device)[:n_test]] = True

    # the data set's own item ids: popularity is not in id order (the
    # recipe's shuffle), so a g x g blocking sees balanced item blocks
    item_ids = torch.randperm(n, generator=pat, device=device)
    users, items = keys // n, item_ids[keys % n]
    del keys, item_ids

    planted = _gen(device, seed, 2)
    x_star = torch.randn((m, f), generator=planted, device=device)
    t_star = torch.randn((n, f), generator=planted, device=device)
    rating_scale = float(cfg["rating_scale"])
    vals = torch.randn(nnz, generator=_gen(device, seed, 3), device=device)
    vals.mul_(float(cfg["noise"]) * rating_scale)
    scale = rating_scale / math.sqrt(f)
    for lo in range(0, nnz, DOT_CHUNK):
        hi = min(lo + DOT_CHUNK, nnz)
        dots = (x_star[users[lo:hi]] * t_star[items[lo:hi]]).sum(1)
        vals[lo:hi].add_(dots, alpha=scale)
    del x_star, t_star, dots

    train = ~test
    ut, it, vt = users[train], items[train], vals[train]
    r = _csr(ut, it, vt, m, n)
    rt = _csr(it, ut, vt, n, m)
    del ut, it, vt
    te = _csr(users[test], items[test], vals[test], m, n)
    del users, items, vals, test, train

    init = _gen(device, seed, 4)
    scale0 = float(cfg["init_scale"])
    x0 = torch.rand((m, f), generator=init, device=device) * scale0
    theta0 = torch.rand((n, f), generator=init, device=device) * scale0
    return Problem(r=r, rt=rt, test=te, x0=x0, theta0=theta0)
