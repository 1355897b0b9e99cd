"""The plain reference of ALS and the comparison that decides ``correct``.

Plain torch, from the benchmark's own CSR matrices; it imports nothing of
the program and takes none of its layouts.  Two parts:

- the judge (:func:`judge_als`) reads the program's factors only to judge
  them.  A half-iteration solves, for every row u of one side,
  ``A_u x_u = b_u`` with ``A_u = sum_v theta_v theta_v^T + lam n_u I`` and
  ``b_u = sum_v r_uv theta_v`` over the row's ratings.  The judge forms
  neither A nor a solve: in float64 it takes each row's residual
  ``A_u x_u - b_u = sum_v theta_v (theta_v . x_u - r_uv) + lam n_u x_u``
  and its normwise backward error
  ``eta_u = |A_u x_u - b_u| / (tr(A_u) |x_u| + |b_u|)``, which a backward
  stable float32 solve keeps near float32's rounding whatever the row's
  conditioning.  The train and test RMSE are recomputed in float64.
- the solver (:func:`als_reference_run`), the reference put in the
  program's place: padded per-row Gram matrices by ``bmm`` and a batched
  Cholesky solve, in float32 with TF32 off, or in TF32 for the control.
"""
from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch

from mfbench.data import Csr

#: ratings per chunk of the judge's float64 gathers (two [chunk, f] arrays)
JUDGE_CHUNK = 1 << 22
#: gathered floats per group of rows in the solver ([rows, K, f] float32)
GROUP_ELEMS = 1 << 28
#: rows per group of the solver (its [rows, f, f] Gram matrices)
GROUP_ROWS = 1 << 16


def _row_chunks(ptr: np.ndarray, chunk: int):
    """Consecutive row ranges [r0, r1) holding at most ``chunk`` ratings
    (a single heavier row makes a range of its own)."""
    rows = ptr.shape[0] - 1
    r0 = 0
    while r0 < rows:
        r1 = int(np.searchsorted(ptr, ptr[r0] + chunk, side="right")) - 1
        r1 = min(max(r1, r0 + 1), rows)
        yield r0, r1
        r0 = r1


def _chunk(csr: Csr, r0: int, r1: int, device):
    """One row range's ratings on the device: (cols int64, vals float64,
    counts int64, segment matrix S [rows, ratings] of ones in CSR form)."""
    lo, hi = int(csr.ptr[r0]), int(csr.ptr[r1])
    cols = torch.from_numpy(csr.cols[lo:hi]).to(device=device, dtype=torch.int64)
    vals = torch.from_numpy(csr.vals[lo:hi]).to(device=device, dtype=torch.float64)
    crow = torch.from_numpy(csr.ptr[r0:r1 + 1] - lo).to(device)
    counts = crow.diff()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
        warnings.filterwarnings("ignore", message="Sparse invariant checks")
        seg = torch.sparse_csr_tensor(
            crow, torch.arange(hi - lo, device=device),
            torch.ones(hi - lo, dtype=torch.float64, device=device),
            size=(r1 - r0, hi - lo), check_invariants=False)
    return cols, vals, counts, seg


def row_backward_errors(csr: Csr, fixed: torch.Tensor, solved: torch.Tensor,
                        lam: float, chunk: int = JUDGE_CHUNK) -> torch.Tensor:
    """eta_u for every row of ``csr`` (float64, on ``solved``'s device):
    how far ``solved[u]`` is from solving row u's normal equations against
    ``fixed``.  An empty row must hold an exact zero (the program's guard)
    and reads 0, or infinity when it does not."""
    device = solved.device
    out = torch.empty(csr.rows, dtype=torch.float64, device=device)
    f = fixed.shape[1]
    for r0, r1 in _row_chunks(csr.ptr, chunk):
        cols, vals, counts, seg = _chunk(csr, r0, r1, device)
        th = fixed[cols].double()
        x = solved[r0:r1].double()
        rep = torch.repeat_interleave(torch.arange(r1 - r0, device=device), counts)
        e = (th * x[rep]).sum(1) - vals
        n_u = counts.double()[:, None]
        res = seg @ (e[:, None] * th) + lam * n_u * x
        b = seg @ (vals[:, None] * th)
        tr = seg @ (th * th).sum(1, keepdim=True) + lam * f * n_u
        eta = res.norm(dim=1) / (tr[:, 0] * x.norm(dim=1) + b.norm(dim=1))
        empty = counts == 0
        eta = torch.where(empty, torch.where((x == 0).all(1), 0.0, math.inf), eta)
        out[r0:r1] = eta
        del cols, vals, seg, th, x, rep, e, res, b, tr
    return out


def rmse(csr: Csr, x: torch.Tensor, theta: torch.Tensor,
         chunk: int = JUDGE_CHUNK) -> float:
    """RMSE of ``x theta^T`` over the ratings of ``csr``, in float64."""
    device = x.device
    sse = torch.zeros((), dtype=torch.float64, device=device)
    for r0, r1 in _row_chunks(csr.ptr, chunk):
        cols, vals, counts, _ = _chunk(csr, r0, r1, device)
        rep = torch.repeat_interleave(torch.arange(r0, r1, device=device), counts)
        e = (x[rep].double() * theta[cols].double()).sum(1) - vals
        sse += (e * e).sum()
    return math.sqrt(float(sse) / max(csr.nnz, 1))


def judge_als(r: Csr, rt: Csr, test: Csr, lam: float, start, last,
              reported: dict) -> dict:
    """The numbers that decide an ALS run's ``correct``.

    ``start`` = (Theta_0, X_1, Theta_1): the benchmark's initial Theta and
    the program's first iteration; ``last`` = (Theta_{k-1}, X_k, Theta_k):
    the program's last two iterations; ``reported``: the train and test
    RMSE the program reported for iteration k.  ``backward_error`` is the
    largest over every row of both sides of both checked iterations."""
    eta = 0.0
    for theta_prev, x, theta in (start, last):
        eta = max(eta, float(row_backward_errors(r, theta_prev, x, lam).max()),
                  float(row_backward_errors(rt, x, theta, lam).max()))
    _, x, theta = last
    out = {"backward_error": eta}
    for name, csr in (("train", r), ("test", test)):
        ref = rmse(csr, x, theta)
        out[f"{name}_rmse_gap"] = abs(float(reported[f"{name}_rmse"]) - ref) / ref
    return out


# ---------------------------------------------------------------------------
# The reference solver (the control's program)
# ---------------------------------------------------------------------------

def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, as the tensor cores round their operands: the control's
    precision on a device without TF32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision(mode: str):
    """``"fp32"``: TF32 off.  ``"tf32"``: the card's TF32 matmuls.
    ``"tf32_emulated"``: operands rounded by :func:`round_tf32` (the CPU
    has no TF32)."""
    if mode not in ("fp32", "tf32", "tf32_emulated"):
        raise ValueError(f"unknown precision {mode!r}")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _bmm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32_emulated":
        a, b = round_tf32(a), round_tf32(b)
    return torch.bmm(a, b)


def _groups(csr: Csr, f: int):
    """Rows by ascending degree, cut into groups of at most
    :data:`GROUP_ROWS` rows and :data:`GROUP_ELEMS` gathered floats:
    (row ids, padded K)."""
    deg = np.diff(csr.ptr)
    order = np.argsort(deg, kind="stable")
    d = np.maximum(deg[order], 1)
    lo = 0
    while lo < order.size:
        hi = min(lo + GROUP_ROWS, order.size)
        while hi > lo + 1 and (hi - lo) * int(d[hi - 1]) * f > GROUP_ELEMS:
            hi = lo + 1 + (hi - lo - 1) // 2
        yield order[lo:hi], int(d[hi - 1])
        lo = hi


class _DeviceCsr:
    """A CSR's arrays on the device, padded by groups of rows."""

    def __init__(self, csr: Csr, device):
        self.csr = csr
        self.ptr = torch.from_numpy(csr.ptr).to(device)
        self.cols = torch.from_numpy(csr.cols).to(device=device, dtype=torch.int64)
        self.vals = torch.from_numpy(csr.vals).to(device)

    def padded(self, rows: np.ndarray, K: int):
        device = self.ptr.device
        rows_d = torch.from_numpy(rows).to(device)
        start = self.ptr[rows_d]
        deg = self.ptr[rows_d + 1] - start
        k = torch.arange(K, device=device)
        live = k[None, :] < deg[:, None]
        pos = torch.where(live, start[:, None] + k[None, :], 0)
        cols = torch.where(live, self.cols[pos], 0)
        vals = torch.where(live, self.vals[pos], 0.0)
        return rows_d, deg, live, cols, vals


def solve_side(dcsr: _DeviceCsr, fixed: torch.Tensor, lam: float, mode: str) -> torch.Tensor:
    """Every row of one side, given the fixed other side: the Gram matrix
    of the row's gathered factors plus ``lam n_u I``, solved by Cholesky
    (an empty row gets I and so x = 0)."""
    f = fixed.shape[1]
    out = torch.zeros((dcsr.csr.rows, f), dtype=torch.float32, device=fixed.device)
    eye = torch.eye(f, dtype=torch.float32, device=fixed.device)
    with precision(mode):
        for rows, K in _groups(dcsr.csr, f):
            rows_d, deg, live, cols, vals = dcsr.padded(rows, K)
            g = fixed[cols] * live[..., None]
            gt = g.transpose(1, 2)
            A = _bmm(gt, g, mode)
            b = _bmm(gt, vals[..., None], mode)
            diag = torch.where(deg > 0, lam * deg.float(), 1.0)
            A = A + diag[:, None, None] * eye
            L, _ = torch.linalg.cholesky_ex(A)
            out[rows_d] = torch.cholesky_solve(b, L)[..., 0]
            del g, gt, A, b, L
    return out


def rmse_side(dcsr: _DeviceCsr, x: torch.Tensor, theta: torch.Tensor, mode: str) -> float:
    """The RMSE as the reference would report it: predictions by ``bmm``
    over padded groups, squared errors summed in float32 per group."""
    f = x.shape[1]
    sse = 0.0
    with precision(mode):
        for rows, K in _groups(dcsr.csr, f):
            rows_d, _, live, cols, vals = dcsr.padded(rows, K)
            g = theta[cols]
            pred = _bmm(g, x[rows_d][:, :, None], mode)[..., 0]
            e = (vals - pred) * live
            sse += float((e * e).sum())
    return math.sqrt(sse / max(dcsr.csr.nnz, 1))


def als_reference_run(r: Csr, rt: Csr, test: Csr, theta0: torch.Tensor, lam: float,
                      iters: int, mode: str):
    """``iters`` ALS iterations of the reference solver from ``theta0``.
    Returns (start, last, reported) in :func:`judge_als`'s form."""
    device = theta0.device
    dr, drt, dte = _DeviceCsr(r, device), _DeviceCsr(rt, device), _DeviceCsr(test, device)
    theta = theta0
    start = None
    for it in range(iters):
        prev = theta
        x = solve_side(dr, theta, lam, mode)
        theta = solve_side(drt, x, lam, mode)
        if it == 0:
            start = (prev, x, theta)
    reported = {"train_rmse": rmse_side(dr, x, theta, mode),
                "test_rmse": rmse_side(dte, x, theta, mode)}
    return start, (prev, x, theta), reported


# ---------------------------------------------------------------------------
# Blocked batch-Hogwild SGD (CuMF_SGD): the reference's own schedule and epoch
# ---------------------------------------------------------------------------

def cosine_lr(base: float, epoch: int, total: int, min_lr: float = 0.0) -> float:
    """The cosine-annealed learning rate of an epoch (float64)."""
    frac = min(max(epoch / max(total, 1), 0.0), 1.0)
    return min_lr + (base - min_lr) * 0.5 * (1.0 + math.cos(math.pi * frac))


def set_order(seed: int, epoch: int, g: int) -> list[int]:
    """CuMF_SGD's shuffled visit order of the g diagonal sets in an epoch,
    keyed on (seed, epoch): the traffic's schedule, worked out here from
    the seed as the program is documented to draw it."""
    key = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.randperm(g, generator=torch.Generator().manual_seed(key)).tolist()


class SgdSchedule:
    """The g x g blocking of R (train) in slot order: users in blocks of
    ceil(m/g), items in blocks of ceil(n/g); diagonal set s holds tiles
    (i, (i + s) % g); within a tile each user's ratings in ascending item
    order, slot k holding every user's k-th.  ``slots[s]`` lists set s's
    slots as (lo, hi) spans of ``u``, ``v``, ``r``."""

    def __init__(self, r: Csr, g: int, device):
        m, n = r.rows, r.n_cols
        self.g, self.m, self.n = g, m, n
        mb, nb = -(-m // g), -(-n // g)
        counts = torch.from_numpy(np.diff(r.ptr)).to(device)
        u = torch.repeat_interleave(torch.arange(m, device=device), counts)
        v = torch.from_numpy(r.cols).to(device=device, dtype=torch.int64)
        bj = v // nb
        s = (bj - u // mb) % g
        group = u * g + bj                     # ascending: CSR order is (user, item)
        new = torch.ones_like(group, dtype=torch.bool)
        new[1:] = group[1:] != group[:-1]
        starts = torch.nonzero(new).squeeze(1)
        pos = torch.arange(group.numel(), device=device) - starts[torch.cumsum(new, 0) - 1]
        K = int(pos.max()) + 1 if pos.numel() else 1
        key = s * K + pos
        order = torch.argsort(key, stable=True)
        self.u, self.v = u[order], v[order]
        self.r = torch.from_numpy(r.vals).to(device)[order]
        ends = torch.cumsum(torch.bincount(key, minlength=g * K), 0).cpu().numpy()
        begins = np.concatenate([[0], ends[:-1]])
        self.slots = [[(int(begins[q * K + k]), int(ends[q * K + k])) for k in range(K)
                       if ends[q * K + k] > begins[q * K + k]] for q in range(g)]


def _dot(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Row-wise dot products: elementwise in float64 or float32, or as a
    batched matmul in TF32 (``"tf32"``, ``"tf32_emulated"``)."""
    if mode in ("fp64", "fp32"):
        return (a * b).sum(1)
    with precision(mode):
        return _bmm(a[:, None, :], b[:, :, None], mode)[:, 0, 0]


def sgd_epoch(sched: SgdSchedule, x: torch.Tensor, theta: torch.Tensor, lr: float,
              lam: float, order: list[int], mode: str):
    """One epoch of blocked batch-Hogwild SGD from (x, theta), in the dtype
    they come in.  Within a slot every row updates against the pre-slot
    factors; an item hit by several rows takes the mean of their
    gradients:  e = r - x.theta;  x += lr (e theta - lam x);
    theta += lr (mean(e x) - lam theta).  Returns fresh tensors."""
    x, theta = x.clone(), theta.clone()
    ones = torch.ones(1, dtype=x.dtype, device=x.device)
    for s in order:
        for lo, hi in sched.slots[s]:
            u, v = sched.u[lo:hi], sched.v[lo:hi]
            xu, tv = x[u], theta[v]
            e = sched.r[lo:hi].to(x.dtype) - _dot(xu, tv, mode)
            x[u] = xu + lr * (e[:, None] * tv - lam * xu)
            num = torch.zeros_like(theta).index_add_(0, v, e[:, None] * xu)
            hits = torch.zeros(theta.shape[0], dtype=x.dtype, device=x.device).index_add_(
                0, v, ones.expand(hi - lo))
            hit = hits > 0
            theta[hit] += lr * (num[hit] / hits[hit, None] - lam * theta[hit])
    return x, theta


def _row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest row distance, over the row's norm plus the median row
    norm (a row near zero reads against the typical row)."""
    norms = want.norm(dim=1)
    return float(((got - want).norm(dim=1) / (norms + norms.median())).max())


def judge_sgd(sched: SgdSchedule, test: Csr, lam: float, epochs: list, reported: dict) -> dict:
    """The numbers that decide an SGD run's ``correct``.  ``epochs`` holds
    (x_before, theta_before, x_after, theta_after, lr, order) of each
    checked epoch, each factor unpadded [m, f] / [n, f]; the float64
    reference epoch runs from each ``before`` and the program's ``after``
    is judged row by row against it.  ``reported``: the test RMSE of the
    last epoch."""
    gx = gt = 0.0
    for x0, t0, x1, t1, lr, order in epochs:
        xr, tr = sgd_epoch(sched, x0.double(), t0.double(), lr, lam, order, "fp64")
        gx = max(gx, _row_gap(x1.double(), xr))
        gt = max(gt, _row_gap(t1.double(), tr))
        del xr, tr
    _, _, x, theta, _, _ = epochs[-1]
    ref = rmse(test, x, theta)
    return {"x_epoch_gap": gx, "theta_epoch_gap": gt,
            "test_rmse_gap": abs(float(reported["test_rmse"]) - ref) / ref}


def sgd_reference_run(r: Csr, test: Csr, x0: torch.Tensor, theta0: torch.Tensor, lam: float,
                      traffic: dict, seed: int, epochs: int, mode: str):
    """``epochs`` epochs of the reference SGD from (x0, theta0) in the
    program's place.  Returns (checked epochs, reported) in
    :func:`judge_sgd`'s form: the first and the last epoch."""
    g = int(traffic["g"])
    sched = SgdSchedule(r, g, x0.device)
    x, theta, checked = x0, theta0, []
    for ep in range(epochs):
        lr = cosine_lr(float(traffic["lr"]), ep, int(traffic["epochs"]))
        order = set_order(seed, ep, g)
        x1, t1 = sgd_epoch(sched, x, theta, lr, lam, order, mode)
        if ep in (0, epochs - 1):
            checked.append((x, theta, x1, t1, lr, order))
        x, theta = x1, t1
    return checked, {"test_rmse": rmse(test, x, theta)}
