"""Plain PyTorch versions of the port's kernels (the reference's
``kernels/ref.py``).

These define correctness: the CPU tests compare them with the JAX
package, and ``chip_smoke.py`` compares each CUDA kernel with them on the
card.  They are also what the kernel wrappers run for tensors on the CPU.
Library calls (``einsum``, ``torch.linalg``, ``index_add_``) are allowed
here and only here.
"""
from __future__ import annotations

import torch


def mask_from_cnt(cnt: torch.Tensor, K: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[m] counts -> [m, K] 0/1 validity mask."""
    k = torch.arange(K, dtype=torch.int32, device=cnt.device)
    return (k[None, :] < cnt[:, None]).to(dtype)


def herm_ref(
    g: torch.Tensor,      # [m, K, F] gathered theta rows (garbage in padding slots)
    val: torch.Tensor,    # [m, K]    rating values (0 in padding)
    mask: torch.Tensor,   # [m, K]    1.0 where slot is a real nonzero
    diag: torch.Tensor,   # [m]       weighted-lambda diagonal
) -> tuple[torch.Tensor, torch.Tensor]:
    """A_u = sum_k mask[u,k] g[u,k] g[u,k]^T + diag[u] I;
    B_u = sum_k val[u,k] mask[u,k] g[u,k]."""
    F = g.shape[-1]
    gm = g * mask[..., None]
    A = torch.einsum("ukf,ukg->ufg", gm, g)
    A = A + diag[:, None, None] * torch.eye(F, dtype=A.dtype,
                                            device=A.device)[None, :, :]
    B = torch.einsum("uk,ukf->uf", val * mask, g)
    return A, B


def batch_solve_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve x_u = A_u^{-1} B_u via Cholesky."""
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(B[..., None], L)[..., 0]


def fused_herm_chunked_plain(theta, idx, val, cnt, diag, chunk: int):
    """:func:`herm_ref` in the order of work of the split Hermitian kernel:
    a partial (no diagonal) per ``chunk`` slots, the partials summed in
    chunk order from zero, then the diagonal.  For tests and
    ``chip_smoke.py`` only."""
    m, K = idx.shape
    f = theta.shape[1]
    mask = mask_from_cnt(cnt, K, theta.dtype)
    zero = torch.zeros(m, dtype=theta.dtype, device=theta.device)
    A = torch.zeros((m, f, f), dtype=theta.dtype, device=theta.device)
    B = torch.zeros((m, f), dtype=theta.dtype, device=theta.device)
    for k0 in range(0, K, chunk):
        part = slice(k0, k0 + chunk)
        dA, dB = herm_ref(theta[idx[:, part].long()], val[:, part], mask[:, part], zero)
        A, B = A + dA, B + dB
    return A + diag[:, None, None] * torch.eye(f, dtype=A.dtype, device=A.device), B


def batch_solve_blocked_plain(A: torch.Tensor, B: torch.Tensor, nb: int) -> torch.Tensor:
    """x_u = A_u^{-1} B_u in the order of work of the blocked solve kernel:
    right-looking Cholesky over blocks of ``nb`` columns of
    W = [A_u ; B_u^T], so the forward substitution is W's last row, then a
    blocked back substitution.  The clamps sit where the reference's are:
    ``max(pivot, 1e-20)`` before ``rsqrt`` and ``max(L_jj, 1e-20)`` as
    both substitutions' divisors.  For tests and ``chip_smoke.py`` only."""
    m, f, _ = A.shape
    W = torch.zeros((m, f + 1, f + 1), dtype=A.dtype, device=A.device)
    W[:, :f, :f] = A
    W[:, f, :f] = B
    for j0 in range(0, f, nb):
        j1 = min(j0 + nb, f)
        for c in range(j0, j1):           # the diagonal block and the panel below it
            r = torch.rsqrt(torch.clamp(W[:, c, c], min=1e-20))
            W[:, c:f, c] = W[:, c:f, c] * r[:, None]
            W[:, f, c] = W[:, f, c] / torch.clamp(W[:, c, c], min=1e-20)
            W[:, c + 1:, c + 1:j1] -= W[:, c + 1:, c, None] * W[:, None, c + 1:j1, c]
        W[:, j1:, j1:f] -= W[:, j1:, j0:j1] @ W[:, j1:f, j0:j1].transpose(1, 2)
    z = W[:, f, :f].clone()
    x = torch.zeros_like(B)
    for J0 in reversed(range(0, f, nb)):
        J1 = min(J0 + nb, f)
        for c in reversed(range(J0, J1)):
            x[:, c] = z[:, c] / torch.clamp(W[:, c, c], min=1e-20)
            z[:, J0:c] -= W[:, c, J0:c] * x[:, c, None]
        z[:, :J0] -= torch.einsum("uck,uc->uk", W[:, J0:J1, :J0], x[:, J0:J1])
    return x


def fused_herm_gathered_ref(theta, idx, val, cnt, lam):
    """Gather + Hermitian in one call, with the empty-row fallback (what
    ``ops.fused_herm`` computes)."""
    g = theta[idx.long()]
    mask = mask_from_cnt(cnt, idx.shape[1], theta.dtype)
    diag = torch.where(cnt > 0, lam * cnt.to(torch.float32),
                       torch.ones((), dtype=torch.float32, device=cnt.device))
    return herm_ref(g, val, mask, diag)


def sgd_block_ref(
    x: torch.Tensor,      # [mb, f]  user factors of this user block
    theta: torch.Tensor,  # [nb, f]  item factors of this item block
    idx: torch.Tensor,    # [mb, K]  block-local item index per slot (0 in padding)
    val: torch.Tensor,    # [mb, K]  rating (0 in padding)
    cnt: torch.Tensor,    # [mb]     true nnz per user row
    lr: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-Hogwild sweep of one tile (CuMF_SGD): the K slots in order;
    within a slot every active row (``cnt > k``) updates against the
    pre-slot factors, and item collisions take the *mean* of the colliding
    gradients::

        e      = r_uv - <x_u, theta_v>
        x_u   += lr * (e * theta_v - lam * x_u)
        th_v  += lr * (mean_{u in slot hits v} e * x_u - lam * theta_v)

    Inactive slots leave x and theta unchanged (their update is ``+ 0``).
    """
    K = idx.shape[1]
    nb = theta.shape[0]
    mask = mask_from_cnt(cnt, K, x.dtype)
    for k in range(K):
        iv = idx[:, k].long()
        msk = mask[:, k]
        tv = theta[iv]                                  # [mb, f]
        e = (val[:, k] - torch.sum(x * tv, dim=-1)) * msk
        dx = msk[:, None] * (e[:, None] * tv - lam * x)
        num = torch.zeros_like(theta).index_add_(0, iv, msk[:, None] * (e[:, None] * x))
        hits = torch.zeros(nb, dtype=x.dtype, device=x.device).index_add_(0, iv, msk)
        dt = num / torch.clamp(hits, min=1.0)[:, None] \
            - lam * theta * (hits > 0).to(x.dtype)[:, None]
        x, theta = x + lr * dx, theta + lr * dt
    return x, theta


def sgd_tile_planned_plain(x, theta, plan, lr: float, lam: float):
    """:func:`sgd_block_ref` in the order of work of the planned SGD
    kernel, from a ``sgd_update.SlotPlan``: per slot, each unit's rows in
    order with the unit's fp32 sum of ``e * x_u`` taken in row order; a
    whole group then updates its item, a part leaves its sum in scratch;
    then each split group adds its parts' sums in part order and updates
    its item.  Returns fresh tensors.  For tests, ``chip_smoke.py`` and
    the CPU side of ``sgd_update.sgd_tile_planned_``."""
    x, theta = x.clone(), theta.clone()
    f = x.shape[1]
    scratch = torch.zeros((plan.n_scratch, f), dtype=x.dtype, device=x.device)
    uo, so = plan.unit_offs.tolist(), plan.split_offs.tolist()

    def step(t, total, h):
        return t + lr * (total / h.to(t.dtype)[:, None] - lam * t)

    for s in range(plan.n_slots):
        item, start, ln, scr = plan.units[uo[s]:uo[s + 1]].long().unbind(1)
        tv = theta[item]                                 # the slot's theta, before it
        acc = torch.zeros((item.numel(), f), dtype=x.dtype, device=x.device)
        for q in range(int(ln.max())):
            on = ln > q
            ent = start[on] + q
            rows = plan.rows[ent].long()
            xv, t = x[rows], tv[on]
            e = plan.vals[ent] - torch.sum(xv * t, dim=-1)
            acc[on] = acc[on] + e[:, None] * xv
            x[rows] = xv + lr * (e[:, None] * t - lam * xv)
        whole = scr < 0
        theta[item[whole]] = step(tv[whole], acc[whole], ln[whole])
        scratch[scr[~whole]] = acc[~whole]
        item, first, parts, h = plan.splits[so[s]:so[s + 1]].long().unbind(1)
        if item.numel():
            total = torch.zeros((item.numel(), f), dtype=x.dtype, device=x.device)
            for q in range(int(parts.max())):
                on = parts > q
                total[on] = total[on] + scratch[first[on] + q]
            theta[item] = step(theta[item], total, h)
    return x, theta
