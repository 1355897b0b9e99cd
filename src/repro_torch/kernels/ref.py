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
