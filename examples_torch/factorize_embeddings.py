"""Apply the paper's technique to an LM: ALS-factorize an embedding table,
on the card (the port of ``examples/factorize_embeddings.py``).

The vocab x d_model embedding of an LM is the one large matrix the cuMF
solver applies to directly: factor E ~ X . Theta^T with rank f << d,
giving a (vocab x f + f x d) compressed embedding.  Dense factorization is
the K = d special case of the padded-ELL path: R's rows have K = d and
R^T's rows K = vocab (the Hermitian kernel splits such rows over blocks).

    PYTHONPATH=src python examples_torch/factorize_embeddings.py --arch recurrentgemma-2b
    PYTHONPATH=src python examples_torch/factorize_embeddings.py --device cpu

The reference runs its plain path (``mode="ref"``); here the run takes
the port's default mode, so on the card the CUDA ``fused_herm`` and
``batch_solve`` kernels run, and the script prints their launch counts at
exit.  ``--device cpu`` runs the plain PyTorch versions.
"""
import argparse
import json

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import registry
from repro_torch.core import als as als_mod
from repro_torch.models import transformer as T
from repro_torch.obs import kernel_launches

#: the weighted-lambda regularization (the reference's, fixed)
LAM = 1e-3
#: the kernels this example's path runs
KERNELS = ("fused_herm", "batch_solve")


def launch_counts() -> dict:
    counts = kernel_launches()
    return {name: counts.get(name, 0) for name in KERNELS}


def dense_ell(emb: torch.Tensor):
    """A dense [V, d] matrix as padded-ELL triplets of R and R^T on its
    device: every row rates every column."""
    V, d = emb.shape
    dev = emb.device
    r = (torch.arange(d, dtype=torch.int32, device=dev).expand(V, d).contiguous(),
         emb.contiguous(), torch.full((V,), d, dtype=torch.int32, device=dev))
    rt = (torch.arange(V, dtype=torch.int32, device=dev).expand(d, V).contiguous(),
          emb.T.contiguous(), torch.full((d,), V, dtype=torch.int32, device=dev))
    return r, rt


def factorize(emb, rank: int, iters: int, device=None, *, init=None):
    """ALS-factorize ``emb`` at rank ``rank`` for ``iters`` iterations on
    ``device``, printing the reconstruction RMSE after each; ``init`` (x,
    theta as numpy) replaces the seeded initial factors.  Returns the
    states (the initial one, then one after each iteration) and the RMSEs."""
    dev = resolve_device(device)
    emb = torch.as_tensor(emb).to(dev, torch.float32)
    V, d = emb.shape
    cfg = als_mod.AlsConfig(f=rank, lam=LAM, iters=1, device=str(dev))
    st = (als_mod.als_init(V, d, cfg) if init is None
          else als_mod.state_from_numpy(init[0], init[1], device=dev))
    states = [st]
    r, rt = dense_ell(emb)
    base = float(torch.sqrt(torch.mean(torch.square(emb))))
    rmses = []
    for it in range(iters):
        st = als_mod.als_iteration(st, r, rt, cfg)
        states.append(st)
        recon = st.x @ st.theta.T
        err = float(torch.sqrt(torch.mean(torch.square(recon - emb))))
        rmses.append(err)
        print(f"iter {it+1}: recon RMSE={err:.5f} (rms(E)={base:.5f}, "
              f"relative {err/base:.2%})", flush=True)
    return states, rmses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    choices=registry.list_archs())
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device the run uses (default: the card); "
                         "'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)            # raises without a GPU

    cfg = registry.smoke_config(args.arch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    emb = params["embed"]                               # [V, d]
    V, d = emb.shape
    print(f"{args.arch}: embedding {V}x{d}, rank {args.rank} "
          f"-> {(V*args.rank + args.rank*d) / (V*d):.1%} of original size")
    before = launch_counts()
    _, rmses = factorize(emb, args.rank, args.iters, dev)
    print("factorized embedding ready: E ~ X @ Theta^T")
    after = launch_counts()
    print("kernel launches: " + json.dumps({k: after[k] - before[k] for k in KERNELS}))
    return rmses


if __name__ == "__main__":
    main()
