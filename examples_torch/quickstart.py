"""Quickstart: factorize a synthetic Netflix-like rating matrix with ALS on
the card (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples_torch/quickstart.py                 # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu    # plain PyTorch

Prints test RMSE per iteration (paper Fig. 6 protocol).  The gate is
tests/test_convergence.py's: the last test RMSE below half the first and
within 5 % of the best.  With the planted noise sigma=0.1 the oracle floor
is ~0.1; 8 iterations end near 0.34.
"""
import argparse

from repro_torch.backend import resolve_device
from repro_torch.core import als as als_mod
from repro_torch.sparse import synth


def converged(rmses) -> bool:
    """tests/test_convergence.py's relative criteria."""
    return rmses[-1] < 0.5 * rmses[0] and rmses[-1] <= min(rmses) * 1.05


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device the run uses (default: the card); "
                         "'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)            # raises without a GPU

    spec = synth.SynthSpec("netflix-quickstart", m=2048, n=512,
                           nnz=150_000, f=16, lam=0.05)
    print(f"synthesizing {spec.nnz} ratings ({spec.m}x{spec.n}, f={spec.f})")
    r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=0, noise=0.1)
    print(f"padded-ELL: K={r.K}, fill={r.fill:.2f}x")

    cfg = als_mod.AlsConfig(f=spec.f, lam=spec.lam, iters=8, device=str(dev))
    print(f"device {dev}, mode {cfg.mode}")
    _, hist = als_mod.als_train(
        als_mod.ell_triplet(r, dev), als_mod.ell_triplet(rt, dev), r.m, rt.m,
        cfg, test=als_mod.ell_triplet(rte, dev),
        callback=lambda st, rec: print(
            f"iter {rec['iteration']:2d}  train_rmse={rec['train_rmse']:.4f}"
            f"  test_rmse={rec['test_rmse']:.4f}", flush=True))
    rmses = [h["test_rmse"] for h in hist]
    if not converged(rmses):
        raise SystemExit(f"did not converge: test RMSE {rmses}")
    print("converged.")
    return hist


if __name__ == "__main__":
    main()
