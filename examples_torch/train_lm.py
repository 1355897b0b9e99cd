"""Train a small LM on the synthetic n-gram stream with the full substrate:
any of the 10 archs (reduced config), AdamW, grad accumulation,
checkpoint/restart, on the card (the port of ``examples/train_lm.py``).

    PYTHONPATH=src python examples_torch/train_lm.py --arch qwen3-4b --steps 60
    PYTHONPATH=src python examples_torch/train_lm.py --arch rwkv6-7b --steps 40
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 10

Loss drops well below the unigram entropy once the linear n-gram rule is
learned.  ``--width`` scales the model up (e.g. --width 512 --layers 8
gives a ~110M-param model for a longer run).  ``--device cpu`` runs on the
CPU.

As the reference does, a resumed run starts the stream at its first batch
again, and a stub-frontend arch (musicgen, internvl2) trains on random
``embeds`` drawn each step (here from a ``torch.Generator`` seeded by the
step, so not the reference's draws).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.backend import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models import lm as lm_mod
from repro_torch.training.optimizer import OptConfig

EMBEDS_SEED = 9_000_000      # + the step index: the stub frontends' draws


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=registry.list_archs())
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="constant",
                    choices=("constant", "inverse_time", "cosine"),
                    help="lr schedule over --steps (training/optimizer)")
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run uses (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)            # raises without a GPU

    cfg = registry.smoke_config(args.arch)
    if args.width:
        cfg = dataclasses.replace(
            cfg, d_model=args.width, d_ff=args.width * 3,
            d_head=args.width // max(cfg.n_heads, 1),
            d_rnn=args.width if cfg.d_rnn else None)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    n_params = cfg.params_count()
    print(f"arch={args.arch} params={n_params/1e6:.1f}M vocab={cfg.vocab} device={dev}")

    opt = OptConfig(lr=args.lr, schedule=args.schedule,
                    schedule_steps=args.steps)
    state = lm_mod.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), opt)
    step = lm_mod.make_train_step(cfg, opt, microbatch=args.microbatch, remat=False)

    start = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, keep=2)
        restored, start = mgr.restore_or_init(state, lambda: state)
        if start:
            state = restored
            print(f"resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    with Prefetcher(synthetic_lm_batches(cfg.vocab, args.seq, args.batch, seed=0),
                    depth=2, device=dev) as stream:
        for i, batch in zip(range(start, args.steps), stream):
            if cfg.frontend:   # stub-frontend archs consume embeddings
                gen = torch.Generator(device=dev).manual_seed(EMBEDS_SEED + i)
                batch = dict(batch)
                batch["embeds"] = torch.randn((args.batch, args.seq, cfg.d_model),
                                              generator=gen, device=dev)
                batch.pop("tokens")
            state, m = step(state, batch)
            losses.append(m["loss"])
            if (i + 1) % 10 == 0 or i == start:
                print(f"step {i+1:4d}  loss={float(m['loss']):.4f}  "
                      f"gnorm={float(m['grad_norm']):.2f}  "
                      f"({(time.perf_counter()-t0)/(i-start+1):.2f}s/step)", flush=True)
            if mgr and (i + 1) % 25 == 0:
                mgr.save(i + 1, state)
    if mgr:
        mgr.wait()
    print("done.")
    return {"start": start, "losses": [float(x) for x in losses], "state": state}


if __name__ == "__main__":
    main()
