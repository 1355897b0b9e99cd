"""Serve a small model with batched requests through the continuous-
batching engine (slot admission, ragged lengths, KV cache reuse), on the
card (the port of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples_torch/serve_lm.py --arch phi3-mini-3.8b
    PYTHONPATH=src python examples_torch/serve_lm.py --arch olmoe-1b-7b
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

The model is the architecture's smoke config with random weights drawn
from seed 0; the engine runs in bf16.  Every token architecture serves:
dense attention, MoE (olmoe, moonshot), RG-LRU with local attention
(recurrentgemma) and RWKV6; the stub-frontend architectures (musicgen,
internvl2) take embeddings, not tokens.  ``--device cpu`` runs the plain
PyTorch path.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServeEngine


def make_requests(cfg, n: int, new_tokens: int, seed: int = 0) -> list:
    """The example's traffic: ``n`` prompts of 3-8 random tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(3, 9))
        reqs.append(Request(rid=i, prompt=prompt.astype(np.int32),
                            max_new_tokens=new_tokens))
    return reqs


def serve(eng: ServeEngine, reqs: list) -> tuple[int, float]:
    """Submit ``reqs``, step the engine until it is idle, print what each
    request generated; returns (engine steps, seconds)."""
    for req in reqs:
        eng.submit(req)
        print(f"req {req.rid}: prompt={req.prompt.tolist()}")
    t0 = time.perf_counter()
    steps = 0
    while eng.step():            # each step ends on a host read of its tokens
        steps += 1
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: generated={r.out}")
    print(f"{total} tokens in {dt:.2f}s over {steps} engine steps "
          f"({total / dt:.1f} tok/s, {eng.n_slots} slots)")
    return steps, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=registry.list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device the run uses (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)            # raises without a GPU

    cfg = registry.smoke_config(args.arch)
    if cfg.frontend:
        raise SystemExit("stub-frontend archs serve embeddings; pick a "
                         "token arch for this demo")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, n_slots=args.slots, max_seq=96, device=dev)
    print(f"{cfg.name} on {dev}")
    reqs = make_requests(cfg, args.requests, args.new_tokens)
    serve(eng, reqs)
    return reqs


if __name__ == "__main__":
    main()
