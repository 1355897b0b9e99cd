"""LM-substrate microbenches (framework overhead visibility): one smoke
train step and one decode step per block family (the port of
``benchmarks/bench_lm_substrate.py``), on the card unless ``device="cpu"``."""
from __future__ import annotations

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import OptConfig

from benchmarks_torch.common import emit, time_fn

ARCHS = ("phi3-mini-3.8b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b")


def run(device="cuda"):
    dev = resolve_device(device)
    for arch in ARCHS:
        cfg = registry.smoke_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        state = lm.init_train_state(cfg, gen, OptConfig())
        step = lm.make_train_step(cfg, OptConfig(), remat=False)
        B, S = 4, 32
        # the reference draws tokens and labels from one key: the same ids
        ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": ids, "labels": ids.clone(),
                 "mask": torch.ones((B, S), dtype=torch.float32, device=dev)}
        if cfg.frontend:
            batch["embeds"] = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
            del batch["tokens"]
        us = time_fn(step, state, batch, iters=3)
        emit(f"lm_train_step_{arch}", us, f"B={B};S={S};smoke")

        params = T.init_params(cfg, gen)
        cache = T.init_cache(cfg, B, 64, torch.float32, device=dev)
        dec = lm.make_decode_step(cfg)
        tok = torch.zeros((B,), dtype=torch.int32, device=dev) if not cfg.frontend \
            else torch.zeros((B, cfg.d_model), dtype=torch.float32, device=dev)
        lens = torch.full((B,), 5, dtype=torch.int32, device=dev)
        us = time_fn(dec, params, cache, tok, lens, iters=3)
        emit(f"lm_decode_step_{arch}", us, f"B={B};smoke")


if __name__ == "__main__":
    run()
