#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:

1. device: print the card's name and power limit; fp32 matmuls without TF32;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (in parallel);
3. each kernel against its plain PyTorch version at f in {8, 100, 128},
   with ragged and empty rows and ``diag_fallback`` on and off;
4. netflix-mini (tests/test_convergence.py's problem, seed 2): two ALS
   iterations in kernel mode and in plain mode from one injected state;
5. quickstart size (examples/quickstart.py's problem), 8 iterations in
   kernel mode, judged by tests/test_convergence.py's relative criteria;
6. the main path: ``als_train_binned`` on quarter-Netflix at full width
   (m=120047, n=17770, nnz=24.75M, f=100, lambda=0.05, 8 degree bins),
   3 iterations, with each kernel's launch count read around the run;
7. each kernel timed at the main path's shapes (every bin of both sides
   of one iteration) against its plain version and a library call.

The second-to-last line of output is a JSON ``kernels`` record; the last
line is ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

HERM_ATOL, HERM_RTOL = 2e-4, 1e-4      # tests/test_kernels.py:44
SOLVE_TOL = 5e-4                       # tests/test_kernels.py:77
TRAJ_TOL = 3e-3                        # tests/test_convergence.py:80
PLAIN_CHUNK_ELEMS = 1 << 28            # gathered floats per plain-version chunk


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card: one warm-up call, then
    ``reps`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch.core import als
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.batch_solve import batch_solve_cuda, batch_solve_plain
    from repro_torch.kernels.hermitian import fused_herm_cuda, fused_herm_plain
    from repro_torch.sparse import synth

    dev = torch.device("cuda")

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    check(torch.cuda.device_count() >= 1, "no CUDA device counted")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {list(built)} compiled in {time.perf_counter() - t0:.1f} s")
    for name in build.KERNELS:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernel vs plain, small shapes ----------------------------------------
    gen = torch.Generator().manual_seed(0)
    for f in (8, 100, 128):
        n, m, K = 700, 257, 3000
        theta = torch.randn(n, f, generator=gen).to(dev)
        idx = torch.randint(0, n, (m, K), generator=gen, dtype=torch.int32).to(dev)
        cnt = torch.randint(0, K + 1, (m,), generator=gen, dtype=torch.int32)
        cnt[torch.rand(m, generator=gen) < 0.2] = 0
        cnt = cnt.to(dev)
        val = torch.randn(m, K, generator=gen).to(dev) * kref.mask_from_cnt(cnt, K)
        for fallback in (True, False):
            A1, B1 = ops.fused_herm(theta, idx, val, cnt, 0.05, mode="kernel",
                                    diag_fallback=fallback)
            A0, B0 = ops.fused_herm(theta, idx, val, cnt, 0.05, mode="ref",
                                    diag_fallback=fallback)
            ea, eb = (A1 - A0).abs().max().item(), (B1 - B0).abs().max().item()
            log(f"herm f={f} diag_fallback={fallback}: max|dA|={ea:.3g} max|dB|={eb:.3g}")
            check(torch.allclose(A1, A0, atol=HERM_ATOL, rtol=HERM_RTOL)
                  and torch.allclose(B1, B0, atol=HERM_ATOL, rtol=HERM_RTOL),
                  f"fused_herm disagrees with its plain version at f={f}")
        # SPD systems as ALS makes them (the fallback puts I on empty rows)
        A, B = ops.fused_herm(theta, idx, val, cnt, 0.05, mode="kernel")
        x1 = ops.batch_solve(A, B, mode="kernel")
        x0 = ops.batch_solve(A, B, mode="ref")
        resid = (torch.einsum("uij,uj->ui", A, x1) - B).abs().max().item()
        scale = B.abs().max().item()
        log(f"solve f={f}: max|dx|={(x1 - x0).abs().max().item():.3g} "
            f"max residual {resid:.3g} (max|B| {scale:.3g})")
        check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL),
              f"batch_solve disagrees with its plain version at f={f}")
        check(resid <= 1e-4 * max(scale, 1.0), f"batch_solve residual {resid} at f={f}")
        diag = torch.where(cnt > 0, 0.05 * cnt.float(), torch.ones(m, device=dev))
        g = theta[idx.long()]
        gm = g * kref.mask_from_cnt(cnt, K)[..., None]
        log(f"  f={f} ms: herm kernel "
            f"{cuda_ms(torch, lambda: fused_herm_cuda(theta, idx, val, cnt, diag)):.3f}"
            f" plain {cuda_ms(torch, lambda: fused_herm_plain(theta, idx, val, cnt, diag)):.3f}"
            f" bmm {cuda_ms(torch, lambda: torch.bmm(gm.transpose(1, 2), g)):.3f}"
            f" | solve kernel {cuda_ms(torch, lambda: batch_solve_cuda(A, B)):.3f}"
            f" plain {cuda_ms(torch, lambda: batch_solve_plain(A, B)):.3f}"
            f" cholesky_ex+cholesky_solve {cuda_ms(torch, lambda: torch.cholesky_solve(B[..., None], torch.linalg.cholesky_ex(A)[0])):.3f}")
        del g, gm

    def reset_counts():
        fused_herm_cuda.launches = 0
        batch_solve_cuda.launches = 0

    def read_counts(phase: str) -> dict:
        counts = {"fused_herm": fused_herm_cuda.launches,
                  "batch_solve": batch_solve_cuda.launches}
        log(f"{phase} launches: {counts}")
        for name, c in counts.items():
            check(c > 0, f"{phase}: kernel {name} was never launched")
        return counts

    def triplet(ell):
        return als.ell_triplet(ell, dev)

    # -- 4. netflix-mini trajectory, kernel vs plain -------------------------------
    spec = synth.SynthSpec("netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)
    r, rt, _, _ = synth.make_synthetic_ratings(spec, seed=2, noise=0.1)
    rng = np.random.default_rng(2)
    x_init = rng.uniform(0.0, 0.3, (r.m, spec.f))
    t_init = rng.uniform(0.0, 0.3, (rt.m, spec.f))
    states = {}
    for mode in ("ref", "kernel"):
        cfg = als.AlsConfig(f=spec.f, lam=spec.lam, mode=mode)
        st = als.state_from_numpy(x_init, t_init, device=dev)
        reset_counts()
        for _ in range(2):
            st = als.als_iteration(st, triplet(r), triplet(rt), cfg)
        torch.cuda.synchronize()
        if mode == "kernel":
            read_counts("netflix-mini")
        states[mode] = st
    dx = (states["kernel"].x - states["ref"].x).abs().max().item()
    dt = (states["kernel"].theta - states["ref"].theta).abs().max().item()
    log(f"netflix-mini 2 iterations kernel vs plain: max|dx|={dx:.3g} max|dtheta|={dt:.3g}")
    check(torch.allclose(states["kernel"].x, states["ref"].x, atol=TRAJ_TOL, rtol=TRAJ_TOL)
          and torch.allclose(states["kernel"].theta, states["ref"].theta,
                             atol=TRAJ_TOL, rtol=TRAJ_TOL),
          "netflix-mini trajectory: kernel and plain modes disagree")

    # -- 5. quickstart size ---------------------------------------------------------
    spec = synth.SynthSpec("netflix-quickstart", m=2048, n=512, nnz=150_000,
                           f=16, lam=0.05)
    r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=0, noise=0.1)
    reset_counts()
    _, hist = als.als_train(triplet(r), triplet(rt), r.m, rt.m,
                            als.AlsConfig(f=spec.f, lam=spec.lam, iters=8),
                            test=triplet(rte))
    read_counts("quickstart")
    rmses = [h["test_rmse"] for h in hist]
    log("quickstart test RMSE: " + " ".join(f"{v:.4f}" for v in rmses))
    check(rmses[-1] < 0.5 * rmses[0], f"quickstart did not halve its test RMSE: {rmses}")
    check(rmses[-1] <= min(rmses) * 1.05, f"quickstart last RMSE not within 5% of best: {rmses}")

    # -- 6. main path: quarter-Netflix, binned, full width ----------------------------
    spec = synth.SynthSpec("netflix/4", m=120_047, n=17_770, nnz=24_750_000,
                           f=100, lam=0.05)
    t0 = time.perf_counter()
    rb, rtb, rte, _ = synth.make_synthetic_ratings_binned(spec, n_bins=8, seed=0)
    log(f"quarter-Netflix host build: {time.perf_counter() - t0:.1f} s; "
        f"train nnz {rb.nnz}, test nnz {rte.nnz}")
    for side, b in (("R (users)", rb), ("R^T (items)", rtb)):
        log(f"  {side}: K {list(b.K_list)} rows {[x.m for x in b.bins]} fill {b.fill:.3f}")
    cfg = als.AlsConfig(f=spec.f, lam=spec.lam, iters=3, seed=0)
    check(cfg.mode == "kernel", f"default mode on the card is {cfg.mode}")
    test = triplet(rte)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)]
    walls = [time.perf_counter()]

    def on_iteration(state, rec):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter())

    reset_counts()
    marks[0].record()
    state, hist = als.als_train_binned(rb, rtb, cfg, test=test, callback=on_iteration)
    torch.cuda.synchronize()
    counts = read_counts("quarter-Netflix")
    peak = torch.cuda.max_memory_allocated()
    iter_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(cfg.iters)]
    # the in-loop evaluation, on bins already on the card as in the loop
    r_bins = als._device_bins(rb, dev)
    eval_ms = cuda_ms(torch, lambda: (als._rmse_bins(state.x, state.theta, r_bins),
                                      float(als.rmse_padded(state.x, state.theta, *test))))
    del r_bins
    for h, ms, w0, w1 in zip(hist, iter_ms, walls, walls[1:]):
        log(f"  iteration {h['iteration']}: {ms:.1f} ms on the card "
            f"({w1 - w0:.3f} s wall) train RMSE {h['train_rmse']:.4f} "
            f"test RMSE {h['test_rmse']:.4f}")
    log(f"  (each iteration includes its RMSE evaluation, {eval_ms:.1f} ms on the card; "
        f"the first also uploads the bins)")
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({peak} B)")
    train = [h["train_rmse"] for h in hist]
    check(all(np.isfinite(v) for h in hist for v in h.values()), f"non-finite RMSE: {hist}")
    check(bool(torch.isfinite(state.x).all()) and bool(torch.isfinite(state.theta).all()),
          "non-finite factors")
    check(all(b < a for a, b in zip(train, train[1:])), f"train RMSE did not fall: {train}")

    # -- 7. kernels at the main path's shapes -------------------------------------------
    sides = ((state.theta, rb), (state.x, rtb))
    tot = {k: 0.0 for k in ("herm_ms", "herm_plain_ms", "herm_lib_ms", "herm_ops",
                            "herm_bytes", "solve_ms", "solve_plain_ms",
                            "solve_lib_ms", "solve_ops", "solve_bytes")}
    err = {"herm": 0.0, "solve": 0.0}
    f = spec.f
    for side, (fixed, binned) in zip(("users", "items"), sides):
        for b in binned.bins:
            before = (tot["herm_ms"], tot["solve_ms"])
            idx, val, cnt = triplet(b)
            diag = torch.where(cnt > 0, spec.lam * cnt.float(), torch.ones_like(cnt, dtype=torch.float32))
            nnz, m = b.nnz, b.m
            A, B = fused_herm_cuda(fixed, idx, val, cnt, diag)
            step = max(1, PLAIN_CHUNK_ELEMS // (b.K * f))
            chunks = [slice(lo, lo + step) for lo in range(0, m, step)]
            for sl in chunks:
                A0, B0 = fused_herm_plain(fixed, idx[sl], val[sl], cnt[sl], diag[sl])
                check(torch.allclose(A[sl], A0, atol=HERM_ATOL, rtol=HERM_RTOL)
                      and torch.allclose(B[sl], B0, atol=HERM_ATOL, rtol=HERM_RTOL),
                      f"fused_herm disagrees with its plain version at K={b.K}")
                err["herm"] = max(err["herm"], (A[sl] - A0).abs().max().item(),
                                  (B[sl] - B0).abs().max().item())
                del A0, B0
            tot["herm_ms"] += cuda_ms(torch, lambda: fused_herm_cuda(fixed, idx, val, cnt, diag))
            tot["herm_plain_ms"] += sum(cuda_ms(torch, lambda sl=sl: fused_herm_plain(
                fixed, idx[sl], val[sl], cnt[sl], diag[sl])) for sl in chunks)
            for sl in chunks:      # library yardstick: one bmm on the masked gather
                g = fixed[idx[sl].long()]
                gm = g * kref.mask_from_cnt(cnt[sl], b.K)[..., None]
                tot["herm_lib_ms"] += cuda_ms(torch, lambda: torch.bmm(gm.transpose(1, 2), g))
                del g, gm
            tot["herm_ops"] += nnz * (f * (f + 1) + 2 * f)
            tot["herm_bytes"] += fixed.numel() * 4 + nnz * 8 + m * 8 + A.numel() * 4 + B.numel() * 4

            x1 = batch_solve_cuda(A, B)
            x0 = batch_solve_plain(A, B)
            check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL),
                  f"batch_solve disagrees with its plain version at K={b.K}")
            err["solve"] = max(err["solve"], (x1 - x0).abs().max().item())
            tot["solve_ms"] += cuda_ms(torch, lambda: batch_solve_cuda(A, B))
            tot["solve_plain_ms"] += cuda_ms(torch, lambda: batch_solve_plain(A, B))
            tot["solve_lib_ms"] += cuda_ms(torch, lambda: torch.cholesky_solve(
                B[..., None], torch.linalg.cholesky_ex(A)[0]))
            tot["solve_ops"] += m * (f ** 3 / 3 + 2 * f * f)
            tot["solve_bytes"] += A.numel() * 4 + 2 * B.numel() * 4
            log(f"  {side} bin K={b.K}: {m} rows, {nnz} ratings, max|A| "
                f"{A.abs().max().item():.4g}; fused_herm "
                f"{tot['herm_ms'] - before[0]:.3f} ms, batch_solve "
                f"{tot['solve_ms'] - before[1]:.3f} ms")
            del A, B, x1, x0

    def bound(ops_, bytes_):
        t_ops, t_bytes = ops_ / PEAK_FP32_FLOPS * 1e3, bytes_ / PEAK_HBM_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    hb, hb_by = bound(tot["herm_ops"], tot["herm_bytes"])
    sb, sb_by = bound(tot["solve_ops"], tot["solve_bytes"])
    log(f"per iteration at quarter-Netflix: fused_herm {tot['herm_ms']:.2f} ms "
        f"(plain {tot['herm_plain_ms']:.2f}, bmm {tot['herm_lib_ms']:.2f}, bound {hb:.2f} by {hb_by}); "
        f"batch_solve {tot['solve_ms']:.2f} ms (plain {tot['solve_plain_ms']:.2f}, "
        f"cholesky_ex+cholesky_solve {tot['solve_lib_ms']:.2f}, bound {sb:.2f} by {sb_by})")
    kernels = [
        {"name": "fused_herm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hermitian.cu",
         "replaces": "src/repro/kernels/hermitian.py:72",
         "launches": counts["fused_herm"], "max_abs_err": err["herm"],
         "ms": tot["herm_ms"], "plain_ms": tot["herm_plain_ms"], "bound_ms": hb,
         "bound_by": hb_by, "library_ms": tot["herm_lib_ms"]},
        {"name": "batch_solve", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/batch_solve.cu",
         "replaces": "src/repro/kernels/batch_solve.py:87",
         "launches": counts["batch_solve"], "max_abs_err": err["solve"],
         "ms": tot["solve_ms"], "plain_ms": tot["solve_plain_ms"], "bound_ms": sb,
         "bound_by": sb_by, "library_ms": tot["solve_lib_ms"]},
    ]
    log(smi.splitlines()[0])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
