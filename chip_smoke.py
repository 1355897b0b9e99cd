#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:

1. device: print the card's name and power limit; fp32 matmuls without TF32;
2. build all four CUDA kernels from ``src/repro_torch/kernels/csrc`` (in
   parallel) and print what ptxas said;
3. the ALS kernels against their plain PyTorch versions at f in
   {8, 33, 100, 128}, with ragged and empty rows and ``diag_fallback`` on
   and off, two calls of each bit-equal; heavy rows (K >= 20 split
   parts, ragged cnt, cnt on a part boundary) against the plain version
   and its split order of work; a near-singular system where the
   reference's clamps decide the solution;
3b. the SGD tile sweep and the Fig. 7 Hermitian against their plain
   versions at f in {8, 33, 100, 128} (empty rows, ragged cnt, a forced
   heavy item collision split into parts, units of exactly P and P + 1
   rows, an empty trailing slot, a ragged last bin), the SGD sweep also
   against its planned plain version, one CUDA launch a call, two calls
   bit-equal; one SGD epoch on a per-tile-K, degree-sorted grid, planned
   kernel against plain;
4. netflix-mini (tests/test_convergence.py's problem, seed 2): two ALS
   iterations in kernel mode and in plain mode from one injected state;
4b. netflix-mini SGD: two epochs in kernel and plain mode from one
   injected state and set order; the hybrid (2 ALS iterations + 16 SGD
   epochs, kernel mode) within 2% of 8 kernel-mode ALS iterations
   (tests/test_sgd.py's criterion);
5. quickstart size (examples/quickstart.py's problem), 8 iterations in
   kernel mode, judged by tests/test_convergence.py's relative criteria;
6. the ALS path: ``als_train_binned`` on quarter-Netflix at full width
   (m=120047, n=17770, nnz=24.75M, f=100, lambda=0.05, 8 degree bins),
   3 iterations, with each kernel's launch count read around the run;
7. the ALS kernels timed at that path's shapes (every bin of both sides
   of one iteration) against their plain versions and a library call;
8. the SGD path: ``sgd_train`` (3 epochs, cold start, kernel mode) on
   phase 6's ratings blocked g=4, with its calls and CUDA launches read
   around the run; the slot plans' build time, bytes and shape; each
   set's call held against the plain version, and its planned in-place
   call against both the plain version and the planned plain version;
   the kernel timed per epoch on prebuilt plans, and the plain version;
9. paper Fig. 7 on the card: ``herm_hbm_accum_cuda`` (tk=32) against
   ``fused_herm_cuda`` on phase 6's largest user bin;
10a. out-of-core streaming ALS (``outofcore.run_streaming_als``) on
   netflix-mini in kernel mode: the uniform store at q=4 and the binned
   store at n_bins=4, 3 iterations from ``als_init``, per-iteration RMSE
   within 1e-4 of in-core ``als_train`` (tests/test_outofcore.py:181),
   binned factors within 1e-5 of uniform (:474), both ledgers all ok; a
   kill after wave 3 (solve-X) and after wave 6 (accumulate-Theta) and a
   resume from the checkpoints, bit-equal to the uninterrupted run; then
   streaming SGD (``outofcore.run_streaming_sgd``, g=4, 2 tiles a wave, 2
   epochs) on the uniform and the per-tile-K grid, factors within 1e-5 and
   test RMSE within 1e-3 per epoch of in-core ``sgd_train``
   (tests/test_outofcore.py:290-292), per-tile-K bit-equal to uniform,
   kills after waves 3 and 11 resumed bit-equal; and the streaming hybrid
   (``sgd.run_streaming_hybrid``, 2 ALS iterations + 2 SGD epochs, both
   streamed), its first SGD epoch below the cold ALS start, a restart that
   skips ALS and gives bit-equal factors; every ledger all ok;
10b. streaming ALS at quarter-Netflix, f=100, on phase 6's ratings: the
   binned store (n_bins=8), q the smallest power of two >= 8 whose eq. (8)
   plan fits a device capped at 1.5 GiB (standing in for a problem larger
   than the card), 3 iterations with prefetch depth 2, per-iteration RMSE
   within 1e-4 of phase 6, an all-ok ledger; both kernels against their
   plain versions at the shapes of that run (every bin of solve-X wave 0,
   every bin of every R^T batch with the heavy items split, the solve of
   the accumulated Theta systems, which must reproduce the run's Theta);
   the store's build time, the host's peak RSS and the resident set it
   added, ms per iteration (CUDA events and wall clock),
   the phase breakdown (prefetch stall against overlapped load), bytes
   streamed and the rate they imply, and the allocator's peak beside the
   schedule's capacity and the modelled meter's peak, which it must not
   exceed;
10c. streaming SGD at quarter-Netflix, f=100, on phase 8's grid and
   config from a cold start: one tile a wave (16 waves an epoch), 3 epochs
   without evaluation, the final factors within 1e-5 of phase 8's, an
   all-ok ledger with exact bytes, ms per epoch, the stall share, bytes
   and their rate, each wave's slot plan (build time, bytes, and the
   allocator's peak of building the largest alone), the allocator's peak
   over the run, which must not exceed the schedule's capacity plus that
   plan peak; ``sgd_tile_planned_`` at one wave of each set against
   ``sgd_tile_planned_plain`` and ``sgd_tile_plain``;
10d. the layout autotuner on phase 10b's ratings (q=8, f=100): the
   analytic ALS sweep, whose winner's bytes must equal its store's
   ``predicted_stream_stats``; the measured sweep (one solve-X wave per
   rung on the card); the SGD blocking sweep at g=4; and
   ``RatingStore(n_bins="auto")`` twice through a cache file, a miss and
   then a hit under the ``cuda`` backend tag;
11. the multi-device path, one host program driving a mesh whose cells
   all share this one card (results and launches, not scaling):
   11a. netflix-mini: ``distributed.su_als.make_su_als_fns(...).iteration``
   on data=2 x model=4 (one-phase) and pod=2 x data=2 x model=2 (one- and
   two-phase), kernels against phase 4's single-device kernel iteration
   and against the same mesh in plain mode (2e-3), ``row_block=64``
   against 0 (1e-4); streaming mesh ALS on data=4 x model=2 (the reduce's
   tree stage runs), uniform and binned, against in-core (1e-4), killed
   after waves 1 and 3 and resumed bit-equal; streaming mesh SGD with 2
   and 3 workers against in-core (1e-4);
   11b. binned streaming mesh ALS at quarter-Netflix, f=100, on data=2 x
   model=2 (p=2) under phase 10b's 1.5 GiB budget a cell, 3 iterations:
   RMSE within 1e-4 of phase 6, an all-ok ledger, the allocator's peak at
   most 4 cells x the schedule's capacity; both ALS kernels against their
   plain versions at that run's shapes (solve-X wave 0 in each cell's
   column block, reduced and each owned slice solved, which must match the
   wave entry point; every stacked bin of every batch on each cell, the
   split path included; each theta shard's reduce-and-solve, which must
   reproduce the run's Theta); ms per iteration, the reduce's seconds and
   bytes, the partials brought to the host a wave, the stall;
   11c. streaming mesh SGD at quarter-Netflix on phase 8's grid, 4 tiles
   a wave, one to each cell of data=2 x model=2, 3 epochs: factors within
   1e-4 of phase 8's, ms per epoch;
12. the user entry points on the card, each ``main(argv)`` in-process in a
   temporary working directory with its own ``--ckpt``, every kernel's
   count set to 0 before each call and read after it, the path's kernels
   required: ``examples_torch/quickstart.py`` (the relative criteria), and
   once as a script; ``examples_torch/train_als_netflix.py`` at its default
   size (netflix-scaled, 122880 x 17770, 6 M ratings, f=32): in-core ALS
   for 2 iterations and a rerun that resumes to 3, SGD for 3 epochs, the
   hybrid (2 + 3), out-of-core ALS under a 256 MiB budget (waves >= 2)
   with an all-ok ``--ledger`` and a valid ``--trace``; at ``--small`` the
   streamed SGD and hybrid, ``--autotune`` twice (a cache miss, then a
   hit), and ``--mesh 2,2 --mesh-device cuda:0`` for ALS and SGD; the
   script's own launch line must match the wrappers' counts; both ALS
   kernels at the in-core run's shapes (R, and R^T with its heavy items
   split) and the SGD kernel at the SGD run's grid, from their
   checkpoints, against the plain versions; then ``benchmarks_torch/
   run.py`` once per module at its default size (``--autotune``), every
   row parsed, both JSON files written, and ``python -m
   repro_torch.obs.regress --history`` accepting the history file.

The second-to-last line of output is a JSON ``kernels`` record (with each
kernel's ``launches_mesh``, its launches in phase 11's runs,
``launches_entry_points``, its launches in phase 12's runs, and for the
ALS kernels ``max_abs_err_mesh``, their error against the plain versions
at 11b's shapes, and ``max_abs_err_entry_points`` for the three training
kernels at phase 12's shapes); the last line is ``{"ok": true, "device":
{...}}``.
Without a GPU, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import io
import json
import resource
import subprocess
import sys
import tempfile
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
SGD_TOL = 1e-5                         # tests/test_sgd.py:97, :285
STREAM_RMSE_TOL = 1e-4                 # tests/test_outofcore.py:181-182
BINNED_TOL = 1e-5                      # tests/test_outofcore.py:474-475
SOLVE_NB = 16                          # kNB of csrc/batch_solve.cu
SU_TOL = 2e-3                          # tests/test_distributed.py:73-74, :92-93
MESH_TOL = 1e-4                        # tests/test_distributed.py:110-111,
                                       # tests/test_mesh_streaming.py:189-192, :354-356
PLAN_PEAK_INT64 = 126_199_808          # phase 10c's plan build before its int32 form
PLAIN_CHUNK_ELEMS = 1 << 28            # gathered floats per plain-version chunk


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rss_now() -> int:
    """The process's resident set now, in bytes (``VmRSS``), where
    ``ru_maxrss`` gives only its high-water mark."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return -1


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


class _Tee(io.TextIOBase):
    """Standard output that also keeps what passes through it: the output
    of an entry point run in-process."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.out.write(s)
        self.parts.append(s)
        return len(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _load_script(rel: str):
    """A script of the repository (``examples_torch/...``) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("smoke_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: each bench module's row-name prefixes, and the kernels its run must launch
BENCH_ROWS = {
    "convergence": (("fig6_convergence_netflix", "fig6_convergence_yahoomusic"),
                    ("fused_herm", "batch_solve")),
    "register_ablation": (("fig7_register_fused", "fig7_register_hbm_binned"),
                          ("fused_herm", "herm_hbm_accum")),
    "texture": (("fig8_texture_fused_gather", "fig8_texture_materialized"), ("fused_herm",)),
    "scaling": (("fig9_scaling_1dev_measured",) + tuple(
        f"fig9_scaling_modeled_p{p}" for p in (1, 2, 4, 8, 16)), ("fused_herm", "batch_solve")),
    "huge": (tuple(f"fig11_huge_{n}" for n in ("netflix", "yahoomusic", "hugewiki", "sparkals",
                                               "factorbird", "facebook", "cumf_max"))
             + ("outofcore_q4_w2", "outofcore_q8_w4", "outofcore_q4_w2_binned",
                "outofcore_binned_fill_win", "outofcore_q4_w2_autotuned",
                "outofcore_mesh_p2_q4_w2_binned"), ("fused_herm", "batch_solve")),
    "reduction": (tuple(f"fig5_reduction_p16x{s}_{k}" for s in (2, 4)
                        for k in ("flat", "two_phase")), ()),
    "kernels": (("kern_fused_AB_one_pass", "kern_paper_two_pass", "kern_batch_solve"),
                ("fused_herm", "batch_solve")),
    "sgd": (tuple(f"sgd_vs_als_{k}" for k in ("als", "sgd", "hybrid", "sgd_stream",
                                               "sgd_stream_skew", "sgd_stream_binned"))
            + ("sgd_binned_fill_win", "sgd_vs_als_sgd_stream_mesh"),
            ("fused_herm", "batch_solve", "sgd_tile")),
}


def entry_points(torch, wrappers: dict, dev) -> dict:
    """Phase 12: the user entry points on the card.

    Each script's ``main(argv)`` runs in-process with the working directory
    a fresh temporary one and its own ``--ckpt`` there; every kernel
    wrapper's count is set to 0 just before each call and read just after,
    and the path's kernels must have launched.  The example's own count
    line must agree.  After the in-core ALS and SGD runs at the default
    size, their kernels are held against the plain versions at the shapes
    those runs gave them, from the runs' checkpoints.  Returns the launches
    summed over the runs, each run's seconds, launches and allocator peak,
    and the kernels' largest errors.
    """
    import contextlib
    import importlib
    import os
    import re

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import als
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sgd_update
    from repro_torch.kernels.batch_solve import batch_solve_cuda, batch_solve_plain
    from repro_torch.kernels.hermitian import fused_herm_cuda, fused_herm_plain
    from repro_torch.obs import load_and_validate, validate_ledger
    from repro_torch.sgd import blocking
    from repro_torch.sgd import train as sgd
    from repro_torch.sparse import synth

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))           # benchmarks_torch
    train = _load_script("examples_torch/train_als_netflix.py")
    quick = _load_script("examples_torch/quickstart.py")
    bench = importlib.import_module("benchmarks_torch.run")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    total = dict.fromkeys(wrappers, 0)
    runs, err = [], {"herm": 0.0, "solve": 0.0, "sgd": 0.0}
    als_path, sgd_path = ("fused_herm", "batch_solve"), ("sgd_tile",)
    log(f"phase 12: the entry points on the card, in {work}; host RSS {rss_now() / 2**30:.2f} GiB")

    def call(label, fn, argv, path):
        """``fn(argv)`` in ``work``, its output kept; the launches, seconds
        and allocator peak of the call."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tee = _Tee(sys.stdout)
        cwd = os.getcwd()
        os.chdir(work)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                ret = fn(argv)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        secs = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() - resident
        log(f"phase 12 {label}: {secs:.2f} s, launches {counts}, allocator peak "
            f"{peak / 2**20:.1f} MiB over {resident / 2**20:.1f} MiB resident, host peak RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
        for k in path:
            check(counts[k] > 0, f"phase 12 {label}: kernel {k} was never launched")
        for k, v in counts.items():
            total[k] += v
        runs.append({"run": label, "seconds": secs, "launches": counts, "peak_bytes": peak})
        return tee.text(), ret

    def example(label, argv, path):
        out, _ = call(label, train.main, ["--device", "cuda", *argv], path)
        line = [ln for ln in out.splitlines() if ln.startswith("kernel launches: ")]
        check(len(line) == 1, f"phase 12 {label}: no kernel launch line")
        printed = json.loads(line[0].removeprefix("kernel launches: "))
        check(printed == runs[-1]["launches"],
              f"phase 12 {label}: the script counted {printed}, the wrappers {runs[-1]['launches']}")
        rmses = [float(v) for v in re.findall(r"test_rmse=([0-9.]+|nan|inf)", out)]
        check(bool(rmses) and all(np.isfinite(rmses)) and rmses[-1] < 1.2,
              f"phase 12 {label}: test RMSE {rmses}")
        return out

    def ck(name):
        return str(work / name)

    def restore(directory, rows_x, rows_t, f):
        state, step = CheckpointManager(directory).restore_or_init(
            {"x": torch.zeros((rows_x, f), device=dev),
             "theta": torch.zeros((rows_t, f), device=dev)}, lambda: None)
        check(step > 0, f"no checkpoint under {directory}")
        return state

    # quickstart, in-process and as a script
    _, hist = call("quickstart", quick.main, ["--device", "cuda"], als_path)
    rm = [h["test_rmse"] for h in hist]
    check(quick.converged(rm), f"quickstart failed the relative criteria: {rm}")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    sub = subprocess.run([sys.executable, str(ROOT / "examples_torch" / "quickstart.py")],
                         cwd=work, env=env, capture_output=True, text=True, timeout=600)
    log(f"phase 12 quickstart as a script: exit {sub.returncode} in "
        f"{time.perf_counter() - t0:.2f} s; {sub.stdout.strip().splitlines()[-2:]}")
    check(sub.returncode == 0 and "converged." in sub.stdout,
          f"python3 examples_torch/quickstart.py failed: {sub.stdout[-2000:]} {sub.stderr[-2000:]}")

    # train_als_netflix at its default size (netflix-scaled, f=32): in-core
    # ALS, kept ratings for the kernel checks below
    kept = {}
    real = synth.make_synthetic_ratings

    def keep(*a, **k):
        kept["ratings"] = real(*a, **k)
        return kept["ratings"]

    synth.make_synthetic_ratings = keep
    try:
        example("train_als_netflix ALS, 2 iterations", ["--iters", "2", "--ckpt", ck("als")],
                als_path)
    finally:
        synth.make_synthetic_ratings = real

    # both ALS kernels at the shapes that run gave them (R, then R^T with
    # its heavy items split, in the example's 16384-row blocks), at its
    # checkpointed factors
    r, rt, _, _ = kept.pop("ratings")
    f, lam, rows = 32, 0.05, 16_384
    st = restore(ck("als"), r.m, rt.m, f)
    for side, fixed, ell in (("R", st["theta"], r), ("R^T", st["x"], rt)):
        idx, val, cnt = als.ell_triplet(ell, dev)
        diag = torch.where(cnt > 0, lam * cnt.float(), torch.ones_like(cnt, dtype=torch.float32))
        K = idx.shape[1]
        step = max(1, PLAIN_CHUNK_ELEMS // (K * f))
        a_max = 0.0
        for lo in range(0, ell.m, rows):
            blk = slice(lo, min(lo + rows, ell.m))
            A, B = fused_herm_cuda(fixed, idx[blk], val[blk], cnt[blk], diag[blk])
            a_max = max(a_max, A.abs().max().item())
            for c0 in range(blk.start, blk.stop, step):
                sl = slice(c0, min(c0 + step, blk.stop))
                A0, B0 = fused_herm_plain(fixed, idx[sl], val[sl], cnt[sl], diag[sl])
                a_, b_ = A[sl.start - lo:sl.stop - lo], B[sl.start - lo:sl.stop - lo]
                check(torch.allclose(a_, A0, atol=HERM_ATOL, rtol=HERM_RTOL)
                      and torch.allclose(b_, B0, atol=HERM_ATOL, rtol=HERM_RTOL),
                      f"fused_herm disagrees with its plain version on the example's {side}")
                err["herm"] = max(err["herm"], (a_ - A0).abs().max().item(),
                                  (b_ - B0).abs().max().item())
                del A0, B0
            x1, x0 = batch_solve_cuda(A, B), batch_solve_plain(A, B)
            check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL),
                  f"batch_solve disagrees with its plain version on the example's {side}")
            err["solve"] = max(err["solve"], (x1 - x0).abs().max().item())
            del A, B, x1, x0
        log(f"  the example's {side}: {ell.m} rows, K={K}, {ell.nnz} ratings, max|A| "
            f"{a_max:.4g}: max|dA,dB| {err['herm']:.3g}, max|dx| {err['solve']:.3g} so far")
        del idx, val, cnt, diag
    del st, rt

    out = example("train_als_netflix ALS resumed to 3 iterations",
                  ["--iters", "3", "--ckpt", ck("als")], als_path)
    check("resuming from checkpoint at iteration 2" in out
          and re.findall(r"^iter +(\d+) ", out, re.M) == ["3"],
          "the in-core ALS rerun did not resume from iteration 2")

    example("train_als_netflix SGD, 3 epochs", ["--solver", "sgd", "--epochs", "3",
                                                "--ckpt", ck("sgd")], sgd_path)
    # the SGD kernel at the run's grid, from its final factors: each set's
    # planned in-place call against the plain version and the planned plain one
    grid = blocking.block_ell(r, g=4)
    g, mb, nb, K = grid.g, grid.mb, grid.nb, grid.K
    st = restore(str(Path(ck("sgd")) / "sgd"), g * mb, g * nb, f)
    cfg = sgd.SgdConfig(f=f, lam=lam, lr=0.15, epochs=3, schedule="cosine")
    lr0 = sgd.epoch_lr(cfg, 0)
    idx, val, cnt = gt = sgd.grid_triplet(grid, dev)
    plans = sgd.build_set_plans(gt, grid)
    ar = torch.arange(g, device=dev)
    offs = (torch.arange(g, dtype=torch.int32, device=dev) * nb)[:, None, None]
    tb = st["theta"].reshape(g, nb, f)
    for s_, pl in enumerate(plans):
        j = (ar + s_) % g
        x0, t0_ = sgd_update.sgd_tile_plain(
            st["x"], tb[j].reshape(g * nb, f), (idx[ar, j] + offs).reshape(g * mb, K),
            val[ar, j].reshape(g * mb, K), cnt[ar, j].reshape(g * mb), lr0, lam)
        x1, t1 = st["x"].clone(), st["theta"].clone()
        sgd_update.sgd_tile_planned_(x1, t1, pl, lr0, lam)
        t1_set = t1.reshape(g, nb, f)[j].reshape(g * nb, f)
        xp, tp = kref.sgd_tile_planned_plain(st["x"], st["theta"], pl, lr0, lam)
        for a_, b_ in ((x1, x0), (t1_set, t0_), (x1, xp), (t1, tp)):
            check(torch.allclose(a_, b_, atol=SGD_TOL, rtol=SGD_TOL),
                  f"sgd_tile disagrees with its plain versions on the example's set {s_}")
            err["sgd"] = max(err["sgd"], (a_ - b_).abs().max().item())
        del x0, t0_, x1, t1, t1_set, xp, tp
    log(f"  the example's SGD grid (g={g}, mb={mb}, nb={nb}, K={K}, {grid.nnz} ratings): "
        f"planned sgd_tile vs plain, max |d| {err['sgd']:.3g}")
    del st, grid, gt, idx, val, cnt, plans, tb, r

    example("train_als_netflix hybrid, 2 + 3", ["--solver", "hybrid", "--iters", "2",
                                                 "--epochs", "3", "--ckpt", ck("hybrid")],
            als_path + sgd_path)
    ledger, trace = work / "ledger.json", work / "trace.json"
    out = example("train_als_netflix out-of-core ALS, 2 iterations",
                  ["--out-of-core", "--device-mb", "256", "--iters", "2", "--ledger",
                   str(ledger), "--trace", str(trace), "--ckpt", ck("ooc")], als_path)
    waves = int(re.search(r"^schedule: waves=(\d+)", out, re.M).group(1))
    check(waves >= 2, f"the out-of-core plan has {waves} waves")
    led = json.loads(ledger.read_text())
    check(validate_ledger(led)["ok"] and all(rec["ok"] for rec in led["records"]),
          "the out-of-core example's ledger is not all ok")
    load_and_validate(str(trace))

    # --small: the streamed SGD and hybrid, the autotuner, the mesh
    example("train_als_netflix --small out-of-core SGD",
            ["--small", "--out-of-core", "--solver", "sgd", "--epochs", "3", "--ckpt", ck("s1")],
            sgd_path)
    example("train_als_netflix --small out-of-core hybrid",
            ["--small", "--out-of-core", "--solver", "hybrid", "--iters", "2", "--epochs", "3",
             "--ckpt", ck("s2")], als_path + sgd_path)
    out = example("train_als_netflix --small out-of-core autotune",
                  ["--small", "--out-of-core", "--autotune", "--iters", "2", "--ckpt", ck("s3")],
                  als_path)
    cache = json.loads((work / "s3" / "tune_cache.json").read_text())
    check("(cache_miss)" in out and cache.get("schema") == "repro.core/tunecache-v1",
          f"the autotune run wrote no tune cache: {cache}")
    out = example("train_als_netflix --small out-of-core autotune again",
                  ["--small", "--out-of-core", "--autotune", "--iters", "3", "--ckpt", ck("s3")],
                  als_path)
    check("(cache_hit)" in out, "the second autotune run missed its cache")
    for solver, n in (("als", ["--iters", "2"]), ("sgd", ["--epochs", "3"])):
        out = example(f"train_als_netflix --small mesh 2,2 on cuda:0 {solver}",
                      ["--small", "--out-of-core", "--mesh", "2,2", "--mesh-device", "cuda:0",
                       "--solver", solver, *n, "--ckpt", ck("m" + solver)],
                      als_path if solver == "als" else sgd_path)
        check("on 1 device(s) (cuda:0)" in out, f"the {solver} mesh is not on cuda:0")

    # benchmarks_torch/run.py, every module at its default size, one call each
    history = work / "history.jsonl"
    for name, _ in bench.MODULES:
        names, path = BENCH_ROWS[name]
        out, _ = call(f"bench {name}", bench.main,
                      ["--only", name, "--autotune", "--history", str(history),
                       "--device", "cuda"], path)
        rows = []
        for line in out.splitlines():
            if line and not line.startswith("#") and line != "name,us_per_call,derived":
                row, us, _ = line.split(",", 2)
                check(float(us) >= 0.0, f"bench {name}: row {line!r}")
                rows.append(row)
        check([n for n in rows if n != "outofcore_ledger"] == list(names),
              f"bench {name}: rows {rows}, expected {names}")
    for fname in ("BENCH_torch_outofcore.json", "BENCH_torch_sgd.json"):
        check(len(json.loads((work / fname).read_text())) > 0, f"{fname} is empty")
    sub = subprocess.run([sys.executable, "-m", "repro_torch.obs.regress", "--history",
                          str(history)], env=env, capture_output=True, text=True, timeout=120)
    log(f"phase 12 regress --history: exit {sub.returncode}; {sub.stdout.strip()[-300:]}")
    check(sub.returncode == 0, f"repro_torch.obs.regress refused the history: {sub.stdout}")
    log(f"phase 12 launches over its runs: {total}")
    for k, v in total.items():
        check(v > 0, f"phase 12 never launched {k}")
    return {"launches": total, "runs": runs, "max_abs_err": err}


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
    from repro_torch.core.partition import plan_for, streaming_acc_bytes
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.batch_solve import batch_solve_cuda, batch_solve_plain
    from repro_torch.kernels.hermitian import (fused_herm_cuda, fused_herm_plain,
                                               herm_hbm_accum_cuda, herm_hbm_accum_plain,
                                               split_slots)
    from repro_torch.kernels import sgd_update
    from repro_torch.kernels.sgd_update import sgd_tile_cuda, sgd_tile_plain
    from repro_torch.obs import Tracer
    from repro_torch.obs.ledger import validate_ledger
    from repro_torch.obs.report import render_ledger
    from repro_torch.core import autotune
    from repro_torch.outofcore import (FactorStore, RatingStore, SimulatedFailure,
                                       TileStore, build_schedule, build_sgd_schedule,
                                       run_streaming_als, run_streaming_sgd, sgd_driver)
    from repro_torch.outofcore.schedule import predicted_stream_stats
    from repro_torch.sgd import blocking, hybrid
    from repro_torch.sgd import train as sgd
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
    for f in (8, 33, 100, 128):
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
        A2, B2 = ops.fused_herm(theta, idx, val, cnt, 0.05, mode="kernel")
        check(torch.equal(A, A2) and torch.equal(B, B2),
              f"two fused_herm calls on the same inputs differ at f={f}")
        x1 = ops.batch_solve(A, B, mode="kernel")
        x0 = ops.batch_solve(A, B, mode="ref")
        xb = kref.batch_solve_blocked_plain(A, B, SOLVE_NB)
        check(torch.equal(x1, ops.batch_solve(A, B, mode="kernel")),
              f"two batch_solve calls on the same inputs differ at f={f}")
        resid = (torch.einsum("uij,uj->ui", A, x1) - B).abs().max().item()
        scale = B.abs().max().item()
        log(f"solve f={f}: max|dx|={(x1 - x0).abs().max().item():.3g} "
            f"(blocked plain {(x1 - xb).abs().max().item():.3g}) "
            f"max residual {resid:.3g} (max|B| {scale:.3g}); two calls of each kernel bit-equal")
        check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL)
              and torch.allclose(x1, xb, atol=SOLVE_TOL, rtol=SOLVE_TOL),
              f"batch_solve disagrees with its plain versions at f={f}")
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
        del g, gm, A2, B2

    # heavy rows: K >= 20 parts of the split, cnt ragged, on a part boundary,
    # 0; factors and ratings as ALS has them (the tolerances are absolute
    # at 2e-4, and sums of 4e4 signed terms would cancel below them)
    S = split_slots()
    f, n, K = 100, 700, 20 * S + 123
    theta = (torch.rand(n, f, generator=gen) * 0.3).to(dev)
    idx = torch.randint(0, n, (6, K), generator=gen, dtype=torch.int32).to(dev)
    cnt = torch.tensor([K, 0, 3 * S, 20 * S + 1, 777, K - 5], dtype=torch.int32).to(dev)
    val = (torch.rand(6, K, generator=gen) * 4 + 1).to(dev) * kref.mask_from_cnt(cnt, K)
    diag = torch.where(cnt > 0, 0.05 * cnt.float(), torch.ones(6, device=dev))
    calls = fused_herm_cuda.cuda_launches
    A1, B1 = fused_herm_cuda(theta, idx, val, cnt, diag)
    A2, B2 = fused_herm_cuda(theta, idx, val, cnt, diag)
    check(fused_herm_cuda.cuda_launches - calls == 4, "a split fused_herm call is not 2 launches")
    for name, (A0, B0) in (("plain", fused_herm_plain(theta, idx, val, cnt, diag)),
                           ("split-order plain", kref.fused_herm_chunked_plain(
                               theta, idx, val, cnt, diag, S))):
        log(f"herm heavy rows (K={K}, split {S}) vs {name}: max|dA|="
            f"{(A1 - A0).abs().max().item():.3g} max|dB|={(B1 - B0).abs().max().item():.3g}")
        check(torch.allclose(A1, A0, atol=HERM_ATOL, rtol=HERM_RTOL)
              and torch.allclose(B1, B0, atol=HERM_ATOL, rtol=HERM_RTOL),
              f"fused_herm on heavy rows disagrees with its {name} version")
    check(torch.equal(A1, A2) and torch.equal(B1, B2),
          "two split fused_herm calls on the same inputs differ")
    log("  two split fused_herm calls bit-equal")
    x1 = batch_solve_cuda(A1, B1)
    check(torch.allclose(x1, batch_solve_plain(A1, B1), atol=SOLVE_TOL, rtol=SOLVE_TOL),
          "batch_solve disagrees with its plain version on the heavy rows' systems")
    del A1, B1, A2, B2, idx, val

    # near-singular: coordinate 5 decoupled, pivot 1e-30, b 1e-30 -> x_5 = 1e10
    L = torch.randn(64, 20, 20, generator=gen) * 0.3
    A = L @ L.transpose(1, 2) + 2 * torch.eye(20)
    B = torch.randn(64, 20, generator=gen)
    A[:, 5, :] = 0.0
    A[:, :, 5] = 0.0
    A[:, 5, 5] = 1e-30
    B[:, 5] = 1e-30
    A, B = A.to(dev), B.to(dev)
    x1, x0 = batch_solve_cuda(A, B), kref.batch_solve_blocked_plain(A, B, SOLVE_NB)
    log(f"solve near-singular: x_5 {x1[:, 5].min().item():.4g}..{x1[:, 5].max().item():.4g} "
        f"(clamped; exact 1), max|dx| vs blocked plain {(x1 - x0).abs().max().item():.3g}")
    check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL),
          "batch_solve disagrees with the clamped plain version on a near-singular system")

    # -- 3b. SGD sweep and Fig. 7 Hermitian vs plain, small shapes -----------------
    P = sgd_update.P_SPLIT
    log(f"sgd_tile: units of at most P={P} rows")
    for f in (8, 33, 100, 128):
        mb, nb, K = 1000, 300, 40
        x = (torch.rand(mb, f, generator=gen) * 0.3).to(dev)
        th = (torch.rand(nb, f, generator=gen) * 0.3).to(dev)
        idx = torch.randint(0, nb, (mb, K), generator=gen, dtype=torch.int32)
        heavy = mb * 3 // 4
        idx[:heavy, 1] = 7                        # 750 rows hit item 7 in slot 1: split
        idx[:, 2] = torch.randint(20, nb, (mb,), generator=gen, dtype=torch.int32)
        idx[:P, 2] = 11                           # a unit of exactly P rows
        idx[P:2 * P + 1, 2] = 12                  # a group of P + 1 rows: two parts
        cnt = torch.randint(0, K, (mb,), generator=gen, dtype=torch.int32)   # slot K-1 empty
        cnt[heavy:][torch.rand(mb - heavy, generator=gen) < 0.2] = 0
        cnt[:heavy] = torch.clamp(cnt[:heavy], min=3)
        val = torch.rand(mb, K, generator=gen) * 4 + 1
        idx, cnt, val = idx.to(dev), cnt.to(dev), val.to(dev)
        plan = sgd_update.build_plan(idx, val, cnt)
        units, splits = plan.units.cpu(), plan.splits.cpu()
        check(K - 1 not in plan.slots.tolist() and bool(((units[:, 2] == P) & (units[:, 3] < 0)).any())
              and bool((splits[:, 3] == P + 1).any()) and bool((splits[:, 3] >= heavy).any()),
              f"phase 3b's plan lacks its cases at f={f}")
        calls = sgd_tile_cuda.cuda_launches
        x1, t1 = sgd_tile_cuda(x, th, idx, val, cnt, 0.05, 0.05)
        check(sgd_tile_cuda.cuda_launches - calls == 1, "an sgd_tile call is not one CUDA launch")
        x2, t2 = sgd_tile_cuda(x, th, idx, val, cnt, 0.05, 0.05)
        for name, (x0, t0_) in (("plain", sgd_tile_plain(x, th, idx, val, cnt, 0.05, 0.05)),
                                ("planned plain", kref.sgd_tile_planned_plain(
                                    x, th, plan, 0.05, 0.05))):
            log(f"sgd_tile f={f} vs {name}: max|dx|={(x1 - x0).abs().max().item():.3g} "
                f"max|dtheta|={(t1 - t0_).abs().max().item():.3g}")
            check(torch.allclose(x1, x0, atol=SGD_TOL, rtol=SGD_TOL)
                  and torch.allclose(t1, t0_, atol=SGD_TOL, rtol=SGD_TOL),
                  f"sgd_tile disagrees with its {name} version at f={f}")
        check(torch.equal(x1, x2) and torch.equal(t1, t2),
              f"two sgd_tile calls on the same inputs differ at f={f}")
        log(f"  {plan.n_slots} slots planned of {K}, {units.shape[0]} units, "
            f"{splits.shape[0]} split groups; one CUDA launch a call; rerun bit-equal")
        m, n, K = 257, 700, 300                   # 300 % 32: a ragged last bin
        theta = torch.randn(n, f, generator=gen).to(dev)
        idx = torch.randint(0, n, (m, K), generator=gen, dtype=torch.int32).to(dev)
        cnt = torch.randint(0, K + 1, (m,), generator=gen, dtype=torch.int32).to(dev)
        val = torch.randn(m, K, generator=gen).to(dev) * kref.mask_from_cnt(cnt, K)
        diag = torch.where(cnt > 0, 0.05 * cnt.float(), torch.ones(m, device=dev))
        A1, B1 = herm_hbm_accum_cuda(theta, idx, val, cnt, diag, tk=32)
        A0, B0 = herm_hbm_accum_plain(theta, idx, val, cnt, diag, tk=32)
        log(f"herm_hbm_accum f={f}: max|dA|={(A1 - A0).abs().max().item():.3g} "
            f"max|dB|={(B1 - B0).abs().max().item():.3g}")
        check(torch.allclose(A1, A0, atol=HERM_ATOL, rtol=HERM_RTOL)
              and torch.allclose(B1, B0, atol=HERM_ATOL, rtol=HERM_RTOL),
              f"herm_hbm_accum disagrees with its plain version at f={f}")

    # a per-tile-K, degree-sorted grid: one epoch planned kernel vs plain
    rng = np.random.default_rng(5)
    m_, n_ = 3000, 900
    pu, pv = np.arange(1, m_ + 1) ** -1.1, np.arange(1, n_ + 1) ** -0.8
    rr = rng.choice(m_, size=60_000, p=pu / pu.sum())
    cc = rng.choice(n_, size=60_000, p=pv / pv.sum())
    _, keep = np.unique(rr * n_ + cc, return_index=True)
    grid = blocking.block_coo(rr[keep], cc[keep], rng.uniform(1, 5, keep.size).astype(np.float32),
                              m_, n_, 4, per_tile_k=True, degree_sort=True)
    gt = sgd.grid_triplet(grid, dev)
    st = sgd.sgd_state_from_numpy(rng.uniform(0, 0.3, (grid.g * grid.mb, 8)),
                                  rng.uniform(0, 0.3, (grid.g * grid.nb, 8)), device=dev)
    out = {}
    for mode in ("kernel", "ref"):
        scfg = sgd.SgdConfig(f=8, lam=0.05, mode=mode)
        calls = sgd_tile_cuda.cuda_launches
        out[mode] = sgd.sgd_epoch(st, gt, grid, scfg, 0.05, set_order=[2, 0, 3, 1])
        if mode == "kernel":
            check(sgd_tile_cuda.cuda_launches - calls == grid.g, "a planned set is not one launch")
    dx = (out["kernel"].x - out["ref"].x).abs().max().item()
    dt = (out["kernel"].theta - out["ref"].theta).abs().max().item()
    log(f"sgd epoch, per-tile-K degree-sorted grid (tile K {sorted(set(grid.tile_K.ravel().tolist()))}"
        f", {grid.nnz} ratings): planned kernel vs plain max|dx|={dx:.3g} max|dtheta|={dt:.3g}")
    check(torch.allclose(out["kernel"].x, out["ref"].x, atol=SGD_TOL, rtol=SGD_TOL)
          and torch.allclose(out["kernel"].theta, out["ref"].theta, atol=SGD_TOL, rtol=SGD_TOL),
          "planned SGD epoch on a per-tile-K degree-sorted grid disagrees with plain")

    wrappers = {"fused_herm": fused_herm_cuda, "batch_solve": batch_solve_cuda,
                "sgd_tile": sgd_tile_cuda, "herm_hbm_accum": herm_hbm_accum_cuda}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        fused_herm_cuda.cuda_launches = 0
        sgd_tile_cuda.cuda_launches = 0

    def read_counts(phase: str, path=("fused_herm", "batch_solve")) -> dict:
        counts = {name: w.launches for name, w in wrappers.items()}
        log(f"{phase} launches: {counts}; CUDA launches: fused_herm "
            f"{fused_herm_cuda.cuda_launches}, sgd_tile {sgd_tile_cuda.cuda_launches}")
        for name in path:
            check(counts[name] > 0, f"{phase}: kernel {name} was never launched")
        return counts

    def triplet(ell):
        return als.ell_triplet(ell, dev)

    # -- 4. netflix-mini trajectory, kernel vs plain -------------------------------
    spec = synth.SynthSpec("netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)
    r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=2, noise=0.1)
    rng = np.random.default_rng(2)
    x_init = rng.uniform(0.0, 0.3, (r.m, spec.f))
    t_init = rng.uniform(0.0, 0.3, (rt.m, spec.f))
    states = {}
    for mode in ("ref", "kernel"):
        cfg = als.AlsConfig(f=spec.f, lam=spec.lam, mode=mode)
        st = als.state_from_numpy(x_init, t_init, device=dev)
        reset_counts()
        for i in range(2):
            st = als.als_iteration(st, triplet(r), triplet(rt), cfg)
            if i == 0 and mode == "kernel":     # phase 11a's single-device iteration
                p4 = {"spec": spec, "r": r, "rt": rt, "init": (x_init, t_init), "first": st}
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

    # -- 4b. netflix-mini SGD and hybrid ------------------------------------------------
    grid = blocking.block_ell(r, g=4)
    x_init = rng.uniform(0.0, 0.3, (grid.g * grid.mb, spec.f))
    t_init = rng.uniform(0.0, 0.3, (grid.g * grid.nb, spec.f))
    gt = sgd.grid_triplet(grid, dev)
    states = {}
    for mode in ("ref", "kernel"):
        scfg = sgd.SgdConfig(f=spec.f, lam=spec.lam, lr=0.1, epochs=2, mode=mode, seed=3)
        st = sgd.sgd_state_from_numpy(x_init, t_init, device=dev)
        reset_counts()
        for ep in range(2):
            st = sgd.sgd_epoch(st, gt, grid, scfg, sgd.epoch_lr(scfg, ep),
                               set_order=sgd.epoch_set_order(scfg.seed, ep, grid.g))
        torch.cuda.synchronize()
        if mode == "kernel":
            read_counts("netflix-mini SGD", ("sgd_tile",))
        states[mode] = st
    dx = (states["kernel"].x - states["ref"].x).abs().max().item()
    dt = (states["kernel"].theta - states["ref"].theta).abs().max().item()
    log(f"netflix-mini 2 SGD epochs kernel vs plain: max|dx|={dx:.3g} max|dtheta|={dt:.3g}")
    check(torch.allclose(states["kernel"].x, states["ref"].x, atol=SGD_TOL, rtol=SGD_TOL)
          and torch.allclose(states["kernel"].theta, states["ref"].theta,
                             atol=SGD_TOL, rtol=SGD_TOL),
          "netflix-mini SGD epochs: kernel and plain modes disagree")
    test = triplet(rte)
    _, als_hist = als.als_train(triplet(r), triplet(rt), r.m, rt.m,
                                als.AlsConfig(f=spec.f, lam=spec.lam, iters=8), test=test)
    reset_counts()
    _, hyb_hist = hybrid.hybrid_train(
        triplet(r), triplet(rt), grid, als.AlsConfig(f=spec.f, lam=spec.lam, iters=2),
        sgd.SgdConfig(f=spec.f, lam=spec.lam, lr=0.12, epochs=16, schedule="cosine", seed=1),
        test=test)
    torch.cuda.synchronize()
    read_counts("netflix-mini hybrid", ("fused_herm", "batch_solve", "sgd_tile"))
    als_rmse, hyb_rmse = als_hist[-1]["test_rmse"], hyb_hist[-1]["test_rmse"]
    log(f"netflix-mini test RMSE: hybrid {hyb_rmse:.4f} (phases "
        f"{[h['phase'] for h in hyb_hist].count('als')} als + "
        f"{[h['phase'] for h in hyb_hist].count('sgd')} sgd), ALS {als_rmse:.4f}")
    check(hyb_rmse <= als_rmse * 1.02, f"hybrid test RMSE {hyb_rmse} not within 2% of ALS {als_rmse}")

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
    incore_hist = hist
    peak = torch.cuda.max_memory_allocated()
    iter_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(cfg.iters)]
    incore_iter_ms = iter_ms
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
    herm_cuda_launches = 0
    for side, (fixed, binned) in zip(("users", "items"), sides):
        for b in binned.bins:
            before = (tot["herm_ms"], tot["solve_ms"])
            idx, val, cnt = triplet(b)
            diag = torch.where(cnt > 0, spec.lam * cnt.float(), torch.ones_like(cnt, dtype=torch.float32))
            nnz, m = b.nnz, b.m
            launched = fused_herm_cuda.cuda_launches
            A, B = fused_herm_cuda(fixed, idx, val, cnt, diag)
            herm_cuda_launches += fused_herm_cuda.cuda_launches - launched
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
                f"{A.abs().max().item():.4g}; fused_herm ("
                f"{f'{-(-b.K // S)} parts, 2 launches' if b.K > S else '1 launch'}) "
                f"{tot['herm_ms'] - before[0]:.3f} ms, batch_solve "
                f"{tot['solve_ms'] - before[1]:.3f} ms")
            del A, B, x1, x0

    def bound(ops_, bytes_):
        t_ops, t_bytes = ops_ / PEAK_FP32_FLOPS * 1e3, bytes_ / PEAK_HBM_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    hb, hb_by = bound(tot["herm_ops"], tot["herm_bytes"])
    sb, sb_by = bound(tot["solve_ops"], tot["solve_bytes"])
    n_bins = len(rb.bins) + len(rtb.bins)
    log(f"per iteration at quarter-Netflix: fused_herm {tot['herm_ms']:.2f} ms "
        f"({n_bins} calls, {herm_cuda_launches} CUDA launches) "
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

    # -- 8. SGD path: quarter-Netflix blocked g=4, 3 epochs --------------------------
    t0 = time.perf_counter()
    r_full = rb.to_padded()
    grid = blocking.block_ell(r_full, g=4)
    g, mb, nb, K = grid.g, grid.mb, grid.nb, grid.K
    log(f"SGD grid build: {time.perf_counter() - t0:.1f} s; g {g} mb {mb} nb {nb} K {K} "
        f"fill {grid.fill:.3f} nnz {grid.nnz}")
    train_eval = triplet(r_full)
    scfg = sgd.SgdConfig(f=f, lam=spec.lam, epochs=3)
    check(scfg.mode == "kernel", f"default SGD mode on the card is {scfg.mode}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)]
    walls = [time.perf_counter()]
    per_epoch = []            # (peak bytes, sgd_tile calls) after each epoch

    def on_epoch(state, rec):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter())
        per_epoch.append((torch.cuda.max_memory_allocated(), sgd_tile_cuda.launches))
        torch.cuda.reset_peak_memory_stats()

    reset_counts()
    marks[0].record()
    sstate, shist = sgd.sgd_train(grid, scfg, test=test, train_eval=train_eval,
                                  callback=on_epoch)
    torch.cuda.synchronize()
    counts["sgd_tile"] = read_counts("quarter-Netflix SGD", ("sgd_tile",))["sgd_tile"]
    sgd_cuda_launches = sgd_tile_cuda.cuda_launches
    epoch_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(scfg.epochs)]
    eval_ms = cuda_ms(torch, lambda: [float(als.rmse_padded(*sgd.eval_factors(sstate, grid), *t))
                                      for t in (test, train_eval)])
    calls = [0] + [c for _, c in per_epoch]
    for h, ms, w0, w1, (peak, _), c0, c1 in zip(shist, epoch_ms, walls, walls[1:],
                                                per_epoch, calls, calls[1:]):
        log(f"  epoch {h['epoch']} (lr {h['lr']:.5g}): {ms:.1f} ms on the card "
            f"({w1 - w0:.3f} s wall) train RMSE {h['train_rmse']:.4f} "
            f"test RMSE {h['test_rmse']:.4f}, peak device memory "
            f"{peak / 2**30:.2f} GiB ({peak} B), {c1 - c0} sgd_tile calls")
    log(f"  (each epoch includes its RMSE evaluation, {eval_ms:.1f} ms on the card; "
        f"the first also uploads the grid and builds the slot plans); "
        f"{sgd_cuda_launches / scfg.epochs:g} sgd_tile CUDA launches per epoch")
    train = [h["train_rmse"] for h in shist]
    check(all(np.isfinite(v) for h in shist for v in h.values()), f"non-finite RMSE: {shist}")
    check(bool(torch.isfinite(sstate.x).all()) and bool(torch.isfinite(sstate.theta).all()),
          "non-finite SGD factors")
    check(all(b < a for a, b in zip(train, train[1:])), f"SGD train RMSE did not fall: {train}")

    # the slot plans (as sgd_train built them), timed and counted; one epoch's
    # stacked set calls and planned set calls at the trained factors, kernel vs plain
    gt = sgd.grid_triplet(grid, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = sgd.build_set_plans(gt, grid)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    n_units = sum(pl.units.shape[0] for pl in plans)
    log(f"  SGD slot plans (P={P}): built in {plan_s:.3f} s (host clock, on the card), "
        f"{sum(pl.nbytes for pl in plans)} B; per epoch {sum(pl.rows.numel() for pl in plans)} "
        f"entries, {n_units} units, largest unit {max(int(pl.units[:, 2].max()) for pl in plans)} "
        f"rows, largest group {max((int(pl.splits[:, 3].max()) for pl in plans), default=0)} "
        f"rows; slots per set {[pl.n_slots for pl in plans]}, with split groups "
        f"{[int((pl.split_offs.diff() > 0).sum()) for pl in plans]}")
    idx, val, cnt = gt
    ar = torch.arange(g, device=dev)
    offs = (torch.arange(g, dtype=torch.int32, device=dev) * nb)[:, None, None]
    tb = sstate.theta.reshape(g, nb, f)
    lr0 = sgd.epoch_lr(scfg, 0)
    sets, sgd_ops, sgd_bytes, err["sgd"], live_all = [], 0.0, 0.0, 0.0, 0
    for s_ in range(g):
        j = (ar + s_) % g
        sets.append((sstate.x, tb[j].reshape(g * nb, f),
                     (idx[ar, j] + offs).reshape(g * mb, K), val[ar, j].reshape(g * mb, K),
                     cnt[ar, j].reshape(g * mb)))
        live = int(sets[-1][4].sum())
        live_all += live
        sgd_ops += 6 * f * live
        sgd_bytes += 2 * sstate.x.numel() * 4 + 2 * tb.numel() * 4 + live * 8 + g * mb * 4
    def sgd_close(x1, t1, x0, t0_):
        return (torch.allclose(x1, x0, atol=SGD_TOL, rtol=SGD_TOL)
                and torch.allclose(t1, t0_, atol=SGD_TOL, rtol=SGD_TOL))

    def sgd_diff(x1, t1, x0, t0_):
        return max((x1 - x0).abs().max().item(), (t1 - t0_).abs().max().item())

    for s_, (a, pl) in enumerate(zip(sets, plans)):
        j = (ar + s_) % g
        x0, t0_ = sgd_tile_plain(*a, lr0, spec.lam)
        x1, t1 = sgd_tile_cuda(*a, lr0, spec.lam)
        e = sgd_diff(x1, t1, x0, t0_)
        check(sgd_close(x1, t1, x0, t0_),
              f"sgd_tile disagrees with its plain version on set {s_} at full width")
        del x1, t1
        # the main path's call: the set's plan in global ids, in place on
        # the whole X and Theta; held against the independent plain result
        # (Theta's blocks in the set's order) and against the planned mirror
        x1, t1 = sstate.x.clone(), sstate.theta.clone()
        sgd_update.sgd_tile_planned_(x1, t1, pl, lr0, spec.lam)
        t1_set = t1.reshape(g, nb, f)[j].reshape(g * nb, f)
        e2 = sgd_diff(x1, t1_set, x0, t0_)
        check(sgd_close(x1, t1_set, x0, t0_),
              f"the planned in-place call disagrees with the plain version on set {s_}")
        del x0, t0_, t1_set
        x0, t0_ = kref.sgd_tile_planned_plain(sstate.x, sstate.theta, pl, lr0, spec.lam)
        e3 = sgd_diff(x1, t1, x0, t0_)
        log(f"  set {s_}: {int(a[4].sum())} live ratings, max abs err: kernel vs plain {e:.3g}, "
            f"planned in place vs plain {e2:.3g}, vs planned plain {e3:.3g}")
        check(sgd_close(x1, t1, x0, t0_),
              f"sgd_tile disagrees with its planned plain version on set {s_} at full width")
        err["sgd"] = max(err["sgd"], e, e2, e3)
        del x1, t1, x0, t0_
    # the kernel per epoch on prebuilt plans (the plans' build not counted)
    xc, tc = sstate.x.clone(), sstate.theta.clone()
    sgd_ms = cuda_ms(torch, lambda: [sgd_update.sgd_tile_planned_(xc, tc, pl, lr0, spec.lam)
                                     for pl in plans])
    sgd_plain_ms = cuda_ms(torch, lambda: [sgd_tile_plain(*a, lr0, spec.lam) for a in sets])
    gb, gb_by = bound(sgd_ops, sgd_bytes)
    floor_ms = live_all * 8 * f / PEAK_HBM_BYTES * 1e3
    log(f"per SGD epoch at quarter-Netflix: sgd_tile {sgd_ms:.3f} ms on prebuilt plans "
        f"({g} calls, {sgd_cuda_launches / scfg.epochs:g} CUDA launches; plain {sgd_plain_ms:.2f}, "
        f"bound {gb:.3f} by {gb_by}, x read+write floor {floor_ms:.3f}); "
        f"no single PyTorch call computes the slot loop, so no library time")
    kernels.append(
        {"name": "sgd_tile", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sgd_update.cu",
         "replaces": "src/repro/kernels/sgd_update.py:81",
         "launches": counts["sgd_tile"], "cuda_launches": sgd_cuda_launches,
         "max_abs_err": err["sgd"],
         "ms": sgd_ms, "plain_ms": sgd_plain_ms, "bound_ms": gb,
         "bound_by": gb_by, "library_ms": None})
    del sets, plans, gt, idx, val, cnt, train_eval, r_full, xc, tc
    p8 = {"grid": grid, "state": sstate, "hist": shist, "cfg": scfg,
          "epoch_ms": epoch_ms, "eval_ms": eval_ms, "sgd_ms": sgd_ms}

    # -- 9. Fig. 7: device-memory vs register accumulator, largest user bin ----------
    b = max(rb.bins, key=lambda e: e.m)
    idx, val, cnt = triplet(b)
    diag = torch.where(cnt > 0, spec.lam * cnt.float(), torch.ones_like(cnt, dtype=torch.float32))
    reset_counts()
    A, B = herm_hbm_accum_cuda(state.theta, idx, val, cnt, diag, tk=32)
    torch.cuda.synchronize()
    counts["herm_hbm_accum"] = read_counts("Fig. 7", ("herm_hbm_accum",))["herm_hbm_accum"]
    A1, B1 = fused_herm_cuda(state.theta, idx, val, cnt, diag)
    ea, eb = (A - A1).abs().max().item(), (B - B1).abs().max().item()
    log(f"Fig. 7 bin K={b.K}, {b.m} rows, {b.nnz} ratings: herm_hbm_accum vs fused_herm "
        f"max|dA|={ea:.3g} max|dB|={eb:.3g}")
    check(torch.allclose(A, A1, atol=HERM_ATOL, rtol=HERM_RTOL)
          and torch.allclose(B, B1, atol=HERM_ATOL, rtol=HERM_RTOL),
          "herm_hbm_accum disagrees with fused_herm")
    del A1, B1
    step = max(1, PLAIN_CHUNK_ELEMS // (b.K * f))
    chunks = [slice(lo, lo + step) for lo in range(0, b.m, step)]
    err["hbm"], hbm_plain_ms, hbm_lib_ms = 0.0, 0.0, 0.0
    for sl in chunks:
        A0, B0 = herm_hbm_accum_plain(state.theta, idx[sl], val[sl], cnt[sl], diag[sl], tk=32)
        check(torch.allclose(A[sl], A0, atol=HERM_ATOL, rtol=HERM_RTOL)
              and torch.allclose(B[sl], B0, atol=HERM_ATOL, rtol=HERM_RTOL),
              "herm_hbm_accum disagrees with its plain version")
        err["hbm"] = max(err["hbm"], (A[sl] - A0).abs().max().item(),
                         (B[sl] - B0).abs().max().item())
        del A0, B0
        hbm_plain_ms += cuda_ms(torch, lambda sl=sl: herm_hbm_accum_plain(
            state.theta, idx[sl], val[sl], cnt[sl], diag[sl], tk=32))
        g_ = state.theta[idx[sl].long()]
        gm = g_ * kref.mask_from_cnt(cnt[sl], b.K)[..., None]
        hbm_lib_ms += cuda_ms(torch, lambda: torch.bmm(gm.transpose(1, 2), g_))
        del g_, gm
    del A, B
    hbm_ms = cuda_ms(torch, lambda: herm_hbm_accum_cuda(state.theta, idx, val, cnt, diag, tk=32))
    reg_ms = cuda_ms(torch, lambda: fused_herm_cuda(state.theta, idx, val, cnt, diag))
    hb9, hb9_by = bound(b.nnz * (f * (f + 1) + 2 * f),
                        state.theta.numel() * 4 + b.nnz * 8 + b.m * 8 + b.m * (f * f + f) * 4)
    log(f"Fig. 7 on this card: accumulator in device memory (tk=32, "
        f"{-(-b.K // 32)} bins) {hbm_ms:.2f} ms, in registers (fused_herm) {reg_ms:.2f} ms: "
        f"{hbm_ms / reg_ms:.2f}x (the paper reports 2.5x); plain {hbm_plain_ms:.2f} ms, "
        f"bmm {hbm_lib_ms:.2f} ms, bound {hb9:.2f} ms by {hb9_by}")
    kernels.append(
        {"name": "herm_hbm_accum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/herm_hbm_accum.cu",
         "replaces": "src/repro/kernels/hermitian.py:140",
         "launches": counts["herm_hbm_accum"], "max_abs_err": err["hbm"],
         "ms": hbm_ms, "plain_ms": hbm_plain_ms, "bound_ms": hb9,
         "bound_by": hb9_by, "library_ms": hbm_lib_ms})

    del idx, val, cnt, diag

    # -- 10a. out-of-core streaming ALS, netflix-mini --------------------------------
    def check_ledger(tel, what: str) -> None:
        summary = validate_ledger(tel.ledger)
        bad = [r_["name"] for r_ in tel.ledger["records"] if not r_["ok"]]
        check(summary["ok"] and not bad, f"{what}: ledger records fail: {bad}")

    def plan_store(store, m_, nnz, f_, q, hbm, depth=2):
        fill = (dict(bin_fills=store.bin_fill_pairs()) if store.n_bins > 1
                else dict(fill=store.worst_fill))
        return plan_for(m_, store.n, nnz, f_, p=1, q=q, n_data=1,
                        eps=store.n * (f_ * f_ + 3 * f_ + 1) * 4, buffers=depth + 2,
                        hbm_bytes=hbm, **fill)

    spec = synth.SynthSpec("netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)
    r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=2, noise=0.1)
    cfg = als.AlsConfig(f=spec.f, lam=spec.lam, iters=3)
    check(cfg.mode == "kernel", f"default mode on the card is {cfg.mode}")
    st0 = als.als_init(r.m, rt.m, cfg)
    _, ref_hist = als.als_train(triplet(r), triplet(rt), r.m, rt.m, cfg,
                                test=triplet(rte), init=st0)
    streams = {}
    launches = {"fused_herm": 0, "batch_solve": 0}

    def fresh_init(store):      # the driver writes solved rows into its factors
        x0 = np.zeros((store.m_pad, spec.f), np.float32)
        x0[:r.m] = st0.x.cpu().numpy()
        return FactorStore.from_arrays(x0, st0.theta)

    for name, n_bins in (("uniform", 1), ("binned", 4)):
        store = RatingStore(r, q=4, n_bins=n_bins)
        sched = build_schedule(plan_store(store, r.m, r.nnz, spec.f, 4, 1 << 30),
                               r.m, rt.m, n_data=1)
        reset_counts()
        fac, shist, tel = run_streaming_als(store, sched, cfg, factors=fresh_init(store),
                                            train_eval=triplet(r), test_eval=triplet(rte))
        torch.cuda.synchronize()
        c10 = read_counts(f"netflix-mini streaming {name}")
        for k_ in launches:
            launches[k_] += c10[k_]
        check_ledger(tel, f"netflix-mini streaming {name}")
        d_rmse = max(max(abs(a["train_rmse"] - b["train_rmse"]),
                         abs(a["test_rmse"] - b["test_rmse"]))
                     for a, b in zip(shist, ref_hist))
        log(f"netflix-mini streaming {name} (q=4, {len(sched.waves)} waves per half): "
            f"test RMSE {[round(h['test_rmse'], 5) for h in shist]}, max |dRMSE| vs "
            f"in-core {d_rmse:.3g}; {tel.waves_run} waves, {tel.bytes_streamed} B streamed, "
            f"ledger {len(tel.ledger['records'])} records all ok")
        check(len(shist) == len(ref_hist) and d_rmse <= STREAM_RMSE_TOL,
              f"netflix-mini streaming {name} RMSE is {d_rmse} from in-core")
        streams[name] = (store, sched, fac)
    fu, fb = streams["uniform"][2], streams["binned"][2]
    dfac = max(np.abs(fb.x - fu.x).max(), np.abs(fb.theta - fu.theta).max())
    log(f"netflix-mini streaming binned vs uniform: max |dfactor| {dfac:.3g}")
    check(dfac <= BINNED_TOL, f"binned streaming factors {dfac} from uniform")
    store, sched, fac = streams["uniform"]
    for kill in (3, 6):
        with tempfile.TemporaryDirectory() as ck:
            try:
                run_streaming_als(store, sched, cfg, factors=fresh_init(store), ckpt_dir=ck,
                                  fail_after_waves=kill)
                fail(f"the kill after wave {kill} did not fire")
            except SimulatedFailure:
                pass
            rfac, _, rtel = run_streaming_als(store, sched, cfg, ckpt_dir=ck)
        same = (torch.equal(torch.from_numpy(rfac.x), torch.from_numpy(fac.x))
                and torch.equal(torch.from_numpy(rfac.theta), torch.from_numpy(fac.theta)))
        log(f"netflix-mini kill after wave {kill}, resume from step "
            f"{rtel.resumed_from_step}: factors bit-equal to the uninterrupted run: {same}")
        check(same and rtel.resumed_from_step == kill,
              f"resume after a kill at wave {kill} is not bit-equal")

    # streaming SGD on netflix-mini (g=4, two tiles a wave), kernel mode
    def check_resumed_ledger(tel, what: str) -> None:
        # worst_fill_bound holds the grid's fill against the fill of the
        # waves this run streamed; after a resume mid-epoch that part of an
        # epoch can pad more than the whole grid (the reference's record)
        validate_ledger(tel.ledger)             # raises on a malformed ledger
        bad = [r_["name"] for r_ in tel.ledger["records"]
               if not r_["ok"] and r_["name"] != "worst_fill_bound"]
        wf = next(r_ for r_ in tel.ledger["records"] if r_["name"] == "worst_fill_bound")
        log(f"  {what}: worst_fill_bound predicted {wf['predicted']:.4f} measured "
            f"{wf['measured']:.4f} ok {wf['ok']}")
        check(not bad, f"{what}: ledger records fail: {bad}")

    def same_factors(a, b) -> bool:
        return (torch.equal(torch.from_numpy(a.x), torch.from_numpy(b.x))
                and torch.equal(torch.from_numpy(a.theta), torch.from_numpy(b.theta)))

    launches["sgd_tile"] = 0
    mini_test = triplet(rte)
    mcfg = sgd.SgdConfig(f=spec.f, lam=spec.lam, lr=0.1, epochs=2, seed=3,
                         schedule="inverse_time", decay=1.0)
    check(mcfg.mode == "kernel", f"default SGD mode on the card is {mcfg.mode}")
    mgrid = blocking.block_ell(r, g=4)
    minc, minc_hist = sgd.sgd_train(mgrid, mcfg, test=mini_test)
    sstreams = {}
    for name, kw in (("uniform", {}), ("per-tile-K", dict(per_tile_k=True))):
        g_ = blocking.block_ell(r, g=4, **kw)
        tiles_, ssched_ = TileStore(g_), build_sgd_schedule(g_, spec.f, n_workers=2)
        reset_counts()
        sfac, sh, stel = run_streaming_sgd(tiles_, ssched_, mcfg, test_eval=mini_test)
        torch.cuda.synchronize()
        launches["sgd_tile"] += read_counts(f"netflix-mini streaming SGD {name}",
                                            ("sgd_tile",))["sgd_tile"]
        check_ledger(stel, f"netflix-mini streaming SGD {name}")
        dx = max(np.abs(sfac.x - minc.x.cpu().numpy()).max(),
                 np.abs(sfac.theta - minc.theta.cpu().numpy()).max())
        d_rmse = max(abs(a["test_rmse"] - b["test_rmse"]) for a, b in zip(sh, minc_hist))
        log(f"netflix-mini streaming SGD {name} (g=4, {ssched_.waves_per_epoch} waves an "
            f"epoch, tile K {sorted(set(g_.tile_K.ravel().tolist())) if g_.tile_K is not None else g_.K}): "
            f"test RMSE {[round(h['test_rmse'], 5) for h in sh]}; vs in-core sgd_train "
            f"max |dfactor| {dx:.3g}, max |dRMSE| {d_rmse:.3g}; {stel.waves_run} waves, "
            f"{stel.bytes_streamed} B streamed, ledger {len(stel.ledger['records'])} records all ok")
        check(len(sh) == len(minc_hist) and dx <= SGD_TOL and d_rmse <= 1e-3,
              f"netflix-mini streaming SGD {name} is {dx} / {d_rmse} from in-core")
        sstreams[name] = (tiles_, ssched_, sfac)
    same = same_factors(sstreams["per-tile-K"][2], sstreams["uniform"][2])
    log(f"netflix-mini streaming SGD per-tile-K vs uniform: bit-equal {same}")
    check(same, "per-tile-K streaming SGD is not bit-equal to uniform")
    tiles_, ssched_, sfac = sstreams["uniform"]
    for kill in (3, 11):
        with tempfile.TemporaryDirectory() as ck:
            try:
                run_streaming_sgd(tiles_, ssched_, mcfg, ckpt_dir=ck, fail_after_waves=kill)
                fail(f"the SGD kill after wave {kill} did not fire")
            except SimulatedFailure:
                pass
            rfac, _, rtel = run_streaming_sgd(tiles_, ssched_, mcfg, ckpt_dir=ck)
        same = same_factors(rfac, sfac)
        log(f"netflix-mini streaming SGD kill after wave {kill}, resume from step "
            f"{rtel.resumed_from_step}: factors bit-equal to the uninterrupted run: {same}")
        check(same and rtel.resumed_from_step == kill,
              f"streaming SGD resume after a kill at wave {kill} is not bit-equal")
        check_resumed_ledger(rtel, f"netflix-mini streaming SGD resumed at wave {kill}")
    hstore = RatingStore(r, q=4)
    hsched = build_schedule(plan_store(hstore, r.m, r.nnz, spec.f, 4, 1 << 30), r.m, rt.m,
                            n_data=1)
    hcfg = als.AlsConfig(f=spec.f, lam=spec.lam, iters=2)
    with tempfile.TemporaryDirectory() as ck:
        reset_counts()
        hfac, hh, htel = hybrid.run_streaming_hybrid(
            hstore, hsched, tiles_, ssched_, hcfg, mcfg, test_eval=mini_test, ckpt_dir=ck)
        torch.cuda.synchronize()
        c10 = read_counts("netflix-mini streaming hybrid", ("fused_herm", "batch_solve",
                                                            "sgd_tile"))
        for k_ in launches:
            launches[k_] += c10[k_]
        check_ledger(htel, "netflix-mini streaming hybrid")
        hfac2, hh2, htel2 = hybrid.run_streaming_hybrid(
            hstore, hsched, tiles_, ssched_, hcfg, mcfg, test_eval=mini_test, ckpt_dir=ck)
    tags = [h["phase"] for h in hh]
    same = same_factors(hfac2, hfac)
    log(f"netflix-mini streaming hybrid: phases {tags}, test RMSE "
        f"{[round(h['test_rmse'], 5) for h in hh]}; {htel.waves_run} waves "
        f"({htel.phases['als'].waves_run} ALS, {htel.phases['sgd'].waves_run} SGD), "
        f"{htel.bytes_streamed} B streamed; restart: {len(hh2)} records, phases "
        f"{sorted(htel2.phases)}, factors bit-equal {same}")
    check(tags == ["als"] * 2 + ["sgd"] * 2, f"streaming hybrid phases {tags}")
    check(hh[2]["test_rmse"] < hh[0]["test_rmse"],
          "the streaming hybrid's first SGD epoch is not below the cold ALS start")
    check(hh2 == [] and "als" not in htel2.phases and same,
          "the streaming hybrid's restart did not skip ALS with bit-equal factors")
    del minc, mgrid, sstreams, hstore, hfac, hfac2, mini_test

    # -- 10b. streaming ALS at quarter-Netflix, f=100, capped device ----------------
    spec = synth.SynthSpec("netflix/4", m=120_047, n=17_770, nnz=24_750_000,
                           f=100, lam=0.05)
    cap = int(1.5 * 2**30)
    depth = 2
    r_full = rb.to_padded()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    vm0 = rss_now()
    q = 8
    while True:
        t0 = time.perf_counter()
        store = RatingStore(r_full, q=q, n_bins=8)
        build_s = time.perf_counter() - t0
        plan = plan_store(store, r_full.m, r_full.nnz, spec.f, q, cap, depth)
        log(f"quarter-Netflix streaming store q={q}: built in {build_s:.2f} s; "
            f"plan {plan.describe()}")
        if plan.fits or q >= 1024:
            break
        q *= 2
    check(plan.fits, f"no q up to {q} fits the {cap} B budget")
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    vm1 = rss_now()
    sched = build_schedule(plan, r_full.m, r_full.n_cols, n_data=1)
    log(f"  schedule: {sched.describe()}; host peak RSS {rss0 / 2**20:.2f} GiB before the "
        f"store, {rss1 / 2**20:.2f} GiB after (a high-water mark of the whole process); "
        f"current RSS {vm0} B before the store, {vm1} B after ({(vm1 - vm0) / 2**30:.3f} GiB "
        f"added by the store); store host arrays {store.host_nbytes} B "
        f"(the reference's layout, uniform R^T included), fills {store.fill_breakdown()}")
    check(len(sched.waves) >= 8, f"only {len(sched.waves)} waves per half")
    cfg = als.AlsConfig(f=spec.f, lam=spec.lam, iters=3, seed=0)
    train_eval = triplet(r_full)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)]
    walls = [time.perf_counter()]

    def on_wave_iteration(it, rec):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter())

    reset_counts()
    marks[0].record()
    fac, shist, tel = run_streaming_als(store, sched, cfg, prefetch_depth=depth,
                                        train_eval=train_eval, test_eval=test,
                                        callback=on_wave_iteration)
    torch.cuda.synchronize()
    c10 = read_counts("quarter-Netflix streaming")
    for k_ in launches:
        launches[k_] += c10[k_]
    alloc_peak = torch.cuda.max_memory_allocated() - resident
    check_ledger(tel, "quarter-Netflix streaming")
    s_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(cfg.iters)]
    for h, ms, w0, w1, h0, ms0 in zip(shist, s_ms, walls, walls[1:], incore_hist,
                                      incore_iter_ms):
        log(f"  streaming iteration {h['iteration']}: {ms:.1f} ms on the card "
            f"({w1 - w0:.3f} s wall; in-core {ms0:.1f} ms) train RMSE "
            f"{h['train_rmse']:.5f} (in-core {h0['train_rmse']:.5f}) test RMSE "
            f"{h['test_rmse']:.5f} (in-core {h0['test_rmse']:.5f})")
    d_rmse = max(max(abs(a["train_rmse"] - b["train_rmse"]), abs(a["test_rmse"] - b["test_rmse"]))
                 for a, b in zip(shist, incore_hist))
    check(len(shist) == len(incore_hist) and d_rmse <= STREAM_RMSE_TOL,
          f"quarter-Netflix streaming RMSE is {d_rmse} from in-core")
    ps = tel.phase_seconds
    per_it = tel.bytes_streamed / cfg.iters
    log(f"  max |dRMSE| vs in-core {d_rmse:.3g}; {tel.waves_run} waves; "
        f"{tel.bytes_streamed} B streamed ({per_it:.0f} B per iteration: "
        f"{per_it / (sum(s_ms) / cfg.iters) / 1e6:.2f} GB/s over the iteration on the "
        f"card's clock, {tel.bytes_streamed / max(ps.get('prefetch_load', 0.0), 1e-9) / 1e9:.2f}"
        f" GB/s over the worker's load time)")
    log("  phase seconds: " + ", ".join(f"{k_} {v:.4f}" for k_, v in sorted(ps.items())))
    log(f"  prefetch stall {ps.get('prefetch', 0.0):.4f} s = "
        f"{ps.get('prefetch', 0.0) / ps['driver'] * 100:.1f} % of the run "
        f"({ps['driver']:.4f} s); overlapped load {ps.get('prefetch_load', 0.0):.4f} s")
    log(f"  device memory: allocator peak over the resident {resident} B: {alloc_peak} B "
        f"({alloc_peak / 2**30:.3f} GiB); schedule capacity {sched.capacity_bytes} B "
        f"({sched.capacity_bytes / 2**30:.3f} GiB); modelled meter peak {tel.peak_bytes} B "
        f"({tel.peak_bytes / 2**30:.3f} GiB); allocator/capacity "
        f"{alloc_peak / sched.capacity_bytes:.3f}")
    check(alloc_peak <= sched.capacity_bytes,
          f"streaming ALS allocator peak {alloc_peak} B exceeds the schedule's capacity "
          f"{sched.capacity_bytes} B")
    log(render_ledger(tel.ledger))
    check(bool(np.isfinite(fac.x).all() and np.isfinite(fac.theta).all()),
          "non-finite streaming factors")

    # the path's two kernels against their plain versions at the shapes this
    # run gave them, from its store, schedule and final factors (launched
    # after the counts were read): every bin of solve-X wave 0, every bin of
    # every batch of the accumulate-Theta half (x_dev of one batch's rows,
    # in-batch K, the heavy items split), and the accumulated systems' solve
    serr = {"herm": 0.0, "solve": 0.0}

    def herm_vs_plain(fixed, idx, val, cnt, diag, what, err=serr):
        A, B = fused_herm_cuda(fixed, idx, val, cnt, diag)
        step = max(1, PLAIN_CHUNK_ELEMS // (idx.shape[1] * fixed.shape[1]))
        for lo in range(0, idx.shape[0], step):
            sl = slice(lo, lo + step)
            A0, B0 = fused_herm_plain(fixed, idx[sl], val[sl], cnt[sl], diag[sl])
            check(torch.allclose(A[sl], A0, atol=HERM_ATOL, rtol=HERM_RTOL)
                  and torch.allclose(B[sl], B0, atol=HERM_ATOL, rtol=HERM_RTOL),
                  f"fused_herm disagrees with its plain version on {what}")
            err["herm"] = max(err["herm"], (A[sl] - A0).abs().max().item(),
                              (B[sl] - B0).abs().max().item())
            del A0, B0
        return A, B

    def solve_vs_plain(A, B, what, err=serr):
        x1, x0 = batch_solve_cuda(A, B), batch_solve_plain(A, B)
        check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL),
              f"batch_solve disagrees with its plain version on {what}")
        err["solve"] = max(err["solve"], (x1 - x0).abs().max().item())
        return x1

    w0 = sched.waves[0]
    theta_dev = torch.from_numpy(fac.theta).to(dev)
    x_shapes = []
    for (idx, val, cnt), _rows in als._device_bins(
            store.x_slice_binned(w0.row_start, w0.row_stop), dev):
        diag = spec.lam * cnt.to(torch.float32)
        diag = torch.where(cnt > 0, diag, torch.ones_like(diag))
        A, B = herm_vs_plain(theta_dev, idx, val, cnt, diag,
                             f"solve-X wave 0's bin K={idx.shape[1]}")
        solve_vs_plain(A, B, f"solve-X wave 0's bin K={idx.shape[1]}")
        x_shapes.append(tuple(idx.shape))
        del A, B
    f = spec.f
    A = torch.zeros((store.n, f, f), dtype=torch.float32, device=dev)
    B = torch.zeros((store.n, f), dtype=torch.float32, device=dev)
    c = torch.zeros((store.n,), dtype=torch.float32, device=dev)
    t_calls, t_split, t_kmax = 0, 0, 0
    for wave in sched.waves:
        for b in wave.batches:
            x_dev = torch.from_numpy(fac.x[b.row_start:b.row_stop]).to(dev)
            for (idx, val, cnt), rows in als._device_bins(store.theta_batch_binned(b.index), dev):
                Ab, Bb = herm_vs_plain(x_dev, idx, val, cnt, spec.lam * cnt.to(torch.float32),
                                       f"batch {b.index}'s R^T bin K={idx.shape[1]}")
                A.index_add_(0, rows, Ab)
                B.index_add_(0, rows, Bb)
                c.index_add_(0, rows, cnt.to(torch.float32))
                t_calls += 1
                t_split += idx.shape[1] > S
                t_kmax = max(t_kmax, idx.shape[1])
                del Ab, Bb
    A.diagonal(dim1=-2, dim2=-1).add_((c <= 0).to(A.dtype)[:, None])
    theta1 = solve_vs_plain(A, B, f"the accumulated Theta systems (n={store.n})")
    dtheta = (theta1 - theta_dev).abs().max().item()
    log(f"  streaming shapes, kernel vs plain: solve-X wave 0 bins {x_shapes} (x_dev "
        f"{w0.rows} rows); accumulate-Theta {t_calls} bin calls over {len(sched.waves)} "
        f"batches of {sched.waves[0].batches[0].row_stop - sched.waves[0].batches[0].row_start}"
        f" rows, {t_split} split (K > {S}, largest K {t_kmax}); accumulated solve "
        f"n={store.n}: max|dA,dB| {serr['herm']:.3g}, max|dx| {serr['solve']:.3g}; "
        f"the re-accumulated Theta vs the run's: max|d| {dtheta:.3g} "
        f"(bit-equal: {torch.equal(theta1, theta_dev)})")
    check(t_split > 0, "no accumulate-Theta bin took fused_herm's split path")
    check(torch.allclose(theta1, theta_dev, atol=SOLVE_TOL, rtol=SOLVE_TOL),
          f"the re-accumulated Theta is {dtheta} from the streaming run's")
    for k in kernels:
        e = {"fused_herm": serr["herm"], "batch_solve": serr["solve"]}.get(k["name"])
        if e is not None:
            k["max_abs_err_streaming"] = e
            k["max_abs_err"] = max(k["max_abs_err"], e)
    del A, B, c, theta1, theta_dev, x_dev, idx, val, cnt, rows
    # one more iteration (warm, no evaluation) under torch.profiler: how
    # much of its wall time the card spends in kernels and in copies
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def busy_ms(spans) -> float:
        total, end = 0.0, float("-inf")
        for lo, hi in sorted(spans):
            if hi > end:
                total += hi - max(lo, end)
                end = hi
        return total / 1e3

    cfg1 = als.AlsConfig(f=spec.f, lam=spec.lam, iters=1, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run_streaming_als(store, sched, cfg1, prefetch_depth=depth,
                          factors=FactorStore.from_arrays(fac.x, fac.theta))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - w0) * 1e3
    kern, copies = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (copies if "memcpy" in e.name.lower() else kern).append(
                (e.time_range.start, e.time_range.end))
    kb, cb = busy_ms(kern), busy_ms(copies)
    if kern:
        log(f"  profiled streaming iteration (warm, no evaluation, profiler on): "
            f"{prof_ms:.1f} ms wall; {len(kern)} kernels busy {kb:.1f} ms "
            f"({kb / prof_ms * 100:.1f} %), {len(copies)} copies busy {cb:.1f} ms; "
            f"kernels idle {100 - kb / prof_ms * 100:.1f} % of the wall time")
    else:
        log(f"  profiled streaming iteration: {prof_ms:.1f} ms wall; device idle share "
            f"not measured (the profiler returned no device events)")
    del train_eval

    # -- 10c. streaming SGD at quarter-Netflix, f=100, one tile a wave -------------
    grid8, scfg8 = p8["grid"], p8["cfg"]
    g8, mb8, nb8, K8 = grid8.g, grid8.mb, grid8.nb, grid8.K
    tiles8 = TileStore(grid8)
    ssched8 = build_sgd_schedule(grid8, f, n_workers=1, prefetch_depth=depth)
    tile_b = mb8 * K8 * 8 + mb8 * 4                 # one tile's idx, val, cnt
    blocks_b = (mb8 + nb8) * f * 4                  # its two factor blocks
    log(f"quarter-Netflix streaming SGD: {ssched8.describe()}; a tile {tile_b} B, its factor "
        f"blocks {blocks_b} B; capacity ({depth} + 2) x {tile_b} + 2 x {blocks_b} = "
        f"{ssched8.capacity_bytes} B")
    check(ssched8.waves_per_epoch == g8 * g8 and
          ssched8.capacity_bytes == (depth + 2) * tile_b + 2 * blocks_b,
          f"streaming SGD schedule: {ssched8.describe()}")
    # each wave's slot plan built alone, as the driver builds it (on the card
    # from the uploaded tile): time, bytes, and the allocator's peak
    waves8 = ssched8.epoch_waves(range(g8))

    def upload_tile(i, j):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)
                     for a in tiles8.tile_triplet(i, j))

    sgd_driver.wave_plan(*upload_tile(*waves8[0].tiles[0]), nb8)       # warm-up
    plan_ms, plan_b, plan_peak, plan_peak_at = [], [], 0, None
    for w in waves8:
        trip = upload_tile(*w.tiles[0])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pl = sgd_driver.wave_plan(*trip, nb8)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        plan_b.append(pl.nbytes)
        peak_w = torch.cuda.max_memory_allocated() - base
        if plan_peak_at is None or peak_w > plan_peak:
            plan_peak, plan_peak_at = peak_w, (w.tiles[0], int(trip[2].sum()))
        del trip, pl
    log(f"  slot plans, one a wave ({len(waves8)} waves, host clock around a synchronise): "
        f"build {np.mean(plan_ms):.2f} ms mean, {min(plan_ms):.2f}..{max(plan_ms):.2f} ms; "
        f"{np.mean(plan_b):.0f} B mean, {min(plan_b)}..{max(plan_b)} B; the allocator's "
        f"peak of building one alone at most {plan_peak} B ({plan_peak / 2**20:.1f} MiB, "
        f"tile {plan_peak_at[0]}, {plan_peak_at[1]} ratings; the int64 build peaked at "
        f"{PLAN_PEAK_INT64} B)")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)]
    walls = [time.perf_counter()]

    def on_sgd_epoch(factors, rec):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter())

    reset_counts()
    marks[0].record()
    sfac8, sh8, stel8 = run_streaming_sgd(tiles8, ssched8, scfg8, prefetch_depth=depth,
                                          callback=on_sgd_epoch)
    torch.cuda.synchronize()
    launches["sgd_tile"] += read_counts("quarter-Netflix streaming SGD",
                                        ("sgd_tile",))["sgd_tile"]
    salloc = torch.cuda.max_memory_allocated() - resident
    check_ledger(stel8, "quarter-Netflix streaming SGD")
    brec = next(r_ for r_ in stel8.ledger["records"] if r_["name"] == "bytes_streamed")
    per_ep = len(waves8) * (tile_b + blocks_b)
    check(brec["check"] == "exact" and brec["measured"] == brec["predicted"]
          == scfg8.epochs * per_ep == stel8.bytes_streamed,
          f"streaming SGD bytes {brec} against {scfg8.epochs} x {per_ep}")
    se_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(scfg8.epochs)]
    st8 = p8["state"]
    dx8 = max((torch.from_numpy(sfac8.x).to(dev) - st8.x).abs().max().item(),
              (torch.from_numpy(sfac8.theta).to(dev) - st8.theta).abs().max().item())
    bit8 = (torch.equal(torch.from_numpy(sfac8.x).to(dev), st8.x)
            and torch.equal(torch.from_numpy(sfac8.theta).to(dev), st8.theta))
    x_eval = sfac8.x[grid8.user_inv] if grid8.user_perm is not None else sfac8.x[:grid8.m]
    s_rmse = float(als.rmse_padded(torch.from_numpy(np.ascontiguousarray(x_eval)).to(dev),
                                   torch.from_numpy(sfac8.theta[:grid8.n]).to(dev), *test))
    p8_noeval = [ms - p8["eval_ms"] for ms in p8["epoch_ms"]]
    ps = stel8.phase_seconds
    for h, ms, w0, w1, ms8 in zip(sh8, se_ms, walls, walls[1:], p8_noeval):
        log(f"  streaming SGD epoch {h['epoch']} (lr {h['lr']:.5g}): {ms:.1f} ms on the card "
            f"({w1 - w0:.3f} s wall); phase 8's epoch without its evaluation {ms8:.1f} ms")
    log(f"  phase 8's sgd_tile on prebuilt plans {p8['sgd_ms']:.3f} ms an epoch; streamed "
        f"{stel8.bytes_streamed} B ({per_ep} B an epoch: {per_ep / np.mean(se_ms[1:]) / 1e6:.2f} "
        f"GB/s over epochs 2-3 on the card's clock); {stel8.waves_run} waves, "
        f"{sum(plan_b)} B of slot plans an epoch")
    log("  phase seconds: " + ", ".join(f"{k_} {v:.4f}" for k_, v in sorted(ps.items())))
    log(f"  prefetch stall {ps.get('prefetch', 0.0):.4f} s = "
        f"{ps.get('prefetch', 0.0) / ps['driver'] * 100:.1f} % of the run "
        f"({ps['driver']:.4f} s); overlapped load {ps.get('prefetch_load', 0.0):.4f} s")
    log(f"  final factors vs phase 8's: max |d| {dx8:.3g} (bit-equal: {bit8}); test RMSE "
        f"{s_rmse:.5f} (phase 8: {p8['hist'][-1]['test_rmse']:.5f})")
    log(f"  device memory: allocator peak over the resident {resident} B: {salloc} B "
        f"({salloc / 2**20:.1f} MiB); schedule capacity {ssched8.capacity_bytes} B; slot plan "
        f"peak {plan_peak} B; capacity + plan peak {ssched8.capacity_bytes + plan_peak} B; "
        f"modelled meter peak {stel8.peak_bytes} B; largest plan {max(plan_b)} B")
    log(render_ledger(stel8.ledger))
    check(dx8 <= SGD_TOL, f"streaming SGD factors {dx8} from phase 8's")
    check(abs(s_rmse - p8["hist"][-1]["test_rmse"]) <= 1e-3,
          f"streaming SGD test RMSE {s_rmse} from phase 8's")
    check(salloc <= ssched8.capacity_bytes + plan_peak,
          f"streaming SGD allocator peak {salloc} B exceeds the capacity "
          f"{ssched8.capacity_bytes} B plus the plan's peak {plan_peak} B")
    # the kernel at the waves' own shapes: the first wave of each set, from
    # the run's store and final factors, against both plain versions (these
    # launches come after the counts were read)
    lr8 = sgd.epoch_lr(scfg8, 0)
    serr["sgd"] = 0.0
    for s_ in range(g8):
        i, j = ssched8.set_waves[s_][0].tiles[0]
        idx_, val_, cnt_ = upload_tile(i, j)
        xw = torch.from_numpy(sfac8.x[i * mb8:(i + 1) * mb8]).to(dev)
        tw = torch.from_numpy(sfac8.theta[j * nb8:(j + 1) * nb8]).to(dev)
        pl = sgd_driver.wave_plan(idx_, val_, cnt_, nb8)
        x1, t1 = xw.clone(), tw.clone()
        sgd_update.sgd_tile_planned_(x1, t1, pl, lr8, scfg8.lam)
        for name, (x0, t0_) in (("planned plain", kref.sgd_tile_planned_plain(
                                    xw, tw, pl, lr8, scfg8.lam)),
                                ("plain", sgd_tile_plain(xw, tw, idx_[0], val_[0], cnt_[0],
                                                         lr8, scfg8.lam))):
            e = max((x1 - x0).abs().max().item(), (t1 - t0_).abs().max().item())
            serr["sgd"] = max(serr["sgd"], e)
            check(torch.allclose(x1, x0, atol=SGD_TOL, rtol=SGD_TOL)
                  and torch.allclose(t1, t0_, atol=SGD_TOL, rtol=SGD_TOL),
                  f"sgd_tile_planned_ disagrees with its {name} version on tile ({i}, {j})")
        log(f"  set {s_} wave 0, tile ({i}, {j}): {int(cnt_.sum())} ratings, {pl.n_slots} "
            f"slots, {pl.units.shape[0]} units; kernel vs planned plain and plain: max abs "
            f"err so far {serr['sgd']:.3g}")
        del idx_, val_, cnt_, xw, tw, x1, t1, x0, t0_, pl
    for k in kernels:
        if k["name"] == "sgd_tile":
            k["max_abs_err_streaming"] = serr["sgd"]
            k["max_abs_err"] = max(k["max_abs_err"], serr["sgd"])
    del sfac8, tiles8

    # -- 10d. the layout autotuner on phase 10b's ratings ------------------------------
    q_ = store.q
    t0 = time.perf_counter()
    tres = autotune.tune_als_layout(r_full, q_, f=f)
    log(f"autotune, analytic ALS sweep (q={q_}, f={f}): {time.perf_counter() - t0:.2f} s "
        f"(host clock); winner {tres.config.to_obj()} at {tres.score} B an iteration")
    for c in tres.candidates:
        log(f"  n_bins={c['config']['n_bins']} k_multiple={c['config']['k_multiple']}: "
            f"{c['score']} B an iteration, fill {c['fill']:.4f}, eq. (8) "
            f"{c['bytes_per_device']} B a device")
    wcfg = tres.config
    if (wcfg.n_bins, wcfg.k_multiple) == (store.n_bins, store.k_multiple):
        wstore, wsched, reused = store, sched, "phase 10b's store"
    else:
        wstore = RatingStore(r_full, q=q_, n_bins=wcfg.n_bins, k_multiple=wcfg.k_multiple)
        wsched = build_schedule(plan_store(wstore, r_full.m, r_full.nnz, f, q_, cap, depth),
                                r_full.m, r_full.n_cols, n_data=1)
        reused = "a store built at that rung"
    wst = predicted_stream_stats(wstore, wsched, f)
    wbytes = sum(wst["x_bytes"]) + sum(wst["t_bytes"])
    log(f"  the winner's bytes against predicted_stream_stats of {reused}: {wbytes} B")
    check(wbytes == tres.score, f"the analytic winner prices {tres.score} B, its store "
          f"predicts {wbytes} B")
    del wstore, wsched
    reset_counts()
    t0 = time.perf_counter()
    mres = autotune.tune_als_layout(r_full, q_, f=f, mode="measured")
    torch.cuda.synchronize()
    log(f"autotune, measured ALS sweep: {time.perf_counter() - t0:.1f} s (host clock, "
        f"{len(mres.candidates)} stores built); winner {mres.config.to_obj()}")
    ctune = read_counts("autotune (measured)")
    for c in mres.candidates:
        log(f"  n_bins={c['config']['n_bins']} k_multiple={c['config']['k_multiple']}: "
            f"solve-X wave 0 {c['seconds'] * 1e3:.2f} ms (host clock around a synchronise), "
            f"{c['score']} B an iteration")
    t0 = time.perf_counter()
    gres = autotune.tune_sgd_layout(r_full, 4)
    log(f"autotune, SGD blocking sweep (g=4): {time.perf_counter() - t0:.1f} s (host clock); "
        f"winner {gres.config.to_obj()}; " + "; ".join(
            f"per_tile_k={c['config']['per_tile_k']} degree_sort={c['config']['degree_sort']}"
            f": {c['score']} slots, fill {c['fill']:.4f}" for c in gres.candidates))
    del gres
    with tempfile.TemporaryDirectory() as td:
        cpath = str(Path(td) / "tune_cache.json")
        s1 = RatingStore(r_full, q=q_, n_bins="auto", tune_cache=cpath)
        s2 = RatingStore(r_full, q=q_, n_bins="auto", tune_cache=cpath)
        cdata = json.loads(Path(cpath).read_text())
    centry = cdata["entries"].get(s1.tune["key"], {})
    log(f"  RatingStore(n_bins='auto') twice through one cache file: hits "
        f"{s1.tune['cache_hit']}, {s2.tune['cache_hit']}; n_bins {s1.n_bins}, {s2.n_bins}; "
        f"key {s1.tune['key']}; provenance {centry.get('provenance')}")
    check(not s1.tune["cache_hit"] and s2.tune["cache_hit"] and s1.n_bins == s2.n_bins
          and s1.tune["key"] == s2.tune["key"] and s1.tune["key"].endswith("|cuda")
          and cdata["schema"] == autotune.TUNECACHE_SCHEMA
          and centry.get("provenance", {}).get("backend") == "cuda",
          "the tune cache did not miss and then hit under the cuda backend tag")
    del s1, s2, store

    # -- 11. the multi-device path on cells that share one card --------------------
    from repro_torch.distributed import collectives as coll, su_als
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sparse.padded import partition_padded

    card = f"cuda:{torch.cuda.current_device()}"
    launches_mesh = {"fused_herm": 0, "batch_solve": 0, "sgd_tile": 0}

    def cells(shape, axes):
        mesh_ = make_mesh(shape, axes, devices=[card] * int(np.prod(shape)))
        log(f"  {mesh_.describe()}: {mesh_.size} cells share one card")
        return mesh_

    def count_mesh(phase: str, path) -> None:
        c = read_counts(phase, path)
        for k_ in launches_mesh:
            launches_mesh[k_] += c[k_]

    def fdiff(a, b) -> float:
        return max(float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))

    def plan_mesh(store, m_, nnz, f_, q, n_data, hbm, depth=2):
        fill = (dict(bin_fills=store.bin_fill_pairs()) if store.n_bins > 1
                else dict(fill=store.worst_fill))
        return plan_for(m_, store.n, nnz, f_, p=store.p, q=q, n_data=n_data, eps=0,
                        buffers=depth + 2, acc_bytes=streaming_acc_bytes(store.n, f_),
                        hbm_bytes=hbm, **fill)

    log(f"phase 11: the multi-device path, single-controller; every mesh's cells share "
        f"one card ({card}, {torch.cuda.get_device_name(0)}) and run one after another "
        f"on one stream: this checks results and launches, it measures no scaling")
    # 11a. netflix-mini: SU-ALS on two meshes against phase 4's single-device
    # kernel iteration and against plain mode; row blocks
    r, rt, spec = p4["r"], p4["rt"], p4["spec"]
    x0, t0_ = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in p4["init"])
    first = (p4["first"].x, p4["first"].theta)
    for name, shape, axes, schemes in (
            ("data=2 x model=4", (2, 4), ("data", "model"), ("one_phase",)),
            ("pod=2 x data=2 x model=2", (2, 2, 2), ("pod", "data", "model"),
             ("one_phase", "two_phase"))):
        mesh = cells(shape, axes)
        _, p_ = su_als.mesh_axes(mesh)
        rdev = su_als.shard_ratings(partition_padded(r, p_), mesh)
        rtdev = su_als.shard_ratings(partition_padded(rt, p_), mesh)
        for scheme in schemes:
            out = {}
            for mode in ("ref", "kernel"):
                _, _, it = su_als.make_su_als_fns(mesh, spec.lam, scheme=scheme, mode=mode)
                reset_counts()
                out[mode] = it(x0, t0_, rdev, rtdev)
                torch.cuda.synchronize()
                if mode == "kernel":
                    count_mesh(f"SU-ALS {name} {scheme}", ("fused_herm", "batch_solve"))
            d1, d0 = fdiff(out["kernel"], first), fdiff(out["kernel"], out["ref"])
            log(f"  SU-ALS {name} {scheme}, one iteration: max|d| vs phase 4's single-device "
                f"kernel iteration {d1:.3g}, vs this mesh in plain mode {d0:.3g}")
            check(d1 <= SU_TOL and d0 <= SU_TOL,
                  f"SU-ALS {name} {scheme} is {d1} / {d0} from single-device / plain")
        if len(shape) == 2:
            _, _, it_b = su_als.make_su_als_fns(mesh, spec.lam, row_block=64)
            reset_counts()
            blocked = it_b(x0, t0_, rdev, rtdev)
            torch.cuda.synchronize()
            count_mesh(f"SU-ALS {name} row_block=64", ("fused_herm", "batch_solve"))
            d = fdiff(blocked, out["kernel"])
            log(f"  SU-ALS {name} row_block=64 vs row_block=0: max|d| {d:.3g}")
            check(d <= MESH_TOL, f"SU-ALS row_block=64 is {d} from row_block=0")
    del rdev, rtdev, out, blocked

    # streaming mesh ALS on data=4 x model=2 (two fast domains: the reduce's
    # tree stage runs), uniform and binned, against in-core; kill and resume
    r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=2, noise=0.1)
    mesh42 = cells((4, 2), ("data", "model"))
    cfg = als.AlsConfig(f=spec.f, lam=spec.lam, iters=3)
    st0 = als.als_init(r.m, rt.m, cfg)
    inc, inc_hist = als.als_train(triplet(r), triplet(rt), r.m, rt.m, cfg,
                                  test=triplet(rte), init=st0)
    mstreams = {}
    for name, n_bins in (("uniform", 1), ("binned", 4)):
        store = RatingStore(r, q=8, p=2, n_bins=n_bins)
        sched = build_schedule(plan_mesh(store, r.m, r.nnz, spec.f, 8, 4, 1 << 30),
                               r.m, rt.m, n_data=4)
        x_st = np.zeros((store.m_pad, spec.f), np.float32)
        x_st[:r.m] = st0.x.cpu().numpy()
        reset_counts()
        fac, shist, tel = run_streaming_als(
            store, sched, cfg, mesh=mesh42, factors=FactorStore.from_arrays(x_st, st0.theta),
            train_eval=triplet(r), test_eval=triplet(rte))
        torch.cuda.synchronize()
        count_mesh(f"netflix-mini mesh streaming {name}", ("fused_herm", "batch_solve"))
        check_ledger(tel, f"netflix-mini mesh streaming {name}")
        d_rmse = max(max(abs(a["train_rmse"] - b["train_rmse"]), abs(a["test_rmse"] - b["test_rmse"]))
                     for a, b in zip(shist, inc_hist))
        dfac = max(np.abs(fac.x[:r.m] - inc.x.cpu().numpy()).max(),
                   np.abs(fac.theta - inc.theta.cpu().numpy()).max())
        log(f"  netflix-mini mesh streaming {name} (q=8, p=2, n_data=4, {len(sched.waves)} waves "
            f"a half, {tel.topology}): max |dRMSE| vs in-core {d_rmse:.3g}, max |dfactor| "
            f"{dfac:.3g}; reduce bytes fast {tel.reduce_fast_bytes} slow {tel.reduce_slow_bytes}; "
            f"ledger {len(tel.ledger['records'])} records all ok")
        check(len(shist) == len(inc_hist) and d_rmse <= MESH_TOL and dfac <= MESH_TOL,
              f"netflix-mini mesh streaming {name} is {d_rmse} / {dfac} from in-core")
        check(tel.reduce_slow_bytes > 0, "the reduce's tree stage did not run")
        mstreams[name] = (store, sched, x_st, fac)
    store, sched, x_st, fac = mstreams["uniform"]
    for kill in (1, 3):
        with tempfile.TemporaryDirectory() as ck:
            try:
                run_streaming_als(store, sched, cfg, mesh=mesh42, ckpt_dir=ck,
                                  factors=FactorStore.from_arrays(x_st, st0.theta),
                                  fail_after_waves=kill)
                fail(f"the mesh kill after wave {kill} did not fire")
            except SimulatedFailure:
                pass
            rfac, _, rtel = run_streaming_als(store, sched, cfg, mesh=mesh42, ckpt_dir=ck)
        same = same_factors(rfac, fac)
        log(f"  netflix-mini mesh streaming kill after wave {kill}, resume from step "
            f"{rtel.resumed_from_step}: factors bit-equal to the uninterrupted run: {same}")
        check(same and rtel.resumed_from_step == kill,
              f"mesh streaming resume after a kill at wave {kill} is not bit-equal")
    # streaming mesh SGD: one tile a cell, 2 and 3 workers, against in-core
    mcfg = sgd.SgdConfig(f=spec.f, lam=spec.lam, lr=0.1, epochs=2, seed=3,
                         schedule="inverse_time", decay=1.0)
    mgrid = blocking.block_ell(r, g=4)
    minc, _ = sgd.sgd_train(mgrid, mcfg, test=triplet(rte))
    for nw in (2, 3):
        reset_counts()
        sfac, _, stel = run_streaming_sgd(TileStore(mgrid), build_sgd_schedule(mgrid, spec.f,
                                                                               n_workers=nw),
                                          mcfg, mesh=mesh42)
        torch.cuda.synchronize()
        count_mesh(f"netflix-mini mesh streaming SGD n_workers={nw}", ("sgd_tile",))
        check_ledger(stel, f"netflix-mini mesh streaming SGD n_workers={nw}")
        dx = max(np.abs(sfac.x - minc.x.cpu().numpy()).max(),
                 np.abs(sfac.theta - minc.theta.cpu().numpy()).max())
        log(f"  netflix-mini mesh streaming SGD n_workers={nw}: max |dfactor| vs in-core {dx:.3g}")
        check(dx <= MESH_TOL, f"mesh streaming SGD n_workers={nw} is {dx} from in-core")
    del mstreams, store, sched, fac, rfac, minc, mgrid, sfac, inc

    # 11b. binned streaming mesh ALS at quarter-Netflix, f=100, on data=2 x
    # model=2 under phase 10b's 1.5 GiB budget a cell
    spec = synth.SynthSpec("netflix/4", m=120_047, n=17_770, nnz=24_750_000,
                           f=100, lam=0.05)
    f = spec.f
    mesh22 = cells((2, 2), ("data", "model"))
    q = 8
    while True:
        t0 = time.perf_counter()
        store = RatingStore(r_full, q=q, p=2, n_bins=8)
        build_s = time.perf_counter() - t0
        plan = plan_mesh(store, r_full.m, r_full.nnz, f, q, 2, cap, depth)
        log(f"  quarter-Netflix mesh store q={q} p=2: built in {build_s:.2f} s; "
            f"plan {plan.describe()}")
        if plan.fits or q >= 1024:
            break
        q *= 2
    check(plan.fits, f"no q up to {q} fits the {cap} B budget a cell")
    sched = build_schedule(plan, r_full.m, r_full.n_cols, n_data=2)
    part_b = sum(2 * st_.rows * (f * f + f) * 4 for st_ in store.rt_stacked)
    log(f"  schedule: {sched.describe()}; {len(store.rt_stacked)} stacked bins, rows "
        f"{[st_.rows for st_ in store.rt_stacked]}, K {[st_.K for st_ in store.rt_stacked]}; "
        f"store host arrays {store.host_nbytes} B, fills {store.fill_breakdown()}")
    cfg = als.AlsConfig(f=f, lam=spec.lam, iters=3, seed=0)
    train_eval = triplet(r_full)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)]
    walls = [time.perf_counter()]
    tr = Tracer()               # splits the solve phase between the halves
    reset_counts()
    marks[0].record()
    fac, shist, tel = run_streaming_als(store, sched, cfg, prefetch_depth=depth, mesh=mesh22,
                                        train_eval=train_eval, test_eval=test,
                                        callback=on_wave_iteration, tracer=tr)
    torch.cuda.synchronize()
    count_mesh("quarter-Netflix mesh streaming", ("fused_herm", "batch_solve"))
    alloc_peak = torch.cuda.max_memory_allocated() - resident
    check_ledger(tel, "quarter-Netflix mesh streaming")
    s_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(cfg.iters)]
    for h, ms, w0, w1, h0 in zip(shist, s_ms, walls, walls[1:], incore_hist):
        log(f"  mesh streaming iteration {h['iteration']}: {ms:.1f} ms on the card's clock "
            f"({w1 - w0:.3f} s wall) train RMSE {h['train_rmse']:.5f} (phase 6 "
            f"{h0['train_rmse']:.5f}) test RMSE {h['test_rmse']:.5f} (phase 6 {h0['test_rmse']:.5f})")
    d_rmse = max(max(abs(a["train_rmse"] - b["train_rmse"]), abs(a["test_rmse"] - b["test_rmse"]))
                 for a, b in zip(shist, incore_hist))
    ps = tel.phase_seconds
    log(f"  max |dRMSE| vs phase 6 {d_rmse:.3g}; {tel.waves_run} waves, {tel.bytes_streamed} B "
        f"streamed; partials brought to the host {part_b} B a wave (f32 A and B of every "
        f"stacked bin, both data shards), added in float64 there")
    half_s = {nm: sum(e.dur for e in tr.spans(cat="solve") if e.name == nm) / 1e6
              for nm in ("als.wave_x", "als.wave_theta")}
    log(f"  solve phase by half over {cfg.iters} iterations: solve-X waves "
        f"{half_s['als.wave_x']:.4f} s, accumulate-Theta waves {half_s['als.wave_theta']:.4f} s")
    log(f"  reduce ({tel.topology}): {ps.get('reduce', 0.0):.4f} s over {cfg.iters} "
        f"iterations, fast-link bytes {tel.reduce_fast_bytes}, slow-link bytes "
        f"{tel.reduce_slow_bytes}")
    log("  phase seconds: " + ", ".join(f"{k_} {v:.4f}" for k_, v in sorted(ps.items())))
    log(f"  prefetch stall {ps.get('prefetch', 0.0):.4f} s = "
        f"{ps.get('prefetch', 0.0) / ps['driver'] * 100:.1f} % of the run ({ps['driver']:.4f} s)")
    log(f"  device memory: allocator peak over the resident {resident} B: {alloc_peak} B "
        f"({alloc_peak / 2**30:.3f} GiB); 4 cells x the schedule's capacity "
        f"{sched.capacity_bytes} B = {4 * sched.capacity_bytes} B; modelled meter peak "
        f"(one cell) {tel.peak_bytes} B")
    check(len(shist) == len(incore_hist) and d_rmse <= MESH_TOL,
          f"quarter-Netflix mesh streaming RMSE is {d_rmse} from phase 6")
    check(alloc_peak <= 4 * sched.capacity_bytes,
          f"mesh streaming allocator peak {alloc_peak} B exceeds 4 cells x capacity "
          f"{sched.capacity_bytes} B")
    check(bool(np.isfinite(fac.x).all() and np.isfinite(fac.theta).all()),
          "non-finite mesh streaming factors")
    log(render_ledger(tel.ledger))

    # the mesh path's two kernels against their plain versions at the shapes
    # this run gave them, from its store, schedule and final factors
    # (launched after the counts were read): solve-X wave 0 cut into each
    # cell's column block (a theta row shard, diag = lam * cnt with no
    # fallback), reduced over each data shard's column cells and each owned
    # slice solved; every stacked bin of every batch on each cell (a data
    # shard's X slice, the cell's half of the bin's rows, the heavy items
    # split), accumulated per theta row; and each theta shard's
    # reduce-and-solve, which must reproduce the run's Theta
    merr = {"herm": 0.0, "solve": 0.0}
    groups = su_als.column_groups(mesh22)
    n_data, p_ = su_als.mesh_axes(mesh22)
    npp = store.n // p_
    theta_dev = torch.from_numpy(fac.theta).to(dev)
    w0 = sched.waves[0]
    xw = store.x_slice_mesh_triplet(w0.row_start, w0.row_stop)
    idx, val, cnt = (torch.from_numpy(a).to(dev) for a in xw)
    m_loc, K_loc = idx.shape[0] // n_data, idx.shape[1] // p_
    pad = -m_loc % p_
    x_rows = []
    for d, devs in enumerate(groups):
        rows = slice(d * m_loc, (d + 1) * m_loc)
        A_c, B_c, c_c = [], [], []
        for k, cell in enumerate(devs):
            cols = slice(k * K_loc, (k + 1) * K_loc)
            i_, v_, c_ = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]).contiguous()
                          for t in (idx[rows, cols], val[rows, cols], cnt[rows, k]))
            Ak, Bk = herm_vs_plain(theta_dev[k * npp:(k + 1) * npp].to(cell), i_.to(cell),
                                   v_.to(cell), c_.to(cell), spec.lam * c_.to(cell, torch.float32),
                                   f"solve-X wave 0's block (data {d}, column {k})", merr)
            A_c.append(Ak)
            B_c.append(Bk)
            c_c.append(c_.to(cell, torch.float32))
        owned = []
        for k, (a, b, c_) in enumerate(zip(*(coll.reduce_scatter_flat(t)
                                              for t in (A_c, B_c, c_c)))):
            a.diagonal(dim1=-2, dim2=-1).add_((c_ <= 0).to(a.dtype)[:, None])
            owned.append(solve_vs_plain(a, b, f"solve-X wave 0's slice (data {d}, column {k})",
                                        merr))
        x_rows.append(torch.cat(owned)[:m_loc])
        del A_c, B_c, c_c, owned, a, b
    x_replay = torch.cat(x_rows)
    x_entry = torch.from_numpy(su_als.make_wave_update_fn(mesh22, spec.lam, mode="kernel")(
        su_als.shard_rows(theta_dev, mesh22), *xw)).to(dev)
    dx_w0 = (x_replay - x_entry).abs().max().item()
    A = torch.zeros((store.n, f, f), dtype=torch.float64, device=dev)
    B = torch.zeros((store.n, f), dtype=torch.float64, device=dev)
    c = torch.zeros((store.n,), dtype=torch.float64, device=dev)
    t_calls, t_split = 0, 0
    for wave in sched.waves:
        stacked = store.theta_wave_stacked([b.index for b in wave.batches])
        for d, b in enumerate(wave.batches):
            x_dev = torch.from_numpy(fac.x[b.row_start:b.row_stop]).to(dev)
            for sidx, sval, scnt, sitems in stacked:
                rpp = sidx.shape[1] // p_
                for k, cell in enumerate(groups[d]):
                    rows = slice(k * rpp, (k + 1) * rpp)
                    i_, v_, c_ = (torch.from_numpy(np.ascontiguousarray(a[d, rows])).to(cell)
                                  for a in (sidx, sval, scnt))
                    Ab, Bb = herm_vs_plain(x_dev.to(cell), i_, v_, c_,
                                           spec.lam * c_.to(torch.float32),
                                           f"batch {b.index}'s stacked bin K={sidx.shape[2]} "
                                           f"(data {d}, column {k})", merr)
                    live = c_ > 0
                    items = torch.from_numpy(sitems[d, rows]).to(dev)[live.to(dev)]
                    A.index_add_(0, items, Ab[live].to(dev, torch.float64))
                    B.index_add_(0, items, Bb[live].to(dev, torch.float64))
                    c.index_add_(0, items, c_[live].to(dev, torch.float64))
                    t_calls += 1
                    t_split += sidx.shape[2] > S
                    del Ab, Bb
    shards = []
    for k, cell in enumerate(groups[0]):
        lo, hi = k * npp, (k + 1) * npp
        Ak, Bk, ck = (t[lo:hi].to(cell, torch.float32) for t in (A, B, c))
        Ak.diagonal(dim1=-2, dim2=-1).add_((ck <= 0).to(Ak.dtype)[:, None])
        shards.append(solve_vs_plain(Ak, Bk, f"theta shard {k}'s reduce-and-solve (n/p={npp})",
                                     merr).to(dev))
        del Ak, Bk, ck
    theta1 = torch.cat(shards)
    dtheta = (theta1 - theta_dev).abs().max().item()
    log(f"  mesh shapes, kernel vs plain: solve-X wave 0 on {n_data} x {p_} cells ({m_loc} "
        f"rows x K={K_loc} a cell, {m_loc + pad} rows reduced and {(m_loc + pad) // p_} "
        f"solved a cell), the replay vs the wave entry point max|d| {dx_w0:.3g} (bit-equal: "
        f"{torch.equal(x_replay, x_entry)}); accumulate-Theta {t_calls} cell calls over "
        f"{len(store.rt_stacked)} stacked bins, {t_split} split (K > {S}); reduce-and-solve "
        f"of {p_} theta shards of {npp} rows: max|dA,dB| {merr['herm']:.3g}, max|dx| "
        f"{merr['solve']:.3g}; the re-solved Theta vs the run's: max|d| {dtheta:.3g} "
        f"(bit-equal: {torch.equal(theta1, theta_dev)})")
    check(t_split > 0, "no stacked bin of the mesh theta half took fused_herm's split path")
    check(torch.allclose(x_replay, x_entry, atol=SOLVE_TOL, rtol=SOLVE_TOL),
          f"the replayed solve-X wave 0 is {dx_w0} from the wave entry point's")
    check(torch.allclose(theta1, theta_dev, atol=SOLVE_TOL, rtol=SOLVE_TOL),
          f"the re-solved mesh Theta is {dtheta} from the mesh streaming run's")
    for k in kernels:
        e = {"fused_herm": merr["herm"], "batch_solve": merr["solve"]}.get(k["name"])
        if e is not None:
            k["max_abs_err_mesh"] = e
            k["max_abs_err"] = max(k["max_abs_err"], e)
    del A, B, c, shards, theta1, theta_dev, x_dev, x_rows, x_replay, x_entry, idx, val, cnt
    del store, fac, train_eval, r_full

    # 11c. streaming mesh SGD at quarter-Netflix: phase 8's grid, 4 tiles a
    # wave, one to each cell of data=2 x model=2, 3 epochs
    ssched = build_sgd_schedule(grid8, f, n_workers=4, prefetch_depth=depth)
    marks = [torch.cuda.Event(enable_timing=True)]
    walls = [time.perf_counter()]
    reset_counts()
    marks[0].record()
    sfac, sh, stel = run_streaming_sgd(TileStore(grid8), ssched, scfg8, prefetch_depth=depth,
                                       mesh=mesh22, callback=on_sgd_epoch)
    torch.cuda.synchronize()
    count_mesh("quarter-Netflix mesh streaming SGD", ("sgd_tile",))
    check_ledger(stel, "quarter-Netflix mesh streaming SGD")
    se_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(scfg8.epochs)]
    dx = max((torch.from_numpy(sfac.x).to(dev) - st8.x).abs().max().item(),
             (torch.from_numpy(sfac.theta).to(dev) - st8.theta).abs().max().item())
    ps = stel.phase_seconds
    for h, ms, w0, w1 in zip(sh, se_ms, walls, walls[1:]):
        log(f"  mesh streaming SGD epoch {h['epoch']}: {ms:.1f} ms on the card's clock "
            f"({w1 - w0:.3f} s wall)")
    log(f"  {ssched.describe()}; final factors vs phase 8's max |d| {dx:.3g}; stall "
        f"{ps.get('prefetch', 0.0) / ps['driver'] * 100:.1f} %")
    check(dx <= MESH_TOL, f"quarter-Netflix mesh streaming SGD factors {dx} from phase 8's")

    del sfac, ssched
    # -- 12. the entry points on the card ----------------------------------------------
    t12 = time.perf_counter()
    entry = entry_points(torch, wrappers, dev)
    log(f"phase 12 took {time.perf_counter() - t12:.1f} s")
    for k in kernels:
        k["launches_entry_points"] = entry["launches"][k["name"]]
        e = {"fused_herm": entry["max_abs_err"]["herm"], "batch_solve":
             entry["max_abs_err"]["solve"], "sgd_tile": entry["max_abs_err"]["sgd"]}.get(k["name"])
        if e is not None:
            k["max_abs_err_entry_points"] = e
            k["max_abs_err"] = max(k["max_abs_err"], e)

    for k in kernels:
        k["launches_mesh"] = launches_mesh.get(k["name"], 0)
        if k["name"] in launches:
            k["launches_streaming"] = launches[k["name"]]
        if k["name"] in ("fused_herm", "batch_solve"):
            k["launches_autotune"] = ctune[k["name"]]

    log(smi.splitlines()[0])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
