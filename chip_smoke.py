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
   script's own launch line must match the registry's counts; both ALS
   kernels at the in-core run's shapes (R, and R^T with its heavy items
   split) and the SGD kernel at the SGD run's grid, from their
   checkpoints, against the plain versions; then ``benchmarks_torch/
   run.py`` once per module at its default size (``--autotune``), every
   row parsed, both JSON files written, and ``python -m
   repro_torch.obs.regress --history`` accepting the history file;
13. the LM serving path and the embedding factorization:
   ``examples_torch/serve_lm.py`` and ``examples_torch/factorize_embeddings.py``
   at their defaults (the latter's launch line against the registry's
   counts); phi3-mini-3.8b at full width and depth (32 layers, d=3072,
   vocab 32256, 3.82 B parameters, random weights from seed 0): greedy
   prefill/decode consistency in float32 (exact up to 2 layers) and in
   float64 (at every depth), ``attention_chunked`` against
   ``attention_full`` on a 2048-token prompt (3e-5), a bf16 2048-token
   prefill, and ``ServeEngine`` on the example's traffic (6 requests, 3
   slots, 12 new tokens, max_seq 96) with ms per decode step, tokens/s,
   the allocator's peak and the step's bound; qwen3-4b at full width, cut
   to ``QWEN3_LAYERS`` layers, the same way; phi3-mini's full embedding
   (32256 x 3072) factorized at rank 16 for 6 iterations through the
   CUDA kernels (RMSE falling each iteration, launches counted), both
   kernels against their plain versions at K = 3072 and K = 32256;
14. the MoE and recurrent families (``PHASE14``), one model at a time,
   random weights from seed 0: olmoe-1b-7b (16 layers, 64 experts top-8),
   recurrentgemma-2b (26 layers: 8 x (RG-LRU, RG-LRU, window-2048
   attention) + 2 RG-LRU) and rwkv6-7b (32 layers) at full width and
   depth, moonshot-v1-16b-a3b at full width and 8 of its 48 layers: phase
   13's greedy check in float32 and float64 at each depth up to the
   model's own (a MoE at a capacity that drops no pair, and at its own
   capacity prefill against the forward), ``ServeEngine`` on the
   example's traffic (ms per decode step against its bound, tokens/s, the
   allocator's peak, one profiled step's device busy share and op count),
   and for recurrentgemma-2b and rwkv6-7b a timed bf16 prefill of 512
   tokens through the sequential scans.  This path has no CUDA kernel: the
   reference computes these blocks outside any Pallas kernel;
15. LM training (``lm_training``): one train step of every arch's smoke
   config and the reference's tiny-LM convergence test (60 steps, the loss
   falls by 0.1); phi3-mini-3.8b at full width, 2 layers, B=2, S=1024:
   the fused loss against the plain one (rel 1e-5), microbatch 1 against
   2 and ``remat`` on against off (loss rel 1e-4, params atol 2.5e-3 rtol
   1e-3); the timed AdamW step of phi3-mini-3.8b at full width and
   ``TRAIN_LAYERS`` of its 32 layers (bf16, remat, fused loss, batch 4 x
   2048 in 2 microbatches): ms a step on CUDA events, tokens/s, mfu
   against 989.4 TFLOP/s, the allocator's peak against the predicted state
   bytes, then one Adafactor step; rwkv6-7b at full width, 2 layers: the
   chunked WKV scan against one loop, the same loss at a lower peak;
   ``examples_torch/train_lm.py`` at its defaults and with ``--ckpt`` and a
   resume.  The training path launches none of the four kernels, and the
   phase checks that it did not: the reference trains these models with
   ``jax.grad`` outside any Pallas kernel.
16. mesh LM serving (``mesh_serving``) on ``make_mesh((2, 2), ("data",
   "model"), devices=["cuda:0"] * 4)``, random weights from seed 0:
   ``flash_decode``, ``flash_decode_update`` (sequence and kv layouts) and
   ``cache_write`` at qwen3-4b's decode shapes (B=4, S=2048, KV=8, H=32,
   dh=128) against the single device (1e-4, a wholly masked slice; the
   writes bit-equal, one past the end dropped); phi3-mini-3.8b at full
   width (heads and kv heads over "model"): prefill and 8 decode steps in
   float32 at 2 layers (1e-4) and float64 at 8 layers (1e-7) and 16 (the
   deepest that fits; tokens) against the single device, then ``ServeEngine(mesh=)`` at all 32 layers
   in bf16 on the example's traffic with 4 slots against the single-device
   engine (flips and their margins, ms per decode step, tokens/s, each
   cell's weight and cache bytes against the layout's count); qwen3-4b at
   8 of 36 layers with the cache's sequence over "model" (its
   ``ArchSpec``): two 1024-token prompts through ``make_prefill_step(mesh=,
   max_seq=2048)`` and 16 decode steps, each cell holding 1024 positions,
   bf16 tokens and float32 logits at 2 layers against the single device;
   olmoe-1b-7b at full width, 32 experts a cell: float32 at 2 layers at a
   capacity that drops nothing (2e-4), each data shard's own capacity, the
   engines.  The reference computes this path with ``einsum``s under
   ``shard_map``, outside any Pallas kernel: the phase checks that it
   launches none of the four kernels.
17. mesh LM training, the pod sync and the ``mlp_2d`` serving layout
   (``mesh_training``) on the same data=2 x model=2 mesh: phi3-mini-3.8b at
   full width, 2 layers, B=4, S=1024, the state laid out by the train
   policy (FSDP: d_model over "data", gathered a layer at a time before
   use): one AdamW and one Adafactor mesh step against the one-device step
   (float32 forward: loss rel 1e-4, params atol 2.5e-3 rtol 1e-3; float64
   params within 1e-7); the timed mesh step in phase 15's configuration
   (16 of 32 layers, bf16, remat, fused loss, 4 x 2048 tokens in 2
   microbatches: ms a step, tokens/s, mfu, the allocator's peak against the
   laid-out states and one layer's gathered weights, beside phase 15's);
   olmoe-1b-7b at full width, 2 layers, no pair dropped (the experts' FSDP
   gather) against one device; on pod=2 x data=2 x model=2,
   ``compressed_pod_psum`` at phi3-mini's gradient shapes (within 2 x scale)
   and a ``pod_compress=True`` step; mistral-large-123b at full width in its
   serving layout (``mlp_2d``, the attention projections over (data,
   model), the cache's sequence over model): float32 at 2 layers against
   one device (1e-4) and the bf16 engines at 4 of 88 layers (phase 16's
   gates, each cell's bytes, ms per decode step).  The path launches none of
   the four kernels, as the reference's ``jax.grad`` and partitioner reach
   none.
18. the recurrent blocks and the ring decode on a mesh (``mesh_recurrent``)
   on the same data=2 x model=2 mesh: recurrentgemma-2b (RG-LRU and window
   2048 MQA attention) and rwkv6-7b at full width, random weights from
   seed 0: float32 at 3 and 2 layers against one device (1e-4;
   recurrentgemma's 2560-token prompt rolls the ring and 16 decode steps
   write past the roll), the bf16 engines at full depth (phase 16's gates, ms per decode
   step, tokens/s, each cell's bytes of weights and of every cache kind), a
   timed bf16 mesh prefill of 512 tokens, one AdamW mesh train step at the
   cut depth (float32 at the microbatch bounds, float64 params within
   1e-7; rwkv6 at 128 tokens: its chunked WKV scan) and float64 at the
   deepest depth that fits (1e-7).  The path launches none of the four
   kernels.
19. the dry-run against the card (``dryrun_on_card``): production cells of
   the H100 deployment (``launch.mesh.make_production_mesh``) with the
   data axis cut to 1, one model group of 8 cells on ``cuda:0`` at the
   production cell's per-cell shapes: (a) the netflix SU-ALS wave (16384
   rows, K_loc 512, Theta over 8 cells, f=100, synthetic ratings from seed
   0) through ``fused_herm`` and ``batch_solve`` (both must launch; A and
   B of every cell and row block against the plain version at 2e-4/1e-4,
   each owned slice's solve at 5e-4, the wave against its plain run at
   2e-3); (b) phi3-mini-3.8b ``decode_32k`` at full width, 4 of 32 layers
   (4 rows a cell, 32768 positions, 4 kv heads a cell): a prefill step of
   4 x 32768 tokens and 3 decode steps, the dry-run's units x 8 cells
   equal to ``FlopCounterMode`` over a whole decode step and a whole
   2048-token prefill on the CUDA cells (and the decode's equal on meta
   cells), the allocator's peak within 1.25x of the dry-run's
   one-working-set estimate, no kernel launched; in (a) and (b) the
   allocator's peak must lie between the meta dry-run's arguments +
   outputs and its live-set estimate for the same layout, and each
   measured time at or above the roofline bound of the same work; (c) ``launch.dryrun.run_cell`` and
   ``benchmarks_torch/roofline.py``'s ``roofline_cell`` on meta cells for
   phi3-mini-3.8b x {train_4k, decode_32k} and the netflix wave at the
   real production shapes, each record's fits, live set, terms and
   dominant term printed, each required to fit.
20. the port's lint and the kernels' shared memory (``lint_and_smem``):
   ``repro_torch.analysis``'s seven rules over the repo on this
   machine's Python, no new finding against
   ``reprolint_torch_baseline.json``; and ``kernels/budgets.py``'s
   ``footprint_bytes`` equal, at every f from 1 to each kernel's bound,
   to the bytes the kernel's launch asks for
   (``<kernel>_smem_bytes`` of its CUDA source).

The second-to-last line of output is a JSON ``kernels`` record (with each
kernel's ``launches_mesh``, its launches in phase 11's runs,
``launches_entry_points``, its launches in phase 12's runs,
``launches_lm``, its launches in phase 13's full-width factorization,
``launches_mesh_lm``, its launches in phase 16 (none),
``launches_mesh_train``, its launches in phase 17 (none),
``launches_mesh_recurrent``, its launches in phase 18 (none),
``launches_dryrun``, its launches in phase 19's ALS wave, and
for the ALS kernels ``max_abs_err_mesh``, their error against the plain
versions at 11b's shapes, ``max_abs_err_lm`` at phase 13's, and
``max_abs_err_entry_points`` for the three training kernels at phase 12's
shapes); the last line is ``{"ok": true, "device":
{...}}``.
Without a GPU, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import io
import json
import math
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
SU_TOL = 2e-3                          # tests/test_distributed.py:73-74, :92-93
MESH_TOL = 1e-4                        # tests/test_distributed.py:110-111,
                                       # tests/test_mesh_streaming.py:189-192, :354-356
PLAN_PEAK_INT64 = 126_199_808          # phase 10c's plan build before its int32 form
PLAIN_CHUNK_ELEMS = 1 << 28            # gathered floats per plain-version chunk
LM_DRYRUN_LAYERS = 4                   # phase 19's phi3-mini depth: ~8 GB of one model group
LM_DRYRUN_SEQ = 32768                  # decode_32k's cache positions
LM_DRYRUN_ROWS = 128 // 32             # decode_32k's rows a data shard of the 32 x 8 deployment
LM_FLOPS_SEQ = 2048                    # phase 19's prefill counted whole: 4 chunks a side
PEAK_EST_FACTOR = 1.25                 # the card's LM peak within this of the one-working-set estimate


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class Launches:
    """The port's kernel launches since the last :meth:`reset`, by kernel:
    deltas of the obs registry's counters (``repro_torch.obs.
    kernel_launches``) of the wrappers' launching calls (``kind``
    ``"launches"``) or of the CUDA launches they made
    (``"cuda_launches"``)."""

    NAMES = ("fused_herm", "batch_solve", "sgd_tile", "herm_hbm_accum")

    def __init__(self, kind: str = "launches"):
        self.kind = kind
        self.reset()

    def _now(self) -> dict:
        from repro_torch.obs import kernel_launches
        counts = kernel_launches(self.kind)
        return {k: counts.get(k, 0) for k in self.NAMES}

    def reset(self) -> None:
        self._base = self._now()

    def read(self) -> dict:
        now = self._now()
        return {k: now[k] - self._base[k] for k in self.NAMES}


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
    "lm_substrate": (tuple(f"lm_{k}_step_{a}" for a in ("phi3-mini-3.8b", "olmoe-1b-7b",
                                                        "recurrentgemma-2b", "rwkv6-7b")
                           for k in ("train", "decode")), ()),
    "sgd": (tuple(f"sgd_vs_als_{k}" for k in ("als", "sgd", "hybrid", "sgd_stream",
                                               "sgd_stream_skew", "sgd_stream_binned"))
            + ("sgd_binned_fill_win", "sgd_vs_als_sgd_stream_mesh"),
            ("fused_herm", "batch_solve", "sgd_tile")),
}


def entry_points(torch, launches: Launches, dev) -> dict:
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
    total = dict.fromkeys(Launches.NAMES, 0)
    runs, err = [], {"herm": 0.0, "solve": 0.0, "sgd": 0.0}
    als_path, sgd_path = ("fused_herm", "batch_solve"), ("sgd_tile",)
    log(f"phase 12: the entry points on the card, in {work}; host RSS {rss_now() / 2**30:.2f} GiB")

    def call(label, fn, argv, path):
        """``fn(argv)`` in ``work``, its output kept; the launches, seconds
        and allocator peak of the call."""
        launches.reset()
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
        counts = launches.read()
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
              f"phase 12 {label}: the script counted {printed}, the registry {runs[-1]['launches']}")
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


#: phase 13's tolerances: tests/test_attention.py:34-75 for the chunked
#: attention; float32 forwards as tests/test_torch_lm.py holds them; the
#: factorization's kernels at HERM_ATOL/HERM_RTOL, SOLVE_TOL
ATTN_TOL = 3e-5
FWD_TOL = 1e-4
#: depth up to which the float32 greedy check is exact (see consistency)
STRICT_LAYERS = 2
#: float64 logits of prefill and decode against the forward's at any depth:
#: float32's decode-vs-forward difference grows from 4e-6 at one layer to
#: 0.2 at 32 on phi3-mini-3.8b; float64 rounds 2**29 times finer
F64_TOL = 1e-7
#: qwen3-4b keeps its widths and runs 8 of its 36 layers in phase 13
QWEN3_LAYERS = 8


def _serve_stats(tr, reqs, peak, weight_bytes, cache_bytes) -> dict:
    """The engine run's numbers from its spans: ms per decode step and per
    prefill token, tokens per second, and the decode step's bound (the
    bf16 weights and the cache it reads, over the card's HBM rate)."""
    dec = [e.dur / 1e3 for e in tr.spans("serve") if e.name == "serve.decode_step"]
    pre = [(e.dur / 1e3, e.args["prompt_len"]) for e in tr.spans("serve")
           if e.name == "serve.prefill"]
    decoded = sum(len(r.out) for r in reqs)
    total_s = (sum(dec) + sum(p for p, _ in pre)) / 1e3
    bound = (weight_bytes + cache_bytes) / PEAK_HBM_BYTES * 1e3
    return {"decode_steps": len(dec), "decode_ms_mean": sum(dec) / len(dec),
            "decode_ms_median": sorted(dec)[len(dec) // 2], "decode_ms_min": min(dec),
            "decode_ms_max": max(dec),
            "prefill_ms_per_token": sum(p for p, _ in pre) / sum(n for _, n in pre),
            "tokens": decoded, "tokens_per_s": decoded / total_s,
            "decode_bound_ms": bound, "weight_bytes": weight_bytes,
            "cache_bytes": cache_bytes, "alloc_peak_bytes": peak}


def _first_layers(cfg, params, depth):
    """``cfg`` and ``params`` cut to their first ``depth`` layers: the
    leaves of the layers kept are views of ``params``'.  The scan groups of
    the cut follow ``block_pattern`` (full periods, then a tail)."""
    import dataclasses

    if depth == cfg.n_layers:
        return cfg, params
    period = len(cfg.block_pattern)
    n_full, rem = divmod(depth, period)
    g0 = params["blocks"][0]
    reps0 = next(iter(next(iter(g0.values())).values())).shape[0]
    blocks = []
    if n_full:
        blocks.append({pi: {n: t[:n_full] for n, t in g.items()} for pi, g in g0.items()})
    if rem:   # the tail: from period n_full of group 0, or the model's own tail
        src, at = (g0, n_full) if n_full < reps0 else (params["blocks"][1], 0)
        blocks.append({str(pi): {n: t[at:at + 1] for n, t in src[str(pi)].items()}
                       for pi in range(rem)})
    return dataclasses.replace(cfg, n_layers=depth), dict(params, blocks=blocks)


def _no_drop(cfg):
    """A MoE ``cfg`` at ``capacity_factor = ceil(E / k)``, where no
    token-expert pair drops (capacity >= the token count); others as they
    are.  The capacity is the reference's arithmetic on the token count, so
    a decode step of B tokens drops other pairs than a forward of B*S."""
    import dataclasses
    import math

    if cfg.moe is None:
        return cfg
    cf = float(math.ceil(cfg.moe.n_experts / cfg.moe.top_k))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _greedy(torch, dev, cfg, params, tokens, dtype):
    """The greedy check at ``cfg``'s depth in ``dtype`` compute: the last
    position's logits of a full forward, of prefill, and of one decode step
    from a one-shorter prefix (tests/test_models_smoke.py:57-82), with the
    tokens of all three.  A window longer than that prefix gets its ring
    padded with empty slots (``pos`` -1): the prefill step, as the
    reference's, sizes a window's ring to the prompt, and a decode step
    would overwrite its oldest entry."""
    import torch.nn.functional as F

    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    B, S = tokens.shape
    kw = dict(compute_dtype=dtype)
    full, _ = T.forward(cfg, params, {"tokens": tokens}, mode="train", **kw)
    prefill = lm.make_prefill_step(cfg, max_seq=S + 4, **kw)
    tok, _ = prefill(params, {"tokens": tokens})
    lg_p, _ = T.forward(cfg, params, {"tokens": tokens}, mode="prefill", **kw)
    _, cache2 = prefill(params, {"tokens": tokens[:, :S - 1]})
    if cfg.sliding_window and S - 1 < cfg.sliding_window:
        n = min(cfg.sliding_window, S + 4) - (S - 1)
        cache2 = T.tree_map(lambda name, t: F.pad(t, (0, 0, 0, 0, 0, n)) if name in ("k", "v")
                            else F.pad(t, (0, n), value=-1) if name == "pos" else t, cache2)
    lens = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    lg_d, _ = T.forward(cfg, params, {"tokens": tokens[:, S - 1:]}, mode="decode",
                        cache=T.tree_map(lambda _, t: t.clone(), cache2), lengths=lens, **kw)
    tok2, _, _ = lm.make_decode_step(cfg, **kw)(params, cache2, tokens[:, S - 1], lens)
    check(bool(torch.isfinite(full).all()), f"{cfg.name}: non-finite logits")
    return full[:, -1], lg_p[:, 0], lg_d[:, 0], tok, tok2


def _consistency(torch, dev, cfg, params, label, depths, record):
    """Greedy prefill/decode consistency on the first ``depth`` layers for
    each of ``depths`` and the model's own depth, appended to
    ``record[label]``.  In float64 compute (no step rounds to float32) the
    three paths' logits agree within ``F64_TOL`` and their tokens are equal
    at every depth.  In float32 the same holds within FWD_TOL up to
    ``STRICT_LAYERS`` layers; deeper, the random network amplifies float32
    rounding layer by layer (the reference's init gives q and k entries of
    ~sqrt(D/H)), so there the float32 decode is held to the float64
    forward no farther than 4 times the float32 forward is (plus FWD_TOL),
    and its tokens are logged.  Returns the deepest float64 depth."""
    import numpy as np

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)).to(dev)
    for depth in sorted({d for d in depths if d < cfg.n_layers} | {cfg.n_layers}):
        c, p = _first_layers(cfg, params, depth)
        full, lg_p, lg_d, tok, tok2 = _greedy(torch, dev, c, p, tokens, torch.float32)
        full64, lg_p64, lg_d64, tok64, tok2_64 = _greedy(torch, dev, c, p, tokens, torch.float64)
        want = torch.argmax(full, dim=-1).to(torch.int32)
        want64 = torch.argmax(full64, dim=-1).to(torch.int32)
        top2 = full.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        d_p = (lg_p - full).abs().max().item()
        d_d = (lg_d - full).abs().max().item()
        d64 = max((lg_p64 - full64).abs().max().item(), (lg_d64 - full64).abs().max().item())
        e_f = (full.double() - full64).abs().max().item()
        e_d = (lg_d.double() - full64).abs().max().item()
        record.setdefault(label, []).append(
            {"layers": depth, "prefill_max_abs": d_p, "decode_max_abs": d_d,
             "margins": margin.tolist(),
             "equal": bool(torch.equal(tok, want) and torch.equal(tok2, want)),
             "f64_max_abs": d64, "f64_equal": bool(torch.equal(tok64, want64)
                                                    and torch.equal(tok2_64, want64)),
             "forward_from_f64": e_f, "decode_from_f64": e_d})
        log(f"  {label}, first {depth} layers, float32 greedy: forward {want.tolist()}, "
            f"prefill {tok.tolist()}, decode {tok2.tolist()}; top-2 margins "
            f"{margin.tolist()}; last-position logits max|d| prefill {d_p:.3g}, decode "
            f"{d_d:.3g}; from the float64 forward: forward {e_f:.3g}, decode {e_d:.3g}; "
            f"float64: forward {want64.tolist()}, prefill {tok64.tolist()}, decode "
            f"{tok2_64.tolist()}, max|d| {d64:.3g}")
        check(torch.equal(tok64, want64) and torch.equal(tok2_64, want64) and d64 <= F64_TOL,
              f"{label}: float64 prefill/decode disagree with the forward at {depth} layers")
        check(e_d <= 4 * e_f + FWD_TOL, f"{label}: the float32 decode is {e_d} from the "
              f"float64 forward at {depth} layers, the float32 forward only {e_f}")
        if depth <= STRICT_LAYERS:
            check(torch.equal(tok, want) and torch.equal(tok2, want)
                  and d_p <= FWD_TOL and d_d <= FWD_TOL,
                  f"{label}: float32 prefill/decode disagree with the forward at {depth} layers")
    return depth


def _serve_run(torch, dev, serve_ex, cfg, params, label):
    """``ServeEngine`` (bf16, 3 slots, max_seq 96) on the example's traffic
    (6 requests x 12 tokens), then one more decode step under the profiler.
    The bound reads the engine's weights (less the embedding rows a step
    does not read, where the head is its own matrix) and its whole cache
    once over the card's HBM rate; the allocator's peak is the run's over
    the engine's weights and cache.  Returns (stats, engine)."""
    import contextlib

    from repro_torch.models import transformer as T
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving.engine import ServeEngine
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr, reg = Tracer(), MetricsRegistry()
    eng = ServeEngine(cfg, params, n_slots=3, max_seq=96, device=dev, tracer=tr,
                      registry=reg)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    weight_bytes = sum(t.numel() * t.element_size() for t in T.tree_leaves(eng.params))
    if "lm_head" in eng.params:                 # 3 embedding rows a step, not the table
        emb = eng.params["embed"]
        weight_bytes += (3 - emb.shape[0]) * emb.shape[1] * emb.element_size()
    cache_bytes = sum(t.numel() * t.element_size() for t in T.tree_leaves(eng.cache))
    reqs = serve_ex.make_requests(cfg, 6, 12)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        steps, secs = serve_ex.serve(eng, reqs)
    peak = torch.cuda.max_memory_allocated() - resident
    st = _serve_stats(tr, reqs, peak, weight_bytes, cache_bytes)
    st.update(engine_steps=steps, seconds=secs)
    # one more decode step under torch.profiler: the card's busy share
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        eng._decode(eng.params, eng.cache, eng.last_tok, eng.lengths)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy = 0.0
    end = float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    st.update(profiled_step_ms=wall, device_ops=len(spans),
              device_busy_ms=busy / 1e3 if spans else None)
    log(f"  {label} one decode step under the profiler: {wall:.3f} ms wall, "
        + (f"{len(spans)} device ops busy {busy / 1e3:.3f} ms ({busy / 1e3 / wall * 100:.1f} "
           f"%; idle {100 - busy / 1e3 / wall * 100:.1f} %)" if spans else
           "device idle share not measured (the profiler returned no device events)"))
    log(f"  {label} engine (bf16, 3 slots, max_seq 96, 6 requests x 12 tokens): {steps} "
        f"steps in {secs:.3f} s; decode step {st['decode_ms_mean']:.3f} ms mean, "
        f"{st['decode_ms_median']:.3f} median, {st['decode_ms_min']:.3f}-"
        f"{st['decode_ms_max']:.3f} over {st['decode_steps']} steps; prefill "
        f"{st['prefill_ms_per_token']:.3f} ms a prompt token; {st['tokens_per_s']:.1f} "
        f"tokens/s; bound {st['decode_bound_ms']:.3f} ms a step ({weight_bytes} B of "
        f"weights + {cache_bytes} B of cache over {PEAK_HBM_BYTES:.3g} B/s); allocator peak "
        f"{peak / 2**20:.1f} MiB over {resident / 2**30:.2f} GiB resident; "
        f"serve/tokens_decoded {reg.snapshot()['counters']['serve/tokens_decoded']}")
    check(all(len(r.out) == 12 and r.done for r in reqs)
          and all(0 <= t < cfg.padded_vocab for r in reqs for t in r.out),
          f"{label}: the engine did not serve 6 requests x 12 valid tokens")
    check(reg.snapshot()["counters"]["serve/tokens_decoded"] == 72,
          f"{label}: serve/tokens_decoded is not 72")
    return st, eng


def lm_serving(torch, launches: Launches, dev) -> dict:
    """Phase 13: the LM serving path and the embedding factorization.

    Both LM examples at their defaults; phi3-mini-3.8b at full width and
    depth (random weights from seed 0): greedy prefill/decode consistency
    in float32 and float64, ``attention_chunked`` against ``attention_full`` on a
    2048-token prompt, a bf16 2048-token prefill, and the serving engine on
    the example's traffic with its numbers; qwen3-4b at full width and
    ``QWEN3_LAYERS`` layers the same way; then phi3-mini's full embedding
    factorized at rank 16 for 6 iterations through the CUDA kernels (the
    counts set to 0 just before and read just after), and both kernels
    against their plain versions at its K = 3072 and K = 32256.
    """
    import contextlib
    import dataclasses
    import math
    import re

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels.batch_solve import batch_solve_cuda, batch_solve_plain
    from repro_torch.kernels.hermitian import fused_herm_cuda, fused_herm_plain
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    serve_ex = _load_script("examples_torch/serve_lm.py")
    fact_ex = _load_script("examples_torch/factorize_embeddings.py")
    out = {"serve": {}, "max_abs_err": {"fused_herm": 0.0, "batch_solve": 0.0}}

    def run_main(label, mod, argv):
        launches.reset()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            ret = mod.main(argv)
        torch.cuda.synchronize()
        counts = launches.read()
        log(f"phase 13 {label}: {time.perf_counter() - t0:.2f} s, launches {counts}")
        return tee.text(), ret, counts

    # 13a. both examples at their defaults
    text, reqs, _ = run_main("examples_torch/serve_lm.py", serve_ex, ["--device", "cuda"])
    check(len(reqs) == 6 and all(len(r.out) == 12 and r.done for r in reqs)
          and re.search(r"^72 tokens in ", text, re.M) is not None,
          "serve_lm did not serve its 6 requests x 12 tokens")
    text, rmses, counts = run_main("examples_torch/factorize_embeddings.py", fact_ex,
                                   ["--device", "cuda"])
    line = [ln for ln in text.splitlines() if ln.startswith("kernel launches: ")]
    check(len(line) == 1 and json.loads(line[0].removeprefix("kernel launches: "))
          == {k: counts[k] for k in fact_ex.KERNELS},
          f"factorize_embeddings' launch line {line} disagrees with the registry's {counts}")
    for k in fact_ex.KERNELS:
        check(counts[k] > 0, f"factorize_embeddings never launched {k}")
    check(len(rmses) == 6 and all(np.isfinite(rmses)) and rmses[-1] < rmses[0],
          f"factorize_embeddings' RMSE {rmses}")

    # 13b. phi3-mini-3.8b at full width and depth
    cfg = registry.get_arch("phi3-mini-3.8b").model
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in T.tree_leaves(params))
    log(f"phase 13 phi3-mini-3.8b: {cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads "
        f"(kv {cfg.n_kv}) x {cfg.d_head}, d_ff={cfg.d_ff}, vocab {cfg.vocab} -> "
        f"{cfg.padded_vocab}; {n_par} parameters stored ({cfg.params_count()} counted), "
        f"{n_par * 4 / 1e9:.2f} GB float32, drawn in {time.perf_counter() - t0:.2f} s")
    out["greedy"] = {}
    _consistency(torch, dev, cfg, params, "phi3-mini-3.8b", (1, 2, 4, 8, 16), out["greedy"])

    # attention_chunked against attention_full on a 2048-token prompt: the
    # first layer's q, k, v in float32
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 2048)).astype(np.int32)).to(dev)
    p0 = {n: t[0] for n, t in params["blocks"][0]["0"].items()}
    xn = L.rms_norm(params["embed"][toks.long()], p0["ln1"], cfg.norm_eps)
    pos = torch.arange(2048, device=dev)[None]
    q = L.rope(T._proj(xn, p0["wq"]), pos, cfg.rope_theta)
    k = L.rope(T._proj(xn, p0["wk"]), pos, cfg.rope_theta)
    v = T._proj(xn, p0["wv"])
    o_full = L.attention_full(q, k, v)
    for skip in (False, True):
        o_ch = L.attention_chunked(q, k, v, chunk_q=512, chunk_kv=512, causal_skip=skip)
        d = (o_ch - o_full).abs().max().item()
        check(torch.allclose(o_ch, o_full, atol=ATTN_TOL, rtol=ATTN_TOL),
              f"attention_chunked (causal_skip={skip}) is {d} from attention_full at 2048 tokens")
        log(f"  attention_chunked (512 x 512, causal_skip={skip}) vs attention_full, 2048 tokens, "
            f"32 heads x 96, float32: max|d| {d:.3g} (tolerance {ATTN_TOL})")
    ms_full = cuda_ms(torch, lambda: L.attention_full(q, k, v))
    ms_ch = cuda_ms(torch, lambda: L.attention_chunked(q, k, v, causal_skip=True))
    log(f"  one layer's attention at 2048 tokens: attention_full {ms_full:.3f} ms, "
        f"attention_chunked (causal_skip) {ms_ch:.3f} ms")
    del q, k, v, o_full, o_ch, xn
    emb = params["embed"].clone()                       # 13d's matrix
    params16 = lm.cast_params(params)
    del params
    torch.cuda.empty_cache()
    prefill16 = lm.make_prefill_step(cfg)
    ms_pre = cuda_ms(torch, lambda: prefill16(params16, {"tokens": toks}), reps=2)
    tok, cache = prefill16(params16, {"tokens": toks})
    check(0 <= int(tok[0]) < cfg.padded_vocab and all(
        bool(torch.isfinite(t.float()).all()) for t in T.tree_leaves(cache)),
        "the bf16 2048-token prefill gave no valid token or a non-finite cache")
    out["prefill_2048_ms"] = ms_pre
    log(f"  bf16 prefill of 2048 tokens (chunked attention, 512 x 512): {ms_pre:.2f} ms "
        f"({2048 / ms_pre * 1e3:.0f} tokens/s)")
    del cache
    out["serve"]["phi3-mini-3.8b"] = _serve_run(torch, dev, serve_ex, cfg, params16,
                                                "phi3-mini-3.8b")[0]
    del params16
    torch.cuda.empty_cache()

    # 13c. qwen3-4b at full width, QWEN3_LAYERS of its 36 layers
    full_q = registry.get_arch("qwen3-4b").model
    cfg_q = dataclasses.replace(full_q, n_layers=QWEN3_LAYERS)
    pq = T.init_params(cfg_q, torch.Generator(device=dev).manual_seed(0))
    log(f"phase 13 qwen3-4b cut to {QWEN3_LAYERS} of {full_q.n_layers} layers: d="
        f"{cfg_q.d_model}, {cfg_q.n_heads} heads (GQA kv {cfg_q.n_kv}) x {cfg_q.d_head}, "
        f"qk-norm, tied head, d_ff={cfg_q.d_ff}, vocab {cfg_q.vocab} -> {cfg_q.padded_vocab}; "
        f"{sum(t.numel() for t in T.tree_leaves(pq))} parameters stored")
    _consistency(torch, dev, cfg_q, pq, "qwen3-4b", (1, 2, 4), out["greedy"])
    pq16 = lm.cast_params(pq)
    del pq
    out["serve"]["qwen3-4b"] = _serve_run(torch, dev, serve_ex, cfg_q, pq16,
                                          f"qwen3-4b ({QWEN3_LAYERS} layers)")[0]
    del pq16
    torch.cuda.empty_cache()

    # 13d. phi3-mini's full embedding factorized at rank 16, 6 iterations
    V, dmod = emb.shape
    launches.reset()
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        states, rm = fact_ex.factorize(emb, 16, 6, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["launches"] = launches.read()
    out["factorize"] = {"seconds": secs, "rmse": rm}
    log(f"phase 13 factorization of phi3-mini's embedding ({V} x {dmod}, "
        f"{V * dmod} ratings, rank 16): 6 iterations in {secs:.2f} s, recon RMSE {rm}; "
        f"launches {out['launches']}")
    check(all(np.isfinite(rm)), f"the full-width factorization's RMSE {rm}")
    for k in fact_ex.KERNELS:
        check(out["launches"][k] > 0, f"phase 13's factorization never launched {k}")

    # what ALS descends: the weighted-lambda objective of the run's states
    lam = fact_ex.LAM

    def objective(state):
        err = (state.x @ state.theta.T - emb).double().square().sum()
        reg = lam * (dmod * state.x.double().square().sum()
                     + V * state.theta.double().square().sum())
        return (err + reg).item(), math.sqrt(err.item() / (V * dmod))

    objs = [objective(s_) for s_ in states]
    out["factorize"]["objective"] = [o for o, _ in objs]
    out["factorize"]["rmse_init"] = objs[0][1]
    log(f"  weighted-lambda objective from the initial factors (RMSE {objs[0][1]:.6g}) over "
        f"6 iterations: {[o for o, _ in objs]}")
    check(rm[0] < objs[0][1] and all(b[0] <= a[0] * (1 + 1e-6) for a, b in zip(objs, objs[1:])),
          f"ALS did not descend its objective on the embedding: {objs}")
    init = states[0]
    del states
    r, rt = fact_ex.dense_ell(emb)

    # both kernels against their plain versions at its shapes: R (K = 3072)
    # against the initial theta (the run's first call), R^T (K = 32256)
    # against the initial x (the run's factors after it are ~0: its
    # weighted lambda, 1e-3 x 3072 and 1e-3 x 32256, outweighs the matrix)
    for side, fixed, (idx, val, cnt) in (("R", init.theta, r), ("R^T", init.x, rt)):
        K = idx.shape[1]
        diag = lam * cnt.float()
        A, B = fused_herm_cuda(fixed, idx, val, cnt, diag)
        step = max(1, PLAIN_CHUNK_ELEMS // (K * fixed.shape[1]))
        for c0 in range(0, idx.shape[0], step):
            sl = slice(c0, min(c0 + step, idx.shape[0]))
            A0, B0 = fused_herm_plain(fixed, idx[sl], val[sl], cnt[sl], diag[sl])
            check(torch.allclose(A[sl], A0, atol=HERM_ATOL, rtol=HERM_RTOL)
                  and torch.allclose(B[sl], B0, atol=HERM_ATOL, rtol=HERM_RTOL),
                  f"fused_herm disagrees with its plain version on the embedding's {side}")
            out["max_abs_err"]["fused_herm"] = max(
                out["max_abs_err"]["fused_herm"], (A[sl] - A0).abs().max().item(),
                (B[sl] - B0).abs().max().item())
            del A0, B0
        x1, x0 = batch_solve_cuda(A, B), batch_solve_plain(A, B)
        check(torch.allclose(x1, x0, atol=SOLVE_TOL, rtol=SOLVE_TOL),
              f"batch_solve disagrees with its plain version on the embedding's {side}")
        out["max_abs_err"]["batch_solve"] = max(out["max_abs_err"]["batch_solve"],
                                                (x1 - x0).abs().max().item())
        ms_h = cuda_ms(torch, lambda: fused_herm_cuda(fixed, idx, val, cnt, diag))
        ms_s = cuda_ms(torch, lambda: batch_solve_cuda(A, B))
        m, f, nnz = idx.shape[0], fixed.shape[1], idx.numel()
        # bounds as phase 7 counts them: the larger of ops / fp32 peak, bytes / HBM
        hb = max(nnz * (f * (f + 1) + 2 * f) / PEAK_FP32_FLOPS, (
            fixed.numel() * 4 + nnz * 8 + m * 8 + A.numel() * 4 + B.numel() * 4)
            / PEAK_HBM_BYTES) * 1e3
        sb = max(m * (f ** 3 / 3 + 2 * f * f) / PEAK_FP32_FLOPS,
                 (A.numel() * 4 + 2 * B.numel() * 4) / PEAK_HBM_BYTES) * 1e3
        out[f"herm_ms_{side}"], out[f"solve_ms_{side}"] = ms_h, ms_s
        out[f"herm_bound_ms_{side}"], out[f"solve_bound_ms_{side}"] = hb, sb
        log(f"  the embedding's {side}: {m} rows, K={K}, f={f}, max|A| "
            f"{A.abs().max().item():.4g}: fused_herm {ms_h:.3f} ms (bound {hb:.3f}), "
            f"batch_solve {ms_s:.3f} ms (bound {sb:.4f}); max|dA,dB| "
            f"{out['max_abs_err']['fused_herm']:.3g}, max|dx| "
            f"{out['max_abs_err']['batch_solve']:.3g} so far")
        del A, B, x1, x0
    del emb, r, rt, init
    torch.cuda.empty_cache()
    return out


#: phase 14's models, random weights from seed 0: (arch, layers run, or None
#: for all, depths of the greedy check besides the model's own).  moonshot's
#: 28.06 B parameters are 112 GB in float32, so it runs 8 of its 48 layers
PHASE14 = (("olmoe-1b-7b", None, (1, 2, 4, 8)),
           ("recurrentgemma-2b", None, (1, 2, 3, 4, 8, 16)),
           ("rwkv6-7b", None, (1, 2, 4, 8, 16)),
           ("moonshot-v1-16b-a3b", 8, (1, 2, 4)))
#: the models whose sequential scans phase 14 times on a 512-token bf16 prefill
PREFILL_512 = ("recurrentgemma-2b", "rwkv6-7b")


def moe_and_recurrent(torch, dev) -> dict:
    """Phase 14: the MoE and recurrent families, one model at a time.

    For each model of ``PHASE14`` at full width: the greedy check of phase
    13 in float32 and float64 at each of its depths and its own (a MoE at a
    capacity that drops nothing, ``_no_drop``; at the model's own capacity,
    prefill against the forward, which route the same B*S tokens); the
    engine on the example's traffic in bf16 with its numbers; for
    ``PREFILL_512`` a bf16 prefill of 512 tokens, timed.
    """
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    serve_ex = _load_script("examples_torch/serve_lm.py")
    out = {"serve": {}, "greedy": {}, "f64_layers": {}, "prefill_512_ms": {},
           "own_capacity_prefill_max_abs": {}, "seconds": {}}
    for arch, layers, depths in PHASE14:
        t0 = time.perf_counter()
        full = registry.get_arch(arch).model
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in T.tree_leaves(params))
        cut = "" if layers is None else f" cut to {layers} of {full.n_layers} layers"
        moe = "" if cfg.moe is None else (
            f", MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} x d_ff {cfg.d_ff}, "
            f"capacity factor {cfg.moe.capacity_factor}")
        log(f"phase 14 {arch}{cut}: pattern {T.layer_pattern(cfg)[:len(cfg.block_pattern)]} "
            f"x {cfg.n_layers} layers, groups {T.scan_groups(cfg)}, d={cfg.d_model}, d_rnn "
            f"{cfg.d_rnn}, window {cfg.sliding_window}{moe}, vocab {cfg.vocab} -> "
            f"{cfg.padded_vocab}; {n_par} parameters stored ({cfg.params_count()} counted), "
            f"{n_par * 4 / 1e9:.2f} GB float32, drawn in {time.perf_counter() - t0:.2f} s")

        # (a), (b): the greedy check in float32 and float64 by depth
        ccfg = _no_drop(cfg)
        if cfg.moe is not None:
            log(f"  {arch}: the greedy check runs at capacity factor "
                f"{ccfg.moe.capacity_factor} (no pair drops)")
        out["f64_layers"][arch] = _consistency(torch, dev, ccfg, params, arch, depths,
                                               out["greedy"])
        log(f"  {arch}: the float64 check reached {out['f64_layers'][arch]} of "
            f"{cfg.n_layers} layers")
        if cfg.moe is not None:
            rng = np.random.default_rng(0)
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)).to(dev)
            d = {}
            for dt in (torch.float32, torch.float64):
                lg_f, _ = T.forward(cfg, params, {"tokens": tokens}, mode="train", compute_dtype=dt)
                lg_p, _ = T.forward(cfg, params, {"tokens": tokens}, mode="prefill",
                                    compute_dtype=dt)
                d[str(dt).split(".")[-1]] = (lg_p[:, 0] - lg_f[:, -1]).abs().max().item()
            out["own_capacity_prefill_max_abs"][arch] = d
            n = tokens.numel()
            cap = int(cfg.moe.capacity_factor * n * cfg.moe.top_k / cfg.moe.n_experts) or 1
            log(f"  {arch} at its own capacity ({cap} a bucket for {n} tokens): prefill vs "
                f"forward last-position logits max|d| "
                f"float32 {d['float32']:.3g}, float64 {d['float64']:.3g}")
            check(d["float64"] <= F64_TOL, f"{arch}: prefill disagrees with the forward at "
                  f"the model's own capacity: {d}")

        # (c): the engine, bf16, on the example's traffic
        out["serve"][arch], eng = _serve_run(torch, dev, serve_ex, cfg, params, arch + cut)
        del params
        torch.cuda.empty_cache()

        # (d): a bf16 prefill of 512 tokens through the sequential scans
        if arch in PREFILL_512:
            rng = np.random.default_rng(1)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 512)).astype(np.int32)).to(dev)
            prefill = lm.make_prefill_step(cfg)
            ms = cuda_ms(torch, lambda: prefill(eng.params, {"tokens": toks}), reps=1)
            tok, cache = prefill(eng.params, {"tokens": toks})
            check(0 <= int(tok[0]) < cfg.padded_vocab and all(
                bool(torch.isfinite(t.float()).all()) for t in T.tree_leaves(cache)),
                f"{arch}: the bf16 512-token prefill gave no valid token or a non-finite cache")
            out["prefill_512_ms"][arch] = ms
            log(f"  {arch} bf16 prefill of 512 tokens: {ms:.2f} ms ({512 / ms * 1e3:.0f} "
                f"tokens/s)")
            del cache
        del eng
        torch.cuda.empty_cache()
        out["seconds"][arch] = time.perf_counter() - t0
        log(f"phase 14 {arch}: {out['seconds'][arch]:.1f} s")
    return out


#: phase 15's tolerances: tests/test_training.py:133 (fused against plain),
#: :113-117 (microbatch 1 against 2: loss, then params after one AdamW step)
FUSED_REL = 1e-5
MB_LOSS_REL = 1e-4
MB_ATOL, MB_RTOL = 2.5e-3, 1e-3
#: the timed train step: phi3-mini-3.8b at full width, this many of its 32
#: layers (all 32 need ~84 GB of AdamW state, more than the card's 80 GB)
TRAIN_LAYERS = 16
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 2048, 2
#: the timed step's first update, from the same weights and batch on one
#: device (phase 15) and on the mesh (phase 17): AdamW's first step moves a
#: parameter by about lr against its gradient's sign, so the first and
#: last layers' ``wq`` and ``w_down`` and the head show the gradient's
#: signs.  A 16-layer random bf16 model amplifies rounding, so the mesh is
#: held beside a witness on one device, the first step with the mesh's
#: row-parallel products (:class:`_RowSplit`: ``wo`` and ``w_down`` in
#: model=2 blocks, each rounded to bf16, summed in float32): each sample's
#: share of moves of one sign on both sides at most ``FIRST_SIGN_SLACK``
#: under the witness's, and the grad norm within ``FIRST_NORM_REL`` or 3x
#: the witness's distance (a gradient tp = 2 times too large is 1.0 off,
#: one from half the rows about 0.5)
UPDATE_SAMPLE = ("wq", "w_down")
FIRST_NORM_REL = 0.1
FIRST_SIGN_SLACK = 0.05
#: and the mesh against that witness itself: the first update's moves of
#: one sign in ``WITNESS_SIGN_AGREE`` of each sample's entries or more, the
#: grad norms within ``WITNESS_NORM_REL`` (0.9898 and 0.30 % read on an
#: H100 when these were set)
WITNESS_SIGN_AGREE = 0.95
WITNESS_NORM_REL = 0.01


def _update_sample(params) -> dict:
    """Float32 copies on the host of :data:`UPDATE_SAMPLE`'s first and last
    layers and of the head, from a tree of tensors or of ``Sharded``
    leaves."""
    import torch

    from repro_torch.distributed.sharding import Sharded

    def whole(t):
        return t.unshard() if isinstance(t, Sharded) else t

    blk = params["blocks"][0]["0"]
    out = {}
    for n in UPDATE_SAMPLE:
        t = whole(blk[n])
        out[f"{n}[0]"], out[f"{n}[-1]"] = (t[i].to("cpu", torch.float32, copy=True)
                                           for i in (0, -1))
        del t
    out["head"] = whole(params.get("lm_head", params["embed"])).to("cpu", torch.float32,
                                                                   copy=True)
    return out


def _sign_agreement(before: dict, after_a: dict, after_b: dict) -> dict:
    """Each sample's share of entries whose moves from ``before`` have one
    sign in ``after_a`` and in ``after_b``."""
    return {k: ((after_a[k] - before[k]).sign() == (after_b[k] - before[k]).sign())
            .float().mean().item() for k in before}


def _matmul_params(cfg, params) -> int:
    """The parameters that enter a matrix product: every block weight that
    is a matrix or more per layer, and the head (the embedding when it is
    tied); the embedding gather, norm scales and biases excluded."""
    n = sum(t.numel() for grp in params["blocks"] for blk in grp.values()
            for t in blk.values() if t.dim() >= 3)
    return n + params.get("lm_head", params["embed"]).numel()


def _kernel_kind(name: str) -> str:
    """A CUDA kernel's name sorted into the kinds phase 15 reports: float32
    products on the CUDA cores (no TF32), other products (bf16 on the
    tensor cores), elementwise, reductions, copies, the rest."""
    n = name.lower()
    if "gemm" in n or "xmma" in n or "nvjet" in n or "cutlass" in n:
        return "f32 products" if ("sgemm" in n or "f32f32_f32f32" in n) else "bf16 products"
    if "copy" in n:
        return "copies"
    if "reduce" in n or "softmax" in n:
        return "reductions"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def _tree_bytes(tree) -> int:
    from repro_torch.models import transformer as T

    return sum(t.numel() * t.element_size() for t in T.tree_leaves(tree))


def lm_training(torch, launches: Launches, dev) -> dict:
    """Phase 15: the LM training path (``models/lm.py``'s loss and train
    step, ``training/optimizer.py``, ``data/tokens.py``,
    ``examples_torch/train_lm.py``) on the card.

    (a) one train step of every arch's smoke config in float32
    ``compute_dtype`` (which, as in the reference, casts only the master
    weights: the forward runs in bf16), and the reference's tiny-LM
    convergence test; (b) phi3-mini-3.8b at full width, 2 layers, B=2,
    S=1024: fused against plain loss, microbatch 1 against 2, ``remat`` on
    against off; (c) the timed step at ``TRAIN_LAYERS`` layers with its
    numbers, and one Adafactor step; (d) rwkv6-7b at full width, 2 layers:
    the chunked WKV scan against one unchunked loop, losses equal and the
    allocator's peak lower with the chunks; (e) the example at its defaults
    and with ``--ckpt`` and a resume.  Every kernel's count is set to 0 at
    the start and read at the end: the path launches none of them.
    """
    import contextlib
    import dataclasses
    import functools
    import math

    import numpy as np

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))           # benchmarks_torch
    from benchmarks_torch.common import PEAK_BF16_FLOPS
    from repro_torch.configs import registry
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.models import lm
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches.reset()
    out = {}
    t0 = time.perf_counter()

    def to_dev(batch):
        return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}

    def smoke_batch(cfg, B, S, seed):
        rng = np.random.default_rng(seed)
        b = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "mask": np.ones((B, S), np.float32)}
        if cfg.frontend:
            b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        else:
            b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        return to_dev(b)

    def clone_state(st):
        return lm.TrainState(T.tree_map(lambda _, t: t.clone(), st.params),
                             type(st.opt)(*(T.tree_map(lambda _, t: t.clone(), list(st.opt)))),
                             st.step.clone())

    def max_param_gap(a, b):
        bad, gap = 0, 0.0
        for x, y in zip(T.tree_leaves(a.params), T.tree_leaves(b.params)):
            d = (x - y).abs()
            gap = max(gap, d.max().item())
            bad += int((d > MB_ATOL + MB_RTOL * y.abs()).sum())
        return gap, bad

    # (a) every arch's smoke config, then the tiny LM's convergence
    smoke = {}
    for arch in registry.list_archs():
        cfg = registry.smoke_config(arch)
        oc = opt.OptConfig(lr=1e-3)
        st = lm.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), oc)
        before = [t.clone() for t in T.tree_leaves(st.params)]
        st, m = lm.make_train_step(cfg, oc, remat=False, compute_dtype=torch.float32)(
            st, smoke_batch(cfg, 2, 16, 0))
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        delta = sum((a - b).abs().sum().item() for a, b in zip(T.tree_leaves(st.params), before))
        smoke[arch] = {"loss": loss, "grad_norm": gn, "delta": delta}
        check(math.isfinite(loss) and math.isfinite(gn) and delta > 0,
              f"phase 15 {arch}: smoke train step loss {loss}, grad norm {gn}, |dparams| {delta}")
    log("phase 15 smoke train steps (float32 compute_dtype, B=2, S=16): " + ", ".join(
        f"{a} loss {v['loss']:.4f} gnorm {v['grad_norm']:.3f}" for a, v in smoke.items()))
    out["smoke"] = smoke

    cfg = registry.smoke_config("phi3-mini-3.8b")
    oc = opt.OptConfig(lr=3e-3)
    st = lm.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), oc)
    step = lm.make_train_step(cfg, oc, remat=False, compute_dtype=torch.float32)
    losses = []
    for _, batch in zip(range(60), synthetic_lm_batches(cfg.vocab, 32, 8, seed=0)):
        st, m = step(st, to_dev(batch))
        losses.append(m["loss"])
    losses = [x.item() for x in losses]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"phase 15 tiny-LM convergence (phi3-mini smoke, 60 steps, lr 3e-3): mean loss of "
        f"the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    check(last < first - 0.1, f"phase 15: the tiny LM's loss fell {first - last:.4f} < 0.1")
    out["convergence"] = {"first5": first, "last5": last}

    # (b) phi3-mini at full width, 2 layers, B=2, S=1024
    full = registry.get_arch("phi3-mini-3.8b").model
    cfg2 = dataclasses.replace(full, n_layers=2)
    oc = opt.OptConfig(lr=1e-3)
    st_a = lm.init_train_state(cfg2, torch.Generator(device=dev).manual_seed(0), oc)
    b2 = to_dev(next(synthetic_lm_batches(cfg2.vocab, 1024, 2, seed=1)))
    with torch.no_grad():
        plain = lm.lm_loss(cfg2, st_a.params, b2, compute_dtype=torch.float32)
        fused = lm.lm_loss(cfg2, st_a.params, b2, compute_dtype=torch.float32, fused_loss=True,
                           loss_chunk=256)
    rel = abs(fused.item() - plain.item()) / abs(plain.item())
    log(f"phase 15 phi3-mini full width, 2 layers, B=2, S=1024: plain loss {plain.item():.6f}, "
        f"fused (chunks of 256) {fused.item():.6f}, rel {rel:.3g}")
    check(rel <= FUSED_REL, f"phase 15: fused loss {rel} from plain")
    st_b, st_c = clone_state(st_a), clone_state(st_a)
    sa, ma = lm.make_train_step(cfg2, oc, microbatch=1, compute_dtype=torch.float32)(st_a, b2)
    sb, mb = lm.make_train_step(cfg2, oc, microbatch=2, compute_dtype=torch.float32)(st_b, b2)
    sc, mc = lm.make_train_step(cfg2, oc, microbatch=1, remat=False,
                                compute_dtype=torch.float32)(st_c, b2)
    mb_rel = abs(ma["loss"].item() - mb["loss"].item()) / abs(ma["loss"].item())
    gap_mb, bad_mb = max_param_gap(sb, sa)
    gap_rm, bad_rm = max_param_gap(sc, sa)
    log(f"  microbatch 1 vs 2: loss {ma['loss'].item():.6f} vs {mb['loss'].item():.6f} (rel "
        f"{mb_rel:.3g}), params after the step max|d| {gap_mb:.3g}, {bad_mb} outside atol "
        f"{MB_ATOL} rtol {MB_RTOL}; remat on vs off: loss equal {torch.equal(ma['loss'], mc['loss'])}"
        f", params max|d| {gap_rm:.3g}, {bad_rm} outside")
    check(mb_rel <= MB_LOSS_REL and bad_mb == 0, "phase 15: microbatch 2 differs from 1")
    check(torch.equal(ma["loss"], mc["loss"]) and bad_rm == 0, "phase 15: remat changed the step")
    out["full_2_layers"] = {"fused_rel": rel, "microbatch_loss_rel": mb_rel,
                            "microbatch_params_max_abs": gap_mb, "remat_params_max_abs": gap_rm}
    del st_a, st_b, st_c, sa, sb, sc, b2
    torch.cuda.empty_cache()

    # (c) the timed step: phi3-mini at full width, TRAIN_LAYERS layers
    cfg16 = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    oc = opt.OptConfig(lr=3e-4, grad_clip=1.0)
    batch = to_dev(next(synthetic_lm_batches(cfg16.vocab, TRAIN_S, TRAIN_B, seed=0)))
    # the witness of phase 17's comparison: the first step with the mesh's
    # row-parallel products (``wo`` and ``w_down`` in model=2 blocks)
    st = lm.init_train_state(cfg16, torch.Generator(device=dev).manual_seed(0), oc)
    before = _update_sample(st.params)
    with _RowSplit(2):
        st, mw = lm.make_train_step(cfg16, oc, microbatch=TRAIN_MB, remat=True,
                                    fused_loss=True)(st, batch)
    first = {"before": before, "witness": _update_sample(st.params),
             "witness_grad_norm": mw["grad_norm"].item(), "witness_loss": mw["loss"].item()}
    del st, mw
    torch.cuda.empty_cache()
    st = lm.init_train_state(cfg16, torch.Generator(device=dev).manual_seed(0), oc)
    n_all = sum(t.numel() for t in T.tree_leaves(st.params))
    n_mm = _matmul_params(cfg16, st.params)
    step = lm.make_train_step(cfg16, oc, microbatch=TRAIN_MB, remat=True, fused_loss=True)
    # f32 params, Adam's m and v, the accumulated grads, one microbatch's
    # grads and the bf16 copy of the weights
    predicted = 22 * n_all
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, m0 = step(st, batch)                         # warm-up
    out["first_update"] = dict(first, after=_update_sample(st.params))
    del before, first
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    step_losses, norms = [], []
    ev[0].record()
    for i in range(3):
        st, m = step(st, batch)
        ev[i + 1].record()
        step_losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    peak = torch.cuda.max_memory_allocated()
    step_losses, norms = [x.item() for x in step_losses], [x.item() for x in norms]
    tokens = TRAIN_B * TRAIN_S
    ms_mean = sum(ms) / len(ms)
    mfu = 6 * n_mm * tokens / (ms_mean / 1e3 * PEAK_BF16_FLOPS)
    log(f"phase 15 timed train step: phi3-mini-3.8b full width, {TRAIN_LAYERS} of "
        f"{full.n_layers} layers ({n_all} parameters, {n_mm} in products), AdamW lr 3e-4 clip "
        f"1.0, bf16, remat, fused loss (chunks of 1024), batch {TRAIN_B} x {TRAIN_S}, microbatch "
        f"{TRAIN_MB}: warm-up loss {m0['loss'].item():.4f}; steps "
        + ", ".join(f"{t:.2f} ms (loss {x:.4f}, grad norm {g:.4g})"
                    for t, x, g in zip(ms, step_losses, norms))
        + f"; mean {ms_mean:.2f} ms, {tokens / ms_mean * 1e3:.0f} tokens/s, mfu {mfu:.4f} "
        f"(6 N tokens over {PEAK_BF16_FLOPS:.4g} FLOP/s); allocator peak {peak} B against "
        f"{predicted} B predicted for the states (x{peak / predicted:.3f})")
    check(all(math.isfinite(x) for x in step_losses) and step_losses[-1] < step_losses[0],
          f"phase 15: the timed steps' loss did not fall: {step_losses}")
    out["timed"] = {"ms": ms, "ms_mean": ms_mean, "tokens_per_s": tokens / ms_mean * 1e3,
                    "mfu": mfu, "peak_bytes": peak, "predicted_bytes": predicted,
                    "losses": step_losses, "grad_norms": norms, "params": n_all,
                    "matmul_params": n_mm, "warmup_loss": m0["loss"].item(),
                    "warmup_grad_norm": m0["grad_norm"].item()}
    # one more step under torch.profiler: where the step's device time goes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kinds = {}
    for n, t in by_name.items():
        kinds[_kernel_kind(n)] = kinds.get(_kernel_kind(n), 0.0) + t / 1e3
    out["timed"].update(profiled_ms=wall, device_ops=len(spans), device_busy_ms=busy / 1e3,
                        top_kernels_ms=[(n[:80], t / 1e3) for n, t in top], kinds_ms=kinds)
    log(f"  one more step under the profiler: {wall:.1f} ms wall, " + (
        f"{len(spans)} device ops busy {busy / 1e3:.1f} ms ({busy / 1e3 / wall * 100:.1f} %); "
        "device ms by kind: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                          sorted(kinds.items(), key=lambda kv: -kv[1]))
        + "; the most device time: " + "; ".join(f"{n[:60]} {t / 1e3:.1f} ms" for n, t in top)
        if spans else "device busy share not measured (the profiler returned no device events)"))
    # one Adafactor step at the same shape, on the same weights
    params = st.params
    del st, m, m0
    torch.cuda.empty_cache()
    oca = opt.OptConfig(name="adafactor", lr=3e-4, grad_clip=1.0)
    sta = lm.TrainState(params, opt.adafactor_init(params),
                        torch.zeros((), dtype=torch.int32, device=dev))
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    sta, ma = lm.make_train_step(cfg16, oca, microbatch=TRAIN_MB, remat=True,
                                 fused_loss=True)(sta, batch)
    e1.record()
    torch.cuda.synchronize()
    af_bytes = _tree_bytes([sta.opt.vr, sta.opt.vc])
    af_ms, af_peak = e0.elapsed_time(e1), torch.cuda.max_memory_allocated()
    log(f"  Adafactor step at the same shape: loss {ma['loss'].item():.4f}, grad norm "
        f"{ma['grad_norm'].item():.4f}, {af_ms:.2f} ms, state {af_bytes} B (AdamW's "
        f"{8 * n_all} B), allocator peak {af_peak} B")
    check(math.isfinite(ma["loss"].item()) and math.isfinite(ma["grad_norm"].item()),
          "phase 15: the Adafactor step is not finite")
    out["adafactor"] = {"ms": af_ms, "state_bytes": af_bytes, "peak_bytes": af_peak}
    del sta, params, batch
    torch.cuda.empty_cache()

    # (d) rwkv6-7b at full width, 2 layers: the chunked WKV scan's memory
    rcfg = dataclasses.replace(registry.get_arch("rwkv6-7b").model, n_layers=2)
    rb = to_dev(next(synthetic_lm_batches(rcfg.vocab, 1024, 1, seed=2)))
    scan = rwkv_mod._wkv_scan
    rw = {}
    for label, chunk in (("chunked", 64), ("unchunked", 1024)):
        st = lm.init_train_state(rcfg, torch.Generator(device=dev).manual_seed(0),
                                 opt.OptConfig(lr=3e-4))
        leaves = T.tree_leaves(st.params)
        rwkv_mod._wkv_scan = functools.partial(scan, chunk=chunk)
        try:
            # the loss and its gradients alone, the part the chunks are for:
            # the allocator's peak over the resident weights and moments
            for p in leaves:
                p.requires_grad_(True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            grads = torch.autograd.grad(lm.lm_loss(rcfg, st.params, rb), leaves)
            torch.cuda.synchronize()
            grad_peak = torch.cuda.max_memory_allocated() - base
            del grads
            for p in leaves:
                p.requires_grad_(False)
            # then the whole train step
            torch.cuda.reset_peak_memory_stats()
            e0.record()
            st, m = lm.make_train_step(rcfg, opt.OptConfig(lr=3e-4))(st, rb)
            e1.record()
            torch.cuda.synchronize()
        finally:
            rwkv_mod._wkv_scan = scan
        rw[label] = {"loss": m["loss"], "peak": torch.cuda.max_memory_allocated(),
                     "grad_peak": grad_peak, "ms": e0.elapsed_time(e1)}
        del st, m, leaves
        torch.cuda.empty_cache()
    log(f"phase 15 rwkv6-7b full width (d={rcfg.d_model}, {rcfg.d_model // 64} heads), 2 layers, "
        f"bf16, B=1, S=1024: chunked WKV scan loss {rw['chunked']['loss'].item():.6f}, step "
        f"{rw['chunked']['ms']:.1f} ms, the loss and gradients' allocator peak over the "
        f"resident state {rw['chunked']['grad_peak']} B, the step's peak "
        f"{rw['chunked']['peak']} B; one loop (chunk=S) loss "
        f"{rw['unchunked']['loss'].item():.6f}, {rw['unchunked']['ms']:.1f} ms, gradients' "
        f"peak {rw['unchunked']['grad_peak']} B, step's {rw['unchunked']['peak']} B")
    check(torch.equal(rw["chunked"]["loss"], rw["unchunked"]["loss"]),
          "phase 15: the chunked WKV scan changed rwkv6's loss")
    check(rw["chunked"]["grad_peak"] < rw["unchunked"]["grad_peak"],
          "phase 15: the chunked WKV scan did not lower the gradients' allocator peak")
    out["rwkv"] = {k: {"loss": v["loss"].item(), "peak": v["peak"], "grad_peak": v["grad_peak"],
                       "ms": v["ms"]} for k, v in rw.items()}

    # (e) the entry point, at its defaults, then with --ckpt and a resume
    ex = _load_script("examples_torch/train_lm.py")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = ex.main([])
    ls = res["losses"]
    log(f"phase 15 examples_torch/train_lm.py (defaults): {len(ls)} steps, loss {ls[0]:.4f} -> "
        f"{ls[-1]:.4f}")
    check(len(ls) == 60 and np.mean(ls[-5:]) < np.mean(ls[:5]),
          "phase 15: the example's loss did not fall")
    with tempfile.TemporaryDirectory() as d:
        with contextlib.redirect_stdout(_Tee(sys.stdout)):
            a = ex.main(["--ckpt", d, "--steps", "30"])
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            b = ex.main(["--ckpt", d, "--steps", "40"])
    log(f"  --ckpt: 30 steps (saved at 25), then a rerun to 40 resumed at {b['start']} and ran "
        f"{len(b['losses'])} steps, loss {b['losses'][0]:.4f} -> {b['losses'][-1]:.4f}")
    check(len(a["losses"]) == 30 and b["start"] == 25 and len(b["losses"]) == 15
          and "resumed from step 25" in tee.text(), "phase 15: the example did not resume")
    out["example"] = {"losses_first_last": [ls[0], ls[-1]], "resumed_at": b["start"]}
    del res, a, b

    out["launches"] = launches.read()
    log(f"phase 15 launches of the four kernels on the training path: {out['launches']}")
    check(not any(out["launches"].values()),
          "phase 15: the training path launched a kernel it should not reach")
    out["seconds"] = time.perf_counter() - t0
    return out


#: phase 16's tolerances: flash-decode against the local decode
#: (tests/test_distributed.py:135), the EP MoE against one device
#: (tests/test_distributed.py:159); the float32 and float64 forwards as
#: phase 13 holds them
FLASH_TOL = 1e-4
MOE_TOL = 2e-4
#: phi3-mini's float64 mesh checks: 8 layers gated at F64_TOL, and 16, the
#: deepest that fits (the float32 master weights, 15.3 GB, their float64
#: copy and its laid-out copy together: 32 layers would need 76.5 GB of
#: 80), gated against two witnesses on one device: ``wo`` and ``w_down``
#: contracted in the mesh's "model" blocks, summed in its order
#: (:class:`_RowSplit`), and every weight one ulp up (:class:`_UlpShift`).
#: The reference's init amplifies rounding-sized changes with depth; the
#: mesh must stay within ``MESH_F64_WITNESS`` times the larger witness's
#: distance from the plain single device (or within F64_TOL)
MESH_F64_LAYERS = (8, 16)
MESH_F64_WITNESS = 10
#: the bf16 engines, mesh against one device call by call: the largest
#: logit difference on the slots compared within ``MESH_BF16_REL`` of the
#: single device's largest logit, and every flip at a top-2 margin under
#: ``MESH_NEAR_TIE`` (tests/test_torch_mesh_lm.py's)
MESH_BF16_REL = 0.5
MESH_NEAR_TIE = 0.125


class _LogitTap:
    """Records the logits of each forward the steps run (the single
    device's through ``transformer.forward``, the mesh's through
    ``mesh_forward.forward``), last position, as float64 on the host."""

    def __init__(self):
        from repro_torch.models import mesh_forward
        from repro_torch.models import transformer as T

        self.T, self.MF = T, mesh_forward
        self.fwd, self.mfwd = T.forward, mesh_forward.forward
        self.logits = []

    def __enter__(self):
        def single(*a, **k):
            out = self.fwd(*a, **k)
            if k.get("mesh") is None and not k.get("return_hidden"):
                self.logits.append(out[0][:, -1].double().cpu().numpy())
            return out

        def mesh(*a, **k):
            out = self.mfwd(*a, **k)
            self.logits.append(out[0].unshard()[:, -1].double().cpu().numpy())
            return out

        self.T.forward, self.MF.forward = single, mesh
        return self

    def __exit__(self, *exc):
        self.T.forward, self.MF.forward = self.fwd, self.mfwd


def _engine_run(torch, serve_ex, cfg, params, label, **kw):
    """``ServeEngine`` (bf16, 4 slots, max_seq 96) on the example's traffic
    (6 requests x 12 tokens), each decode call recorded: (each slot's
    request, inputs, lengths, next tokens, last-position logits).  Returns
    (requests, log, stats, engine bytes)."""
    import contextlib

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving.engine import ServeEngine

    tr, reg = Tracer(), MetricsRegistry()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    eng = ServeEngine(cfg, params, n_slots=4, max_seq=96, tracer=tr, registry=reg, **kw)
    torch.cuda.synchronize()
    mesh = kw.get("mesh")
    if mesh is not None:
        by_cell = {"weights": shd.cell_bytes(eng.params, mesh),
                   "weights_layout": shd.layout_bytes(eng.params, mesh),
                   "cache": shd.cell_bytes(eng.cache, mesh),
                   "cache_layout": shd.layout_bytes(eng.cache, mesh),
                   "weights_on_card": sum(shd.device_bytes(eng.params).values()),
                   "cache_on_card": sum(shd.device_bytes(eng.cache).values())}
        weight_bytes, cache_bytes = by_cell["weights_on_card"], by_cell["cache_on_card"]
    else:
        by_cell = None
        weight_bytes = sum(t.numel() * t.element_size() for t in T.tree_leaves(eng.params))
        cache_bytes = sum(t.numel() * t.element_size() for t in T.tree_leaves(eng.cache))
    torch.cuda.reset_peak_memory_stats()
    log_ = []
    dec = eng._decode

    def logged(p, c, t, ln):
        rec = ([None if r is None else r.rid for r in eng.slot_req], t.cpu().numpy(),
               ln.cpu().numpy())
        with _LogitTap() as tap:
            n, c2, l2 = dec(p, c, t, ln)
        log_.append(rec + (n.cpu().numpy(), tap.logits[-1]))
        return n, c2, l2

    eng._decode = logged
    reqs = serve_ex.make_requests(cfg, 6, 12)
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        steps, secs = serve_ex.serve(eng, reqs)
    peak = torch.cuda.max_memory_allocated() - resident
    st = _serve_stats(tr, reqs, peak, weight_bytes, cache_bytes)
    st.update(engine_steps=steps, seconds=secs)
    check(all(len(r.out) == 12 and r.done for r in reqs)
          and all(0 <= t < cfg.padded_vocab for r in reqs for t in r.out)
          and reg.snapshot()["counters"]["serve/tokens_decoded"] == 72,
          f"{label}: the engine did not serve 6 requests x 12 valid tokens")
    log(f"  {label} engine (bf16, 4 slots, max_seq 96, 6 requests x 12 tokens, logits "
        f"recorded): {steps} steps in {secs:.3f} s; decode step {st['decode_ms_mean']:.3f} ms "
        f"mean, {st['decode_ms_median']:.3f} median, {st['decode_ms_min']:.3f}-"
        f"{st['decode_ms_max']:.3f} over {st['decode_steps']} steps; prefill "
        f"{st['prefill_ms_per_token']:.3f} ms a prompt token; {st['tokens_per_s']:.1f} tokens/s; "
        f"bound {st['decode_bound_ms']:.3f} ms; allocator peak {peak / 2**20:.1f} MiB over "
        f"{resident / 2**30:.2f} GiB resident")
    del eng
    torch.cuda.empty_cache()
    return reqs, log_, st, by_cell


def _engine_flips(log1, log2, n_slots, rule):
    """Call by call (tests/test_torch_serving.py's ``_compare_calls``): the
    same requests, lengths and inputs; the largest logit difference on the
    slots compared; a differing token is a flip, with the single device's
    top-2 margin.  After a flip the slot is compared again once a new
    request is admitted into it at length 0 (``rule`` "admit"), or no slot
    is compared from the next call on ("all": a MoE's slots share the
    experts' capacity).  Returns (flips [(call, slot, request, margin)],
    the largest logit difference, the requests not compared to the end)."""
    import numpy as np

    check(len(log1) == len(log2) > 0, f"the engines made {len(log1)} and {len(log2)} calls")
    diverged, flips, before, skipped, dmax = set(), [], [None] * n_slots, set(), 0.0
    for k, ((rr, rt, rl, rn, rlg), (pr, pt, pl, pn, plg)) in enumerate(zip(log1, log2)):
        check(rr == pr and np.array_equal(rl, pl), f"call {k}: the engines' slots differ")
        flipped = set()
        for s in range(n_slots):
            if rule == "admit" and s in diverged and rr[s] is not None \
                    and rr[s] != before[s] and rl[s] == 0:
                diverged.discard(s)
            if s in diverged:
                skipped.add(rr[s])
                continue
            check(rt[s] == pt[s], f"call {k} slot {s}: the engines' inputs differ")
            dmax = max(dmax, float(np.abs(rlg[s] - plg[s]).max()))
            if rn[s] != pn[s]:
                top2 = np.sort(rlg[s])[-2:]
                flips.append((k, s, rr[s], float(top2[1] - top2[0])))
                flipped.add(s)
                skipped.add(rr[s])
        diverged |= set(range(n_slots)) if rule == "all" and flipped else flipped
        before = rr
    return flips, dmax, sorted(r for r in skipped if r is not None)


class _RowSplit:
    """The single-device forward with the attention's ``wo`` and the swiglu
    FFN's ``w_down`` contracted in ``parts`` blocks of their input dim,
    each block's product at the compute dtype, summed in ascending order
    in float32 (float64 stays float64) and cast once: the mesh's
    row-parallel sums (``collectives.all_reduce``) without the mesh."""

    def __init__(self, parts: int):
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T

        self.T, self.L, self.parts = T, L, parts
        self.saved = (T._attn_out, T._ffn_partial)

    def __enter__(self):
        T, L, n = self.T, self.L, self.parts

        def split_sum(a, w):
            import torch

            k = a.shape[-1] // n
            wide = torch.promote_types(a.dtype, torch.float32)
            out = (a[..., :k] @ w[:k]).to(wide)
            for i in range(1, n):
                out = out + (a[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k]).to(wide)
            return out.to(a.dtype)

        def attn_out(out, wo):
            return split_sum(out.reshape(out.shape[0], out.shape[1], -1),
                             wo.reshape(-1, wo.shape[-1]))

        def ffn(cfg, p, x):
            check(cfg.mlp == "swiglu" and cfg.moe is None, f"_RowSplit: a {cfg.mlp} FFN")
            dt = x.dtype
            h = L.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
            return split_sum(h, p["w_down"].to(dt))

        T._attn_out, T._ffn_partial = attn_out, ffn
        return self

    def __exit__(self, *exc):
        self.T._attn_out, self.T._ffn_partial = self.saved


class _UlpShift:
    """Every parameter of ``params`` moved one ulp toward +inf in place,
    restored exactly on exit: a rounding-sized change of the whole model."""

    def __init__(self, params):
        from repro_torch.models import transformer as T

        self.leaves = list({id(t): t for t in T.tree_leaves(params)}.values())

    def __enter__(self):
        for t in self.leaves:
            t.nextafter_(t.new_full((), math.inf))
        return self

    def __exit__(self, *exc):
        for t in self.leaves:
            t.nextafter_(t.new_full((), -math.inf))


class _MeshOrder:
    """The single-device forward in the summation order of a mesh whose
    weights are whole after their d_model gathers (the ``mlp_2d`` layout
    with replicated heads), on one device: the swiglu FFN in ``parts``
    column blocks of ``w_gate``/``w_up`` with the matching row blocks of
    ``w_down``, each block a contiguous operand, the products summed in
    ascending order (the "model" cells and their fold); with ``seq`` the
    decode attention over ``parts`` sequence slices of the cache, combined
    by flash-decode's own ``_partial_decode`` and ``combine``.
    :func:`_mesh_vs_single` runs it on each data block of the batch rows
    on its own, as the mesh's data cells run them."""

    def __init__(self, parts: int, seq: bool):
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T

        self.T, self.L, self.parts, self.seq = T, L, parts, seq
        self.saved = (T._ffn_partial, L.attention_decode)

    def __enter__(self):
        from repro_torch.distributed import flash_decode as fd

        n, ffn0 = self.parts, self.saved[0]

        def ffn(cfg, p, x):
            check(cfg.mlp == "swiglu" and cfg.moe is None, f"_MeshOrder: a {cfg.mlp} FFN")
            f = p["w_gate"].shape[-1] // n
            out = None
            for i in range(n):
                cols = slice(i * f, (i + 1) * f)
                y = ffn0(cfg, dict(p, w_gate=p["w_gate"][:, cols].contiguous(),
                                   w_up=p["w_up"][:, cols].contiguous(),
                                   w_down=p["w_down"][cols].contiguous()), x)
                out = y if out is None else out + y
            return out

        def attention_decode(q, k, v, length, *, window=None):
            check(window is None, "_MeshOrder: a windowed decode")
            s = k.shape[1] // n
            parts = [fd._partial_decode(q, k[:, i * s:(i + 1) * s].contiguous(),
                                        v[:, i * s:(i + 1) * s].contiguous(), length, i * s)
                     for i in range(n)]
            return fd.combine(parts, q.device).reshape(q.shape).to(q.dtype)

        self.T._ffn_partial = ffn
        if self.seq:
            self.L.attention_decode = attention_decode
        return self

    def __exit__(self, *exc):
        self.T._ffn_partial, self.L.attention_decode = self.saved


def _check_engine_flips(label, flips, dmax, scale):
    """Phases 16 and 17's gate on two bf16 engines compared call by call."""
    check(dmax <= MESH_BF16_REL * scale,
          f"{label}: the mesh engine's logits are {dmax} from one device's "
          f"(bound {MESH_BF16_REL}x the largest logit {scale})")
    check(all(f[3] < MESH_NEAR_TIE for f in flips),
          f"{label}: a flip at a margin of {MESH_NEAR_TIE} or more: {flips}")


def _mesh_vs_single(torch, cfg, params, mesh, dtype, tokens, steps, max_seq, seq=False,
                    witness=False, mlp_2d=False, order=False):
    """Prefill (cache at ``max_seq``) and ``steps`` greedy decode steps on
    one device and on ``mesh`` (parameters laid out by the serve policy)
    from the same tokens in ``dtype``.  Returns the largest last-position
    logit difference over the calls (and over the prefill call alone),
    whether every token agreed, the largest single-device logit, the mesh
    cache's cell shape and the calls' seconds (single, mesh).  ``witness``:
    also the single device under :class:`_RowSplit` ("model" blocks) and
    under :class:`_UlpShift`: their largest differences from the plain
    single device, and the row split's from the mesh (``"ulp"``: only
    :class:`_UlpShift`'s).  ``order``: also the
    single device under :class:`_MeshOrder` on each block of the batch
    rows that the data axes give the mesh's cells: its largest differences
    from the plain single device and from the mesh.  ``mlp_2d``: the
    parameters in the serve policy's ``mlp_2d`` layout."""
    import contextlib

    import numpy as np

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.models.transformer import tree_leaves as T_leaves

    kw = dict(compute_dtype=dtype)
    sp = shd.shard_params(cfg, params, mesh, serve_seq_shard=seq, mlp_2d=mlp_2d)

    def run(p, mk, ctx, toks_in):
        with _LogitTap() as tap, ctx:
            tok, cache = lm.make_prefill_step(cfg, max_seq=max_seq, **mk, **kw)(
                p, {"tokens": toks_in})
            dec = lm.make_decode_step(cfg, **mk, **kw)
            lens = torch.full((toks_in.shape[0],), toks_in.shape[1], dtype=torch.int32,
                              device=toks_in.device)
            toks = [tok]
            for _ in range(steps):
                tok, cache, lens = dec(p, cache, tok, lens)
                toks.append(tok)
        return tap.logits, torch.stack(toks).cpu(), cache

    tp = mesh.shape["model"]
    res = {}
    runs = [("single", params, {}, contextlib.nullcontext()),
            ("mesh", sp, dict(mesh=mesh, serve_seq_shard=seq), contextlib.nullcontext())]
    if witness:
        if witness != "ulp":
            runs.append(("witness", params, {}, _RowSplit(tp)))
        runs.append(("ulp", params, {}, _UlpShift(params)))
    for where, p, mk, ctx in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run(p, mk, ctx, tokens)
        torch.cuda.synchronize()
        res[where] = r + (time.perf_counter() - t0,)
    if order:
        B = tokens.shape[0]
        dp = math.prod(mesh.shape[a] for a in shd.dp_axes(mesh))
        rows = B // dp if B % dp == 0 else B
        t0 = time.perf_counter()
        parts = [run(params, {}, _MeshOrder(tp, seq), tokens[r:r + rows])
                 for r in range(0, B, rows)]
        torch.cuda.synchronize()
        res["order"] = ([np.concatenate(ls) for ls in zip(*(x[0] for x in parts))],
                        torch.cat([x[1] for x in parts], dim=1), None,
                        time.perf_counter() - t0)

    def dist(a, b, calls=slice(None)):
        return max(float(abs(x - y).max()) for x, y in zip(res[a][0][calls], res[b][0][calls]))

    def leaf(cache, name):
        """The first leaf called ``name`` of a cache, or None."""
        return next((blk[name] for grp in cache["blocks"] for blk in grp.values()
                     if name in blk), None)

    scale = max(float(abs(a).max()) for a in res["single"][0])
    k0 = leaf(res["mesh"][2], "k")
    k0 = T_leaves(res["mesh"][2])[0] if k0 is None else k0
    out = {"max_abs": dist("single", "mesh"), "prefill_max_abs": dist("single", "mesh", slice(1)),
           "tokens_equal": bool(torch.equal(res["single"][1], res["mesh"][1])),
           "max_logit": scale, "cache_cell_shape": list(k0.cells[0].shape),
           "seconds": [res["single"][3], res["mesh"][3]],
           "tokens": res["single"][1].tolist()}
    pos = leaf(res["mesh"][2], "pos")
    if pos is not None:     # a window's ring: the positions each slot holds after the run
        pm, ps = pos.unshard(), leaf(res["single"][2], "pos")
        row = pm[0, 0]
        out["ring"] = {"slots": int(row.numel()), "first": int(row.min()), "last": int(row.max()),
                       "equal_to_single": bool(torch.equal(pm.cpu(), ps.cpu())),
                       "slot_of_last": int(torch.argmax(row))}
    if witness:
        out["ulp_max_abs"] = dist("single", "ulp")
    if witness and witness != "ulp":
        out.update(witness_max_abs=dist("single", "witness"),
                   mesh_vs_witness=dist("mesh", "witness"),
                   witness_tokens_equal=bool(torch.equal(res["single"][1], res["witness"][1])))
    if order:
        out.update(order_max_abs=dist("single", "order"), mesh_vs_order=dist("mesh", "order"),
                   mesh_vs_order_prefill=dist("mesh", "order", slice(1)),
                   order_tokens_equal=bool(torch.equal(res["mesh"][1], res["order"][1])))
    return out


def mesh_serving(torch, launches: Launches, dev) -> dict:
    """Phase 16: mesh LM serving on a data=2 x model=2 mesh whose four
    cells share the card (results, launches and the host's cost of four
    cells; not scaling).  The float32 and float64 checks gate; the bf16
    runs are reported against the single device (flips with their
    margins, the largest logit difference): the mesh decode rounds its
    scores to bf16 as the reference's mesh decode does, and a deep random
    network amplifies any rounding (phase 13).

    (a) the primitives at qwen3-4b's decode shapes against the single
    device; (b) phi3-mini-3.8b at full width: float32 at 2 layers, float64
    at ``MESH_F64_LAYERS``, the engine at all 32 against the single-device
    engine, the bytes of each cell; (c) qwen3-4b at 8 of 36 layers with its
    cache's sequence split over "model": a 1024-token prompt and 16 decode
    steps, bf16 at 8 layers and float32 at 2; (d) olmoe-1b-7b at full
    width, 32 experts a cell: float32 at 2 layers at a capacity that drops
    nothing, the engine at its own capacity.  The phase launches none of
    the four kernels.
    """
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.distributed.cache_update import cache_write
    from repro_torch.distributed.flash_decode import flash_decode, flash_decode_update
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    t_start = time.perf_counter()
    launches.reset()
    serve_ex = _load_script("examples_torch/serve_lm.py")
    mesh = make_mesh((2, 2), ("data", "model"), devices=[f"cuda:{dev.index or 0}"] * 4)
    out = {"mesh": mesh.describe(), "seconds": {}}

    # (a) the primitives at qwen3-4b's decode shapes, float32
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, KV, H, dh = 4, 2048, 8, 32, 128

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, kc, vc, kn, vn = rn(B, H, dh), rn(B, S, KV, dh), rn(B, S, KV, dh), rn(B, KV, dh), \
        rn(B, KV, dh)
    # row 1: the second cell's slice [1024, 2048) wholly masked; row 3: one position
    lens = torch.tensor([2048, 700, 1500, 1], dtype=torch.int32, device=dev)
    got = flash_decode(q, kc, vc, lens, mesh=mesh)
    prim = {"flash_decode": (got - L.attention_decode(q, kc, vc, lens)).abs().max().item()}
    lens_up = torch.tensor([2047, 700, 1500, 0], dtype=torch.int32, device=dev)
    for layout, kw in (("seq", dict(seq_axis="model", kv_axis=None)),
                       ("kv", dict(seq_axis=None, kv_axis="model"))):
        k1, v1 = kc.clone(), vc.clone()
        cache_write(k1, kn, lens_up)
        cache_write(v1, vn, lens_up)
        o, k2, v2 = flash_decode_update(q, kc.clone(), vc.clone(), kn, vn, lens_up, mesh=mesh,
                                        dp=("data",), **kw)
        prim[f"flash_decode_update_{layout}"] = (
            o.unshard() - L.attention_decode(q, k1, v1, lens_up + 1)).abs().max().item()
        check(torch.equal(k2.unshard(), k1) and torch.equal(v2.unshard(), v1),
              f"flash_decode_update's {layout} cache write differs from the single device's")
    lens_cw = torch.tensor([2048, 700, 1024, 0], dtype=torch.int32, device=dev)  # 2048: dropped
    want = cache_write(kc.clone(), kn, lens_cw)
    check(not torch.equal(want, kc) and torch.equal(want[0], kc[0]),
          "the single-device write past the end was not dropped")
    for layout, kw in (("seq", dict(seq_axis="model")), ("kv", dict(kv_axis="model"))):
        got = cache_write(kc.clone(), kn, lens_cw, mesh=mesh, dp=("data",), **kw)
        check(torch.equal(got.unshard(), want),
              f"cache_write's {layout} layout differs from the single device's")
    out["primitives"] = prim
    log(f"phase 16 mesh {out['mesh']}; primitives at qwen3-4b's decode shapes (B={B}, S={S}, "
        f"KV={KV}, H={H}, dh={dh}, float32) against the single device: max|d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in prim.items())
        + f" (tolerance {FLASH_TOL}); cache_write and the fused writes bit-equal on both "
        f"layouts, the write past the end dropped")
    check(all(v <= FLASH_TOL for v in prim.values()), f"phase 16 primitives: {prim}")
    del q, kc, vc, kn, vn, k1, v1, k2, v2, o, got, want
    out["seconds"]["primitives"] = time.perf_counter() - t0

    # (b) phi3-mini-3.8b at full width
    t0 = time.perf_counter()
    cfg = registry.get_arch("phi3-mini-3.8b").model
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)).to(dev)
    c2, p2 = _first_layers(cfg, params, 2)
    r32 = _mesh_vs_single(torch, c2, p2, mesh, torch.float32, tokens, 8, 32)
    gated, deepest = MESH_F64_LAYERS
    c64, p64 = _first_layers(cfg, params, deepest)
    p64 = T.tree_map(lambda _, t: t.double(), p64)
    r64 = {n: _mesh_vs_single(torch, *_first_layers(c64, p64, n), mesh, torch.float64, tokens,
                              8, 32, witness=True) for n in MESH_F64_LAYERS}
    del p64
    torch.cuda.empty_cache()
    out["phi3"] = {"f32_2_layers": r32, "f64": {str(n): r for n, r in r64.items()}}
    log(f"phase 16 phi3-mini-3.8b (d={cfg.d_model}, {cfg.n_heads} heads, kv {cfg.n_kv}; heads "
        f"and kv heads split over model, the cache's kv heads too), B=4 x 12 tokens, prefill + "
        f"8 decode steps, mesh against one device: float32 at 2 layers max|d| "
        f"{r32['max_abs']:.3g} (tolerance {FWD_TOL}), tokens equal {r32['tokens_equal']}; "
        + "; ".join(f"float64 at {n} layers max|d| {r['max_abs']:.4g}, tokens equal "
                    f"{r['tokens_equal']}, largest logit {r['max_logit']:.6g}; witness (one "
                    f"device, wo and w_down in the mesh's 2 blocks summed in order) "
                    f"{r['witness_max_abs']:.4g} from the plain single device, "
                    f"{r['mesh_vs_witness']:.4g} from the mesh; one device with every weight "
                    f"one ulp up {r['ulp_max_abs']:.4g} from it" for n, r in r64.items())
        + f" (tolerance {F64_TOL} at {gated}; at {deepest} {F64_TOL} or {MESH_F64_WITNESS}x "
        f"the larger witness); seconds (single, mesh) {r32['seconds']}, "
        + ", ".join(str(r["seconds"]) for r in r64.values()))
    check(r32["max_abs"] <= FWD_TOL and r32["tokens_equal"],
          f"phase 16 phi3 float32 mesh disagrees with one device: {r32}")
    check(r64[gated]["max_abs"] <= F64_TOL and all(r["tokens_equal"] for r in r64.values()),
          f"phase 16 phi3 float64 mesh disagrees with one device: {r64}")
    wit = max(r64[deepest]["witness_max_abs"], r64[deepest]["ulp_max_abs"])
    check(r64[deepest]["max_abs"] <= max(F64_TOL, MESH_F64_WITNESS * wit),
          f"phase 16 phi3 float64 mesh at {deepest} layers is further from one device than "
          f"{MESH_F64_WITNESS}x the witnesses: {r64[deepest]}")
    runs = {}
    for where, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device=dev))):
        runs[where] = _engine_run(torch, serve_ex, cfg, params, f"phi3-mini-3.8b {where}", **kw)
    del params
    torch.cuda.empty_cache()
    flips, dmax, skipped = _engine_flips(runs["single"][1], runs["mesh"][1], 4, "admit")
    scale = max(float(np.abs(r[4]).max()) for r in runs["single"][1])
    same = sum(a.out == b.out for a, b in zip(runs["single"][0], runs["mesh"][0]))
    by_cell = runs["mesh"][3]
    out["phi3"]["engine"] = {"mesh": runs["mesh"][2], "single": runs["single"][2],
                             "flips": flips, "max_logit_diff": dmax, "max_logit": scale,
                             "requests_equal": same, "not_compared": skipped,
                             "bytes_by_cell": by_cell}
    log(f"  phi3-mini-3.8b engines, mesh against one device: decode step "
        f"{runs['mesh'][2]['decode_ms_mean']:.3f} against {runs['single'][2]['decode_ms_mean']:.3f} "
        f"ms ({runs['mesh'][2]['decode_ms_mean'] / runs['single'][2]['decode_ms_mean']:.2f}x), "
        f"{runs['mesh'][2]['tokens_per_s']:.1f} against {runs['single'][2]['tokens_per_s']:.1f} "
        f"tokens/s; {same} of 6 requests token for token; flips (call, slot, request, the single "
        f"device's top-2 margin) {flips}; largest logit difference on the slots compared "
        f"{dmax:.4g} (largest logit {scale:.4g}; bound {MESH_BF16_REL}x it, flips under a "
        f"margin of {MESH_NEAR_TIE})")
    _check_engine_flips("phase 16 phi3-mini-3.8b", flips, dmax, scale)
    log(f"  phi3-mini-3.8b bytes a cell (data, model) = (0,0) (0,1) (1,0) (1,1): weights "
        f"{by_cell['weights']} (layout {by_cell['weights_layout']}), cache {by_cell['cache']} "
        f"(layout {by_cell['cache_layout']}); on the card: weights {by_cell['weights_on_card']}, "
        f"cache {by_cell['cache_on_card']}")
    check(by_cell["weights"] == by_cell["weights_layout"]
          and by_cell["cache"] == by_cell["cache_layout"],
          "phase 16: a cell's bytes differ from its layout's count")
    out["seconds"]["phi3"] = time.perf_counter() - t0

    # (c) qwen3-4b at full width, 8 of 36 layers, the cache's sequence split
    t0 = time.perf_counter()
    spec_q = registry.get_arch("qwen3-4b")
    check(spec_q.serve_seq_shard, "qwen3-4b's ArchSpec no longer shards its cache's sequence")
    cfg_q = dataclasses.replace(spec_q.model, n_layers=QWEN3_LAYERS)
    pq = T.init_params(cfg_q, torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg_q.vocab, (2, 1024)).astype(np.int32)).to(dev)
    pq16 = T.tree_map(lambda n, t: t if n in T.FLOAT32_LEAVES else t.to(torch.bfloat16), pq)
    rq16 = _mesh_vs_single(torch, cfg_q, pq16, mesh, torch.bfloat16, toks, 16, 2048, seq=True)
    del pq16
    cq2, pq2 = _first_layers(cfg_q, pq, 2)
    rq32 = _mesh_vs_single(torch, cq2, pq2, mesh, torch.float32, toks, 16, 2048, seq=True)
    del pq, pq2
    torch.cuda.empty_cache()
    out["qwen3"] = {"bf16_8_layers": rq16, "f32_2_layers": rq32}
    log(f"phase 16 qwen3-4b cut to {QWEN3_LAYERS} of {spec_q.model.n_layers} layers (heads "
        f"replicated, the cache's sequence split over model), 2 prompts of 1024 tokens, "
        f"max_seq 2048, 16 decode steps: each cell holds a cache block "
        f"{rq16['cache_cell_shape']} (layers, rows, positions, kv, dh); bf16 mesh against one "
        f"device: tokens equal {rq16['tokens_equal']}, max|d| {rq16['max_abs']:.4g} (largest "
        f"logit {rq16['max_logit']:.4g}); float32 at 2 layers max|d| {rq32['max_abs']:.3g} "
        f"(tolerance {FWD_TOL}), tokens equal {rq32['tokens_equal']}; seconds (single, mesh) "
        f"{rq16['seconds']} and {rq32['seconds']}")
    check(rq16["cache_cell_shape"][2] == 1024, "phase 16: qwen3's cells do not hold 1024 positions")
    check(rq16["max_abs"] <= MESH_BF16_REL * rq16["max_logit"],
          f"phase 16 qwen3 bf16 mesh logits beyond {MESH_BF16_REL}x the largest: {rq16}")
    check(rq32["max_abs"] <= FWD_TOL and rq32["tokens_equal"],
          f"phase 16 qwen3 float32 mesh disagrees with one device: {rq32}")
    out["seconds"]["qwen3"] = time.perf_counter() - t0

    # (d) olmoe-1b-7b at full width, expert-parallel
    t0 = time.perf_counter()
    cfg_o = registry.get_arch("olmoe-1b-7b").model
    po = T.init_params(cfg_o, torch.Generator(device=dev).manual_seed(0))
    E, k = cfg_o.moe.n_experts, cfg_o.moe.top_k
    co2, po2 = _first_layers(_no_drop(cfg_o), po, 2)
    ro = _mesh_vs_single(torch, co2, po2, mesh, torch.float32, tokens, 8, 32)
    del po2
    caps = {f"{n} tokens": int(cfg_o.moe.capacity_factor * n * k / E) or 1 for n in (2, 4)}
    runs_o, runs_nd = {}, {}
    for where, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device=dev))):
        runs_o[where] = _engine_run(torch, serve_ex, cfg_o, po, f"olmoe-1b-7b {where}", **kw)
        runs_nd[where] = _engine_run(torch, serve_ex, _no_drop(cfg_o), po,
                                     f"olmoe-1b-7b no-drop {where}", **kw)
    del po
    flips_o, dmax_o, skipped_o = _engine_flips(runs_nd["single"][1], runs_nd["mesh"][1], 4,
                                               "admit")
    scale_o = max(float(np.abs(r[4]).max()) for r in runs_nd["single"][1])
    torch.cuda.empty_cache()
    same_o = sum(a.out == b.out for a, b in zip(runs_o["single"][0], runs_o["mesh"][0]))
    out["olmoe"] = {"f32_2_layers_no_drop": ro, "capacity": caps,
                    "engine": {"mesh": runs_o["mesh"][2], "single": runs_o["single"][2],
                               "requests_equal": same_o,
                               "bytes_by_cell": runs_o["mesh"][3]},
                    "engine_no_drop": {"flips": flips_o, "max_logit_diff": dmax_o,
                                       "max_logit": scale_o, "not_compared": skipped_o}}
    log(f"phase 16 olmoe-1b-7b ({E} experts top-{k}, {E // 2} a cell): float32 at 2 layers, "
        f"capacity factor {co2.moe.capacity_factor} (no pair drops), prefill + 8 decode steps "
        f"max|d| {ro['max_abs']:.3g} (tolerance {MOE_TOL}), tokens equal {ro['tokens_equal']}; "
        f"at its own capacity factor {cfg_o.moe.capacity_factor} a decode step's capacity is "
        f"{caps['2 tokens']} a bucket on each data shard (2 of the 4 slots' tokens) and "
        f"{caps['4 tokens']} on one device (4 tokens); engines: decode step "
        f"{runs_o['mesh'][2]['decode_ms_mean']:.3f} (mesh) against "
        f"{runs_o['single'][2]['decode_ms_mean']:.3f} ms, {runs_o['mesh'][2]['tokens_per_s']:.1f} "
        f"against {runs_o['single'][2]['tokens_per_s']:.1f} tokens/s; {same_o} of 6 requests "
        f"the same (the capacities differ); weights a cell {runs_o['mesh'][3]['weights']}; "
        f"engines at capacity factor {co2.moe.capacity_factor} (no drops), call by call: flips "
        f"(call, slot, request, margin) {flips_o}, largest logit difference on the slots "
        f"compared {dmax_o:.4g} (largest logit {scale_o:.4g})")
    _check_engine_flips("phase 16 olmoe-1b-7b no-drop", flips_o, dmax_o, scale_o)
    check(ro["max_abs"] <= MOE_TOL and ro["tokens_equal"],
          f"phase 16 olmoe float32 EP mesh disagrees with one device: {ro}")
    out["seconds"]["olmoe"] = time.perf_counter() - t0

    out["launches"] = launches.read()
    log(f"phase 16 launches of the four kernels on the mesh serving path: {out['launches']}")
    check(not any(out["launches"].values()),
          "phase 16: the mesh serving path launched a kernel it should not reach")
    out["seconds"]["total"] = time.perf_counter() - t_start
    return out


#: phase 17: mistral-large-123b's engine runs this many of its 88 layers
#: in bf16 (its weights take 1.38 B parameters a layer), the float32 check 2
MISTRAL_LAYERS = 4
#: the int8 pod sync against its input (tests/test_distributed.py:245)
POD_SCALES = 2
#: bf16 losses of one model on two layouts (tests/test_torch_training.py)
BF16_LOSS_REL = 1e-3
#: the mesh step trains: its loss falls over this many AdamW steps on one
#: batch (phi3-mini at full width, 2 layers)
FALL_STEPS, FALL_LR = 3, 1e-4


class _ForwardAt:
    """``transformer.forward`` at ``dtype`` while inside: ``lm_loss``, as
    the reference's, does not pass its ``compute_dtype`` on, so the
    float32 and float64 checks of a train step patch the forward (as
    tests/test_torch_training.py's ``f32_forward`` does)."""

    def __init__(self, dtype):
        import functools

        from repro_torch.models import transformer as T

        self.T, self.orig = T, T.forward
        self.patched = functools.partial(T.forward, compute_dtype=dtype)

    def __enter__(self):
        self.T.forward = self.patched
        return self

    def __exit__(self, *exc):
        self.T.forward = self.orig


def mesh_training(torch, launches: Launches, dev, single_timed: dict, single_first: dict) -> dict:
    """Phase 17: mesh LM training, the pod sync and the ``mlp_2d`` serving
    layout on a data=2 x model=2 mesh whose four cells share the card
    (results, launches and the host's cost of four cells; not scaling).

    (a) phi3-mini-3.8b at full width, 2 layers, B=4, S=1024, the state laid
    out by the train policy (FSDP: d_model over "data"): one AdamW mesh
    step against the one-device step, float32 forward at the microbatch
    tolerances and float64 params within ``F64_TOL``; one Adafactor step
    the same way in float32; (b) the timed mesh step with phase 15's
    configuration (``TRAIN_LAYERS`` layers, bf16, remat, fused loss, 4 x
    2048 tokens in 2 microbatches): ms a step, tokens/s, mfu, the
    allocator's peak against the laid-out states and one layer's gathered
    bf16 weights, beside phase 15's one-device step ``single_timed``, and
    its first step held to phase 15's from the same weights and batch
    (loss, grad norm, the signs of the first update on ``single_first``'s
    sample);
    (c) olmoe-1b-7b at full width, 2 of 16 layers, at a capacity that drops
    nothing: the mesh step (its experts' FSDP gather) against one device;
    (d) on pod=2 x data=2 x model=2, eight cells: ``compressed_pod_psum`` at
    phi3-mini's full-width gradient shapes (2 layers) within ``POD_SCALES``
    x scale a leaf, and a ``pod_compress=True`` step whose sync moves its
    gradient within that bound; (e) mistral-large-123b at full width in its
    ``ArchSpec``'s serving layout (``mlp_2d`` with the attention
    projections over ("data", "model"), the cache's sequence over "model"):
    float32 at 2 layers against one device in the mesh's summation order
    (:class:`_MeshOrder`) and plain, float64 at 2 layers, then the bf16
    engines at ``MISTRAL_LAYERS`` layers under phase 16's gates, each
    cell's bytes against the layout's count, ms per decode step.  The
    reference trains and serves these with ``jax.grad`` and ``einsum``s
    under its partitioner, outside any Pallas kernel: the phase checks that
    it launches none of the four kernels.
    """
    import dataclasses

    import numpy as np

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))           # benchmarks_torch
    from benchmarks_torch.common import PEAK_BF16_FLOPS
    from repro_torch.configs import registry
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt

    t_start = time.perf_counter()
    launches.reset()
    cards = [f"cuda:{dev.index or 0}"]
    mesh = make_mesh((2, 2), ("data", "model"), devices=cards * 4)
    out = {"mesh": mesh.describe(), "seconds": {}}

    def to_dev(batch):
        return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}

    def clone(tree):
        return T.tree_map(lambda _, t: t.clone(), tree)

    def clone_state(st):
        return lm.TrainState(clone(st.params), type(st.opt)(*clone(list(st.opt[:2])),
                                                            st.opt.step.clone()), st.step.clone())

    def as_dtype(st, dtype):
        cast = lambda tree: T.tree_map(lambda _, t: t.to(dtype), tree)  # noqa: E731
        return lm.TrainState(cast(st.params), type(st.opt)(*cast(list(st.opt[:2])),
                                                           st.opt.step.clone()), st.step.clone())

    def laid_out(cfg, st, m):
        return shd.shard_train_state(cfg, clone_state(st), m, shd.train_policy_for(cfg, m))

    def param_gap(a, b, atol, rtol):
        gap, bad = 0.0, 0
        for x, y in zip(T.tree_leaves(a), T.tree_leaves(shd.unshard_tree(b))):
            d = (x - y).abs()
            gap = max(gap, d.max().item())
            bad += int((d > atol + rtol * x.abs()).sum())
        return gap, bad

    def step_pair(cfg, st, batch, oc, dtype, m=mesh, **kw):
        """One step on one device and one on ``m`` from ``st``: the losses
        and (single params, mesh params)."""
        sm = laid_out(cfg, st, m)
        with _ForwardAt(dtype):          # the one-device step updates ``st`` in place
            s1, m1 = lm.make_train_step(cfg, oc, compute_dtype=dtype, **kw)(st, batch)
            s2, m2 = lm.make_train_step(cfg, oc, mesh=m, compute_dtype=dtype, **kw)(sm, batch)
        return m1["loss"].item(), m2["loss"].item(), s1.params, s2.params

    # (a) phi3-mini at full width, 2 layers
    t0 = time.perf_counter()
    full = registry.get_arch("phi3-mini-3.8b").model
    cfg2 = dataclasses.replace(full, n_layers=2)
    b2 = to_dev(next(synthetic_lm_batches(cfg2.vocab, 1024, 4, seed=1)))
    checks = {}
    for name in ("adamw", "adafactor"):
        oc = opt.OptConfig(name=name, lr=1e-3)
        st = lm.init_train_state(cfg2, torch.Generator(device=dev).manual_seed(0), oc)
        l1, l2, p1, p2 = step_pair(cfg2, st, b2, oc, torch.float32)
        gap, bad = param_gap(p1, p2, MB_ATOL, MB_RTOL)
        checks[name] = {"loss_single": l1, "loss_mesh": l2, "loss_rel": abs(l2 - l1) / abs(l1),
                        "params_max_abs": gap, "params_outside": bad}
        del p1, p2
        if name == "adamw":
            st64 = as_dtype(st, torch.float64)
            del st
            l1, l2, p1, p2 = step_pair(cfg2, st64, b2, oc, torch.float64)
            gap64, _ = param_gap(p1, p2, 0.0, 0.0)
            checks["adamw_f64"] = {"loss_single": l1, "loss_mesh": l2, "params_max_abs": gap64}
            del st64, p1, p2
        else:
            del st
        torch.cuda.empty_cache()
    # bf16, the timed step's dtype, at 2 layers: the first AdamW update's
    # moves of one sign on the mesh and on one device, leaf by leaf
    # (and on one device with the mesh's row-parallel products, the witness)
    oc = opt.OptConfig(lr=1e-3)
    st = lm.init_train_state(cfg2, torch.Generator(device=dev).manual_seed(0), oc)
    p0 = clone(st.params)
    sw = clone_state(st)
    l1, l2, p1, p2 = step_pair(cfg2, st, b2, oc, torch.bfloat16)
    with _RowSplit(2):
        sw, mw = lm.make_train_step(cfg2, oc)(sw, b2)

    def signs(a, b):
        return [((x - z).sign() == (y - z).sign()).float().mean().item()
                for z, x, y in zip(T.tree_leaves(p0), T.tree_leaves(a), T.tree_leaves(b))]
    sm, sw_ = signs(shd.unshard_tree(p2), p1), signs(sw.params, p1)
    checks["adamw_bf16"] = {"loss_single": l1, "loss_mesh": l2, "loss_rel": abs(l2 - l1) / abs(l1),
                            "loss_witness": mw["loss"].item(), "sign_agreement": sm,
                            "witness_sign_agreement": sw_,
                            "sign_shortfall": max(w - m for m, w in zip(sm, sw_))}
    del st, sw, mw, p0, p1, p2
    torch.cuda.empty_cache()
    # the mesh step trains: FALL_STEPS AdamW steps on one batch at 2 layers
    oc = opt.OptConfig(lr=FALL_LR)
    st = laid_out(cfg2, lm.init_train_state(cfg2, torch.Generator(device=dev).manual_seed(0), oc),
                  mesh)
    step = lm.make_train_step(cfg2, oc, mesh=mesh, fused_loss=True)
    falls = []
    for _ in range(FALL_STEPS):
        st, m = step(st, b2)
        falls.append(m["loss"].item())
    out["phi3_2_layers_falls"] = falls
    del st, step
    torch.cuda.empty_cache()
    out["phi3_2_layers"] = checks
    log(f"phase 17 mesh {out['mesh']}; phi3-mini-3.8b full width (d={full.d_model}, vocab "
        f"{full.padded_vocab}), 2 layers, B=4, S=1024, the train policy's layout (d_model over "
        f"data, heads/ff/vocab over model): one step on the mesh against one device: "
        + "; ".join(f"{k} loss {v['loss_mesh']:.6f} vs {v['loss_single']:.6f}"
                    + (f" (rel {v['loss_rel']:.3g}), params max|d| {v['params_max_abs']:.3g}, "
                       f"{v['params_outside']} outside atol {MB_ATOL} rtol {MB_RTOL}"
                       if "params_outside" in v else f", params max|d| "
                       f"{v['params_max_abs']:.3g} (tolerance {F64_TOL})" if "params_max_abs" in v
                       else f" (rel {v['loss_rel']:.3g}, tolerance {BF16_LOSS_REL}), the first "
                       f"update's moves of one sign as one device's, leaf by leaf: mesh "
                       + ", ".join(f"{x:.4f}" for x in v["sign_agreement"])
                       + "; one device with the row-parallel products "
                       + ", ".join(f"{x:.4f}" for x in v["witness_sign_agreement"])
                       + f" (gate: the mesh at most {FIRST_SIGN_SLACK} under it)")
        for k, v in checks.items()))
    log(f"  {FALL_STEPS} bf16 AdamW mesh steps (lr {FALL_LR}, fused loss) on that batch: losses "
        + ", ".join(f"{x:.6f}" for x in falls))
    for name in ("adamw", "adafactor"):
        check(checks[name]["loss_rel"] <= MB_LOSS_REL and checks[name]["params_outside"] == 0,
              f"phase 17 phi3 {name} mesh step disagrees with one device: {checks[name]}")
    check(all(b < a for a, b in zip(falls, falls[1:])),
          f"phase 17: the 2-layer mesh steps' loss did not fall: {falls}")
    check(checks["adamw_f64"]["params_max_abs"] <= F64_TOL,
          f"phase 17 phi3 float64 mesh step: {checks['adamw_f64']}")
    check(checks["adamw_bf16"]["loss_rel"] <= BF16_LOSS_REL
          and checks["adamw_bf16"]["sign_shortfall"] <= FIRST_SIGN_SLACK,
          f"phase 17 phi3 bf16 mesh step: {checks['adamw_bf16']}")
    out["seconds"]["phi3_2_layers"] = time.perf_counter() - t0

    # (b) the timed mesh step: phase 15's configuration
    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    oc = opt.OptConfig(lr=3e-4, grad_clip=1.0)
    params = T.init_params(cfg16, torch.Generator(device=dev).manual_seed(0))
    n_all = sum(t.numel() for t in T.tree_leaves(params))
    n_mm = _matmul_params(cfg16, params)
    layer_bf16 = 2 * sum(t.numel() // t.shape[0] for grp in params["blocks"]
                         for blk in grp.values() for t in blk.values())
    sp = shd.shard_params(cfg16, params, mesh, policy=shd.train_policy_for(cfg16, mesh))
    del params
    torch.cuda.empty_cache()
    st = lm.TrainState(sp, opt.adam_init(sp), torch.zeros((), dtype=torch.int32, device=dev))
    del sp
    state_bytes = sum(shd.device_bytes(st).values())
    by_cell = shd.cell_bytes(st, mesh)
    check(by_cell == shd.layout_bytes(st, mesh), "phase 17: the state's cell bytes differ "
          "from its layout's count")
    batch = to_dev(next(synthetic_lm_batches(cfg16.vocab, TRAIN_S, TRAIN_B, seed=0)))
    step = lm.make_train_step(cfg16, oc, mesh=mesh, microbatch=TRAIN_MB, remat=True,
                              fused_loss=True)
    before = _update_sample(st.params)
    check(all(torch.equal(before[k], single_first["before"][k]) for k in before),
          "phase 17: the timed mesh step does not start from phase 15's weights")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, m0 = step(st, batch)                         # warm-up
    after = _update_sample(st.params)
    agree = _sign_agreement(before, after, single_first["after"])
    agree_w = _sign_agreement(before, single_first["witness"], single_first["after"])
    agree_mw = _sign_agreement(before, after, single_first["witness"])
    del after
    del before
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    losses, norms = [], []
    ev[0].record()
    for i in range(3):
        st, m = step(st, batch)
        ev[i + 1].record()
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    peak = torch.cuda.max_memory_allocated()
    losses, norms = [x.item() for x in losses], [x.item() for x in norms]
    m0_loss, m0_norm = m0["loss"].item(), m0["grad_norm"].item()
    n1, nw = single_timed["warmup_grad_norm"], single_first["witness_grad_norm"]
    norm_bound = max(FIRST_NORM_REL, 3 * abs(nw - n1) / n1)
    ln_v = math.log(cfg16.vocab)
    tokens = TRAIN_B * TRAIN_S
    ms_mean = sum(ms) / len(ms)
    mfu = 6 * n_mm * tokens / (ms_mean / 1e3 * PEAK_BF16_FLOPS)
    out["timed"] = {"ms": ms, "ms_mean": ms_mean, "tokens_per_s": tokens / ms_mean * 1e3,
                    "mfu": mfu, "peak_bytes": peak, "state_bytes": state_bytes,
                    "state_bytes_by_cell": by_cell, "layer_gathered_bf16_bytes": layer_bf16,
                    "losses": losses, "grad_norms": norms, "params": n_all,
                    "matmul_params": n_mm, "warmup_loss": m0_loss,
                    "warmup_grad_norm": m0_norm, "single_device_warmup_grad_norm": n1,
                    "warmup_loss_minus_ln_vocab": m0_loss - ln_v,
                    "single_device_warmup_loss_minus_ln_vocab":
                        single_timed["warmup_loss"] - ln_v,
                    "first_update_sign_agreement": agree,
                    "witness_first_update_sign_agreement": agree_w,
                    "mesh_vs_witness_first_update_sign_agreement": agree_mw,
                    "witness_warmup_grad_norm": nw,
                    "witness_warmup_loss": single_first["witness_loss"],
                    "single_device_warmup_loss": single_timed["warmup_loss"],
                    "single_device_ms_mean": single_timed["ms_mean"],
                    "single_device_peak_bytes": single_timed["peak_bytes"]}
    log(f"phase 17 timed mesh train step: phi3-mini-3.8b full width, {TRAIN_LAYERS} of "
        f"{full.n_layers} layers ({n_all} parameters, {n_mm} in products), AdamW lr 3e-4 clip "
        f"1.0, bf16, remat (the FSDP gathers inside each layer's checkpoint), fused loss, batch "
        f"{TRAIN_B} x {TRAIN_S}, microbatch {TRAIN_MB}, on {out['mesh']}: warm-up loss "
        f"{m0_loss:.6f} (phase 15's {single_timed['warmup_loss']:.6f}; less ln V = {ln_v:.6f}: "
        f"{m0_loss - ln_v:.6f} against {single_timed['warmup_loss'] - ln_v:.6f}), grad norm "
        f"{m0_norm:.6g} (phase 15's {n1:.6g}, rel {abs(m0_norm - n1) / n1:.4g}, gate "
        f"{norm_bound:.4g}; one device with the row-parallel products {nw:.6g}, rel "
        f"{abs(nw - n1) / n1:.4g}, "
        f"loss {single_first['witness_loss']:.6f}), the first update's moves of one sign as "
        f"phase 15's in " + ", ".join(f"{k} {v:.4f} (row split: {agree_w[k]:.4f}; the mesh "
                                      f"as the row split: {agree_mw[k]:.4f})"
                                      for k, v in agree.items())
        + f" of the entries (gates: at most {FIRST_SIGN_SLACK} under the row split's; the mesh "
        f"as the row split in {WITNESS_SIGN_AGREE} or more, its grad norm within "
        f"{WITNESS_NORM_REL} of the row split's: rel {abs(m0_norm - nw) / nw:.4g}); steps "
        + ", ".join(
            f"{t:.2f} ms (loss {x:.4f}, grad norm {g:.4g})" for t, x, g in zip(ms, losses, norms))
        + f"; mean {ms_mean:.2f} ms, {tokens / ms_mean * 1e3:.0f} tokens/s, mfu {mfu:.4f} "
        f"(6 N tokens over {PEAK_BF16_FLOPS:.4g} FLOP/s); phase 15's one-device step "
        f"{single_timed['ms_mean']:.2f} ms "
        f"({ms_mean / single_timed['ms_mean']:.2f}x); allocator peak {peak} B "
        f"against the laid-out states' {state_bytes} B on the card (cells "
        f"{by_cell} B) and one layer's gathered bf16 weights {layer_bf16} B; phase 15's "
        f"one-device peak {single_timed['peak_bytes']} B")
    # 16 random layers of the reference's init: neither step's loss is
    # monotone (phase 15's warm-up loss is below its last) and a random
    # model's loss sits near ln V; the first step, from the same weights and
    # batch as phase 15's, holds the mesh's gradient to one device's
    check(all(math.isfinite(x) for x in losses + [m0_loss])
          and abs(m0_loss - single_timed["warmup_loss"])
          <= BF16_LOSS_REL * abs(single_timed["warmup_loss"]),
          f"phase 17: the timed mesh step's first loss {m0_loss} against phase 15's "
          f"{single_timed['warmup_loss']}, losses {losses}")
    check(abs(m0_norm - n1) <= norm_bound * n1,
          f"phase 17: the timed mesh step's first grad norm {m0_norm} against phase 15's {n1} "
          f"(row split: {nw})")
    check(all(agree[k] >= agree_w[k] - FIRST_SIGN_SLACK for k in agree),
          f"phase 17: the timed mesh step's first update against phase 15's: {agree} "
          f"(row split: {agree_w})")
    check(min(agree_mw.values()) >= WITNESS_SIGN_AGREE
          and abs(m0_norm - nw) <= WITNESS_NORM_REL * nw,
          f"phase 17: the timed mesh step's first update against one device with its "
          f"row-parallel products: signs {agree_mw}, grad norm {m0_norm} against {nw}")
    del st, m, m0, batch, step
    torch.cuda.empty_cache()
    out["seconds"]["timed"] = time.perf_counter() - t0

    # (c) olmoe-1b-7b at full width, 2 layers, no pair dropped: the experts' FSDP gather
    t0 = time.perf_counter()
    cfg_o = _no_drop(dataclasses.replace(registry.get_arch("olmoe-1b-7b").model, n_layers=2))
    oc = opt.OptConfig(lr=1e-3)
    st = lm.init_train_state(cfg_o, torch.Generator(device=dev).manual_seed(0), oc)
    bo = to_dev(next(synthetic_lm_batches(cfg_o.vocab, 256, 4, seed=2)))
    l1, l2, p1, p2 = step_pair(cfg_o, st, bo, oc, torch.float32)
    gap, bad = param_gap(p1, p2, MB_ATOL, MB_RTOL)
    wg = p2["blocks"][0]["0"]["w_gate"]
    out["olmoe"] = {"loss_single": l1, "loss_mesh": l2, "loss_rel": abs(l2 - l1) / abs(l1),
                    "params_max_abs": gap, "params_outside": bad, "w_gate_spec": list(wg.spec),
                    "capacity_factor": cfg_o.moe.capacity_factor}
    log(f"phase 17 olmoe-1b-7b full width ({cfg_o.moe.n_experts} experts top-"
        f"{cfg_o.moe.top_k}), 2 layers, capacity factor {cfg_o.moe.capacity_factor} (no pair "
        f"drops), B=4, S=256, w_gate laid out {wg.spec} (experts over model, d_model over data, "
        f"gathered before use): AdamW mesh step loss {l2:.6f} vs one device {l1:.6f} (rel "
        f"{abs(l2 - l1) / abs(l1):.3g}), params max|d| {gap:.3g}, {bad} outside")
    check(abs(l2 - l1) / abs(l1) <= MB_LOSS_REL and bad == 0,
          f"phase 17 olmoe mesh step disagrees with one device: {out['olmoe']}")
    del st, p1, p2, wg, bo
    torch.cuda.empty_cache()
    out["seconds"]["olmoe"] = time.perf_counter() - t0

    # (d) the pod sync on eight cells
    t0 = time.perf_counter()
    mesh8 = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=cards * 8)
    pol8 = shd.train_policy_for(cfg2, mesh8)
    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = T.param_shapes(cfg2)
    grads = T._shape_tree_map(lambda _, shape: torch.randn(shape, generator=gen, device=dev)
                              * 1e-3, shapes)
    sg = shd.shard_tree(grads, shd.tree_specs(T.logical_axes_tree(cfg2), pol8), mesh8)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    synced = lm.compressed_pod_psum(sg, lm.pod_generator(0, dev), mesh8)
    e1.record()
    torch.cuda.synchronize()
    worst = 0.0
    for g, o in zip(T.tree_leaves(grads), T.tree_leaves(synced)):
        scale = g.abs().max().item() / 127
        worst = max(worst, (o.unshard() - g).abs().max().item() / scale)
    n_grad = sum(t.numel() for t in T.tree_leaves(grads))
    del grads, sg, synced
    oc = opt.OptConfig(lr=1e-3)
    st = lm.init_train_state(cfg2, torch.Generator(device=dev).manual_seed(0), oc)
    bp = to_dev(next(synthetic_lm_batches(cfg2.vocab, 512, 4, seed=4)))
    runs, synced = [], {}
    sync = lm.compressed_pod_psum

    def tap(g, noise, m):             # the pod step's gradients before and after the sync
        synced["in"], synced["out"] = g, sync(g, noise, m)
        return synced["out"]
    for pod in (False, True):
        lm.compressed_pod_psum = tap
        try:
            with _ForwardAt(torch.float32):
                runs.append(lm.make_train_step(cfg2, oc, mesh=mesh8, pod_compress=pod,
                                               compute_dtype=torch.float32)(
                    laid_out(cfg2, st, mesh8), bp))
        finally:
            lm.compressed_pod_psum = sync
    (s0, m0), (s1, m1) = runs
    pgap = max((a.unshard() - b.unshard()).abs().max().item()
               for a, b in zip(T.tree_leaves(s0.params), T.tree_leaves(s1.params)))
    step_worst, moved = 0.0, 0
    for g, o in zip(T.tree_leaves(synced["in"]), T.tree_leaves(synced["out"])):
        g, o = g.unshard(), o.unshard()
        d = (o - g).abs().max().item()
        step_worst = max(step_worst, d / (g.abs().max().item() / 127))
        moved += d > 0
    gn_in = opt.global_norm(synced["in"]).item()
    gn_out = opt.global_norm(synced["out"]).item()
    n0, n1 = m0["grad_norm"].item(), m1["grad_norm"].item()
    out["pod"] = {"mesh": mesh8.describe(), "grad_elements": n_grad,
                  "worst_err_over_scale": worst, "sync_ms": e0.elapsed_time(e1),
                  "loss": m1["loss"].item(), "grad_norm": n1, "grad_norm_uncompressed": n0,
                  "step_sync_in_grad_norm": gn_in, "step_sync_out_grad_norm": gn_out,
                  "step_sync_worst_err_over_scale": step_worst, "step_sync_leaves_moved": moved,
                  "params_max_abs_vs_uncompressed": pgap}
    log(f"phase 17 pod sync on {mesh8.describe()}: compressed_pod_psum of phi3-mini's "
        f"full-width gradient shapes (2 layers, {n_grad} elements, N(0, 1e-3)) in "
        f"{e0.elapsed_time(e1):.1f} ms, the largest error {worst:.4f} x its leaf's scale (bound "
        f"{POD_SCALES}); pod_compress=True step (B=4, S=512, float32): loss "
        f"{m1['loss'].item():.6f}; its sync's input has the uncompressed step's grad norm "
        f"({gn_in:.9g} against {n0:.9g}), its output the step's ({gn_out:.9g} against "
        f"{n1:.9g}), {moved} of {len(T.tree_leaves(synced['in']))} leaves moved by it, the "
        f"largest by {step_worst:.4f} x the leaf's scale (bound {POD_SCALES}); params max|d| "
        f"{pgap:.3g} from the uncompressed step's (bound 2 lr = {2 * oc.lr})")
    check(worst <= POD_SCALES, f"phase 17: the pod sync's error {worst} x scale")
    check(math.isfinite(m1["loss"].item()) and 0 < pgap <= 2 * oc.lr * (1 + 1e-3)
          and moved > 0 and step_worst <= POD_SCALES and n1 != n0
          and abs(gn_in - n0) <= 1e-6 * n0 and abs(gn_out - n1) <= 1e-6 * n1,
          f"phase 17: the pod_compress step: {out['pod']}")
    del synced
    del st, s0, s1, runs, bp
    torch.cuda.empty_cache()
    out["seconds"]["pod"] = time.perf_counter() - t0

    # (e) mistral-large-123b at full width, its ArchSpec's serving layout
    t0 = time.perf_counter()
    spec_m = registry.get_arch("mistral-large-123b")
    check(spec_m.serve_mlp_2d and spec_m.serve_seq_shard,
          "mistral-large-123b's ArchSpec no longer asks for mlp_2d with a sequence-split cache")
    cfg_m2 = dataclasses.replace(spec_m.model, n_layers=2)
    pm = T.init_params(cfg_m2, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg_m2.vocab, (4, 12)).astype(np.int32)).to(dev)
    rm = _mesh_vs_single(torch, cfg_m2, pm, mesh, torch.float32, tokens, 8, 32, seq=True,
                         mlp_2d=True, witness=True, order=True)
    p64 = T.tree_map(lambda _, t: t.double(), pm)
    del pm
    torch.cuda.empty_cache()
    rm64 = _mesh_vs_single(torch, cfg_m2, p64, mesh, torch.float64, tokens, 8, 32, seq=True,
                           mlp_2d=True)
    del p64
    torch.cuda.empty_cache()
    cfg_m = dataclasses.replace(spec_m.model, n_layers=MISTRAL_LAYERS)
    pm = T.init_params(cfg_m, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    pm = T.tree_map(lambda n, t: t.float() if n in T.FLOAT32_LEAVES else t, pm)
    sp = shd.shard_params(cfg_m, pm, mesh, serve_seq_shard=True, mlp_2d=True)
    serve_ex = _load_script("examples_torch/serve_lm.py")
    runs = {"mesh": _engine_run(torch, serve_ex, cfg_m, sp, "mistral-large-123b mlp_2d mesh",
                                mesh=mesh, serve_seq_shard=True)}
    del sp
    runs["single"] = _engine_run(torch, serve_ex, cfg_m, pm, "mistral-large-123b single",
                                 device=dev)
    del pm
    torch.cuda.empty_cache()
    flips, dmax, skipped = _engine_flips(runs["single"][1], runs["mesh"][1], 4, "admit")
    scale = max(float(np.abs(r[4]).max()) for r in runs["single"][1])
    same = sum(a.out == b.out for a, b in zip(runs["single"][0], runs["mesh"][0]))
    cells = runs["mesh"][3]
    out["mistral"] = {"f32_2_layers": rm, "f64_2_layers": rm64, "engine": {
        "mesh": runs["mesh"][2], "single": runs["single"][2], "flips": flips,
        "max_logit_diff": dmax, "max_logit": scale, "requests_equal": same,
        "not_compared": skipped, "bytes_by_cell": cells}}
    log(f"phase 17 mistral-large-123b (d={cfg_m.d_model}, d_ff={cfg_m.d_ff}, {cfg_m.n_heads} "
        f"heads, kv {cfg_m.n_kv}; mlp_2d: the FFN over (data, model), wq/wk/wv's d_model over "
        f"(data, model), wo's over model, the cache's sequence over model): float32 at 2 layers, "
        f"B=4 x 12 tokens, prefill + 8 decode steps, max|d| {rm['max_abs']:.4g} (prefill "
        f"{rm['prefill_max_abs']:.4g}; largest logit {rm['max_logit']:.4g}), tokens equal "
        f"{rm['tokens_equal']}; one device in the mesh's order (each data block's rows alone, the "
        f"FFN in the model cells' blocks summed in order, the decode attention over the cache's "
        f"two sequence halves combined by flash-decode): {rm['order_max_abs']:.4g} from the "
        f"plain single device, {rm['mesh_vs_order']:.4g} from the mesh (prefill "
        f"{rm['mesh_vs_order_prefill']:.4g}), tokens equal the mesh's "
        f"{rm['order_tokens_equal']} (gates: the mesh within {FWD_TOL} of it, and within "
        f"{FWD_TOL} or {MESH_F64_WITNESS}x its distance of one device); other witnesses, "
        f"reported: wo and w_down in 2 blocks {rm['witness_max_abs']:.4g}, every weight one ulp "
        f"up {rm['ulp_max_abs']:.4g}; float64 at 2 layers max|d| {rm64['max_abs']:.4g} "
        f"(tolerance {F64_TOL}), tokens equal {rm64['tokens_equal']}; engines at "
        f"{MISTRAL_LAYERS} of {spec_m.model.n_layers} layers in bf16: decode step "
        f"{runs['mesh'][2]['decode_ms_mean']:.3f} (mesh) against "
        f"{runs['single'][2]['decode_ms_mean']:.3f} ms, {runs['mesh'][2]['tokens_per_s']:.1f} "
        f"against {runs['single'][2]['tokens_per_s']:.1f} tokens/s; {same} of 6 requests token "
        f"for token; flips (call, slot, request, margin) {flips}; largest logit difference "
        f"{dmax:.4g} (largest logit {scale:.4g}); weight bytes a cell {cells['weights']} "
        f"(layout {cells['weights_layout']}), on the card {cells['weights_on_card']}")
    # d=12288 and 96 heads at the reference's init (wq ~ N(0, 1/96)) amplify
    # float32 rounding over 2 layers: the mesh is held to one device run in
    # its own summation order at phase 13's float32 tolerance, to the plain
    # one device within that or 10x the order's distance from it (as phase
    # 16 holds its deepest float64 run), and in float64 at 1e-7
    check(rm["mesh_vs_order"] <= FWD_TOL and rm["order_tokens_equal"],
          f"phase 17 mistral float32 mlp_2d mesh disagrees with one device in its order: {rm}")
    check(rm["max_abs"] <= max(FWD_TOL, MESH_F64_WITNESS * rm["order_max_abs"])
          and rm["tokens_equal"],
          f"phase 17 mistral float32 mlp_2d mesh disagrees with one device: {rm}")
    check(rm64["max_abs"] <= F64_TOL and rm64["tokens_equal"],
          f"phase 17 mistral float64 mlp_2d mesh disagrees with one device: {rm64}")
    _check_engine_flips("phase 17 mistral-large-123b mlp_2d", flips, dmax, scale)
    check(cells["weights"] == cells["weights_layout"],
          "phase 17: mistral's cell bytes differ from the layout's count")
    out["seconds"]["mistral"] = time.perf_counter() - t0

    out["launches"] = launches.read()
    log(f"phase 17 launches of the four kernels on the mesh training path: {out['launches']}")
    check(not any(out["launches"].values()),
          "phase 17: the mesh training path launched a kernel it should not reach")
    out["seconds"]["total"] = time.perf_counter() - t_start
    return out


#: phase 18: recurrentgemma-2b's float32 check runs one period (R, R, A)
#: on a prompt longer than its 2048 window, so the prefill's ring is rolled
#: (slot p % 2048 holds position p; the chunked prefill attention takes a
#: multiple of its 512-position chunks), and decode steps that write past
#: the roll; its float64 check the deepest of these depths that fits on the
#: card beside what earlier phases hold (a fresh float64 draw from seed 0)
RG_F32_LAYERS, RING_PROMPT, RING_STEPS = 3, 2560, 16
RG_F64_DEPTHS = (26, 13, 6)
#: rwkv6-7b: float32 at 2 layers, float64 at the deepest of these that fits
#: (its float64 weights take 1.75 GB a layer, and 4.3 GB of embedding and
#: head; the mesh holds a laid-out copy beside them)
RWKV_F32_LAYERS = 2
RWKV_F64_DEPTHS = (16, 8, 4)
#: the train steps: recurrentgemma at one period, rwkv6 at 2 layers, B=2 x
#: MESH18_TRAIN_S tokens (a multiple of 64: rwkv6's chunked WKV scan)
MESH18_TRAIN_S = 128
#: phase 18's bf16 engines: the witness factor of :func:`_check_bf16_engines`
MESH_BF16_WITNESS = 2
#: the leaves ``init_params`` sets to zero and phase 18 draws from its seed
#: (N(0, 0.2); ``ln_w`` 1 + N(0, 0.2)): at zero RWKV6's group-norm scale
#: would make its whole time mix 0
DRAWN_LEAVES = ("ln1", "ln2", "final_norm", "ln_w", "ln_b", "u")


def _check_bf16_engines(label, flips, dmax, scale, dmax_ulp):
    """Phase 18's gate on the bf16 engines, mesh against one device: phase
    16's (logits within ``MESH_BF16_REL`` x the largest, flips under
    ``MESH_NEAR_TIE``), each bound raised to ``MESH_BF16_WITNESS`` x the
    distance at which one device's engine lands from itself with every
    bf16 weight one ulp up (``dmax_ulp``): where a deep recurrent network
    turns a rounding into that much, the mesh's rounding (another one) may
    do about as much."""
    wit = MESH_BF16_WITNESS * dmax_ulp
    check(dmax <= max(MESH_BF16_REL * scale, wit),
          f"{label}: the mesh engine's logits are {dmax} from one device's (bound "
          f"{MESH_BF16_REL}x the largest logit {scale}, or {MESH_BF16_WITNESS}x one ulp's "
          f"{dmax_ulp})")
    check(all(f[3] < max(MESH_NEAR_TIE, wit) for f in flips),
          f"{label}: a flip at a margin of {max(MESH_NEAR_TIE, wit)} or more: {flips}")


def mesh_recurrent(torch, launches: Launches, dev, single_prefill_ms: dict) -> dict:
    """Phase 18: the recurrent blocks and the ring decode on a data=2 x
    model=2 mesh whose four cells share the card (results, launches and
    the host's cost of four cells; not scaling).  For recurrentgemma-2b
    (RG-LRU and window-2048 MQA attention, 10 heads padded to 16) and
    rwkv6-7b (64 heads of 64) at full width, random weights from seed 0
    (``DRAWN_LEAVES`` drawn too):

    (a) float32 at a cut depth against one device at ``FWD_TOL``:
    recurrentgemma's ``RING_PROMPT``-token prompt rolls its ring and
    ``RING_STEPS`` decode steps write past the roll, the ring's positions
    equal to one device's (deeper than 2 layers the gate is ``FWD_TOL`` or
    ``MESH_F64_WITNESS`` x the distance of one device with every weight one
    ulp up, as phase 16's float64 gate at 16 layers); (b) the bf16 engines at full depth on the
    example's traffic (4 slots) under :func:`_check_bf16_engines`, ms a
    decode step, tokens/s, each cell's bytes of weights and cache against
    the layout's count; (c) a
    timed bf16 mesh prefill of 512 tokens beside phase 14's one-device
    ``single_prefill_ms``; (d) one AdamW mesh train step at a cut depth
    against one device (float32 at the microbatch bounds, float64 params
    within ``F64_TOL``); (e) float64 at the deepest depth that fits within
    ``F64_TOL`` or that witness's bound.  The reference computes these blocks with ``einsum``s and
    scans under its partitioner, outside any Pallas kernel: the phase
    launches none of the four kernels.
    """
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt

    t_start = time.perf_counter()
    launches.reset()
    serve_ex = _load_script("examples_torch/serve_lm.py")
    mesh = make_mesh((2, 2), ("data", "model"), devices=[f"cuda:{dev.index or 0}"] * 4)
    out = {"mesh": mesh.describe(), "seconds": {}}

    def draw(cfg, depth, dtype):
        """``cfg`` at ``depth`` layers, its weights from seed 0 in ``dtype``."""
        c = dataclasses.replace(cfg, n_layers=depth)
        p = T.init_params(c, torch.Generator(device=dev).manual_seed(0), dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(1)

        def fill(name, t):
            if name in DRAWN_LEAVES:
                z = torch.randn(t.shape, generator=gen, device=dev) * 0.2
                t.copy_(z + 1 if name == "ln_w" else z)
            return t
        return c, T.tree_map(fill, p)

    def serving_dtype(n, p):
        return torch.bfloat16 if n not in T.FLOAT32_LEAVES else None

    def tokens(vocab, B, S, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(np.int32)).to(dev)

    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        t0 = time.perf_counter()
        rg = arch == "recurrentgemma-2b"
        full = registry.get_arch(arch).model
        res = out[arch] = {}
        cfg, params = draw(full, full.n_layers, torch.float32)
        torch.cuda.synchronize()
        label = f"phase 18 {arch}"
        heads = (f"{full.n_heads} heads padded to {full.padded_heads}, kv {full.n_kv}, window "
                 f"{full.sliding_window}, d_rnn {full.d_rnn}" if rg else
                 f"{full.d_model // 64} heads of 64 ({full.d_model // 128} a cell)")
        log(f"{label} (d={full.d_model}, {heads}, d_ff {full.d_ff}, vocab {full.vocab}, "
            f"{full.n_layers} layers, groups {T.scan_groups(full)}) on {out['mesh']}")

        # (a) float32 at a cut depth
        depth = RG_F32_LAYERS if rg else RWKV_F32_LAYERS
        c32, p32 = _first_layers(cfg, params, depth)
        B, S, steps = (2, RING_PROMPT, RING_STEPS) if rg else (4, 64, 16)
        r32 = _mesh_vs_single(torch, c32, p32, mesh, torch.float32,
                              tokens(cfg.vocab, B, S, 0), steps, S + steps, witness="ulp")
        res["f32"] = dict(r32, layers=depth, prompt=S, steps=steps, batch=B)
        ring = ""
        if rg:
            rr = r32["ring"]
            ring = (f"; the ring: {rr['slots']} slots hold positions {rr['first']}-{rr['last']} "
                    f"(the newest in slot {rr['slot_of_last']}), equal to one device's "
                    f"{rr['equal_to_single']}")
            check(rr["slots"] == full.sliding_window and rr["last"] == S + steps - 1
                  and rr["first"] == S + steps - full.sliding_window
                  and rr["slot_of_last"] == (S + steps - 1) % full.sliding_window
                  and rr["equal_to_single"],
                  f"{label}: the ring was not rolled and wrapped as on one device: {rr}")
        log(f"  float32 at {depth} layers, B={B} x {S} tokens, prefill + {steps} decode steps, "
            f"mesh against one device: max|d| {r32['max_abs']:.3g} (prefill "
            f"{r32['prefill_max_abs']:.3g}; one device with every weight one ulp up "
            f"{r32['ulp_max_abs']:.3g} from it; tolerance {FWD_TOL} or {MESH_F64_WITNESS}x "
            f"that), tokens equal {r32['tokens_equal']}, largest logit {r32['max_logit']:.4g}, "
            f"a cell's first cache leaf {r32['cache_cell_shape']}{ring}; seconds (single, "
            f"mesh) {r32['seconds']}")
        check(r32["max_abs"] <= max(FWD_TOL, MESH_F64_WITNESS * r32["ulp_max_abs"])
              and r32["tokens_equal"], f"{label} float32 mesh disagrees with one device: {r32}")
        del p32

        # (b) the bf16 engines at full depth, and the witness: one device
        # with every bf16 weight one ulp up
        runs = {}
        for where, kw in (("mesh", dict(mesh=mesh)), ("single", dict(device=dev))):
            runs[where] = _engine_run(torch, serve_ex, cfg, params, f"{arch} {where}", **kw)
        up = T.tree_map(lambda n, t: t if n in T.FLOAT32_LEAVES else
                        t.to(torch.bfloat16).nextafter(t.new_full((), math.inf, dtype=torch.bfloat16)),
                        params)
        runs["ulp"] = _engine_run(torch, serve_ex, cfg, up, f"{arch} single, weights one ulp up",
                                  device=dev)
        del up
        torch.cuda.empty_cache()
        flips, dmax, skipped = _engine_flips(runs["single"][1], runs["mesh"][1], 4, "never")
        flips_w, dmax_w, _ = _engine_flips(runs["single"][1], runs["ulp"][1], 4, "never")
        scale = max(float(np.abs(r[4]).max()) for r in runs["single"][1])
        same = sum(a.out == b.out for a, b in zip(runs["single"][0], runs["mesh"][0]))
        by_cell = runs["mesh"][3]
        res["engine"] = {"mesh": runs["mesh"][2], "single": runs["single"][2], "flips": flips,
                         "max_logit_diff": dmax, "max_logit": scale, "requests_equal": same,
                         "not_compared": skipped, "bytes_by_cell": by_cell,
                         "ulp_flips": flips_w, "ulp_max_logit_diff": dmax_w}
        del runs
        torch.cuda.empty_cache()
        m_, s_ = res["engine"]["mesh"], res["engine"]["single"]
        log(f"  engines (bf16, {full.n_layers} layers), mesh against one device: decode step "
            f"{m_['decode_ms_mean']:.3f} against {s_['decode_ms_mean']:.3f} ms "
            f"({m_['decode_ms_mean'] / s_['decode_ms_mean']:.2f}x), {m_['tokens_per_s']:.1f} "
            f"against {s_['tokens_per_s']:.1f} tokens/s; {same} of 6 requests token for token; "
            f"flips (call, slot, request, the single device's top-2 margin) {flips}; largest "
            f"logit difference on the slots compared {dmax:.4g} (largest logit {scale:.4g}); "
            f"one device with its bf16 weights one ulp up: flips {flips_w}, largest logit "
            f"difference {dmax_w:.4g}")
        _check_bf16_engines(label, flips, dmax, scale, dmax_w)
        log(f"  bytes a cell (data, model) = (0,0) (0,1) (1,0) (1,1): weights "
            f"{by_cell['weights']} (layout {by_cell['weights_layout']}), cache "
            f"{by_cell['cache']} (layout {by_cell['cache_layout']}); on the card: weights "
            f"{by_cell['weights_on_card']}, cache {by_cell['cache_on_card']}")
        check(by_cell["weights"] == by_cell["weights_layout"]
              and by_cell["cache"] == by_cell["cache_layout"],
              f"{label}: a cell's bytes differ from its layout's count")

        # (c) a timed bf16 mesh prefill of 512 tokens
        sp16 = shd.shard_params(cfg, params, mesh, dtype_of=serving_dtype)
        toks = tokens(cfg.vocab, 1, 512, 1)
        prefill = lm.make_prefill_step(cfg, mesh=mesh)
        ms = cuda_ms(torch, lambda: prefill(sp16, {"tokens": toks}), reps=1)
        tok, cache = prefill(sp16, {"tokens": toks})
        check(0 <= int(tok[0]) < cfg.padded_vocab and all(
            bool(torch.isfinite(t.float()).all()) for leaf in T.tree_leaves(cache)
            for t in leaf.cells), f"{label}: the bf16 mesh prefill gave no valid token or a "
            "non-finite cache")
        res["prefill_512_ms"] = ms
        one = single_prefill_ms.get(arch)
        log(f"  bf16 mesh prefill of 512 tokens: {ms:.2f} ms ({512 / ms * 1e3:.0f} tokens/s); "
            f"phase 14's one-device prefill {one if one is None else f'{one:.2f}'} ms")
        del sp16, cache, prefill
        torch.cuda.empty_cache()

        # (d) one AdamW mesh train step at a cut depth, float32 and float64;
        # the full-depth weights are freed first (rwkv6's take 30 GB)
        ct, pt = _first_layers(cfg, params, depth)
        pt = T.tree_map(lambda _, t: t.clone(), pt)
        del params
        torch.cuda.empty_cache()
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
                 next(synthetic_lm_batches(cfg.vocab, MESH18_TRAIN_S, 2, seed=1)).items()}
        oc = opt.OptConfig(lr=1e-3)
        tr = {}
        for dt in (torch.float32, torch.float64):
            def state():
                p = T.tree_map(lambda _, t: t.to(dt, copy=True), pt)
                return lm.TrainState(p, opt.adam_init(p), torch.zeros((), dtype=torch.int32,
                                                                      device=dev))
            with _ForwardAt(dt):
                s1, m1 = lm.make_train_step(ct, oc, compute_dtype=dt)(state(), batch)
                kept = (m1["loss"].item(), T.tree_leaves(s1.params))
                del s1
                sm = shd.shard_train_state(ct, state(), mesh, shd.train_policy_for(ct, mesh))
                s2, m2 = lm.make_train_step(ct, oc, mesh=mesh, compute_dtype=dt)(sm, batch)
            gap, bad = 0.0, 0
            for x, y in zip(kept[1], T.tree_leaves(shd.unshard_tree(s2.params))):
                d = (x - y).abs()
                gap = max(gap, d.max().item())
                bad += int((d > MB_ATOL + MB_RTOL * x.abs()).sum())
            tr[str(dt).split(".")[-1]] = {"loss_single": kept[0], "loss_mesh": m2["loss"].item(),
                                          "params_max_abs": gap, "params_outside": bad}
            del kept, sm, s2
            torch.cuda.empty_cache()
        res["train"] = dict(tr, layers=depth, batch=2, seq=MESH18_TRAIN_S)
        f32, f64 = tr["float32"], tr["float64"]
        rel = abs(f32["loss_mesh"] - f32["loss_single"]) / abs(f32["loss_single"])
        log(f"  one AdamW train step at {depth} layers, B=2 x {MESH18_TRAIN_S} tokens (train "
            f"policy), mesh against one device: float32 loss {f32['loss_mesh']:.6f} against "
            f"{f32['loss_single']:.6f} (rel {rel:.3g}), params max|d| {f32['params_max_abs']:.3g}, "
            f"{f32['params_outside']} outside atol {MB_ATOL} rtol {MB_RTOL}; float64 params "
            f"max|d| {f64['params_max_abs']:.3g} (tolerance {F64_TOL})")
        check(rel <= MB_LOSS_REL and f32["params_outside"] == 0
              and f64["params_max_abs"] <= F64_TOL,
              f"{label}: the mesh train step disagrees with one device: {tr}")
        del ct, pt, batch
        torch.cuda.empty_cache()

        # (e) float64 at the deepest depth that fits
        r64 = None
        for d in (RG_F64_DEPTHS if rg else RWKV_F64_DEPTHS):
            try:
                c64, p64 = draw(full, d, torch.float64)
                r64 = _mesh_vs_single(torch, c64, p64, mesh, torch.float64,
                                      tokens(cfg.vocab, B, S, 2), steps, S + steps,
                                      witness="ulp")
                r64["layers"] = d
                break
            except torch.cuda.OutOfMemoryError:
                log(f"  float64 at {d} layers does not fit beside what the card holds")
            finally:
                p64 = None
                torch.cuda.empty_cache()
        check(r64 is not None, f"{label}: no float64 depth fits")
        res["f64"] = r64
        log(f"  float64 at {r64['layers']} of {full.n_layers} layers, B={B} x {S} tokens, "
            f"prefill + {steps} decode steps: max|d| {r64['max_abs']:.4g} (one device with "
            f"every weight one ulp up {r64['ulp_max_abs']:.4g} from it; tolerance {F64_TOL} or "
            f"{MESH_F64_WITNESS}x that), tokens equal {r64['tokens_equal']}, largest logit "
            f"{r64['max_logit']:.6g}; seconds (single, mesh) {r64['seconds']}")
        check(r64["max_abs"] <= max(F64_TOL, MESH_F64_WITNESS * r64["ulp_max_abs"])
              and r64["tokens_equal"], f"{label} float64 mesh disagrees with one device: {r64}")
        out["seconds"][arch] = time.perf_counter() - t0
        log(f"{label}: {out['seconds'][arch]:.1f} s")

    out["launches"] = launches.read()
    log(f"phase 18 launches of the four kernels on the recurrent mesh path: {out['launches']}")
    check(not any(out["launches"].values()),
          "phase 18: the recurrent mesh path launched a kernel it should not reach")
    out["seconds"]["total"] = time.perf_counter() - t_start
    return out


def _als_wave_data(torch, dev, m: int, p: int, k_loc: int, n_pad: int, f: int, seed: int = 0):
    """Synthetic ratings for one update-X wave in ``build_als_cell``'s
    layout, from ``seed``: each of ``m`` rows rates a geometric number of
    each column shard's items (netflix's mean, 206 a row, over ``p``
    shards, at most ``k_loc``), values 1-5; theta ~ N(0, 0.1^2)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    npp = n_pad // p
    cnt = np.minimum(rng.geometric(p / 206.0, size=(m, p)), k_loc).astype(np.int32)
    slot = np.arange(k_loc)[None, None, :]
    live = slot < cnt[:, :, None]
    idx = np.where(live, rng.integers(0, npp, size=(m, p, k_loc)), 0).astype(np.int32)
    val = np.where(live, rng.integers(1, 6, size=(m, p, k_loc)), 0).astype(np.float32)
    theta = (rng.standard_normal((n_pad, f)) * 0.1).astype(np.float32)
    return (torch.from_numpy(theta).to(dev),
            torch.from_numpy(idx.reshape(m, p * k_loc)).to(dev),
            torch.from_numpy(val.reshape(m, p * k_loc)).to(dev),
            torch.from_numpy(cnt).to(dev), int(cnt.sum()))


_DRYRUN_CHILD = """
import dataclasses, json, sys
sys.path[:0] = sys.argv[1:3]
from benchmarks_torch import roofline
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, units
from repro_torch.launch.mesh import make_mesh
layers, seq, rows, short = (int(a) for a in sys.argv[3:7])
spec = registry.get_arch('phi3-mini-3.8b')
spec = dataclasses.replace(spec, model=dataclasses.replace(spec.model, n_layers=layers))
meta8 = make_mesh((1, 8), ('data', 'model'), devices=['meta'] * 8)
out = {'cut': {}, 'full': {}}
for kind, name in (('prefill', 'prefill_32k'), ('decode', 'decode_32k')):
    out['cut'][kind] = dryrun.run_cell('phi3-mini-3.8b', name, spec=spec,
                                       shape=ShapeConfig(name, seq, rows, kind), mesh=meta8)
out['cut']['prefill_short'] = units.cost_cell(
    spec, ShapeConfig('prefill_32k', short, rows, 'prefill'), meta8)['flops_by_dtype']
for name in ('train_4k', 'decode_32k'):
    out['full'][name] = {'dryrun': dryrun.run_cell('phi3-mini-3.8b', name),
                         'roofline': roofline.roofline_cell('phi3-mini-3.8b', name, save=False)}
out['full']['netflix'] = {'roofline': roofline.als_roofline_cell('netflix', save=False)}
print(json.dumps(out))
"""


def _fill_random(torch, tree, seed: int) -> None:
    """Every distinct floating cell tensor of a tree of ``Sharded`` leaves
    drawn from N(0, 0.02^2) with a generator seeded ``seed``."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.models import transformer as T

    gen, seen = None, set()
    for leaf in T.tree_leaves(tree):
        for t in (leaf.cells if isinstance(leaf, Sharded) else [leaf]):
            if id(t) in seen or not t.is_floating_point():
                continue
            seen.add(id(t))
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            t.normal_(0.0, 0.02, generator=gen)


def _peak_since(torch, base: int) -> int:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _fresh_base(torch) -> int:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _needed_bytes(mem: dict) -> int:
    """What a step must hold at its end: its arguments and what it returns
    beside the arguments it writes in place."""
    return mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"]


def dryrun_on_card(torch, launches: Launches, dev) -> dict:
    """Phase 19: the dry-run against the card.  Each check builds a
    production cell with the data axis cut to 1, so that one model group
    of 8 cells shares ``cuda:0``, at the production cell's own per-cell
    shapes, and holds the card's allocator peak between the meta dry-run's
    arguments + outputs and its live-set estimate for the same layout
    (``memory["device"]``: every cell on one device), and the card's time
    at or above the roofline bound of the same work.

    (a) the netflix SU-ALS wave on data=1 x model=8: one data shard of the
    production wave (its rows from the production cell's ``meta``),
    K_loc = 512, Theta over 8 cells, f = 100, synthetic ratings from seed
    0; the wave through ``fused_herm`` and ``batch_solve`` (both must
    launch), each cell's A and B of every row block against the plain
    version (``HERM_ATOL``/``HERM_RTOL``), each owned slice's solve
    (``SOLVE_TOL``), the wave against its plain run (``SU_TOL``);
    (b) phi3-mini-3.8b ``decode_32k`` at full width on data=1 x model=8 (4
    rows a cell, 32768 cache positions, 4 kv heads a cell), 4 of 32
    layers, random weights from seed 0: a ``build_prefill_cell`` step of
    4 x 32768 tokens and 3 ``build_decode_cell`` steps; the allocator's
    peak also within ``PEAK_EST_FACTOR`` of the one-working-set estimate
    (the live set may exceed the card); the dry-run's units x 8 cells equal
    to ``FlopCounterMode`` over a whole decode step and a whole prefill of
    ``LM_FLOPS_SEQ`` tokens on the CUDA cells, and the decode's count the
    same on the meta cells; none of the four kernels launched;
    (c) ``run_cell`` and ``roofline_cell`` on meta for phi3-mini-3.8b x
    {train_4k, decode_32k} and ``run_als_cell("netflix")`` at the real
    production shapes, each record's fits, live set, terms and dominant
    term on a line of its own.
    """
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from benchmarks_torch import roofline
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import su_als
    from repro_torch.kernels import ops
    from repro_torch.launch import builders, dryrun
    from repro_torch.launch.mesh import make_mesh

    t_start = time.perf_counter()
    out: dict = {"seconds": {}}
    torch.cuda.empty_cache()
    log(f"phase 19 starts with {torch.cuda.memory_allocated()} B allocated by earlier phases")
    meta8 = make_mesh((1, 8), ("data", "model"), devices=["meta"] * 8)
    card8 = make_mesh((1, 8), ("data", "model"), devices=[dev] * 8)
    launches.reset()
    # the meta dry-runs of (b) and (c) cost their cells in a process of their
    # own, on other host cores, while this one drives the card
    child = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD, str(SRC), str(ROOT), str(LM_DRYRUN_LAYERS),
         str(LM_DRYRUN_SEQ), str(LM_DRYRUN_ROWS), str(LM_FLOPS_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (a) the netflix wave ----------------------------------------------------------------
        t0 = time.perf_counter()
        prod = dryrun.run_als_cell("netflix")
        rows = prod["meta"]["m_wave"] // prod["meta"]["q"]
        cut = dryrun.run_als_cell("netflix", mesh=meta8, m_wave=rows)
        meta = cut["meta"]
        p, k_loc, f = meta["p"], meta["k_loc"], meta["f"]
        cell = builders.build_als_cell("netflix", card8, m_wave=rows)
        update_x, n_pad = cell.fn, cell.args[0].shape[0]
        del cell                                # its zero arguments: the wave gets ratings
        base = _fresh_base(torch)
        theta, idx, val, cnt, nnz = _als_wave_data(torch, dev, rows, p, k_loc, n_pad, f)
        args = (theta, idx, val, cnt)
        x = update_x(*args)
        peak = _peak_since(torch, base)
        launches_wave = launches.read()
        mem = cut["memory"]["device"]
        log(f"19a netflix wave on data=1 x model=8 (cuda:0): {rows} rows, K_loc {k_loc}, p {p}, "
            f"f {f}, {nnz} ratings; allocator peak {peak} B between arguments + outputs "
            f"{_needed_bytes(mem)} B and the dry-run's live set "
            f"{mem['live_set_estimate_bytes']} B; launches {launches_wave}")
        check(launches_wave["fused_herm"] > 0 and launches_wave["batch_solve"] > 0,
              f"19a: the wave launched {launches_wave}")
        check(_needed_bytes(mem) <= peak <= mem["live_set_estimate_bytes"],
              f"19a: allocator peak {peak} outside [{_needed_bytes(mem)}, "
              f"{mem['live_set_estimate_bytes']}]")
        ms = cuda_ms(torch, lambda: update_x(*args), reps=3)
        bound = roofline.bound_on_one_device(
            {"float32": roofline.als_useful_flops(nnz, rows, f)},
            roofline.als_min_bytes(nnz, n_pad, rows, p, f))
        log(f"19a wave {ms:.3f} ms on CUDA events; roofline bound {bound['bound_s'] * 1e3:.4f} ms "
            f"({bound['dominant']}: {json.dumps(bound['terms_s'])})")
        check(ms >= bound["bound_s"] * 1e3, f"19a: {ms} ms under its bound {bound}")
        # the kernels against their plain versions at the wave's shapes
        x_plain = su_als.make_su_als_fns(card8, 0.05, mode="ref", row_block=meta["row_block"])[0](
            *args)
        dx = (x - x_plain).abs().max().item()
        herm_err = solve_err = 0.0
        npp, rb = n_pad // p, meta["row_block"]
        for lo in range(0, rows, rb):
            As, Bs = [], []
            for k in range(p):
                blk = (theta[k * npp:(k + 1) * npp], idx[lo:lo + rb, k * k_loc:(k + 1) * k_loc],
                       val[lo:lo + rb, k * k_loc:(k + 1) * k_loc], cnt[lo:lo + rb, k])
                A, B = ops.fused_herm(*blk, 0.05, mode="kernel", diag_fallback=False)
                Ap, Bp = ops.fused_herm(*blk, 0.05, mode="ref", diag_fallback=False)
                check(torch.allclose(A, Ap, atol=HERM_ATOL, rtol=HERM_RTOL)
                      and torch.allclose(B, Bp, atol=HERM_ATOL, rtol=HERM_RTOL),
                      f"19a: fused_herm disagrees with its plain version at rows {lo}, shard {k}")
                herm_err = max(herm_err, (A - Ap).abs().max().item(), (B - Bp).abs().max().item())
                As.append(A)
                Bs.append(B)
            A_sum, B_sum = sum(As), sum(Bs)
            empty = (cnt[lo:lo + rb].sum(dim=1) <= 0).to(torch.float32)
            A_sum.diagonal(dim1=-2, dim2=-1).add_(empty[:, None])
            for k in range(p):
                sl = slice(k * rb // p, (k + 1) * rb // p)
                xs = ops.batch_solve(A_sum[sl], B_sum[sl], mode="kernel")
                xp = ops.batch_solve(A_sum[sl], B_sum[sl], mode="ref")
                solve_err = max(solve_err, (xs - xp).abs().max().item())
            del As, Bs, A_sum, B_sum
        log(f"19a against the plain versions: fused_herm max|d| {herm_err:.3g} "
            f"(atol {HERM_ATOL}, rtol {HERM_RTOL}), batch_solve {solve_err:.3g} ({SOLVE_TOL}), "
            f"the wave {dx:.3g} ({SU_TOL})")
        check(solve_err <= SOLVE_TOL, f"19a: batch_solve {solve_err} from its plain version")
        check(dx <= SU_TOL, f"19a: the wave {dx} from its plain run")
        out["als"] = {"rows": rows, "nnz": nnz, "ms": ms, "bound_ms": bound["bound_s"] * 1e3,
                      "peak_bytes": peak, "needed_bytes": _needed_bytes(mem),
                      "live_set_bytes": mem["live_set_estimate_bytes"], "launches": launches_wave,
                      "herm_max_abs_err": herm_err, "solve_max_abs_err": solve_err,
                      "wave_max_abs_err": dx}
        del x, x_plain, args, theta, idx, val, cnt
        out["seconds"]["als"] = time.perf_counter() - t0

        # (b) phi3-mini-3.8b decode_32k cut to data=1 and 4 layers -----------------------------
        t0 = time.perf_counter()
        launches.reset()
        spec = registry.get_arch("phi3-mini-3.8b")
        full = spec.model
        spec = dataclasses.replace(spec, model=dataclasses.replace(full, n_layers=LM_DRYRUN_LAYERS))
        shapes = {"prefill": ShapeConfig("prefill_32k", LM_DRYRUN_SEQ, LM_DRYRUN_ROWS, "prefill"),
                  "decode": ShapeConfig("decode_32k", LM_DRYRUN_SEQ, LM_DRYRUN_ROWS, "decode")}
        runs = {}
        for kind, s in shapes.items():
            base = _fresh_base(torch)
            cell = builders.build_cell("phi3-mini-3.8b", s.name, card8, spec=spec, shape=s)
            _fill_random(torch, cell.args[0], seed=0)
            if kind == "decode":
                cell.args[3].cells[0].fill_(s.seq - 8)         # lengths: room for the 3 steps
            step_ms = []
            for _ in range(1 if kind == "prefill" else 3):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                res_ = cell.fn(*cell.args)
                stop.record()
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(stop))
                if kind == "decode":
                    cell.args[3].cells[0].add_(1)
                del res_
            runs[kind] = {"ms": step_ms, "peak_bytes": _peak_since(torch, base)}
            if kind == "decode":
                with FlopCounterMode(display=False) as fc:
                    cell.fn(*cell.args)
                mcell = builders.build_cell("phi3-mini-3.8b", s.name, meta8, spec=spec, shape=s)
                with FlopCounterMode(display=False) as fm:
                    mcell.fn(*mcell.args)
                runs[kind]["flops_cuda"], runs[kind]["flops_meta"] = (fc.get_total_flops(),
                                                                      fm.get_total_flops())
            del cell
        # the whole prefill under the counter at a short sequence: at 32768
        # tokens it issues ~2.6 M ops, and the counter adds ~0.2 ms an op
        short = ShapeConfig("prefill_32k", LM_FLOPS_SEQ, LM_DRYRUN_ROWS, "prefill")
        cell = builders.build_cell("phi3-mini-3.8b", short.name, card8, spec=spec, shape=short)
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)
        runs["prefill"]["flops_cuda_short"] = fc.get_total_flops()
        del cell
        launches_lm = launches.read()
        stdout, stderr = child.communicate(timeout=600)
        check(child.returncode == 0, f"19: the meta dry-run process failed:\n{stderr[-4000:]}")
        meta_recs = json.loads(stdout.strip().splitlines()[-1])
        res = {}
        units_flops = {k: sum(meta_recs["cut"][k]["cost"]["flops_by_dtype"].values())
                       * meta8.size for k in shapes}
        units_flops["prefill_short"] = sum(meta_recs["cut"]["prefill_short"].values()) * meta8.size
        for kind, s in shapes.items():
            mem = meta_recs["cut"][kind]["memory"]["device"]
            flops_total = {k: v * meta8.size
                           for k, v in meta_recs["cut"][kind]["cost"]["flops_by_dtype"].items()}
            bound = roofline.bound_on_one_device(flops_total, _needed_bytes(mem))
            r, ms = runs[kind], min(runs[kind]["ms"])
            log(f"19b phi3-mini-3.8b {kind} ({LM_DRYRUN_LAYERS} of {full.n_layers} layers, "
                f"{LM_DRYRUN_ROWS} x {s.seq} on data=1 x model=8, cuda:0): ms "
                f"{[round(t, 3) for t in r['ms']]}; roofline bound {bound['bound_s'] * 1e3:.4f} ms "
                f"({bound['dominant']}); allocator peak {r['peak_bytes']} B between "
                f"{_needed_bytes(mem)} B and the live set {mem['live_set_estimate_bytes']} B")
            check(_needed_bytes(mem) <= r["peak_bytes"] <= mem["live_set_estimate_bytes"],
                  f"19b {kind}: allocator peak {r['peak_bytes']} outside [{_needed_bytes(mem)}, "
                  f"{mem['live_set_estimate_bytes']}]")
            # the live set (two working sets) may exceed the card, so the peak
            # is also held to the one-working-set estimate, which can fail
            est = mem["peak_estimate_bytes"]
            log(f"19b {kind}: allocator peak / the dry-run's one-working-set estimate {est} B = "
                f"{r['peak_bytes'] / est:.4f} (within {PEAK_EST_FACTOR}x either way)")
            check(est / PEAK_EST_FACTOR <= r["peak_bytes"] <= est * PEAK_EST_FACTOR,
                  f"19b {kind}: allocator peak {r['peak_bytes']} not within {PEAK_EST_FACTOR}x "
                  f"of the one-working-set estimate {est}")
            check(ms >= bound["bound_s"] * 1e3, f"19b {kind}: {ms} ms under its bound {bound}")
            res[kind] = dict(r, bound_ms=bound["bound_s"] * 1e3, dominant=bound["dominant"],
                             needed_bytes=_needed_bytes(mem), peak_estimate_bytes=est,
                             live_set_bytes=mem["live_set_estimate_bytes"],
                             flops_units=units_flops[kind])
        res["prefill"]["flops_units_short"] = units_flops["prefill_short"]
        log(f"19b decode step flops: the dry-run's units x 8 cells {units_flops['decode']}, "
            f"FlopCounterMode over the step on the CUDA cells {res['decode']['flops_cuda']}, "
            f"on the meta cells {res['decode']['flops_meta']}")
        log(f"19b prefill of {LM_FLOPS_SEQ} tokens a row, flops: the units x 8 cells "
            f"{units_flops['prefill_short']}, FlopCounterMode over the step on the CUDA cells "
            f"{res['prefill']['flops_cuda_short']}")
        check(units_flops["decode"] == res["decode"]["flops_cuda"] > 0,
              "19b: the dry-run's units miscount the decode step")
        check(units_flops["prefill_short"] == res["prefill"]["flops_cuda_short"] > 0,
              "19b: the dry-run's units miscount the prefill step")
        check(res["decode"]["flops_cuda"] == res["decode"]["flops_meta"],
              "19b: FlopCounterMode differs on the CUDA and the meta cells")
        res["launches"] = launches_lm
        check(not any(launches_lm.values()),
              f"19b: the LM path launched a kernel it should not reach: {launches_lm}")
        out["lm"] = res
        out["seconds"]["lm"] = time.perf_counter() - t0

        # (c) the full dry-run on meta (from the same process) ---------------------------------
        full_recs = {}
        for shape_name in ("train_4k", "decode_32k"):
            d, r = (meta_recs["full"][shape_name][k] for k in ("dryrun", "roofline"))
            full_recs[shape_name] = {
                "fits": d["memory"]["fits"],
                "live_set_estimate_bytes": d["memory"]["live_set_estimate_bytes"],
                "terms_s": r["terms_s"], "dominant": r["dominant"],
                "flops_per_cell": r["hlo_flops_per_device"],
                "collective_bytes_per_cell": r["collective_bytes_per_device"]}
        ra = meta_recs["full"]["netflix"]["roofline"]
        full_recs["netflix"] = {
            "fits": prod["memory"]["fits"],
            "live_set_estimate_bytes": prod["memory"]["live_set_estimate_bytes"],
            "terms_s": ra["terms_s"], "dominant": ra["dominant"]}
        for name, r in full_recs.items():
            log(f"19c dry-run {name} on the 32x8 H100 deployment (meta cells): " + json.dumps(r))
            check(r["fits"], f"19c: {name} does not fit its 80 GB a cell")
        out["full"] = full_recs
        out["launches"] = dict(launches_wave)
        out["seconds"]["total"] = time.perf_counter() - t_start
        return out
    finally:            # the child never outlives the phase
        if child.poll() is None:
            child.kill()
            child.wait()


def lint_and_smem() -> dict:
    """Phase 20: the port's lint in process, and each kernel's shared memory
    against ``kernels/budgets.py``.

    The lint runs all seven rules over their roots under ``ROOT`` with the
    committed baseline and fails on any new finding (and if it scanned
    fewer than 100 files: a lint that saw nothing is not clean).  Each
    budgeted kernel's ``<kernel>_smem_bytes(f)``, the bytes its launch
    passes to ``<<<...>>>``, must equal ``footprint_bytes(kernel, f=f)``
    for every f from 1 to its declared bound."""
    import ctypes

    from repro_torch.analysis import (ALL_RULES, AnalysisConfig, Baseline,
                                      iter_python_files, run_analysis)
    from repro_torch.analysis.__main__ import DEFAULT_BASELINE
    from repro_torch.kernels import budgets, build

    t0 = time.perf_counter()
    files = {p for r in ALL_RULES for p in iter_python_files(ROOT, r.roots)}
    new, old = run_analysis(AnalysisConfig(
        root=ROOT, rules=ALL_RULES, baseline=Baseline.load(ROOT / DEFAULT_BASELINE)))
    out = {"lint": {"python": sys.version.split()[0], "rules": len(ALL_RULES),
                    "files": len(files), "new": len(new), "grandfathered": len(old),
                    "seconds": time.perf_counter() - t0}, "smem": {}}
    log("phase 20 lint: " + json.dumps(out["lint"]))
    for f in new:
        log("  " + f.format())
    check(len(files) >= 100, f"phase 20: the lint scanned only {len(files)} files")
    check(not new, f"phase 20: the port's lint has {len(new)} new finding(s)")
    for name, b in budgets.BUDGETS.items():
        fn = getattr(build.load(b.library), f"{name}_smem_bytes")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_size_t
        fs = range(1, b.dim_bounds["f"] + 1)
        launched = [fn(f) for f in fs]
        bad = [f for f, n in zip(fs, launched) if n != budgets.footprint_bytes(name, f=f)]
        out["smem"][name] = {"f": [fs[0], fs[-1]], "mismatches": len(bad),
                             "max_bytes": max(launched), "limit": b.smem_limit}
        log(f"phase 20 smem {name}: " + json.dumps(out["smem"][name]))
        check(not bad, f"phase 20: footprint_bytes({name!r}) differs from the "
                       f"launch's bytes at f in {bad[:8]}")
    return out


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
    from repro_torch.kernels.budgets import SOLVE_NB
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
    meter, cuda_meter = Launches(), Launches("cuda_launches")

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
    cuda_meter.reset()
    A1, B1 = fused_herm_cuda(theta, idx, val, cnt, diag)
    A2, B2 = fused_herm_cuda(theta, idx, val, cnt, diag)
    check(cuda_meter.read()["fused_herm"] == 4, "a split fused_herm call is not 2 launches")
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
        cuda_meter.reset()
        x1, t1 = sgd_tile_cuda(x, th, idx, val, cnt, 0.05, 0.05)
        check(cuda_meter.read()["sgd_tile"] == 1, "an sgd_tile call is not one CUDA launch")
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
        cuda_meter.reset()
        out[mode] = sgd.sgd_epoch(st, gt, grid, scfg, 0.05, set_order=[2, 0, 3, 1])
        if mode == "kernel":
            check(cuda_meter.read()["sgd_tile"] == grid.g, "a planned set is not one launch")
    dx = (out["kernel"].x - out["ref"].x).abs().max().item()
    dt = (out["kernel"].theta - out["ref"].theta).abs().max().item()
    log(f"sgd epoch, per-tile-K degree-sorted grid (tile K {sorted(set(grid.tile_K.ravel().tolist()))}"
        f", {grid.nnz} ratings): planned kernel vs plain max|dx|={dx:.3g} max|dtheta|={dt:.3g}")
    check(torch.allclose(out["kernel"].x, out["ref"].x, atol=SGD_TOL, rtol=SGD_TOL)
          and torch.allclose(out["kernel"].theta, out["ref"].theta, atol=SGD_TOL, rtol=SGD_TOL),
          "planned SGD epoch on a per-tile-K degree-sorted grid disagrees with plain")

    def reset_counts():
        meter.reset()
        cuda_meter.reset()

    def read_counts(phase: str, path=("fused_herm", "batch_solve")) -> dict:
        counts, cuda_counts = meter.read(), cuda_meter.read()
        log(f"{phase} launches: {counts}; CUDA launches: fused_herm "
            f"{cuda_counts['fused_herm']}, sgd_tile {cuda_counts['sgd_tile']}")
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
            cuda_meter.reset()
            A, B = fused_herm_cuda(fixed, idx, val, cnt, diag)
            herm_cuda_launches += cuda_meter.read()["fused_herm"]
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
        per_epoch.append((torch.cuda.max_memory_allocated(), meter.read()["sgd_tile"]))
        torch.cuda.reset_peak_memory_stats()

    reset_counts()
    marks[0].record()
    sstate, shist = sgd.sgd_train(grid, scfg, test=test, train_eval=train_eval,
                                  callback=on_epoch)
    torch.cuda.synchronize()
    counts["sgd_tile"] = read_counts("quarter-Netflix SGD", ("sgd_tile",))["sgd_tile"]
    sgd_cuda_launches = cuda_meter.read()["sgd_tile"]
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
    entry = entry_points(torch, meter, dev)
    log(f"phase 12 took {time.perf_counter() - t12:.1f} s")
    for k in kernels:
        k["launches_entry_points"] = entry["launches"][k["name"]]
        e = {"fused_herm": entry["max_abs_err"]["herm"], "batch_solve":
             entry["max_abs_err"]["solve"], "sgd_tile": entry["max_abs_err"]["sgd"]}.get(k["name"])
        if e is not None:
            k["max_abs_err_entry_points"] = e
            k["max_abs_err"] = max(k["max_abs_err"], e)

    # -- 13. the LM serving path and the embedding factorization --------------------
    t13 = time.perf_counter()
    lmr = lm_serving(torch, meter, dev)
    log(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    for k in kernels:
        k["launches_lm"] = lmr["launches"][k["name"]]
        e = lmr["max_abs_err"].get(k["name"])
        if e is not None:
            k["max_abs_err_lm"] = e
            k["max_abs_err"] = max(k["max_abs_err"], e)
    log("phase 13 serving: " + json.dumps(lmr["serve"]))

    # -- 14. the MoE and recurrent families -------------------------------------------
    t14 = time.perf_counter()
    fam = moe_and_recurrent(torch, dev)
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")
    log("phase 14 serving: " + json.dumps({k: fam[k] for k in (
        "serve", "prefill_512_ms", "f64_layers", "own_capacity_prefill_max_abs", "seconds")}))

    # -- 15. LM training --------------------------------------------------------------
    t15 = time.perf_counter()
    trn = lm_training(torch, meter, dev)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    log("phase 15 training: " + json.dumps({k: trn[k] for k in (
        "convergence", "full_2_layers", "timed", "adafactor", "rwkv", "example", "launches")}))

    # -- 16. mesh LM serving ------------------------------------------------------------
    t16 = time.perf_counter()
    msv = mesh_serving(torch, meter, dev)
    log(f"phase 16 took {time.perf_counter() - t16:.1f} s ({json.dumps(msv['seconds'])})")
    log("phase 16 mesh serving: " + json.dumps({k: msv[k] for k in (
        "primitives", "phi3", "qwen3", "olmoe", "launches")}))

    # -- 17. mesh LM training, the pod sync and the mlp_2d layout ----------------------
    t17 = time.perf_counter()
    mtr = mesh_training(torch, meter, dev, trn["timed"], trn.pop("first_update"))
    log(f"phase 17 took {time.perf_counter() - t17:.1f} s ({json.dumps(mtr['seconds'])})")
    log("phase 17 mesh training: " + json.dumps({k: mtr[k] for k in (
        "phi3_2_layers", "phi3_2_layers_falls", "timed", "olmoe", "pod", "mistral",
        "launches")}))

    # -- 18. the recurrent blocks and the ring decode on a mesh ------------------------
    t18 = time.perf_counter()
    mrc = mesh_recurrent(torch, meter, dev, fam["prefill_512_ms"])
    log(f"phase 18 took {time.perf_counter() - t18:.1f} s ({json.dumps(mrc['seconds'])})")
    log("phase 18 recurrent mesh: " + json.dumps({k: mrc[k] for k in (
        "recurrentgemma-2b", "rwkv6-7b", "launches")}))

    # -- 19. the dry-run against the card ---------------------------------------------
    t19 = time.perf_counter()
    dry = dryrun_on_card(torch, meter, dev)
    log(f"phase 19 took {time.perf_counter() - t19:.1f} s ({json.dumps(dry['seconds'])})")
    log("phase 19 dry-run: " + json.dumps({k: dry[k] for k in ("als", "lm", "full")}))

    # -- 20. the port's lint and the kernels' shared memory ------------------------------
    t20 = time.perf_counter()
    lint_and_smem()
    log(f"phase 20 took {time.perf_counter() - t20:.1f} s")

    for k in kernels:
        k["launches_mesh_recurrent"] = mrc["launches"][k["name"]]
        k["launches_mesh_lm"] = msv["launches"][k["name"]]
        k["launches_mesh_train"] = mtr["launches"][k["name"]]
        k["launches_mesh"] = launches_mesh.get(k["name"], 0)
        k["launches_dryrun"] = dry["launches"][k["name"]]
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
