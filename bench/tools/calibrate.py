"""Readings that the limits of ``correct`` are set from, in one process.

    python3 bench/tools/calibrate.py --workload netflix.als \
        --program-seeds 11 12 13 --control-seeds 21 22 23 \
        --seconds 3 --out calibrate_netflix.jsonl

For each program seed, one run of the cell (a window of ``--seconds``)
and the numbers its comparison reads; for each control seed, the plain
reference put in the program's place in TF32 (``--control-precision``;
``tf32_emulated`` for SGD, whose 1 x f x 1 products get no TF32 kernel),
``--control-iters`` iterations from the same initial factors, judged by
the same comparison.  One JSON line per run goes to ``--out`` and to
standard output.  Needs a CUDA card, as the benchmark does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-iters", type=int, default=3)
    ap.add_argument("--control-precision", default="tf32",
                    choices=("tf32", "tf32_emulated", "fp32"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch
    from mfbench import data, reference, registry

    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import run as bench_run

    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    traffic = registry.traffic(wl["traffic"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        def emit(rec):
            line = json.dumps(rec)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        for seed in args.program_seeds:
            t0 = time.perf_counter()
            res = bench_run.run_cell(args.workload, seed, args.seconds, False, [device],
                                     t_start=t0)
            emit({"workload": args.workload, "side": "program", "seed": seed,
                  "numbers": {k: c["value"] for k, c in res["checks"].items()},
                  "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                  "attempted": res["attempted"], "wall_s": time.perf_counter() - t0})
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            prob = data.make_problem(cfg, seed, device)
            lam = float(cfg["lam"])
            t1 = time.perf_counter()
            if traffic["solver"] == "als":
                del prob.x0
                start, last, reported = reference.als_reference_run(
                    prob.r, prob.rt, prob.test, prob.theta0, lam,
                    args.control_iters, args.control_precision)
                t2 = time.perf_counter()
                numbers = reference.judge_als(prob.r, prob.rt, prob.test, lam,
                                              start, last, reported)
            else:
                checked, reported = reference.sgd_reference_run(
                    prob.r, prob.test, prob.x0, prob.theta0, lam, traffic, seed,
                    args.control_iters, args.control_precision)
                t2 = time.perf_counter()
                sched = reference.SgdSchedule(prob.r, int(traffic["g"]), device)
                numbers = reference.judge_sgd(sched, prob.test, lam, checked, reported)
                del sched, checked
            emit({"workload": args.workload, "side": f"control_{args.control_precision}",
                  "seed": seed, "iters": args.control_iters, "numbers": numbers,
                  "reported": reported, "generate_s": t1 - t0, "solve_s": t2 - t1,
                  "judge_s": time.perf_counter() - t2})
            del prob
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
