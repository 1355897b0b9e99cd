"""Benchmark entry point of the port: one function per paper table/figure,
on the card unless ``--device cpu`` (the port of ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV lines.  Any module that declares
a ``JSON_OUT`` filename has its ``run()`` return value serialized there —
BENCH_torch_outofcore.json (bench_huge) and BENCH_torch_sgd.json
(bench_sgd) — and appended to the history file, BENCH_torch_HISTORY.jsonl
by default, so a run of the port never lands in the reference's baseline.

Selection::

    PYTHONPATH=src python benchmarks_torch/run.py                 # everything
    PYTHONPATH=src python benchmarks_torch/run.py --quick         # fast subset
    PYTHONPATH=src python benchmarks_torch/run.py --only convergence --only sgd
    PYTHONPATH=src python benchmarks_torch/run.py --device cpu --quick

``--only`` takes the short names below (repeatable); unknown names exit 2.
``--quick`` without ``--only`` selects the fast subset; combined with
``--only`` it keeps the explicit selection and is passed through to any
module whose ``run`` accepts a ``quick`` keyword (smaller problems).
``--device`` goes to every ``run`` that takes one; without a card, a run
that does not pass ``--device cpu`` raises before it builds anything.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import sys

# make ``python benchmarks_torch/run.py`` work from anywhere: the repo root
# (the parent of this file's directory) must be importable for
# ``benchmarks_torch.*``
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# short name -> module; order is the full-run execution order.  The
# reference's lm_substrate bench belongs to the LM substrate, not ported.
MODULES = [
    ("convergence", "bench_convergence"),            # Fig. 6
    ("register_ablation", "bench_register_ablation"),  # Fig. 7
    ("texture", "bench_texture"),                    # Fig. 8
    ("scaling", "bench_scaling"),                    # Fig. 9/10
    ("huge", "bench_huge"),                          # Fig. 11 + out-of-core
    ("reduction", "bench_reduction"),                # Fig. 5
    ("kernels", "bench_kernels"),                    # kernel-level fusion
    ("sgd", "bench_sgd"),                            # ALS vs SGD vs hybrid
]
QUICK = ("convergence", "register_ablation")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help=f"run only the fast subset: {', '.join(QUICK)}")
    ap.add_argument("--only", action="append", default=[], metavar="NAME",
                    help="run only the named benchmark (repeatable); "
                         f"names: {', '.join(n for n, _ in MODULES)}")
    ap.add_argument("--autotune", action="store_true",
                    help="let benchmarks that take an `autotune` keyword "
                         "add autotuned-layout rows (cuMF Alg.-2 sweep via "
                         "repro_torch.core.autotune; see TUNING.md)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record obs spans across every selected benchmark "
                         "and write one Chrome-trace/Perfetto JSON file")
    ap.add_argument("--history", default="BENCH_torch_HISTORY.jsonl",
                    metavar="JSONL",
                    help="append every JSON emission here with provenance "
                         "(git sha, backend, device count, card, quick "
                         "flag); gate with `python -m repro_torch.obs."
                         "regress --history`")
    ap.add_argument("--no-history", action="store_true",
                    help="skip the history append (one-off local runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every bench (default: the card); "
                         "'cpu' runs the plain PyTorch versions")
    args = ap.parse_args(argv)

    known = {n for n, _ in MODULES}
    unknown = [n for n in args.only if n not in known]
    if unknown:
        ap.error(f"unknown benchmark name(s) {unknown}; "
                 f"choose from {sorted(known)}")
    if args.only:
        selected = set(args.only)
    elif args.quick:
        selected = set(QUICK)
    else:
        selected = known

    from repro_torch.backend import resolve_device
    device = str(resolve_device(args.device))    # raises without a GPU

    from benchmarks_torch.history import append_history, provenance, stamp
    prov = provenance(quick=args.quick, device=device)

    from repro_torch.obs import Tracer, set_tracer, write_trace
    tracer = Tracer() if args.trace else None
    # streaming drivers pick the tracer up themselves; the previous one
    # comes back at the end (main may run in-process, repeatedly)
    prev = set_tracer(tracer) if tracer is not None else None

    print("name,us_per_call,derived")
    try:
        for name, modname in MODULES:
            if name not in selected:
                continue
            mod = importlib.import_module(f"benchmarks_torch.{modname}")
            kwargs = {}
            params = inspect.signature(mod.run).parameters
            if args.quick and "quick" in params:
                kwargs["quick"] = True
            if args.autotune and "autotune" in params:
                kwargs["autotune"] = True
            if "device" in params:
                kwargs["device"] = device
            out = mod.run(**kwargs)
            json_out = getattr(mod, "JSON_OUT", None)
            if json_out and out:
                stamp(out, prov)
                with open(json_out, "w") as f:
                    json.dump(out, f, indent=2)
                print(f"# wrote {len(out)} records to {json_out}", flush=True)
                if not args.no_history:
                    append_history(args.history, modname, out, prov)
                    print(f"# history: {modname} -> {args.history}",
                          flush=True)
    finally:
        if tracer is not None:
            set_tracer(prev)
            write_trace(args.trace, tracer, process_name="benchmarks_torch")
            print(f"# trace: {len(tracer.events)} events -> {args.trace}",
                  flush=True)


if __name__ == '__main__':
    main()
