"""The SU-ALS traffic mix: one in-core ALS job over a mesh of the cell's
cards, each iteration after the last, through
``repro_torch.core.als.als_train_binned(..., mesh=...)`` as a user calls it.

Set-up makes the ratings on the home card, builds the port's mesh layouts
from their CSR (``bin_col_shards`` for R and R^T, p column shards, on the
home card, then to the host; ``pad_csr_fast`` for the test split), and
runs the first iteration, which uploads each cell's shards to its card
and loads every kernel; then the window (:mod:`mfbench.window`).  A traced
run also installs the program's tracer (device clock) and keeps, for
each of the window's iterations, the time its ``su_als.reduce`` spans
cover on the cards and the bytes the cells receive in them; its
profiler window puts each copy between cards on the card that runs it
(:func:`_reduce_profile`).
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from mfbench import data, devtrace, reference, work
from mfbench.als_cell import _herm_shapes, _herm_work, _solve_shapes
from mfbench.window import Window, log


def _reduce_profile(prof: devtrace.Profile) -> dict:
    """The profiler window's reduction (:func:`mfbench.devtrace.reduce_trace`)
    with each copy between cards on the card that runs it: the chrome
    trace gives a peer copy ``inDevice`` (and ``fromDevice``,
    ``toDevice``) but no ``device``, which the reduction reads, so it
    would put every such copy on the home card."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") == "gpu_memcpy" and "device" not in args and "inDevice" in args:
            args["device"] = args["inDevice"]
    return devtrace.reduce_trace(events, prof.t1 - prof.t0, prof.cards)


def _union_ms(spans) -> float:
    """Milliseconds covered by spans over several cards: the union of their
    intervals where each has its start on the host's clock, else the sum
    of their times."""
    if any(s.device_t0 is None for s in spans):
        return sum(s.device_ms for s in spans)
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted((s.device_t0, s.device_t0 + s.device_ms) for s in spans):
        total += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return total


def _reduce_spans(spans, iterations: set) -> tuple[list, list]:
    """For each of ``iterations`` (``als.iteration`` step spans), the
    milliseconds its ``su_als.reduce`` spans cover (the phases of one
    reduction overlap across cards, so their union, not their sum) and the
    bytes they count."""
    by_id = {s.id: s for s in spans}

    def iteration(s):
        while s is not None and s.name != "als.iteration":
            s = by_id.get(s.parent)
        return None if s is None else s.args.get("iteration")

    per: dict = {}
    for s in spans:
        if s.name == "su_als.reduce" and iteration(s) in iterations:
            per.setdefault(iteration(s), []).append(s)
    keys = sorted(per)
    return ([_union_ms(per[k]) for k in keys],
            [sum(s.args["bytes"] for s in per[k]) for k in keys])


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        devices: list[torch.device], t_start: float) -> dict:
    """One run of the cell on ``devices`` as a mesh of ``traffic``'s shape,
    ``devices[0]`` the home card.  Returns what ``registry.driver`` asks."""
    from repro_torch.core import als
    from repro_torch.distributed import su_als
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.sparse.padded import bin_col_shards, pad_csr_fast

    home = devices[0]
    mesh = make_mesh(traffic["mesh_shape"], traffic["mesh_axes"], devices=devices)
    q, p = su_als.mesh_axes(mesh)
    # the mesh's column axes decide the reduction: two phases over a pod axis
    scheme = "two_phase" if len(su_als.col_axes(mesh)) > 1 else "one_phase"
    if (len(devices), p, q, scheme) != (cfg["cards"], cfg["p"], cfg["q"], traffic["scheme"]):
        raise ValueError(f"{len(devices)} cards as a mesh of p {p}, q {q} reducing by "
                         f"{scheme}; the configuration deploys {cfg['cards']} cards, "
                         f"p {cfg['p']}, q {cfg['q']}, the traffic asks for {traffic['scheme']}")
    spans = {}
    t0 = time.perf_counter()
    prob = data.make_problem(cfg, seed, home)
    spans["generate"] = time.perf_counter() - t0
    log(f"generated {prob.r.nnz} train and {prob.test.nnz} test ratings in "
        f"{spans['generate']:.2f} s; {mesh.describe()}")
    theta0_host = prob.theta0.cpu()
    if home.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    n_bins, kmul = int(cfg["n_bins"]), int(cfg["k_multiple"])
    rs = bin_col_shards(prob.r.ptr, prob.r.cols, prob.r.vals, prob.r.n_cols, p,
                        n_bins=n_bins, k_multiple=kmul, device=home).to("cpu")
    rts = bin_col_shards(prob.rt.ptr, prob.rt.cols, prob.rt.vals, prob.rt.n_cols, p,
                         n_bins=n_bins, k_multiple=kmul, device=home).to("cpu")
    te = pad_csr_fast(prob.test.ptr, prob.test.cols, prob.test.vals,
                      prob.test.n_cols, k_multiple=kmul)
    spans["layout"] = time.perf_counter() - t0
    log(f"layouts in {spans['layout']:.2f} s: R K {[list(k) for k in rs.K_table]}, "
        f"R^T K {[list(k) for k in rts.K_table]}")
    test = als.ell_triplet(te, home)
    del te
    if home.type == "cuda":
        torch.cuda.empty_cache()

    acfg = als.AlsConfig(f=int(cfg["f"]), lam=float(cfg["lam"]), iters=1 << 30,
                         batch_rows=int(cfg["batch_rows"]), device=str(home))
    w = Window(seconds, trace, devices, t_start, keep=lambda state: (state.theta,))
    tracer = None
    if trace:
        w.timer.wrap(ops, "fused_herm", "fused_herm", _herm_shapes)
        w.timer.wrap(ops, "batch_solve", "batch_solve", _solve_shapes)
        w.timer.wrap(su_als, "rmse_shards", "objective")
        w.timer.wrap(als, "rmse_padded", "objective")
        tracer = Tracer(device_clock=True)
    prev = set_tracer(tracer) if trace else None
    try:
        w.run(als.als_train_binned, rs, rts, acfg, test=test,
              init=als.AlsState(x=prob.x0, theta=prob.theta0, iteration=0),
              mesh=mesh)
    finally:
        if trace:
            set_tracer(prev)

    ctx = None
    if trace:
        window = set(range(2, w.steps + 2))
        reduce_ms, reduce_bytes = _reduce_spans(tracer.spans(), window)
        ctx = {
            "solver": "als", "spans": spans, "steps": w.steps, "window_s": w.window_s,
            "calls": {"fused_herm": _herm_work(w.timer.ms("fused_herm")),
                      "batch_solve": [(ms,) + work.solve_work(*s)
                                      for ms, s in w.timer.ms("batch_solve")],
                      "objective": [ms for ms, _ in w.timer.ms("objective")]},
            "step_ops": work.als_iteration_ops(prob.r.rows, prob.rt.rows, prob.r.nnz,
                                               prob.test.nnz, acfg.f),
            "device": _reduce_profile(w.prof),
            "mesh": {"cards": len(mesh.distinct_devices), "reduce_ms": reduce_ms,
                     "reduce_bytes": reduce_bytes},
        }
        tracer = None

    # the program's state is freed before the reference runs
    last = (w.prev[0], w.last.x, w.last.theta)
    start = (theta0_host,) + w.first
    w.prev = w.last = w.timer = None
    del test, rs, rts, prob.x0, prob.theta0
    if home.type == "cuda":
        torch.cuda.empty_cache()
    last = (last[0].to(home),) + last[1:]
    t0 = time.perf_counter()
    numbers = reference.judge_als(prob.r, prob.rt, prob.test, acfg.lam,
                                  start=tuple(t.to(home) for t in start),
                                  last=last, reported=w.history[-1])
    log(f"judged in {time.perf_counter() - t0:.2f} s")
    # the test RMSE is the one-card path's own call on the home card, and
    # no control reads above the program there, so it decides nothing
    # (bench/limits/yahoomusic.als_mesh4.json)
    log(f"test_rmse_gap {numbers.pop('test_rmse_gap')!r} (not compared)")
    return {"e2e": w.e2e("als_iter_ms"), "ctx": ctx, "numbers": numbers,
            "attempted": w.steps, "failed": w.failed, "peaks": w.peaks}
