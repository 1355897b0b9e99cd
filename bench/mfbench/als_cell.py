"""The ALS traffic mix: one in-core binned ALS job, each iteration after the
last, through ``repro_torch.core.als.als_train_binned`` as a user calls it.

Set-up makes the ratings on the device, builds the port's layouts from
their CSR (``bin_rows`` for R and R^T, ``pad_csr_fast`` for the test
split), and runs the first iteration, which loads every kernel and
uploads the bins; then the window (:mod:`mfbench.window`).
"""
from __future__ import annotations

import time

import torch

from mfbench import data, reference, work
from mfbench.window import Window, log


def _herm_shapes(theta, idx, val, cnt, lam, **_):
    return (theta.shape[0], theta.shape[1], idx.shape[0], cnt)


def _solve_shapes(A, B, **_):
    return (A.shape[0], A.shape[1])


def _herm_work(calls):
    nnz_of: dict[int, int] = {}
    out = []
    for ms, (fixed_rows, f, rows, cnt) in calls:
        if id(cnt) not in nnz_of:
            nnz_of[id(cnt)] = int(cnt.sum())
        out.append((ms,) + work.herm_work(nnz_of[id(cnt)], rows, f, fixed_rows))
    return out


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        devices: list[torch.device], t_start: float) -> dict:
    """One run of the cell on ``devices[0]``, its one card.  Returns the
    end-to-end values, the traced run's readings context, the comparison's
    numbers, the run's counts and each card's allocator peaks."""
    from repro_torch.core import als
    from repro_torch.kernels import ops
    from repro_torch.sparse.padded import bin_rows, pad_csr_fast

    device = devices[0]
    spans = {}
    t0 = time.perf_counter()
    prob = data.make_problem(cfg, seed, device)
    spans["generate"] = time.perf_counter() - t0
    log(f"generated {prob.r.nnz} train and {prob.test.nnz} test ratings in "
        f"{spans['generate']:.2f} s")
    theta0_host = prob.theta0.cpu()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    n_bins, kmul = int(cfg["n_bins"]), int(cfg["k_multiple"])
    rb = bin_rows(prob.r.ptr, prob.r.cols, prob.r.vals, prob.r.n_cols,
                  n_bins=n_bins, k_multiple=kmul)
    rtb = bin_rows(prob.rt.ptr, prob.rt.cols, prob.rt.vals, prob.rt.n_cols,
                   n_bins=n_bins, k_multiple=kmul)
    te = pad_csr_fast(prob.test.ptr, prob.test.cols, prob.test.vals,
                      prob.test.n_cols, k_multiple=kmul)
    spans["layout"] = time.perf_counter() - t0
    log(f"layouts in {spans['layout']:.2f} s: R K {list(rb.K_list)}, R^T K {list(rtb.K_list)}")
    test = als.ell_triplet(te, device)
    del te

    acfg = als.AlsConfig(f=int(cfg["f"]), lam=float(cfg["lam"]), iters=1 << 30,
                         batch_rows=int(cfg["batch_rows"]), device=str(device))
    w = Window(seconds, trace, devices, t_start, keep=lambda state: (state.theta,))
    if trace:
        w.timer.wrap(ops, "fused_herm", "fused_herm", _herm_shapes)
        w.timer.wrap(ops, "batch_solve", "batch_solve", _solve_shapes)
        w.timer.wrap(als, "_rmse_bins", "objective")
        w.timer.wrap(als, "rmse_padded", "objective")
    w.run(als.als_train_binned, rb, rtb, acfg, test=test,
          init=als.AlsState(x=prob.x0, theta=prob.theta0, iteration=0))

    ctx = None
    if trace:
        ctx = {
            "solver": "als", "spans": spans, "steps": w.steps, "window_s": w.window_s,
            "calls": {"fused_herm": _herm_work(w.timer.ms("fused_herm")),
                      "batch_solve": [(ms,) + work.solve_work(*s)
                                      for ms, s in w.timer.ms("batch_solve")],
                      "objective": [ms for ms, _ in w.timer.ms("objective")]},
            "step_ops": work.als_iteration_ops(prob.r.rows, prob.rt.rows, prob.r.nnz,
                                               prob.test.nnz, acfg.f),
            "device": w.prof.reduce(),
        }

    # the program's state is freed before the reference runs
    last = (w.prev[0], w.last.x, w.last.theta)
    start = (theta0_host,) + w.first
    w.prev = w.last = w.timer = None
    del test, rb, rtb, prob.x0, prob.theta0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    last = (last[0].to(device),) + last[1:]
    t0 = time.perf_counter()
    numbers = reference.judge_als(prob.r, prob.rt, prob.test, acfg.lam,
                                  start=tuple(t.to(device) for t in start),
                                  last=last, reported=w.history[-1])
    log(f"judged in {time.perf_counter() - t0:.2f} s")
    return {"e2e": w.e2e("als_iter_ms"), "ctx": ctx, "numbers": numbers,
            "attempted": w.steps, "failed": w.failed, "peaks": w.peaks}
