"""The SGD traffic mix: one blocked batch-Hogwild SGD job (CuMF_SGD), each
epoch after the last, through ``repro_torch.sgd.train.sgd_train`` as the
port's example calls it: a g x g grid, ``test=`` only, no checkpoints.

Set-up makes the ratings on the device, builds the port's grid from the
train ratings (``block_coo``) and runs the first epoch, which loads the
kernel and builds the set plans; then the window (:mod:`mfbench.window`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from mfbench import data, reference, work
from mfbench.window import Window, log


def _plan_shapes(x, theta, plan, lr, lam):
    return (int(plan.rows.numel()), x.shape[0], x.shape[1])


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        devices: list[torch.device], t_start: float) -> dict:
    """One run of the cell on ``devices[0]``, in the form of
    :func:`mfbench.als_cell.run`."""
    from repro_torch.core.als import ell_triplet
    from repro_torch.sgd import train as sgd
    from repro_torch.sgd.blocking import block_coo
    from repro_torch.sparse.padded import pad_csr_fast

    device = devices[0]
    spans = {}
    t0 = time.perf_counter()
    prob = data.make_problem(cfg, seed, device)
    spans["generate"] = time.perf_counter() - t0
    log(f"generated {prob.r.nnz} train and {prob.test.nnz} test ratings in "
        f"{spans['generate']:.2f} s")
    m, n, f, g = prob.r.rows, prob.r.n_cols, int(cfg["f"]), int(traffic["g"])
    kmul = int(cfg["k_multiple"])

    t0 = time.perf_counter()
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(prob.r.ptr))
    grid = block_coo(rows, prob.r.cols.astype(np.int64), prob.r.vals, m, n, g,
                     k_multiple=kmul)
    te = pad_csr_fast(prob.test.ptr, prob.test.cols, prob.test.vals, n, k_multiple=kmul)
    spans["layout"] = time.perf_counter() - t0
    del rows
    log(f"grid in {spans['layout']:.2f} s: g {g} mb {grid.mb} nb {grid.nb} K {grid.idx.shape[-1]}")
    test = ell_triplet(te, device)
    del te

    scfg = sgd.SgdConfig(f=f, lam=float(cfg["lam"]), lr=float(traffic["lr"]),
                         epochs=int(traffic["epochs"]), schedule=traffic["schedule"],
                         seed=seed, device=str(device))
    init = sgd.SgdState(x=sgd.pad_factor(prob.x0, g * grid.mb),
                        theta=sgd.pad_factor(prob.theta0, g * grid.nb), epoch=0)
    start = (prob.x0.cpu(), prob.theta0.cpu())
    del prob.x0, prob.theta0
    w = Window(seconds, trace, devices, t_start)
    if trace:
        w.timer.wrap(sgd, "sgd_tile_planned_", "sgd_tile", _plan_shapes)
        w.timer.wrap(sgd, "rmse_padded", "objective")
    w.run(sgd.sgd_train, grid, scfg, test=test, init_state=init)

    ctx = None
    if trace:
        tiles = [(ms,) + work.sgd_work(live, f_, x_rows, g * grid.nb, g, grid.mb)
                 for ms, (live, x_rows, f_) in w.timer.ms("sgd_tile")]
        ctx = {"solver": "sgd", "spans": spans, "steps": w.steps, "window_s": w.window_s,
               "calls": {"sgd_tile": tiles,
                         "objective": [ms for ms, _ in w.timer.ms("objective")]},
               "step_ops": float(6 * f * prob.r.nnz),
               "device": w.prof.reduce()}

    # the program's state is freed before the reference runs; the check
    # takes the first epoch from the benchmark's start and the last one
    # from the program's state before it
    ep_last = w.last.epoch - 1
    lr = [reference.cosine_lr(float(traffic["lr"]), e, int(traffic["epochs"])) for e in (0, ep_last)]
    epochs = [
        start + (w.first[0][:m], w.first[1][:n], lr[0], reference.set_order(seed, 0, g)),
        (w.prev[0][:m], w.prev[1][:n], w.last.x[:m], w.last.theta[:n], lr[1],
         reference.set_order(seed, ep_last, g)),
    ]
    w.prev = w.last = w.timer = None
    del test, grid, init
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sched = reference.SgdSchedule(prob.r, g, device)
    epochs = [tuple(t.to(device) if torch.is_tensor(t) else t for t in e) for e in epochs]
    numbers = reference.judge_sgd(sched, prob.test, float(cfg["lam"]), epochs, w.history[-1])
    log(f"judged in {time.perf_counter() - t0:.2f} s")
    return {"e2e": w.e2e("sgd_epoch_ms"), "ctx": ctx, "numbers": numbers,
            "attempted": w.steps, "failed": w.failed, "peaks": w.peaks}
