"""A whole run of the cell, its look for a card skipped, on the CPU at a
tiny size with the program's plain path: sound, it reads ``correct``;
with the timed path broken underneath, it does not.

The faults a single-card ALS run can have: a step that returns its state
unchanged; half of each row's ratings left out of the Hermitian (the mean
taken over the rest); the RMSE taken over half of the bins; a factor row
altered where the solve produces it; the reported RMSE altered.  No
exchange between cards exists on one card."""
import pytest
import torch

from mfbench import registry


def tiny_config(name="netflix"):
    cfg = registry.config(name)
    cfg.update(m=500, n=120, nnz=16000, test_nnz=1800, f=8, n_bins=4)
    return cfg


def run_tiny(bench_run, cfg, trace=False, workload="netflix.als"):
    import time
    return bench_run.run_cell(workload, 2**31 + 101, 0.3, trace, [torch.device("cpu")],
                              config=cfg, t_start=time.perf_counter())


@pytest.mark.parametrize("name", ["netflix", "yahoomusic"])
def test_sound_run_is_correct(bench_run, name):
    torch.set_num_threads(2)
    res = run_tiny(bench_run, tiny_config(name), workload=f"{name}.als")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "als_iter_ms", "peak_mem_GiB"}
    assert list(res)[-1] == "checks"


def test_traced_run_reports_every_layer_metric(bench_run):
    torch.set_num_threads(2)
    res = run_tiny(bench_run, tiny_config(), trace=True)
    assert res["correct"], res["checks"]
    assert {"layout_s", "herm_roofline", "solve_roofline", "als_mfu",
            "objective_ms.als"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _unchanged(monkeypatch, als, ops):
    orig, first = als._update_factor_bins, {}

    def step(fixed, dbins, m, cfg):
        if m not in first:
            first[m] = orig(fixed, dbins, m, cfg)
        return first[m]
    monkeypatch.setattr(als, "_update_factor_bins", step)


def _half_ratings(monkeypatch, als, ops):
    orig = ops.fused_herm

    def herm(theta, idx, val, cnt, lam, **kw):
        return orig(theta, idx, val, (cnt + 1) // 2, lam, **kw)
    monkeypatch.setattr(ops, "fused_herm", herm)


def _half_bins_rmse(monkeypatch, als, ops):
    orig = als._rmse_bins
    monkeypatch.setattr(als, "_rmse_bins", lambda x, theta, dbins: orig(x, theta, dbins[: max(1, len(dbins) // 2)]))


def _row_altered(monkeypatch, als, ops):
    orig = als._update_factor_bins

    def step(fixed, dbins, m, cfg):
        out = orig(fixed, dbins, m, cfg)
        out[m // 2] += 1e-3
        return out
    monkeypatch.setattr(als, "_update_factor_bins", step)


def _rmse_altered(monkeypatch, als, ops):
    orig = als._rmse_bins
    monkeypatch.setattr(als, "_rmse_bins", lambda *a: orig(*a) * (1 + 1e-4))


@pytest.mark.parametrize("fault", [_unchanged, _half_ratings, _half_bins_rmse, _row_altered,
                                   _rmse_altered], ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(bench_run, monkeypatch, fault):
    from repro_torch.core import als
    from repro_torch.kernels import ops
    torch.set_num_threads(2)
    fault(monkeypatch, als, ops)
    res = run_tiny(bench_run, tiny_config())
    assert not res["correct"], res["checks"]


# -- SGD ----------------------------------------------------------------------

def test_sound_sgd_run_is_correct(bench_run):
    torch.set_num_threads(2)
    res = run_tiny(bench_run, tiny_config(), workload="netflix.sgd")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "sgd_epoch_ms", "peak_mem_GiB"}
    res = run_tiny(bench_run, tiny_config(), trace=True, workload="netflix.sgd")
    assert res["correct"], res["checks"]
    assert {"layout_s", "sgd_mfu", "objective_ms.sgd"} <= set(res["metrics"])


def _sgd_unchanged(monkeypatch, sgd):
    monkeypatch.setattr(sgd, "sgd_epoch", lambda state, *a, **k: state._replace(epoch=state.epoch + 1))


def _sgd_half_ratings(monkeypatch, sgd):
    orig = sgd.sgd_epoch

    def epoch(state, gt, *a, **k):
        return orig(state, (gt[0], gt[1], (gt[2] + 1) // 2), *a, **k)
    monkeypatch.setattr(sgd, "sgd_epoch", epoch)


def _sgd_row_altered(monkeypatch, sgd):
    orig = sgd.sgd_epoch

    def epoch(*a, **k):
        out = orig(*a, **k)
        out.x[3] += 1e-3
        return out
    monkeypatch.setattr(sgd, "sgd_epoch", epoch)


def _sgd_rmse_altered(monkeypatch, sgd):
    orig = sgd.rmse_padded
    monkeypatch.setattr(sgd, "rmse_padded", lambda *a: orig(*a) * (1 + 1e-4))


@pytest.mark.parametrize("fault", [_sgd_unchanged, _sgd_half_ratings, _sgd_row_altered,
                                   _sgd_rmse_altered], ids=lambda f: f.__name__.strip("_"))
def test_sgd_fault_is_not_correct(bench_run, monkeypatch, fault):
    from repro_torch.sgd import train as sgd
    torch.set_num_threads(2)
    fault(monkeypatch, sgd)
    res = run_tiny(bench_run, tiny_config(), workload="netflix.sgd")
    assert not res["correct"], res["checks"]
