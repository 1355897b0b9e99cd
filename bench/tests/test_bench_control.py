"""The control: the plain reference put in the program's place in the
nearest precision below the configuration's float32 with TF32 off, that
is TF32, must come out as not correct under each configuration's limits.

On the CPU, TF32 is emulated by rounding the matmuls' operands; on the
card (``card`` marker) the tensor cores' own TF32 runs, at a size a test
run holds.  ``bench/tools/calibrate.py`` runs the same control at each
cell's full size."""
import pytest
import torch

from mfbench import data, reference, registry


def control_numbers(cfg, seed, device, mode):
    p = data.make_problem(cfg, seed, device)
    start, last, reported = reference.als_reference_run(
        p.r, p.rt, p.test, p.theta0, cfg["lam"], 3, mode)
    return reference.judge_als(p.r, p.rt, p.test, cfg["lam"], start, last, reported)


def sgd_control_numbers(cfg, seed, device, mode):
    traffic = registry.traffic("sgd")
    p = data.make_problem(cfg, seed, device)
    checked, reported = reference.sgd_reference_run(
        p.r, p.test, p.x0, p.theta0, cfg["lam"], traffic, seed, 3, mode)
    sched = reference.SgdSchedule(p.r, int(traffic["g"]), device)
    return reference.judge_sgd(sched, p.test, cfg["lam"], checked, reported)


def small(name):
    cfg = registry.config(name)
    cfg.update(m=3000, n=400, nnz=120000, test_nnz=13000, f=32, n_bins=4)
    return cfg


@pytest.mark.parametrize("name", ["netflix", "yahoomusic"])
def test_control_fails_on_the_cpu(bench_run, name):
    torch.set_num_threads(2)
    cfg = small(name)
    ok, checks = bench_run.check_numbers(control_numbers(cfg, 2**31 + 7, "cpu", "tf32_emulated"),
                                         registry.limits(f"{name}.als"))
    assert not ok, checks


@pytest.mark.parametrize("name", ["netflix", "yahoomusic"])
def test_reference_in_fp32_passes_on_the_cpu(bench_run, name):
    torch.set_num_threads(2)
    cfg = small(name)
    ok, checks = bench_run.check_numbers(control_numbers(cfg, 2**31 + 7, "cpu", "fp32"),
                                         registry.limits(f"{name}.als"))
    assert ok, checks


@pytest.mark.parametrize("mode,fails", [("tf32_emulated", True), ("fp32", False)])
def test_sgd_control_on_the_cpu(bench_run, mode, fails):
    torch.set_num_threads(2)
    ok, checks = bench_run.check_numbers(sgd_control_numbers(small("netflix"), 2**31 + 9, "cpu", mode),
                                         registry.limits("netflix.sgd"))
    assert ok is not fails, checks


@pytest.mark.card
@pytest.mark.parametrize("name", ["netflix", "yahoomusic"])
def test_control_fails_on_the_card(bench_run, card, name):
    cfg = registry.config(name)
    cfg.update(m=cfg["m"] // 20, n=max(cfg["n"] // 20, 2000), nnz=cfg["nnz"] // 400,
               test_nnz=cfg["test_nnz"] // 400)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ok, checks = bench_run.check_numbers(control_numbers(cfg, seed, card, "tf32"),
                                             registry.limits(f"{name}.als"))
        assert not ok, checks


@pytest.mark.card
def test_sgd_control_fails_on_the_card(bench_run, card):
    cfg = registry.config("netflix")
    cfg.update(m=cfg["m"] // 20, n=max(cfg["n"] // 20, 2000), nnz=cfg["nnz"] // 400,
               test_nnz=cfg["test_nnz"] // 400)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ok, checks = bench_run.check_numbers(sgd_control_numbers(cfg, seed, card, "tf32_emulated"),
                                             registry.limits("netflix.sgd"))
        assert not ok, checks
