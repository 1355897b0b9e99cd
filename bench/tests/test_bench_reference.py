"""The plain reference against a closed-form float64 solve on a tiny
problem, and the judge's numbers on exact, rounded and wrong factors."""
import numpy as np
import pytest
import torch

from mfbench import data, reference, registry


@pytest.fixture(scope="module")
def tiny():
    cfg = registry.config("netflix")
    cfg.update(m=120, n=40, nnz=1500, test_nnz=170, f=6)
    return cfg, data.make_problem(cfg, 12345, "cpu")


def closed_form(csr: data.Csr, fixed: np.ndarray, lam: float) -> np.ndarray:
    """x_u = (Theta_u^T Theta_u + lam n_u I)^-1 Theta_u^T r_u, row by row."""
    f = fixed.shape[1]
    out = np.zeros((csr.rows, f))
    for u in range(csr.rows):
        lo, hi = csr.ptr[u], csr.ptr[u + 1]
        if hi == lo:
            continue
        th = fixed[csr.cols[lo:hi]]
        A = th.T @ th + lam * (hi - lo) * np.eye(f)
        out[u] = np.linalg.solve(A, th.T @ csr.vals[lo:hi].astype(np.float64))
    return out


def test_solver_matches_closed_form(tiny):
    cfg, p = tiny
    lam = cfg["lam"]
    theta = p.theta0.double().numpy()
    x_ref = closed_form(p.r, theta, lam)
    x = reference.solve_side(reference._DeviceCsr(p.r, "cpu"), p.theta0, lam, "fp32")
    assert np.allclose(x.numpy(), x_ref, rtol=1e-4, atol=1e-5)


def test_judge_reads_zero_on_the_closed_form(tiny):
    cfg, p = tiny
    lam = cfg["lam"]
    theta = p.theta0.double()
    x = torch.from_numpy(closed_form(p.r, theta.numpy(), lam))
    eta = reference.row_backward_errors(p.r, theta, x, lam)
    assert float(eta.max()) < 1e-13
    x_bad = x.clone()
    x_bad[7] *= 1.01
    eta = reference.row_backward_errors(p.r, theta, x_bad, lam)
    assert float(eta[7]) > 1e-4 and float(np.delete(eta.numpy(), 7).max()) < 1e-13


def test_judge_of_an_empty_row():
    csr = data.Csr(ptr=np.array([0, 2, 2]), cols=np.array([0, 1], np.int32),
                   vals=np.array([1.0, 2.0], np.float32), n_cols=2)
    fixed = torch.eye(2, dtype=torch.float64)
    x = torch.tensor([[1.0 / 1.1, 2.0 / 1.1], [0.0, 0.0]], dtype=torch.float64)
    eta = reference.row_backward_errors(csr, fixed, x, 0.05)
    assert float(eta.max()) < 1e-15
    eta = reference.row_backward_errors(csr, fixed, x + torch.tensor([[0.0, 0.0], [1.0, 0.0]],
                                                                      dtype=torch.float64), 0.05)
    assert eta[1] == float("inf")


def test_rmse_against_numpy(tiny):
    _, p = tiny
    x, th = p.x0.double().numpy(), p.theta0.double().numpy()
    rows = np.repeat(np.arange(p.test.rows), np.diff(p.test.ptr))
    e = (x[rows] * th[p.test.cols]).sum(1) - p.test.vals
    want = np.sqrt(np.mean(e * e))
    assert reference.rmse(p.test, p.x0, p.theta0) == pytest.approx(want, rel=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -(1.0 + 3 * 2**-12), 3.0])
    r = reference.round_tf32(t)
    assert r.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10), 3.0]


def test_reference_run_in_fp32_passes_its_own_judge(tiny):
    cfg, p = tiny
    start, last, reported = reference.als_reference_run(
        p.r, p.rt, p.test, p.theta0, cfg["lam"], 2, "fp32")
    nums = reference.judge_als(p.r, p.rt, p.test, cfg["lam"], start, last, reported)
    assert max(nums.values()) < 1e-6
