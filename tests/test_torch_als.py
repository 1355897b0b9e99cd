"""Port ALS driver vs the reference, on the CPU.

The reference's initial factors (``jax.random``) are injected into the
port through ``state_from_numpy``; tolerances are the reference's own
(tests/test_convergence.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import als as ref_als  # noqa: E402
from repro.core import objective as ref_obj  # noqa: E402
from repro.sparse import padded as ref_padded  # noqa: E402
from repro.sparse import synth as ref_synth  # noqa: E402
from repro_torch.core import als as port_als  # noqa: E402
from repro_torch.core import objective as port_obj  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.sparse import padded as port_padded  # noqa: E402

MINI = ref_synth.SynthSpec("netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)


@pytest.fixture(scope="module")
def problem():
    r, rt, rte, _ = ref_synth.make_synthetic_ratings(MINI, seed=2, noise=0.1)
    return r, rt, rte


@pytest.fixture(scope="module")
def ref_init(problem):
    r, rt, _ = problem
    cfg = ref_als.AlsConfig(f=MINI.f, lam=MINI.lam)
    s = ref_als.als_init(r.m, rt.m, cfg)
    return np.array(s.x), np.array(s.theta)      # writable copies


def _port_cfg(**kw):
    return port_als.AlsConfig(f=MINI.f, lam=MINI.lam, device="cpu", **kw)


def _inject(ref_init):
    return port_als.state_from_numpy(*ref_init, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def test_two_iterations_match_reference_kernel_path(problem, ref_init):
    r, rt, _ = problem
    c_ref = ref_als.AlsConfig(f=MINI.f, lam=MINI.lam, mode="kernel_interpret",
                              tm=8, tk=8, tb=8, f_mult=8)
    s = ref_als.AlsState(jnp.asarray(ref_init[0]), jnp.asarray(ref_init[1]),
                         jnp.int32(0))
    R, RT = ref_als.ell_triplet(r), ref_als.ell_triplet(rt)
    for _ in range(2):
        s = ref_als.als_iteration(s, R, RT, c_ref)
    pr, prt = port_als.ell_triplet(r, "cpu"), port_als.ell_triplet(rt, "cpu")
    for mode in ("kernel", "ref"):
        st = _inject(ref_init)
        for _ in range(2):
            st = port_als.als_iteration(st, pr, prt, _port_cfg(mode=mode))
        assert st.iteration == 2
        np.testing.assert_allclose(_np(st.x), np.asarray(s.x), atol=3e-3, rtol=3e-3)
        np.testing.assert_allclose(_np(st.theta), np.asarray(s.theta), atol=3e-3, rtol=3e-3)


def test_qbatched_equals_full(problem, ref_init):
    r, rt, _ = problem
    pr, prt = port_als.ell_triplet(r, "cpu"), port_als.ell_triplet(rt, "cpu")
    s1 = port_als.als_iteration(_inject(ref_init), pr, prt, _port_cfg())
    s2 = port_als.als_iteration(_inject(ref_init), pr, prt, _port_cfg(batch_rows=128))
    np.testing.assert_allclose(_np(s1.x), _np(s2.x), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(s1.theta), _np(s2.theta), atol=2e-4, rtol=2e-4)


def test_objective_does_not_increase_and_matches_reference(problem, ref_init):
    r, rt, _ = problem
    pr, prt = port_als.ell_triplet(r, "cpu"), port_als.ell_triplet(rt, "cpu")
    cfg = _port_cfg(mode="kernel")
    st = _inject(ref_init)
    js = []
    for _ in range(4):
        st = port_als.als_iteration(st, pr, prt, cfg)
        js.append(float(port_obj.objective_j(st.x, st.theta, *pr, prt[2], MINI.lam)))
    assert all(b <= a * (1 + 1e-5) for a, b in zip(js, js[1:])), js
    R, RT = ref_als.ell_triplet(r), ref_als.ell_triplet(rt)
    j_ref = float(ref_obj.objective_j(jnp.asarray(_np(st.x)), jnp.asarray(_np(st.theta)),
                                      R[0], R[1], R[2], RT[2], MINI.lam))
    np.testing.assert_allclose(js[-1], j_ref, rtol=1e-5)
    np.testing.assert_allclose(
        float(port_obj.rmse_padded(st.x, st.theta, *pr)),
        float(ref_obj.rmse_padded(jnp.asarray(_np(st.x)), jnp.asarray(_np(st.theta)), *R)),
        rtol=1e-5)


def test_als_train_converges(problem):
    r, rt, rte = problem
    cfg = _port_cfg(iters=8, mode="kernel")
    seen = []
    state, hist = port_als.als_train(
        port_als.ell_triplet(r, "cpu"), port_als.ell_triplet(rt, "cpu"),
        r.m, rt.m, cfg, test=port_als.ell_triplet(rte, "cpu"),
        callback=lambda s, rec: seen.append(rec["iteration"]))
    assert seen == list(range(1, 9)) and state.iteration == 8
    rmses = [h["test_rmse"] for h in hist]
    assert rmses[-1] < 0.5 * rmses[0], rmses
    assert rmses[-1] < 0.35, rmses
    assert rmses[-1] <= min(rmses) * 1.05


def test_binned_equals_uniform_and_reference_binned(ref_init):
    rb, rtb, rte, _ = ref_synth.make_synthetic_ratings_binned(MINI, 4, seed=2)
    r, rt, _, _ = ref_synth.make_synthetic_ratings(MINI, seed=2)
    assert rtb.n_bins > 1
    init = _inject(ref_init)
    cfg = _port_cfg(iters=2, mode="kernel")
    sb, hb = port_als.als_train_binned(rb, rtb, cfg, init=init,
                                       test=port_als.ell_triplet(rte, "cpu"))
    su, hu = port_als.als_train(port_als.ell_triplet(r, "cpu"),
                                port_als.ell_triplet(rt, "cpu"), r.m, rt.m, cfg,
                                init=init, test=port_als.ell_triplet(rte, "cpu"))
    np.testing.assert_allclose(_np(sb.x), _np(su.x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(sb.theta), _np(su.theta), atol=1e-5, rtol=1e-5)
    for a, b in zip(hb, hu):
        np.testing.assert_allclose(a["train_rmse"], b["train_rmse"], rtol=1e-5)
        np.testing.assert_allclose(a["test_rmse"], b["test_rmse"], rtol=1e-5)

    c_ref = ref_als.AlsConfig(f=MINI.f, lam=MINI.lam, iters=2, mode="ref")
    s_ref, h_ref = ref_als.als_train_binned(rb, rtb, c_ref)
    np.testing.assert_allclose(_np(sb.x), np.asarray(s_ref.x), atol=3e-3, rtol=3e-3)
    np.testing.assert_allclose(_np(sb.theta), np.asarray(s_ref.theta), atol=3e-3, rtol=3e-3)
    np.testing.assert_allclose(hb[-1]["train_rmse"], h_ref[-1]["train_rmse"], rtol=1e-4)
    np.testing.assert_allclose(
        port_als.rmse_binned(sb.x, sb.theta, rb),
        ref_als.rmse_binned(jnp.asarray(_np(sb.x)), jnp.asarray(_np(sb.theta)), rb),
        rtol=1e-5)


def test_update_rows_binned_and_partial_herm_binned_match_reference(problem, ref_init):
    r, rt, _ = problem
    cfg_p = _port_cfg(mode="kernel")
    cfg_r = ref_als.AlsConfig(f=MINI.f, lam=MINI.lam, mode="ref")
    x_np, th_np = ref_init
    rb_port = port_padded.bin_padded(r, 4)
    rb_ref = ref_padded.bin_padded(r, 4)
    xb = port_als.update_rows_binned(torch.from_numpy(th_np), rb_port, cfg_p)
    xr = ref_als.update_rows_binned(jnp.asarray(th_np), rb_ref, cfg_r)
    np.testing.assert_allclose(_np(xb), np.asarray(xr), atol=2e-3, rtol=2e-3)
    xu = port_als.update_rows(torch.from_numpy(th_np), *port_als.ell_triplet(r, "cpu"), cfg_p)
    np.testing.assert_allclose(_np(xb), _np(xu), atol=1e-5, rtol=1e-5)

    rtb_port = port_padded.bin_padded(rt, 3)
    A, B = port_als.partial_herm_binned(torch.from_numpy(x_np), rtb_port, cfg_p)
    A0, B0 = ref_als.partial_herm_binned(jnp.asarray(x_np), ref_padded.bin_padded(rt, 3), cfg_r)
    np.testing.assert_allclose(_np(A), np.asarray(A0), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(B), np.asarray(B0), atol=2e-4, rtol=1e-4)


def test_partial_sums_then_solve_accumulated_equal_full_update(problem, ref_init):
    """Partial Hermitians over two column halves, summed, then solved with
    the empty-row guard, equal the one-shot update (the reference's
    out-of-core accumulate scheme)."""
    r, _, _ = problem
    x_np, th_np = ref_init
    cfg = _port_cfg(mode="kernel", batch_rows=100)
    theta = torch.from_numpy(th_np)
    idx, val, cnt = port_als.ell_triplet(r, "cpu")
    live = port_ref.mask_from_cnt(cnt, idx.shape[1], torch.bool)
    A = torch.zeros((r.m, MINI.f, MINI.f))
    B = torch.zeros((r.m, MINI.f))
    for half in (idx < 80, idx >= 80):
        sel = live & half
        order = torch.argsort((~sel).to(torch.int8), dim=1, stable=True)
        idx_h = torch.where(torch.gather(sel, 1, order), torch.gather(idx, 1, order), 0)
        val_h = torch.where(torch.gather(sel, 1, order), torch.gather(val, 1, order), 0.0)
        Ah, Bh = port_als.partial_herm(theta, idx_h.to(torch.int32), val_h,
                                       sel.sum(1).to(torch.int32), cfg)
        A += Ah
        B += Bh
    x = port_als.solve_accumulated(A, B, cnt, cfg)
    x_full = port_als.update_rows(theta, idx, val, cnt, cfg)
    np.testing.assert_allclose(_np(x), _np(x_full), atol=2e-4, rtol=2e-4)
    x_ref = ref_als.solve_accumulated(jnp.asarray(_np(A)), jnp.asarray(_np(B)),
                                      jnp.asarray(_np(cnt)),
                                      ref_als.AlsConfig(f=MINI.f, lam=MINI.lam, batch_rows=100))
    np.testing.assert_allclose(_np(x), np.asarray(x_ref), atol=5e-4, rtol=5e-4)


def test_als_init_is_seeded_and_scaled():
    cfg = _port_cfg(seed=3)
    a, b = port_als.als_init(50, 20, cfg), port_als.als_init(50, 20, cfg)
    assert torch.equal(a.x, b.x) and torch.equal(a.theta, b.theta)
    assert a.x.shape == (50, 8) and a.theta.shape == (20, 8) and a.iteration == 0
    assert 0.0 <= float(a.x.min()) and float(a.x.max()) < 0.3
    c = port_als.als_init(50, 20, _port_cfg(seed=4))
    assert not torch.equal(a.x, c.x)


@pytest.mark.parametrize("n_bins", [1, 3, 8])
def test_rmse_bins_matches_unbinned_and_reference(n_bins):
    """The binned train RMSE (every bin into one accumulator, read once)
    against ``rmse_padded`` on the unbinned layout of the same ratings and
    the reference's ``rmse_binned``, at factors that are not a fit."""
    rb, rtb, _, _ = ref_synth.make_synthetic_ratings_binned(MINI, n_bins, seed=2)
    r, _, _, _ = ref_synth.make_synthetic_ratings(MINI, seed=2)
    rng = np.random.default_rng(n_bins)
    x = rng.uniform(0.0, 0.5, (rb.m, MINI.f)).astype(np.float32)
    theta = rng.uniform(0.0, 0.5, (rtb.m, MINI.f)).astype(np.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(theta)
    got = port_als.rmse_binned(xt, tt, rb)
    assert isinstance(got, float)
    unbinned = float(port_obj.rmse_padded(xt, tt, *port_als.ell_triplet(r, "cpu")))
    np.testing.assert_allclose(got, unbinned, rtol=1e-6)
    np.testing.assert_allclose(
        got, float(ref_als.rmse_binned(jnp.asarray(x), jnp.asarray(theta), rb)), rtol=1e-6)
