"""Port kernel ops vs the reference's Pallas kernels (interpret mode).

The same numpy inputs go through ``repro.kernels.ops`` (Pallas kernels in
interpret mode) and ``repro_torch.kernels.ops`` on the CPU, where the
port's kernel wrappers run their plain PyTorch versions.  Tolerances are
the reference's own (tests/test_kernels.py).  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.kernels.hermitian import herm_hbm_accum as ref_herm_hbm_accum  # noqa: E402
from repro_torch.kernels import batch_solve as port_solve  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import hermitian as port_herm  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402


def _problem(seed, m, n, K, f, frac_empty=0.2):
    """tests/test_kernels.py's generator, as numpy."""
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, f)).astype(np.float32)
    idx = rng.integers(0, n, (m, K)).astype(np.int32)
    cnt = np.where(rng.random(m) < frac_empty, 0,
                   rng.integers(0, K + 1, m)).astype(np.int32)
    val = rng.standard_normal((m, K)).astype(np.float32)
    val = val * (np.arange(K)[None] < cnt[:, None])
    return theta, idx, val.astype(np.float32), cnt


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


SWEEP = [  # (m, n, K, f, seed)
    (8, 16, 8, 4, 0),
    (16, 40, 16, 8, 11),
    (24, 40, 32, 12, 23),
    (16, 16, 32, 16, 42),
    (24, 40, 8, 16, 77),
    (13, 40, 24, 12, 91),     # m not a multiple of the reference's tm
]


@pytest.mark.parametrize("diag_fallback", [True, False])
@pytest.mark.parametrize("m,n,K,f,seed", SWEEP)
def test_fused_herm_matches_reference_kernel(m, n, K, f, seed, diag_fallback):
    theta, idx, val, cnt = _problem(seed, m, n, K, f)
    A0, B0 = ref_ops.fused_herm(
        jnp.asarray(theta), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(cnt), 0.05, mode="kernel_interpret", tm=8, tk=8,
        f_mult=8, diag_fallback=diag_fallback)
    for mode in ("kernel", "ref"):
        A1, B1 = port_ops.fused_herm(*_t(theta, idx, val, cnt), 0.05,
                                     mode=mode, diag_fallback=diag_fallback)
        np.testing.assert_allclose(A1.numpy(), np.asarray(A0), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(B1.numpy(), np.asarray(B0), atol=2e-4, rtol=1e-4)


def test_weighted_lambda_diagonal_and_empty_rows():
    theta, idx, val, cnt = _problem(3, 16, 32, 16, 8)
    lam = 0.7
    A, B = port_ops.fused_herm(*_t(theta, idx, val, cnt), lam, mode="kernel")
    g = torch.from_numpy(theta)[torch.from_numpy(idx).long()]
    mask = port_ref.mask_from_cnt(torch.from_numpy(cnt), 16)
    raw = torch.einsum("ukf,ukg->ufg", g * mask[..., None], g)
    got = torch.diagonal(A - raw, dim1=1, dim2=2).numpy()
    want = np.where(cnt > 0, lam * cnt.astype(np.float32), 1.0)
    np.testing.assert_allclose(got, np.broadcast_to(want[:, None], got.shape), atol=1e-5)
    empty = cnt == 0
    assert empty.any()
    np.testing.assert_array_equal(A.numpy()[empty], np.broadcast_to(np.eye(8), (empty.sum(), 8, 8)))
    np.testing.assert_array_equal(B.numpy()[empty], 0.0)


def _spd(seed, m, f, scale=0.3, shift=2.0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((m, f, f)) * scale
    A = (L @ np.transpose(L, (0, 2, 1)) + shift * np.eye(f)[None]).astype(np.float32)
    return A, rng.standard_normal((m, f)).astype(np.float32)


@pytest.mark.parametrize("m,f,seed", [(8, 4, 0), (16, 8, 5), (13, 16, 9), (9, 100, 3)])
def test_batch_solve_matches_reference_kernel(m, f, seed):
    A, B = _spd(seed, m, f, scale=0.3 if f < 64 else 0.1)
    x0 = np.asarray(ref_ops.batch_solve(jnp.asarray(A), jnp.asarray(B),
                                        mode="kernel_interpret", tb=8))
    for mode in ("kernel", "ref"):
        x1 = port_ops.batch_solve(*_t(A, B), mode=mode).numpy()
        np.testing.assert_allclose(x1, x0, atol=5e-4, rtol=5e-4)


def test_batch_solve_actually_solves():
    A, B = _spd(1, 16, 12, scale=0.4, shift=3.0)
    x = port_ops.batch_solve(*_t(A, B), mode="kernel")
    np.testing.assert_allclose(np.einsum("uij,uj->ui", A, x.numpy()), B,
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("seed,m,K,f", [(5, 16, 16, 8), (6, 21, 24, 12)])
def test_als_update_factor_matches_reference_kernel(seed, m, K, f):
    theta, idx, val, cnt = _problem(seed, m, 32, K, f)
    x0 = np.asarray(ref_ops.als_update_factor(
        jnp.asarray(theta), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(cnt), 0.05, mode="kernel_interpret", tm=8, tk=8, tb=8,
        f_mult=8))
    x1 = port_ops.als_update_factor(*_t(theta, idx, val, cnt), 0.05, mode="kernel")
    np.testing.assert_allclose(x1.numpy(), x0, atol=2e-3, rtol=2e-3)
    x2 = port_solve.batch_solve_plain(*port_ref.fused_herm_gathered_ref(
        *_t(theta, idx, val, cnt), 0.05))
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=2e-3, rtol=2e-3)


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    theta, idx, val, cnt = _problem(2, 16, 40, 16, 8)
    diag = np.ones(16, np.float32)
    before = (port_herm.fused_herm_cuda.launches, port_herm.fused_herm_cuda.cuda_launches,
              port_solve.batch_solve_cuda.launches)
    A, B = port_herm.fused_herm_cuda(*_t(theta, idx, val, cnt, diag))
    A0, B0 = port_herm.fused_herm_plain(*_t(theta, idx, val, cnt, diag))
    assert torch.equal(A, A0) and torch.equal(B, B0)
    x = port_solve.batch_solve_cuda(A, B)
    assert torch.equal(x, port_solve.batch_solve_plain(A, B))
    assert (port_herm.fused_herm_cuda.launches, port_herm.fused_herm_cuda.cuda_launches,
            port_solve.batch_solve_cuda.launches) == before
    assert "hermitian" not in build.loaded()
    assert "batch_solve" not in build.loaded()


def test_wrappers_reject_bad_inputs():
    theta, idx, val, cnt = _problem(2, 8, 40, 16, 8)
    diag = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="int32"):
        port_herm.fused_herm_cuda(*_t(theta, idx.astype(np.int64), val, cnt, diag))
    with pytest.raises(ValueError, match="shapes"):
        port_herm.fused_herm_cuda(*_t(theta, idx, val[:, :8], cnt, diag))
    with pytest.raises(ValueError, match="outside"):
        port_herm.fused_herm_cuda(*_t(np.zeros((40, 129), np.float32), idx, val, cnt, diag))
    A, B = _spd(0, 4, 8)
    with pytest.raises(ValueError, match="B must be"):
        port_solve.batch_solve_cuda(*_t(A, B[:, :4]))
    with pytest.raises(ValueError, match="A must be"):
        port_solve.batch_solve_cuda(*_t(A[:, :4], B))
    with pytest.raises(ValueError, match="unknown mode"):
        port_ops.batch_solve(*_t(A, B), mode="kernel_interpret")


def test_default_mode_on_cpu_tensors_is_plain():
    A, B = _spd(4, 5, 6)
    x = port_ops.batch_solve(*_t(A, B))
    assert torch.equal(x, port_ref.batch_solve_ref(*_t(A, B)))


@pytest.mark.parametrize("m,n,K,f,seed", [(16, 40, 24, 8, 7), (13, 40, 32, 12, 23)])
def test_herm_hbm_accum_matches_reference_ablation(m, n, K, f, seed):
    """Fig. 7 ablation: the reference's per-bin Pallas kernel (interpret
    mode, tm=8, tk=8) against the port's wrapper (plain version on the
    CPU) at tk=8 and at a ragged tk=10 (K % tk != 0)."""
    theta, idx, val, cnt = _problem(seed, m, n, K, f)
    diag = np.where(cnt > 0, 0.05 * cnt.astype(np.float32), 1.0).astype(np.float32)
    g = jnp.take(jnp.asarray(theta), jnp.asarray(idx), axis=0)
    mask = ref_kref.mask_from_cnt(jnp.asarray(cnt), K, jnp.float32)
    mp = -(-m // 8) * 8        # the reference's tm=8 tiles need m % 8 == 0
    pad = ((0, mp - m),)
    A0, B0 = ref_herm_hbm_accum(jnp.pad(g, pad + ((0, 0), (0, 0))), jnp.pad(jnp.asarray(val), pad + ((0, 0),)),
                                jnp.pad(mask, pad + ((0, 0),)), jnp.pad(jnp.asarray(diag), pad),
                                tm=8, tk=8, interpret=True)
    for tk in (8, 10):
        launches = port_herm.herm_hbm_accum_cuda.launches
        A1, B1 = port_herm.herm_hbm_accum_cuda(*_t(theta, idx, val, cnt, diag), tk=tk)
        assert port_herm.herm_hbm_accum_cuda.launches == launches
        np.testing.assert_allclose(A1.numpy(), np.asarray(A0)[:m], atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(B1.numpy(), np.asarray(B0)[:m], atol=2e-4, rtol=1e-4)
        A2, B2 = port_herm.fused_herm_plain(*_t(theta, idx, val, cnt, diag))
        np.testing.assert_allclose(A1.numpy(), A2.numpy(), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(B1.numpy(), B2.numpy(), atol=2e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="tk"):
        port_herm.herm_hbm_accum_cuda(*_t(theta, idx, val, cnt, diag), tk=0)


@pytest.mark.parametrize("chunk", ["K", 7, 8])
def test_fused_herm_chunked_plain_matches_reference_kernel(chunk):
    """The split Hermitian's order of work: one chunk of K slots, a small
    chunk with a ragged last chunk (40 % 7), and chunks of 8 with rows
    whose cnt ends exactly on a chunk boundary."""
    m, n, K, f = 13, 40, 40, 12
    theta, idx, val, cnt = _problem(31, m, n, K, f)
    chunk = K if chunk == "K" else chunk
    cnt[:4] = [chunk, 2 * chunk, K, 0]
    val = (val * (np.arange(K)[None] < cnt[:, None])).astype(np.float32)
    diag = np.where(cnt > 0, 0.05 * cnt.astype(np.float32), 1.0).astype(np.float32)
    A1, B1 = port_ref.fused_herm_chunked_plain(*_t(theta, idx, val, cnt, diag), chunk)
    A0, B0 = ref_ops.fused_herm(jnp.asarray(theta), jnp.asarray(idx), jnp.asarray(val),
                                jnp.asarray(cnt), 0.05, mode="kernel_interpret", tm=8,
                                tk=8, f_mult=8)
    np.testing.assert_allclose(A1.numpy(), np.asarray(A0), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(B1.numpy(), np.asarray(B0), atol=2e-4, rtol=1e-4)
    A2, B2 = port_herm.fused_herm_plain(*_t(theta, idx, val, cnt, diag))
    np.testing.assert_allclose(A1.numpy(), A2.numpy(), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(B1.numpy(), B2.numpy(), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("f", [8, 33, 100])
def test_batch_solve_blocked_plain_matches_reference_kernel(f, nb):
    A, B = _spd(17 + f, 8, f, scale=0.3 if f < 64 else 0.1)
    x0 = np.asarray(ref_ops.batch_solve(jnp.asarray(A), jnp.asarray(B),
                                        mode="kernel_interpret", tb=8))
    x1 = port_ref.batch_solve_blocked_plain(*_t(A, B), nb).numpy()
    np.testing.assert_allclose(x1, x0, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(x1, port_solve.batch_solve_plain(*_t(A, B)).numpy(),
                               atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("nb", [16, 32])
def test_batch_solve_blocked_plain_clamps_like_the_reference(nb):
    """A near-singular system: coordinate 5 is decoupled with pivot 1e-30
    and right-hand side 1e-30.  Exactly, x_5 = 1; with the reference's
    clamps (rsqrt of max(d, 1e-20), divisors max(L_jj, 1e-20)) it is 1e10,
    and the other coordinates are solved as usual."""
    A, B = _spd(5, 8, 20)
    A[:, 5, :] = 0.0
    A[:, :, 5] = 0.0
    A[:, 5, 5] = 1e-30
    B[:, 5] = 1e-30
    x0 = np.asarray(ref_ops.batch_solve(jnp.asarray(A), jnp.asarray(B),
                                        mode="kernel_interpret", tb=8))
    np.testing.assert_allclose(x0[:, 5], 1e10, rtol=1e-3)
    x1 = port_ref.batch_solve_blocked_plain(*_t(A, B), nb).numpy()
    np.testing.assert_allclose(x1, x0, atol=5e-4, rtol=5e-4)
