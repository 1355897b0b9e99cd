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
from repro_torch.core import objective as port_obj  # noqa: E402
from repro_torch.kernels import budgets, build  # noqa: E402
from repro_torch.kernels import hermitian as port_herm  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels import sq_err as port_sq  # noqa: E402
from repro_torch.obs import kernel_launches  # noqa: E402


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
    before = (kernel_launches(), kernel_launches("cuda_launches"))
    A, B = port_herm.fused_herm_cuda(*_t(theta, idx, val, cnt, diag))
    A0, B0 = port_herm.fused_herm_plain(*_t(theta, idx, val, cnt, diag))
    assert torch.equal(A, A0) and torch.equal(B, B0)
    x = port_solve.batch_solve_cuda(A, B)
    assert torch.equal(x, port_solve.batch_solve_plain(A, B))
    assert (kernel_launches(), kernel_launches("cuda_launches")) == before
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
        launches = kernel_launches()["herm_hbm_accum"]
        A1, B1 = port_herm.herm_hbm_accum_cuda(*_t(theta, idx, val, cnt, diag), tk=tk)
        assert kernel_launches()["herm_hbm_accum"] == launches
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


def _solve_system_floats(f):
    """The solve's layout counted block by block: block-rows 0..f // 4 of
    W = [A_u ; b_u^T], block-row a of a + 1 4x4 blocks and 4 floats of
    padding, then two buffers of 16 floats."""
    return sum(16 * (a + 1) + 4 for a in range(f // 4 + 1)) + 2 * 16


@pytest.mark.parametrize("f", range(1, port_solve.MAX_F + 1))
def test_solve_footprint_is_its_block_layout(f):
    spc = budgets.solve_systems_per_cta(f)
    assert 1 <= spc <= budgets.SOLVE_MAX_SYS
    assert budgets.solve_system_bytes(f) == 4 * _solve_system_floats(f)
    assert budgets.footprint_bytes("batch_solve", f=f) == spc * 4 * _solve_system_floats(f)
    assert budgets.footprint_bytes("batch_solve", f=f) <= budgets.SOLVE_CTA_SMEM
    assert budgets.footprint_bytes("batch_solve", f=f) <= budgets.SMEM_BYTES
    # no larger CTA of the same systems fits beside another
    assert spc == budgets.SOLVE_MAX_SYS or \
        (spc + 1) * budgets.solve_system_bytes(f) > budgets.SOLVE_CTA_SMEM


def test_solve_fits_ten_systems_an_sm_at_f100():
    """At most 24 KB a system at f = 100, and two CTAs of five, each with
    the 1 KB a CTA reserves, in an SM's 228 KB: 10 systems an SM."""
    per_system = budgets.solve_system_bytes(100)
    assert per_system <= 24 * 1024 and 228 * 1024 // per_system >= 9
    assert budgets.solve_systems_per_cta(100) == 5
    assert 2 * (budgets.footprint_bytes("batch_solve", f=100) + 1024) <= 228 * 1024


def _sq_err_before(x, theta, idx, val, cnt, gather_elems=1 << 26):
    """The objective's squared error as ``core/objective.py`` computed it
    before the kernel: ``theta[idx]`` gathered in row chunks, an einsum."""
    m, K = idx.shape
    step = max(1, gather_elems // max(K * theta.shape[1], 1))
    sse = torch.zeros((), dtype=x.dtype)
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        g = theta[idx[lo:hi].long()]
        pred = torch.einsum("uf,ukf->uk", x[lo:hi], g)
        err = (val[lo:hi] - pred) * port_ref.mask_from_cnt(cnt[lo:hi], K, x.dtype)
        sse = sse + torch.sum(err * err)
    return sse, torch.sum(cnt)


def _sq_problem(seed, m, n, K, f, frac_empty=0.2):
    theta, idx, val, cnt = _problem(seed, m, n, K, f, frac_empty)
    x = np.random.default_rng(seed + 1).standard_normal((m, f)).astype(np.float32)
    return _t(x, theta, idx, val, cnt)


def _sq_err_f64(x, theta, idx, val, cnt):
    """(sse, nnz) in float64 numpy, one rating at a time."""
    x, theta, idx, val, cnt = (t.numpy().astype(np.float64) if t.is_floating_point()
                               else t.numpy() for t in (x, theta, idx, val, cnt))
    sse = 0.0
    for u in range(idx.shape[0]):
        k = cnt[u]
        sse += float(np.sum((val[u, :k] - theta[idx[u, :k]] @ x[u]) ** 2))
    return sse, int(cnt.sum())


@pytest.mark.parametrize("K", [1, 7, 64, 300])
@pytest.mark.parametrize("f", [8, 100, 128])
def test_sq_err_plain_is_the_objectives_gather_and_einsum(f, K):
    args = _sq_problem(f + K, 37, 50, K, f)
    sse0, n0 = _sq_err_before(*args)
    before = (kernel_launches(), kernel_launches("cuda_launches"))
    for acc in (port_ops.sq_err(*args), port_ops.sq_err(*args, mode="ref"),
                port_ops.sq_err(*args, mode="kernel"), port_sq.sq_err_cuda(*args)):
        assert acc.dtype == torch.float64 and acc.shape == (2,)
        assert acc.tolist() == [sse0.item(), float(n0)]
    sse1, n1 = port_obj._sq_err_padded(*args)
    assert sse1.dtype == torch.float32 and torch.equal(sse1, sse0) and torch.equal(n1, n0)
    assert (kernel_launches(), kernel_launches("cuda_launches")) == before
    assert "sq_err" not in build.loaded()


@pytest.mark.parametrize("frac_empty", [0.0, 0.5, 1.0])
def test_sq_err_counts_rows_with_no_rating(frac_empty):
    args = _sq_problem(5, 40, 30, 16, 12, frac_empty)
    sse, nnz = _sq_err_f64(*args)
    acc = port_ops.sq_err(*args)
    assert acc[1].item() == nnz
    np.testing.assert_allclose(acc[0].item(), sse, rtol=1e-6)
    if frac_empty == 1.0:
        assert acc.tolist() == [0.0, 0.0]
        assert port_obj.rmse_padded(*args).item() == 0.0


@pytest.mark.parametrize("rows_per_chunk", [1, 3, 7])
def test_sq_err_plain_chunk_boundaries(monkeypatch, rows_per_chunk):
    K, f = 24, 8
    args = _sq_problem(rows_per_chunk, 20, 30, K, f)
    whole = port_ops.sq_err(*args)
    monkeypatch.setattr(port_sq, "GATHER_ELEMS", rows_per_chunk * K * f)
    chunked = port_ops.sq_err(*args)
    assert chunked[1].item() == whole[1].item() == _sq_err_f64(*args)[1]
    np.testing.assert_allclose(chunked[0].item(), whole[0].item(), rtol=1e-6)
    assert chunked[0].item() == _sq_err_before(*args, rows_per_chunk * K * f)[0].item()


def test_sq_err_row_map_adds_into_one_total():
    x, theta, idx, val, cnt = _sq_problem(3, 30, 40, 16, 12)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(30))
    x_all = torch.empty_like(x)
    x_all[perm] = x                        # batch row u is row perm[u] of x_all
    acc = torch.zeros(2, dtype=torch.float64)
    parts = []
    for sl in (slice(0, 11), slice(11, 30)):
        ret = port_ops.sq_err(x_all, theta, idx[sl], val[sl], cnt[sl], rows=perm[sl], out=acc)
        assert ret is acc
        parts.append(port_ops.sq_err(x[sl], theta, idx[sl], val[sl], cnt[sl]))
    assert acc.tolist() == (parts[0] + parts[1]).tolist()


def test_sq_err_rejects_bad_inputs():
    x, theta, idx, val, cnt = _sq_problem(4, 8, 40, 16, 8)
    with pytest.raises(ValueError, match="outside"):
        port_sq.sq_err_cuda(torch.zeros(8, 129), torch.zeros(40, 129), idx, val, cnt)
    with pytest.raises(ValueError, match="int32"):
        port_sq.sq_err_cuda(x, theta, idx.long(), val, cnt)
    with pytest.raises(ValueError, match="shapes"):
        port_sq.sq_err_cuda(x, theta, idx, val[:, :8], cnt)
    with pytest.raises(ValueError, match="no row map"):
        port_sq.sq_err_cuda(x[:4], theta, idx, val, cnt)
    with pytest.raises(ValueError, match="rows must be"):
        port_sq.sq_err_cuda(x, theta, idx, val, cnt, rows=torch.arange(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        port_sq.sq_err_cuda(x, theta, idx, val, cnt, out=torch.zeros(2))
