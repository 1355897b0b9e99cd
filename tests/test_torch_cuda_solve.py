"""The batched Cholesky solve (``kernels/csrc/batch_solve.cu``) against its
plain version in the same order of work, on the card.

Every test here needs an NVIDIA card and skips without one.  On the card:

    python -m pytest -q -m card tests/test_torch_cuda_solve.py

The file imports no JAX: the kernel is held against
``ref.batch_solve_blocked_plain``, which the CPU tests
(``tests/test_torch_kernels.py``) hold against the reference.
"""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import batch_solve as bs  # noqa: E402
from repro_torch.kernels import budgets, build  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.obs import kernel_launches  # noqa: E402

pytestmark = pytest.mark.card

#: chip_smoke.py's and the reference's solve tolerance (tests/test_kernels.py:77):
#: the kernel's FMAs against the plain version's separate products and sums
SOLVE_TOL = 5e-4

FS = [1, 2, 7, 16, 31, 32, 33, 64, 100, 127, 128]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(dev, seed, m, f):
    """SPD systems as the reference's tests make them, on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = torch.randn(m, f, f, generator=gen, device=dev) * (0.3 if f < 64 else 0.1)
    A = torch.bmm(L, L.transpose(1, 2)) + 2.0 * torch.eye(f, device=dev)
    return A, torch.randn(m, f, generator=gen, device=dev)


def _m_of(f, which):
    s = budgets.solve_systems_per_cta(f)
    return {"one": 1, "cta_less": max(1, s - 1), "cta_more": s + 1, "large": 65_537}[which]


@pytest.mark.parametrize("which", ["one", "cta_less", "cta_more", "large"])
@pytest.mark.parametrize("f", FS)
def test_kernel_matches_blocked_plain(card, f, which):
    """Single systems, a ragged last CTA on either side of a full one, and
    65,537 systems."""
    m = _m_of(f, which)
    A, B = _spd(card, 1000 * f + m, m, f)
    x = bs.batch_solve_cuda(A, B)
    xb = kref.batch_solve_blocked_plain(A, B, budgets.SOLVE_NB)
    torch.testing.assert_close(x, xb, atol=SOLVE_TOL, rtol=SOLVE_TOL)
    resid = (torch.einsum("uij,uj->ui", A, x) - B).abs().max().item()
    assert resid <= 1e-4 * max(B.abs().max().item(), 1.0)


@pytest.mark.parametrize("j", [5, 37])
def test_clamped_pivot_gives_the_blocked_plain_answer(card, j):
    """Coordinate j decoupled with pivot 1e-30 and right-hand side 1e-30:
    with the clamps, x_j is 1e10 (exactly it would be 1), the rest solved
    as usual (tests/test_torch_kernels.py's near-singular system)."""
    A, B = _spd(card, 5, 64, 40)
    A[:, j, :] = 0.0
    A[:, :, j] = 0.0
    A[:, j, j] = 1e-30
    B[:, j] = 1e-30
    x = bs.batch_solve_cuda(A, B)
    xb = kref.batch_solve_blocked_plain(A, B, budgets.SOLVE_NB)
    assert torch.isfinite(x).all()
    torch.testing.assert_close(x[:, j], torch.full_like(x[:, j], 1e10), rtol=1e-3, atol=0)
    torch.testing.assert_close(x, xb, atol=SOLVE_TOL, rtol=SOLVE_TOL)


def test_two_launches_bit_equal(card):
    A, B = _spd(card, 2, 3000, 100)
    assert torch.equal(bs.batch_solve_cuda(A, B), bs.batch_solve_cuda(A, B))


@pytest.mark.parametrize("f", [7, 100, 128])
def test_reads_the_lower_triangle_only(card, f):
    """NaN above the diagonal leaves X as it was, bit for bit (f = 7 loads
    4 bytes at a time, f = 100 and 128 16)."""
    A, B = _spd(card, 3, 777, f)
    x = bs.batch_solve_cuda(A, B)
    upper = torch.triu(torch.ones(f, f, dtype=torch.bool, device=card), diagonal=1)
    assert torch.equal(bs.batch_solve_cuda(A.masked_fill(upper, float("nan")), B), x)


def test_unaligned_rows_solve_the_same(card):
    """A and B starting 4 bytes past a 16-byte boundary take the 4-byte
    loads; X is the 16-byte loads' bit for bit."""
    m, f = 500, 100
    A, B = _spd(card, 4, m, f)
    a = torch.empty(m * f * f + 1, device=card)[1:].view(m, f, f)
    b = torch.empty(m * f + 1, device=card)[1:].view(m, f)
    a.copy_(A)
    b.copy_(B)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    assert torch.equal(bs.batch_solve_cuda(a, b), bs.batch_solve_cuda(A, B))


def test_counts_one_launch_a_call(card):
    A, B = _spd(card, 6, 100, 100)
    before = (kernel_launches().get("batch_solve", 0),
              kernel_launches("cuda_launches").get("batch_solve", 0))
    for _ in range(3):
        bs.batch_solve_cuda(A, B)
    after = (kernel_launches()["batch_solve"], kernel_launches("cuda_launches")["batch_solve"])
    assert (after[0] - before[0], after[1] - before[1]) == (3, 3)


def test_launch_shape_is_the_budgets(card):
    """The library's systems a CTA and bytes a CTA at every f equal
    ``kernels/budgets.py``'s."""
    lib = build.load("batch_solve")
    spc, smem = lib.batch_solve_systems_per_cta, lib.batch_solve_smem_bytes
    spc.argtypes = smem.argtypes = [ctypes.c_int]
    spc.restype, smem.restype = ctypes.c_int, ctypes.c_size_t
    for f in range(1, bs.MAX_F + 1):
        assert spc(f) == budgets.solve_systems_per_cta(f), f
        assert smem(f) == budgets.footprint_bytes("batch_solve", f=f), f
