"""The squared-error kernel (``kernels/csrc/sq_err.cu``) against its plain
version, on the card.

Every test here needs an NVIDIA card and skips without one.  On the card:

    python -m pytest -q -m card tests/test_torch_cuda_kernels.py

The file imports no JAX: the kernel is held against ``sq_err_plain``,
which the CPU tests (``tests/test_torch_kernels.py``) hold against the
reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sq_err as sq  # noqa: E402
from repro_torch.obs import kernel_launches  # noqa: E402

pytestmark = pytest.mark.card

#: the SSE's relative distance from the plain version: both sum fp32
#: residuals, in different orders (the plain version's fp32 total over up
#: to 2^26 gathered floats, the kernel's fp32 per work item, then float64)
SSE_RTOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, seed, m, n, K, f, frac_empty=0.2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, f, generator=gen)
    theta = torch.randn(n, f, generator=gen)
    idx = torch.randint(0, n, (m, K), generator=gen, dtype=torch.int32)
    cnt = torch.randint(0, K + 1, (m,), generator=gen, dtype=torch.int32)
    cnt[torch.rand(m, generator=gen) < frac_empty] = 0
    val = torch.randn(m, K, generator=gen) * (torch.arange(K)[None] < cnt[:, None])
    return tuple(t.to(dev) for t in (x, theta, idx, val, cnt))


def _close(acc, want):
    assert acc[1].item() == want[1].item()
    np.testing.assert_allclose(acc[0].item(), want[0].item(), rtol=SSE_RTOL)


@pytest.mark.parametrize("K", [1, 7, 64, 300, 3000])
@pytest.mark.parametrize("f", [8, 33, 100, 128])
def test_kernel_matches_plain(card, f, K):
    args = _problem(card, f * 7 + K, 257, 700, K, f)
    acc = sq.sq_err_cuda(*args)
    _close(acc, sq.sq_err_plain(*args))
    assert torch.equal(acc, sq.sq_err_cuda(*args))          # two calls bit-equal


def test_kernel_matches_plain_on_a_large_bin(card):
    # a 300k-row bin at f = 100, Netflix's item count
    args = _problem(card, 1, 300_000, 17_770, 64, 100)
    _close(sq.sq_err_cuda(*args), sq.sq_err_plain(*args))


def test_row_map_and_shared_total(card):
    x, theta, idx, val, cnt = _problem(card, 2, 1000, 500, 48, 100)
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(2)).to(card)
    x_all = torch.empty_like(x)
    x_all[perm] = x
    acc = torch.zeros(2, dtype=torch.float64, device=card)
    want = torch.zeros(2, dtype=torch.float64, device=card)
    for sl in (slice(0, 300), slice(300, 1000)):
        assert ops.sq_err(x_all, theta, idx[sl], val[sl], cnt[sl], rows=perm[sl], out=acc) is acc
        sq.sq_err_plain(x[sl], theta, idx[sl], val[sl], cnt[sl], out=want)
    _close(acc, want)


def test_f_above_the_bound_raises(card):
    x, theta, idx, val, cnt = _problem(card, 3, 16, 40, 8, 129)
    with pytest.raises(ValueError, match="outside"):
        sq.sq_err_cuda(x, theta, idx, val, cnt)


def test_launches_are_counted(card):
    args = _problem(card, 4, 64, 100, 16, 100)
    before = (kernel_launches().get("sq_err", 0),
              kernel_launches("cuda_launches").get("sq_err", 0))
    ops.sq_err(*args)                                       # the card's default: the kernel
    ops.sq_err(*args, mode="ref")                           # the plain version: no launch
    torch.cuda.synchronize()
    assert (kernel_launches()["sq_err"], kernel_launches("cuda_launches")["sq_err"]) == \
        (before[0] + 1, before[1] + 2)
