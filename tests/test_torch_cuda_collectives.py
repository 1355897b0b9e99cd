"""The donated reduce-scatter, streamed between cards, against the one that
does not donate, on two and on four cards.

Every test here needs NVIDIA cards, two or four, and skips with fewer.  On
the cards:

    python -m pytest -q -m card tests/test_torch_cuda_collectives.py

The file imports no JAX: the CPU tests (``tests/test_torch_distributed.py``)
hold the in-place fold to the sum that does not donate, bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.obs.metrics import process_registry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

pytestmark = pytest.mark.card

COLS = 1024                      # a row of 4 KiB
SLAB = 1 << 20                   # 256 rows a slab here
#: NVLink 4's rate each way: no reduction receives faster
LINK_BYTES_S = 450e9
#: rows of each part over a group of g cells, two-level in pairs: a chunk
#: of 40.6 and 20.3 slabs, one of under a slab, and an empty ragged chunk
#: (1 row over a pair; 3 rows over 2 x 2: chunks of 2 and 1, then sub-
#: slices of 1, 1 and 1, 0)
CASES = {
    "slabs_and_a_part": lambda g: g * (20 * 256 + 77),
    "under_a_slab": lambda g: g * 125,
    "empty_chunk": lambda g: g - 1,
}


@pytest.fixture(params=[2, 4], ids=lambda n: f"{n}cards")
def cards(request):
    n = request.param
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA cards: the reduction streams between cards")
    return [torch.device("cuda", i) for i in range(n)]


def _parts(cards, rows, seed):
    """One part a card, of very different scales, so that another order of
    the sum would change its bits."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(rows, COLS, generator=gen) * 10.0 ** k).to(dev)
            for k, dev in enumerate(cards)]


def _counters():
    c = process_registry().snapshot()["counters"]
    return (c.get("collective/reduce_scatter/bytes", 0.0),
            c.get("collective/reduce_scatter/streamed_bytes", 0.0))


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _fill_every_card(cards):
    """Fresh memory made and written on every card before any synchronise:
    a buffer handed on while a copy still used it would be overwritten."""
    return [torch.full((64 << 20,), float("nan"), device=dev) for dev in cards]


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_two_level_reduce_scatter_is_the_sum(cards, case, monkeypatch):
    monkeypatch.setattr(coll, "SLAB_BYTES", SLAB)
    rows = CASES[case](len(cards))
    parts = _parts(cards, rows, seed=rows)
    want = [t.cpu() for t in coll.two_level_reduce_scatter([p.clone() for p in parts], 2,
                                                           ragged=True)]
    tracer = Tracer(device_clock=True)
    tracer.anchor(cards)

    def phase(name, nbytes):
        return tracer.span_on(cards, "su_als.reduce", cat="mesh", phase=name, bytes=nbytes)

    before = _counters()
    got = coll.two_level_reduce_scatter(parts, 2, ragged=True, phase=phase, donate=True)
    del parts
    junk = _fill_every_card(cards)
    after = _counters()
    for dev in cards:
        torch.cuda.synchronize(dev)
    assert all(torch.isnan(j).all() for j in junk)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.device == cards[c] and _same_bits(g.cpu(), w), c
    streamed, total = after[1] - before[1], after[0] - before[0]
    assert streamed == total == (len(cards) - 1) * rows * COLS * 4
    for span in tracer.spans(cat="mesh"):
        least_ms = span.args["bytes"] / len(cards) / LINK_BYTES_S * 1e3
        assert span.device_ms >= least_ms, (span.args, span.device_ms)


def test_streamed_flat_reduce_scatter_stages_the_terms_before_the_owner(cards, monkeypatch):
    """One group of every card: an owner after the second folds the terms
    before it in a staging slab, then adds the later ones."""
    monkeypatch.setattr(coll, "SLAB_BYTES", SLAB)
    rows = len(cards) * (5 * 256 + 31) - 7            # ragged: the last chunk short
    parts = _parts(cards, rows, seed=7)
    want = [t.cpu() for t in coll.reduce_scatter_flat([p.clone() for p in parts], ragged=True)]
    got = coll.reduce_scatter_flat(parts, ragged=True, donate=True)
    junk = _fill_every_card(cards)
    for dev in cards:
        torch.cuda.synchronize(dev)
    assert all(torch.isnan(j).all() for j in junk)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.device == cards[c] and _same_bits(g.cpu(), w), c
