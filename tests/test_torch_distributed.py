"""The port's multi-device path against the reference's, on CPU cells.

One process drives every cell of a ``repro_torch.launch.mesh.Mesh`` whose
devices are all ``"cpu"``; no rendezvous, no ports, no spawned ranks.
Tolerances are the reference's own: the staged reduction bit for bit
(tests/test_mesh_streaming.py:44-51), flat against hierarchical
reduce-scatter 1e-4 (tests/test_distributed.py:206-207), SU-ALS against
the single-device ALS iteration 2e-3 (:73-74, :92-93) and ``row_block``
1e-4 (:110-111).  Problem: tests/test_distributed.py's COMMON problem.
"""
import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import als as r_als  # noqa: E402
from repro.distributed import collectives as r_coll  # noqa: E402
from repro.distributed import reduce as r_reduce  # noqa: E402
from repro.sparse import padded as r_padded  # noqa: E402
from repro.sparse import synth  # noqa: E402
from repro_torch.core import als as p_als  # noqa: E402
from repro_torch.distributed import collectives as p_coll  # noqa: E402
from repro_torch.distributed import reduce as p_reduce  # noqa: E402
from repro_torch.distributed import su_als  # noqa: E402
from repro_torch.launch import mesh as p_mesh  # noqa: E402
from repro_torch.sparse import padded as p_padded  # noqa: E402

SU_TOL = 2e-3          # tests/test_distributed.py:73-74, :92-93
BLOCK_TOL = 1e-4       # tests/test_distributed.py:110-111
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
GROUPINGS = [
    ((0, 1, 2, 3, 4, 5, 6, 7),),                  # flat ring
    ((0, 1), (2, 3), (4, 5), (6, 7)),             # the paper: 2 per PCIe switch
    ((0, 1, 2, 3), (4, 5, 6, 7)),                 # 2 sockets
    ((0, 1, 2), (3, 4, 5), (6, 7)),               # ragged domains
]


def _bitexact(a, b) -> bool:
    assert a.dtype == b.dtype == np.float64, (a.dtype, b.dtype)
    return bool((a.view(np.uint64) == b.view(np.uint64)).all())


def _parts(n_dev=8, shape=(6, 4, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n_dev)]


def _cpu_mesh(name):
    shape, axes = MESHES[name]
    return p_mesh.make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def problem():
    """tests/test_distributed.py's COMMON ``make_problem``: rows padded to
    a multiple of 8, the reference's initial state and one single-device
    ALS iteration from it."""
    spec = synth.scaled(synth.DATASETS["netflix"], 0.004, f=16)
    r_tr, r_tr_T, _, _ = synth.make_synthetic_ratings(spec, seed=1)

    def pad_rows(e, mult):
        m2 = -(-e.m // mult) * mult
        return r_padded.PaddedELL(np.pad(e.idx, ((0, m2 - e.m), (0, 0))),
                                  np.pad(e.val, ((0, m2 - e.m), (0, 0))),
                                  np.pad(e.cnt, (0, m2 - e.m)), e.n_cols)

    r_tr, r_tr_T = pad_rows(r_tr, 8), pad_rows(r_tr_T, 8)
    m, n = r_tr.m, r_tr_T.m
    r_tr = r_padded.PaddedELL(r_tr.idx, r_tr.val, r_tr.cnt, n)
    r_tr_T = r_padded.PaddedELL(r_tr_T.idx, r_tr_T.val, r_tr_T.cnt, m)
    cfg = r_als.AlsConfig(f=16, lam=0.05, iters=1, mode="ref")
    state = r_als.als_init(m, n, cfg)
    st1 = r_als.als_iteration(state, r_als.ell_triplet(r_tr), r_als.ell_triplet(r_tr_T), cfg)
    return (r_tr, r_tr_T, (np.asarray(state.x), np.asarray(state.theta)),
            (np.asarray(st1.x), np.asarray(st1.theta)))


def _sharded(problem, mesh):
    r_tr, r_tr_T = problem[:2]
    _, p = su_als.mesh_axes(mesh)
    return (su_als.shard_ratings(p_padded.partition_padded(r_tr, p), mesh),
            su_als.shard_ratings(p_padded.partition_padded(r_tr_T, p), mesh))


# ---------------------------------------------------------------------------
# topology-aware host reduction: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", GROUPINGS)
def test_topology_reduce_matches_reference_and_oracle_bitexact(groups):
    parts = _parts()
    got = p_reduce.topology_reduce(parts, p_reduce.DeviceTopology(groups))
    assert _bitexact(got, r_reduce.topology_reduce(parts, r_reduce.DeviceTopology(groups)))
    assert _bitexact(got, p_reduce.allreduce_oracle(parts))
    assert _bitexact(p_reduce.allreduce_oracle(parts), r_reduce.allreduce_oracle(parts))


def test_topology_reduce_order_default_and_spans():
    """Scrambled spellings normalize to one schedule, the default topology
    is the oracle, and a tracer sees one ring span and the tree rounds."""
    from repro_torch.obs import Tracer

    parts = _parts(4)
    a = p_reduce.topology_reduce(parts, p_reduce.DeviceTopology(((1, 0), (3, 2))))
    b = p_reduce.topology_reduce(parts, p_reduce.DeviceTopology(((0, 1), (2, 3))))
    assert _bitexact(a, b)
    assert _bitexact(p_reduce.topology_reduce(parts), p_reduce.allreduce_oracle(parts))
    tr = Tracer()
    p_reduce.topology_reduce(_parts(8), p_reduce.linear_topology(8, 2), tracer=tr)
    spans = tr.spans(cat="reduce")
    assert [s.name for s in spans] == ["reduce.ring"] + ["reduce.tree"] * 2
    assert spans[0].args["bytes"] == 4 * _parts(1)[0].nbytes


def test_topology_validation_and_helpers():
    with pytest.raises(ValueError):
        p_reduce.DeviceTopology(((0, 1), (1, 2)))          # overlapping
    with pytest.raises(ValueError):
        p_reduce.DeviceTopology(((0, 2),))                 # gap
    topo = p_reduce.linear_topology(6, 4)
    assert topo.groups == ((0, 1, 2, 3), (4, 5)) and topo.n_devices == 6
    assert topo.describe() == r_reduce.linear_topology(6, 4).describe()


@pytest.mark.parametrize("n_dev,group", [(8, 2), (8, 8), (6, 4), (4, 2), (1, 1)])
def test_reduce_traffic_matches_reference(n_dev, group):
    nbytes = 12345 * 8
    assert p_reduce.reduce_traffic(nbytes, p_reduce.linear_topology(n_dev, group)) == \
        r_reduce.reduce_traffic(nbytes, r_reduce.linear_topology(n_dev, group))


@pytest.mark.parametrize("p_fast,p_slow", [(4, 1), (4, 2), (2, 2), (8, 4)])
def test_collective_bytes_reduce_matches_reference(p_fast, p_slow):
    assert p_coll.collective_bytes_reduce(1 << 20, p_fast, p_slow) == \
        r_coll.collective_bytes_reduce(1 << 20, p_fast, p_slow)


# ---------------------------------------------------------------------------
# collectives over cells
# ---------------------------------------------------------------------------

def test_hierarchical_reduction_equals_flat():
    """tests/test_distributed.py:183: the same tensor on the 4 column cells
    of a (pod=2, model=2) group; flat and two-phase both give 4x, each
    cell its slice (two-phase: replicated over the slow axis)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    want = 4 * x
    flat = p_coll.reduce_scatter_flat([x.clone() for _ in range(4)])
    hier = p_coll.hierarchical_reduce_scatter([x.clone() for _ in range(4)], n_fast=2)
    for c in range(4):
        torch.testing.assert_close(flat[c], want[4 * c:4 * c + 4], atol=1e-4, rtol=0)
        f = c % 2
        torch.testing.assert_close(hier[c], want[8 * f:8 * f + 8], atol=1e-4, rtol=0)
    gathered = p_coll.all_gather(flat, 0)
    assert all(torch.equal(g, gathered[0]) for g in gathered)
    torch.testing.assert_close(gathered[0], want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        p_coll.reduce_scatter_flat([x[:15]] * 4)


def test_two_level_reduce_scatter_matches_flat_sum():
    """SU-ALS's two-phase reduction on a (pod=2, model=2) group: cell
    (s, f) holds sub-slice s of chunk f of the total, the fast groups
    folded first; bit-equal to that fold done by hand."""
    rng = np.random.default_rng(2)
    parts = [torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32))
             for _ in range(4)]
    out = p_coll.two_level_reduce_scatter(parts, n_fast=2)
    for s in range(2):
        for f in range(2):
            rows = slice(8 * f + 4 * s, 8 * f + 4 * s + 4)
            want = (parts[0][rows] + parts[1][rows]) + (parts[2][rows] + parts[3][rows])
            assert torch.equal(out[2 * s + f], want)
    with pytest.raises(ValueError):
        p_coll.two_level_reduce_scatter(parts[:3], n_fast=2)


def test_reduce_scatter_sums_in_ascending_cell_order():
    """The fold order is fixed: cell 0's slice, then cell 1's, ..."""
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32) * 10 ** k)
             for k in range(4)]
    out = p_coll.reduce_scatter_flat(parts)
    for c in range(4):
        want = parts[0][2 * c:2 * c + 2].clone()
        for q in parts[1:]:
            want += q[2 * c:2 * c + 2]
        assert torch.equal(out[c], want)


def _scaled_parts(n, rows, seed, cols=3):
    """n cells' tensors of very different scales, so that another order of
    the sum would change its bits."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32) * 10.0 ** k)
            for k in range(n)]


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("g,k", [(g, k) for g in (2, 3, 4) for k in range(g)])
def test_donated_fold_is_sum_to_bit_for_bit(g, k):
    """The owner at position k folds the others into its own piece in
    place: the same bits as ``_sum_to``'s left fold, and the other pieces
    untouched."""
    pieces = _scaled_parts(g, 7, seed=10 * g + k)
    others = [p.clone() for p in pieces]
    want = p_coll._sum_to(pieces, pieces[k].device)
    got = p_coll._fold_into(pieces, k)
    assert got is pieces[k] and _same_bits(got, want)
    assert all(_same_bits(pieces[j], others[j]) for j in range(g) if j != k)


@pytest.mark.parametrize("g,rows", [(2, 9), (3, 10), (4, 10), (4, 9), (3, 2)],
                         ids=lambda v: str(v))
def test_donated_reduce_scatter_is_the_sum_bit_for_bit(g, rows):
    """Ragged chunks (9 rows over 4 cells: 3, 3, 3 and an empty last one;
    2 over 3: 1, 1, 0): every cell's chunk, built in its own part, has the
    bits of the reduce-scatter that does not donate, and is a view of that
    part."""
    parts = _scaled_parts(g, rows, seed=rows)
    want = p_coll.reduce_scatter_flat([p.clone() for p in parts], ragged=True)
    got = p_coll.reduce_scatter_flat(parts, ragged=True, donate=True)
    for c in range(g):
        assert _same_bits(got[c], want[c]), c
        assert got[c].untyped_storage().data_ptr() == parts[c].untyped_storage().data_ptr()


@pytest.mark.parametrize("n_slow,n_fast,rows", [(2, 2, 16), (2, 2, 7), (2, 3, 16), (2, 3, 5)],
                         ids=lambda v: str(v))
def test_donated_two_level_reduce_scatter_is_the_sum_bit_for_bit(n_slow, n_fast, rows):
    """SU-ALS's two-phase reduction on 2 x 2 and 2 x 3 groups, even and
    ragged: cell (s, f)'s sub-slice, folded in place into its fast chunk,
    has the bits of the reduction that does not donate; the phases are
    entered in order with the bytes they receive."""
    parts = _scaled_parts(n_slow * n_fast, rows, seed=rows + n_fast)
    entered = []

    def phase(name, nbytes):
        entered.append((name, nbytes))
        return contextlib.nullcontext()

    want = p_coll.two_level_reduce_scatter([p.clone() for p in parts], n_fast, ragged=True)
    got = p_coll.two_level_reduce_scatter(parts, n_fast, ragged=True, phase=phase, donate=True)
    total = parts[0].numel() * 4
    assert entered == [("fast", n_slow * (n_fast - 1) * total), ("slow", (n_slow - 1) * total)]
    for c in range(n_slow * n_fast):
        assert _same_bits(got[c], want[c]), c
        assert got[c].untyped_storage().data_ptr() == parts[c].untyped_storage().data_ptr()


NOT_DONATING = {
    "flat": lambda parts: p_coll.reduce_scatter_flat(parts, ragged=True),
    "two_level": lambda parts: p_coll.two_level_reduce_scatter(parts, 2, ragged=True),
    "hierarchical": lambda parts: p_coll.hierarchical_reduce_scatter(parts, 2),
    "all_reduce": lambda parts: p_coll.all_reduce(parts),
}


@pytest.mark.parametrize("collective", list(NOT_DONATING))
def test_a_caller_that_does_not_donate_keeps_its_inputs(collective):
    """Without ``donate`` the inputs are left as they were, and the
    results are tensors of their own."""
    parts = _scaled_parts(4, 10, seed=3)
    before = [p.clone() for p in parts]
    for t in NOT_DONATING[collective](parts):
        t.add_(1.0)
    assert all(_same_bits(p, b) for p, b in zip(parts, before))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_make_mesh(monkeypatch):
    mesh = p_mesh.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert mesh.distinct_devices == [torch.device("cpu")]
    assert mesh.device(pod=1, data=0, model=1) == torch.device("cpu")
    assert su_als.mesh_axes(mesh) == (2, 4) and su_als.col_sizes(mesh) == (2, 2)
    assert "pod=2 x data=2 x model=2" in mesh.describe()
    with pytest.raises(ValueError):
        p_mesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        p_mesh.make_mesh((2, 2), ("data", "data"), devices=["cpu"] * 4)
    # without devices each cell wants its own card, and there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cards"):
        p_mesh.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="is_available"):
        p_mesh.make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)


def test_shard_ratings_and_rows_layout(problem):
    r_tr = problem[0]
    mesh = _cpu_mesh("2x2x2")
    idx, val, cnt = su_als.shard_ratings(p_padded.partition_padded(r_tr, 4), mesh)
    parts = r_padded.partition_padded(r_tr, 4)
    Pn, m, K = parts.idx.shape
    np.testing.assert_array_equal(idx.numpy(), np.transpose(parts.idx, (1, 0, 2)).reshape(m, Pn * K))
    np.testing.assert_array_equal(val.numpy(), np.transpose(parts.val, (1, 0, 2)).reshape(m, Pn * K))
    np.testing.assert_array_equal(cnt.numpy(), parts.cnt.T)
    theta = torch.arange(72 * 2, dtype=torch.float32).reshape(72, 2)
    rows = su_als.shard_rows(theta, mesh)
    assert len(rows.blocks) == 2 and all(len(b) == 4 for b in rows.blocks)
    for d in range(2):
        assert torch.equal(torch.cat(rows.blocks[d]), theta)


# ---------------------------------------------------------------------------
# SU-ALS on CPU cells against the reference's single-device iteration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ref", "kernel"])
@pytest.mark.parametrize("mesh_name,scheme", [
    ("2x4", "one_phase"), ("2x4", "two_phase"),
    ("2x2x2", "one_phase"), ("2x2x2", "two_phase")])
def test_su_als_matches_single_device(problem, mesh_name, scheme, mode):
    _, _, init, want = problem
    mesh = _cpu_mesh(mesh_name)
    rdev, rtdev = _sharded(problem, mesh)
    ux, ut, it = su_als.make_su_als_fns(mesh, 0.05, scheme=scheme, mode=mode)
    x2, t2 = it(init[0], init[1], rdev, rtdev)
    assert x2.shape == want[0].shape and t2.shape == want[1].shape
    np.testing.assert_allclose(x2.numpy(), want[0], atol=SU_TOL, rtol=0)
    np.testing.assert_allclose(t2.numpy(), want[1], atol=SU_TOL, rtol=0)
    # the half-steps alone, the second from placed row shards
    x3 = ux(init[1], *rdev)
    assert torch.equal(x3, x2)
    assert torch.equal(ut(su_als.shard_rows(x3, mesh), *rtdev), t2)


@pytest.mark.parametrize("row_block", [64, 100])      # 960 rows a cell: 15 or 9 + a short one
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_su_als_row_block_matches(problem, mesh_name, row_block):
    _, _, init, _ = problem
    mesh = _cpu_mesh(mesh_name)
    rdev, rtdev = _sharded(problem, mesh)
    _, _, it0 = su_als.make_su_als_fns(mesh, 0.05, row_block=0, mode="kernel")
    _, _, it1 = su_als.make_su_als_fns(mesh, 0.05, row_block=row_block, mode="kernel")
    xa, ta = it0(init[0], init[1], rdev, rtdev)
    xb, tb = it1(init[0], init[1], rdev, rtdev)
    np.testing.assert_allclose(xb.numpy(), xa.numpy(), atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), ta.numpy(), atol=BLOCK_TOL, rtol=0)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_su_als_fns_run_the_mesh_engine(problem, mesh_name):
    """``make_su_als_fns`` runs the engine of ``als_train_binned(mesh=)``:
    its ``su_als.bin`` and ``su_als.herm`` spans, the reductions nested in
    the bins with the mesh's phases; per q-batch and data group 3
    reductions (A, B, counts), each a reduce-scatter per group of cells
    of each phase, and one all-gather over the column cells, none over
    "data"; the results bit-equal to an untraced run; float32 counts
    handed in left as they were."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.metrics import process_registry
    from repro_torch.obs.trace import set_tracer

    _, _, init, _ = problem
    mesh = _cpu_mesh(mesh_name)
    rdev, rtdev = _sharded(problem, mesh)
    rdev = rdev[:2] + (rdev[2].to(torch.float32),)
    cnt = rdev[2].clone()
    row_block = 100
    _, _, it = su_als.make_su_als_fns(mesh, 0.05, row_block=row_block, mode="ref")
    want = it(init[0], init[1], rdev, rtdev)

    def calls():
        c = process_registry().snapshot()["counters"]
        return [c.get(f"collective/{k}/calls", 0) for k in ("reduce_scatter", "all_gather")]

    tracer = Tracer()
    prev = set_tracer(tracer)
    before = calls()
    try:
        with p_coll.counting(mesh.size, dict(mesh.shape)) as ctr:
            got = it(init[0], init[1], rdev, rtdev)
    finally:
        set_tracer(prev)
    after = calls()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(rdev[2], cnt)
    n_data, p = su_als.mesh_axes(mesh)
    batches = sum(-(-(rows // n_data) // row_block) for rows in (len(init[0]), len(init[1])))
    spans = tracer.spans()
    name_of = {s.id: s.name for s in spans}
    assert sum(s.name == "su_als.bin" for s in spans) == batches
    assert sum(s.name == "su_als.herm" for s in spans) == batches
    for s in spans:
        if s.name in ("su_als.herm", "su_als.reduce", "su_als.solve", "su_als.gather",
                      "als.scatter"):
            assert name_of[s.parent] == "su_als.bin", s
    sizes = su_als.col_sizes(mesh)
    two_phase = len(sizes) > 1
    phases = {s.args["phase"] for s in spans if s.name == "su_als.reduce"}
    assert phases == ({"fast", "slow"} if two_phase else {"flat"})
    per_reduction = sum(sizes) if two_phase else 1    # fast: n_slow groups, slow: n_fast
    assert after[0] - before[0] == 3 * batches * n_data * per_reduction
    assert after[1] - before[1] == batches * n_data
    gathers = [r for r in ctr.records if r.kind == "all-gather"]
    assert len(gathers) == batches * n_data
    assert all("data" not in r.axes for r in ctr.records)


def test_wave_entry_points_match_single_device(problem):
    """``make_wave_update_fn`` against the reference's single-device
    ``update_rows``; ``make_wave_herm_fn``'s per-data-shard partials,
    summed, against the reference's ``partial_herm`` of each batch."""
    r_tr, _, init, _ = problem
    mesh = _cpu_mesh("2x4")
    rcfg = r_als.AlsConfig(f=16, lam=0.05, mode="ref")
    rows = slice(0, 480)                                   # 2 batches of 240
    parts = p_padded.partition_padded(p_padded.PaddedELL(
        r_tr.idx[rows], r_tr.val[rows], r_tr.cnt[rows], r_tr.n_cols), 4)
    upd = su_als.make_wave_update_fn(mesh, 0.05, mode="kernel")
    got = upd(init[1], *su_als.shard_ratings(parts, mesh))
    want = np.asarray(r_als.update_rows(init[1], r_tr.idx[rows], r_tr.val[rows],
                                        r_tr.cnt[rows], rcfg))
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, atol=SU_TOL, rtol=0)
    # 2 x 238 rows: a data shard's rows do not split evenly over its 4 column cells
    rows = slice(0, 476)
    parts = p_padded.partition_padded(p_padded.PaddedELL(
        r_tr.idx[rows], r_tr.val[rows], r_tr.cnt[rows], r_tr.n_cols), 4)
    got = upd(init[1], *su_als.shard_ratings(parts, mesh))
    want = np.asarray(r_als.update_rows(init[1], r_tr.idx[rows], r_tr.val[rows],
                                        r_tr.cnt[rows], rcfg))
    assert got.shape == (476, 16)
    np.testing.assert_allclose(got, want, atol=SU_TOL, rtol=0)

    rt = p_padded.partition_padded(problem[1], 1)            # R^T, one column block
    store_T = p_padded.partition_padded(
        p_padded.PaddedELL(rt.idx[0], rt.val[0], rt.cnt[0], rt.n_cols), 2)   # 2 user batches
    herm = su_als.make_wave_herm_fn(mesh, 0.05, mode="kernel")
    mq = r_tr.m // 2
    x_stack = np.stack([init[0][:mq], init[0][mq:]])
    A, B = herm(x_stack, store_T.idx, store_T.val, store_T.cnt)
    assert A.dtype == np.float32 and A.shape == (2, 72, 16, 16)
    for d in range(2):
        Aj, Bj = r_als.partial_herm(x_stack[d], store_T.idx[d], store_T.val[d],
                                    store_T.cnt[d], rcfg)
        np.testing.assert_allclose(A[d], np.asarray(Aj), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(B[d], np.asarray(Bj), atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# batch-uniform stacked bins: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bins,p", [(1, 1), (4, 2), (4, 3), (8, 4)])
def test_stack_binned_parts_matches_reference(n_bins, p):
    spec = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
    r, _, _, _ = synth.make_synthetic_ratings(spec, seed=0)
    items, users, vals = r.transpose_coo()
    ptr, cc, vv = r_padded.csr_from_coo(items, users, vals, r.n_cols)
    rt = r_padded.pad_csr_fast(ptr, cc, vv, n_cols=r.m)
    rt = r_padded.PaddedELL(rt.idx, rt.val, rt.cnt, r.m)
    parts = r_padded.partition_padded(rt, 4)
    ref = r_padded.stack_binned_parts(parts, n_bins, p=p)
    mine = p_padded.stack_binned_parts(parts, n_bins, p=p)
    csrs = []
    for j in range(4):
        live = np.arange(parts.idx.shape[2])[None, :] < parts.cnt[j][:, None]
        c = parts.cnt[j].astype(np.int64)
        pj = np.concatenate([[0], np.cumsum(c)])
        csrs.append((pj, parts.idx[j][live], parts.val[j][live]))
    from_csr = p_padded.stack_binned_csr(csrs, parts.idx.shape[2], n_bins, p=p)
    assert len(ref) == len(mine) == len(from_csr)
    for a, b, c in zip(ref, mine, from_csr):
        for k in ("idx", "val", "cnt", "items"):
            x, y, z = getattr(a, k), getattr(b, k), getattr(c, k)
            assert x.dtype == y.dtype == z.dtype and x.shape == y.shape == z.shape, k
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        assert (a.cap, a.nnz, a.padded_slots, a.nbytes, a.rows % p) == \
            (b.cap, b.nnz, b.padded_slots, b.nbytes, 0)


# ---------------------------------------------------------------------------
# the reference's own SU-ALS on 8 forced host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_mesh_run(tmp_path_factory):
    """The reference's ``make_su_als_fns`` iteration on 8 forced host
    devices (tests/test_distributed.py's ``run_script``), one-phase and
    two-phase, on both meshes, from the reference's initial state."""
    from test_distributed import COMMON, run_script

    out = tmp_path_factory.mktemp("reference_mesh_run") / "ref.npz"
    run_script(COMMON + f"""
r_tr, r_tr_T, m, n = make_problem(4)
cfg = als_mod.AlsConfig(f=16, lam=0.05, iters=1, mode='ref')
state = als_mod.als_init(m, n, cfg)
res = {{}}
for name, shape, axes in (('2x4', (2, 4), ('data', 'model')),
                          ('2x2x2', (2, 2, 2), ('pod', 'data', 'model'))):
    mesh = make_mesh(shape, axes)
    rdev = su_als.shard_ratings(padded.partition_padded(r_tr, 4), mesh)
    rtdev = su_als.shard_ratings(padded.partition_padded(r_tr_T, 4), mesh)
    for scheme in ('one_phase', 'two_phase'):
        _, _, it = su_als.make_su_als_fns(mesh, 0.05, scheme=scheme)
        x2, t2 = it(state.x, state.theta, rdev, rtdev)
        res[name + scheme + '_x'] = np.asarray(x2)
        res[name + scheme + '_t'] = np.asarray(t2)
np.savez({str(out)!r}, **res)
print('OK')
""")
    with np.load(out) as ref:
        return dict(ref)


@pytest.mark.mesh
def test_su_als_matches_reference_mesh_run(problem, reference_mesh_run):
    """The reference's ``make_su_als_fns`` on 8 forced host devices and the
    port's on 8 CPU cells, one-phase and two-phase, from the same state:
    within 2e-3."""
    ref = reference_mesh_run
    _, _, init, _ = problem
    report = {}
    for name in MESHES:
        mesh = _cpu_mesh(name)
        rdev, rtdev = _sharded(problem, mesh)
        for scheme in ("one_phase", "two_phase"):
            _, _, it = su_als.make_su_als_fns(mesh, 0.05, scheme=scheme, mode="kernel")
            x2, t2 = it(init[0], init[1], rdev, rtdev)
            dx = float(np.abs(x2.numpy() - ref[name + scheme + "_x"]).max())
            dt = float(np.abs(t2.numpy() - ref[name + scheme + "_t"]).max())
            report[name + scheme] = (dx, dt)
    assert all(max(v) <= SU_TOL for v in report.values()), json.dumps(report)


def _csr_of(ell):
    """A ``PaddedELL``'s ratings as a CSR triple (ptr, cols, vals)."""
    live = np.arange(ell.idx.shape[1])[None, :] < ell.cnt[:, None]
    ptr = np.zeros(ell.idx.shape[0] + 1, np.int64)
    np.cumsum(ell.cnt, out=ptr[1:])
    return ptr, ell.idx[live].astype(np.int32), ell.val[live].astype(np.float32)


@pytest.mark.mesh
@pytest.mark.parametrize("batch_rows", [0, 100])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_train_binned_matches_reference_mesh_run(problem, reference_mesh_run, mesh_name,
                                                      batch_rows):
    """The port's normal SU-ALS path, ``als_train_binned(..., mesh=)`` on
    binned column shards resident on 8 CPU cells, against the reference's
    ``make_su_als_fns`` iteration on the same mesh shape (one-phase on the
    mesh without a pod axis, two-phase on the one with), from the same
    state: within the reference's own SU-ALS tolerance, 2e-3 (measured
    below 3e-6).  ``batch_rows`` 0 takes each bin in one q-batch, 100 in
    several, the last short."""
    r_tr, r_tr_T, init, _ = problem
    mesh = _cpu_mesh(mesh_name)
    p = su_als.mesh_axes(mesh)[1]
    rs = p_padded.bin_col_shards(*_csr_of(r_tr), r_tr.n_cols, p, n_bins=4)
    rts = p_padded.bin_col_shards(*_csr_of(r_tr_T), r_tr_T.n_cols, p, n_bins=4)
    cfg = p_als.AlsConfig(f=16, lam=0.05, iters=1, batch_rows=batch_rows, device="cpu",
                          mode="kernel")
    start = p_als.AlsState(x=torch.tensor(init[0]), theta=torch.tensor(init[1]),
                           iteration=0)
    state, hist = p_als.als_train_binned(rs, rts, cfg, init=start, mesh=mesh)
    scheme = "two_phase" if "pod" in mesh.axis_names else "one_phase"
    dx = float(np.abs(state.x.numpy() - reference_mesh_run[mesh_name + scheme + "_x"]).max())
    dt = float(np.abs(state.theta.numpy() - reference_mesh_run[mesh_name + scheme + "_t"]).max())
    assert max(dx, dt) <= SU_TOL, (dx, dt)
    assert state.iteration == 1 and len(hist) == 1
