"""SU-ALS on the port's normal path, ``als_train_binned(..., mesh=...)``, on
meshes of CPU cells.

The problem is small and power-law, built here in numpy, and has what the
mesh path must carry: a user with no rating at all (the singular guard
keeps its row at 0), rows with no rating in some column shard, a bin that
holds a single row (one user rates every item), and q-batches of 7 rows,
so that some bin's last q-batch is short.  The plain reference is a
float64 ALS half-step written here: normal equations from the CSR and
``torch.linalg.solve``, nothing of the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import als  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import su_als  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.obs.metrics import process_registry  # noqa: E402
from repro_torch.obs.trace import Tracer, set_tracer  # noqa: E402
from repro_torch.sparse import padded  # noqa: E402

M, N, F, LAM = 240, 70, 8, 0.1
N_BINS, BATCH = 4, 7
MESHES = {"pod2x2": ((2, 2), ("pod", "model")),
          "data2x2": ((2, 2), ("data", "model")),
          "data1x3": ((1, 3), ("data", "model"))}
#: X after one half-step against the float64 half-step: float32 sums of at
#: most 70 products and a float32 Cholesky of 8 x 8 systems; measured below
#: 3e-7, the bound leaves ten times that
REF_TOL = 3e-6
#: the mesh against one card after three iterations: the partial Hermitians
#: summed shard by shard instead of in one sum (float32 reassociation)
#: through three rounds of solves; measured below 1e-6
ONE_CARD_TOL = 1e-5
#: the plain squared error sums each call in float32, and the shards group
#: the ratings into other calls than the bins do; the test RMSE also sees
#: the factors' reassociation error above (measured below 1.1e-7)
RMSE_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _csr(major, minor, vals, n_major):
    order = np.lexsort((minor, major))
    ptr = np.zeros(n_major + 1, np.int64)
    np.cumsum(np.bincount(major, minlength=n_major), out=ptr[1:])
    return ptr, minor[order].astype(np.int32), vals[order].astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    """(R, R^T) as CSR triples: power-law items, user 0 rates every item,
    user 3 and the last item have no rating."""
    rng = np.random.default_rng(5)
    w = np.arange(1, N + 1, dtype=np.float64) ** -0.8
    w[-1] = 0.0
    users = rng.integers(0, M, 3000)
    items = rng.choice(N, size=3000, p=w / w.sum())
    keys = np.unique(np.concatenate([users * N + items, np.arange(N - 1)]))
    users, items = keys // N, keys % N
    keep = users != 3
    users, items = users[keep], items[keep]
    vals = rng.standard_normal(users.size).astype(np.float32)
    return _csr(users, items, vals, M), _csr(items, users, vals, N)


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _layouts(problem, mesh):
    (r, rt), p = problem, su_als.mesh_axes(mesh)[1]
    return (padded.bin_col_shards(*r, N, p, n_bins=N_BINS),
            padded.bin_col_shards(*rt, M, p, n_bins=N_BINS))


def _cfg(iters=1):
    return als.AlsConfig(f=F, lam=LAM, iters=iters, batch_rows=BATCH, device="cpu", mode="ref")


def _init():
    return als.als_init(M, N, als.AlsConfig(f=F, lam=LAM, device="cpu", seed=3))


def _half64(csr, fixed):
    """x_u = (sum_v t_v t_v^T + lam n_u I)^-1 sum_v r_uv t_v in float64, 0
    for an empty row."""
    ptr, cols, vals = csr
    fixed = fixed.double()
    out = torch.zeros((ptr.size - 1, fixed.shape[1]), dtype=torch.float64)
    for u in range(ptr.size - 1):
        lo, hi = ptr[u], ptr[u + 1]
        if hi == lo:
            continue
        t = fixed[torch.from_numpy(cols[lo:hi].astype(np.int64))]
        r = torch.from_numpy(vals[lo:hi]).double()
        A = t.T @ t + LAM * (hi - lo) * torch.eye(fixed.shape[1], dtype=torch.float64)
        out[u] = torch.linalg.solve(A, t.T @ r)
    return out


def _to_csr(layout):
    """The CSR a ``BinnedShards`` holds: each row's ratings shard by shard,
    in the order the row holds them within a shard."""
    rows, keys, cols, vals = [], [], [], []
    for rb, shards in zip(layout.rows, layout.bins):
        for k, (idx, val, cnt) in enumerate(shards):
            live = torch.arange(idx.shape[1])[None, :] < cnt[:, None].long()
            r = rb[:, None].expand_as(idx)[live]
            rows.append(r)
            keys.append(r * layout.p + k)
            cols.append(idx[live].long() + layout.starts[k])
            vals.append(val[live])
    order = torch.sort(torch.cat(keys), stable=True).indices
    ptr = np.zeros(layout.m + 1, np.int64)
    np.cumsum(torch.bincount(torch.cat(rows), minlength=layout.m).numpy(), out=ptr[1:])
    return ptr, torch.cat(cols)[order].numpy(), torch.cat(vals)[order].numpy()


def test_problem_has_the_edge_cases(problem):
    r, rt = problem
    rs, rts = _layouts(problem, _mesh("pod2x2"))
    assert r[0][4] == r[0][3]                                   # user 3 empty
    assert any(rb.numel() == 1 for rb in rs.rows)               # user 0's bin
    assert any((cnt == 0).any() and (cnt > 0).any()
               for shards in rs.bins for _, _, cnt in shards)  # rows empty in a shard
    assert any(rb.numel() % BATCH for rb in rs.rows + rts.rows)  # a short last batch


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_col_shards_round_trip_to_the_csr(problem, p):
    for csr, n_cols in zip(problem, (N, M)):
        layout = padded.bin_col_shards(*csr, n_cols, p, n_bins=N_BINS)
        got = _to_csr(layout)
        for a, b in zip(got, csr):
            np.testing.assert_array_equal(a, b)
        # the rows are binned as bin_rows bins them
        want = padded.bin_rows(*csr, n_cols, n_bins=N_BINS).rows
        assert [rb.tolist() for rb in layout.rows] == [rb.tolist() for rb in want]
        assert layout.starts[-1] == n_cols and layout.nnz == csr[0][-1]
        for shards in layout.bins:
            for k, (idx, val, cnt) in enumerate(shards):
                assert idx.shape[1] == padded.round_k(int(cnt.max()), 8)
                assert int(idx.max()) < layout.starts[k + 1] - layout.starts[k]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_half_step_matches_float64_normal_equations(problem, mesh_name):
    mesh = _mesh(mesh_name)
    rs, rts = _layouts(problem, mesh)
    init = _init()
    state, hist = als.als_train_binned(rs, rts, _cfg(), init=init, mesh=mesh)
    want_x = _half64(problem[0], init.theta)
    want_theta = _half64(problem[1], state.x)
    torch.testing.assert_close(state.x.double(), want_x, atol=REF_TOL, rtol=REF_TOL)
    torch.testing.assert_close(state.theta.double(), want_theta, atol=REF_TOL, rtol=REF_TOL)
    assert torch.equal(state.x[3], torch.zeros(F)) and torch.equal(state.theta[-1], torch.zeros(F))
    assert set(hist[0]) == {"iteration", "train_rmse"}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_matches_one_card(problem, mesh_name):
    (r, rt), mesh = problem, _mesh(mesh_name)
    rs, rts = _layouts(problem, mesh)
    rb = padded.bin_rows(*r, N, n_bins=N_BINS)
    rtb = padded.bin_rows(*rt, M, n_bins=N_BINS)
    test = als.ell_triplet(padded.pad_csr_fast(*r, N), "cpu")
    one, h1 = als.als_train_binned(rb, rtb, _cfg(3), test=test, init=_init())
    seen = []
    got, h2 = als.als_train_binned(rs, rts, _cfg(3), test=test, init=_init(), mesh=mesh,
                                   callback=lambda s, rec: seen.append(s.iteration))
    torch.testing.assert_close(got.x, one.x, atol=ONE_CARD_TOL, rtol=ONE_CARD_TOL)
    torch.testing.assert_close(got.theta, one.theta, atol=ONE_CARD_TOL, rtol=ONE_CARD_TOL)
    assert seen == [1, 2, 3] and got.iteration == 3
    assert [set(h) for h in h2] == [set(h) for h in h1]
    for a, b in zip(h1, h2):
        assert b["test_rmse"] == pytest.approx(a["test_rmse"], rel=RMSE_REL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_train_rmse_equals_one_card(problem, mesh_name):
    mesh = _mesh(mesh_name)
    rs, _ = _layouts(problem, mesh)
    rb = padded.bin_rows(*problem[0], N, n_bins=N_BINS)
    gen = torch.Generator().manual_seed(1)
    x, theta = torch.randn((M, F), generator=gen), torch.randn((N, F), generator=gen)
    want = als._rmse_bins(x, theta, als._device_bins(rb, "cpu"))
    side = su_als.place_side(rs, mesh)
    syncs = process_registry().counter("host/syncs").value
    got = su_als.rmse_shards(su_als.replicate(x, mesh), su_als.replicate(theta, mesh), side, mesh)
    assert got == pytest.approx(want, rel=RMSE_REL)
    assert process_registry().counter("host/syncs").value == syncs + 1


def _counters():
    c = process_registry().snapshot()["counters"]
    return {k: c.get(f"collective/{k}/bytes", 0.0) for k in ("reduce_scatter", "all_gather")}


def _expected_bytes(mesh, side, batch_rows):
    """Bytes the cells receive in one half, by ``collective_bytes_reduce``:
    per cell its fast link, and half its slow link (the slow phase here is
    a reduce-scatter, half the ring all-reduce it prices); the gathers'
    (P - 1) times each gathered batch, and the reshard's over the data
    axis."""
    n_data, p = su_als.mesh_axes(mesh)
    sizes = su_als.col_sizes(mesh)
    p_fast, p_slow = sizes[0], (sizes[1] if len(sizes) > 1 else 1)
    rs = ag = 0.0
    for batches in su_als.mesh_batches(side, batch_rows):
        for parts in batches:
            for lo, hi in filter(None, parts):
                for nbytes in ((hi - lo) * F * F * 4, (hi - lo) * F * 4, (hi - lo) * 4):
                    cb = coll.collective_bytes_reduce(nbytes, p_fast, p_slow)["hierarchical"]
                    rs += p * (cb["fast_link"] + cb["slow_link"] / 2)
                ag += (p - 1) * (hi - lo) * F * 4
    ag += p * (n_data - 1) * side.m * F * 4
    return rs, ag


@pytest.mark.parametrize("mesh_name", ["pod2x2", "data2x2"])
def test_spans_nest_and_bytes_are_counted(problem, mesh_name):
    mesh = _mesh(mesh_name)
    rs, rts = _layouts(problem, mesh)
    tracer = Tracer()
    prev = set_tracer(tracer)
    before = _counters()
    try:
        als.als_train_binned(rs, rts, _cfg(), init=_init(), mesh=mesh)
    finally:
        set_tracer(prev)
    after = _counters()
    spans = tracer.spans()
    by_id = {s.id: s for s in spans}
    name_of = {s.id: s.name for s in spans}
    for s in spans:
        if s.name in ("su_als.herm", "su_als.reduce", "su_als.solve", "su_als.gather",
                      "als.scatter"):
            assert name_of[s.parent] == "su_als.bin", s
        if s.name in ("su_als.bin", "su_als.reshard"):
            assert name_of[s.parent] == "als.half", s
        if s.name == "als.half":
            assert name_of[s.parent] == "als.iteration"
    names = {s.name for s in spans}
    assert {"su_als.bin", "su_als.herm", "su_als.reduce", "su_als.solve", "su_als.gather",
            "su_als.reshard", "als.scatter", "als.evaluate", "als.rmse_train"} <= names
    phases = {s.args["phase"] for s in spans if s.name == "su_als.reduce"}
    assert phases == ({"fast", "slow"} if "pod" in mesh.axis_names else {"flat"})
    bins = [s for s in spans if s.name == "su_als.bin"]
    assert all(len(s.args["K"]) == mesh.size and len(s.args["nnz"]) == mesh.size for s in bins)
    assert sum(sum(s.args["nnz"]) for s in bins) == 2 * len(problem[0][1])
    # the counters, the spans' bytes and collective_bytes_reduce agree
    sides = [su_als.place_side(rs, mesh), su_als.place_side(rts, mesh)]
    want_rs, want_ag = (sum(v) for v in zip(*(_expected_bytes(mesh, s, BATCH) for s in sides)))
    assert after["reduce_scatter"] - before["reduce_scatter"] == pytest.approx(want_rs, rel=1e-12)
    assert after["all_gather"] - before["all_gather"] == pytest.approx(want_ag, rel=1e-12)
    assert sum(s.args["bytes"] for s in spans if s.name == "su_als.reduce") == \
        pytest.approx(want_rs, rel=1e-12)
    reshard = sum(s.args["bytes"] for s in spans if s.name == "su_als.reshard")
    n_data, p = su_als.mesh_axes(mesh)
    assert reshard == p * (n_data - 1) * (M + N) * F * 4
    assert by_id[bins[0].parent].args["side"] == "x"
