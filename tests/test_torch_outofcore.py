"""The port's out-of-core path against the reference's, on the CPU.

Host-side layouts, plans, schedules and predictions are numpy in both
packages and must be bit-equal; the streaming driver runs in ``"ref"``
and ``"kernel"`` mode (the plain versions, on the CPU) from the
reference's injected initial factors and is held to the reference's
ALS-trajectory tolerance (tests/test_convergence.py:80), its RMSE within
1e-4 (tests/test_outofcore.py:181) and every exact ledger record equal.
Problem: tests/test_outofcore.py's SPEC.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import als as r_als  # noqa: E402
from repro.core import partition as r_part  # noqa: E402
from repro.data.prefetch import Prefetcher as RefPrefetcher  # noqa: E402
from repro.obs.ledger import validate_ledger as r_validate  # noqa: E402
from repro.outofcore import schedule as r_sched  # noqa: E402
from repro.outofcore import store as r_store  # noqa: E402
from repro.outofcore.driver import run_streaming_als as r_run  # noqa: E402
from repro.sgd import blocking as r_blocking  # noqa: E402
from repro.sparse import padded as r_padded  # noqa: E402
from repro.sparse import synth  # noqa: E402
from repro_torch.core import als as p_als  # noqa: E402
from repro_torch.core import partition as p_part  # noqa: E402
from repro_torch.data.prefetch import Prefetcher  # noqa: E402
from repro_torch.kernels import budgets  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.outofcore import schedule as p_sched  # noqa: E402
from repro_torch.outofcore import store as p_store  # noqa: E402
from repro_torch.outofcore.driver import run_streaming_als as p_run  # noqa: E402
from repro_torch.outofcore.runtime import SimulatedFailure  # noqa: E402
from repro_torch.sgd import blocking as p_blocking  # noqa: E402
from repro_torch.sparse import padded as p_padded  # noqa: E402

SPEC = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
ACC_EPS = SPEC.n * (SPEC.f * SPEC.f + 3 * SPEC.f + 1) * 4
TRAJ_TOL = 3e-3            # tests/test_convergence.py:80
RMSE_TOL = 1e-4            # tests/test_outofcore.py:181


@pytest.fixture(scope="module")
def problem():
    r, rt, rte, _ = synth.make_synthetic_ratings(SPEC, seed=0)
    return r, rt, rte


def _assert_ell_equal(a, b):
    for k in ("idx", "val", "cnt"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y)
    assert a.n_cols == b.n_cols


def _assert_binned_equal(a, b):
    assert (a.m, a.n_cols, a.n_bins) == (b.m, b.n_cols, b.n_bins)
    for x, y in zip(a.bins, b.bins):
        _assert_ell_equal(x, y)
    for x, y in zip(a.rows, b.rows):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _fields(obj):
    return dataclasses.astuple(obj)


# ---------------------------------------------------------------------------
# layouts, planner, stores, schedules: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4, 5])
def test_partition_padded_matches_reference(problem, p):
    r, rt, _ = problem
    for ell in (r, rt):
        if ell.n_cols % p == 0:
            _assert_ell_equal(r_padded.partition_padded(ell, p),
                              p_padded.partition_padded(ell, p))
    _assert_ell_equal(r_padded.partition_padded(r, p, k_multiple=16),
                      p_padded.partition_padded(r, p, k_multiple=16))
    with pytest.raises(ValueError):
        p_padded.partition_padded(r, 3)


@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_row_partition_matches_reference(problem, q):
    r, _, _ = problem
    _assert_ell_equal(r_padded.row_partition(r, q), p_padded.row_partition(r, q))
    with pytest.raises(ValueError):
        p_padded.row_partition(r, 7)


@pytest.mark.parametrize("kw", [
    dict(fill=1.5), dict(fill=2.25, buffers=4, eps=ACC_EPS),
    dict(bin_fills=[(400, 300), (96, 80)], buffers=4, acc_bytes=4096),
    dict(fill=1.0, dtype_bytes=8, hbm_bytes=1 << 40),
])
def test_plan_for_matches_reference(problem, kw):
    r, _, _ = problem
    kw.setdefault("hbm_bytes", 1 << 22)
    for p, q, n_data in ((1, 4, 2), (1, 3, 2), (2, 8, 4), (1, 1, 16)):
        a = r_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=p, q=q, n_data=n_data, **kw)
        b = p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=p, q=q, n_data=n_data, **kw)
        assert _fields(a) == _fields(b) and a.describe() == b.describe()
        for m in (SPEC.m, 97):
            assert [[_fields(x) for x in w] for w in r_part.export_schedule(a, m)] == \
                [[_fields(x) for x in w] for w in p_part.export_schedule(b, m)]


def test_plan_partitions_and_budget_default(problem):
    r, _, _ = problem
    for args in ((480_189, 17_770, 99_072_112, 100, 16 << 30),
                 (480_189, 17_770, 99_072_112, 100, 80 << 30),
                 (SPEC.m, SPEC.n, r.nnz, SPEC.f, 1 << 22),
                 (10_000_000, 5_000_000, 3 << 30, 128, 16 << 30)):
        a = r_part.plan_partitions(*args[:4], hbm_bytes=args[4], n_data=4)
        b = p_part.plan_partitions(*args[:4], hbm_bytes=args[4], n_data=4)
        assert _fields(a) == _fields(b)
    assert p_part.streaming_acc_bytes(40, 8) == r_part.streaming_acc_bytes(40, 8)
    # the autotuner's pricing (plan_for(auto=True)) prices as the reference's
    auto = dict(hbm_bytes=1 << 22, auto=True, degrees=np.asarray(r.cnt))
    assert _fields(p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=1, q=4, **auto)) == \
        _fields(r_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=1, q=4, **auto))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="hbm_bytes"):
            p_part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=1, q=4)


@pytest.mark.parametrize("q,n_bins", [(1, 1), (3, 1), (4, 1), (1, 4), (3, 4), (4, 4), (4, 8)])
def test_rating_store_matches_reference(problem, q, n_bins):
    r, _, _ = problem
    a = r_store.RatingStore(r, q=q, n_bins=n_bins)
    b = p_store.RatingStore(r, q=q, n_bins=n_bins)
    assert (a.m, a.n, a.q, a.m_pad, a.nnz, a.n_bins) == (b.m, b.n, b.q, b.m_pad, b.nnz, b.n_bins)
    _assert_ell_equal(a.r, b.r)
    assert b.rt_shape == a.rt_parts.idx.shape
    np.testing.assert_array_equal(b.rt_cnt, a.rt_parts.cnt)
    for prop in ("fill_r", "fill_rt", "worst_fill", "host_nbytes"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert a.fill_breakdown() == b.fill_breakdown()
    assert b._rt_parts is None            # the uniform stack is built only on use
    _assert_ell_equal(a.rt_parts, b.rt_parts)
    for j in range(q):
        for x, y in zip(a.theta_batch_triplet(j), b.theta_batch_triplet(j)):
            np.testing.assert_array_equal(x, y)
    npp = a.m_pad // q
    for j in range(q):
        for x, y in zip(a.x_slice_triplet(j * npp, (j + 1) * npp),
                        b.x_slice_triplet(j * npp, (j + 1) * npp)):
            np.testing.assert_array_equal(x, y)
    if n_bins == 1:
        assert b.r_binned is None and b.rt_binned is None
        with pytest.raises(ValueError):
            b.bin_fill_pairs()
        with pytest.raises(ValueError):
            b.x_slice_binned(0, npp)
        return
    assert a.bin_fill_pairs() == b.bin_fill_pairs()
    _assert_binned_equal(a.r_binned, b.r_binned)
    for j in range(q):
        _assert_binned_equal(a.theta_batch_binned(j), b.theta_batch_binned(j))
    for lo, hi in ((0, npp), (5, 61), (npp, a.m_pad)):
        _assert_binned_equal(a.x_slice_binned(lo, hi), b.x_slice_binned(lo, hi))


def test_store_auto_bins_and_the_mesh_guard(problem):
    """``n_bins="auto"`` builds the reference's autotuned store, at p = 1
    and p = 2; a p = 1 store refuses to cut mesh slices, and a p that does
    not divide the items raises."""
    r, _, _ = problem
    for p in (1, 2):
        a = r_store.RatingStore(r, q=4, p=p, n_bins="auto")
        b = p_store.RatingStore(r, q=4, p=p, n_bins="auto")
        assert (a.n_bins, a.bin_fill_pairs(), a.worst_fill) == \
            (b.n_bins, b.bin_fill_pairs(), b.worst_fill)
        assert b.tune["config"] == a.tune["config"] and b.tune["score"] == a.tune["score"]
    _assert_binned_equal(r_store.RatingStore(r, q=4, n_bins="auto").r_binned,
                         p_store.RatingStore(r, q=4, n_bins="auto").r_binned)
    with pytest.raises(ValueError, match="p=1"):
        p_store.RatingStore(r, q=4).x_slice_mesh_triplet(0, 8)
    with pytest.raises(ValueError, match="not divisible"):
        p_store.RatingStore(r, q=4, p=3)


def _plan(mod, store, r, q, n_data, n_bins):
    kw = (dict(bin_fills=store.bin_fill_pairs()) if n_bins > 1
          else dict(fill=store.worst_fill))
    return mod.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=1, q=q, n_data=n_data,
                        eps=ACC_EPS, buffers=4, hbm_bytes=1 << 22, **kw)


@pytest.mark.parametrize("q,n_data,n_bins", [(4, 2, 1), (3, 2, 1), (4, 1, 1),
                                              (8, 3, 1), (4, 2, 4), (3, 2, 4)])
def test_schedule_and_stream_stats_match_reference(problem, q, n_data, n_bins):
    r, _, _ = problem
    a = r_store.RatingStore(r, q=q, n_bins=n_bins)
    b = p_store.RatingStore(r, q=q, n_bins=n_bins)
    sa = r_sched.build_schedule(_plan(r_part, a, r, q, n_data, n_bins), SPEC.m, SPEC.n,
                                n_data=n_data)
    sb = p_sched.build_schedule(_plan(p_part, b, r, q, n_data, n_bins), SPEC.m, SPEC.n,
                                n_data=n_data)
    assert sa.describe() == sb.describe() and sa.capacity_bytes == sb.capacity_bytes
    assert [[_fields(x) for x in w.batches] for w in sa.waves] == \
        [[_fields(x) for x in w.batches] for w in sb.waves]
    for depth in (1, 2, 3):
        assert r_sched.required_capacity_bytes(a, sa, SPEC.f, depth) == \
            p_sched.required_capacity_bytes(b, sb, SPEC.f, depth)
    assert r_sched.predicted_stream_stats(a, sa, SPEC.f) == \
        p_sched.predicted_stream_stats(b, sb, SPEC.f)


@pytest.mark.parametrize("g,n_workers,per_tile_k", [(4, 2, False), (4, 3, False), (4, 2, True)])
def test_sgd_schedule_and_tiles_match_reference(problem, g, n_workers, per_tile_k):
    r, _, _ = problem
    ga = r_blocking.block_ell(r, g=g, per_tile_k=per_tile_k)
    gb = p_blocking.block_ell(r, g=g, per_tile_k=per_tile_k)
    sa = r_sched.build_sgd_schedule(ga, SPEC.f, n_workers=n_workers)
    sb = p_sched.build_sgd_schedule(gb, SPEC.f, n_workers=n_workers)
    assert sa.describe() == sb.describe() and sa.capacity_bytes == sb.capacity_bytes
    order = [2, 0, 3, 1]
    assert [_fields(w) for w in sa.epoch_waves(order)] == \
        [_fields(w) for w in sb.epoch_waves(order)]
    with pytest.raises(ValueError):
        sb.epoch_waves([0, 1, 2, 2])
    ta, tb = r_store.TileStore(ga), p_store.TileStore(gb)
    pa = r_sched.predicted_sgd_stream_stats(ta, sa)
    pb = p_sched.predicted_sgd_stream_stats(tb, sb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    assert (ta.host_nbytes, ta.nnz) == (tb.host_nbytes, tb.nnz)
    for x, y in zip(ta.tile_triplet(1, 2), tb.tile_triplet(1, 2)):
        np.testing.assert_array_equal(x, y)
    assert np.shares_memory(tb.tile_triplet(1, 2)[1], gb.val)


def test_budgets_mirror_the_launch_configs():
    # csrc/herm_tile.cuh smem_bytes(f) and csrc/batch_solve.cu batch_solve_smem_bytes(f)
    assert budgets.footprint_bytes("fused_herm", f=100) == 40400      # staged A, B
    assert budgets.footprint_bytes("fused_herm", f=8) == 2 * 32 * (16 * 4 + 4)
    assert budgets.footprint_bytes("fused_herm", f=128) == 66048
    assert budgets.footprint_bytes("batch_solve", f=100) == 5 * (16 * 26 * 55 + 128)   # 5 systems
    assert budgets.footprint_bytes("batch_solve", f=128) == 3 * (16 * 33 * 69 + 128)   # 3 systems
    for name, b in budgets.BUDGETS.items():
        assert budgets.footprint_bytes(name, f=b.dim_bounds["f"]) <= b.smem_limit
    assert budgets.SMEM_BYTES == 227 * 1024
    with pytest.raises(KeyError):
        budgets.footprint_bytes("sgd_tile", f=8)
    with pytest.raises(ValueError):
        budgets.footprint_bytes("batch_solve", f=129)


# ---------------------------------------------------------------------------
# prefetcher lifecycle (tests/test_outofcore.py:53-90, mirrored)
# ---------------------------------------------------------------------------

def _join(pf, timeout=5.0):
    deadline = time.monotonic() + timeout
    while pf._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not pf._thread.is_alive()


def test_prefetcher_close_unblocks_worker():
    pf = Prefetcher(({"x": np.asarray([i])} for i in range(1000)), depth=1, device="cpu")
    item = next(pf)               # worker is now blocked on a full queue
    assert isinstance(item["x"], torch.Tensor) and item["x"].tolist() == [0]
    pf.close()
    assert _join(pf), "worker thread leaked after close()"
    assert pf.closed
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                    # idempotent


def test_prefetcher_context_manager():
    with Prefetcher(iter(range(1000)), depth=1, put=lambda x: x, device="cpu") as pf:
        assert next(pf) == 0
    assert _join(pf)


def test_prefetcher_close_after_exhaustion():
    pf = Prefetcher(iter(range(3)), depth=2, put=lambda x: x, device="cpu")
    assert list(pf) == [0, 1, 2]
    pf.close()
    assert _join(pf)


def test_prefetcher_still_propagates_errors():
    def boom():
        yield 1
        raise ValueError("boom")

    with Prefetcher(boom(), depth=2, put=lambda x: x, device="cpu") as pf:
        assert next(pf) == 1
        with pytest.raises(ValueError, match="boom"):
            next(pf)


def test_prefetcher_uploads_copies_and_reports_like_the_reference():
    host = [np.arange(6, dtype=np.int32).reshape(2, 3) + i for i in range(4)]
    tr_p, reg_p = Tracer(), MetricsRegistry()
    with Prefetcher(iter(host), depth=2, put=lambda a: ("tag", a, [a * 2]),
                    device="cpu", tracer=tr_p, registry=reg_p) as pf:
        got = list(pf)
    for a, (tag, t, (t2,)) in zip(host, got):
        assert tag == "tag" and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)
        np.testing.assert_array_equal(t2.numpy(), a * 2)
        assert not np.shares_memory(t.numpy(), a)
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.obs import Tracer as RefTracer
    tr_r, reg_r = RefTracer(), RefRegistry()
    with RefPrefetcher(iter(host), depth=2, put=lambda a: a, tracer=tr_r,
                       registry=reg_r) as pf:
        list(pf)
    assert sorted(reg_p.phase_seconds()) == sorted(reg_r.phase_seconds()) == \
        ["prefetch", "prefetch_load"]
    assert reg_p.counter("prefetch/items").value == reg_r.counter("prefetch/items").value == 4
    assert sorted((e.name, e.cat) for e in tr_p.spans()) == \
        sorted((e.name, e.cat) for e in tr_r.spans())
    assert "prefetch-worker" in tr_p.thread_names.values()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Prefetcher(iter(host))


# ---------------------------------------------------------------------------
# the streaming driver against the reference's
# ---------------------------------------------------------------------------

CASES = {"uniform": (4, 2, 1), "ragged": (3, 2, 1), "binned": (4, 2, 4)}


def _setup(side, r, case):
    q, n_data, n_bins = CASES[case]
    store_mod, part, sched_mod = ((r_store, r_part, r_sched) if side == "ref"
                                  else (p_store, p_part, p_sched))
    store = store_mod.RatingStore(r, q=q, n_bins=n_bins)
    sched = sched_mod.build_schedule(_plan(part, store, r, q, n_data, n_bins),
                                     SPEC.m, SPEC.n, n_data=n_data)
    return store, sched


@pytest.fixture(scope="module")
def init(problem):
    r, rt, _ = problem
    st = r_als.als_init(r.m, rt.m, r_als.AlsConfig(f=SPEC.f, lam=SPEC.lam))
    return np.array(st.x), np.array(st.theta)


def _factors(mod, store, init):
    x0 = np.zeros((store.m_pad, SPEC.f), np.float32)
    x0[:store.m] = init[0]
    return mod.FactorStore.from_arrays(x0, init[1])


@pytest.fixture(scope="module")
def ref_runs(problem, init):
    r, _, rte = problem
    out = {}
    for case in CASES:
        store, sched = _setup("ref", r, case)
        cfg = r_als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=2, mode="ref")
        out[case] = r_run(store, sched, cfg, factors=_factors(r_store, store, init),
                          train_eval=r_als.ell_triplet(r),
                          test_eval=r_als.ell_triplet(rte))
    return out


def _port_cfg(**kw):
    return p_als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=2, device="cpu", **kw)


def _records(tel, rename=False):
    out = {}
    for rec in tel.ledger["records"]:
        name = rec["name"]
        if rename:
            name = name.replace("smem/", "vmem/")
        out[name] = rec
    return out


def _consumer_floor(store, sched):
    """The least the metered peak can be: what the consumer alone holds
    while it solves a wave — in the solve-X half the fixed Theta, the
    solve scratch and one batch's share of the wave; in the
    accumulate-Theta half the accumulators and one batch's payload."""
    f = SPEC.f
    st = p_sched.predicted_stream_stats(store, sched, f)
    share = [min(b // len(w.batches) for b, w in zip(st[k], sched.waves))
             for k in ("x_bytes", "t_bytes")]
    x_half = store.n * f * 4 + sched.waves[0].rows * (f * f + 2 * f) * 4 // sched.n_data
    return max(x_half + share[0], store.n * (f * f + f + 1) * 4 + share[1])


def _assert_peak(peak, tel, store, sched):
    """The metered peak depends on how far the prefetch worker, which
    registers its wave buffers on its own thread, ran ahead of the
    consumer, in both packages; it is held as the reference's tests hold
    it (tests/test_outofcore.py:156, :185), not compared across runs."""
    assert _consumer_floor(store, sched) <= peak <= tel.capacity_bytes, \
        (peak, tel.capacity_bytes)


@pytest.mark.parametrize("mode", ["ref", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_streaming_matches_reference(problem, init, ref_runs, case, mode):
    r, _, rte = problem
    store, sched = _setup("port", r, case)
    tr, reg = Tracer(), MetricsRegistry()
    fac, hist, tel = p_run(store, sched, _port_cfg(mode=mode),
                           factors=_factors(p_store, store, init),
                           train_eval=p_als.ell_triplet(r, "cpu"),
                           test_eval=p_als.ell_triplet(rte, "cpu"),
                           tracer=tr, registry=reg)
    rfac, rhist, rtel = ref_runs[case]
    np.testing.assert_allclose(fac.x, rfac.x, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    np.testing.assert_allclose(fac.theta, rfac.theta, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    assert len(hist) == len(rhist) == 2
    for a, b in zip(hist, rhist):
        assert abs(a["train_rmse"] - b["train_rmse"]) < RMSE_TOL
        assert abs(a["test_rmse"] - b["test_rmse"]) < RMSE_TOL
        assert a["waves_run"] == b["waves_run"]
        _assert_peak(a["peak_bytes"], tel, store, sched)
    # the ledger: the reference's validator accepts it, every record holds,
    # and every exact record (and every fill) equals the reference's; the
    # metered peaks on their predicted side
    assert r_validate(tel.ledger)["ok"] and all(x["ok"] for x in tel.ledger["records"])
    mine, ref = _records(tel, rename=True), _records(rtel)
    assert set(mine) == set(ref) - {"vmem/fused_herm_pallas", "vmem/batch_solve_pallas"} \
        | {"vmem/fused_herm", "vmem/batch_solve"}
    for name, rec in ref.items():
        if name.startswith(("peak", "modeled")):
            assert mine[name]["predicted"] == rec["predicted"], name
            _assert_peak(mine[name]["measured"], tel, store, sched)
        elif rec["check"] == "exact" or name.startswith(("fill", "worst")):
            assert (mine[name]["predicted"], mine[name]["measured"]) == \
                (rec["predicted"], rec["measured"]), name
    for kernel in ("fused_herm", "batch_solve"):
        rec = _records(tel)[f"smem/{kernel}"]
        assert rec["measured"] == budgets.footprint_bytes(kernel, f=SPEC.f)
        assert rec["context"] == {"mode": mode}
    for key in ("waves_run", "batches_loaded", "bytes_streamed", "padded_slots",
                "nnz_streamed", "capacity_bytes"):
        assert getattr(tel, key) == getattr(rtel, key), key
    _assert_peak(tel.peak_bytes, tel, store, sched)
    assert set(tel.ledger["run"]) == set(rtel.ledger["run"]) | {"device"}
    # the span contract: one solve span per wave consumed
    assert len(tr.spans(cat="solve")) == tel.waves_run == 2 * len(sched.waves) * 2
    assert {"driver", "iteration", "half", "solve", "prefetch",
            "prefetch_load"} <= set(tel.phase_seconds)


def test_binned_streaming_matches_uniform(problem, init):
    r, _, _ = problem
    runs = {}
    for case in ("uniform", "binned"):
        store, sched = _setup("port", r, case)
        runs[case] = p_run(store, sched, _port_cfg(mode="kernel"),
                           factors=_factors(p_store, store, init),
                           train_eval=p_als.ell_triplet(r, "cpu"))
    (fu, hu, tu), (fb, hb, tb) = runs["uniform"], runs["binned"]
    np.testing.assert_allclose(fb.x, fu.x, atol=1e-5)              # test_outofcore.py:474
    np.testing.assert_allclose(fb.theta, fu.theta, atol=1e-5)
    for a, b in zip(hb, hu):
        assert abs(a["train_rmse"] - b["train_rmse"]) < 1e-5
    fw = {case: _records(t)["fill_waste_ratio"]["measured"] for case, t in
          (("u", tu), ("b", tb))}
    assert fw["b"] < fw["u"]


@pytest.mark.parametrize("case,kill_after", [("uniform", 1), ("uniform", 3),
                                             ("binned", 3), ("ragged", 4)])
def test_kill_and_resume_bit_exact(problem, init, tmp_path, case, kill_after):
    r, _, _ = problem
    store, sched = _setup("port", r, case)
    cfg = _port_cfg(mode="kernel")
    ref_fac, ref_hist, _ = p_run(store, sched, cfg, factors=_factors(p_store, store, init),
                                 train_eval=p_als.ell_triplet(r, "cpu"))
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedFailure):
        p_run(store, sched, cfg, factors=_factors(p_store, store, init), ckpt_dir=ckpt,
              fail_after_waves=kill_after)
    fac, hist, tel = p_run(store, sched, cfg, ckpt_dir=ckpt,
                           train_eval=p_als.ell_triplet(r, "cpu"))
    assert tel.resumed_from_step == kill_after
    assert torch.equal(torch.from_numpy(fac.x), torch.from_numpy(ref_fac.x))
    assert torch.equal(torch.from_numpy(fac.theta), torch.from_numpy(ref_fac.theta))
    assert hist[-1]["train_rmse"] == ref_hist[-1]["train_rmse"]
    ledger = _records(tel)
    assert all(rec["ok"] for rec in ledger.values())
    assert tel.ledger["run"]["resumed_from_step"] == kill_after


@pytest.mark.parametrize("n_bins", [1, 4])
def test_x_slices_are_views_of_the_store(problem, n_bins):
    # the driver streams these slices as they are: views of the store's
    # arrays (the prefetcher's staging is the copy), equal to the copies
    # that row_slice makes by default
    r, _, _ = problem
    store = p_store.RatingStore(r, q=3, n_bins=n_bins)
    for lo, hi in ((0, 32), (5, 61), (64, 96)):
        if n_bins == 1:
            parents = [(store.r.idx, store.r.val, store.r.cnt)]
            got = [store.x_slice_triplet(lo, hi)]
            copies = [p_store._triplet(p_padded.row_slice(store.r, lo, hi))]
        else:
            cut = store.x_slice_binned(lo, hi)
            full = store.r_binned.row_slice(lo, hi)
            _assert_binned_equal(cut, full)
            parents = [(b.idx, b.val, b.cnt) for b in store.r_binned.bins]
            got = [(b.idx, b.val, b.cnt) for b in cut.bins]
            copies = [(b.idx, b.val, b.cnt) for b in full.bins]
        for trip, want, parent in zip(got, copies, parents):
            assert [a.dtype for a in trip] == [np.int32, np.float32, np.int32]
            for x, y, base in zip(trip, want, parent):
                np.testing.assert_array_equal(x, y)
                assert x.flags.c_contiguous
                assert np.shares_memory(x, base) or x.size == 0
                assert not np.shares_memory(y, base)


def test_solve_accumulated_in_place_equals_the_copying_solve():
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(20, 6, 6, generator=gen)
    A = g @ g.transpose(1, 2) + 0.1 * torch.eye(6)
    A[[3, 7]] = 0.0
    B = torch.randn(20, 6, generator=gen)
    B[[3, 7]] = 0.0                                    # rows no batch rated
    cnt = torch.arange(20) % 5 + 1
    cnt[[3, 7]] = 0
    for kw in ({}, {"batch_rows": 8}):
        cfg = _port_cfg(**kw)
        A0 = A.clone()
        x = p_als.solve_accumulated(A0, B, cnt, cfg)
        assert torch.equal(A0, A)                      # the copying solve leaves A
        x_ = p_als.solve_accumulated_(A0, B, cnt, cfg)
        assert torch.equal(x, x_)
        assert torch.equal(A0.diagonal(dim1=1, dim2=2)[3], torch.ones(6))
        assert torch.equal(x[[3, 7]], torch.zeros(2, 6))


def test_driver_rejects_what_is_not_ported(problem):
    r, _, _ = problem
    store, sched = _setup("port", r, "uniform")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh p=2"):     # a p = 1 schedule on p = 2
        p_run(store, sched, _port_cfg(), mesh=mesh)
    with pytest.raises(ValueError, match="pass mesh="):
        p_run(p_store.RatingStore(r, q=4, p=2, n_bins=4), sched, _port_cfg())
    for q in (3, 5):
        with pytest.raises(ValueError):
            p_run(p_store.RatingStore(r, q=q), sched, _port_cfg())
