"""The port's mesh streaming (p > 1) against the reference's, on CPU cells.

Mirrors tests/test_mesh_streaming.py.  Host-side layouts, schedules,
capacities and stream statistics are numpy in both packages and must be
bit-equal; the drivers run on a mesh of CPU cells in one process and are
held to the reference's tolerances: in-core factors and RMSE within 1e-4
(tests/test_mesh_streaming.py:189-192, :283-285, :354-356), kill/resume
bit-equal.  The ledger of a mesh run equals the reference's mesh run on 8
forced host devices, record by record, except the metered peaks, which
the prefetch worker's thread timing moves in both packages.  Problem:
tests/test_mesh_streaming.py's SPEC.
"""
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import partition as r_part  # noqa: E402
from repro.outofcore import schedule as r_sched  # noqa: E402
from repro.outofcore import store as r_store  # noqa: E402
from repro.sparse import synth  # noqa: E402
from repro_torch.core import als as p_als  # noqa: E402
from repro_torch.core import partition as p_part  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.outofcore import schedule as p_sched  # noqa: E402
from repro_torch.outofcore import store as p_store  # noqa: E402
from repro_torch.outofcore import (SimulatedFailure, TileStore,  # noqa: E402
                                   build_sgd_schedule, run_streaming_als,
                                   run_streaming_sgd)
from repro_torch.sgd import SgdConfig, block_ell, run_streaming_hybrid, sgd_train  # noqa: E402

SPEC = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
TOL = 1e-4                 # tests/test_mesh_streaming.py:189-192, :283-285, :354-356
# (q, n_data, p, n_bins): the reference's mesh cases
CASES = {"uniform": (4, 2, 2, 1), "ragged": (3, 2, 2, 1), "binned": (4, 2, 2, 4)}
PEAK_RECORDS = ("peak_device_bytes", "modeled_peak_bytes")


@pytest.fixture(scope="module")
def problem():
    r, rt, rte, _ = synth.make_synthetic_ratings(SPEC, seed=0)
    return r, rt, rte


def _mesh(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _plan(part, store, r, q, n_data, p):
    fill = (dict(bin_fills=store.bin_fill_pairs()) if store.n_bins > 1
            else dict(fill=store.worst_fill))
    return part.plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=p, q=q, n_data=n_data,
                         eps=0, buffers=4, acc_bytes=part.streaming_acc_bytes(SPEC.n, SPEC.f),
                         hbm_bytes=1 << 22, **fill)


def _setup(side, r, case):
    q, n_data, p, n_bins = CASES[case]
    store_mod, part, sched_mod = ((r_store, r_part, r_sched) if side == "ref"
                                  else (p_store, p_part, p_sched))
    store = store_mod.RatingStore(r, q=q, p=p, n_bins=n_bins)
    sched = sched_mod.build_schedule(_plan(part, store, r, q, n_data, p),
                                     SPEC.m, SPEC.n, n_data=n_data)
    return store, sched


def _cfg(mode="kernel", iters=3):
    return p_als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=iters, mode=mode, device="cpu")


@pytest.fixture(scope="module")
def incore(problem):
    r, rt, rte = problem
    cfg = _cfg("ref")
    return p_als.als_train(p_als.ell_triplet(r, "cpu"), p_als.ell_triplet(rt, "cpu"),
                           r.m, rt.m, cfg, test=p_als.ell_triplet(rte, "cpu"))


def _same(a, b) -> bool:
    return (torch.equal(torch.from_numpy(a.x), torch.from_numpy(b.x))
            and torch.equal(torch.from_numpy(a.theta), torch.from_numpy(b.theta)))


# ---------------------------------------------------------------------------
# p-sharded stores, shard IO, schedules and stream statistics: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,n_bins", [(2, 1), (2, 4), (4, 4), (5, 8)])
def test_rating_store_model_partition_matches_reference(problem, p, n_bins):
    r, _, _ = problem
    a = r_store.RatingStore(r, q=4, p=p, n_bins=n_bins)
    b = p_store.RatingStore(r, q=4, p=p, n_bins=n_bins)
    for k in ("idx", "val", "cnt"):
        np.testing.assert_array_equal(getattr(a.r_model_parts, k), getattr(b.r_model_parts, k))
        assert getattr(a.r_model_parts, k).dtype == getattr(b.r_model_parts, k).dtype
    for lo, hi in ((0, a.m_pad // 4), (5, 61), (0, a.m_pad)):
        for x, y in zip(a.x_slice_mesh_triplet(lo, hi), b.x_slice_mesh_triplet(lo, hi)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert (a.fill_r, a.fill_rt, a.fill_r_model, a.worst_fill, a.fill_breakdown(),
            a.host_nbytes) == \
        (b.fill_r, b.fill_rt, b.fill_r_model, b.worst_fill, b.fill_breakdown(), b.host_nbytes)
    assert (b.r_binned, b.rt_binned) == (None, None)
    if n_bins > 1:
        assert a.bin_fill_pairs() == b.bin_fill_pairs()
        assert len(a.rt_stacked) == len(b.rt_stacked)
        for x, y in zip(a.rt_stacked, b.rt_stacked):
            for k in ("idx", "val", "cnt", "items"):
                np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
            assert x.cap == y.cap
        for js in ([0, 1], [3], [2, 0, 1]):
            for x, y in zip(a.theta_wave_stacked(js), b.theta_wave_stacked(js)):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v)
    else:
        assert b.rt_stacked is None
        for j in range(4):
            for x, y in zip(a.theta_batch_triplet(j), b.theta_batch_triplet(j)):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a._rt_shard(j).idx, b._rt_shard(j).idx)


def test_factor_store_shard_io():
    fs = p_store.FactorStore.from_arrays(np.zeros((8, 3), np.float32),
                                         np.arange(12, dtype=np.float32).reshape(6, 2))
    rs = r_store.FactorStore.from_arrays(np.zeros((8, 3), np.float32),
                                         np.arange(12, dtype=np.float32).reshape(6, 2))
    for k in range(3):
        assert fs.shard_bounds("theta", k, 3) == rs.shard_bounds("theta", k, 3)
        np.testing.assert_array_equal(fs.read_shard("theta", k, 3), rs.read_shard("theta", k, 3))
    fs.write_shard("theta", 2, 3, torch.full((2, 2), 9.0))
    assert (fs.theta[4:6] == 9.0).all() and (fs.theta[:4] != 9.0).all()
    with pytest.raises(ValueError):
        fs.shard_bounds("theta", 0, 4)          # 6 rows not divisible by 4
    with pytest.raises(IndexError):
        fs.shard_bounds("theta", 3, 3)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_schedule_capacity_and_stats_match_reference(problem, case):
    r, _, _ = problem
    (ra, rs), (pa, ps) = _setup("ref", r, case), _setup("port", r, case)
    assert ps.describe() == rs.describe()
    assert (ps.p, ps.n_data, ps.capacity_bytes, ps.waves_per_iteration) == \
        (rs.p, rs.n_data, rs.capacity_bytes, rs.waves_per_iteration)
    assert [(w.index, w.row_start, w.row_stop, [b.index for b in w.batches])
            for w in ps.waves] == \
        [(w.index, w.row_start, w.row_stop, [b.index for b in w.batches]) for w in rs.waves]
    for depth in (1, 2, 3):
        assert p_sched.required_capacity_bytes(pa, ps, SPEC.f, prefetch_depth=depth) == \
            r_sched.required_capacity_bytes(ra, rs, SPEC.f, prefetch_depth=depth)
    assert p_sched.predicted_stream_stats(pa, ps, SPEC.f) == \
        r_sched.predicted_stream_stats(ra, rs, SPEC.f)


# ---------------------------------------------------------------------------
# streaming on CPU cells: in-core parity and kill/resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ref", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_streaming_als_on_mesh_matches_incore(problem, incore, case, mode):
    """tests/test_mesh_streaming.py:170, :199, :249: uniform, a ragged last
    wave (q = 3: its one batch padded with an empty one on the mesh) and
    the stacked-bin theta half, each within 1e-4 of in-core."""
    r, _, rte = problem
    state, hist = incore
    store, sched = _setup("port", r, case)
    if case == "ragged":
        assert len(sched.waves) == 2 and len(sched.waves[-1].batches) == 1
    fac, shist, tel = run_streaming_als(store, sched, _cfg(mode), mesh=_mesh(),
                                        train_eval=p_als.ell_triplet(r, "cpu"),
                                        test_eval=p_als.ell_triplet(rte, "cpu"))
    assert len(shist) == len(hist)
    for a, b in zip(shist, hist):
        assert abs(a["train_rmse"] - b["train_rmse"]) < TOL, (a, b)
        assert abs(a["test_rmse"] - b["test_rmse"]) < TOL, (a, b)
    np.testing.assert_allclose(fac.x[:r.m], state.x.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(fac.theta, state.theta.numpy(), atol=TOL, rtol=0)
    assert tel.peak_bytes <= tel.capacity_bytes
    assert tel.peak_bytes <= p_sched.required_capacity_bytes(store, sched, SPEC.f)
    assert tel.waves_run == 2 * len(sched.waves) * 3
    assert tel.topology == "topology[0,1]" and tel.reduce_fast_bytes > 0
    led = tel.ledger
    assert led["run"]["mesh"] is True and led["run"]["p"] == 2
    assert all(rec["ok"] for rec in led["records"])


@pytest.mark.parametrize("case,kills", [("uniform", (1, 3)), ("binned", (1, 3, 5))])
def test_streaming_als_mesh_kill_resume_bit_exact(problem, case, kills):
    """tests/test_mesh_streaming.py:221, :291: killed in the solve-X half
    and in the accumulate-Theta half, the run resumes to the uninterrupted
    run's factors exactly (the checkpoint carries the per-data-shard f64
    partials, so the topology reduce replays from the same summands)."""
    r, _, _ = problem
    store, sched = _setup("port", r, case)
    cfg = _cfg(iters=2)
    ref, _, _ = run_streaming_als(store, sched, cfg, mesh=_mesh())
    for kill in kills:
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(SimulatedFailure):
                run_streaming_als(store, sched, cfg, mesh=_mesh(), ckpt_dir=d,
                                  fail_after_waves=kill)
            fac, _, tel = run_streaming_als(store, sched, cfg, mesh=_mesh(), ckpt_dir=d)
        assert tel.resumed_from_step == kill
        assert _same(fac, ref), kill


@pytest.mark.parametrize("mode", ["ref", "kernel"])
@pytest.mark.parametrize("n_workers", [2, 3])
def test_streaming_sgd_on_mesh_matches_incore(problem, n_workers, mode):
    """tests/test_mesh_streaming.py:322: one tile a cell over the joint
    (data, model) axes of a 4 x 2 mesh, including a ragged split (3
    workers on a g = 4 grid), within 1e-4 of in-core."""
    r, _, rte = problem
    rtest = p_als.ell_triplet(rte, "cpu")
    grid = block_ell(r, g=4)
    cfg = SgdConfig(f=SPEC.f, lam=SPEC.lam, lr=0.1, mode=mode, seed=3, device="cpu",
                    schedule="inverse_time", decay=1.0, epochs=3)
    state, hist = sgd_train(grid, cfg, test=rtest)
    sched = build_sgd_schedule(grid, SPEC.f, n_workers=n_workers)
    fac, shist, tel = run_streaming_sgd(TileStore(grid), sched, cfg, test_eval=rtest,
                                        mesh=_mesh((4, 2)))
    np.testing.assert_allclose(fac.x, state.x.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(fac.theta, state.theta.numpy(), atol=TOL, rtol=0)
    assert abs(shist[-1]["test_rmse"] - hist[-1]["test_rmse"]) < TOL
    assert tel.peak_bytes <= tel.capacity_bytes
    assert tel.waves_run == sched.waves_per_epoch * cfg.epochs
    assert tel.ledger["run"]["mesh"] is True


def test_streaming_hybrid_on_mesh(problem, tmp_path):
    """Both phases of the streaming hybrid on the mesh: the same factors
    as on one device within 1e-4, and a restart skips the warm start."""
    r, _, rte = problem
    rtest = p_als.ell_triplet(rte, "cpu")
    grid = block_ell(r, g=4)
    scfg = SgdConfig(f=SPEC.f, lam=SPEC.lam, lr=0.1, seed=3, device="cpu",
                     schedule="inverse_time", decay=1.0, epochs=2)
    runs = {}
    for name, p, mesh in (("one", 1, None), ("mesh", 2, _mesh())):
        store = p_store.RatingStore(r, q=4, p=p)
        sched = p_sched.build_schedule(_plan(p_part, store, r, 4, 2 if mesh else 1, p),
                                       SPEC.m, SPEC.n, n_data=2 if mesh else 1)
        runs[name] = run_streaming_hybrid(
            store, sched, TileStore(grid), build_sgd_schedule(grid, SPEC.f, n_workers=2),
            _cfg(iters=2), scfg, test_eval=rtest, ckpt_dir=str(tmp_path / name), mesh=mesh)
    (fo, ho, _), (fm, hm, tm) = runs["one"], runs["mesh"]
    assert [h["phase"] for h in hm] == ["als"] * 2 + ["sgd"] * 2
    np.testing.assert_allclose(fm.x, fo.x, atol=TOL, rtol=0)
    np.testing.assert_allclose(fm.theta, fo.theta, atol=TOL, rtol=0)
    assert tm.phases["als"].ledger["run"]["mesh"] and tm.phases["sgd"].ledger["run"]["mesh"]
    store = p_store.RatingStore(r, q=4, p=2)
    sched = p_sched.build_schedule(_plan(p_part, store, r, 4, 2, 2), SPEC.m, SPEC.n, n_data=2)
    f2, h2, t2 = run_streaming_hybrid(
        store, sched, TileStore(grid), build_sgd_schedule(grid, SPEC.f, n_workers=2),
        _cfg(iters=2), scfg, test_eval=rtest, ckpt_dir=str(tmp_path / "mesh"), mesh=_mesh())
    assert h2 == [] and "als" not in t2.phases and _same(f2, fm)


# ---------------------------------------------------------------------------
# the ledger against the reference's mesh run on 8 forced host devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_mesh_runs(problem, tmp_path_factory):
    """The reference's ``run_streaming_als(mesh=)`` (uniform, ragged,
    binned) and ``run_streaming_sgd(mesh=)`` from its own initial factors,
    in a subprocess with 8 forced host devices; their init, factors and
    ledgers."""
    from test_distributed import run_script

    out = tmp_path_factory.mktemp("refmesh") / "ref"
    run_script(f"""
import json, numpy as np
from repro.core import als as als_mod
from repro.core.partition import plan_for, streaming_acc_bytes
from repro.outofcore import (FactorStore, RatingStore, TileStore, build_schedule,
                             build_sgd_schedule, run_streaming_als, run_streaming_sgd)
from repro.sgd import SgdConfig, block_ell, train as sgd_train_mod
from repro.sparse import synth
from repro.launch.mesh import make_mesh
SPEC = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
r, rt, rte, _ = synth.make_synthetic_ratings(SPEC, seed=0)
cfg = als_mod.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=2, mode="ref")
st = als_mod.als_init(r.m, rt.m, cfg)
res, ledgers = {{"x0": np.asarray(st.x), "t0": np.asarray(st.theta)}}, {{}}
mesh = make_mesh((2, 2), ("data", "model"))
for case, (q, n_data, p, n_bins) in {CASES!r}.items():
    store = RatingStore(r, q=q, p=p, n_bins=n_bins)
    fill = (dict(bin_fills=store.bin_fill_pairs()) if n_bins > 1
            else dict(fill=store.worst_fill))
    plan = plan_for(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=p, q=q, n_data=n_data, eps=0,
                    buffers=4, acc_bytes=streaming_acc_bytes(SPEC.n, SPEC.f),
                    hbm_bytes=1 << 22, **fill)
    sched = build_schedule(plan, SPEC.m, SPEC.n, n_data=n_data)
    x0 = np.zeros((store.m_pad, SPEC.f), np.float32)
    x0[:r.m] = np.asarray(st.x)
    fac, _, tel = run_streaming_als(store, sched, cfg, mesh=mesh,
                                    factors=FactorStore.from_arrays(x0, st.theta))
    res[case + "_x"], res[case + "_t"] = fac.x, fac.theta
    ledgers[case] = tel.ledger
grid = block_ell(r, g=4)
scfg = SgdConfig(f=SPEC.f, lam=SPEC.lam, lr=0.1, mode="ref", seed=3,
                 schedule="inverse_time", decay=1.0, epochs=2)
init = sgd_train_mod.sgd_init(grid, scfg)
res["sx0"], res["st0"] = np.asarray(init.x), np.asarray(init.theta)
fac, _, tel = run_streaming_sgd(TileStore(grid), build_sgd_schedule(grid, SPEC.f, n_workers=3),
                                scfg, mesh=make_mesh((4, 2), ("data", "model")),
                                factors=FactorStore.from_arrays(init.x, init.theta))
res["sgd_x"], res["sgd_t"] = fac.x, fac.theta
ledgers["sgd"] = tel.ledger
np.savez({str(out) + '.npz'!r}, **res)
open({str(out) + '.json'!r}, "w").write(json.dumps(ledgers))
print("OK")
""")
    return np.load(str(out) + ".npz"), json.loads(open(str(out) + ".json").read())


def _check_ledger(mine, ref, renamed):
    """Every record equal to the reference's (``smem/*`` for its
    ``vmem/*``), the metered peaks on their predicted side only."""
    recs = {r_["name"]: r_ for r_ in mine["records"]}
    refs = {r_["name"]: r_ for r_ in ref["records"]}
    assert set(recs) == {renamed.get(k, k) for k in refs} - {None}
    for name, rec in refs.items():
        if name not in renamed:
            assert (recs[name]["predicted"], recs[name]["check"]) == \
                (rec["predicted"], rec["check"]), name
            if name not in PEAK_RECORDS:
                assert recs[name]["measured"] == rec["measured"], name
        if renamed.get(name, name) is not None:
            assert recs[renamed.get(name, name)]["ok"], name
    assert set(mine["run"]) == set(ref["run"]) | {"device"}
    for k, v in ref["run"].items():
        if k not in ("phase_seconds", "mode"):       # the port runs its kernels
            assert mine["run"][k] == v, k
    assert mine["run"]["mode"] == "kernel"


@pytest.mark.mesh
@pytest.mark.parametrize("case", list(CASES))
def test_streaming_als_mesh_ledger_matches_reference(problem, ref_mesh_runs, case):
    r, _, _ = problem
    res, ledgers = ref_mesh_runs
    store, sched = _setup("port", r, case)
    x0 = np.zeros((store.m_pad, SPEC.f), np.float32)
    x0[:r.m] = res["x0"]
    fac, _, tel = run_streaming_als(store, sched, _cfg("kernel", iters=2), mesh=_mesh(),
                                    factors=p_store.FactorStore.from_arrays(x0, res["t0"]))
    np.testing.assert_allclose(fac.x, res[case + "_x"], atol=TOL, rtol=0)
    np.testing.assert_allclose(fac.theta, res[case + "_t"], atol=TOL, rtol=0)
    _check_ledger(tel.ledger, ledgers[case],
                  {"vmem/fused_herm_pallas": "smem/fused_herm",
                   "vmem/batch_solve_pallas": "smem/batch_solve"})


@pytest.mark.mesh
def test_streaming_sgd_mesh_ledger_matches_reference(problem, ref_mesh_runs, monkeypatch):
    from repro.sgd import train as r_train
    from repro_torch.outofcore import sgd_driver

    monkeypatch.setattr(sgd_driver, "epoch_set_order", lambda seed, ep, g: torch.from_numpy(
        np.array(r_train.epoch_set_order(seed, ep, g))))
    r, _, _ = problem
    res, ledgers = ref_mesh_runs
    grid = block_ell(r, g=4)
    cfg = SgdConfig(f=SPEC.f, lam=SPEC.lam, lr=0.1, mode="kernel", seed=3, device="cpu",
                    schedule="inverse_time", decay=1.0, epochs=2)
    fac, _, tel = run_streaming_sgd(
        TileStore(grid), build_sgd_schedule(grid, SPEC.f, n_workers=3), cfg,
        mesh=_mesh((4, 2)), factors=p_store.FactorStore.from_arrays(res["sx0"], res["st0"]))
    np.testing.assert_allclose(fac.x, res["sgd_x"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(fac.theta, res["sgd_t"], atol=1e-5, rtol=0)
    _check_ledger(tel.ledger, ledgers["sgd"], {"vmem/sgd_tile_pallas": None})
