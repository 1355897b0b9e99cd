"""The port's streaming SGD driver and streaming hybrid against the
reference's, on the CPU.

The reference's ``run_streaming_sgd`` runs in mode ``"ref"``; the port's
runs in ``"ref"`` (the stacked plain sweep) and ``"kernel"`` (a slot plan
per same-K group of a wave and ``sgd_tile_planned_``, whose planned plain
mirror runs on the CPU), from the reference's injected ``sgd_init``
factors and set orders.  Tolerances are the reference's own: factors 1e-5
and test RMSE 1e-3 per epoch against in-core (tests/test_outofcore.py:290-292),
the binned hybrid 1e-5 from the uniform one (:573-577), and every exact
ledger record equal.  The reference's own streaming tests are ported as
they are (:279, :301, :323, :525, :543).  Problem: tests/test_outofcore.py's
SPEC, g = 4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import als as r_als  # noqa: E402
from repro.core.partition import plan_for as r_plan_for  # noqa: E402
from repro.obs.ledger import validate_ledger as r_validate  # noqa: E402
from repro.outofcore import RatingStore as RRatingStore  # noqa: E402
from repro.outofcore import TileStore as RTileStore  # noqa: E402
from repro.outofcore import build_schedule as r_build_schedule  # noqa: E402
from repro.outofcore import build_sgd_schedule as r_build_sgd_schedule  # noqa: E402
from repro.outofcore import run_streaming_sgd as r_run_sgd  # noqa: E402
from repro.sgd import SgdConfig as RSgdConfig  # noqa: E402
from repro.sgd import block_ell as r_block_ell  # noqa: E402
from repro.sgd import train as r_train  # noqa: E402
from repro.sgd.hybrid import run_streaming_hybrid as r_run_hybrid  # noqa: E402
from repro.sparse import synth  # noqa: E402
from repro_torch.core import als as p_als  # noqa: E402
from repro_torch.core.partition import plan_for  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.outofcore import (FactorStore, RatingStore,  # noqa: E402
                                   SimulatedFailure, TileStore, build_schedule,
                                   build_sgd_schedule)
from repro_torch.outofcore import sgd_driver  # noqa: E402
from repro_torch.sgd import SgdConfig, block_ell, run_streaming_hybrid, sgd_train  # noqa: E402

SPEC = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
ACC_EPS = SPEC.n * (SPEC.f * SPEC.f + 3 * SPEC.f + 1) * 4
FAC_TOL = 1e-5             # tests/test_outofcore.py:290-291
RMSE_TOL = 1e-3            # tests/test_outofcore.py:292
MODES = ("ref", "kernel")


@pytest.fixture(scope="module")
def problem():
    r, _, rte, _ = synth.make_synthetic_ratings(SPEC, seed=0)
    return r, rte


def _sgd_kw(**kw):
    kw.setdefault("schedule", "inverse_time")
    kw.setdefault("decay", 1.0)
    kw.setdefault("epochs", 2)
    return dict(f=SPEC.f, lam=SPEC.lam, lr=0.1, seed=3, **kw)


def _cfg(mode, **kw):
    return SgdConfig(mode=mode, device="cpu", **_sgd_kw(**kw))


def _tiles(r, n_workers=2, **kw):
    grid = block_ell(r, g=4, **kw)
    return grid, TileStore(grid), build_sgd_schedule(grid, SPEC.f, n_workers=n_workers)


def _triplet(ell):
    return p_als.ell_triplet(ell, "cpu")


@pytest.fixture
def ref_order(monkeypatch):
    """The port's drivers take the reference's per-epoch set order."""
    def order(seed, epoch, g):
        return torch.from_numpy(np.array(r_train.epoch_set_order(seed, epoch, g)))

    monkeypatch.setattr(sgd_driver, "epoch_set_order", order)


@pytest.fixture(scope="module")
def ref_runs(problem):
    """The reference's streaming SGD (mode "ref") and its sgd_init, per
    worker count (3 is ragged: waves of 3 and 1 tiles)."""
    r, rte = problem
    grid = r_block_ell(r, g=4)
    rc = RSgdConfig(mode="ref", **_sgd_kw())
    init = r_train.sgd_init(grid, rc)
    out = {}
    for nw in (2, 3, 4):
        out[nw] = r_run_sgd(RTileStore(grid), r_build_sgd_schedule(grid, SPEC.f, n_workers=nw),
                            rc, test_eval=r_als.ell_triplet(rte))
    return (np.asarray(init.x), np.asarray(init.theta)), out


def _records(tel):
    return {rec["name"]: rec for rec in tel.ledger["records"]}


#: ledger records whose measured side is the metered peak
PEAK_RECORDS = ("peak_device_bytes", "modeled_peak_bytes")


def _consumer_floor(grid):
    """The least the metered peak can be on a uniform grid: what the
    consumer alone holds during a wave — one worker's tile triplet and the
    fetched and updated factor blocks (``fac_in``, ``fac_out``)."""
    return grid.mb * grid.K * 8 + grid.mb * 4 + 2 * (grid.mb + grid.nb) * SPEC.f * 4


def _assert_peak(peak, tel, grid):
    """The metered peak depends on how far the prefetch worker, which
    registers its wave buffers on its own thread, ran ahead of the
    consumer, in both packages; it is held as the reference's tests hold
    it (tests/test_outofcore.py:156, :294), not compared across runs."""
    assert _consumer_floor(grid) <= peak <= tel.capacity_bytes, (peak, tel.capacity_bytes)


# ---------------------------------------------------------------------------
# the driver against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_workers", [2, 3, 4])
def test_streaming_sgd_matches_reference(problem, ref_runs, ref_order, n_workers, mode):
    r, rte = problem
    init, runs = ref_runs
    grid, tiles, sched = _tiles(r, n_workers)
    tr, reg = Tracer(), MetricsRegistry()
    fac, hist, tel = sgd_driver.run_streaming_sgd(
        tiles, sched, _cfg(mode), factors=FactorStore.from_arrays(*init),
        test_eval=_triplet(rte), tracer=tr, registry=reg)
    rfac, rhist, rtel = runs[n_workers]
    np.testing.assert_allclose(fac.x, rfac.x, atol=FAC_TOL)
    np.testing.assert_allclose(fac.theta, rfac.theta, atol=FAC_TOL)
    assert len(hist) == len(rhist) == 2
    for a, b in zip(hist, rhist):
        assert abs(a["test_rmse"] - b["test_rmse"]) < RMSE_TOL
        assert (a["epoch"], a["lr"], a["waves_run"]) == (b["epoch"], b["lr"], b["waves_run"])
        _assert_peak(a["peak_bytes"], tel, grid)
    # the ledger: the reference's validator accepts it, every record holds,
    # and every record but the reference's VMEM budget equals the reference's
    # (the metered peaks on their predicted side)
    assert r_validate(tel.ledger)["ok"] and all(x["ok"] for x in tel.ledger["records"])
    mine, ref = _records(tel), _records(rtel)
    assert set(mine) == set(ref) - {"vmem/sgd_tile_pallas"}
    for name, rec in mine.items():
        if name in PEAK_RECORDS:
            assert (rec["predicted"], rec["check"]) == \
                (ref[name]["predicted"], ref[name]["check"]), name
            _assert_peak(rec["measured"], tel, grid)
        else:
            assert (rec["predicted"], rec["measured"], rec["check"]) == \
                (ref[name]["predicted"], ref[name]["measured"], ref[name]["check"]), name
    assert mine["bytes_streamed"]["check"] == "exact"
    assert set(tel.ledger["run"]) == set(rtel.ledger["run"]) | {"device"}
    assert tel.ledger["run"]["device"] == "cpu" and tel.ledger["run"]["mode"] == mode
    for key in ("waves_run", "batches_loaded", "bytes_streamed", "padded_slots",
                "nnz_streamed", "capacity_bytes"):
        assert getattr(tel, key) == getattr(rtel, key), key
    _assert_peak(tel.peak_bytes, tel, grid)
    # the span contract: one solve span per wave consumed
    assert len(tr.spans(cat="solve")) == tel.waves_run == 2 * sched.waves_per_epoch
    assert {"driver", "epoch", "solve", "prefetch", "prefetch_load"} <= set(tel.phase_seconds)


@pytest.mark.parametrize("mode", MODES)
def test_streaming_sgd_matches_incore(problem, mode):
    """tests/test_outofcore.py:279: a waves >= 2 tile plan follows the
    in-core trajectory (the port's own ``sgd_train`` in the same mode) and
    the metered peak stays under the plan's capacity."""
    r, rte = problem
    grid, tiles, sched = _tiles(r, n_workers=2)
    assert all(len(ws) >= 2 for ws in sched.set_waves)
    test = _triplet(rte)
    cfg = _cfg(mode, epochs=3)
    state, hist = sgd_train(grid, cfg, test=test)
    fac, shist, tel = sgd_driver.run_streaming_sgd(tiles, sched, cfg, test_eval=test)
    assert len(shist) == len(hist) == 3
    for a, b in zip(shist, hist):
        assert abs(a["test_rmse"] - b["test_rmse"]) < RMSE_TOL
    np.testing.assert_allclose(fac.x, state.x.numpy(), atol=FAC_TOL)
    np.testing.assert_allclose(fac.theta, state.theta.numpy(), atol=FAC_TOL)
    assert tel.peak_bytes <= tel.capacity_bytes
    assert tel.peak_bytes < tiles.host_nbytes + fac.nbytes
    assert tel.waves_run == sched.waves_per_epoch * cfg.epochs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kill_after", [3, 11])
def test_streaming_sgd_kill_and_resume_bit_exact(problem, tmp_path, kill_after, mode):
    """tests/test_outofcore.py:301: killed after wave 3 (mid first epoch)
    or 11 (mid second epoch, across the set-order reshuffle), the resumed
    run reaches the uninterrupted run's factors bit for bit."""
    r, _ = problem
    _, tiles, sched = _tiles(r, n_workers=2)
    cfg = _cfg(mode)
    assert kill_after < cfg.epochs * sched.waves_per_epoch
    ref_fac, _, _ = sgd_driver.run_streaming_sgd(tiles, sched, cfg)
    ckpt = str(tmp_path / "sgd_ckpt")
    with pytest.raises(SimulatedFailure):
        sgd_driver.run_streaming_sgd(tiles, sched, cfg, ckpt_dir=ckpt,
                                     fail_after_waves=kill_after)
    fac, hist, tel = sgd_driver.run_streaming_sgd(tiles, sched, cfg, ckpt_dir=ckpt)
    assert tel.resumed_from_step == kill_after == tel.ledger["run"]["resumed_from_step"]
    assert len(hist) == cfg.epochs - kill_after // sched.waves_per_epoch
    assert torch.equal(torch.from_numpy(fac.x), torch.from_numpy(ref_fac.x))
    assert torch.equal(torch.from_numpy(fac.theta), torch.from_numpy(ref_fac.theta))
    # worst_fill_bound holds the grid's fill against the fill of the waves
    # this run streamed; after a resume that is part of an epoch, which can
    # pad more than the whole grid (the reference's record, as it is)
    assert all(rec["ok"] for rec in tel.ledger["records"]
               if rec["name"] != "worst_fill_bound")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("alpha_user", [0.0, 1.2])
def test_streaming_sgd_per_tile_k_equals_uniform(problem, alpha_user, mode):
    """tests/test_outofcore.py:525: per-tile-K tiles stream as same-K
    groups and land on bit-identical factors, storing no more slots.
    ``alpha_user=1.2`` skews the users so that tiles differ in K and a
    wave splits into groups (the SPEC's tiles all have K = 8)."""
    r = problem[0] if alpha_user == 0.0 else \
        synth.make_synthetic_ratings(SPEC, seed=0, alpha_user=alpha_user)[0]
    grid_u, tiles_u, sched_u = _tiles(r, n_workers=2)
    grid_b, tiles_b, sched_b = _tiles(r, n_workers=2, per_tile_k=True)
    assert grid_b.padded_slots <= grid_u.padded_slots
    if alpha_user:
        assert len(set(grid_b.tile_K.ravel().tolist())) > 1
    cfg = _cfg(mode)
    fac_u, _, _ = sgd_driver.run_streaming_sgd(tiles_u, sched_u, cfg)
    fac_b, _, tel_b = sgd_driver.run_streaming_sgd(tiles_b, sched_b, cfg)
    assert torch.equal(torch.from_numpy(fac_b.x), torch.from_numpy(fac_u.x))
    assert torch.equal(torch.from_numpy(fac_b.theta), torch.from_numpy(fac_u.theta))
    assert tel_b.peak_bytes <= tel_b.capacity_bytes
    assert tel_b.ledger["run"]["per_tile_k"] is True


def test_driver_rejects_what_does_not_fit(problem):
    r, _ = problem
    grid, tiles, sched = _tiles(r)
    with pytest.raises(ValueError, match="workers"):       # 2 workers, 1 cell
        sgd_driver.run_streaming_sgd(tiles, sched, _cfg("ref"),
                                     mesh=make_mesh((1, 1), ("data", "model"), ["cpu"]))
    with pytest.raises(ValueError, match="data axis"):
        sgd_driver.run_streaming_sgd(tiles, sched, _cfg("ref"),
                                     mesh=make_mesh((2,), ("model",), ["cpu"] * 2))
    with pytest.raises(ValueError, match="different grids"):
        sgd_driver.run_streaming_sgd(TileStore(block_ell(r, g=2)), sched, _cfg("ref"))
    with pytest.raises(ValueError, match="f="):
        sgd_driver.run_streaming_sgd(tiles, sched, SgdConfig(f=4, lam=0.05, device="cpu"))
    with pytest.raises(ValueError, match="do not fit"):
        sgd_driver.run_streaming_sgd(tiles, sched, _cfg("ref"), factors=FactorStore.from_arrays(
            np.zeros((3, SPEC.f), np.float32), np.zeros((3, SPEC.f), np.float32)))


# ---------------------------------------------------------------------------
# the streaming hybrid
# ---------------------------------------------------------------------------

def _als_sched(plan_fn, store, r, n_bins=1):
    kw = (dict(bin_fills=store.bin_fill_pairs()) if n_bins > 1
          else dict(fill=store.worst_fill))
    plan = plan_fn(SPEC.m, SPEC.n, r.nnz, SPEC.f, p=1, q=4, n_data=2, eps=ACC_EPS,
                   buffers=4, hbm_bytes=1 << 22, **kw)
    return (build_schedule if plan_fn is plan_for else r_build_schedule)(
        plan, SPEC.m, SPEC.n, n_data=2)


def _hybrid(r, rte, ckpt, n_bins=1, per_tile_k=False, mode="kernel"):
    store = RatingStore(r, q=4, n_bins=n_bins)
    _, tiles, sched = _tiles(r, n_workers=2, per_tile_k=per_tile_k)
    als_cfg = p_als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=2, mode=mode, device="cpu")
    return run_streaming_hybrid(store, _als_sched(plan_for, store, r, n_bins), tiles, sched,
                                als_cfg, _cfg(mode), test_eval=_triplet(rte), ckpt_dir=ckpt)


@pytest.mark.parametrize("mode", MODES)
def test_streaming_hybrid_runs_both_phases_streamed(problem, tmp_path, mode):
    """tests/test_outofcore.py:323: a streaming warm start and a streaming
    refine, one merged telemetry, and a restart with a committed SGD
    checkpoint skips the ALS phase and returns the same factors."""
    r, rte = problem
    ck = str(tmp_path / "hyb")
    fac, hist, tel = _hybrid(r, rte, ck, mode=mode)
    assert [h["phase"] for h in hist] == ["als"] * 2 + ["sgd"] * 2
    assert hist[2]["test_rmse"] < hist[0]["test_rmse"]   # the warm start pays off
    atel, stel = tel.phases["als"], tel.phases["sgd"]
    assert atel.peak_bytes <= atel.capacity_bytes
    assert stel.peak_bytes <= stel.capacity_bytes
    assert tel.waves_run == atel.waves_run + stel.waves_run
    assert tel.bytes_streamed == atel.bytes_streamed + stel.bytes_streamed
    assert tel.peak_bytes == max(atel.peak_bytes, stel.peak_bytes)
    assert tel.wall_seconds >= max(atel.wall_seconds, stel.wall_seconds)
    assert any(k.startswith("als/") for k in tel.phase_seconds)
    assert any(k.startswith("sgd/") for k in tel.phase_seconds)
    assert r_validate(tel.ledger)["ok"]
    fac2, hist2, tel2 = _hybrid(r, rte, ck, mode=mode)
    assert hist2 == [] and "als" not in tel2.phases
    assert torch.equal(torch.from_numpy(fac2.x), torch.from_numpy(fac.x))
    assert torch.equal(torch.from_numpy(fac2.theta), torch.from_numpy(fac.theta))


def test_streaming_hybrid_binned_matches_uniform(problem, tmp_path):
    """tests/test_outofcore.py:543: a binned warm start and a per-tile-K
    refine land within 1e-5 of the all-uniform hybrid."""
    r, rte = problem
    fac_u, hist_u, _ = _hybrid(r, rte, str(tmp_path / "u"))
    fac_b, hist_b, _ = _hybrid(r, rte, str(tmp_path / "b"), n_bins=4, per_tile_k=True)
    np.testing.assert_allclose(fac_b.x, fac_u.x, atol=1e-5)
    np.testing.assert_allclose(fac_b.theta, fac_u.theta, atol=1e-5)
    assert len(hist_b) == len(hist_u) == 4
    for a, b in zip(hist_b, hist_u):
        assert a["phase"] == b["phase"]
        assert abs(a["test_rmse"] - b["test_rmse"]) < 1e-5


@pytest.mark.parametrize("mode", MODES)
def test_streaming_hybrid_matches_reference(problem, ref_order, monkeypatch, tmp_path, mode):
    """The slice end to end: the port's streaming hybrid against the
    reference's, from the reference's ``als_init`` and set orders, within
    the streaming hybrid's tolerances (factors 1e-5, RMSE 1e-4:
    tests/test_outofcore.py:384-386)."""
    r, rte = problem
    rcfg = r_als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=2, mode="ref")
    init = r_als.als_init(SPEC.m, SPEC.n, rcfg)
    monkeypatch.setattr(p_als, "als_init", lambda m, n, cfg: p_als.state_from_numpy(
        np.asarray(init.x), np.asarray(init.theta), device=cfg.device))
    store = RRatingStore(r, q=4)
    grid = r_block_ell(r, g=4)
    rfac, rhist, rtel = r_run_hybrid(
        store, _als_sched(r_plan_for, store, r), RTileStore(grid),
        r_build_sgd_schedule(grid, SPEC.f, n_workers=2), rcfg,
        RSgdConfig(mode="ref", **_sgd_kw()), test_eval=r_als.ell_triplet(rte),
        ckpt_dir=str(tmp_path / "ref"))
    fac, hist, tel = _hybrid(r, rte, str(tmp_path / "port"), mode=mode)
    np.testing.assert_allclose(fac.x, rfac.x, atol=1e-5)
    np.testing.assert_allclose(fac.theta, rfac.theta, atol=1e-5)
    assert [h["phase"] for h in hist] == [h["phase"] for h in rhist]
    for a, b in zip(hist, rhist):
        assert abs(a["test_rmse"] - b["test_rmse"]) < 1e-4
    for key in ("waves_run", "batches_loaded", "bytes_streamed", "padded_slots",
                "nnz_streamed", "capacity_bytes"):
        assert getattr(tel, key) == getattr(rtel, key), key
    _assert_peak(tel.peak_bytes, tel, grid)
