"""Port SGD path (tile sweep, blocking, epochs, training, hybrid) vs the
reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``; on the CPU
the port's ``sgd_tile_cuda`` runs its plain PyTorch version.  The
reference draws its initial state and set orders from ``jax.random``,
which torch cannot reproduce, so the epoch parity tests inject the
reference's state, set orders and learning rates.  Tolerances are the
reference's own (tests/test_sgd.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sgd_update import sgd_block_update as ref_block_update  # noqa: E402
from repro.sgd import blocking as ref_blocking  # noqa: E402
from repro.sgd import train as ref_train  # noqa: E402
from repro.sparse import synth as ref_synth  # noqa: E402
from repro.training.optimizer import lr_schedule as ref_lr_schedule  # noqa: E402
from repro_torch.core import als as port_als  # noqa: E402
from repro_torch.kernels import ref as port_kref  # noqa: E402
from repro_torch.kernels import sgd_update as port_sgd  # noqa: E402
from repro_torch.obs import kernel_launches  # noqa: E402
from repro_torch.sgd import blocking as port_blocking  # noqa: E402
from repro_torch.sgd import hybrid as port_hybrid  # noqa: E402
from repro_torch.sgd import train as port_train  # noqa: E402
from repro_torch.sparse import padded as port_padded  # noqa: E402
from repro_torch.training.optimizer import lr_schedule as port_lr_schedule  # noqa: E402

MINI = ref_synth.SynthSpec("netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)


def _np(t):
    return t.detach().cpu().numpy()


def _tile(seed, mb, nb, f, K, collide=False):
    """tests/test_sgd.py's tile generator, as numpy; ``collide`` sends
    most rows of slot 1 to item 3 (a heavy in-slot collision)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((mb, f)) * 0.3).astype(np.float32)
    th = (rng.standard_normal((nb, f)) * 0.3).astype(np.float32)
    cnt = rng.integers(0, K + 1, mb).astype(np.int32)
    idx = rng.integers(0, nb, (mb, K)).astype(np.int32)
    val = rng.standard_normal((mb, K)).astype(np.float32)
    if collide:
        cnt = np.maximum(cnt, 2).astype(np.int32)
        idx[: mb * 3 // 4, 1] = 3
    return x, th, idx, val, cnt


# ---------------------------------------------------------------------------
# the tile sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mb,nb,f,K,collide", [
    (12, 10, 5, 9, False), (8, 8, 8, 8, False), (16, 24, 4, 17, False),
    (64, 12, 6, 10, True)])
def test_sgd_block_update_matches_reference(mb, nb, f, K, collide):
    x, th, idx, val, cnt = _tile(mb * 100 + K, mb, nb, f, K, collide)
    args = (jnp.asarray(x), jnp.asarray(th), jnp.asarray(idx), jnp.asarray(val),
            jnp.asarray(cnt), 0.05, 0.01)
    refs = [ref_block_update(*args, mode="ref"),
            ref_block_update(*args, mode="kernel_interpret",
                             row_mult=8, col_mult=8, f_mult=8)]
    for mode in ("kernel", "ref"):
        xp, tp = port_sgd.sgd_block_update(
            *(torch.from_numpy(a) for a in (x, th, idx, val, cnt)), 0.05, 0.01, mode=mode)
        for xr, tr in refs:
            np.testing.assert_allclose(_np(xp), np.asarray(xr), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(_np(tp), np.asarray(tr), atol=1e-5, rtol=1e-5)


def test_sgd_update_leaves_empty_rows_and_unhit_items_unchanged():
    x = torch.ones((4, 3))
    th = torch.ones((5, 3))
    idx = torch.zeros((4, 6), dtype=torch.int32)
    val = torch.zeros((4, 6))
    cnt = torch.zeros(4, dtype=torch.int32)
    for mode in ("kernel", "ref"):
        x2, t2 = port_sgd.sgd_block_update(x, th, idx, val, cnt, 0.1, 0.05, mode=mode)
        assert torch.equal(x2, x) and torch.equal(t2, th)
    # one live row: the other rows and the items it does not hit stay as they were
    cnt[1] = 2
    idx[1, :2] = torch.tensor([2, 4], dtype=torch.int32)
    val[1, :2] = 3.0
    x2, t2 = port_sgd.sgd_block_update(x, th, idx, val, cnt, 0.1, 0.05)
    assert torch.equal(x2[[0, 2, 3]], x[[0, 2, 3]]) and not torch.equal(x2[1], x[1])
    assert torch.equal(t2[[0, 1, 3]], th[[0, 1, 3]]) and not torch.equal(t2[2], th[2])


def _plan_entries(plan):
    """(slot, item, row) of every planned entry, walked through the units."""
    out = []
    slots = plan.slots.tolist()
    uo = plan.unit_offs.tolist()
    for s, k in enumerate(slots):
        for item, start, ln, _ in plan.units[uo[s]:uo[s + 1]].tolist():
            out += [(k, item, r) for r in plan.rows[start:start + ln].tolist()]
    return out


def _check_plan(plan, idx, cnt, row_ids, p):
    """Every live (row, slot) once, no dead slot, rows ascending within a
    group, parts of at most p rows summed by their group in part order."""
    live = {(k, int(idx[u, k]), int(row_ids[u])) for u in range(idx.shape[0])
            for k in range(int(cnt[u]))}
    got = _plan_entries(plan)
    assert len(got) == len(live) == plan.rows.numel() and set(got) == live
    assert plan.slots.tolist() == sorted({k for k, _, _ in live})
    assert plan.units[:, 2].min() >= 1 and plan.units[:, 2].max() <= p
    # the plan's entry order is (slot, item, row): ascending rows in a group
    ordered = [None] * len(got)
    for item, start, ln, _ in plan.units.tolist():
        for i in range(ln):
            ordered[start + i] = item
    keys = [(k, it, r) for (k, _, r), it in zip(sorted(got), ordered)]
    assert keys == sorted(got)
    so, uo = plan.split_offs.tolist(), plan.unit_offs.tolist()
    for s in range(plan.n_slots):
        units = plan.units[uo[s]:uo[s + 1]].tolist()
        assert [u[2] for u in units] == sorted((u[2] for u in units), reverse=True)
        parts = {}
        for item, start, ln, scr in units:
            if scr >= 0:
                parts.setdefault(item, []).append((start, ln, scr))
        splits = plan.splits[so[s]:so[s + 1]].tolist()
        assert sorted(parts) == sorted(g[0] for g in splits)
        for item, first, n_parts, h in splits:
            ps = sorted(parts[item])
            assert [scr for _, _, scr in ps] == list(range(first, first + n_parts))
            assert sum(ln for _, ln, _ in ps) == h > p and first + n_parts <= plan.n_scratch
            assert all(ps[i][0] + ps[i][1] == ps[i + 1][0] for i in range(len(ps) - 1))


@pytest.mark.parametrize("p", [1, 3, 64])
@pytest.mark.parametrize("collide", [False, True])
def test_build_plan_lists_each_live_entry_once(p, collide):
    x, th, idx, val, cnt = _tile(11 + p, 64, 12, 4, 10, collide)
    cnt[:5] = 0
    cnt = np.minimum(cnt, 8).astype(np.int32)           # slots 8, 9 dead
    plan = port_sgd.build_plan(*(torch.from_numpy(a) for a in (idx, val, cnt)), p=p)
    _check_plan(plan, idx, cnt, np.arange(64), p)
    assert plan.n_slots <= 8 and plan.rows.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(plan.vals), [val[r, k] for k, _, r in sorted(_plan_entries(plan))])
    if collide and p < 48:
        assert plan.splits.shape[0] > 0
    assert plan.nbytes == sum(t.numel() * 4 for t in plan[:7])


def _plan_int64(idx, val, cnt, p):
    """The slot plan as ``build_plan`` computed it before its entry arrays
    went to int32: int64 (row, slot) pairs from a mask, a stable sort on
    slot * n_items + item, groups from two comparisons.  The oracle the
    leaner build must equal array for array."""
    R, K = idx.shape
    live = torch.arange(K)[None, :] < cnt[:, None].long()
    r_, k_ = live.nonzero(as_tuple=True)
    items = idx[r_, k_].long()
    n_items = int(items.max()) + 1 if items.numel() else 1
    order = torch.sort(k_ * n_items + items, stable=True).indices
    ks, items = k_[order], items[order]
    rows, vals, L = r_[order].int(), val[r_, k_][order].float(), int(ks.numel())
    new = torch.ones(L, dtype=torch.bool)
    new[1:] = (ks[1:] != ks[:-1]) | (items[1:] != items[:-1])
    g_start = new.nonzero().squeeze(1)
    g_len = torch.diff(g_start, append=torch.tensor([L]))
    g_item, g_k = items[g_start], ks[g_start]
    slots, per_slot = torch.unique_consecutive(g_k, return_counts=True)
    S = int(slots.numel())
    g_slot = torch.repeat_interleave(torch.arange(S), per_slot)
    parts = (g_len + p - 1) // p
    split = parts > 1
    sp = torch.where(split, parts, 0)
    ex = torch.cumsum(sp, 0) - sp
    base = ex - ex[(torch.cumsum(per_slot, 0) - per_slot)][g_slot]
    n_scratch = int(torch.zeros(S, dtype=torch.long).index_add_(0, g_slot, sp).max()) if S else 0
    u_g = torch.repeat_interleave(torch.arange(g_start.numel()), parts)
    u_part = torch.arange(u_g.numel()) - (torch.cumsum(parts, 0) - parts)[u_g]
    u_len = torch.clamp(g_len[u_g] - u_part * p, max=p)
    units = torch.stack([g_item[u_g], g_start[u_g] + u_part * p, u_len,
                         torch.where(split[u_g], base[u_g] + u_part, -1)], 1)
    u_order = torch.sort(g_slot[u_g] * (p + 1) + (p - u_len), stable=True).indices
    zero = torch.zeros(1, dtype=torch.long)
    unit_offs = torch.cat([zero, torch.cumsum(
        torch.zeros(S, dtype=torch.long).index_add_(0, g_slot, parts), 0)])
    sg = split.nonzero().squeeze(1)
    splits = torch.stack([g_item[sg], base[sg], parts[sg], g_len[sg]], 1)
    split_offs = torch.cat([zero, torch.cumsum(torch.zeros(S, dtype=torch.long).index_add_(
        0, g_slot[sg], torch.ones_like(sg)), 0)])
    return (rows, vals, units[u_order].int(), unit_offs.int(), splits.int(),
            split_offs.int(), slots.int(), n_scratch)


@pytest.mark.parametrize("seed", range(6))
def test_build_plan_equals_its_int64_form(seed):
    """The plan's int32 build gives the int64 build's arrays bit for bit:
    ragged rows, empty rows, rows whose cnt lies outside 0..K, heavy
    collisions split at every p."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(20):
        R, K = int(torch.randint(0, 300, (1,), generator=g)), int(torch.randint(1, 48, (1,), generator=g))
        n_items = int(torch.randint(1, 60, (1,), generator=g))
        idx = torch.randint(0, n_items, (R, K), generator=g, dtype=torch.int32)
        val = torch.rand(R, K, generator=g)
        cnt = torch.randint(-2, K + 3, (R,), generator=g, dtype=torch.int32)
        for p in (1, 3, port_sgd.P_SPLIT):
            plan = port_sgd.build_plan(idx, val, cnt, p=p)
            for got, want in zip(plan, _plan_int64(idx, val, cnt, p)):
                if isinstance(want, torch.Tensor):
                    assert got.dtype == want.dtype and torch.equal(got, want)
                else:
                    assert got == want


@pytest.mark.parametrize("layout", ["uniform", "per_tile_k_sorted"])
def test_set_plans_use_global_ids(problem, layout):
    kw = {} if layout == "uniform" else dict(per_tile_k=True, degree_sort=True)
    grid = port_blocking.block_ell(problem[0], 4, **kw)
    gt = port_train.grid_triplet(grid, "cpu")
    plans = port_train.build_set_plans(gt, grid, p=5)
    g, mb, nb = grid.g, grid.mb, grid.nb
    assert len(plans) == g and sum(p.rows.numel() for p in plans) == grid.nnz
    for s, plan in enumerate(plans):
        j = [(i + s) % g for i in range(g)]
        idx = np.concatenate([grid.idx[i, j[i]] + j[i] * nb for i in range(g)])
        cnt = np.concatenate([grid.cnt[i, j[i]] for i in range(g)])
        _check_plan(plan, idx, cnt, np.arange(g * mb), 5)
        assert 0 <= int(plan.rows.min()) and int(plan.rows.max()) < g * mb
        assert 0 <= int(plan.units[:, 0].min()) and int(plan.units[:, 0].max()) < g * nb


@pytest.mark.parametrize("mb,nb,f,K,collide,p", [
    (12, 10, 5, 9, False, 2), (16, 24, 4, 17, False, 64), (64, 12, 6, 10, True, 4),
    (64, 12, 6, 10, True, 7), (64, 12, 8, 10, True, 64)])
def test_sgd_tile_planned_plain_matches_reference(mb, nb, f, K, collide, p):
    x, th, idx, val, cnt = _tile(mb * 100 + K + p, mb, nb, f, K, collide)
    args = (jnp.asarray(x), jnp.asarray(th), jnp.asarray(idx), jnp.asarray(val),
            jnp.asarray(cnt), 0.05, 0.01)
    refs = [ref_block_update(*args, mode="ref"),
            ref_block_update(*args, mode="kernel_interpret",
                             row_mult=8, col_mult=8, f_mult=8)]
    tx, tth, tidx, tval, tcnt = (torch.from_numpy(a) for a in (x, th, idx, val, cnt))
    plan = port_sgd.build_plan(tidx, tval, tcnt, p=p)
    if collide and p < 48:
        assert plan.splits.shape[0] > 0                     # a group was split
    xp, tp = port_kref.sgd_tile_planned_plain(tx, tth, plan, 0.05, 0.01)
    xi, ti = tx.clone(), tth.clone()
    port_sgd.sgd_tile_planned_(xi, ti, plan, 0.05, 0.01)   # CPU: the mirror, in place
    assert torch.equal(xi, xp) and torch.equal(ti, tp)
    for xr, tr in refs:
        np.testing.assert_allclose(_np(xp), np.asarray(xr), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(tp), np.asarray(tr), atol=1e-5, rtol=1e-5)


def test_sgd_tile_planned_rejects_bad_inputs():
    x, th, idx, val, cnt = (torch.from_numpy(a) for a in _tile(2, 8, 6, 4, 5))
    plan = port_sgd.build_plan(idx, val, cnt)
    with pytest.raises(ValueError, match="contiguous"):
        port_sgd.sgd_tile_planned_(torch.zeros(4, 8).t(), th, plan, 0.1, 0.05)
    with pytest.raises(ValueError, match="outside"):
        port_sgd.sgd_tile_planned_(torch.zeros(8, 129), torch.zeros(6, 129), plan, 0.1, 0.05)
    with pytest.raises(ValueError, match="at least 1"):
        port_sgd.build_plan(idx, val, cnt, p=0)


def test_sgd_tile_is_pure_and_rejects_bad_inputs():
    x, th, idx, val, cnt = (torch.from_numpy(a) for a in _tile(1, 8, 6, 4, 5))
    before = [t.clone() for t in (x, th)]
    launches = kernel_launches()["sgd_tile"]
    port_sgd.sgd_tile_cuda(x, th, idx, val, cnt, 0.1, 0.05)
    assert torch.equal(x, before[0]) and torch.equal(th, before[1])
    assert kernel_launches()["sgd_tile"] == launches      # CPU: plain version
    with pytest.raises(ValueError, match="int32"):
        port_sgd.sgd_tile_cuda(x, th, idx.long(), val, cnt, 0.1, 0.05)
    with pytest.raises(ValueError, match="outside"):
        port_sgd.sgd_tile_cuda(torch.zeros(8, 129), torch.zeros(6, 129), idx, val, cnt, 0.1, 0.05)
    with pytest.raises(ValueError, match="unknown mode"):
        port_sgd.sgd_block_update(x, th, idx, val, cnt, 0.1, 0.05, mode="kernel_interpret")


# ---------------------------------------------------------------------------
# blocking: bit-equal to the reference
# ---------------------------------------------------------------------------

def _random_coo(rng, m, n, nnz):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    _, uniq = np.unique(rows * n + cols, return_index=True)
    return rows[uniq], cols[uniq], rng.standard_normal(len(uniq)).astype(np.float32)


def _skewed_coo(rng, m, n, nnz, alpha=1.2):
    p = np.arange(1, m + 1, dtype=np.float64) ** -alpha
    rows = rng.choice(m, size=nnz, p=p / p.sum())
    cols = rng.integers(0, n, nnz)
    _, uniq = np.unique(rows * n + cols, return_index=True)
    return rows[uniq], cols[uniq], rng.standard_normal(len(uniq)).astype(np.float32)


def _assert_grids_equal(a, b):
    for name in ("idx", "val", "cnt"):
        got, want = getattr(a, name), getattr(b, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("tile_K", "user_perm"):
        got, want = getattr(a, name), getattr(b, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert (a.g, a.m, a.n, a.mb, a.nb, a.K) == (b.g, b.m, b.n, b.mb, b.nb, b.K)
    assert a.padded_slots == b.padded_slots and a.fill == b.fill


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("per_tile_k,degree_sort", [(False, False), (True, False),
                                                    (False, True), (True, True)])
def test_block_coo_and_block_ell_bit_equal_reference(skewed, per_tile_k, degree_sort):
    rng = np.random.default_rng(17 + skewed)
    m, n = 96, 48
    rows, cols, vals = (_skewed_coo if skewed else _random_coo)(rng, m, n, 1500)
    kw = dict(per_tile_k=per_tile_k, degree_sort=degree_sort)
    _assert_grids_equal(port_blocking.block_coo(rows, cols, vals, m, n, 4, **kw),
                        ref_blocking.block_coo(rows, cols, vals, m, n, 4, **kw))
    ptr, cc, vv = port_padded.csr_from_coo(rows, cols, vals, m)
    ell = port_padded.pad_csr_fast(ptr, cc, vv, n)
    _assert_grids_equal(port_blocking.block_ell(ell, 3, **kw),
                        ref_blocking.block_ell(ell, 3, **kw))


@pytest.mark.parametrize("g,seed", [(1, 0), (2, 1), (3, 2), (4, 3)])
def test_block_grid_to_coo_round_trips(g, seed):
    rng = np.random.default_rng(seed)
    m, n = 40, 24
    rows, cols, vals = _skewed_coo(rng, m, n, 300)
    for kw in ({}, {"per_tile_k": True, "degree_sort": True}):
        grid = port_blocking.block_coo(rows, cols, vals, m, n, g, **kw)
        assert grid.nnz == len(rows)
        r2, c2, v2 = grid.to_coo()
        assert sorted(zip(rows.tolist(), cols.tolist(), vals.tolist())) == \
            sorted(zip(r2.tolist(), c2.tolist(), v2.tolist()))
        if grid.user_perm is not None:
            np.testing.assert_array_equal(grid.user_inv[grid.user_perm], np.arange(m))


@pytest.mark.parametrize("g", [1, 2, 3, 5])
def test_diagonal_sets_conflict_free_and_equal_reference(g):
    sets = port_blocking.diagonal_sets(g)
    assert sets == ref_blocking.diagonal_sets(g)
    seen = set()
    for s in sets:
        assert len({i for i, _ in s}) == g and len({j for _, j in s}) == g
        seen.update(s)
    assert len(seen) == g * g
    assert [port_blocking.tile_k_ladder(k) for k in range(1, 70)] == \
        [ref_blocking.tile_k_ladder(k) for k in range(1, 70)]


@pytest.mark.parametrize("skewed", [False, True])
def test_per_tile_k_auto_equals_reference(skewed):
    """``per_tile_k="auto"`` builds the reference's auto grid bit for bit
    and records the same decision (its cache key apart from the backend)."""
    rng = np.random.default_rng(0)
    rows, cols, vals = (_skewed_coo if skewed else _random_coo)(rng, 96, 48, 1500)
    got = port_blocking.block_coo(rows, cols, vals, 96, 48, 4, per_tile_k="auto")
    want = ref_blocking.block_coo(rows, cols, vals, 96, 48, 4, per_tile_k="auto")
    _assert_grids_equal(got, want)
    assert got.tune["key"].rsplit("|", 1)[0] == want.tune["key"].rsplit("|", 1)[0]
    assert {k: v for k, v in got.tune.items() if k != "key"} == \
        {k: v for k, v in want.tune.items() if k != "key"}


# ---------------------------------------------------------------------------
# lr schedule and set order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "inverse_time", "cosine"])
def test_lr_schedule_and_epoch_lr_equal_reference(name):
    """float32 like the reference: constant and inverse_time are bit-equal;
    cosine may differ where ``cos`` rounds one ulp apart, so it is held at
    one ulp of cos scaled by the amplitude, (base_lr - min_lr) * 2^-23."""
    for kw in (dict(base_lr=0.15, total_steps=40, min_lr=0.001),
               dict(base_lr=0.08, total_steps=3), dict(base_lr=0.1, total_steps=5, decay=1.0)):
        want = np.array([np.float32(ref_lr_schedule(name, s, **kw)) for s in range(45)])
        got = np.array([port_lr_schedule(name, s, **kw).item() for s in range(45)], np.float32)
        if name == "cosine":
            amp = kw["base_lr"] - kw.get("min_lr", 0.0)
            np.testing.assert_allclose(got, want, rtol=0, atol=amp * 2.0 ** -23)
        else:
            np.testing.assert_array_equal(got, want)
    cfg_kw = dict(f=4, lam=0.05, lr=0.15, epochs=40, schedule=name, min_lr=0.001)
    pc = port_train.SgdConfig(device="cpu", **cfg_kw)
    rc = ref_train.SgdConfig(**cfg_kw)
    for ep in (0, 7, 39):
        np.testing.assert_allclose(port_train.epoch_lr(pc, ep), ref_train.epoch_lr(rc, ep),
                                   rtol=0, atol=0.15 * 2.0 ** -23)


def test_epoch_set_order_is_reproducible_permutation():
    g = 6
    orders = [port_train.epoch_set_order(0, ep, g) for ep in range(8)]
    for o in orders:
        assert sorted(o.tolist()) == list(range(g))
    assert torch.equal(orders[3], port_train.epoch_set_order(0, 3, g))
    assert any(not torch.equal(orders[0], o) for o in orders[1:])
    assert any(not torch.equal(port_train.epoch_set_order(s, 0, g), orders[0])
               for s in range(1, 5))


# ---------------------------------------------------------------------------
# epochs on netflix-mini, from the reference's injected state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    r, rt, rte, _ = ref_synth.make_synthetic_ratings(MINI, seed=2, noise=0.1)
    return r, rt, rte


@pytest.fixture(scope="module")
def als_rmse(problem):
    """The port's own ALS test RMSE after 8 iterations (the reference's
    baseline for its SGD/hybrid criteria)."""
    r, rt, rte = problem
    cfg = port_als.AlsConfig(f=MINI.f, lam=MINI.lam, iters=8, device="cpu")
    _, hist = port_als.als_train(*(port_als.ell_triplet(e, "cpu") for e in (r, rt)),
                                 r.m, rt.m, cfg, test=port_als.ell_triplet(rte, "cpu"))
    return hist[-1]["test_rmse"]


@pytest.mark.parametrize("p", [None, 3])
@pytest.mark.parametrize("layout", ["uniform", "per_tile_k_sorted"])
def test_two_epochs_match_reference(problem, layout, p):
    """``p``: the planned kernel path's unit size (None: the module's
    default; 3 splits most collision groups)."""
    r = problem[0]
    kw = {} if layout == "uniform" else dict(per_tile_k=True, degree_sort=True)
    grid_r = ref_blocking.block_ell(r, 4, **kw)
    grid_p = port_blocking.block_ell(r, 4, **kw)
    if kw:
        assert int(grid_p.tile_K.min()) < grid_p.K        # grouped per-K sweep
    rc = ref_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.1, epochs=2, mode="ref", seed=3)
    s = ref_train.sgd_init(grid_r, rc)
    state = port_train.sgd_state_from_numpy(np.asarray(s.x), np.asarray(s.theta), 0, "cpu")
    gt_r, gt_p = ref_train.grid_triplet(grid_r), port_train.grid_triplet(grid_p, "cpu")
    for mode in ("kernel", "ref"):
        pc = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.1, epochs=2, mode=mode,
                                  device="cpu")
        plan = None if p is None else port_train.build_set_plans(gt_p, grid_p, p=p)
        if plan is not None:
            assert sum(pl.splits.shape[0] for pl in plan) > 0
        s_ref, s_port = s, state
        for ep in range(2):
            order = ref_train.epoch_set_order(rc.seed, ep, grid_r.g)
            lr = ref_train.epoch_lr(rc, ep)
            s_ref = ref_train.sgd_epoch(s_ref, gt_r, grid_r, rc, lr, set_order=order)
            s_port = port_train.sgd_epoch(s_port, gt_p, grid_p, pc, lr,
                                          set_order=np.asarray(order), plan=plan)
        assert s_port.epoch == 2
        np.testing.assert_allclose(_np(s_port.x), np.asarray(s_ref.x), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(s_port.theta), np.asarray(s_ref.theta),
                                   atol=1e-5, rtol=1e-5)
        xr, tr = ref_train.factors_np(s_ref, grid_r)
        xp, tp = port_train.factors_np(s_port, grid_p)
        np.testing.assert_allclose(xp, xr, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tp, tr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["kernel", "ref"])
def test_sgd_epoch_leaves_the_callers_state_unchanged(problem, mode):
    grid = port_blocking.block_ell(problem[0], 4)
    cfg = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, mode=mode, device="cpu")
    state = port_train.sgd_init(grid, cfg)
    before = (state.x.clone(), state.theta.clone())
    out = port_train.sgd_epoch(state, port_train.grid_triplet(grid, "cpu"), grid, cfg, 0.1)
    assert torch.equal(state.x, before[0]) and torch.equal(state.theta, before[1])
    assert not torch.equal(out.x, before[0]) and not torch.equal(out.theta, before[1])


def test_sgd_epoch_rejects_overpadded_factors(problem):
    grid = port_blocking.block_ell(problem[0], 4)
    cfg = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, device="cpu")
    state = port_train.sgd_init(grid, cfg)
    bad = port_train.SgdState(x=state.x, epoch=0, theta=port_train.pad_factor(
        state.theta, grid.g * grid.nb + grid.g))
    with pytest.raises(ValueError, match="do not fit the grid"):
        port_train.sgd_epoch(bad, port_train.grid_triplet(grid, "cpu"), grid, cfg, 0.1)
    with pytest.raises(ValueError, match="cannot pad"):
        port_train.pad_factor(state.theta, 3)


def test_sgd_init_is_seeded_and_scaled(problem):
    grid = port_blocking.block_ell(problem[0], 4)
    cfg = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, seed=5, device="cpu")
    a, b = port_train.sgd_init(grid, cfg), port_train.sgd_init(grid, cfg)
    assert torch.equal(a.x, b.x) and torch.equal(a.theta, b.theta) and a.epoch == 0
    assert a.x.shape == (grid.g * grid.mb, MINI.f) and a.theta.shape == (grid.g * grid.nb, MINI.f)
    assert 0.0 <= float(a.x.min()) and float(a.x.max()) < cfg.init_scale


# ---------------------------------------------------------------------------
# training: the reference's criteria (within 2% of ALS)
# ---------------------------------------------------------------------------

def test_sgd_within_2pct_of_als(problem, als_rmse):
    r, _, rte = problem
    grid = port_blocking.block_ell(r, 4)
    cfg = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.15, epochs=40,
                               schedule="cosine", seed=1, device="cpu")
    assert cfg.mode == "ref"
    _, hist = port_train.sgd_train(grid, cfg, test=port_als.ell_triplet(rte, "cpu"))
    assert hist[-1]["test_rmse"] <= als_rmse * 1.02, (hist[-1]["test_rmse"], als_rmse)
    assert hist[-1]["lr"] < hist[0]["lr"] * 0.1


def test_hybrid_within_2pct_of_als(problem, als_rmse):
    r, rt, rte = problem
    grid = port_blocking.block_ell(r, 4)
    warm = port_als.AlsConfig(f=MINI.f, lam=MINI.lam, iters=2, device="cpu")
    refine = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.12, epochs=16,
                                  schedule="cosine", seed=1, mode="kernel", device="cpu")
    _, hist = port_hybrid.hybrid_train(
        port_als.ell_triplet(r, "cpu"), port_als.ell_triplet(rt, "cpu"), grid, warm, refine,
        test=port_als.ell_triplet(rte, "cpu"))
    assert [h["phase"] for h in hist] == ["als"] * 2 + ["sgd"] * 16
    assert hist[-1]["test_rmse"] <= als_rmse * 1.02, (hist[-1]["test_rmse"], als_rmse)
    assert hist[2]["test_rmse"] < hist[0]["test_rmse"]


def test_sgd_state_from_als_permutes_and_pads(problem):
    r = problem[0]
    grid = port_blocking.block_ell(r, 4, per_tile_k=True, degree_sort=True)
    x = torch.arange(r.m * 2, dtype=torch.float32).reshape(r.m, 2)
    th = torch.ones(r.n_cols, 2)
    st = port_hybrid.sgd_state_from_als(port_als.AlsState(x, th, 3), grid)
    assert st.x.shape == (grid.g * grid.mb, 2) and st.theta.shape == (grid.g * grid.nb, 2)
    assert st.epoch == 0
    xe, te = port_train.eval_factors(st, grid)
    assert torch.equal(xe, x) and torch.equal(te, th)
