"""Port checkpoint store/manager vs the reference's on-disk layout, and
SGD kill/resume, on the CPU.

A checkpoint either package writes must restore into the other bit for
bit; a killed SGD run resumed from its checkpoint must end bit-equal to a
straight run (``torch.equal``, stricter than the reference's 1e-6).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as ref_manager  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.sgd import train as ref_train  # noqa: E402
from repro.sparse import synth as ref_synth  # noqa: E402
from repro_torch import checkpoint as port_ckpt  # noqa: E402
from repro_torch.checkpoint import store as port_store  # noqa: E402
from repro_torch.core import als as port_als  # noqa: E402
from repro_torch.sgd import blocking as port_blocking  # noqa: E402
from repro_torch.sgd import hybrid as port_hybrid  # noqa: E402
from repro_torch.sgd import train as port_train  # noqa: E402

MINI = ref_synth.SynthSpec("netflix-mini", m=768, n=160, nnz=40_000, f=8, lam=0.05)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((7, 3)).astype(np.float32),
            "theta": rng.standard_normal((5, 3)).astype(np.float32),
            "opt": {"step": np.array(4, np.int32),
                    "m": rng.standard_normal(6).astype(np.float64)}}


def _as_torch(tree):
    return {k: _as_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _read(path):
    with open(path) as f:
        return f.read()


def test_same_tree_gives_the_same_files(tmp_path):
    tree = _tree(0)
    ref_store.save_checkpoint(str(tmp_path / "ref"), 3, tree)
    port_store.save_checkpoint(str(tmp_path / "port"), 3, _as_torch(tree))
    for name in ("LATEST", "step_00000003/meta.json"):
        assert _read(tmp_path / "ref" / name) == _read(tmp_path / "port" / name), name
    meta = json.loads(_read(tmp_path / "port" / "step_00000003" / "meta.json"))
    assert meta["names"] == ["opt/m", "opt/step", "theta", "x"]
    with np.load(tmp_path / "ref" / "step_00000003" / "shard_00000.npz") as a, \
            np.load(tmp_path / "port" / "step_00000003" / "shard_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_reference_checkpoint_restores_into_the_port_bit_equal(tmp_path):
    tree = _tree(1)
    ref_store.save_checkpoint(str(tmp_path), 9, {k: (jnp.asarray(v) if k != "opt" else v)
                                                 for k, v in tree.items()})
    like = _as_torch(_tree(2))
    assert port_store.latest_step(str(tmp_path)) == 9
    got = port_store.restore_checkpoint(str(tmp_path), like)
    for k in ("x", "theta"):
        assert isinstance(got[k], torch.Tensor) and torch.equal(got[k], torch.from_numpy(tree[k]))
    assert got["opt"]["m"].dtype == torch.float64
    assert torch.equal(got["opt"]["m"], torch.from_numpy(tree["opt"]["m"]))
    assert int(got["opt"]["step"]) == 4


def test_port_checkpoint_restores_into_the_reference_bit_equal(tmp_path):
    tree = _tree(3)
    port_store.save_checkpoint(str(tmp_path), 2, _as_torch(tree))
    got = ref_store.restore_checkpoint(str(tmp_path), _tree(4))
    for k in ("x", "theta"):
        assert got[k].dtype == tree[k].dtype and np.array_equal(got[k], tree[k])
    assert np.array_equal(got["opt"]["m"], tree["opt"]["m"])
    assert ref_store.latest_step(str(tmp_path)) == 2


def test_sequences_and_named_tuples_flatten_like_the_reference(tmp_path):
    port_tree = {"s": port_train.SgdState(x=torch.ones(2, 2), theta=torch.zeros(3, 2),
                                          epoch=np.int32(1)),
                 "l": [torch.ones(1), torch.zeros(2)]}
    ref_tree = {"s": ref_train.SgdState(x=jnp.ones((2, 2)), theta=jnp.zeros((3, 2)),
                                        epoch=jnp.int32(1)),
                "l": [np.ones(1, np.float32), np.zeros(2, np.float32)]}
    port_store.save_checkpoint(str(tmp_path / "p"), 1, port_tree)
    ref_store.save_checkpoint(str(tmp_path / "r"), 1, ref_tree)
    names = [json.loads(_read(tmp_path / d / "step_00000001" / "meta.json"))["names"]
             for d in ("p", "r")]
    assert names[0] == names[1]
    back = port_store.restore_checkpoint(str(tmp_path / "r"), port_tree)
    assert isinstance(back["s"], port_train.SgdState)
    assert torch.equal(back["s"].x, torch.ones(2, 2)) and torch.equal(back["l"][1], torch.zeros(2))


@pytest.mark.parametrize("async_write", [True, False])
def test_manager_keeps_the_last_steps_and_restores_latest(tmp_path, async_write):
    d = str(tmp_path / "ck")
    mgr = port_ckpt.CheckpointManager(d, keep=2, async_write=async_write)
    fresh, step = mgr.restore_or_init({"x": torch.zeros(3)}, lambda: "init")
    assert (fresh, step) == ("init", 0)
    live = torch.zeros(3)
    for s in range(1, 5):
        live += 1.0
        mgr.save(s, {"x": live})
        live.add_(100.0)            # mutating after save must not reach the commit
        live.sub_(100.0)
    mgr.wait()
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003", "step_00000004"]
    got, step = mgr.restore_or_init({"x": torch.zeros(3)}, lambda: None)
    assert step == 4 and torch.equal(got["x"], torch.full((3,), 4.0))
    # the reference's manager reads the port's directory
    got_ref, step_ref = ref_manager.CheckpointManager(d).restore_or_init(
        {"x": np.zeros(3, np.float32)}, lambda: None)
    assert step_ref == 4 and np.array_equal(got_ref["x"], np.full(3, 4.0, np.float32))


# ---------------------------------------------------------------------------
# SGD and hybrid kill/resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    r, rt, rte, _ = ref_synth.make_synthetic_ratings(MINI, seed=2, noise=0.1)
    return r, rt, rte, port_blocking.block_ell(r, 4)


@pytest.mark.parametrize("mode", ["kernel", "ref"])
def test_sgd_kill_and_resume_is_bit_equal(problem, tmp_path, mode):
    grid = problem[3]
    # decay pinned: the default (10/epochs) would give the 3- and 5-epoch
    # configs different schedules
    kw = dict(f=MINI.f, lam=MINI.lam, lr=0.1, schedule="inverse_time", decay=1.0,
              mode=mode, seed=4, device="cpu")
    straight, _ = port_train.sgd_train(grid, port_train.SgdConfig(epochs=5, **kw))
    ck = str(tmp_path / "sgd_ck")
    port_train.sgd_train(grid, port_train.SgdConfig(epochs=3, **kw), ckpt_dir=ck)
    resumed, hist = port_train.sgd_train(grid, port_train.SgdConfig(epochs=5, **kw), ckpt_dir=ck)
    assert [h["epoch"] for h in hist] == [4, 5] and resumed.epoch == 5
    assert torch.equal(resumed.x, straight.x)
    assert torch.equal(resumed.theta, straight.theta)


def test_hybrid_resume_skips_als_warm_start(problem, tmp_path):
    r, rt, _, grid = problem
    rr, rtt = port_als.ell_triplet(r, "cpu"), port_als.ell_triplet(rt, "cpu")
    warm = port_als.AlsConfig(f=MINI.f, lam=MINI.lam, iters=1, device="cpu")
    refine = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.1, epochs=2,
                                  schedule="inverse_time", decay=1.0, device="cpu")
    ck = str(tmp_path / "hyb_ck")
    final1, hist1 = port_hybrid.hybrid_train(rr, rtt, grid, warm, refine, ckpt_dir=ck)
    assert [h["phase"] for h in hist1] == ["als", "sgd", "sgd"]
    final2, hist2 = port_hybrid.hybrid_train(rr, rtt, grid, warm, refine, ckpt_dir=ck)
    assert hist2 == []
    assert torch.equal(final2.x, final1.x) and torch.equal(final2.theta, final1.theta)


def test_sgd_train_checkpoints_host_copies(problem, tmp_path, monkeypatch):
    """The tree handed to the async manager holds numpy copies, never
    arrays sharing memory with the live CPU factors."""
    grid = problem[3]
    captured = []

    class SpyManager(port_ckpt.CheckpointManager):
        def save(self, step, tree):
            captured.append((step, tree))
            super().save(step, tree)

    monkeypatch.setattr(port_ckpt, "CheckpointManager", SpyManager)
    cfg = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.1, epochs=2, seed=4, device="cpu")
    state, _ = port_train.sgd_train(grid, cfg, ckpt_dir=str(tmp_path / "ck"))
    assert len(captured) == 2
    live = {"x": state.x.numpy(), "theta": state.theta.numpy()}
    for _, tree in captured:
        for k in ("x", "theta"):
            assert isinstance(tree[k], np.ndarray)
            assert not np.shares_memory(tree[k], live[k])
    np.testing.assert_array_equal(captured[-1][1]["x"], live["x"])


def test_reference_sgd_checkpoint_resumes_in_the_port(problem, tmp_path):
    """An epoch-3 checkpoint the reference's manager wrote resumes in the
    port's ``sgd_train``, which starts at epoch 4 from exactly those factors."""
    grid = problem[3]
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 0.3, (grid.g * grid.mb, MINI.f)).astype(np.float32)
    th = rng.uniform(0, 0.3, (grid.g * grid.nb, MINI.f)).astype(np.float32)
    ck = str(tmp_path / "ck")
    mgr = ref_manager.CheckpointManager(ck, keep=2)
    mgr.save(3, {"x": x, "theta": th})
    mgr.wait()
    cfg = port_train.SgdConfig(f=MINI.f, lam=MINI.lam, lr=0.1, epochs=4, device="cpu")
    seen = []
    port_train.sgd_train(grid, cfg, ckpt_dir=ck,
                         callback=lambda s, rec: seen.append(rec["epoch"]))
    assert seen == [4]
    want = port_train.sgd_epoch(port_train.sgd_state_from_numpy(x, th, 3, "cpu"),
                                port_train.grid_triplet(grid, "cpu"), grid, cfg,
                                port_train.epoch_lr(cfg, 3),
                                set_order=port_train.epoch_set_order(cfg.seed, 3, grid.g))
    got = port_store.restore_checkpoint(ck, {"x": torch.zeros(1), "theta": torch.zeros(1)})
    assert torch.equal(got["x"], want.x) and torch.equal(got["theta"], want.theta)
