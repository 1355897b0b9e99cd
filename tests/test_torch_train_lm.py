"""The port's LM training path on the CPU: the token data
(``repro_torch.data.tokens``), the train state and step
(``repro_torch.models.lm``), ``examples_torch/train_lm.py`` and the
``lm_substrate`` bench, against the reference where it has the same
function.

Tolerances: the token streams bit-equal; one train step from the
reference's injected ``TrainState`` (both forwards patched to float32
compute: the reference's ``lm_loss`` does not pass ``compute_dtype`` on)
with the loss at 1e-4 (``tests/test_torch_lm.py``'s ``FWD_TOL``), the grad
norm at rel 1e-4, and the params at atol 2.5e-3, rtol 1e-3
(``tests/test_training.py:113-117``: a step from small moments is
sign-like, so a reassociated gradient may move a parameter by up to
2 lr); microbatch 1 against 2 at the same bounds (:113-117); the tiny LM's
loss falls by 0.1 (:165-179); every arch's smoke step finite with its
params changed (``tests/test_models_smoke.py:39-54``).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.data import tokens as ref_tokens  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import TokenDataset, synthetic_lm_batches  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from test_torch_lm import _ref_params  # noqa: E402
from test_torch_training import f32_forward  # noqa: E402,F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-4                  # tests/test_torch_lm.py
NORM_REL = 1e-4
P_ATOL, P_RTOL = 2.5e-3, 1e-3   # tests/test_training.py:113-117


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this file's smoke-size tensors: as fast alone,
    and the suite's workers share the machine's cores (spinning thread
    pools slow every worker down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(rel):
    spec = importlib.util.spec_from_file_location("ex_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# token data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,order", [(0, 2), (7, 3)])
def test_synthetic_batches_bit_equal_to_reference(seed, order):
    ours = synthetic_lm_batches(97, 24, 3, seed=seed, order=order)
    ref = ref_tokens.synthetic_lm_batches(97, 24, 3, seed=seed, order=order)
    for _ in range(5):
        a, b = next(ours), next(ref)
        assert set(a) == set(b) == {"tokens", "labels", "mask"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_token_dataset_bit_equal_to_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 60000, 1000).astype(dtype).tofile(path)
    ours = TokenDataset(str(path), seq_len=16, vocab=5000, dtype=dtype)
    ref = ref_tokens.TokenDataset(str(path), seq_len=16, vocab=5000, dtype=dtype)
    assert len(ours) == len(ref) == 62
    for host_id, n_hosts in ((0, 1), (0, 2), (1, 2)):
        a = list(ours.batches(4, seed=3, host_id=host_id, n_hosts=n_hosts))
        b = list(ref.batches(4, seed=3, host_id=host_id, n_hosts=n_hosts))
        assert len(a) == len(b) == 62 // n_hosts // 4
        for x, y in zip(a, b):
            for k in ("tokens", "labels", "mask"):
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# train state and step
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["mask"] = np.ones((B, S), np.float32)
    return b


def _clone_tree(tree):
    return T.tree_map(lambda _, t: t.clone(), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_state_from_numpy_round_trip(name):
    rcfg, cfg = ref_registry.smoke_config("olmoe-1b-7b"), registry.smoke_config("olmoe-1b-7b")
    oc = ref_opt.OptConfig(name=name)
    rs = ref_lm.init_train_state(rcfg, jax.random.PRNGKey(2), oc)
    st = lm.train_state_from_numpy(cfg, jax.tree.map(np.asarray, rs), "cpu")
    assert isinstance(st, lm.TrainState)
    assert type(st.opt).__name__ == type(rs.opt).__name__
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    ours = T.tree_leaves(st.params) + opt._leaves(list(st.opt))
    refs = jax.tree.leaves(rs.params) + jax.tree.leaves(rs.opt)
    assert len(ours) == len(refs)
    for a, b in zip(ours, refs):
        assert a.dtype == getattr(torch, str(b.dtype)) and np.array_equal(a.numpy(), b)
    fresh = lm.init_train_state(cfg, torch.Generator().manual_seed(0), opt.OptConfig(name=name))
    assert [tuple(t.shape) for t in opt._leaves(list(fresh.opt))] == \
        [tuple(t.shape) for t in opt._leaves(list(st.opt))]


@pytest.mark.parametrize("name,arch", [("adamw", "phi3-mini-3.8b"), ("adafactor", "olmoe-1b-7b")])
def test_train_step_matches_reference_from_injected_state(name, arch, f32_forward):
    """Two steps: the reference's first from its initial state (so the
    moments are not zero), then one step of each package from that state
    on another batch."""
    rcfg, cfg = ref_registry.smoke_config(arch), registry.smoke_config(arch)
    kw = dict(name=name, lr=1e-3, weight_decay=0.01)
    roc, oc = ref_opt.OptConfig(**kw), opt.OptConfig(**kw)
    rp = _ref_params(rcfg, 1)
    r_init, _ = ref_opt.make_optimizer(roc)
    rs = ref_lm.TrainState(params=rp, opt=r_init(rp), step=jnp.zeros((), jnp.int32))
    rstep = jax.jit(ref_lm.make_train_step(rcfg, roc, remat=False, compute_dtype=jnp.float32))
    rs, _ = rstep(rs, {k: jnp.asarray(v) for k, v in _batch(cfg, 2, 16, 1).items()})
    st = lm.train_state_from_numpy(cfg, jax.tree.map(np.asarray, rs), "cpu")
    b2 = _batch(cfg, 2, 16, 2)
    rs2, rm = rstep(rs, {k: jnp.asarray(v) for k, v in b2.items()})
    step = lm.make_train_step(cfg, oc, compute_dtype=torch.float32)
    st2, m = step(st, {k: _t(v) for k, v in b2.items()})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), atol=FWD_TOL, rtol=FWD_TOL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=NORM_REL)
    assert int(st2.step) == int(rs2.step) == 2 and int(st2.opt.step) == 2
    for a, b in zip(T.tree_leaves(st2.params), jax.tree.leaves(rs2.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=P_ATOL, rtol=P_RTOL)


def test_microbatch_accumulation_matches_full_batch():
    """tests/test_training.py:94-117 in the port."""
    cfg = registry.smoke_config("phi3-mini-3.8b")
    oc = opt.OptConfig(lr=1e-3)
    state = lm.init_train_state(cfg, torch.Generator().manual_seed(0), oc)
    st_a = lm.TrainState(_clone_tree(state.params), opt.adam_init(state.params), state.step)
    batch = {k: _t(v) for k, v in _batch(cfg, 4, 16, 0).items()}
    s1 = lm.make_train_step(cfg, oc, microbatch=1, remat=False, compute_dtype=torch.float32)
    s2 = lm.make_train_step(cfg, oc, microbatch=2, remat=False, compute_dtype=torch.float32)
    st1, m1 = s1(state, batch)
    st2, m2 = s2(st_a, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for a, b in zip(T.tree_leaves(st1.params), T.tree_leaves(st2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=P_ATOL, rtol=P_RTOL)


def test_train_step_remat_on_and_off_equal():
    cfg = registry.smoke_config("recurrentgemma-2b")
    oc = opt.OptConfig(lr=1e-3)
    a = lm.init_train_state(cfg, torch.Generator().manual_seed(3), oc)
    b = lm.TrainState(_clone_tree(a.params), opt.adam_init(a.params), a.step)
    batch = {k: _t(v) for k, v in _batch(cfg, 2, 16, 4).items()}
    sa, ma = lm.make_train_step(cfg, oc, remat=True)(a, batch)
    sb, mb = lm.make_train_step(cfg, oc, remat=False)(b, batch)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    assert all(torch.equal(x, y) for x, y in zip(T.tree_leaves(sa.params), T.tree_leaves(sb.params)))
    assert not any(t.requires_grad for t in T.tree_leaves(sa.params))


def test_mesh_and_pod_sync_raise_with_their_roadmap_item():
    """The mesh train step and the pod sync are ported
    (tests/test_torch_mesh_train.py); as in the reference, ``pod_compress``
    does nothing without a mesh that has a "pod" axis: the step is
    bit-equal to the one without it.  A recurrent arch's mesh step with it
    on a mesh that has a "pod" axis runs the sync
    (tests/test_torch_mesh_recurrent.py holds it)."""
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch.mesh import make_mesh

    cfg = registry.smoke_config("phi3-mini-3.8b")
    oc = opt.OptConfig(lr=1e-3)
    a = lm.init_train_state(cfg, torch.Generator().manual_seed(0), oc)
    b = lm.TrainState(_clone_tree(a.params), opt.adam_init(a.params), a.step)
    batch = {k: _t(v) for k, v in _batch(cfg, 2, 16, 5).items()}
    sa, ma = lm.make_train_step(cfg, oc, remat=False)(a, batch)
    sb, mb = lm.make_train_step(cfg, oc, remat=False, pod_compress=True)(b, batch)
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    assert all(torch.equal(x, y) for x, y in zip(T.tree_leaves(sa.params), T.tree_leaves(sb.params)))
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), devices=["cpu"] * 4)
    rcfg = registry.smoke_config("recurrentgemma-2b")
    sp = shard_params(rcfg, T.init_params(rcfg, torch.Generator().manual_seed(0)), mesh)
    st = lm.TrainState(sp, opt.adam_init(sp), torch.zeros((), dtype=torch.int32))
    rb = {k: _t(v) for k, v in _batch(rcfg, 2, 8, 5).items()}
    st, m = lm.make_train_step(rcfg, opt.OptConfig(), mesh=mesh, pod_compress=True)(st, rb)
    assert np.isfinite(float(m["loss"])) and int(st.step) == 1


def test_train_loss_goes_down_tiny_lm():
    """tests/test_training.py:165-179 in the port."""
    cfg = registry.smoke_config("phi3-mini-3.8b")
    oc = opt.OptConfig(lr=3e-3)
    state = lm.init_train_state(cfg, torch.Generator().manual_seed(0), oc)
    step = lm.make_train_step(cfg, oc, remat=False, compute_dtype=torch.float32)
    losses = []
    for _, batch in zip(range(60), synthetic_lm_batches(cfg.vocab, 32, 8, seed=0)):
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


@pytest.mark.parametrize("arch", ref_registry.list_archs())
def test_smoke_train_step(arch):
    """tests/test_models_smoke.py:39-54 in the port."""
    cfg = registry.smoke_config(arch)
    state = lm.init_train_state(cfg, torch.Generator().manual_seed(0), opt.OptConfig(lr=1e-3))
    before = [t.clone() for t in T.tree_leaves(state.params)]
    step = lm.make_train_step(cfg, opt.OptConfig(lr=1e-3), remat=False)
    state, metrics = step(state, {k: _t(v) for k, v in _batch(cfg, 2, 16, 0).items()})
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    delta = sum(float((a - b).abs().sum()) for a, b in zip(T.tree_leaves(state.params), before))
    assert delta > 0


# ---------------------------------------------------------------------------
# the example and the bench
# ---------------------------------------------------------------------------

def test_train_lm_example_runs_and_resumes(tmp_path, capsys):
    ex = _load("examples_torch/train_lm.py")
    ck = str(tmp_path / "ck")
    out = ex.main(["--device", "cpu", "--steps", "30", "--ckpt", ck])
    assert out["start"] == 0 and len(out["losses"]) == 30
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    text = capsys.readouterr().out
    assert "step   30" in text and "done." in text
    assert int(out["state"].step) == int(out["state"].opt.step) == 30
    again = ex.main(["--device", "cpu", "--steps", "27", "--ckpt", ck])
    assert again["start"] == 25 and len(again["losses"]) == 2
    assert "resumed from step 25" in capsys.readouterr().out
    assert int(again["state"].step) == int(again["state"].opt.step) == 27


def test_train_lm_example_stub_frontend_and_width(capsys):
    ex = _load("examples_torch/train_lm.py")
    out = ex.main(["--device", "cpu", "--arch", "musicgen-medium", "--steps", "3",
                   "--microbatch", "1", "--schedule", "cosine"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    out = ex.main(["--device", "cpu", "--steps", "2", "--width", "48", "--layers", "1"])
    assert "params=" in capsys.readouterr().out
    assert out["state"].params["embed"].shape[-1] == 48
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ex.main(["--steps", "1"])


def test_lm_substrate_bench_through_run(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    from benchmarks_torch import run as p_run

    p_run.main(["--device", "cpu", "--only", "lm_substrate", "--no-history"])
    rows = [ln.split(",") for ln in capsys.readouterr().out.splitlines()[1:] if "," in ln]
    names = [r[0] for r in rows]
    archs = ("phi3-mini-3.8b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b")
    assert names == [f"lm_{kind}_step_{a}" for a in archs for kind in ("train", "decode")]
    assert all(float(r[1]) > 0 for r in rows)
    assert [r[2] for r in rows[:2]] == ["B=4;S=32;smoke", "B=4;smoke"]
    assert not list(tmp_path.iterdir())            # no JSON_OUT, no history


def test_state_dataclass_config_replace_keeps_width():
    cfg = dataclasses.replace(registry.smoke_config("qwen3-4b"), n_layers=1)
    st = lm.init_train_state(cfg, torch.Generator().manual_seed(0),
                             opt.OptConfig(name="adafactor"), device="cpu")
    assert isinstance(st.opt, opt.AdafactorState) and st.step.device.type == "cpu"
