"""The port's optimizers, cross-entropy, int8 codec and LM loss
(``repro_torch.training.optimizer``, ``repro_torch.models.lm``) against the
reference's (``repro.training.optimizer``, ``repro.models.lm``) on the CPU.

Inputs and states are drawn with numpy and injected into both packages.
Tolerances, each beside its source:

- ``adam_update`` / ``adafactor_update``: params and states within
  ``OPT_TOL`` = 1e-6 relative, each entry within 1e-6 (|ref| + the leaf's
  max |ref|) (the same float32 expressions; the largest deviation measured
  over these cases is 1.2e-7 of that scale: ulps of a ``pow``, or a
  reduction summed in another order);
- ``clip_by_global_norm``: rel 1e-5 (``tests/test_training.py:90``);
- ``_xent``: 1e-5 (``tests/test_training.py:144``);
- the int8 codec: bit-equal with the reference's noise injected; error at
  most 1.01 scale, bias within rel 0.05 (``tests/test_training.py:155,162``);
- ``lm_loss``: the reference's ``lm_loss`` runs its forward at the
  forward's default bf16 whatever ``compute_dtype`` says (it casts only the
  master weights), and the port does the same: as they are, the two losses
  are bf16 forwards of the same weights, within ``BF16_LOSS_REL`` = 1e-3
  relative (bf16's epsilon is 7.8e-3; XLA's fused bf16 layer loop rounds a
  few ulps apart, and a MoE's router may then pick another expert; the
  largest difference measured is 6.4e-4 relative, on olmoe), 5e-3 for
  recurrentgemma (1.9e-3 measured with bf16 weights: its RG-LRU states are
  a sequential loop here and an associative scan there, rounded to bf16
  after either; ``tests/test_torch_serving.py`` bounds its engine's logits
  looser than the other archs' for the same reason).  With both forwards patched to float32 compute (``f32_forward``)
  the losses, plain and fused (``loss_chunk=4``), are within ``FWD_TOL`` =
  1e-4 (``tests/test_torch_lm.py``; 1.5e-6 measured); fused against plain
  in the port within rel 1e-5 (``tests/test_training.py:133``; 1.1e-7).
"""
import dataclasses
import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from test_torch_lm import _ref_params  # noqa: E402

OPT_TOL = 1e-6
CLIP_TOL = 1e-5                 # tests/test_training.py:90
XENT_TOL = 1e-5                 # tests/test_training.py:144
FUSED_TOL = 1e-5                # tests/test_training.py:133
FWD_TOL = 1e-4                  # tests/test_torch_lm.py
BF16_LOSS_REL = {"recurrentgemma-2b": 5e-3}      # default 1e-3
LOSS_ARCHS = ["phi3-mini-3.8b", "qwen3-4b", "olmoe-1b-7b", "recurrentgemma-2b",
              "rwkv6-7b", "musicgen-medium"]


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


def _np(a):
    return np.asarray(a, dtype=np.float32)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _quadratic_steps(name, steps=60, lr=0.1):
    """tests/test_training.py:_quadratic_steps in the port."""
    cfg = opt.OptConfig(name=name, lr=lr, grad_clip=10.0)
    init, update = opt.make_optimizer(cfg)
    params = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones((2, 3))}
    target = {"w": torch.tensor([1.0, 1.0]), "m": torch.zeros((2, 3))}
    state = init(params)

    def loss(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in sorted(p))

    l0 = float(loss(params))
    for _ in range(steps):
        leaves = [params[k].requires_grad_(True) for k in sorted(params)]
        g = torch.autograd.grad(loss(params), leaves)
        for p in leaves:
            p.requires_grad_(False)
        params, state, _ = update(dict(zip(sorted(params), g)), state, params)
    return l0, float(loss(params))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    l0, l1 = _quadratic_steps(name)
    assert l1 < 0.05 * l0, (name, l0, l1)       # tests/test_training.py:34


def _opt_problem(seed):
    """A stacked [L, a, b] leaf, a matrix, a vector and a per-layer vector
    (a stacked norm scale, which Adafactor factors), as nested dicts."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 4, 5), "ln": (3, 5)}, "head": (6, 4), "bias": (7,)}

    def draw(tree, scale=1.0):
        return {k: draw(v, scale) if isinstance(v, dict)
                else (rng.standard_normal(v) * scale).astype(np.float32) for k, v in tree.items()}
    return draw(shapes), [draw(shapes, 0.3) for _ in range(3)]


def _tree_t(tree):
    return jax.tree.map(_t, tree)


def _ref_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_tree(port, ref, tol, what):
    pl, rl = opt._leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl) > 0
    for a, b in zip(pl, rl):
        assert tuple(a.shape) == np.shape(b), what
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=tol, atol=tol * np.abs(b).max(),
                                   err_msg=what)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("schedule,wd", [("constant", 0.0), ("inverse_time", 0.1),
                                         ("cosine", 0.0), ("cosine", 0.05)])
def test_updates_match_reference(name, schedule, wd):
    """1 and 3 updates from the reference's params, grads and states
    (states after one reference update, so the moments are not zero);
    grad_clip 1.0 clips every gradient here."""
    cfg_kw = dict(name=name, lr=0.05, weight_decay=wd, schedule=schedule,
                  schedule_steps=5, min_lr=0.001)
    rcfg, cfg = ref_opt.OptConfig(**cfg_kw), opt.OptConfig(**cfg_kw)
    params, grads = _opt_problem(zlib.crc32(f"{name} {schedule} {wd}".encode()) % 1000)
    r_init, r_update = ref_opt.make_optimizer(rcfg)
    rp = _ref_tree(params)
    rp, rs, _ = r_update(_ref_tree(grads[2]), r_init(rp), rp)       # warm moments
    state_np = jax.tree.map(np.asarray, rs)
    cls = opt.AdamState if name == "adamw" else opt.AdafactorState
    ps = cls(*(_tree_t(getattr(state_np, f)) for f in cls._fields[:-1]),
             step=torch.tensor(int(state_np.step), dtype=torch.int32))
    pp = _tree_t(jax.tree.map(np.asarray, rp))
    _, update = opt.make_optimizer(cfg)
    for n, g in enumerate(grads, 1):
        rp, rs, rnorm = r_update(_ref_tree(g), rs, rp)
        pp, ps, norm = update(_tree_t(g), ps, pp)
        assert float(norm) == pytest.approx(float(rnorm), rel=OPT_TOL)
        if n in (1, 3):
            _close_tree(pp, rp, OPT_TOL, f"params after {n}")
            for f in cls._fields[:-1]:
                _close_tree(getattr(ps, f), getattr(rs, f), OPT_TOL, f"{f} after {n}")
            assert int(ps.step) == int(rs.step) == n + 1


def test_adafactor_factors_stacked_leaves_as_the_reference():
    params = {"ln": torch.zeros(3, 5), "w": torch.zeros(2, 4, 6), "b": torch.zeros(7)}
    st = opt.adafactor_init(params)
    assert tuple(st.vr["ln"].shape) == (3,) and tuple(st.vc["ln"].shape) == (5,)
    assert tuple(st.vr["w"].shape) == (2, 4) and tuple(st.vc["w"].shape) == (2, 6)
    assert tuple(st.vr["b"].shape) == (7,) and tuple(st.vc["b"].shape) == (1,)
    r = ref_opt.adafactor_init({k: jnp.zeros(v.shape) for k, v in params.items()})
    assert [tuple(a.shape) for a in opt._leaves(st.vr) + opt._leaves(st.vc)] == \
        [a.shape for a in jax.tree.leaves(r.vr) + jax.tree.leaves(r.vc)]


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=CLIP_TOL)
    _, grads = _opt_problem(3)
    c, n = opt.clip_by_global_norm(_tree_t(grads[0]), 0.5)
    rc, rn = ref_opt.clip_by_global_norm(_ref_tree(grads[0]), 0.5)
    assert float(n) == pytest.approx(float(rn), rel=CLIP_TOL)
    _close_tree(c, rc, CLIP_TOL, "clipped")


def test_optimizer_uses_schedule():
    """tests/test_training.py:72-89 in the port: the first step (cos(0) = 1)
    equals constant; a step at the cosine horizon with min_lr 0 is a no-op."""
    g = {"w": torch.tensor([1.0, 0.5])}
    const = opt.OptConfig(lr=0.1, grad_clip=10.0)
    cos = opt.OptConfig(lr=0.1, grad_clip=10.0, schedule="cosine", schedule_steps=8)
    p1, _, _ = opt.adam_update(g, opt.adam_init({"w": torch.zeros(2)}),
                               {"w": torch.tensor([3.0, -2.0])}, const)
    p2, s_cos, _ = opt.adam_update(g, opt.adam_init({"w": torch.zeros(2)}),
                                   {"w": torch.tensor([3.0, -2.0])}, cos)
    assert torch.equal(p1["w"], p2["w"])
    s_end = opt.AdamState(m=s_cos.m, v=s_cos.v, step=torch.tensor(8, dtype=torch.int32))
    p3, _, _ = opt.adam_update(g, s_end, {"w": torch.tensor([3.0, -2.0])}, cos)
    assert torch.equal(p3["w"], torch.tensor([3.0, -2.0]))
    with pytest.raises(ValueError):
        opt.make_optimizer(opt.OptConfig(name="sgd"))


def test_update_writes_in_place_and_returns_the_same_tensors():
    params = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    ids = {k: id(v) for k, v in params.items()}
    for name in ("adamw", "adafactor"):
        init, update = opt.make_optimizer(opt.OptConfig(name=name))
        st = init(params)
        p2, st2, _ = update({k: torch.full_like(v, 0.5) for k, v in params.items()}, st, params)
        assert {k: id(v) for k, v in p2.items()} == ids
        assert all(a is b for a, b in zip(opt._leaves(st2[:2]), opt._leaves(st[:2])))
        assert int(st2.step) == 1 and int(st.step) == 0


# ---------------------------------------------------------------------------
# cross-entropy and the int8 codec
# ---------------------------------------------------------------------------

def test_xent_matches_reference_and_manual():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 3, 7)).astype(np.float32) * 4
    labels = rng.integers(0, 7, (2, 3)).astype(np.int32)
    nll = lm._xent(_t(logits), _t(labels))
    ref = ref_lm._xent(jnp.asarray(logits), jnp.asarray(labels))
    manual = -torch.log_softmax(_t(logits), -1).gather(-1, _t(labels).long()[..., None])[..., 0]
    np.testing.assert_allclose(nll.numpy(), np.asarray(ref), atol=XENT_TOL, rtol=XENT_TOL)
    np.testing.assert_allclose(nll.numpy(), manual.numpy(), atol=XENT_TOL, rtol=XENT_TOL)
    lg = _t(logits).requires_grad_(True)
    (g,) = torch.autograd.grad(lm._xent(lg, _t(labels)).sum(), lg)
    rg = jax.grad(lambda x: ref_lm._xent(x, jnp.asarray(labels)).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=XENT_TOL, rtol=XENT_TOL)


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 50.0), (3, 1.0)])
def test_int8_bit_equal_with_the_reference_noise(seed, scale):
    g = (np.random.default_rng(seed).standard_normal((64,)) * scale).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    rq, rs = ref_lm.quantize_int8(jnp.asarray(g), key)
    noise = np.asarray(jax.random.uniform(key, g.shape, jnp.float32) - 0.5)
    q, s = lm.quantize_int8(_t(g), noise=_t(noise))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_int8_quantization_error_bounded(seed, scale):
    g = torch.from_numpy((np.random.default_rng(seed).standard_normal((64,)) * scale)
                         .astype(np.float32))
    q, s = lm.quantize_int8(g, generator=torch.Generator().manual_seed(seed))
    back = q.float() * s
    assert float((back - g).abs().max()) <= float(s) * 1.01   # tests/test_training.py:155


def test_int8_stochastic_rounding_unbiased():
    g = torch.full((20000,), 0.3e-2)
    q, s = lm.quantize_int8(g, generator=torch.Generator().manual_seed(0))
    assert float((q.float() * s).mean()) == pytest.approx(0.3e-2, rel=0.05)  # :162


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    return b


@pytest.fixture
def f32_forward(monkeypatch):
    """Both packages' ``lm_loss`` with its forward in float32 compute (the
    reference's ``lm_loss`` does not pass ``compute_dtype`` on)."""
    monkeypatch.setattr(RT, "forward", functools.partial(RT.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(T, "forward", functools.partial(T.forward, compute_dtype=torch.float32))


def _loss_pair(arch, seed=2):
    rcfg, cfg = ref_registry.smoke_config(arch), registry.smoke_config(arch)
    rp = _ref_params(rcfg, 1)
    pp = T.params_from_numpy(cfg, jax.tree.map(np.asarray, rp), "cpu")
    b = _batch(cfg, 2, 16, seed=seed)
    return (rcfg, rp, {k: jnp.asarray(v) for k, v in b.items()},
            cfg, pp, {k: _t(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_plain_and_fused_match_reference(arch, f32_forward):
    rcfg, rp, rb, cfg, pp, tb = _loss_pair(arch)
    ref = float(ref_lm.lm_loss(rcfg, rp, rb, remat=False, compute_dtype=jnp.float32))
    ref_fused = float(ref_lm.lm_loss(rcfg, rp, rb, remat=False, compute_dtype=jnp.float32,
                                     fused_loss=True, loss_chunk=4))
    with torch.no_grad():
        plain = lm.lm_loss(cfg, pp, tb, compute_dtype=torch.float32)
        fused = lm.lm_loss(cfg, pp, tb, compute_dtype=torch.float32, fused_loss=True,
                           loss_chunk=4)
    assert plain.dtype == torch.float32 and plain.shape == ()
    np.testing.assert_allclose(float(plain), ref, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(float(fused), ref_fused, atol=FWD_TOL, rtol=FWD_TOL)
    assert float(fused) == pytest.approx(float(plain), rel=FUSED_TOL)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_forward_is_bf16_as_the_reference(arch):
    """As they are, both ``lm_loss``es run a bf16 forward: within bf16
    tolerance of each other at either ``compute_dtype``."""
    rcfg, rp, rb, cfg, pp, tb = _loss_pair(arch)
    for rdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = ref_lm.lm_loss(rcfg, rp, rb, remat=False, compute_dtype=rdt)
        with torch.no_grad():
            port = lm.lm_loss(cfg, pp, tb, compute_dtype=dt)
        assert float(port) == pytest.approx(float(ref), rel=BF16_LOSS_REL.get(arch, 1e-3))


def test_lm_loss_mask_clamp_and_chunk_checks():
    cfg = registry.smoke_config("qwen3-4b")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    b = {k: _t(v) for k, v in _batch(cfg, 2, 12, seed=4).items()}
    with torch.no_grad():
        zero = lm.lm_loss(cfg, pp, dict(b, mask=torch.zeros(2, 12)))
        assert float(zero) == 0.0                        # sum 0 over max(0, 1)
        nomask = lm.lm_loss(cfg, pp, {k: v for k, v in b.items() if k != "mask"})
        ones = lm.lm_loss(cfg, pp, dict(b, mask=torch.ones(2, 12)))
        assert torch.equal(nomask, ones)
        with pytest.raises(ValueError, match="divide"):
            lm.lm_loss(cfg, pp, b, fused_loss=True, loss_chunk=5)
    with pytest.raises(NotImplementedError, match="13f"):
        lm.lm_loss(cfg, pp, b, mesh=object())


def test_fused_loss_matches_unfused_in_bf16():
    """tests/test_training.py:120-133 in the port (bf16 weights and
    activations)."""
    cfg = registry.smoke_config("qwen3-4b")
    pp = T.init_params(cfg, torch.Generator().manual_seed(1))
    b = {k: _t(v) for k, v in _batch(cfg, 2, 16, seed=1).items() if k != "mask"}
    with torch.no_grad():
        l1 = lm.lm_loss(cfg, pp, b, remat=False, fused_loss=False)
        l2 = lm.lm_loss(cfg, pp, b, remat=False, fused_loss=True, loss_chunk=4)
    assert float(l1) == pytest.approx(float(l2), rel=FUSED_TOL)
    cfg2 = dataclasses.replace(cfg, n_layers=1)
    pp2 = T.init_params(cfg2, torch.Generator().manual_seed(1))
    l3 = lm.lm_loss(cfg2, pp2, b, fused_loss=True, loss_chunk=8)   # grad enabled: checkpointed
    with torch.no_grad():
        assert torch.equal(l3.detach(), lm.lm_loss(cfg2, pp2, b, fused_loss=True, loss_chunk=8))
