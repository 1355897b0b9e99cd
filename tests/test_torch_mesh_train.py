"""Mesh LM training in the port (``sharding.train_policy_for`` /
``shard_train_state``, ``collectives.all_gather_over``, ``forward(mode=
"train", mesh=)``, ``lm_loss(mesh=)``, ``make_train_step(mesh=,
pod_compress=)``, ``moe_ffn(fsdp_gather=True)``, ``compressed_pod_psum``,
the optimizers over ``Sharded`` leaves) and the ``mlp_2d`` serving layout,
on meshes of CPU cells.

Tolerances, each beside its source:

- layouts: round trips bit-equal, each cell's bytes equal to the layout's
  count; the data gather's backward equal to the reduce-scatter of the
  single-device gradient in float64 (1e-12);
- the loss on the mesh against the port's single-device ``lm_loss``:
  float32 forward (both patched as ``tests/test_torch_training.py`` does)
  rel ``LOSS_REL`` = 1e-5, float64 1e-10 with every gradient within 1e-10
  of its leaf's largest entry (a token counted twice would show as a
  factor of "model" = 2 or 4); fused against plain on the mesh rel 1e-5
  (``tests/test_training.py:133``);
- the train step on the mesh against the single-device step from the same
  injected state: loss rel 1e-4, params atol 2.5e-3 rtol 1e-3
  (``tests/test_training.py:113-117``), float64 params within 1e-10; and
  against the reference's own mesh step (qwen3-4b smoke, data=2 x model=4,
  microbatch 2, its forward patched to float32) at the same bounds with
  the loss finite (``tests/test_distributed.py:221``);
- ``moe_ffn(fsdp_gather=True)`` against the reference's under
  ``shard_map``: 2e-4 (``tests/test_distributed.py:159``);
- ``compressed_pod_psum`` bit-equal to the reference's with its noise
  injected, within 2 x scale of its input (``tests/test_distributed.py:245``);
  a ``pod_compress=True`` step finite, its params within 2 lr of the
  uncompressed step's (AdamW's first step moves each parameter by about
  lr times the sign of its gradient; the int8 round trip may flip a sign);
- the ``mlp_2d`` layout (mistral-large, internvl2 smoke) against one
  device: float32 1e-4, float64 1e-10 (the 13d rows of ROADMAP's table);
  the bf16 ``ServeEngine(mesh=)`` given that tree token for token and logit
  for logit equal to the engine on the default serve layout (the gathers
  copy, so each cell computes the same products).
"""
import contextlib
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import builders as RB  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.collectives import all_gather_over, all_reduce  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

LOSS_REL = 1e-5
FUSED_REL = 1e-5                # tests/test_training.py:133
STEP_LOSS_REL = 1e-4            # tests/test_training.py:113-117
P_ATOL, P_RTOL = 2.5e-3, 1e-3   # tests/test_training.py:113-117
F64_TOL = 1e-10
GATHER_TOL = 1e-12
MOE_TOL = 2e-4                  # tests/test_distributed.py:159
FWD_TOL = 1e-4                  # tests/test_torch_lm.py
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LOSS_ARCHS = ["phi3-mini-3.8b", "qwen3-4b", "olmoe-1b-7b", "mistral-large-123b"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this file's smoke-size tensors: as fast alone,
    and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    cf = float(math.ceil(cfg.moe.n_experts / cfg.moe.top_k))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@contextlib.contextmanager
def _forward_at(dtype):
    """Both forwards of ``lm_loss`` (one device, mesh) in ``dtype``: the
    port's ``lm_loss``, as the reference's, does not pass its
    ``compute_dtype`` on (``tests/test_torch_training.py``'s
    ``f32_forward``)."""
    orig = T.forward
    T.forward = functools.partial(orig, compute_dtype=dtype)
    try:
        yield
    finally:
        T.forward = orig


def _batch(cfg, B, S, seed, mask=True):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if mask:
        b["mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_state(rcfg, oc_kw, seed=0):
    """The reference's initial ``TrainState`` as numpy leaves."""
    rs = ref_lm.init_train_state(rcfg, jax.random.PRNGKey(seed), ref_opt.OptConfig(**oc_kw))
    return jax.tree.map(np.asarray, rs)


def _state(cfg, state_np, dtype):
    st = lm.train_state_from_numpy(cfg, state_np, "cpu")
    if dtype == torch.float32:
        return st
    cast = functools.partial(T.tree_map, lambda _, t: t.to(dtype))
    return lm.TrainState(cast(st.params), type(st.opt)(*cast(list(st.opt[:2])), st.opt.step),
                         st.step)


def _leaf_names(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{path}/{i}")]
    return [path]


# ---------------------------------------------------------------------------
# layouts and the data gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["2x2", "2x2x2"])
def test_train_and_mlp_2d_layouts_round_trip_and_count_bytes(mesh_name):
    """``shard_params`` under ``train_policy_for`` (the reference builders'
    train policy) and ``mlp_2d``, and ``shard_train_state`` (AdamW and
    Adafactor): bit-equal round trips, each cell's bytes the layout's; the
    optimizers' ``init`` on a laid-out tree gives the same layout."""
    mesh = _mesh(mesh_name)
    for arch in ("olmoe-1b-7b", "mistral-large-123b"):
        spec, rspec = registry.get_arch(arch), ref_registry.get_arch(arch)
        cfg = registry.smoke_config(arch)
        assert spec.fsdp
        pol = shd.train_policy_for(cfg, mesh)

        class RefMesh:
            axis_names, shape = mesh.axis_names, dict(mesh.shape)
        rpol = RB._train_policy(dataclasses.replace(rspec, model=ref_registry.smoke_config(arch)),
                                RefMesh)
        assert dict(pol.rules) == dict(rpol.rules)
        pp = T.init_params(cfg, torch.Generator().manual_seed(1))
        for sp in (shd.shard_params(cfg, pp, mesh, policy=pol),
                   shd.shard_params(cfg, pp, mesh, serve_seq_shard=True, mlp_2d=True)):
            assert all(torch.equal(a, b) for a, b in
                       zip(T.tree_leaves(pp), T.tree_leaves(shd.unshard_tree(sp))))
            assert shd.cell_bytes(sp, mesh) == shd.layout_bytes(sp, mesh)
        for name in ("adamw", "adafactor"):
            init, _ = opt.make_optimizer(opt.OptConfig(name=name))
            st = lm.TrainState(pp, init(pp), torch.zeros((), dtype=torch.int32))
            st = lm.TrainState(pp, type(st.opt)(*(T.tree_map(lambda _, t: t + 0.5, x)
                                                  for x in st.opt[:2]), st.opt.step), st.step)
            sst = shd.shard_train_state(cfg, st, mesh, pol)
            for a, b in ((st.params, sst.params), (list(st.opt[:2]), list(sst.opt[:2]))):
                assert all(torch.equal(x, y) for x, y in
                           zip(T.tree_leaves(a), T.tree_leaves(shd.unshard_tree(b))))
            assert shd.cell_bytes(sst, mesh) == shd.layout_bytes(sst, mesh)
            total = sum(t.numel() * t.element_size() for t in T.tree_leaves(list(st)))
            assert sum(shd.device_bytes(sst).values()) + 8 == total    # one card, + 2 steps
            fresh = init(sst.params)
            assert [x.spec for x in opt._leaves(list(fresh[:2]))] == \
                [x.spec for x in opt._leaves(list(sst.opt[:2]))]
            assert sst.step.device == mesh.home and fresh.step.device == mesh.home
    # the train policy splits every matrix's d_model over "data": a quarter a cell
    w = sst.params["blocks"][0]["0"]["w_gate"]
    assert w.spec == (None, "data", "model") and \
        math.prod(w.local_shape()) * 4 == math.prod(w.shape)


def test_data_gather_backward_is_the_reduce_scatter():
    """float64: each cell's gathered tensor (dim 1 gathered over "data",
    dim 2 its "model" block) times a weight of its own; each block's
    gradient equals the matching slice of the single-device gradient, and
    ``all_reduce``'s inputs get the sum of its outputs' gradients."""
    mesh = _mesh("2x4")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 8, 8)))
    w = [torch.from_numpy(rng.standard_normal((3, 8, 2))) for _ in range(mesh.size)]
    sx = shd.shard(x, (None, "data", "model"), mesh)
    blocks = [t.requires_grad_(True) for t in sx.cells]
    gathered = all_gather_over(blocks, mesh, "data", 1)
    assert all(tuple(g.shape) == (3, 8, 2) for g in gathered)
    loss = sum(torch.sum(g * wc) for g, wc in zip(gathered, w))
    grads = torch.autograd.grad(loss, blocks)
    xs = x.clone().requires_grad_(True)
    ref = sum(torch.sum(xs[:, :, sx.slices(c)[2]] * wc) for c, wc in enumerate(w))
    (gx,) = torch.autograd.grad(ref, xs)
    for c, g in enumerate(grads):
        assert torch.allclose(g, gx[sx.slices(c)], atol=GATHER_TOL, rtol=0)
    parts = [torch.from_numpy(rng.standard_normal((4, 5))).requires_grad_(True) for _ in range(3)]
    ws = [torch.from_numpy(rng.standard_normal((4, 5))) for _ in range(3)]
    out = all_reduce(parts)
    gp = torch.autograd.grad(sum(torch.sum(o * wc) for o, wc in zip(out, ws)), parts)
    assert all(torch.allclose(g, ws[0] + ws[1] + ws[2], atol=GATHER_TOL, rtol=0) for g in gp)


# ---------------------------------------------------------------------------
# the loss on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_mesh_loss_matches_single_device(arch, mesh_name):
    """Plain and fused, float32 and float64 (with the gradients: every
    token's loss counted once), against the single-device ``lm_loss``."""
    cfg = _no_drop(registry.smoke_config(arch))
    mesh = _mesh(mesh_name)
    pol = shd.train_policy_for(cfg, mesh)
    b = _batch(cfg, 4, 16, seed=2)
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    sp = shd.shard_params(cfg, pp, mesh, policy=pol)
    kw = dict(compute_dtype=torch.float32, loss_chunk=4)
    with _forward_at(torch.float32), torch.no_grad():
        one = lm.lm_loss(cfg, pp, b, **kw)
        plain = lm.lm_loss(cfg, sp, b, mesh=mesh, **kw)
        fused = lm.lm_loss(cfg, sp, b, mesh=mesh, fused_loss=True, **kw)
    assert plain.shape == () and plain.dtype == torch.float32 and plain.device == mesh.home
    assert float(plain) == pytest.approx(float(one), rel=LOSS_REL)
    assert float(fused) == pytest.approx(float(plain), rel=FUSED_REL)

    p64 = T.tree_map(lambda _, t: t.double(), pp)
    s64 = shd.shard_params(cfg, p64, mesh, policy=pol)
    leaves, dl = T.tree_leaves(p64), lm._distinct_tensors(s64)
    for t in leaves + dl:
        t.requires_grad_(True)
    kw64 = dict(compute_dtype=torch.float64, loss_chunk=4)
    with _forward_at(torch.float64):
        one = lm.lm_loss(cfg, p64, b, **kw64)
        g1 = torch.autograd.grad(one, leaves)
        for fused_loss in (False, True):
            got = lm.lm_loss(cfg, s64, b, mesh=mesh, fused_loss=fused_loss, **kw64)
            assert abs(float(got) - float(one)) <= F64_TOL * abs(float(one))
            g2 = lm._replica_sums(s64, list(torch.autograd.grad(got, dl)))
            for name, a, g in zip(_leaf_names(p64), g1, g2):
                d = float((a - g.unshard()).abs().max())
                assert d <= F64_TOL * max(float(a.abs().max()), 1e-30), (name, fused_loss, d)


# ---------------------------------------------------------------------------
# the train step on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh_name,name,microbatch,remat", [
    ("phi3-mini-3.8b", "2x2", "adamw", 1, True),
    ("phi3-mini-3.8b", "2x2", "adamw", 2, False),
    ("phi3-mini-3.8b", "1x4", "adamw", 2, True),
    ("phi3-mini-3.8b", "2x2", "adafactor", 1, False),
    ("phi3-mini-3.8b", "2x2", "adafactor", 2, True),
    ("phi3-mini-3.8b", "1x4", "adafactor", 1, True),
    ("olmoe-1b-7b", "2x2", "adamw", 2, True),
    ("mistral-large-123b", "2x2", "adafactor", 1, False),
])
def test_mesh_train_step_matches_single_device(arch, mesh_name, name, microbatch, remat):
    """From the same injected state (the reference's ``init_train_state``
    through ``train_state_from_numpy``): float32 loss rel 1e-4, params
    atol 2.5e-3 rtol 1e-3; float64 params within 1e-10; replicas equal."""
    cfg = _no_drop(registry.smoke_config(arch))
    rcfg = _no_drop(ref_registry.smoke_config(arch))
    mesh = _mesh(mesh_name)
    oc_kw = dict(name=name, lr=1e-3, weight_decay=0.01)
    state_np = _ref_state(rcfg, oc_kw)
    oc = opt.OptConfig(**oc_kw)
    b = _batch(cfg, 4, 16, seed=3)
    for dtype in (torch.float32, torch.float64):
        kw = dict(microbatch=microbatch, remat=remat, compute_dtype=dtype)
        st = _state(cfg, state_np, dtype)
        sst = shd.shard_train_state(cfg, _state(cfg, state_np, dtype), mesh,
                                    shd.train_policy_for(cfg, mesh))
        with _forward_at(dtype):
            s1, m1 = lm.make_train_step(cfg, oc, **kw)(st, b)
            s2, m2 = lm.make_train_step(cfg, oc, mesh=mesh, **kw)(sst, b)
        assert int(s2.step) == 1 and int(s2.opt.step) == 1 and s2.step.device == mesh.home
        back = shd.unshard_tree(s2.params)
        if dtype == torch.float32:
            assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=STEP_LOSS_REL)
            for a, p in zip(T.tree_leaves(s1.params), T.tree_leaves(back)):
                np.testing.assert_allclose(p.numpy(), a.numpy(), atol=P_ATOL, rtol=P_RTOL)
        else:
            d = max(float((a - p).abs().max()) for a, p in
                    zip(T.tree_leaves(s1.params) + opt._leaves(list(s1.opt[:2])),
                        T.tree_leaves(back) + opt._leaves(shd.unshard_tree(list(s2.opt[:2])))))
            assert d <= F64_TOL, d
        assert not any(t.requires_grad for t in lm._distinct_tensors(s2.params))


def test_mesh_train_step_keeps_replicas_on_distinct_devices_equal():
    """Cells on distinct devices hold distinct copies of a replicated
    block: the step sums their gradients and updates every copy alike.
    (Two CPU "devices" differ only by name here: ``cpu`` and ``cpu:0``.)"""
    cfg = registry.smoke_config("phi3-mini-3.8b")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    assert len(mesh.distinct_devices) == 2
    oc_kw = dict(name="adamw", lr=1e-3)
    state_np = _ref_state(ref_registry.smoke_config("phi3-mini-3.8b"), oc_kw)
    st = _state(cfg, state_np, torch.float64)
    sst = shd.shard_train_state(cfg, _state(cfg, state_np, torch.float64), mesh,
                                shd.train_policy_for(cfg, mesh))
    ln = sst.params["blocks"][0]["0"]["ln1"]
    assert len(ln.block_tensors()[(0, 0)]) == 2          # one copy a device
    b = _batch(cfg, 4, 16, seed=4)
    with _forward_at(torch.float64):
        s1, _ = lm.make_train_step(cfg, opt.OptConfig(**oc_kw), compute_dtype=torch.float64)(st, b)
        s2, _ = lm.make_train_step(cfg, opt.OptConfig(**oc_kw), mesh=mesh,
                                   compute_dtype=torch.float64)(sst, b)
    for leaf in T.tree_leaves(s2.params):
        for ts in leaf.block_tensors().values():
            assert all(torch.equal(t, ts[0]) for t in ts[1:])
    d = max(float((a - p).abs().max()) for a, p in
            zip(T.tree_leaves(s1.params), T.tree_leaves(shd.unshard_tree(s2.params))))
    assert d <= F64_TOL, d


# ---------------------------------------------------------------------------
# against the reference's own mesh code
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
import functools
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import registry
from repro.launch import builders
from repro.launch.mesh import make_mesh
from repro.models import lm as lm_mod, moe as moe_mod, transformer as T
from repro.training import optimizer as opt_mod

T.forward = functools.partial(T.forward, compute_dtype=jnp.float32)
inp = dict(np.load({inp!r}))
res = {{}}
m24 = make_mesh((2, 4), ('data', 'model'))
m222 = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
cfg = registry.smoke_config('qwen3-4b')
shapes = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
leaves, tdef = jax.tree.flatten(shapes)
params = jax.tree.unflatten(tdef, [jnp.asarray(inp[f'p{{i}}']) for i in range(len(leaves))])
oc = opt_mod.OptConfig(lr=1e-3)
init, _ = opt_mod.make_optimizer(oc)
state = lm_mod.TrainState(params=params, opt=init(params), step=jnp.zeros((), jnp.int32))
spec = type(registry.get_arch('qwen3-4b'))(model=cfg, fsdp=True, microbatch=2)
structs = builders.train_state_structs(spec, m24)
state = jax.device_put(state, jax.tree.map(lambda s: s.sharding, structs))
batch = {{k: jax.device_put(jnp.asarray(inp[k]), NamedSharding(m24, P('data')))
         for k in ('tokens', 'labels', 'mask')}}
step = lm_mod.make_train_step(cfg, oc, mesh=m24, microbatch=2, compute_dtype=jnp.float32)
new, m = jax.jit(step)(state, batch)
res['loss'] = np.asarray(m['loss'])
res['grad_norm'] = np.asarray(m['grad_norm'])
for i, a in enumerate(jax.tree.leaves(new.params)):
    res[f'new{{i}}'] = np.asarray(a)
mp = {{k: jnp.asarray(inp['moe_' + k]) for k in ('router', 'w_gate', 'w_up', 'w_down')}}
for cf in (1.25, 100.0):
    mc = moe_mod.MoEConfig(n_experts=8, top_k=2, capacity_factor=cf)
    res[f'moe_{{cf}}'] = np.asarray(jax.jit(
        lambda p, x: moe_mod.moe_ffn(p, x, mc, mesh=m24, fsdp_gather=True))(mp, jnp.asarray(inp['moe_x'])))
g = {{'a': jnp.asarray(inp['g_a']), 'b': {{'c': jnp.asarray(inp['g_c']), 'd': jnp.asarray(inp['g_d'])}}}}
key = jax.random.PRNGKey(5)
keys = jax.random.split(key, 3)
for i, (kk, leaf) in enumerate(zip(keys, jax.tree.leaves(g))):
    res[f'noise{{i}}'] = np.asarray(jax.random.uniform(kk, leaf.shape, jnp.float32) - 0.5)
out = compat.shard_map(lambda gg: lm_mod.compressed_pod_psum(gg, key), mesh=m222,
                       in_specs=(jax.tree.map(lambda _: P(), g),),
                       out_specs=jax.tree.map(lambda _: P(), g),
                       axis_names={{'pod', 'data', 'model'}}, check_vma=False)(g)
for i, a in enumerate(jax.tree.leaves(out)):
    res[f'pod{{i}}'] = np.asarray(a)
np.savez({out!r}, **res)
print('OK')
"""


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """Inputs made with numpy (seed 0) and the reference's mesh results on
    8 forced host devices: its qwen3-4b smoke train step on data=2 x
    model=4 (microbatch 2, AdamW, float32 weights and forward), ``moe_ffn(fsdp_gather=
    True)`` on the same mesh, and ``compressed_pod_psum`` on pod=2 x
    data=2 x model=2."""
    from test_distributed import run_script

    rng = np.random.default_rng(0)
    rcfg = ref_registry.smoke_config("qwen3-4b")
    shapes = jax.tree.leaves(jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.PRNGKey(0))))
    inp = {}
    for i, s in enumerate(shapes):
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        inp[f"p{i}"] = (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(np.float32)
    inp["tokens"] = rng.integers(0, rcfg.vocab, (8, 16)).astype(np.int32)
    inp["labels"] = rng.integers(0, rcfg.vocab, (8, 16)).astype(np.int32)
    inp["mask"] = (rng.random((8, 16)) < 0.8).astype(np.float32)
    for k, s in (("router", (8, 8)), ("w_gate", (8, 8, 16)), ("w_up", (8, 8, 16)),
                 ("w_down", (8, 16, 8))):
        inp["moe_" + k] = (rng.standard_normal(s) * (1.0 if k == "router" else 0.2)).astype(
            np.float32)
    inp["moe_x"] = rng.standard_normal((2, 32, 8)).astype(np.float32)
    inp["g_a"] = (rng.standard_normal((32, 8)) * 1e-3).astype(np.float32)
    inp["g_c"] = rng.standard_normal((16,)).astype(np.float32)
    inp["g_d"] = (rng.standard_normal((4, 8, 6)) * 50).astype(np.float32)
    d = tmp_path_factory.mktemp("mesh_train_ref")
    np.savez(d / "inp.npz", **inp)
    run_script(_REF_SCRIPT.format(inp=str(d / "inp.npz"), out=str(d / "ref.npz")))
    return inp, dict(np.load(d / "ref.npz"))


@pytest.mark.mesh
def test_mesh_train_step_matches_reference_mesh_step(ref_mesh):
    inp, ref = ref_mesh
    rcfg, cfg = ref_registry.smoke_config("qwen3-4b"), registry.smoke_config("qwen3-4b")
    shapes = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
    leaves, tdef = jax.tree.flatten(shapes)
    params = jax.tree.unflatten(tdef, [inp[f"p{i}"] for i in range(len(leaves))])
    zeros = jax.tree.map(np.zeros_like, params)
    state_np = ref_lm.TrainState(params=params, opt=ref_opt.AdamState(
        m=zeros, v=zeros, step=np.int32(0)), step=np.int32(0))
    mesh = _mesh("2x4")
    st = shd.shard_train_state(cfg, lm.train_state_from_numpy(cfg, state_np, "cpu"), mesh,
                               shd.train_policy_for(cfg, mesh))
    b = {k: torch.from_numpy(inp[k]) for k in ("tokens", "labels", "mask")}
    with _forward_at(torch.float32):
        st2, m = lm.make_train_step(cfg, opt.OptConfig(lr=1e-3), mesh=mesh, microbatch=2,
                                    compute_dtype=torch.float32)(st, b)
    assert math.isfinite(float(m["loss"]))                      # tests/test_distributed.py:221
    assert float(m["loss"]) == pytest.approx(float(ref["loss"]), rel=STEP_LOSS_REL)
    assert float(m["grad_norm"]) == pytest.approx(float(ref["grad_norm"]), rel=STEP_LOSS_REL)
    for i, p in enumerate(T.tree_leaves(shd.unshard_tree(st2.params))):
        np.testing.assert_allclose(p.numpy(), ref[f"new{i}"], atol=P_ATOL, rtol=P_RTOL)


@pytest.mark.mesh
@pytest.mark.parametrize("cf", [1.25, 100.0])
def test_moe_fsdp_gather_matches_reference_mesh(ref_mesh, cf):
    """The expert weights split 2D (experts over "model", d_model over
    "data") and gathered before use: the reference's result at its own
    capacity (pairs drop by each data shard's count) and at one that drops
    nothing, where it equals one device."""
    inp, ref = ref_mesh
    params = {k: torch.from_numpy(inp["moe_" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(inp["moe_x"])
    cfg = moe_mod.MoEConfig(n_experts=8, top_k=2, capacity_factor=cf)
    mesh = _mesh("2x4")
    got = moe_mod.moe_ffn(params, x, cfg, mesh=mesh, fsdp_gather=True)
    np.testing.assert_allclose(got.numpy(), ref[f"moe_{cf}"], atol=MOE_TOL, rtol=MOE_TOL)
    assert torch.equal(got, moe_mod.moe_ffn(params, x, cfg, mesh=mesh))
    specs = moe_mod.moe_param_specs(fsdp=True)
    laid = {k: shd.shard(v, specs[k], mesh) for k, v in params.items()}
    assert laid["w_down"].spec == ("model", None, "data")
    assert torch.equal(moe_mod.moe_ffn(laid, x, cfg, mesh=mesh, fsdp_gather=True), got)
    if cf == 100.0:
        np.testing.assert_allclose(got.numpy(), moe_mod.moe_ffn(params, x, cfg).numpy(),
                                   atol=MOE_TOL, rtol=MOE_TOL)


@pytest.mark.mesh
def test_compressed_pod_psum_matches_reference_bit_for_bit(ref_mesh):
    inp, ref = ref_mesh
    mesh = _mesh("2x2x2")
    g = {"a": torch.from_numpy(inp["g_a"]),
         "b": {"c": torch.from_numpy(inp["g_c"]), "d": torch.from_numpy(inp["g_d"])}}
    specs = {"a": ("data", "model"), "b": {"c": (None,), "d": (None, "data", "model")}}
    sg = shd.shard_tree(g, specs, mesh)
    noise = {"a": torch.from_numpy(ref["noise0"]),
             "b": {"c": torch.from_numpy(ref["noise1"]), "d": torch.from_numpy(ref["noise2"])}}
    out = lm.compressed_pod_psum(sg, noise, mesh)
    for i, (x, o) in enumerate(zip(T.tree_leaves(g), T.tree_leaves(out))):
        got = o.unshard()
        assert o.spec == T.tree_leaves(sg)[i].spec
        assert np.array_equal(got.numpy(), ref[f"pod{i}"]), i
        scale = float(x.abs().max()) / 127
        assert float((got - x).abs().max()) <= 2 * scale     # tests/test_distributed.py:245
    # the generator's draw: the same bounds, and the same noise twice
    a = lm.compressed_pod_psum(sg, lm.pod_generator(3, "cpu"), mesh)
    b = lm.compressed_pod_psum(sg, lm.pod_generator(3, "cpu"), mesh)
    for x, p, q in zip(T.tree_leaves(g), T.tree_leaves(a), T.tree_leaves(b)):
        assert torch.equal(p.unshard(), q.unshard())
        assert float((p.unshard() - x).abs().max()) <= 2 * float(x.abs().max()) / 127


def test_pod_compress_step_is_finite_and_near_the_uncompressed_step():
    cfg = registry.smoke_config("phi3-mini-3.8b")
    mesh = _mesh("2x2x2")
    oc_kw = dict(name="adamw", lr=1e-3)
    state_np = _ref_state(ref_registry.smoke_config("phi3-mini-3.8b"), oc_kw)
    b = _batch(cfg, 4, 16, seed=5)
    runs = []
    for pod in (False, True):
        st = shd.shard_train_state(cfg, _state(cfg, state_np, torch.float32), mesh,
                                   shd.train_policy_for(cfg, mesh))
        with _forward_at(torch.float32):
            runs.append(lm.make_train_step(cfg, opt.OptConfig(**oc_kw), mesh=mesh,
                                           pod_compress=pod)(st, b))
    (s0, m0), (s1, m1) = runs
    assert math.isfinite(float(m1["loss"])) and torch.equal(m0["loss"], m1["loss"])
    assert float(m1["grad_norm"]) != float(m0["grad_norm"])     # the sync ran
    d = max(float((a.unshard() - p.unshard()).abs().max()) for a, p in
            zip(T.tree_leaves(s0.params), T.tree_leaves(s1.params)))
    assert 0 < d <= 2 * oc_kw["lr"] * (1 + 1e-3), d


# ---------------------------------------------------------------------------
# the mlp_2d serving layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mistral-large-123b", "internvl2-26b"])
def test_mlp_2d_prefill_and_decode_match_single_device(arch, monkeypatch):
    """Prefill and 3 decode steps with the parameters laid out by
    ``mlp_2d`` (with replicated heads under ``serve_seq_shard``: the
    attention projections over ("data", "model") too), against one
    device."""
    from test_torch_mesh_lm import _prefill_and_decode

    monkeypatch.setattr(shd, "shard_params", functools.partial(shd.shard_params, mlp_2d=True))
    cfg = registry.smoke_config(arch)
    mesh = _mesh("2x2")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    for seq in (True, False):
        sp = shd.shard_params(cfg, pp, mesh, serve_seq_shard=seq)
        assert sp["blocks"][0]["0"]["w_gate"].spec == (None, "data", "model")
        assert sp["blocks"][0]["0"]["wq"].spec[1] == (("data", "model") if seq else "data")
        d, dc, eq = _prefill_and_decode(cfg, pp, mesh, seq, torch.float32)
        assert d <= FWD_TOL and dc <= FWD_TOL and eq, (seq, d, dc)
    p64 = T.tree_map(lambda _, t: t.double(), pp)
    d, dc, eq = _prefill_and_decode(cfg, p64, mesh, True, torch.float64)
    assert d <= F64_TOL and dc <= F64_TOL and eq, (d, dc)


def test_mesh_engine_serves_the_mlp_2d_tree_as_given():
    """bf16, 4 slots, the example's traffic: the engine given the
    ``mlp_2d`` tree keeps its layout (each cell holds a quarter of every
    FFN matrix) and decodes call by call what the engine on the default
    serve layout decodes, logits bit for bit."""
    from test_torch_mesh_lm import _logged_engine
    from test_torch_serving import _requests

    cfg = registry.smoke_config("mistral-large-123b")
    mesh = _mesh("2x2")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    sp = shd.shard_params(cfg, pp, mesh, serve_seq_shard=True, mlp_2d=True)
    logs, reqs = [], []
    for tree in (sp, pp):
        log = []
        eng = _logged_engine(cfg, tree, log, mesh=mesh, serve_seq_shard=True)
        rs = _requests(engine.Request, cfg)
        for r in rs:
            eng.submit(r)
        eng.run()
        logs.append(log)
        reqs.append(rs)
        if tree is sp:
            w = eng.params["blocks"][0]["0"]["w_gate"]
            assert w.spec == (None, "data", "model") and w.dtype == torch.bfloat16
            assert math.prod(w.local_shape()) * 4 == math.prod(w.shape)
            assert shd.cell_bytes(eng.params, mesh) == shd.layout_bytes(eng.params, mesh)
            assert eng.params["final_norm"].dtype == torch.float32
    assert [r.out for r in reqs[0]] == [r.out for r in reqs[1]]
    assert all(len(r.out) == 12 for r in reqs[0])
    assert len(logs[0]) == len(logs[1])
    for a, b in zip(*logs):
        assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))


# ---------------------------------------------------------------------------
# the recurrent blocks on a mesh
# ---------------------------------------------------------------------------

def test_recurrent_blocks_on_a_mesh_raise_naming_13g():
    """The recurrent archs run on a mesh (tests/test_torch_mesh_recurrent.py
    holds them against one device and the reference): the train step, the
    loss, the train forward and the engine, each with a finite result."""
    mesh = _mesh("2x2")
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        cfg = registry.smoke_config(arch)
        pp = T.init_params(cfg, torch.Generator().manual_seed(0))
        sp = shd.shard_params(cfg, pp, mesh, policy=shd.train_policy_for(cfg, mesh))
        b = _batch(cfg, 2, 8, seed=0)
        st = lm.TrainState(sp, opt.adam_init(sp), torch.zeros((), dtype=torch.int32))
        st, m = lm.make_train_step(cfg, opt.OptConfig(), mesh=mesh)(st, b)
        assert math.isfinite(float(m["loss"])) and int(st.step) == 1
        with torch.no_grad():
            assert math.isfinite(float(lm.lm_loss(cfg, sp, b, mesh=mesh)))
            logits, _ = T.forward(cfg, sp, b, mode="train", mesh=mesh)
        assert logits.shape == (2, 8, cfg.padded_vocab)
        eng = engine.ServeEngine(cfg, pp, mesh=mesh, n_slots=2, max_seq=16)
        req = engine.Request(rid=0, prompt=np.array([1, 2, 3], np.int32), max_new_tokens=2)
        eng.submit(req)
        eng.run()
        assert req.done and len(req.out) == 2
    # no fallback: cells asked for on the card need the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
