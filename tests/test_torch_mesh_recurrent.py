"""The recurrent blocks and the ring (sliding-window) decode on a mesh in
the port (``models/mesh_forward.py``'s ``rglru`` and ``rwkv`` blocks and
ring, ``block_cache_layout``; the steps, the loss, the train step and
``ServeEngine(mesh=)`` for recurrentgemma-2b and rwkv6-7b), on meshes of
CPU cells: data=2 x model=2, data=2 x model=4 (rwkv6's 2 smoke heads do
not divide it: its time mix is replicated over "model") and pod=2 x data=2
x model=2.

The weights are the reference's ``init_params`` (recurrentgemma's ``lam``
redrawn from the seed by its recipe, as tests/test_torch_serving.py does)
with the leaves it initialises to zero (norm scales, RWKV6's ``u``,
``ln_w``, ``ln_b``) drawn with numpy from the seed: at zero RWKV6's group
norm would scale the whole time mix to 0.

Tolerances (the 13d and 13f rows of ROADMAP's table):

- prefill and decode, mesh against one device: float32 1e-4, float64
  1e-10, greedy tokens equal; recurrentgemma's 11-token prompt rolls its
  window-8 ring and 10 decode steps wrap it;
- against the reference's own mesh (run once in a subprocess on 8 forced
  host devices, tests/test_distributed.py's ``run_script``): prefill and 4
  decode steps 1e-4, one AdamW step loss rel 1e-4, params atol 2.5e-3 rtol
  1e-3 (``tests/test_training.py:113-117``); the cache layouts equal the
  reference's ``cache_specs`` but for RG-LRU's ``conv`` and ``h``, split
  over "model" here (ROADMAP Queue 3);
- the loss on the mesh against one device: float32 rel 1e-5, fused
  against plain rel 1e-5 (``tests/test_training.py:133``), float64 with
  every gradient within 1e-10 of its leaf's largest entry; rwkv6 at S=128,
  so the chunked WKV scan runs under grad;
- AdamW and Adafactor steps, remat on and off: loss rel 1e-4, params atol
  2.5e-3 rtol 1e-3, float64 params 1e-10; a ``pod_compress=True`` step
  finite and within 2 lr of the uncompressed one;
- the bf16 ``ServeEngine(mesh=)`` against the one-device engine call by
  call: logits within 0.5, flips only at top-2 margins under 0.125,
  pinned in ``MESH_FLIPS``;
- each cell's bytes of the parameters and of every cache kind equal to
  the layout's count.
"""
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as ref_registry  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mesh_forward as MF  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from test_torch_mesh_train import _forward_at  # noqa: E402

FWD_TOL = 1e-4
F64_TOL = 1e-10
LOSS_REL = 1e-5
FUSED_REL = 1e-5                # tests/test_training.py:133
STEP_LOSS_REL = 1e-4            # tests/test_training.py:113-117
P_ATOL, P_RTOL = 2.5e-3, 1e-3   # tests/test_training.py:113-117
#: the bf16 engines, mesh against one device (phase 16's gates): logits
#: within ``MESH_BF16_REL`` times the one device's largest, flips only at
#: top-2 margins under ``MESH_NEAR_TIE`` (rwkv6: ``NEAR_TIE_ARCH``)
MESH_BF16_REL = 0.5
MESH_NEAR_TIE = 0.125
#: rwkv6's bf16 logits at these weights move by more than a flip's margin
#: under a rounding-sized change: every bf16 weight one ulp up moves its
#: one-device logits by 0.84 of a largest 4.2, against the mesh's 0.19
#: (``test_bf16_mesh_forward_is_within_a_rounding_of_one_device``); its
#: mesh engine flips once at a margin of 0.27 on data=2 x model=2
NEAR_TIE_ARCH = {"rwkv6-7b": 0.375}
ARCHS = ["recurrentgemma-2b", "rwkv6-7b"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: the leaves the reference initialises to zero, drawn here from the seed
_DRAWN = ("ln1", "ln2", "final_norm", "ln_w", "ln_b", "u")
#: the bf16 mesh engine's near-tie flips against the one-device engine:
#: (decode call, slot, request) per (arch, mesh)
MESH_FLIPS = {("recurrentgemma-2b", "2x2"): [(16, 2, 2), (18, 0, 0), (21, 1, 1), (24, 3, 3)],
              ("recurrentgemma-2b", "2x2x2"): [(16, 2, 2), (18, 0, 0), (21, 1, 1), (24, 3, 3)],
              ("rwkv6-7b", "2x2"): [(15, 2, 2), (17, 0, 0), (40, 1, None)],
              ("rwkv6-7b", "2x4"): [(53, 3, None), (61, 1, 5)]}


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


@functools.lru_cache(maxsize=None)
def _weights_np(arch, seed=0):
    """The reference's ``init_params`` as numpy leaves, its ``lam`` redrawn
    from ``seed`` by its recipe and the ``_DRAWN`` leaves drawn with numpy
    (norm scales and ``ln_w`` about 1 + N(0, 0.2), the others N(0, 0.2))."""
    from test_torch_serving import _ref_params

    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(np.asarray, _ref_params(ref_registry.smoke_config(arch), seed))

    def draw(t, name=None):
        if isinstance(t, dict):
            return {k: draw(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [draw(v, name) for v in t]
        if name not in _DRAWN:
            return t
        z = (rng.standard_normal(t.shape) * 0.2).astype(t.dtype)
        return z + 1 if name == "ln_w" else z
    return draw(tree)


def _params(arch, dtype=torch.float32):
    cfg = registry.smoke_config(arch)
    pp = T.params_from_numpy(cfg, _weights_np(arch), "cpu")
    return T.tree_map(lambda _, t: t.to(dtype), pp)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def _serve_both(cfg, pp, mesh, dtype, *, B=4, S=11, steps=10, seq=False, seed=0):
    """Prefill and ``steps`` decode steps on one device and on ``mesh``
    from the same prompt, the tokens fed back from the single device.
    Returns the largest logit difference, the largest cache difference
    after the last step, whether every token agreed, and both caches."""
    kw = dict(compute_dtype=dtype)
    sp = shd.shard_params(cfg, pp, mesh, serve_seq_shard=seq)
    tokens = _tokens(cfg, B, S, seed)
    l1, c1 = T.forward(cfg, pp, {"tokens": tokens}, mode="prefill", **kw)
    l2, c2 = T.forward(cfg, sp, {"tokens": tokens}, mode="prefill", mesh=mesh,
                       serve_seq_shard=seq, **kw)
    d = float((l1 - l2.unshard()).abs().max())
    equal = torch.equal(torch.argmax(l1[:, -1], -1), MF.argmax(l2)[:, -1])
    lens = torch.full((B,), S, dtype=torch.int32)
    tok = torch.argmax(l1[:, -1], -1).to(torch.int32)
    for _ in range(steps):
        g1, c1 = T.forward(cfg, pp, {"tokens": tok[:, None]}, mode="decode", cache=c1,
                           lengths=lens, **kw)
        g2, c2 = T.forward(cfg, sp, {"tokens": tok[:, None]}, mode="decode", cache=c2,
                           lengths=lens, mesh=mesh, serve_seq_shard=seq, **kw)
        d = max(d, float((g1 - g2.unshard()).abs().max()))
        nxt = torch.argmax(g1[:, 0], -1).to(torch.int32)
        equal &= torch.equal(nxt, MF.argmax(g2)[:, 0].to(torch.int32))
        tok, lens = nxt, lens + 1
    dc = max(float((a.double() - b.double()).abs().max()) for a, b in
             zip(T.tree_leaves(c1), T.tree_leaves(shd.unshard_tree(c2))))
    return d, dc, equal, c1, c2


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_leaves_lay_out_by_both_policies(arch, mesh_name):
    """``serve_policy_for`` / ``train_policy_for`` on the RG-LRU and RWKV6
    leaves: "rnn" over "model", "lora" and "norm" replicated, d_model over
    "data" under the train policy; ``shard_params`` and
    ``shard_train_state`` (AdamW, Adafactor) round trip bit for bit and
    each cell holds the layout's bytes.  recurrentgemma's 10 heads pad to
    16, so they split over "model"; its one kv head does not."""
    cfg = registry.smoke_config(arch)
    full = registry.get_arch(arch).model
    mesh = _mesh(mesh_name)
    tp = mesh.shape["model"]
    if arch == "recurrentgemma-2b":
        assert full.padded_heads == 16 and full.padded_heads % tp == 0 and full.n_kv % tp
    pp = _params(arch)
    serve, train = shd.serve_policy_for(cfg, mesh), shd.train_policy_for(cfg, mesh)
    for pol in (serve, train):
        assert (pol.rules["rnn"], pol.rules["lora"], pol.rules["norm"]) == ("model", None, None)
        sp = shd.shard_params(cfg, pp, mesh, policy=pol)
        assert all(torch.equal(a, b) for a, b in
                   zip(T.tree_leaves(pp), T.tree_leaves(shd.unshard_tree(sp))))
        assert shd.cell_bytes(sp, mesh) == shd.layout_bytes(sp, mesh)
        blk = sp["blocks"][0]["0"]
        fs = "data" if pol is train else None
        if arch == "recurrentgemma-2b":
            assert blk["w_in_rnn"].spec == (None, fs, "model")
            assert blk["w_a"].spec == (None, None, "model") and blk["lam"].spec == (None, "model")
            assert blk["w_out"].spec == (None, "model", fs)
        else:
            assert blk["w_r"].spec == (None, fs, "model") and blk["w_o"].spec == (None, "model", fs)
            assert blk["w_lora_a"].spec == (None, fs, None)
            assert blk["w_lora_b"].spec == (None, None, None) and blk["u"].spec == (None, None)
            assert blk["w_cr"].spec == (None, fs, None) and blk["w_cv"].spec == (None, "model", fs)
    for name in ("adamw", "adafactor"):
        init, _ = opt.make_optimizer(opt.OptConfig(name=name))
        st = lm.TrainState(pp, init(pp), torch.zeros((), dtype=torch.int32))
        sst = shd.shard_train_state(cfg, st, mesh, train)
        for a, b in ((st.params, sst.params), (list(st.opt[:2]), list(sst.opt[:2]))):
            assert all(torch.equal(x, y) for x, y in
                       zip(T.tree_leaves(a), T.tree_leaves(shd.unshard_tree(b))))
        assert shd.cell_bytes(sst, mesh) == shd.layout_bytes(sst, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_cache_lays_out_every_kind(arch, mesh_name):
    """``init_cache(mesh=)`` builds every leaf ``transformer.init_cache``
    builds, of its shape and dtype (a window's ``pos`` at -1): batch over
    the data axes, ``conv`` / ``h`` over "model" by channel, ``s`` by heads
    where they divide "model", the ring and ``x_prev_*`` whole over
    "model"; under ``serve_seq_shard`` the ring's slots over "model".  Each
    cell holds the layout's bytes."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh(mesh_name)
    dp = shd.dp_axes(mesh)
    for seq in (False, True):
        one = T.init_cache(cfg, 4, 16, torch.bfloat16, device="cpu")
        got = T.init_cache(cfg, 4, 16, torch.bfloat16, mesh=mesh, serve_seq_shard=seq)
        back = shd.unshard_tree(got)
        assert [(a.shape, a.dtype) for a in T.tree_leaves(one)] == \
            [(b.shape, b.dtype) for b in T.tree_leaves(back)]
        assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(one), T.tree_leaves(back)))
        assert shd.cell_bytes(got, mesh) == shd.layout_bytes(got, mesh)
        specs = {}
        for grp in got["blocks"]:
            for blk in grp.values():
                for nm, t in blk.items():
                    specs[nm] = t.spec
        if arch == "recurrentgemma-2b":
            assert specs["k"] == (None, dp, "model" if seq else None, None, None)
            assert specs["pos"] == (None, dp, None)
            assert specs["conv"] == (None, dp, None, "model") and specs["h"] == (None, dp, "model")
            assert len(got["blocks"]) == 2 and set(got["blocks"][1]) == {"0", "1"}
        else:
            heads = "model" if (cfg.d_model // 64) % mesh.shape["model"] == 0 else None
            assert specs["s"] == (None, dp, heads, None, None)
            assert specs["x_prev_t"] == specs["x_prev_c"] == (None, dp, None)
            assert (heads is None) == (mesh_name == "2x4")


# ---------------------------------------------------------------------------
# serving: mesh against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_single_device(arch, mesh_name):
    """Float32 within 1e-4, greedy tokens equal; batch 4 split over the
    data axes and batch 3 replicated.  recurrentgemma: an 11-token prompt
    rolls the window-8 ring (its slots hold positions 8, 9, 10, 3, ..., 7)
    and 10 decode steps wrap it."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh(mesh_name)
    pp = _params(arch)
    for B in (4, 3):
        d, dc, eq, c1, c2 = _serve_both(cfg, pp, mesh, torch.float32, B=B, steps=10)
        assert d <= FWD_TOL and dc <= FWD_TOL and eq, (B, d, dc)
    if arch == "recurrentgemma-2b":
        sp = shd.shard_params(cfg, pp, mesh)
        _, cache = T.forward(cfg, sp, {"tokens": _tokens(cfg, 4, 11, 0)}, mode="prefill",
                             mesh=mesh, compute_dtype=torch.float32)
        pos = cache["blocks"][0]["2"]["pos"].unshard()
        assert pos.shape == (1, 4, 8) and pos[0, 0].tolist() == [8, 9, 10, 3, 4, 5, 6, 7]
        # after 10 steps the ring holds positions 13..20
        assert sorted(c1["blocks"][0]["2"]["pos"][0, 0].tolist()) == list(range(13, 21))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_single_device_float64(arch, mesh_name):
    cfg = registry.smoke_config(arch)
    d, dc, eq, _, _ = _serve_both(cfg, _params(arch, torch.float64), _mesh(mesh_name),
                                  torch.float64, steps=10)
    assert d <= F64_TOL and dc <= F64_TOL and eq, (d, dc)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_serve_seq_shard_ring_matches_single_device(mesh_name):
    """``serve_seq_shard=True`` on recurrentgemma: the reference's decode
    takes the ring before flash-decode, so the result is the ring decode's;
    here the ring's slots split over "model", each cell's partial softmax
    combined over it.  Float32 1e-4, float64 1e-10."""
    cfg = registry.smoke_config("recurrentgemma-2b")
    mesh = _mesh(mesh_name)
    d, dc, eq, _, c2 = _serve_both(cfg, _params("recurrentgemma-2b"), mesh, torch.float32,
                                   seq=True)
    assert d <= FWD_TOL and dc <= FWD_TOL and eq, (d, dc)
    k = c2["blocks"][0]["2"]["k"]
    assert k.spec[2] == "model" and k.cells[0].shape[2] == 8 // mesh.shape["model"]
    d, dc, eq, _, _ = _serve_both(cfg, _params("recurrentgemma-2b", torch.float64), mesh,
                                  torch.float64, seq=True)
    assert d <= F64_TOL and dc <= F64_TOL and eq, (d, dc)
    # the steps: a ring of min(window, S) slots must split over "model"
    sp = shd.shard_params(cfg, _params("recurrentgemma-2b"), mesh, serve_seq_shard=True)
    tok, cache = lm.make_prefill_step(cfg, mesh=mesh, serve_seq_shard=True, max_seq=13)(
        sp, {"tokens": _tokens(cfg, 4, 12, 1)})
    assert cache["blocks"][0]["2"]["k"].shape[2] == 8 and tok.shape == (4,)
    with pytest.raises(ValueError, match="split"):
        lm.make_prefill_step(cfg, mesh=mesh, serve_seq_shard=True)(
            sp, {"tokens": _tokens(cfg, 4, 7, 1)})


def test_ring_with_kv_heads_split_over_model_matches_single_device():
    """data=4 x model=1: the one kv head "divides" model, so the policies
    split ``wk``/``wv`` over it, while a window's ring holds every kv head
    on each cell (the new k/v gathered over "model" before the ring's
    write); float32 1e-4, float64 1e-10."""
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    cfg = registry.smoke_config("recurrentgemma-2b")
    assert shd.shard_params(cfg, _params("recurrentgemma-2b"), mesh)["blocks"][0]["2"][
        "wk"].spec[2] == "model"
    for dtype, tol in ((torch.float32, FWD_TOL), (torch.float64, F64_TOL)):
        d, dc, eq, _, _ = _serve_both(cfg, _params("recurrentgemma-2b", dtype), mesh, dtype)
        assert d <= tol and dc <= tol and eq, (dtype, d, dc)


def test_steps_and_decode_write_every_leaf_in_place():
    """The prefill and decode steps on the mesh against one device (the
    cache padded to ``max_seq`` only where there is no window, as on one
    device); a decode writes the cache it was given, every kind, and a
    block that cells share is written once: a replicated batch's cells
    share one tensor and still agree with one device."""
    mesh = _mesh("2x2")
    for arch in ARCHS:
        cfg = registry.smoke_config(arch)
        pp = _params(arch)
        sp = shd.shard_params(cfg, pp, mesh)
        for B in (4, 3):
            toks = _tokens(cfg, B, 9, 2)
            kw = dict(compute_dtype=torch.float32, max_seq=32)
            t1, c1 = lm.make_prefill_step(cfg, **kw)(pp, {"tokens": toks})
            t2, c2 = lm.make_prefill_step(cfg, mesh=mesh, **kw)(sp, {"tokens": toks})
            assert torch.equal(t1, t2)
            d1 = lm.make_decode_step(cfg, compute_dtype=torch.float32)
            d2 = lm.make_decode_step(cfg, mesh=mesh, compute_dtype=torch.float32)
            lens = torch.full((B,), 9, dtype=torch.int32)
            ids = [id(t) for leaf in T.tree_leaves(c2) for t in leaf.cells]
            for _ in range(3):
                a1, c1, l1 = d1(pp, c1, t1, lens)
                a2, c2b, _ = d2(sp, c2, t1, lens)
                assert torch.equal(a1, a2) and all(
                    x is y for x, y in zip(T.tree_leaves(c2b), T.tree_leaves(c2)))
                t1, lens = a1, l1
            assert ids == [id(t) for leaf in T.tree_leaves(c2) for t in leaf.cells]
            for a, b in zip(T.tree_leaves(c1), T.tree_leaves(shd.unshard_tree(c2))):
                assert a.shape == b.shape and float((a - b).abs().max()) <= FWD_TOL


# ---------------------------------------------------------------------------
# against the reference's own mesh
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
import dataclasses, functools, json
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.distributed import sharding
from repro.launch import builders
from repro.launch.mesh import make_mesh
from repro.models import lm as lm_mod, transformer as T
from repro.training import optimizer as opt_mod

T.forward = functools.partial(T.forward, compute_dtype=jnp.float32)
inp = dict(np.load({inp!r}))
res = {{}}
m24 = make_mesh((2, 4), ('data', 'model'))
m22 = make_mesh((2, 2), ('data', 'model'))
for a, arch in (('rg', 'recurrentgemma-2b'), ('rw', 'rwkv6-7b')):
    cfg = registry.smoke_config(arch)
    shapes = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    leaves, tdef = jax.tree.flatten(shapes)
    params = jax.tree.unflatten(tdef, [jnp.asarray(inp[f'{{a}}_p{{i}}'])
                                       for i in range(len(leaves))])
    spec = dataclasses.replace(registry.get_arch(arch), model=cfg)
    specs = sharding.tree_specs(T.logical_axes_tree(cfg), builders._serve_policy(spec, m24))
    ps = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(m24, s), specs,
                                             is_leaf=lambda x: isinstance(x, P)))
    tokens = jnp.asarray(inp[f'{{a}}_tokens'])
    logits, cache = jax.jit(lambda p, t: T.forward(cfg, p, {{'tokens': t}}, mode='prefill',
                                                   mesh=m24))(ps, tokens)
    res[f'{{a}}_prefill'] = np.asarray(logits)
    dec = jax.jit(lambda p, c, t, l: T.forward(cfg, p, {{'tokens': t[:, None]}}, mode='decode',
                                               cache=c, lengths=l, mesh=m24))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    lens = jnp.full((tokens.shape[0],), tokens.shape[1], jnp.int32)
    for i in range(4):
        lg, cache = dec(ps, cache, tok, lens)
        res[f'{{a}}_dec{{i}}'] = np.asarray(lg)
        res[f'{{a}}_tok{{i}}'] = np.asarray(tok)
        tok = jnp.argmax(lg[:, 0], -1).astype(jnp.int32)
        lens = lens + 1
    oc = opt_mod.OptConfig(lr=1e-3)
    init, _ = opt_mod.make_optimizer(oc)
    state = lm_mod.TrainState(params=params, opt=init(params), step=jnp.zeros((), jnp.int32))
    tspec = type(spec)(model=cfg, fsdp=True, microbatch=1)
    structs = builders.train_state_structs(tspec, m24)
    state = jax.device_put(state, jax.tree.map(lambda s: s.sharding, structs))
    batch = {{k: jax.device_put(jnp.asarray(inp[f'{{a}}_{{k}}']), NamedSharding(m24, P('data')))
             for k in ('ttokens', 'labels', 'mask')}}
    batch['tokens'] = batch.pop('ttokens')
    step = lm_mod.make_train_step(cfg, oc, mesh=m24, compute_dtype=jnp.float32)
    new, m = jax.jit(step)(state, batch)
    res[f'{{a}}_loss'] = np.asarray(m['loss'])
    for i, x in enumerate(jax.tree.leaves(new.params)):
        res[f'{{a}}_new{{i}}'] = np.asarray(x)
    for seq in (False, True):
        cs = registry.cache_specs(cfg, ShapeConfig('c', 16, 4, 'decode'), mesh=m22,
                                  dp_spec=('data',), seq_shard_cache=seq, stacked=True)
        flat = jax.tree_util.tree_flatten_with_path(cs)[0]
        res[f'{{a}}_cache_specs_{{seq}}'] = np.array(json.dumps(
            [[str(p[-1].key), list(x.sharding.spec)] for p, x in flat]))
np.savez({out!r}, **res)
print('OK')
"""


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """Both archs' weights (``_weights_np``), prompts and a train batch
    made with numpy, and the reference's results on data=2 x model=4 of 8
    forced host devices: its float32 mesh prefill, 4 greedy decode steps,
    one AdamW mesh train step, and its ``cache_specs`` on data=2 x
    model=2."""
    from test_distributed import run_script

    rng = np.random.default_rng(7)
    inp = {}
    for a, arch in (("rg", "recurrentgemma-2b"), ("rw", "rwkv6-7b")):
        cfg = registry.smoke_config(arch)
        for i, x in enumerate(T.tree_leaves(_weights_np(arch))):
            inp[f"{a}_p{i}"] = x
        inp[f"{a}_tokens"] = rng.integers(0, cfg.vocab, (4, 11)).astype(np.int32)
        inp[f"{a}_ttokens"] = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
        inp[f"{a}_labels"] = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
        inp[f"{a}_mask"] = (rng.random((4, 16)) < 0.8).astype(np.float32)
    d = tmp_path_factory.mktemp("mesh_recurrent_ref")
    np.savez(d / "inp.npz", **inp)
    run_script(_REF_SCRIPT.format(inp=str(d / "inp.npz"), out=str(d / "ref.npz")))
    return inp, dict(np.load(d / "ref.npz"))


@pytest.mark.mesh
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_matches_reference_mesh(ref_mesh, arch):
    """The port's mesh prefill and 4 decode steps (the reference's tokens
    fed) against the reference's own mesh forward: 1e-4."""
    inp, ref = ref_mesh
    a = "rg" if arch == "recurrentgemma-2b" else "rw"
    cfg = registry.smoke_config(arch)
    mesh = _mesh("2x4")
    sp = shd.shard_params(cfg, _params(arch), mesh)
    kw = dict(mesh=mesh, compute_dtype=torch.float32)
    tokens = torch.from_numpy(inp[f"{a}_tokens"])
    logits, cache = T.forward(cfg, sp, {"tokens": tokens}, mode="prefill", **kw)
    np.testing.assert_allclose(logits.unshard().numpy(), ref[f"{a}_prefill"], atol=FWD_TOL,
                               rtol=FWD_TOL)
    lens = torch.full((4,), 11, dtype=torch.int32)
    for i in range(4):
        tok = torch.from_numpy(ref[f"{a}_tok{i}"])
        if i == 0:
            assert torch.equal(MF.argmax(logits)[:, -1].to(torch.int32), tok)
        lg, cache = T.forward(cfg, sp, {"tokens": tok[:, None]}, mode="decode", cache=cache,
                              lengths=lens, **kw)
        np.testing.assert_allclose(lg.unshard().numpy(), ref[f"{a}_dec{i}"], atol=FWD_TOL,
                                   rtol=FWD_TOL)
        lens = lens + 1


@pytest.mark.mesh
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_reference_mesh_step(ref_mesh, arch):
    inp, ref = ref_mesh
    a = "rg" if arch == "recurrentgemma-2b" else "rw"
    cfg = registry.smoke_config(arch)
    mesh = _mesh("2x4")
    pp = _params(arch)
    st = shd.shard_train_state(cfg, lm.TrainState(pp, opt.adam_init(pp),
                                                  torch.zeros((), dtype=torch.int32)),
                               mesh, shd.train_policy_for(cfg, mesh))
    b = {"tokens": torch.from_numpy(inp[f"{a}_ttokens"]),
         "labels": torch.from_numpy(inp[f"{a}_labels"]),
         "mask": torch.from_numpy(inp[f"{a}_mask"])}
    with _forward_at(torch.float32):
        st2, m = lm.make_train_step(cfg, opt.OptConfig(lr=1e-3), mesh=mesh,
                                    compute_dtype=torch.float32)(st, b)
    assert math.isfinite(float(m["loss"]))                      # tests/test_distributed.py:221
    assert float(m["loss"]) == pytest.approx(float(ref[f"{a}_loss"]), rel=STEP_LOSS_REL)
    for i, p in enumerate(T.tree_leaves(shd.unshard_tree(st2.params))):
        np.testing.assert_allclose(p.numpy(), ref[f"{a}_new{i}"], atol=P_ATOL, rtol=P_RTOL)


@pytest.mark.mesh
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference_cache_specs(ref_mesh, arch, seq):
    """Leaf for leaf the reference's ``cache_specs`` (stacked, data=2 x
    model=2), but RG-LRU's ``conv`` and ``h``: the reference replicates
    them over "model", here each cell holds its channels (the values are
    equal; ROADMAP Queue 3)."""
    _, ref = ref_mesh
    a = "rg" if arch == "recurrentgemma-2b" else "rw"
    cfg = registry.smoke_config(arch)
    cache = T.init_cache(cfg, 4, 16, mesh=_mesh("2x2"), serve_seq_shard=seq)
    flat = []
    for grp in cache["blocks"]:
        for pi in sorted(grp):
            flat += [(nm, grp[pi][nm].spec) for nm in sorted(grp[pi])]
    def norm(spec):
        """A spec with its one-axis entries as the axis name (a
        ``PartitionSpec`` spells ("data",) as "data")."""
        return tuple(e[0] if isinstance(e, (list, tuple)) and len(e) == 1 else
                     tuple(e) if isinstance(e, list) else e for e in spec)

    want = [(nm, norm(s)) for nm, s in json.loads(str(ref[f"{a}_cache_specs_{seq}"]))]
    assert [nm for nm, _ in flat] == [nm for nm, _ in want]
    for (nm, got), (_, exp) in zip(flat, want):
        got = norm(got)
        exp = exp + (None,) * (len(got) - len(exp))
        if nm in ("conv", "h"):
            assert got[:-1] == exp[:-1] and exp[-1] is None and got[-1] == "model", (nm, got)
        else:
            assert got == exp, (nm, got, exp)


# ---------------------------------------------------------------------------
# training: mesh against one device
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
            "mask": torch.from_numpy((rng.random((B, S)) < 0.8).astype(np.float32))}


def _seq_len(arch):
    """rwkv6 at 128 = 2 chunks of 64: the chunked WKV scan under grad."""
    return 128 if arch == "rwkv6-7b" else 16


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_loss_matches_single_device(arch, mesh_name):
    """Plain and fused, float32 (rel 1e-5), under the train policy."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh(mesh_name)
    pp = _params(arch)
    sp = shd.shard_params(cfg, pp, mesh, policy=shd.train_policy_for(cfg, mesh))
    b = _batch(cfg, 4, _seq_len(arch), 2)
    kw = dict(compute_dtype=torch.float32, loss_chunk=8)
    with _forward_at(torch.float32), torch.no_grad():
        one = lm.lm_loss(cfg, pp, b, **kw)
        plain = lm.lm_loss(cfg, sp, b, mesh=mesh, **kw)
        fused = lm.lm_loss(cfg, sp, b, mesh=mesh, fused_loss=True, **kw)
    assert plain.shape == () and plain.device == mesh.home
    assert float(plain) == pytest.approx(float(one), rel=LOSS_REL)
    assert float(fused) == pytest.approx(float(plain), rel=FUSED_REL)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_match_single_device_float64(arch, remat):
    """Float64: the loss within 1e-10 and every gradient within 1e-10 of
    its leaf's largest entry (a token counted twice, or a replicated
    block's gradient summed twice, would show)."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh("2x2")
    p64 = _params(arch, torch.float64)
    s64 = shd.shard_params(cfg, p64, mesh, policy=shd.train_policy_for(cfg, mesh))
    leaves, dl = T.tree_leaves(p64), lm._distinct_tensors(s64)
    for t in leaves + dl:
        t.requires_grad_(True)
    b = _batch(cfg, 4, _seq_len(arch), 3)
    kw = dict(compute_dtype=torch.float64, remat=remat)
    with _forward_at(torch.float64):
        one = lm.lm_loss(cfg, p64, b, **kw)
        g1 = torch.autograd.grad(one, leaves)
        got = lm.lm_loss(cfg, s64, b, mesh=mesh, **kw)
        g2 = lm._replica_sums(s64, list(torch.autograd.grad(got, dl)))
    assert abs(float(got) - float(one)) <= F64_TOL * abs(float(one))
    for i, (a, g) in enumerate(zip(g1, g2)):
        d = float((a - g.unshard()).abs().max())
        assert d <= F64_TOL * max(float(a.abs().max()), 1e-30), (i, d)


@pytest.mark.parametrize("arch,mesh_name,name,remat", [
    ("recurrentgemma-2b", "2x2", "adamw", True),
    ("recurrentgemma-2b", "2x4", "adafactor", False),
    ("rwkv6-7b", "2x2", "adamw", False),
    ("rwkv6-7b", "2x4", "adafactor", True),
])
def test_mesh_train_step_matches_single_device(arch, mesh_name, name, remat):
    """From the same state: float32 loss rel 1e-4, params atol 2.5e-3 rtol
    1e-3; float64 params and optimizer states within 1e-10."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh(mesh_name)
    oc = opt.OptConfig(name=name, lr=1e-3, weight_decay=0.01)
    init, _ = opt.make_optimizer(oc)
    b = _batch(cfg, 4, _seq_len(arch), 4)
    for dtype in (torch.float32, torch.float64):
        def state():
            pp = _params(arch, dtype)
            return lm.TrainState(pp, init(pp), torch.zeros((), dtype=torch.int32))
        st = state()
        sst = shd.shard_train_state(cfg, state(), mesh, shd.train_policy_for(cfg, mesh))
        kw = dict(remat=remat, compute_dtype=dtype)
        with _forward_at(dtype):
            s1, m1 = lm.make_train_step(cfg, oc, **kw)(st, b)
            s2, m2 = lm.make_train_step(cfg, oc, mesh=mesh, **kw)(sst, b)
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
        assert int(s2.step) == 1 and not any(t.requires_grad for t in
                                             lm._distinct_tensors(s2.params))


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_compress_step_is_finite_and_near_the_uncompressed_step(arch):
    """pod=2 x data=2 x model=2: the int8 pod sync runs (the grad norm
    moves) and the step stays within 2 lr of the uncompressed one."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh("2x2x2")
    oc = opt.OptConfig(name="adamw", lr=1e-3)
    b = _batch(cfg, 4, 16, 5)
    runs = []
    for pod in (False, True):
        pp = _params(arch)
        st = shd.shard_train_state(cfg, lm.TrainState(pp, opt.adam_init(pp),
                                                      torch.zeros((), dtype=torch.int32)),
                                   mesh, shd.train_policy_for(cfg, mesh))
        with _forward_at(torch.float32):
            runs.append(lm.make_train_step(cfg, oc, mesh=mesh, pod_compress=pod)(st, b))
    (s0, m0), (s1, m1) = runs
    assert math.isfinite(float(m1["loss"])) and torch.equal(m0["loss"], m1["loss"])
    assert float(m1["grad_norm"]) != float(m0["grad_norm"])
    d = max(float((a.unshard() - p.unshard()).abs().max()) for a, p in
            zip(T.tree_leaves(s0.params), T.tree_leaves(s1.params)))
    assert 0 < d <= 2 * oc.lr * (1 + 1e-3), d


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["2x2", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_mesh_forward_is_within_a_rounding_of_one_device(arch, mesh_name):
    """bf16 weights (``FLOAT32_LEAVES`` float32, as the engine keeps them),
    an 8-token train forward: the mesh's logits (its row-parallel partials
    each rounded to bf16 before their sum) are closer to one device's than
    one device's with every bf16 weight one ulp up: the recurrent archs at
    these weights amplify any rounding, and the mesh adds no more than a
    rounding."""
    cfg = registry.smoke_config(arch)
    mesh = _mesh(mesh_name)
    pb = T.tree_map(lambda n, t: t if n in T.FLOAT32_LEAVES else t.to(torch.bfloat16),
                    _params(arch))
    up = T.tree_map(lambda n, t: t if n in T.FLOAT32_LEAVES else
                    t.nextafter(t.new_full((), math.inf)), pb)
    toks = {"tokens": _tokens(cfg, 4, 8, 0)}
    with torch.no_grad():
        one, _ = T.forward(cfg, pb, toks, mode="train")
        ulp, _ = T.forward(cfg, up, toks, mode="train")
        got, _ = T.forward(cfg, shd.shard_params(cfg, pb, mesh), toks, mode="train", mesh=mesh)
    d_mesh = float((got.unshard().float() - one.float()).abs().max())
    d_ulp = float((ulp.float() - one.float()).abs().max())
    assert 0 < d_mesh < d_ulp <= MESH_BF16_REL * float(one.float().abs().max()), (d_mesh, d_ulp)


@pytest.mark.parametrize("arch,mesh_name", [("recurrentgemma-2b", "2x2"),
                                            ("recurrentgemma-2b", "2x2x2"),
                                            ("rwkv6-7b", "2x2"), ("rwkv6-7b", "2x4")])
def test_mesh_engine_matches_single_device_engine(arch, mesh_name):
    """bf16, 4 slots, the example's traffic (tests/test_torch_mesh_lm.py's
    comparison): logits within 0.5 x the one device's largest call by
    call, flips only at top-2 margins under 0.125 (rwkv6 0.375), pinned.  Admission runs the decode step, so it
    writes the slot's rows of every cache kind; no recurrent state or ring
    ``pos`` is reset.  Each cell holds the layout's bytes of the weights
    and of the cache."""
    from test_torch_mesh_lm import _logged_engine
    from test_torch_serving import _compare_calls, _requests, _resync_rule

    cfg = registry.smoke_config(arch)
    pp = _params(arch)
    mesh = _mesh(mesh_name)
    log1, log2 = [], []
    e1 = _logged_engine(cfg, pp, log1, device="cpu")
    e2 = _logged_engine(cfg, pp, log2, mesh=mesh)
    r1, r2 = _requests(engine.Request, cfg), _requests(engine.Request, cfg)
    for a, b in zip(r1, r2):
        e1.submit(a)
        e2.submit(b)
    e1.run()
    e2.run()
    scale = max(float(np.abs(rec[4]).max()) for rec in log1)
    flips, skipped = _compare_calls(log1, log2, 4, _resync_rule(cfg), (
        MESH_BF16_REL * scale, NEAR_TIE_ARCH.get(arch, MESH_NEAR_TIE)))
    assert [f[:3] for f in flips] == MESH_FLIPS.get((arch, mesh_name), []), flips
    for a, b in zip(r1, r2):
        assert len(b.out) == 12
        if a.rid not in skipped:
            assert a.out == b.out, (a.rid, a.out, b.out)
    assert torch.equal(e1.lengths, e2.lengths)
    for tree in (e2.params, e2.cache):
        assert shd.cell_bytes(tree, mesh) == shd.layout_bytes(tree, mesh)
    # the recurrent states stay float32 on every cell, the rest of the cache bf16
    for leaf, one in zip(T.tree_leaves(e2.cache), T.tree_leaves(e1.cache)):
        assert leaf.dtype == one.dtype
