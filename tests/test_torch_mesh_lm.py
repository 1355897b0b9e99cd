"""Mesh LM serving in the port (``repro_torch.distributed.{sharding,
flash_decode, cache_update}``, the expert-parallel ``moe_ffn``,
``forward(mesh=)``, the steps and ``ServeEngine(mesh=)``) on meshes of CPU
cells.

- The policy tables and the spec trees of every arch equal the
  reference's (``repro.distributed.sharding``, ``repro.launch.builders``).
- ``shard_tree`` / ``unshard_tree`` round trips are bit-equal.
- ``flash_decode``, ``flash_decode_update`` (sequence and kv layouts, with
  a window), ``cache_write`` and the EP ``moe_ffn`` (with drops) are held
  against the reference's own mesh functions, run once in a subprocess on
  8 forced host devices (tests/test_distributed.py's ``run_script``):
  1e-4 (tests/test_distributed.py:135), bit-equal, and 2e-4
  (tests/test_distributed.py:159).
- Mesh prefill and decode of the six dense smoke configs and olmoe's (at a
  capacity that drops nothing) against the single-device port: float32
  within 1e-4, float64 within 1e-10.
- ``ServeEngine(mesh=)`` in bf16 against the single-device engine call by
  call (tests/test_torch_serving.py's ``_compare_calls``), flips pinned.
- What stays unported raises naming ROADMAP item 13f.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.launch import builders as RB  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.cache_update import cache_write  # noqa: E402
from repro_torch.distributed.flash_decode import flash_decode, flash_decode_update  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

FLASH_TOL = 1e-4                # tests/test_distributed.py:135
MOE_TOL = 2e-4                  # tests/test_distributed.py:159
FWD_TOL = 1e-4                  # tests/test_torch_lm.py
F64_TOL = 1e-10
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
DENSE = ["phi3-mini-3.8b", "qwen3-4b", "qwen1.5-4b", "mistral-large-123b",
         "musicgen-medium", "internvl2-26b"]
FWD_ARCHS = DENSE + ["olmoe-1b-7b"]
#: bf16 engines, mesh against one device: the mesh decode rounds its
#: scores to bf16 as the reference's mesh decode does
#: (src/repro/distributed/flash_decode.py:167-172), the single device keeps
#: them float32 (src/repro/models/layers.py:194-195), and the row-parallel
#: sums add in another order.  With float32 mesh scores the largest logit
#: difference on these runs falls from 0.45 to 0.25 (mistral-large) and
#: from 0.30 to 0.125 (phi3-mini); qwen3's qk-norm keeps its scores small
#: (0.02).  Largest measured: 0.453 and a flip margin of 0.086
MESH_LOGIT_TOL = 0.5
MESH_NEAR_TIE = 0.125
#: the near-tie flips of the mesh engine against the single-device one
#: (decode call, slot, request), per (arch, mesh, serve_seq_shard); a
#: margin of 0.0 is a tie in the single device's bf16 logits
MESH_FLIPS = {("phi3-mini-3.8b", "2x2", False): [(32, 1, 1), (34, 2, 2), (46, 0, 4), (60, 1, 5)],
              ("qwen3-4b", "2x2", True): [(17, 2, 2), (44, 0, 4)],
              ("mistral-large-123b", "2x2x2", False): [(12, 1, 1), (46, 1, 5), (52, 0, 4),
                                                       (56, 2, None), (60, 3, None)],
              ("olmoe-1b-7b", "2x2", False): [(30, 1, 1)]}


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


class _RefMesh:
    """What the reference's builders read of a mesh: its axes and shape."""

    def __init__(self, name):
        shape, axes = MESHES[name]
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    cf = float(math.ceil(cfg.moe.n_experts / cfg.moe.top_k))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _spec_leaves(tree, path=""):
    """(path, spec) of a spec tree in sorted-key order."""
    if isinstance(tree, tuple):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], f"{path}/{k}")]
    return [x for i, v in enumerate(tree) for x in _spec_leaves(v, f"{path}/{i}")]


def _ref_spec_leaves(tree):
    from jax.sharding import PartitionSpec as P

    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return [tuple(p) for _, p in flat]


# ---------------------------------------------------------------------------
# policy tables and spec trees
# ---------------------------------------------------------------------------

def test_policy_tables_match_reference():
    for mesh_name in MESHES:
        m, rm = _mesh(mesh_name), _RefMesh(mesh_name)
        assert shd.dp_axes(m) == RS.dp_axes(rm)
        for th, tk, fsdp in itertools.product((False, True), repeat=3):
            ours = shd.train_policy(m, tp_heads=th, tp_kv=tk, fsdp=fsdp)
            ref = RS.train_policy(rm, tp_heads=th, tp_kv=tk, fsdp=fsdp)
            assert (dict(ours.rules), ours.name) == (dict(ref.rules), ref.name)
        for th, tk, m2, seq in itertools.product((False, True), repeat=4):
            ours = shd.serve_policy(m, tp_heads=th, tp_kv=tk, mlp_2d=m2, seq_shard_cache=seq)
            ref = RS.serve_policy(rm, tp_heads=th, tp_kv=tk, mlp_2d=m2, seq_shard_cache=seq)
            assert (dict(ours.rules), ours.name) == (dict(ref.rules), ref.name)
    pol = shd.serve_policy(None, tp_heads=True, tp_kv=True)
    rpol = RS.serve_policy(None, tp_heads=True, tp_kv=True)
    o, r = pol.with_overrides(name="x", ff=None, vocab=("data", "model")), \
        rpol.with_overrides(name="x", ff=None, vocab=("data", "model"))
    assert (dict(o.rules), o.name) == (dict(r.rules), r.name)
    assert o.spec(("vocab", None, "ff")) == tuple(r.spec(("vocab", None, "ff")))
    for dp in (None, "data", ("pod", "data"), ("data", "model"), (("data", "model"),)):
        assert shd.vocab_axis(dp) == RS.vocab_axis(dp)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_spec_trees_match_reference(arch):
    """``logical_axes_tree`` and ``tree_specs`` under the serve policy the
    builders pick (``serve_policy_for``, every flag) and the train policy,
    on every mesh, leaf for leaf."""
    spec, rspec = registry.get_arch(arch), ref_registry.get_arch(arch)
    cfg, rcfg = spec.model, rspec.model
    axes = T.logical_axes_tree(cfg)
    raxes = RT.logical_axes_tree(rcfg)
    assert [a for _, a in _spec_leaves(axes)] == _ref_spec_leaves_tuples(raxes)
    for mesh_name in MESHES:
        m, rm = _mesh(mesh_name), _RefMesh(mesh_name)
        for m2, seq in itertools.product((False, True), repeat=2):
            ours = shd.tree_specs(axes, shd.serve_policy_for(cfg, m, mlp_2d=m2,
                                                             seq_shard_cache=seq))
            rs = dataclasses.replace(rspec, serve_mlp_2d=m2, serve_seq_shard=seq)
            ref = RS.tree_specs(raxes, RB._serve_policy(rs, rm))
            assert [s for _, s in _spec_leaves(ours)] == _ref_spec_leaves(ref)
        tp = m.shape["model"]
        ours = shd.tree_specs(axes, shd.train_policy(
            m, tp_heads=cfg.padded_heads % tp == 0 and cfg.padded_heads >= tp,
            tp_kv=cfg.n_kv % tp == 0, fsdp=spec.fsdp))
        assert [s for _, s in _spec_leaves(ours)] == _ref_spec_leaves(
            RS.tree_specs(raxes, RB._train_policy(rspec, rm)))


def _ref_spec_leaves_tuples(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    return [tuple(a) for _, a in flat]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_tree_round_trip_is_bit_equal(mesh_name):
    mesh = _mesh(mesh_name)
    for arch, dtype in (("qwen3-4b", torch.float32), ("olmoe-1b-7b", torch.bfloat16),
                        ("musicgen-medium", torch.float64)):
        cfg = registry.smoke_config(arch)
        pp = T.init_params(cfg, torch.Generator().manual_seed(1), dtype=dtype)
        for seq in (False, True):
            sp = shd.shard_params(cfg, pp, mesh, serve_seq_shard=seq)
            back = shd.unshard_tree(sp)
            assert all(torch.equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(T.tree_leaves(pp), T.tree_leaves(back)))
            per_cell = shd.cell_bytes(sp, mesh)
            assert per_cell == shd.layout_bytes(sp, mesh)
            total = sum(t.numel() * t.element_size() for t in T.tree_leaves(pp))
            tp = mesh.shape["model"]
            assert total // tp <= per_cell[0] < total
            # one card holds every block once: the whole tree
            assert shd.device_bytes(sp) == {torch.device("cpu"): total}
    x = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    for spec in ((None, "model", None), (shd.dp_axes(mesh), None, "model"),
                 (None, ("data", "model"), None)):
        s = shd.shard(x, spec, mesh)
        assert torch.equal(s.unshard(), x)
        # cast block by block on the cells, as the mesh engine lays out its weights
        s16 = shd.shard(x, spec, mesh, torch.bfloat16)
        assert s16.dtype == torch.bfloat16 and torch.equal(s16.unshard(), x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="split"):
        shd.shard(torch.zeros(3, 4), ("model", None), mesh)
    with pytest.raises(ValueError, match="axis"):
        shd.shard(torch.zeros(4, 4), ("expert", None), mesh)


# ---------------------------------------------------------------------------
# the primitives against the reference's own mesh functions
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
import jax, numpy as np, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.models import layers as L
from repro.models import moe as moe_mod
from repro.distributed.flash_decode import flash_decode, flash_decode_update
from repro.distributed.cache_update import cache_write

inp = dict(np.load({inp!r}))
res = {{}}
m24 = make_mesh((2, 4), ('data', 'model'))
m222 = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
a = {{k: jnp.asarray(v) for k, v in inp.items()}}
res['fd'] = np.asarray(jax.jit(lambda q, k, v, l: flash_decode(q, k, v, l, mesh=m24))(
    a['q'], a['kc'], a['vc'], a['len_fd']))
res['fd_local'] = np.asarray(L.attention_decode(a['q'], a['kc'], a['vc'], a['len_fd']))
for w in (None, 8):
    o, kc, vc = jax.jit(lambda *x: flash_decode_update(
        *x, mesh=m24, dp=('data',), seq_axis='model', kv_axis=None, window=w))(
        a['q'], a['kc'], a['vc'], a['kn'], a['vn'], a['len_up'])
    res[f'seq_{{w}}_o'], res[f'seq_{{w}}_k'], res[f'seq_{{w}}_v'] = map(np.asarray, (o, kc, vc))
b16 = [x.astype(jnp.bfloat16) for x in (a['q'], a['kc'], a['vc'], a['kn'], a['vn'])]
o, kc, vc = jax.jit(lambda *x: flash_decode_update(
    *x, mesh=m24, dp=('data',), seq_axis='model', kv_axis=None))(*b16, a['len_up'])
res['bf16_o'], res['bf16_k'] = (np.asarray(t.astype(jnp.float32)) for t in (o, kc))
o, kc, vc = jax.jit(lambda *x: flash_decode_update(
    *x, mesh=m24, dp=('data',), seq_axis=None, kv_axis='model'))(
    a['q'], a['kc4'], a['vc4'], a['kn4'], a['vn4'], a['len_up'])
res['kv_o'], res['kv_k'], res['kv_v'] = map(np.asarray, (o, kc, vc))
for name, mesh, dp in (('24', m24, ('data',)), ('222', m222, ('pod', 'data'))):
    res[f'cw_seq_{{name}}'] = np.asarray(jax.jit(lambda k, n, l: cache_write(
        k, n, l, mesh=mesh, dp=dp, seq_axis='model'))(a['kc'], a['kn'], a['len_cw']))
    res[f'cw_kv_{{name}}'] = np.asarray(jax.jit(lambda k, n, l: cache_write(
        k, n, l, mesh=mesh, dp=dp, kv_axis='model'))(a['kc4'], a['kn4'], a['len_cw']))
res['cw_none'] = np.asarray(cache_write(a['kc'], a['kn'], a['len_cw']))
params = {{k: a['moe_' + k] for k in ('router', 'w_gate', 'w_up', 'w_down')}}
for cf in (1.25, 100.0):
    cfg = moe_mod.MoEConfig(n_experts=8, top_k=2, capacity_factor=cf)
    for name, mesh in (('24', m24), ('222', m222)):
        res[f'moe_{{cf}}_{{name}}'] = np.asarray(jax.jit(
            lambda p, x: moe_mod.moe_ffn(p, x, cfg, mesh=mesh))(params, a['moe_x']))
    res[f'moe_{{cf}}_single'] = np.asarray(moe_mod.moe_ffn(params, a['moe_x'], cfg))
np.savez({out!r}, **res)
print('OK')
"""


@pytest.fixture(scope="module")
def prim(tmp_path_factory):
    """The primitives' inputs (numpy, seed 0) and the reference's results
    on 8 forced host devices."""
    from test_distributed import run_script

    rng = np.random.default_rng(0)
    B, S, H, dh = 4, 64, 8, 16

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    inp = {"q": rn(B, H, dh), "kc": rn(B, S, 2, dh), "vc": rn(B, S, 2, dh),
           "kn": rn(B, 2, dh), "vn": rn(B, 2, dh),
           "kc4": rn(B, S, 4, dh), "vc4": rn(B, S, 4, dh), "kn4": rn(B, 4, dh),
           "vn4": rn(B, 4, dh),
           # row 1: slices 1-3 of 4 wholly masked; row 3: one position
           "len_fd": np.array([64, 10, 33, 1], np.int32),
           "len_up": np.array([63, 10, 33, 0], np.int32),
           # 64: a write past the end, dropped
           "len_cw": np.array([64, 10, 33, 0], np.int32),
           "moe_router": rn(8, 8), "moe_w_gate": rn(8, 8, 16, scale=0.2),
           "moe_w_up": rn(8, 8, 16, scale=0.2), "moe_w_down": rn(8, 16, 8, scale=0.2),
           "moe_x": rn(2, 32, 8)}
    d = tmp_path_factory.mktemp("mesh_ref")
    np.savez(d / "inp.npz", **inp)
    run_script(_REF_SCRIPT.format(inp=str(d / "inp.npz"), out=str(d / "ref.npz")))
    return {k: torch.from_numpy(v) for k, v in inp.items()}, dict(np.load(d / "ref.npz"))


def _close(a, b, tol):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.mesh
def test_flash_decode_matches_reference_mesh(prim):
    inp, ref = prim
    got = flash_decode(inp["q"], inp["kc"], inp["vc"], inp["len_fd"], mesh=_mesh("2x4"))
    _close(got, ref["fd"], FLASH_TOL)
    _close(got, ref["fd_local"], FLASH_TOL)
    local = L.attention_decode(inp["q"], inp["kc"], inp["vc"], inp["len_fd"])
    _close(got, local.numpy(), FLASH_TOL)
    # every cell of a length-0 row is masked: zeros, not NaN
    z = flash_decode(inp["q"], inp["kc"], inp["vc"], torch.zeros(4, dtype=torch.int32),
                     mesh=_mesh("2x4"))
    assert torch.equal(z, torch.zeros_like(z))


@pytest.mark.mesh
@pytest.mark.parametrize("layout,window", [("seq", None), ("seq", 8), ("kv", None)])
def test_flash_decode_update_matches_reference_mesh(prim, layout, window):
    inp, ref = prim
    sfx = "" if layout == "seq" else "4"
    kw = dict(seq_axis="model", kv_axis=None) if layout == "seq" else \
        dict(seq_axis=None, kv_axis="model")
    o, kc, vc = flash_decode_update(
        inp["q"], inp["kc" + sfx].clone(), inp["vc" + sfx].clone(), inp["kn" + sfx],
        inp["vn" + sfx], inp["len_up"], mesh=_mesh("2x4"), dp=("data",), window=window, **kw)
    key = f"seq_{window}" if layout == "seq" else "kv"
    _close(o.unshard(), ref[key + "_o"], FLASH_TOL)
    assert np.array_equal(kc.unshard().numpy(), ref[key + "_k"])
    assert np.array_equal(vc.unshard().numpy(), ref[key + "_v"])
    # against the single-device decode on the cache the reference wrote
    k1, v1 = (torch.from_numpy(ref[key + s]) for s in ("_k", "_v"))
    _close(o.unshard(), L.attention_decode(inp["q"], k1, v1, inp["len_up"] + 1,
                                           window=window).numpy(), FLASH_TOL)


@pytest.mark.mesh
def test_bf16_flash_decode_update_matches_reference_mesh(prim):
    """In bf16 the port's mesh decode is the reference's mesh arithmetic,
    bit for bit: scores and values at the cache's dtype, softmax
    statistics in float32."""
    inp, ref = prim
    b16 = {k: inp[k].to(torch.bfloat16) for k in ("q", "kc", "vc", "kn", "vn")}
    o, kc, _ = flash_decode_update(b16["q"], b16["kc"], b16["vc"], b16["kn"], b16["vn"],
                                   inp["len_up"], mesh=_mesh("2x4"), dp=("data",),
                                   seq_axis="model")
    assert np.array_equal(kc.unshard().float().numpy(), ref["bf16_k"])
    assert np.array_equal(o.unshard().float().numpy(), ref["bf16_o"])


@pytest.mark.mesh
@pytest.mark.parametrize("mesh_name", ["2x4", "2x2x2"])
def test_cache_write_matches_reference_mesh_bit_for_bit(prim, mesh_name):
    inp, ref = prim
    mesh = _mesh(mesh_name)
    dp = shd.dp_axes(mesh)
    name = mesh_name.replace("x", "")
    got = cache_write(inp["kc"].clone(), inp["kn"], inp["len_cw"], mesh=mesh, dp=dp,
                      seq_axis="model")
    assert np.array_equal(got.unshard().numpy(), ref[f"cw_seq_{name}"])
    got = cache_write(inp["kc4"].clone(), inp["kn4"], inp["len_cw"], mesh=mesh, dp=dp,
                      kv_axis="model")
    assert np.array_equal(got.unshard().numpy(), ref[f"cw_kv_{name}"])
    plain = cache_write(inp["kc"].clone(), inp["kn"], inp["len_cw"])
    assert np.array_equal(plain.numpy(), ref["cw_none"])


@pytest.mark.mesh
@pytest.mark.parametrize("cf", [1.25, 100.0])
def test_ep_moe_matches_reference_mesh(prim, cf):
    """At the default capacity pairs drop, by each data shard's own count
    (its capacity follows the local tokens); at capacity factor 100 none
    does, and the mesh equals the single device."""
    inp, ref = prim
    params = {k: inp["moe_" + k] for k in ("router", "w_gate", "w_up", "w_down")}
    cfg = moe_mod.MoEConfig(n_experts=8, top_k=2, capacity_factor=cf)
    single = moe_mod.moe_ffn(params, inp["moe_x"], cfg)
    _close(single, ref[f"moe_{cf}_single"], MOE_TOL)
    for name in ("2x4", "2x2x2"):
        got = moe_mod.moe_ffn(params, inp["moe_x"], cfg, mesh=_mesh(name))
        _close(got, ref[f"moe_{cf}_{name.replace('x', '')}"], MOE_TOL)
        if cf == 100.0:
            _close(got, single.numpy(), MOE_TOL)
    if cf == 1.25:   # drops: the data-split mesh routes other pairs than one device
        assert not np.allclose(ref["moe_1.25_24"], ref["moe_1.25_single"], atol=MOE_TOL)


# ---------------------------------------------------------------------------
# forward and steps against the single-device port
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, rng):
    if cfg.frontend:
        return {"embeds": torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                                           .astype(np.float32))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}


def _step_input(cfg, tok, B, rng):
    if cfg.frontend:
        return torch.from_numpy(rng.standard_normal((B, cfg.d_model)).astype(np.float32))
    return tok


def _prefill_and_decode(cfg, pp, mesh, seq, dtype, B=4, S=8, steps=3, seed=0):
    """Prefill (cache padded to S + 8) and ``steps`` decode steps on one
    device and on the mesh, from the same inputs; returns the largest
    logit and cache differences and whether every token agreed."""
    rng = np.random.default_rng(seed)
    kw = dict(compute_dtype=dtype)
    sp = shd.shard_params(cfg, pp, mesh, serve_seq_shard=seq)
    batch = _batch(cfg, B, S, rng)
    l1, _ = T.forward(cfg, pp, batch, mode="prefill", **kw)
    l2, _ = T.forward(cfg, sp, batch, mode="prefill", mesh=mesh, serve_seq_shard=seq, **kw)
    d_logit = (l1 - l2.unshard()).abs().max().item()
    t1, c1 = lm.make_prefill_step(cfg, max_seq=S + 8, **kw)(pp, batch)
    t2, c2 = lm.make_prefill_step(cfg, max_seq=S + 8, mesh=mesh, serve_seq_shard=seq,
                                  **kw)(sp, batch)
    equal = torch.equal(t1, t2)
    dec1 = lm.make_decode_step(cfg, **kw)
    dec2 = lm.make_decode_step(cfg, mesh=mesh, serve_seq_shard=seq, **kw)
    lens = torch.tensor([S, S - 3, S - 1, 2][:B], dtype=torch.int32)
    tok = t1
    for _ in range(steps):
        x = _step_input(cfg, tok, B, rng)
        g1, _ = T.forward(cfg, pp, {"tokens" if x.dtype == torch.int32 else "embeds":
                                    x[:, None]}, mode="decode", lengths=lens,
                          cache=T.tree_map(lambda _, t: t.clone(), c1), **kw)
        g2, _ = T.forward(cfg, sp, {"tokens" if x.dtype == torch.int32 else "embeds":
                                    x[:, None]}, mode="decode", lengths=lens, mesh=mesh,
                          serve_seq_shard=seq,
                          cache=T.tree_map(lambda _, t: t.map(torch.clone), c2), **kw)
        d_logit = max(d_logit, (g1 - g2.unshard()).abs().max().item())
        a1, c1, lens1 = dec1(pp, c1, x, lens)
        a2, c2, lens2 = dec2(sp, c2, x, lens)
        equal &= torch.equal(a1, a2) and torch.equal(lens1, lens2)
        tok, lens = a1, lens1
    d_cache = max((a - b).abs().max().item() for a, b in
                  zip(T.tree_leaves(c1), T.tree_leaves(shd.unshard_tree(c2))))
    return d_logit, d_cache, equal


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_mesh_prefill_and_decode_match_single_device(arch, mesh_name):
    """Float32 within 1e-4 and float64 within 1e-10, greedy tokens equal,
    with the cache's sequence or its kv heads over "model"; B=4 splits over
    the data axes, B=3 is replicated."""
    cfg = _no_drop(registry.smoke_config(arch))
    mesh = _mesh(mesh_name)
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    report = {}
    for seq, B in ((False, 4), (True, 4), (False, 3)):
        d, dc, eq = _prefill_and_decode(cfg, pp, mesh, seq, torch.float32, B=B)
        report[(seq, B, "f32")] = (d, dc)
        assert d <= FWD_TOL and dc <= FWD_TOL and eq, report
    pp64 = T.tree_map(lambda _, t: t.double(), pp)
    d, dc, eq = _prefill_and_decode(cfg, pp64, mesh, mesh_name == "2x2", torch.float64)
    assert d <= F64_TOL and dc <= F64_TOL and eq, (d, dc)


def test_mesh_decode_reads_a_bf16_cache_at_the_compute_dtype():
    """A float32 decode over a bf16 cache (as the single-device port and
    the reference read it: the cache cast to the compute dtype), written
    in place in bf16."""
    cfg = registry.smoke_config("qwen3-4b")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    for mesh_name, seq in (("2x2", False), ("2x4", True)):
        mesh = _mesh(mesh_name)
        sp = shd.shard_params(cfg, pp, mesh, serve_seq_shard=seq)
        c1 = T.init_cache(cfg, 4, 16, torch.bfloat16, device="cpu")
        c2 = T.init_cache(cfg, 4, 16, torch.bfloat16, mesh=mesh, serve_seq_shard=seq)
        kw = dict(compute_dtype=torch.float32)
        d1 = lm.make_decode_step(cfg, **kw)
        d2 = lm.make_decode_step(cfg, mesh=mesh, serve_seq_shard=seq, **kw)
        tok = torch.tensor([3, 7, 11, 5], dtype=torch.int32)
        lens = torch.tensor([0, 2, 5, 15], dtype=torch.int32)
        for _ in range(3):
            a1, c1, l1 = d1(pp, c1, tok, lens)
            a2, c2, _ = d2(sp, c2, tok, lens)
            assert torch.equal(a1, a2)
            tok, lens = a1, l1
        # float32 keys and values a rounding apart, stored in bf16: one ulp
        assert all(b.dtype == torch.bfloat16 and torch.allclose(
            a.float(), b.float(), atol=FWD_TOL, rtol=2.0 ** -7)
            for a, b in zip(T.tree_leaves(c1), T.tree_leaves(shd.unshard_tree(c2))))


def test_mesh_argmax_picks_the_lowest_index_on_a_tie():
    mesh = _mesh("2x4")
    from repro_torch.models import mesh_forward

    x = torch.zeros(4, 1, 32)
    x[0, 0, [3, 20]] = 5.0           # a tie across cells: the lower wins
    x[1, 0, [9, 10]] = 2.0           # within one cell
    x[2, 0, 31] = 1.0
    got = mesh_forward.argmax(shd.shard(x, (("data",), None, "model"), mesh))
    assert torch.equal(got, torch.argmax(x, dim=-1))
    assert torch.equal(mesh_forward.argmax(shd.shard(x, (None, None, "model"), mesh)),
                       torch.argmax(x, dim=-1))


def test_padded_heads_stay_zero_on_every_cell():
    """qwen1.5's heads padded 20 -> 32 (``head_pad_to=16``): every cell's
    block of the padded heads' ``wq``/``bq``/``wo`` slices is zero."""
    cfg = dataclasses.replace(registry.smoke_config("qwen1.5-4b"), n_heads=20, n_kv=20,
                              head_pad_to=16, d_model=40, d_head=2)
    assert cfg.padded_heads == 32
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    mesh = _mesh("2x4")
    sp = shd.shard_params(cfg, pp, mesh)
    blk = sp["blocks"][0]["0"]
    for c in range(mesh.size):
        for name, dim in (("wq", 2), ("bq", 1), ("wo", 1)):
            t, h0 = blk[name].cells[c], blk[name].offset(c, dim)
            pad = torch.arange(t.shape[dim]) + h0 >= cfg.n_heads
            assert torch.count_nonzero(t.index_select(dim, torch.nonzero(pad)[:, 0])) == 0
    d, dc, eq = _prefill_and_decode(cfg, pp, mesh, False, torch.float32)
    assert d <= FWD_TOL and dc <= FWD_TOL and eq


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _logged_engine(cfg, pp, log, **kw):
    """A ``ServeEngine`` whose decode calls are recorded as
    test_torch_serving.py's ``_engines`` records them."""
    eng = engine.ServeEngine(cfg, pp, n_slots=4, max_seq=48, **kw)
    dec = eng._decode
    mesh = kw.get("mesh")

    def logged(p, c, t, ln):
        rec = ([None if r is None else r.rid for r in eng.slot_req], t.numpy().copy(),
               ln.numpy().copy())
        clone = T.tree_map(lambda _, a: a.map(torch.clone) if mesh is not None else a.clone(), c)
        lg = T.forward(cfg, p, {"tokens": t[:, None]}, mode="decode", cache=clone, lengths=ln,
                       mesh=mesh, serve_seq_shard=kw.get("serve_seq_shard", False))[0]
        lg = (lg.unshard() if mesh is not None else lg)[:, 0].float().numpy()
        n, c2, l2 = dec(p, c, t, ln)
        log.append(rec + (n.numpy().copy(), lg))
        return n, c2, l2

    eng._decode = logged
    return eng


@pytest.mark.parametrize("arch,mesh_name,seq", [
    ("phi3-mini-3.8b", "2x2", False), ("qwen3-4b", "2x2", True),
    ("mistral-large-123b", "2x2x2", False), ("olmoe-1b-7b", "2x2", False)])
def test_mesh_engine_matches_single_device_engine(arch, mesh_name, seq):
    """bf16, 4 slots (split over the data axes), the example's traffic:
    call by call the same requests, lengths and inputs, logits within
    ``MESH_LOGIT_TOL``, the same token unless the single device's top-2
    margin is under ``MESH_NEAR_TIE`` (a flip, pinned in ``MESH_FLIPS``); a
    MoE at a capacity that drops nothing (each data shard counts its own)."""
    from test_torch_serving import _compare_calls, _requests, _resync_rule

    cfg = _no_drop(registry.smoke_config(arch))
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    log1, log2 = [], []
    e1 = _logged_engine(cfg, pp, log1, device="cpu")
    e2 = _logged_engine(cfg, pp, log2, mesh=_mesh(mesh_name), serve_seq_shard=seq)
    r1, r2 = _requests(engine.Request, cfg), _requests(engine.Request, cfg)
    for a, b in zip(r1, r2):
        e1.submit(a)
        e2.submit(b)
    e1.run()
    e2.run()
    flips, skipped = _compare_calls(log1, log2, 4, _resync_rule(cfg),
                                    (MESH_LOGIT_TOL, MESH_NEAR_TIE))
    assert [f[:3] for f in flips] == MESH_FLIPS.get((arch, mesh_name, seq), []), flips
    for a, b in zip(r1, r2):
        assert len(b.out) == 12
        if a.rid not in skipped:
            assert a.out == b.out, (a.rid, a.out, b.out)
    assert torch.equal(e1.lengths, e2.lengths)
    # the leaves the forward reads in float32 stay float32 on every cell
    assert all(T.tree_leaves(T.tree_map(
        lambda n, t: all((c.dtype == torch.float32) == (n in T.FLOAT32_LEAVES)
                         for c in t.cells), e2.params)))


# ---------------------------------------------------------------------------
# what stays unported
# ---------------------------------------------------------------------------

def test_what_stays_unported_raises_naming_13f():
    mesh = _mesh("2x2")
    cfg = registry.smoke_config("phi3-mini-3.8b")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    sp = shd.shard_params(cfg, pp, mesh)
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="13f"):
        T.forward(cfg, sp, batch, mode="train", mesh=mesh)
    with pytest.raises(NotImplementedError, match="13f"):
        lm.make_train_step(cfg, lm.opt_mod.OptConfig(), mesh=mesh)
    with pytest.raises(NotImplementedError, match="13f"):
        lm.lm_loss(cfg, pp, dict(batch, labels=batch["tokens"]), mesh=mesh)
    with pytest.raises(NotImplementedError, match="13f"):
        T.forward(cfg, sp, batch, mode="prefill", mesh=mesh, return_hidden=True)
    # the mlp_2d layout: the FFN split over (data, model)
    sp2 = shd.shard_tree(pp, shd.tree_specs(T.logical_axes_tree(cfg), shd.serve_policy_for(
        cfg, mesh, mlp_2d=True)), mesh)
    with pytest.raises(NotImplementedError, match="13f"):
        T.forward(cfg, sp2, batch, mode="prefill", mesh=mesh)
    with pytest.raises(NotImplementedError, match="13f"):
        moe_mod.moe_ffn({}, torch.zeros(1, 1, 4), moe_mod.MoEConfig(4, 2), fsdp_gather=True)
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        rcfg = registry.smoke_config(arch)
        rp = T.init_params(rcfg, torch.Generator().manual_seed(0))
        for call in (lambda: engine.ServeEngine(rcfg, rp, mesh=mesh),
                     lambda: lm.make_decode_step(rcfg, mesh=mesh),
                     lambda: lm.make_prefill_step(rcfg, mesh=mesh),
                     lambda: T.init_cache(rcfg, 2, 8, mesh=mesh)):
            with pytest.raises(NotImplementedError, match="13f"):
                call()
    # no silent fallback: unsharded parameters on a mesh are refused
    with pytest.raises(TypeError, match="shard_params"):
        T.forward(cfg, pp, batch, mode="prefill", mesh=mesh)
    with pytest.raises(ValueError, match="split"):
        lm.make_prefill_step(cfg, mesh=mesh, serve_seq_shard=True, max_seq=13)
    with pytest.raises(ValueError, match="stacked"):
        T.init_cache(cfg, 2, 8, mesh=mesh, stacked=False)
