"""The port's LM substrate (``repro_torch.configs``, ``repro_torch.models``)
against the reference's (``repro.configs``, ``repro.models``) on the CPU.

Inputs come from numpy seeds; the reference's weights are injected through
``params_from_numpy``.  Tolerances: the layers at the reference's own 3e-5
(``tests/test_attention.py``), ``rope`` at 1e-4; whole forwards in float32
compute at 1e-4 absolute and relative (two or three layers of float32
products summed in another order; the largest difference seen over these
configs is 4.1e-5, on a cached key), the MoE, RG-LRU and RWKV6 archs
included (their blocks are held alone in ``tests/test_torch_rnn_moe.py``).

A MoE's capacity is the reference's arithmetic on the token count, so a
decode step of B tokens drops other pairs than a forward of B*S tokens;
the consistency tests run MoE configs at ``capacity_factor =
ceil(E / k)``, where no pair drops (``_no_drop``).
"""
import math
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ATTN_TOL = 3e-5                 # tests/test_attention.py:34-75
ROPE_TOL = 1e-4                 # tests/test_attention.py:97-99
FWD_TOL = 1e-4
DENSE = ["phi3-mini-3.8b", "qwen3-4b", "qwen1.5-4b", "mistral-large-123b",
         "musicgen-medium", "internvl2-26b"]
OTHER = {"olmoe-1b-7b": "moe", "moonshot-v1-16b-a3b": "moe",
         "recurrentgemma-2b": "rglru", "rwkv6-7b": "rwkv"}
TOKEN = DENSE + sorted(OTHER)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this file's smoke-size tensors: as fast alone,
    and the suite's workers share the machine's cores (spinning thread
    pools slow every worker down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_drop(cfg):
    """``cfg`` with a capacity at which no MoE pair drops (capacity >= the
    token count); other configs as they are."""
    if cfg.moe is None:
        return cfg
    cf = float(math.ceil(cfg.moe.n_experts / cfg.moe.top_k))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, B, S, H, KV, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,KV,cq,skip,window", [
    (32, 4, 1, 8, False, None), (64, 8, 2, 16, True, None),
    (64, 8, 4, 32, False, None), (64, 4, 4, 16, True, 8), (64, 4, 2, 16, False, 24)])
def test_attention_full_and_chunked_match_reference(S, H, KV, cq, skip, window):
    q, k, v = _qkv(S + H, 2, S, H, KV, 8)
    full = L.attention_full(_t(q), _t(k), _t(v), causal=True, window=window)
    chunked = L.attention_chunked(_t(q), _t(k), _t(v), causal=True, window=window,
                                  chunk_q=cq, chunk_kv=cq, causal_skip=skip)
    ref = RL.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    ref_c = RL.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                 chunk_q=cq, chunk_kv=cq, causal_skip=skip)
    np.testing.assert_allclose(full.numpy(), _np(ref), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(chunked.numpy(), _np(ref_c), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_decode_matches_reference(window):
    q, k, v = _qkv(1, 2, 48, 8, 2, 16)
    lengths = np.array([48, 19], np.int32)
    kc = np.pad(k, ((0, 0), (0, 16), (0, 0), (0, 0)))
    vc = np.pad(v, ((0, 0), (0, 16), (0, 0), (0, 0)))
    out = L.attention_decode(_t(q[:, -1]), _t(kc), _t(vc), _t(lengths), window=window)
    ref = RL.attention_decode(jnp.asarray(q[:, -1]), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(lengths), window=window)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATTN_TOL, rtol=ATTN_TOL)
    full = L.attention_full(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(out[0].numpy(), full[0, -1].numpy(), atol=ATTN_TOL)


def test_attention_bf16_bit_equal_to_reference():
    """bf16 in, bf16 out: scores rounded to bf16 in ``attention_full``,
    float32-accumulated in ``attention_decode``, as the reference."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(3, 2, 24, 8, 2, 16))
    tq, tk, tv = (_t(_np(a)).to(torch.bfloat16) for a in (q, k, v))
    assert np.array_equal(_np(RL.attention_full(q, k, v)), L.attention_full(tq, tk, tv).float().numpy())
    lens = np.array([24, 9], np.int32)
    assert np.array_equal(_np(RL.attention_decode(q[:, -1], k, v, jnp.asarray(lens))),
                          L.attention_decode(tq[:, -1], tk, tv, _t(lens)).float().numpy())


def test_rope_and_sinusoidal_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(8), np.arange(100, 108)]).astype(np.int32)
    for theta in (10_000.0, 1e6):
        np.testing.assert_allclose(L.rope(_t(x), _t(pos), theta).numpy(),
                                   _np(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
                                   atol=ROPE_TOL, rtol=ROPE_TOL)
    np.testing.assert_allclose(L.sinusoidal_positions(_t(pos), 32).numpy(),
                               _np(RL.sinusoidal_positions(jnp.asarray(pos), 32)),
                               atol=ROPE_TOL, rtol=ROPE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_mlps_match_reference(dtype):
    """float32 at 3e-5; bf16 bit-equal (the activations are ``jax.nn``'s
    formulas op by op, with bf16-rounded constants)."""
    rng = np.random.default_rng(1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    arrs = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in
            (((2, 5, 64), 1.0), ((64,), 0.1), ((64, 96), 0.125), ((64, 96), 0.125),
             ((96, 64), 0.1), ((96,), 0.1), ((64,), 0.1))]
    js = [jnp.asarray(a, jd) for a in arrs]
    ts = [_t(_np(a)).to(td) for a in js]
    x, s, wg, wu, wd, b1, b2 = range(7)
    pairs = [
        (RL.rms_norm(js[x], js[s]), L.rms_norm(ts[x], ts[s])),
        (RL.swiglu_mlp(js[x], js[wg], js[wu], js[wd]), L.swiglu_mlp(ts[x], ts[wg], ts[wu], ts[wd])),
        (RL.geglu_mlp(js[x], js[wg], js[wu], js[wd]), L.geglu_mlp(ts[x], ts[wg], ts[wu], ts[wd])),
        (RL.gelu_mlp(js[x], js[wg], js[b1], js[wd], js[b2]),
         L.gelu_mlp(ts[x], ts[wg], ts[b1], ts[wd], ts[b2])),
        (jax.nn.silu(js[x]), L.silu(ts[x])),
        (jax.nn.gelu(js[x]), L.gelu(ts[x])),
    ]
    for ref, out in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATTN_TOL, rtol=ATTN_TOL)
        else:
            assert np.array_equal(out.float().numpy(), _np(ref))


# ---------------------------------------------------------------------------
# configs, shapes, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_registry.list_archs())
def test_configs_and_param_counts_equal_reference(arch):
    assert registry.list_archs() == ref_registry.list_archs()
    for get in ("get_arch", "smoke_config"):
        ref, port = getattr(ref_registry, get)(arch), getattr(registry, get)(arch)
        rd, pd = dataclasses.asdict(ref), dataclasses.asdict(port)
        assert rd == pd
    for cfg, rcfg in ((registry.get_arch(arch).model, ref_registry.get_arch(arch).model),
                      (registry.smoke_config(arch), ref_registry.smoke_config(arch))):
        assert cfg.params_count() == rcfg.params_count()
        assert cfg.active_params_count() == rcfg.active_params_count()
        for prop in ("padded_heads", "padded_vocab", "padded_kv", "attn_free"):
            assert getattr(cfg, prop) == getattr(rcfg, prop)
        assert T.param_shapes(cfg) == jax.tree.map(
            lambda x: x, RT.param_shapes(rcfg),
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple))
        assert T.scan_groups(cfg) == RT.scan_groups(rcfg)
        assert T.layer_pattern(cfg) == RT.layer_pattern(rcfg)


def test_shapes_and_arch_spec_equal_reference():
    from repro.configs import base as ref_base

    from repro_torch.configs import base

    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    spec = registry.get_arch("recurrentgemma-2b")
    assert spec.skip_reason(base.SHAPES["long_500k"]) is None
    assert registry.get_arch("phi3-mini-3.8b").skip_reason(base.SHAPES["long_500k"]) \
        == ref_registry.get_arch("phi3-mini-3.8b").skip_reason(ref_base.SHAPES["long_500k"])
    assert registry.get_arch("phi3-mini-3.8b").model.params_count() == 3_821_079_552


@pytest.mark.parametrize("arch", ref_registry.list_archs())
def test_weight_converter_round_trip_bit_equal(arch):
    rcfg, cfg = ref_registry.smoke_config(arch), registry.smoke_config(arch)
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(3)))
    params = T.params_from_numpy(cfg, tree, "cpu")
    back = T.params_to_numpy(params)
    flat_r, def_r = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_r == def_b
    for a, b in zip(flat_r, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # bf16 leaves keep their bits (numpy has no bfloat16: they come back as float32)
    tree16 = jax.tree.map(np.asarray, ref_lm.cast_params(RT.init_params(rcfg, jax.random.PRNGKey(3))))
    p16 = T.params_from_numpy(cfg, tree16, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in T.tree_leaves(p16))
    for a, b in zip(jax.tree.leaves(tree16), jax.tree.leaves(T.params_to_numpy(p16))):
        assert np.array_equal(a.astype(np.float32), b)
    assert all(torch.equal(x.to(torch.bfloat16), y) for x, y in
               zip(T.tree_leaves(lm.cast_params(params)), T.tree_leaves(p16)))


def test_weight_converter_checks_the_tree():
    rcfg, cfg = ref_registry.smoke_config("qwen3-4b"), registry.smoke_config("qwen3-4b")
    tree = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0)))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        T.params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        T.params_from_numpy(cfg, dict(tree, lm_head=tree["embed"]), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.params_from_numpy(cfg, tree)


@pytest.mark.parametrize("arch", ref_registry.list_archs())
def test_init_params_follows_reference_recipe(arch):
    """Same tree and shapes; zeros, fills and pads where the reference has
    them; each drawn leaf's spread 1/sqrt(shape[-2]) of its stored shape."""
    cfg = registry.smoke_config(arch)
    if arch == "qwen1.5-4b":                       # exercise the head padding
        cfg = dataclasses.replace(cfg, head_pad_to=3)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = T.param_shapes(cfg)
    assert [tuple(t.shape) for t in T.tree_leaves(params)] == \
        [s for s, _ in jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)
                                       and len(x) == 2 and isinstance(x[0], tuple))]

    def check(name, t):
        if name in T._ZERO_INIT:
            assert not t.any(), name
        elif name.startswith("mu_"):
            assert bool((t == 0.5).all())
        elif name == "w0":
            assert bool((t == -6.0).all())
        elif name == "lam":
            a = torch.nn.functional.softplus(t) * 8.0      # -log(u) with u in [0.9, 0.999]
            assert bool((a > -np.log(0.999) - 1e-6).all() and (a < -np.log(0.9) + 1e-6).all())
        elif t.numel() >= 512:
            fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
            live = t[t != 0]
            assert abs(float(live.std()) * np.sqrt(fan_in) - 1.0) < 0.2, name
        return t

    T.tree_map(check, params)
    if cfg.padded_heads != cfg.n_heads:
        p = params["blocks"][0]["0"]
        assert not p["wq"][:, :, cfg.n_heads:].any() and not p["wo"][:, cfg.n_heads:].any()
        assert not p["bq"][:, cfg.n_heads:].any() and p["wq"][:, :, :cfg.n_heads].any()


# ---------------------------------------------------------------------------
# forward: train, prefill, decode in float32 against the reference
# ---------------------------------------------------------------------------

def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _ref_params(rcfg, seed):
    """The reference's ``init_params`` tree with each RG-LRU ``lam`` drawn
    by its recipe from ``seed`` (its own draw is keyed by ``hash('lam')``,
    which changes from process to process)."""
    def fix(path, a):
        if path[-1].key != "lam":
            return a
        un = jax.random.uniform(jax.random.PRNGKey(seed + 1), a.shape, jnp.float32, 0.9, 0.999)
        lam = -jnp.log(un) / 8.0
        return jnp.log(jnp.expm1(jnp.maximum(lam, 1e-6))).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(fix, RT.init_params(rcfg, jax.random.PRNGKey(seed)))


def _pair(arch, seed=1, no_drop=False, **replace):
    rcfg, cfg = ref_registry.smoke_config(arch), registry.smoke_config(arch)
    if replace:
        rcfg, cfg = dataclasses.replace(rcfg, **replace), dataclasses.replace(cfg, **replace)
    if no_drop:
        rcfg, cfg = _no_drop(rcfg), _no_drop(cfg)
    rp = _ref_params(rcfg, seed)
    return rcfg, rp, cfg, T.params_from_numpy(cfg, jax.tree.map(np.asarray, rp), "cpu")


def _close(port, ref, tol=FWD_TOL):
    np.testing.assert_allclose(port.float().numpy(), _np(ref), atol=tol, rtol=tol)


def _close_trees(port, ref):
    rl = jax.tree.leaves(ref)
    pl = T.tree_leaves(port)
    assert len(rl) == len(pl) > 0
    for a, b in zip(pl, rl):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("arch", TOKEN)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_forward_matches_reference_f32(arch, mode):
    rcfg, rp, cfg, pp = _pair(arch)
    B, S = 2, 12
    inp = _inputs(cfg, B, S, seed=3)
    kw = dict(compute_dtype=jnp.float32, remat=False)
    if mode != "decode":
        ref, rc = RT.forward(rcfg, rp, {k: jnp.asarray(v) for k, v in inp.items()}, mode=mode, **kw)
        out, pc = T.forward(cfg, pp, {k: _t(v) for k, v in inp.items()}, mode=mode,
                            compute_dtype=torch.float32)
        assert out.shape == ((B, S, cfg.padded_vocab) if mode == "train" else (B, 1, cfg.padded_vocab))
        _close(out, ref)
        if mode == "prefill":
            _close_trees(pc, rc)
        return
    # decode one token per row from a prefilled cache padded to S + 4 (the
    # port's through make_prefill_step), ragged lengths
    short = {k: v[:, :S - 1] for k, v in inp.items()}
    _, rc = RT.forward(rcfg, rp, {k: jnp.asarray(v) for k, v in short.items()},
                       mode="prefill", **kw)
    rc = _ref_pad(rc, S + 4, cfg.sliding_window)
    _, pc = lm.make_prefill_step(cfg, max_seq=S + 4, compute_dtype=torch.float32)(
        pp, {k: _t(v) for k, v in short.items()})
    _close_trees(pc, rc)
    key = "tokens" if "tokens" in inp else "embeds"
    nxt = inp[key][:, S - 1]
    lengths = np.array([S - 1, S - 3], np.int32)
    ref, rc2 = RT.forward(rcfg, rp, {key: jnp.asarray(nxt)[:, None]}, mode="decode",
                          cache=rc, lengths=jnp.asarray(lengths), **kw)
    out, pc2 = T.forward(cfg, pp, {key: _t(nxt)[:, None]}, mode="decode", cache=pc,
                         lengths=_t(lengths), compute_dtype=torch.float32)
    assert out.shape == (B, 1, cfg.padded_vocab) and pc2 is not None
    _close(out, ref)
    _close_trees(pc, rc2)                   # written in place


def _ref_pad(cache, max_seq, window=None):
    """The reference's ``make_prefill_step`` padding, on a float32 prefill
    (a window's ring cache is not padded)."""
    def fix(path, leaf):
        if path[-1].key in ("k", "v") and not window and max_seq > leaf.shape[2]:
            return jnp.pad(leaf, [(0, 0), (0, 0), (0, max_seq - leaf.shape[2])]
                           + [(0, 0)] * (leaf.ndim - 3))
        return leaf
    return jax.tree_util.tree_map_with_path(fix, cache)


@pytest.mark.parametrize("arch", TOKEN)
def test_greedy_prefill_and_decode_consistent_with_forward(arch):
    """The port's counterpart of tests/test_models_smoke.py:57-82, in
    float32 compute: the argmax of a full forward at the last position
    equals prefill's token and one decode step's from a shorter prefix,
    and all three equal the reference's float32 tokens (MoE at a capacity
    that drops nothing)."""
    rcfg, rp, cfg, pp = _pair(arch, no_drop=True)
    B, S = 2, 12
    inp = {k: _t(v) for k, v in _inputs(cfg, B, S, seed=3).items()}
    f32 = dict(compute_dtype=torch.float32)
    full, _ = T.forward(cfg, pp, inp, mode="train", **f32)
    want = torch.argmax(full[:, -1], dim=-1).to(torch.int32)
    prefill = lm.make_prefill_step(cfg, max_seq=S + 4, **f32)
    tok, _ = prefill(pp, inp)
    assert torch.equal(tok, want)
    _, cache2 = prefill(pp, {k: v[:, :S - 1] for k, v in inp.items()})
    last = inp["tokens"][:, S - 1] if "tokens" in inp else inp["embeds"][:, S - 1]
    tok2, _, lens = lm.make_decode_step(cfg, **f32)(pp, cache2, last,
                                                    torch.full((B,), S - 1, dtype=torch.int32))
    assert torch.equal(tok2, want) and lens.tolist() == [S] * B
    ref_full, _ = RT.forward(rcfg, rp, {k: jnp.asarray(v.numpy()) for k, v in inp.items()},
                             mode="train", remat=False, compute_dtype=jnp.float32)
    assert np.array_equal(np.asarray(jnp.argmax(ref_full[:, -1], axis=-1)), want.numpy())


#: float64 logits of prefill and decode against the full forward's
F64_TOL = 1e-10


@pytest.mark.parametrize("arch,window,S", [
    ("phi3-mini-3.8b", None, 12), ("qwen3-4b", None, 12), ("phi3-mini-3.8b", 5, 12),
    ("qwen3-4b", None, 273), ("olmoe-1b-7b", None, 12), ("moonshot-v1-16b-a3b", None, 12),
    ("recurrentgemma-2b", 8, 12), ("recurrentgemma-2b", 8, 273), ("rwkv6-7b", None, 12)])
def test_float64_prefill_and_decode_equal_forward_at_depth(arch, window, S):
    """In float64 compute no step rounds to float32 (``layers.upcast``), so
    at 8 layers prefill's and one decode step's last-position logits equal
    the full forward's within float64 rounding, and their greedy tokens are
    equal: the deep greedy check of ``chip_smoke.py`` rests on this.  The
    cases cover the ring decode of a sliding window and, at 272 tokens,
    ``attention_chunked`` in prefill (chunks of 21 and, for the cache of
    the 272-token prefix, 16); the RG-LRU and RWKV6 states (recurrentgemma
    at 8 layers runs both of its scan groups) and the MoE FFN at a capacity
    that drops nothing."""
    cfg = _no_drop(dataclasses.replace(registry.smoke_config(arch), n_layers=8,
                                       sliding_window=window))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = _t(np.random.default_rng(7).integers(0, cfg.vocab, (2, S)).astype(np.int32))

    def f64(n):
        c = max(c for c in range(1, 33) if n % c == 0)
        return dict(compute_dtype=torch.float64, chunk_q=c, chunk_kv=c)

    full, _ = T.forward(cfg, params, {"tokens": tokens}, mode="train", **f64(S))
    assert full.dtype == torch.float64
    lg_p, _ = T.forward(cfg, params, {"tokens": tokens}, mode="prefill", **f64(S))
    _, cache = T.forward(cfg, params, {"tokens": tokens[:, :S - 1]}, mode="prefill",
                         **f64(S - 1))
    if not window:
        cache = T.tree_map(lambda n, t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4))
                           if n in ("k", "v") else t, cache)
    lens = torch.full((2,), S - 1, dtype=torch.int32)
    lg_d, _ = T.forward(cfg, params, {"tokens": tokens[:, S - 1:]}, mode="decode",
                        cache=cache, lengths=lens, compute_dtype=torch.float64)
    for lg in (lg_p, lg_d):
        assert lg.dtype == torch.float64
        torch.testing.assert_close(lg[:, 0], full[:, -1], atol=F64_TOL, rtol=0)
        assert torch.equal(lg[:, 0].argmax(-1), full[:, -1].argmax(-1))


@pytest.mark.parametrize("skip", [False, True])
def test_chunked_prefill_matches_reference(skip):
    """A prompt longer than 256 goes through ``attention_chunked``."""
    rcfg, rp, cfg, pp = _pair("qwen3-4b")
    inp = _inputs(cfg, 1, 320, seed=4)
    kw = dict(chunk_q=64, chunk_kv=64, causal_skip=skip)
    ref, rc = RT.forward(rcfg, rp, {"tokens": jnp.asarray(inp["tokens"])}, mode="prefill",
                         compute_dtype=jnp.float32, remat=False, **kw)
    out, pc = T.forward(cfg, pp, {"tokens": _t(inp["tokens"])}, mode="prefill",
                        compute_dtype=torch.float32, **kw)
    _close(out, ref)
    _close_trees(pc, rc)


def test_sliding_window_prefill_and_ring_decode_match_reference():
    """A sliding window (the ring cache and ``_decode_ring``) on a dense
    config, in both packages: prefill past the window, then decode steps."""
    rcfg, rp, cfg, pp = _pair("phi3-mini-3.8b", sliding_window=8)
    B, S = 2, 13
    inp = _inputs(cfg, B, S, seed=6)["tokens"]
    kw = dict(compute_dtype=jnp.float32, remat=False)
    ref, rc = RT.forward(rcfg, rp, {"tokens": jnp.asarray(inp[:, :10])}, mode="prefill", **kw)
    out, pc = T.forward(cfg, pp, {"tokens": _t(inp[:, :10])}, mode="prefill",
                        compute_dtype=torch.float32)
    _close(out, ref)
    _close_trees(pc, rc)
    assert pc["blocks"][0]["0"]["pos"][0, 0].tolist() == [8, 9, 2, 3, 4, 5, 6, 7]
    lengths = np.array([10, 10], np.int32)
    for t in range(10, S):
        ref, rc = RT.forward(rcfg, rp, {"tokens": jnp.asarray(inp[:, t:t + 1])}, mode="decode",
                             cache=rc, lengths=jnp.asarray(lengths), **kw)
        out, pc = T.forward(cfg, pp, {"tokens": _t(inp[:, t:t + 1])}, mode="decode", cache=pc,
                            lengths=_t(lengths), compute_dtype=torch.float32)
        _close(out, ref)
        _close_trees(pc, rc)
        lengths = lengths + 1
    full, _ = T.forward(cfg, pp, {"tokens": _t(inp)}, mode="train", compute_dtype=torch.float32)
    _close(out[:, 0], full[:, -1].numpy())


def _stacked_and_per_layer_decode(arch, S):
    """Two decode steps on a stacked prefill cache and on a per-layer view
    of an equal one: the same tokens, and every leaf of the two caches
    equal afterwards (the per-layer decode writes through its views)."""
    cfg = registry.smoke_config(arch)
    pp = T.init_params(cfg, torch.Generator().manual_seed(2))
    inp = {k: _t(v) for k, v in _inputs(cfg, 2, S, seed=1).items()}
    prefill = lm.make_prefill_step(cfg, max_seq=S + 3, compute_dtype=torch.float32)
    _, stacked = prefill(pp, inp)
    _, other = prefill(pp, inp)
    per_layer = T.unstack_cache(cfg, other)
    assert [len(g) for g in per_layer["blocks"]] == [r for _, r in T.scan_groups(cfg)]
    dec = lm.make_decode_step(cfg, compute_dtype=torch.float32)
    lengths = torch.tensor([S, S - 2], dtype=torch.int32)
    tok = torch.tensor([3, 4], dtype=torch.int32)
    before = T.tree_map(lambda _, t: t.clone(), stacked)
    for _ in range(2):
        a, stacked, _ = dec(pp, stacked, tok, lengths)
        b, per_layer, lengths = dec(pp, per_layer, tok, lengths)
        assert torch.equal(a, b)
        tok = a
    for x, y in zip(T.tree_leaves(stacked), T.tree_leaves(other)):
        assert torch.equal(x, y)             # the per-layer leaves are views of ``other``
    return before, stacked


@pytest.mark.parametrize("arch", sorted(OTHER))
def test_per_layer_cache_equals_stacked_for_every_block_kind(arch):
    """The recurrent states are written in place: every state leaf changed
    from what prefill gave."""
    before, after = _stacked_and_per_layer_decode(arch, 9)
    names = T.tree_leaves(T.tree_map(lambda n, _: n, after))
    assert {"moe": {"k", "v"}, "rglru": {"h", "conv", "k", "v", "pos"},
            "rwkv": {"s", "x_prev_t", "x_prev_c"}}[OTHER[arch]] == set(names)
    for name, b, a in zip(names, T.tree_leaves(before), T.tree_leaves(after)):
        if name in ("h", "s", "conv", "x_prev_t", "x_prev_c"):
            assert not torch.equal(a, b), name


def test_per_layer_cache_equals_stacked():
    cfg = registry.smoke_config("mistral-large-123b")
    _stacked_and_per_layer_decode("mistral-large-123b", 7)
    fresh = T.init_cache(cfg, 2, 10, torch.float32, stacked=False, device="cpu")
    assert [tuple(t.shape) for t in T.tree_leaves(fresh)] == [(2, 10, 2, 16)] * 6
    ref = jax.eval_shape(lambda: RT.init_cache(ref_registry.smoke_config("mistral-large-123b"),
                                               2, 10, jnp.float32, stacked=False))
    assert [tuple(t.shape) for t in jax.tree.leaves(ref)] == [(2, 10, 2, 16)] * 6


@pytest.mark.parametrize("arch", sorted(OTHER))
def test_caches_of_every_block_kind_match_reference(arch):
    cfg, rcfg = registry.smoke_config(arch), ref_registry.smoke_config(arch)
    for stacked in (True, False):
        c = T.init_cache(cfg, 3, 20, torch.bfloat16, stacked=stacked, device="cpu")
        r = jax.eval_shape(lambda: RT.init_cache(rcfg, 3, 20, jnp.bfloat16, stacked=stacked))
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in T.tree_leaves(c)] == \
            [(t.shape, str(t.dtype)) for t in jax.tree.leaves(r)]


def test_mesh_paths_raise_with_their_roadmap_item():
    """Mesh serving and training are ported (tests/test_torch_mesh_lm.py,
    tests/test_torch_mesh_train.py): a train forward on a mesh gives the
    single-device logits (float32, 1e-4) and a train step on a mesh runs;
    so do the recurrent archs' mesh steps
    (tests/test_torch_mesh_recurrent.py holds them)."""
    from repro_torch.distributed.sharding import shard_params, unshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.optimizer import OptConfig

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    cfg = registry.smoke_config("phi3-mini-3.8b")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with torch.no_grad():
        one, _ = T.forward(cfg, pp, batch, mode="train", compute_dtype=torch.float32)
        got, _ = T.forward(cfg, shard_params(cfg, pp, mesh), batch, mode="train", mesh=mesh,
                           compute_dtype=torch.float32)
    assert got.shape == one.shape == (1, 4, cfg.padded_vocab)
    np.testing.assert_allclose(got.unshard().numpy(), one.numpy(), atol=1e-4, rtol=1e-4)
    sp = shard_params(cfg, T.init_params(cfg, torch.Generator().manual_seed(0)), mesh)
    st = lm.TrainState(sp, lm.opt_mod.adam_init(sp), torch.zeros((), dtype=torch.int32))
    st, m = lm.make_train_step(cfg, OptConfig(), mesh=mesh)(
        st, dict(batch, labels=batch["tokens"]))
    assert np.isfinite(float(m["loss"])) and len(unshard_tree(st.params)) == len(pp)
    rw, rg = registry.smoke_config("rwkv6-7b"), registry.smoke_config("recurrentgemma-2b")
    rwp = shard_params(rw, T.init_params(rw, torch.Generator().manual_seed(0)), mesh,
                       serve_seq_shard=True)
    tok, cache = lm.make_prefill_step(rw, mesh=mesh, serve_seq_shard=True)(rwp, batch)
    nxt, _, lens = lm.make_decode_step(rw, mesh=mesh, serve_seq_shard=True)(
        rwp, cache, tok, torch.full((1,), 4, dtype=torch.int32))
    assert nxt.shape == (1,) and int(lens[0]) == 5
    rgp = shard_params(rg, T.init_params(rg, torch.Generator().manual_seed(0)), mesh)
    tok, cache = lm.make_prefill_step(rg, mesh=mesh)(rgp, batch)
    assert tok.shape == (1,) and cache["blocks"][0]["2"]["pos"].shape == (1, 1, 4)
    sw = shard_params(rw, T.init_params(rw, torch.Generator().manual_seed(0)), mesh)
    st = lm.TrainState(sw, lm.opt_mod.adam_init(sw), torch.zeros((), dtype=torch.int32))
    st, m = lm.make_train_step(rw, OptConfig(), mesh=mesh)(st, dict(batch, labels=batch["tokens"]))
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="mode"):
        T.forward(cfg, pp, batch, mode="score")


def test_cast_params_once_is_bit_equal_to_casting_at_each_use():
    cfg = registry.smoke_config("musicgen-medium")
    pp = T.init_params(cfg, torch.Generator().manual_seed(5))
    inp = {k: _t(v) for k, v in _inputs(cfg, 2, 9, seed=2).items()}
    a, ca = T.forward(cfg, pp, inp, mode="prefill")
    cast = lm.cast_params(pp)
    assert all(t.dtype == torch.bfloat16 for t in T.tree_leaves(cast))
    b, cb = T.forward(cfg, cast, inp, mode="prefill")
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(T.tree_leaves(ca), T.tree_leaves(cb)))
