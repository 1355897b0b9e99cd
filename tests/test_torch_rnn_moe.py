"""The port's MoE FFN, RG-LRU and RWKV6 blocks (``repro_torch.models.{moe,
rglru, rwkv6}``) against the reference's (``repro.models.{moe, rglru,
rwkv6}``) on the CPU, on inputs and weights drawn with numpy.

Tolerances: the routing (top-k indices, each pair's dispatch slot and
whether it is kept) bit-equal; ``moe_ffn`` in float32 at 1e-5, drops
included (the same op order; the reference holds its own dispatch to a
dense mixture at 2e-4, ``tests/test_rnn_blocks.py:122``); the causal conv,
the RG-LRU step and a decode step of the recurrent branch at 1e-5; the
RG-LRU scan and prefill at 1e-4 (a sequential loop against
``lax.associative_scan``: the reference's own scan-against-step bound,
``tests/test_rnn_blocks.py:42-44``); the WKV scan, time mix and channel mix
at 1e-4 (``tests/test_rnn_blocks.py:76-77``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as RM  # noqa: E402
from repro.models import rglru as RG  # noqa: E402
from repro.models import rwkv6 as RW  # noqa: E402

from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rglru as G  # noqa: E402
from repro_torch.models import rwkv6 as W  # noqa: E402

MOE_TOL = 1e-5
STEP_TOL = 1e-5
SCAN_TOL = 1e-4


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), _np(ref), atol=tol, rtol=tol)


def _both(tree):
    """A dict of numpy arrays as (jax arrays, torch tensors)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(seed, D, FF, E):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((D, E)).astype(np.float32),
            "w_gate": (rng.standard_normal((E, D, FF)) * 0.2).astype(np.float32),
            "w_up": (rng.standard_normal((E, D, FF)) * 0.2).astype(np.float32),
            "w_down": (rng.standard_normal((E, FF, D)) * 0.2).astype(np.float32)}


@pytest.mark.parametrize("T,E,k", [(37, 8, 2), (24, 64, 8), (5, 64, 6)])
def test_router_topk_matches_reference(T, E, k):
    logits = np.random.default_rng(T + E).standard_normal((T, E)).astype(np.float32) * 3
    rw, ri = RM.router_topk(jnp.asarray(logits), k)
    w, i = M.router_topk(_t(logits), k)
    assert np.array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6, rtol=1e-6)


def test_router_topk_puts_the_lower_expert_first_among_tied_gates():
    rng = np.random.default_rng(0)
    logits = np.repeat(rng.standard_normal((6, 4)).astype(np.float32), 2, axis=1)
    logits[0] = 0.5                                        # every gate equal
    logits[1, [1, 6]] = 9.0                                # a tie for the top
    for k in (1, 3, 8):
        rw, ri = RM.router_topk(jnp.asarray(logits), k)
        w, i = M.router_topk(_t(logits), k)
        assert np.array_equal(i.numpy(), np.asarray(ri)), k
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6, rtol=1e-6)
    assert i[0].tolist() == list(range(8)) and i[1, :2].tolist() == [1, 6]


@pytest.mark.parametrize("T,E,k,e_loc,e_lo,capacity", [
    (24, 8, 2, 8, 0, 100), (24, 8, 2, 8, 0, 3), (40, 16, 4, 4, 8, 5), (3, 64, 8, 64, 0, 1)])
def test_dispatch_slots_and_drops_bit_equal(T, E, k, e_loc, e_lo, capacity):
    """Each pair's slot and keep flag bit-equal (the buckets fill in
    token-major order and the late pairs drop), and the buffers equal."""
    rng = np.random.default_rng(T * E)
    x = rng.standard_normal((T, 8)).astype(np.float32)
    rw, ri = RM.router_topk(jnp.asarray(rng.standard_normal((T, E)).astype(np.float32)), k)
    rbuf, rmeta = RM._dispatch_local(jnp.asarray(x), rw, ri, e_loc, e_lo, capacity)
    buf, meta = M._dispatch_local(_t(x), _t(np.asarray(rw)), _t(np.asarray(ri)).long(),
                                  e_loc, e_lo, capacity)
    for a, b in zip(meta, rmeta):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(buf.numpy(), np.asarray(rbuf))
    keep = meta[3]
    local = (_t(np.asarray(ri)).reshape(-1) >= e_lo) & (_t(np.asarray(ri)).reshape(-1) < e_lo + e_loc)
    if capacity < 100:
        assert int(keep.sum()) < int(local.sum())          # pairs were dropped
    else:
        assert torch.equal(keep, local)


@pytest.mark.parametrize("cf", [100.0, 1.25, 0.25])
def test_moe_ffn_matches_reference(cf):
    """f32 at 1e-5: no drops (100), the configs' default (1.25) and a
    capacity that drops most pairs (0.25)."""
    D, FF, E, k, B, S = 16, 24, 8, 2, 2, 20
    params = _moe_params(1, D, FF, E)
    x = np.random.default_rng(2).standard_normal((B, S, D)).astype(np.float32)
    jp, tp = _both(params)
    ref = RM.moe_ffn(jp, jnp.asarray(x), RM.MoEConfig(E, k, cf))
    out = M.moe_ffn(tp, _t(x), M.MoEConfig(E, k, cf))
    _close(out, ref, MOE_TOL)
    # how many pairs the reference dropped at this capacity
    capacity = int(cf * B * S * k / E) or 1
    rw, ri = RM.router_topk(jnp.asarray(x.reshape(-1, D)) @ jp["router"], k)
    keep = np.asarray(RM._dispatch_local(jnp.asarray(x.reshape(-1, D)), rw, ri, E, 0,
                                         capacity)[1][3])
    assert keep.all() == (cf == 100.0)
    assert cf != 0.25 or keep.mean() < 0.5


def test_moe_ffn_bf16_routes_as_the_reference():
    """bf16 in: the router's logits round to bf16 and the softmax runs in
    float32, so the top-k and the kept pairs are the reference's; the
    output within a few bf16 ulps."""
    D, FF, E, k = 32, 16, 8, 2
    params = _moe_params(3, D, FF, E)
    x = np.random.default_rng(4).standard_normal((3, 1, D)).astype(np.float32)
    jp, tp = _both(params)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = RM.moe_ffn(jp, xb, RM.MoEConfig(E, k))
    out = M.moe_ffn(tp, _t(_np(xb)).to(torch.bfloat16), M.MoEConfig(E, k))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2e-2, rtol=2e-2)
    rl = jnp.einsum("td,de->te", xb.reshape(3, D), jp["router"].astype(jnp.bfloat16))
    tl = _t(_np(xb)).to(torch.bfloat16).reshape(3, D) @ tp["router"].to(torch.bfloat16)
    assert np.array_equal(tl.float().numpy(), _np(rl))
    assert np.array_equal(M.router_topk(tl, k)[1].numpy(), np.asarray(RM.router_topk(rl, k)[1]))


def test_moe_ffn_refuses_a_mesh():
    """The expert-parallel branch is ported (tests/test_torch_mesh_lm.py);
    the FSDP gather of training stays ROADMAP item 13f, and a mesh whose
    "model" axis does not split the experts is refused."""
    from repro_torch.launch.mesh import make_mesh

    params = {k: _t(v) for k, v in _moe_params(0, 8, 8, 4).items()}
    mesh = make_mesh((1, 8), ("data", "model"), devices=["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="13f"):
        M.moe_ffn(params, torch.zeros((1, 2, 8)), M.MoEConfig(4, 2), mesh=mesh,
                  fsdp_gather=True)
    with pytest.raises(ValueError, match="split"):
        M.moe_ffn(params, torch.zeros((1, 2, 8)), M.MoEConfig(4, 2), mesh=mesh)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rg_params(seed, D, R):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa: E731
    return {"w_in_rnn": mk(D, R), "w_in_gate": mk(D, R), "conv": mk(4, R),
            "w_a": mk(R, R), "w_x": mk(R, R),
            "lam": (rng.standard_normal(R) * 3).astype(np.float32), "w_out": mk(R, D)}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    kern = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    ry, rs = RG.causal_conv1d(jnp.asarray(x), jnp.asarray(kern),
                              None if st is None else jnp.asarray(st))
    y, s = G.causal_conv1d(_t(x), _t(kern), None if st is None else _t(st))
    _close(y, ry, STEP_TOL)
    assert np.array_equal(s.numpy(), np.asarray(rs))


def test_lru_coeffs_match_reference_through_large_lambda():
    """lam up to 40: ``jax.nn.softplus`` is logaddexp(lam, 0) everywhere,
    where ``F.softplus`` turns into the identity above 20."""
    p = _rg_params(6, 8, 16)
    p["lam"] = np.linspace(-30, 40, 16).astype(np.float32)
    x = np.random.default_rng(7).standard_normal((2, 5, 16)).astype(np.float32)
    jp, tp = _both(p)
    (ra, rb), (a, b) = RG._lru_coeffs(jp, jnp.asarray(x)), G._lru_coeffs(tp, _t(x))
    assert a.dtype == b.dtype == torch.float32
    _close(a, ra, STEP_TOL)
    _close(b, rb, STEP_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_reference(with_h0):
    p = _rg_params(8, 8, 16)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 33, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    jp, tp = _both(p)
    ry, rh = RG.rg_lru_scan(jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    y, h = G.rg_lru_scan(tp, _t(x), None if h0 is None else _t(h0))
    _close(y, ry, SCAN_TOL)
    _close(h, rh, SCAN_TOL)
    assert h.dtype == torch.float32


def test_rg_lru_step_matches_reference():
    p = _rg_params(10, 8, 16)
    rng = np.random.default_rng(11)
    x, h = (rng.standard_normal((3, 16)).astype(np.float32) for _ in range(2))
    jp, tp = _both(p)
    (ry, rh), (y, hn) = RG.rg_lru_step(jp, jnp.asarray(x), jnp.asarray(h)), \
        G.rg_lru_step(tp, _t(x), _t(h))
    _close(y, ry, STEP_TOL)
    _close(hn, rh, STEP_TOL)


def test_recurrent_branch_prefill_and_decode_match_reference():
    """Prefill (scan) at 1e-4 with its cache; then decode steps from that
    cache at 1e-5 against the reference's steps from the same cache."""
    D, R, B, S = 8, 16, 2, 11
    p = _rg_params(12, D, R)
    x = np.random.default_rng(13).standard_normal((B, S + 3, D)).astype(np.float32)
    jp, tp = _both(p)
    ry, rc = RG.recurrent_branch(jp, jnp.asarray(x[:, :S]))
    y, c = G.recurrent_branch(tp, _t(x[:, :S]))
    _close(y, ry, SCAN_TOL)
    _close(c["h"], rc["h"], SCAN_TOL)
    _close(c["conv"], rc["conv"], STEP_TOL)
    c = {k: _t(np.asarray(v)) for k, v in rc.items()}      # the same starting state
    for t in range(S, S + 3):
        ry, rc = RG.recurrent_branch(jp, jnp.asarray(x[:, t:t + 1]), cache=rc)
        y, c = G.recurrent_branch(tp, _t(x[:, t:t + 1]), cache=c)
        _close(y, ry, STEP_TOL)
        _close(c["h"], rc["h"], STEP_TOL)
        _close(c["conv"], rc["conv"], STEP_TOL)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rw_params(seed, D, FF):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, _) in W.rwkv_param_shapes(D, FF).items():
        if k.startswith("mu_"):
            out[k] = rng.uniform(0.2, 0.8, shp).astype(np.float32)
        elif k == "w0":
            out[k] = rng.uniform(-3.0, -1.0, shp).astype(np.float32)
        elif k in ("ln_w", "ln_b", "u"):
            out[k] = (rng.standard_normal(shp) * 0.3).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(shp) * 0.2).astype(np.float32)
    return out


def test_token_shift_mix_and_decay_match_reference():
    D = 128
    p = _rw_params(14, D, 64)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    prev = rng.standard_normal((2, D)).astype(np.float32)
    jp, tp = _both(p)
    for pv in (None, prev):
        rxs = RW._token_shift(jnp.asarray(x), None if pv is None else jnp.asarray(pv))
        xs = W._token_shift(_t(x), None if pv is None else _t(pv))
        assert np.array_equal(xs.numpy(), np.asarray(rxs))
    _close(W._mix(_t(x), xs, tp["mu_w"]), RW._mix(jnp.asarray(x), rxs, jp["mu_w"]), STEP_TOL)
    _close(W._decay(tp, _t(x)), RW._decay(jp, jnp.asarray(x)), STEP_TOL)


@pytest.mark.parametrize("S,with_s0", [(9, False), (9, True), (128, False)])
def test_wkv_scan_matches_reference(S, with_s0):
    """The port's sequential loop against the reference's plain scan and,
    at 128 steps, its chunked one (chunks of 64)."""
    B, H, dh = 2, 2, 8
    rng = np.random.default_rng(S)
    r, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((B, S, H, dh))))).astype(np.float32)
    u = rng.standard_normal((H, dh)).astype(np.float32)
    s0 = rng.standard_normal((B, H, dh, dh)).astype(np.float32) if with_s0 else None
    ry, rs = RW._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                          None if s0 is None else jnp.asarray(s0))
    y, s = W._wkv_scan(*(_t(a) for a in (r, k, v, w, u)), None if s0 is None else _t(s0))
    _close(y, ry, SCAN_TOL)
    _close(s, rs, SCAN_TOL)


def test_time_mix_and_channel_mix_match_reference():
    """Scan over 10 tokens, then 3 decode steps from the reference's
    cache: outputs and caches at 1e-4."""
    D, FF, B, S = 128, 256, 2, 10
    p = _rw_params(16, D, FF)
    x = np.random.default_rng(17).standard_normal((B, S + 3, D)).astype(np.float32)
    jp, tp = _both(p)
    for fn, rfn in ((W.time_mix, RW.time_mix), (W.channel_mix, RW.channel_mix)):
        ry, rc = rfn(jp, jnp.asarray(x[:, :S]))
        y, c = fn(tp, _t(x[:, :S]))
        _close(y, ry, SCAN_TOL)
        assert set(c) == set(rc)
        for name in c:
            _close(c[name], rc[name], SCAN_TOL)
        c = {n: _t(np.asarray(a)) for n, a in rc.items()}
        for t in range(S, S + 3):
            ry, rc = rfn(jp, jnp.asarray(x[:, t:t + 1]), cache=rc)
            y, c = fn(tp, _t(x[:, t:t + 1]), cache=c)
            _close(y, ry, SCAN_TOL)
            for name in c:
                _close(c[name], rc[name], SCAN_TOL)
    assert c["x_prev"].shape == (B, D)


def test_time_mix_state_and_decay_are_float32_in_bf16():
    """bf16 compute: the state stays float32 and the decay the scan sees is
    bf16-rounded (``w.astype(x.dtype)`` in the reference)."""
    D = 128
    p = {k: _t(v) for k, v in _rw_params(18, D, 64).items()}
    seen = {}
    scan = W._wkv_scan

    def spy(r, k, v, w, u, s0=None):
        seen["w"] = w
        return scan(r, k, v, w, u, s0)

    x = torch.from_numpy(np.random.default_rng(19).standard_normal((1, 4, D)).astype(np.float32))
    W._wkv_scan = spy
    try:
        y, c = W.time_mix(p, x.to(torch.bfloat16))
    finally:
        W._wkv_scan = scan
    assert y.dtype == torch.bfloat16 and c["s"].dtype == torch.float32
    assert seen["w"].dtype == torch.bfloat16
