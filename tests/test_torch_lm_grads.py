"""Gradients of the port's LM loss (``torch.autograd.grad`` through
``repro_torch.models.lm.lm_loss``) against the reference's ``jax.grad``, on
the CPU at the smoke configs, and the chunked, rematerialised WKV scan.

Both ``lm_loss``es are patched to a float32 forward (the reference's does
not pass ``compute_dtype`` on; see ``tests/test_torch_training.py``).
Tolerances: the loss at ``FWD_TOL`` = 1e-4 (``tests/test_torch_lm.py``);
each gradient leaf g within ``GRAD_TOL`` = 1e-4 times its largest
reference entry, |g - g_ref| <= 1e-4 * max|g_ref| (float32 backward passes
that sum in another order: the largest deviation measured over these
archs is 2.4e-5 of the leaf's largest entry, recurrentgemma's, whose
RG-LRU is a loop here and an associative scan there; the others are
under 1.4e-5; the losses within 1.5e-6).  The port's gradients with ``remat`` on and off are
bit-equal: the checkpoint recomputes the same forward.  The WKV scan:
the chunked form's values bit-equal to the sequential loop's and its
gradients within ``CHUNK_TOL`` = 1e-5 of them (``u``'s gradient is summed
chunk by chunk); both against the reference at its scan bound, 1e-4
(``tests/test_rnn_blocks.py:76-77``), values and gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import rwkv6 as RW  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import rwkv6 as W  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_lm import _ref_params  # noqa: E402
from test_torch_training import f32_forward  # noqa: E402,F401  (a fixture)

FWD_TOL = 1e-4                  # tests/test_torch_lm.py
GRAD_TOL = 1e-4
SCAN_TOL = 1e-4                 # tests/test_rnn_blocks.py:76-77
CHUNK_TOL = 1e-5
ARCHS = ["phi3-mini-3.8b", "qwen3-4b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b",
         "musicgen-medium"]


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


def _port_grads(cfg, pp, tb, **kw):
    leaves = T.tree_leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = lm.lm_loss(cfg, pp, tb, compute_dtype=torch.float32, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax_grad(arch, f32_forward):
    rcfg, cfg = ref_registry.smoke_config(arch), registry.smoke_config(arch)
    rp = _ref_params(rcfg, 1)
    pp = T.params_from_numpy(cfg, jax.tree.map(np.asarray, rp), "cpu")
    b = _batch(cfg, 2, 16, seed=5)
    rb, tb = {k: jnp.asarray(v) for k, v in b.items()}, {k: _t(v) for k, v in b.items()}
    fused = arch in ("qwen3-4b", "rwkv6-7b")        # a tied head, and a recurrent one
    kw = dict(fused_loss=fused, loss_chunk=4)
    rl, rg = jax.value_and_grad(lambda p: ref_lm.lm_loss(
        rcfg, p, rb, remat=False, compute_dtype=jnp.float32, **kw))(rp)
    loss, grads = _port_grads(cfg, pp, tb, remat=True, **kw)
    loss_nr, grads_nr = _port_grads(cfg, pp, tb, remat=False, **kw)
    np.testing.assert_allclose(float(loss), float(rl), atol=FWD_TOL, rtol=FWD_TOL)
    assert torch.equal(loss, loss_nr)
    rleaves = jax.tree.leaves(rg)
    assert len(grads) == len(rleaves)
    for g, gn, r in zip(grads, grads_nr, rleaves):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        assert torch.equal(g, gn)
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * max(np.abs(r).max(), 1e-30)


def _wkv_inputs(S, seed=3, B=2, H=2, dh=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((B, S, H, dh))))).astype(np.float32)
    u = rng.standard_normal((H, dh)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("S", [128, 96])
def test_chunked_wkv_scan_values_and_gradients(S):
    """S = 128: two chunks of 64 under checkpoint; S = 96 (not a multiple
    of 64): one plain loop, as the reference's."""
    arrs = _wkv_inputs(S)
    ins = [_t(a).requires_grad_(True) for a in arrs]
    y, s = W._wkv_scan(*ins)
    gy = torch.from_numpy(np.random.default_rng(4).standard_normal(tuple(y.shape))
                          .astype(np.float32))
    loss = (y * gy).sum() + s.square().sum()
    grads = torch.autograd.grad(loss, ins)
    seq_ins = [_t(a).requires_grad_(True) for a in arrs]
    y2, s2 = W._wkv_scan(*seq_ins, chunk=S)            # one sequential loop
    grads2 = torch.autograd.grad((y2 * gy).sum() + s2.square().sum(), seq_ins)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    for a, b in zip(grads, grads2):    # u's sums over the chunks, in another order
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=CHUNK_TOL,
                                   atol=CHUNK_TOL * b.abs().max().item())

    def rloss(*xs):
        ry, rs = RW._wkv_scan(*xs)
        return jnp.sum(ry * jnp.asarray(gy.numpy())) + jnp.sum(rs ** 2), (ry, rs)
    (_, (ry, rs)), rgrads = jax.value_and_grad(rloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(rs), atol=SCAN_TOL, rtol=SCAN_TOL)
    for a, r in zip(grads, rgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_chunked_wkv_scan_checkpoints_each_chunk(monkeypatch):
    """With grad enabled the chunks run under ``checkpoint`` (once in the
    forward, again in the backward); under ``no_grad`` straight through."""
    calls = []
    steps = W._wkv_steps

    def spy(*a):
        calls.append(a[0].shape[1])
        return steps(*a)

    monkeypatch.setattr(W, "_wkv_steps", spy)
    ins = [_t(a).requires_grad_(True) for a in _wkv_inputs(192)]
    y, _ = W._wkv_scan(*ins)
    assert calls == [64, 64, 64]
    torch.autograd.grad(y.sum(), ins)
    assert calls == [64] * 6
    with torch.no_grad():
        W._wkv_scan(*ins)
    assert calls == [64] * 9
