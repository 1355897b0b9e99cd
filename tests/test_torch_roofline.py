"""The port's roofline (``benchmarks_torch/roofline.py`` over
``repro_torch.launch.units``) against the reference's
``benchmarks/roofline.py`` and against hand counts.

- ``model_flops`` and ``analytic_bytes`` equal the reference's for every
  arch x shape at rel 1e-12 (the reference's side runs in a subprocess:
  importing its roofline plants a 512-device ``XLA_FLAGS`` in
  ``os.environ``);
- the meter's flops equal ``FlopCounterMode``'s on the same unit (a
  prefill layer at 64 tokens, where attention is one tile, and at 1024,
  where the chunked attention's einsums are answered from their
  equations; a train layer with its backward), and a dense smoke layer's
  are 2 x its product parameters a cell x tokens + 4 b S^2 h dh;
- a cell's units times the cells equal ``FlopCounterMode`` over the whole
  step, for every arch's serving steps and most train steps;
- the meter's elementwise shortcut changes no dtype or count;
- the roofline records keep the reference's keys, price each axis at its
  link, and a ``tp1`` cell moves nothing over "model".
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))     # for benchmarks_torch.*

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from benchmarks_torch import roofline  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import builders, units  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, IB_BW, NVLINK_BW, PEAK_BF16_FLOPS,  # noqa: E402
                                     PEAK_FP32_FLOPS, make_mesh)

ARCHS = registry.list_archs()
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this file's meta and smoke-size tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REF_SCRIPT = """
import repro.launch.dryrun          # 512 forced host devices, before JAX starts
import json, sys
sys.path.insert(0, REPO)
from benchmarks import roofline as R
from repro.configs import registry
from repro.configs.base import SHAPES
res = {}
for a in registry.list_archs():
    spec = registry.get_arch(a)
    for s, shape in SHAPES.items():
        res[a + '|' + s] = [R.model_flops(spec.model, shape),
                            R.analytic_bytes(spec, shape, spec.microbatch, 256),
                            R.analytic_bytes(spec, shape, 1, 512)]
with open(OUT, 'w') as f:
    json.dump(res, f)
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from test_distributed import run_script

    out = tmp_path_factory.mktemp("roofline_ref") / "ref.json"
    run_script(_REF_SCRIPT.replace("REPO", repr(str(REPO))).replace("OUT", repr(str(out))))
    return json.loads(out.read_text())


@pytest.mark.mesh
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_model_flops_and_analytic_bytes_match_reference(ref, arch, shape_name):
    spec, shape = registry.get_arch(arch), SHAPES[shape_name]
    mf, ab, ab1 = ref[f"{arch}|{shape_name}"]
    assert roofline.model_flops(spec.model, shape) == pytest.approx(mf, rel=REL)
    assert roofline.analytic_bytes(spec, shape, spec.microbatch, 256) == pytest.approx(ab, rel=REL)
    assert roofline.analytic_bytes(spec, shape, 1, 512) == pytest.approx(ab1, rel=REL)


# ---------------------------------------------------------------------------
# counted flops
# ---------------------------------------------------------------------------

def _meta_mesh(shape=(2, 4), axes=("data", "model")):
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


def _smoke(arch, **kw):
    return dataclasses.replace(registry.get_arch(arch), model=registry.smoke_config(arch), **kw)


def _unit(arch, mode, S, B=4):
    spec = _smoke(arch)
    mesh = _meta_mesh()
    policy = (builders._train_policy(spec, mesh) if mode == "train"
              else builders._serve_policy(spec, mesh))
    return units._layer_unit(spec, "attn", 1, mesh, B, S, policy, mode, builders.CellOpts(),
                             1.0), mesh, spec


@pytest.mark.parametrize("S", [64, 1024])
def test_dense_layer_flops_by_hand_and_flop_counter(S):
    """phi3's smoke layer (d=64, 4 heads x 16, d_ff 128) on data=2 x
    model=4: a cell holds 10240 product parameters (a head of q/k/v/o, 32
    of the 128 FFN columns) and 2 of the 4 rows; the attention scores and
    values are 4 b S^2 h dh more."""
    u, mesh, spec = _unit("phi3-mini-3.8b", "prefill", S)
    cfg = spec.model
    m = units.measure(u.fn, u.args, mesh.size, dict(mesh.shape))
    with FlopCounterMode(display=False) as fc:
        u.fn(*u.args)
    b, h = 2, cfg.n_heads // 4
    params = (4 * cfg.d_model * h * cfg.d_head + 3 * cfg.d_model * cfg.d_ff // 4)
    assert params == 10240
    hand = 2 * params * b * S + 4 * b * S * S * h * cfg.d_head
    assert m["flops"] == fc.get_total_flops() == hand * mesh.size
    attn = 4 * b * S * S * h * cfg.d_head * mesh.size
    if S <= 512:                  # one tile at the compute dtype
        assert m["flops_by_dtype"] == {"bfloat16": hand * mesh.size}
    else:                         # the chunked tiles in float32
        assert m["flops_by_dtype"] == {"bfloat16": hand * mesh.size - attn, "float32": attn}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b", "rwkv6-7b"])
def test_train_unit_flops_equal_flop_counter(arch):
    spec = _smoke(arch)
    mesh = _meta_mesh()
    kind = "rwkv" if arch.startswith("rwkv") else "attn"
    u = units._layer_unit(spec, kind, 1, mesh, 4, 64, builders._train_policy(spec, mesh),
                          "train", builders.CellOpts(), 1.0)
    m = units.measure(u.fn, u.args, mesh.size, dict(mesh.shape))
    with FlopCounterMode(display=False) as fc:
        u.fn(*u.args)
    assert m["flops"] == fc.get_total_flops() > 0
    assert m["peak_bytes"] > 0


_STEP = {"prefill": "prefill_32k", "decode": "decode_32k", "train": "train_4k"}
# every arch's serving steps; the train steps but the two recurrent ones
# (their blocks' units are the serving cases', their train steps take
# 25-50 s here); phi3's prefill again at 1024 tokens, the chunked tiles
_UNIT_CASES = ([(a, k, 64) for a in ARCHS for k in ("prefill", "decode")]
               + [(a, "train", 64) for a in ARCHS
                  if a not in ("recurrentgemma-2b", "rwkv6-7b")]
               + [("phi3-mini-3.8b", "prefill", 1024)])


@pytest.mark.parametrize("arch,kind,S", _UNIT_CASES)
def test_units_times_cells_equal_the_whole_step(arch, kind, S):
    """The roofline's decomposition (one layer of each kind x its trip
    count, the embedding, the head) counts what ``FlopCounterMode`` counts
    over the whole step on the same data=2 x model=4 cells, exactly.
    Under remat PyTorch's early-stopping recompute ends a checkpoint's
    recompute at its last saved tensor: a unit's checkpoint spans one
    data group's cells and the step's every cell, so the tails they skip
    differ (one FFN output product a region); both run without it here."""
    spec, mesh = _smoke(arch), _meta_mesh()
    shape = ShapeConfig(_STEP[kind], S, 8, kind)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        cost = units._cost(spec, shape, mesh, builders.CellOpts())
        cell = builders.build_cell(arch, shape.name, mesh, spec=spec, shape=shape)
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)
    assert sum(cost["flops_by_dtype"].values()) * mesh.size == fc.get_total_flops() > 0


def test_meter_promotes_zero_dim_operands_as_torch_does():
    """A 0-dim float32 operand does not widen a bfloat16 vector, an n-dim
    one does, whichever the meter's shortcut meets first."""
    a = torch.empty(8, dtype=torch.bfloat16, device="meta")
    s = torch.empty((), dtype=torch.float32, device="meta")
    v = torch.empty(8, dtype=torch.float32, device="meta")
    for first, second in ((s, v), (v, s)):
        with units.Meter():
            got = [torch.mul(a, first).dtype, torch.mul(a, second).dtype,
                   torch.mul(a, first).dtype]
        assert got == [torch.mul(a, first).dtype, torch.mul(a, second).dtype,
                       torch.mul(a, first).dtype]
    assert torch.mul(a, s).dtype == torch.bfloat16 and torch.mul(a, v).dtype == torch.float32


def _measured_with_outputs(u, mesh):
    outs = []
    m = units.measure(lambda *a: outs.append(u.fn(*a)), u.args, mesh.size, dict(mesh.shape))
    dtypes = []
    for leaf in units._leaves(outs):
        for t in (leaf.cells if isinstance(leaf, units.shd.Sharded) else [leaf]):
            if isinstance(t, torch.Tensor):
                dtypes.append(t.dtype)
    return m, dtypes


@pytest.mark.parametrize("arch,kind,mode", [
    ("phi3-mini-3.8b", "attn", "train"), ("olmoe-1b-7b", "attn", "decode"),
    ("recurrentgemma-2b", "rglru", "prefill"), ("rwkv6-7b", "rwkv", "decode")])
def test_meter_shortcut_changes_no_count(arch, kind, mode, monkeypatch):
    """A unit measured with the meter's elementwise shortcut and without
    it (every op run by PyTorch's meta kernels): the same outputs' dtypes,
    flops by dtype, bytes and working set."""
    spec, mesh = _smoke(arch), _meta_mesh()
    policy = (builders._train_policy(spec, mesh) if mode == "train"
              else builders._serve_policy(spec, mesh))
    u = units._layer_unit(spec, kind, 1, mesh, 4, 64, policy, mode, builders.CellOpts(), 1.0)
    fast, fast_dtypes = _measured_with_outputs(u, mesh)
    monkeypatch.setattr(units.Meter, "_pointwise", lambda self, *a: None)
    slow, slow_dtypes = _measured_with_outputs(u, mesh)
    assert fast_dtypes == slow_dtypes and fast_dtypes
    assert fast["flops_by_dtype"] == slow["flops_by_dtype"]
    assert (fast["bytes"], fast["peak_bytes"]) == (slow["bytes"], slow["peak_bytes"])


# ---------------------------------------------------------------------------
# records and terms
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "status", "chips", "hlo_flops_per_device",
            "hlo_bytes_per_device", "analytic_bytes_per_device", "memory_s_hlo_unfused",
            "collective_bytes_per_device", "model_flops_global", "useful_ratio", "terms_s",
            "dominant", "roofline_step_s", "mfu_upper_bound", "units"}


@pytest.mark.parametrize("arch,shape_name,kind", [
    ("phi3-mini-3.8b", "train_4k", "train"), ("phi3-mini-3.8b", "prefill_32k", "prefill"),
    ("recurrentgemma-2b", "decode_32k", "decode"), ("moonshot-v1-16b-a3b", "train_4k", "train")])
def test_roofline_cell_record(arch, shape_name, kind, tmp_path):
    shape = ShapeConfig(shape_name, 64, 16, kind)
    mesh = _meta_mesh()
    rec = roofline.roofline_cell(arch, shape_name, spec=_smoke(arch), shape=shape, mesh=mesh,
                                 out_dir=str(tmp_path))
    assert REF_KEYS <= set(rec) and rec["status"] == "ok" and rec["chips"] == 8
    assert (tmp_path / f"{arch}_{shape_name}.json").exists()
    t = rec["terms_s"]
    by = rec["flops_by_dtype"]
    assert t["compute_s"] == pytest.approx(by.get("bfloat16", 0) / PEAK_BF16_FLOPS
                                           + by.get("float32", 0) / PEAK_FP32_FLOPS, rel=1e-12)
    assert t["memory_s"] == rec["analytic_bytes_per_device"] / HBM_BW
    links = {"model": NVLINK_BW, "data": IB_BW, "data+model": IB_BW}
    assert t["collective_s"] == pytest.approx(sum(
        b / links[k] for k, b in rec["collective_bytes_by_axis"].items()), rel=1e-12)
    assert rec["roofline_step_s"] == max(t.values())
    assert rec["hlo_flops_per_device"] == pytest.approx(sum(u["flops"] for u in rec["units"]))
    assert rec["useful_ratio"] == rec["model_flops_global"] / (rec["hlo_flops_per_device"] * 8)
    assert {u["unit"] for u in rec["units"]} >= {"embed"}


def test_tp1_moves_nothing_over_model():
    rec = roofline.roofline_cell("phi3-mini-3.8b", "train_4k", builders.CellOpts(tp1=True),
                                 save=False, spec=_smoke("phi3-mini-3.8b"),
                                 shape=ShapeConfig("train_4k", 64, 16, "train"), mesh=_meta_mesh())
    assert set(rec["collective_bytes_by_axis"]) <= {"data", "data+model"}
    assert rec["collective_bytes_by_axis"]["data"] > 0


def test_bound_on_one_device():
    b = roofline.bound_on_one_device({"float32": 67e12, "bfloat16": 989.4e12}, 3.35e12 / 2)
    assert b["terms_s"] == {"compute_s": pytest.approx(2.0), "memory_s": pytest.approx(0.5)}
    assert b["bound_s"] == pytest.approx(2.0) and b["dominant"] == "compute_s"
    assert roofline.als_useful_flops(10, 2, 100) == 10 * (100 * 101 + 200) + 2 * (100 ** 3 / 3
                                                                                 + 2 * 100 ** 2)


def test_roofline_main_on_the_deployment(tmp_path):
    """The CLI at full width on the 256-cell deployment: phi3-mini's
    decode_32k costs 32 layers of 4 rows a cell against 32768 cached
    positions, two all-reduces over "model" a layer and one for the
    embedding, and is bound by the cache's bytes."""
    assert roofline.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                          "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "phi3-mini-3.8b_decode_32k.json").read_text())
    cfg = registry.get_arch("phi3-mini-3.8b").model
    b, h, L = 128 // 32, cfg.n_heads // 8, cfg.n_layers
    layer = (4 * cfg.d_model * cfg.n_heads * cfg.d_head + 3 * cfg.d_model * cfg.d_ff) // 8
    head = cfg.padded_vocab // 8 * cfg.d_model
    want = L * (2 * layer * b + 4 * b * h * cfg.d_head * 32768) + 2 * head * b
    assert rec["hlo_flops_per_device"] == want
    assert rec["dominant"] == "memory_s" and rec["chips"] == 256
    r = b * cfg.d_model * 2
    assert rec["collective_bytes_per_device"] == (2 * L + 1) * 2 * r * 7 / 8
