"""The port's dry-run tools (``repro_torch.configs.registry.input_specs`` /
``cache_specs``, ``launch/builders.py``, ``launch/dryrun.py``, the
collective counter, ``benchmarks_torch/report.py``) against the
reference's, on meshes of meta cells.

The reference's side runs once in a subprocess (tests/test_distributed.py's
``run_script``) that imports ``repro.launch.dryrun`` first, so its JAX
starts with the 512 host devices the production meshes need; this process
never imports it (it plants that flag in ``os.environ``).

- every arch x shape on data=2 x model=4: the input and cache stand-ins
  (stacked and not, ``serve_seq_shard`` on and off) have the reference's
  shapes, dtypes and per-cell specs exactly, except RG-LRU's ``conv`` /
  ``h`` in the port's layout (split over "model" by channel); the
  reference's layout of those two (``rglru_layout="reference"``) equals it
  too;
- the bytes a cell holds of a built cell's arguments equal the reference's
  ``shard_shape`` bytes exactly (``conv`` / ``h`` a model-th of theirs);
- ``build_als_cell``'s ``meta`` equals the reference's for the three
  Table-5 cells on the single- and the multi-pod deployment;
- ``wire_bytes`` reproduces tests/test_builders_and_specs.py's three
  numbers, and the counter a hand count of one attention layer's decode;
- ``report``'s tables of records the port's ``run_cell`` and
  ``roofline_cell`` wrote equal the reference's ``report`` on the same
  records, but for the header and the mesh names.
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
    sys.path.insert(0, str(REPO))     # for benchmarks.* and benchmarks_torch.*

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.cumf_als import ALS_SHAPES  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import builders, dryrun, units  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = registry.list_archs()
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this file's meta and smoke-size tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta_mesh(shape=(2, 4), axes=("data", "model")):
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


def _entry(e):
    """A spec entry as the reference writes it: one axis as its name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else list(e)
    return e


def _rows(tree) -> list:
    """[name, shape, dtype, spec] of every leaf, dict keys sorted (the
    reference's ``tree_flatten`` order)."""
    out = []

    def walk(x, name):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], k)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, name)
        elif isinstance(x, shd.Sharded):
            out.append([name, list(x.shape), str(x.dtype).removeprefix("torch."),
                        [_entry(e) for e in x.spec]])
        else:
            out.append([name, list(x.shape), str(x.dtype).removeprefix("torch."), None])
    walk(tree, None)
    return out


_REF_SCRIPT = """
import repro.launch.dryrun          # 512 forced host devices, before JAX starts
import json
import jax, numpy as np
from repro.configs import registry
from repro.configs.base import SHAPES
from repro.configs.cumf_als import ALS_SHAPES
from repro.launch import builders
from repro.launch.dryrun import parse_collectives
from repro.launch.mesh import make_mesh, make_production_mesh

mesh = make_mesh((2, 4), ('data', 'model'))

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def rows(tree, sharded=True):
    out = []
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        k = path[-1]
        name = str(k.key) if hasattr(k, 'key') else str(getattr(k, 'name', getattr(k, 'idx', k)))
        spec = None
        nb = None
        if sharded:
            sp = list(x.sharding.spec) + [None] * (len(x.shape) - len(x.sharding.spec))
            spec = [entry(e) for e in sp]
            nb = int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
        out.append([name, list(x.shape), str(x.dtype), spec, nb])
    return out

res = {'specs': {}, 'plain': {}, 'bytes': {}, 'meta': {}, 'als': {}}
for a in registry.list_archs():
    cfg = registry.get_arch(a).model
    for s, shape in SHAPES.items():
        dp = builders._dp_spec(mesh, shape.batch)
        key = a + '|' + s
        res['specs'][key + '|input'] = rows(registry.input_specs(cfg, shape, mesh=mesh, dp_spec=dp))
        res['plain'][key + '|input'] = rows(registry.input_specs(cfg, shape), False)
        if shape.kind == 'decode':
            for stacked in (False, True):
                res['plain'][key + f'|cache|{stacked}'] = rows(
                    registry.cache_specs(cfg, shape, stacked=stacked), False)
                for seq in (False, True):
                    res['specs'][key + f'|cache|{stacked}|{seq}'] = rows(registry.cache_specs(
                        cfg, shape, mesh=mesh, dp_spec=dp, seq_shard_cache=seq, stacked=stacked))
        fn, args, kw, meta = builders.build_cell(a, s, mesh)
        res['meta'][key] = meta
        if fn is None:
            continue
        cache = rows(args[1]) if len(args) == 4 else []     # decode: the cache's
        res['bytes'][key] = [sum(x[4] for x in rows(args)),
                             sum(x[4] for x in cache if x[0] in ('conv', 'h'))]
for mp in (False, True):
    pm = make_production_mesh(multi_pod=mp)
    for name in ALS_SHAPES:
        res['als'][f'{name}|{mp}'] = builders.build_als_cell(name, pm)[3]
hlo = '''
  %ag = bf16[16,128]{1,0} all-gather(bf16[1,128] %p), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[64]{0} all-reduce(f32[64] %q), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[4,8]{1,0} reduce-scatter(f32[16,8] %r), replica_groups=[64,4]<=[256], dimensions={0}
'''
res['wire'] = parse_collectives(hlo)
with open(OUT, 'w') as f:
    json.dump(res, f)
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's stand-ins, cell bytes, cell and ALS metas and
    ``parse_collectives`` on its three-collective HLO snippet."""
    from test_distributed import run_script

    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    run_script(_REF_SCRIPT.replace("OUT", repr(str(out))))
    return json.loads(out.read_text())


def _ref_rows(rows):
    return [r[:4] for r in rows]


# ---------------------------------------------------------------------------
# specs and bytes
# ---------------------------------------------------------------------------

@pytest.mark.mesh
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_and_cache_specs_match_reference(ref, arch, shape_name):
    cfg = registry.get_arch(arch).model
    shape = SHAPES[shape_name]
    mesh = _meta_mesh()
    dp = builders._dp_spec(mesh, shape.batch)
    key = f"{arch}|{shape_name}"
    assert _rows(registry.input_specs(cfg, shape, mesh=mesh, dp_spec=dp)) == \
        _ref_rows(ref["specs"][key + "|input"])
    assert [r[:3] for r in _rows(registry.input_specs(cfg, shape))] == \
        [r[:3] for r in ref["plain"][key + "|input"]]
    if shape.kind != "decode":
        return
    for stacked in (False, True):
        assert [r[:3] for r in _rows(registry.cache_specs(cfg, shape, stacked=stacked))] == \
            [r[:3] for r in ref["plain"][f"{key}|cache|{stacked}"]]
        for seq in (False, True):
            want = _ref_rows(ref["specs"][f"{key}|cache|{stacked}|{seq}"])
            kw = dict(mesh=mesh, dp_spec=dp, seq_shard_cache=seq, stacked=stacked)
            assert _rows(registry.cache_specs(cfg, shape, rglru_layout="reference", **kw)) == want
            got = _rows(registry.cache_specs(cfg, shape, **kw))
            lead = [None] if stacked else []
            for g, w in zip(got, want):
                if g[0] in ("conv", "h"):        # split over "model" by channel
                    assert g[:3] == w[:3]
                    assert g[3] == w[3][:-1] + ["model"] and w[3][-1] is None
                    assert g[3][:len(lead) + 1] == lead + [_entry(dp)]
                else:
                    assert g == w
            assert len(got) == len(want)


@pytest.mark.mesh
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cell_argument_bytes_match_reference(ref, arch, shape_name):
    """A cell's bytes of its parameters, optimizer state or cache, and
    inputs equal the reference's per-device bytes, but for RG-LRU's cache
    ``conv`` and ``h``, a model-th of theirs here."""
    mesh = _meta_mesh()
    cell = builders.build_cell(arch, shape_name, mesh)
    key = f"{arch}|{shape_name}"
    assert cell.meta == ref["meta"][key]
    if cell.fn is None:
        assert key not in ref["bytes"]
        return
    total, rnn = ref["bytes"][key]
    mine_rnn = 0
    if len(cell.args) == 4:                # decode: (params, cache, tokens, lengths)
        mine_rnn = sum(builders.cell_bytes([builders.Layout(x.shape, x.spec, x.dtype)], mesh)
                       for name, x in _named(cell.args[1]) if name in ("conv", "h"))
    assert mine_rnn * mesh.shape["model"] == rnn
    assert builders.io_bytes(cell)["cell"]["argument"] == total - rnn + mine_rnn


def _named(tree, name=None):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named(v, name)
    else:
        yield name, tree


@pytest.mark.mesh
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", list(ALS_SHAPES))
def test_als_cell_meta_matches_reference(ref, name, multi_pod):
    """On meta cells of the reference's TPU pod layouts (16 x 16 and 2 x
    16 x 16) the metas are the reference's; on the H100 deployment's the
    same arithmetic gives p = 8 (16 with the pod) and q = 32."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    cell = builders.build_als_cell(name, _meta_mesh(shape, axes))
    assert cell.meta == ref["als"][f"{name}|{multi_pod}"]
    h100 = builders.build_als_cell(name, make_production_mesh(multi_pod=multi_pod)).meta
    als = ALS_SHAPES[name]
    p, q = (16 if multi_pod else 8), 32
    granule = p * q * 2048
    m_wave = max(granule, als.rows_per_wave // granule * granule)
    assert h100 == {"m_wave": m_wave, "k_loc": als.k_pad, "p": p, "q": q, "f": als.spec.f,
                    "scheme": "two_phase", "row_block": 2048,
                    "waves_total": max(1, -(-als.spec.m // m_wave))}


@pytest.mark.mesh
def test_wire_bytes_reproduce_parse_collectives(ref):
    """tests/test_builders_and_specs.py's three numbers."""
    w = ref["wire"]["bytes"]
    assert coll.wire_bytes("all-gather", 16 * 128 * 2, 16) == w["all-gather"] == 16 * 128 * 2 * 15 / 16
    assert coll.wire_bytes("all-reduce", 64 * 4, 4) == w["all-reduce"] == 2 * 64 * 4 * 3 / 4
    assert coll.wire_bytes("reduce-scatter", 4 * 8 * 4, 4) == w["reduce-scatter"] == 4 * 8 * 4 * 3


# ---------------------------------------------------------------------------
# the deployment, meta cells, the counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod,shape", [(False, {"data": 32, "model": 8}),
                                             (True, {"pod": 2, "data": 32, "model": 8})])
def test_production_mesh_is_meta_cells(multi_pod, shape):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert dict(mesh.shape) == shape and mesh.size == math.prod(shape.values())
    assert {d.type for d in mesh.devices.flat} == {"meta"}


def test_meta_only_when_named():
    from repro_torch import backend

    assert backend.resolve_device("meta").type == "meta"
    assert backend.default_mode("meta") == "ref"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            backend.resolve_device(None)
    with pytest.raises(ValueError):
        backend.resolve_device("xpu")


def test_counting_costs_nothing_outside_a_context():
    parts = [torch.ones(4), torch.ones(4)]
    assert coll._COUNTER is None
    coll.all_reduce(parts)
    with coll.counting(2) as ctr:
        coll.all_reduce(parts)
        coll.all_gather(parts)
        coll.reduce_scatter_flat(parts)
    assert coll._COUNTER is None
    s = ctr.summary()
    assert s["count"] == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
    assert s["bytes"] == {"all-reduce": 2 * 16 * 1 / 2, "all-gather": 32 * 1 / 2,
                          "reduce-scatter": 8 * 1}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen1.5-4b"])
def test_counter_hand_counts_one_attention_decode(arch):
    """One attention layer's decode on data=2 x model=4: the attention's
    and the MLP's row-parallel all-reduce over "model", 2 r (g - 1) / g
    each, r a cell's [b, 1, D] bf16 rows; nothing else crosses cells."""
    cfg = registry.smoke_config(arch)
    spec = dataclasses.replace(registry.get_arch(arch), model=cfg, serve_seq_shard=False)
    mesh = _meta_mesh()
    B, S = 4, 32
    u = units._layer_unit(spec, "attn", 1, mesh, B, S, builders._serve_policy(spec, mesh),
                          "decode", builders.CellOpts(), 1.0)
    m = units.measure(u.fn, u.args, mesh.size, dict(mesh.shape))
    s = m["collectives"].summary()
    r = (B // 2) * 1 * cfg.d_model * 2
    assert s["count"] == {"all-reduce": 2}
    assert s["bytes"] == {"all-reduce": 2 * (2 * r * 3 / 4)}
    assert s["bytes_by_axis"] == {"model": 2 * (2 * r * 3 / 4)}


def test_counter_prices_groups_at_the_deployment_size():
    """A gather over "data" counted on a unit mesh whose data axis is cut
    to 1 is priced at the deployment's group; its backward is the
    reduce-scatter of a block."""
    mesh = _meta_mesh((1, 4))
    leaf = shd.zeros((64, 8), ("data", "model"), mesh, torch.float32)
    with coll.counting(4, {"data": 32, "model": 4}) as ctr:
        parts = [t.requires_grad_(True) for t in leaf.cells]
        out = coll.all_gather_dims(shd.Sharded(leaf.spec, leaf.shape, mesh, parts), {0})
        sum(t.sum() for t in out).backward()
    s = ctr.summary()
    full = 64 * 2 * 4                  # a cell's gathered [64, 2] float32
    assert s["count"] == {"all-gather": 1, "reduce-scatter": 1}
    assert s["bytes"]["all-gather"] == full * 31 / 32
    assert s["bytes"]["reduce-scatter"] == full / 32 * 31


# ---------------------------------------------------------------------------
# the dry-run itself
# ---------------------------------------------------------------------------

def _smoke(arch, **kw):
    return dataclasses.replace(registry.get_arch(arch), model=registry.smoke_config(arch), **kw)


SMOKE_SHAPES = {"train_4k": ShapeConfig("train_4k", 64, 16, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 64, 4, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode")}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b", "recurrentgemma-2b",
                                  "rwkv6-7b"])
@pytest.mark.parametrize("shape_name", list(SMOKE_SHAPES))
def test_run_cell_records_fit_and_cost(arch, shape_name):
    mesh = _meta_mesh()
    rec = dryrun.run_cell(arch, shape_name, spec=_smoke(arch), shape=SMOKE_SHAPES[shape_name],
                          mesh=mesh)
    assert rec["status"] == "ok" and rec["mesh"] == [2, 4]
    m = rec["memory"]
    assert m["fits"] and 0 < m["argument_bytes"] < m["peak_estimate_bytes"] \
        < m["live_set_estimate_bytes"]
    assert m["live_set_estimate_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                                            - m["alias_bytes"] + 2 * m["working_set_bytes"])
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["total_bytes"] > 0
    if shape_name == "train_4k":
        assert rec["meta"]["opt"] == "adamw" and m["alias_bytes"] > 0
    d = m["device"]
    assert d["argument_bytes"] >= m["argument_bytes"]
    base = d["argument_bytes"] + d["output_bytes"] - d["alias_bytes"]
    assert (d["peak_estimate_bytes"], d["live_set_estimate_bytes"]) == (
        base + d["working_set_bytes"], base + 2 * d["working_set_bytes"])


def test_run_als_cell_on_a_small_mesh():
    """The netflix wave at its production rows a data shard, on data=2 x
    model=4 meta cells: one data shard's wave measured, reduce-scatters of
    A, B and the counts over "model" and an all-gather each row block."""
    mesh = _meta_mesh()
    rec = dryrun.run_als_cell("netflix", mesh=mesh, m_wave=2 * 4 * 2048)
    assert rec["status"] == "ok" and rec["meta"]["m_wave"] == 16384
    c = rec["collectives"]["count"]
    blocks = 16384 // 2 // 2048               # a data shard's rows in blocks of 2048
    assert c == {"reduce-scatter": 3 * blocks, "all-gather": blocks}
    assert rec["memory"]["fits"] and rec["cost"]["flops_by_dtype"].keys() == {"float32"}


def test_dryrun_main_writes_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "run_cell", lambda a, s, mp, opts=None: {
        "arch": a, "shape": s, "status": "ok", "memory": {"fits": True,
                                                          "live_set_estimate_bytes": 1}})
    assert dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "phi3-mini-3.8b_decode_32k_mp.json", "phi3-mini-3.8b_decode_32k_sp.json"]
    assert dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k", "--single-pod",
                        "--resume", "--out", str(tmp_path)]) == 0


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def test_report_tables_match_reference(tmp_path, monkeypatch):
    from benchmarks import report as ref_report
    from benchmarks_torch import report, roofline

    dry, roof = tmp_path / "dry", tmp_path / "roof"
    for i, arch in enumerate(("phi3-mini-3.8b", "rwkv6-7b")):
        for shape_name in ("train_4k", "decode_32k"):
            for mp, mesh in ((False, _meta_mesh()), (True, _meta_mesh((2, 2, 2),
                                                                      ("pod", "data", "model")))):
                rec = dryrun.run_cell(arch, shape_name, spec=_smoke(arch),
                                      shape=SMOKE_SHAPES[shape_name], mesh=mesh)
                dryrun._save(rec, f"{arch}_{shape_name}_{'mp' if mp else 'sp'}", str(dry))
            roofline.roofline_cell(arch, shape_name, spec=_smoke(arch),
                                   shape=SMOKE_SHAPES[shape_name], mesh=_meta_mesh(),
                                   out_dir=str(roof))
    dryrun._save({"arch": "qwen3-4b", "shape": "long_500k", "status": "skip"},
                 "qwen3-4b_long_500k_sp", str(dry))
    dryrun._save(dryrun.run_als_cell("netflix", mesh=_meta_mesh(), m_wave=16384),
                 "als_netflix_sp", str(dry))
    monkeypatch.setattr(ref_report, "DRY", str(dry))
    monkeypatch.setattr(ref_report, "ROOF", str(roof))
    mine = report.dryrun_table(str(dry)).splitlines()
    theirs = ref_report.dryrun_table().splitlines()
    assert len(mine) == len(theirs) == 2 + 4 * 2 + 2
    assert mine[0] != theirs[0]
    assert mine[1:] == [ln.replace("| 2x16x16 |", "| 2x32x8 |").replace("| 16x16 |", "| 32x8 |")
                        for ln in theirs[1:]]
    mine, theirs = report.roofline_table(directory=str(roof)), ref_report.roofline_table()
    assert mine.splitlines()[1:] == theirs.splitlines()[1:] and len(mine.splitlines()) == 6
    assert report.summary_stats(str(dry)) == ref_report.summary_stats()


# ---------------------------------------------------------------------------
# the reference's tests/test_builders_and_specs.py cases on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_all_shapes(arch):
    cfg = registry.get_arch(arch).model
    for shape in SHAPES.values():
        specs = registry.input_specs(cfg, shape)
        if shape.kind in ("train", "prefill"):
            key = "embeds" if cfg.frontend else "tokens"
            assert key in specs
            assert specs[key].shape[0] == shape.batch
            assert specs[key].shape[1] == shape.seq
            if shape.kind == "train":
                assert tuple(specs["labels"].shape) == (shape.batch, shape.seq)
        else:
            assert tuple(specs["lengths"].shape) == (shape.batch,)
        assert all(t.device.type == "meta" for t in T.tree_leaves(specs))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_analytic_count(arch):
    cfg = registry.get_arch(arch).model
    sizes = []
    T._shape_tree_map(lambda _, s: sizes.append(math.prod(s)), T.param_shapes(cfg))
    total = sum(sizes)
    analytic = cfg.params_count()
    pad_slack = 1.0 + (cfg.padded_heads / cfg.n_heads - 1.0) + 0.05
    assert analytic * 0.995 <= total <= analytic * pad_slack * 1.15, (arch, analytic, total)


def test_skip_rules():
    assert registry.get_arch("qwen3-4b").skip_reason(SHAPES["long_500k"])
    assert registry.get_arch("rwkv6-7b").skip_reason(SHAPES["long_500k"]) is None
    assert registry.get_arch("recurrentgemma-2b").skip_reason(SHAPES["long_500k"]) is None
    for a in ARCHS:
        assert registry.get_arch(a).skip_reason(SHAPES["train_4k"]) is None
        cell = builders.build_cell(a, "long_500k", _meta_mesh())
        assert (cell.fn is None) == bool(registry.get_arch(a).skip_reason(SHAPES["long_500k"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_vocab_and_kv(arch):
    cfg = registry.get_arch(arch).model
    assert cfg.padded_vocab % 16 == 0 and cfg.padded_vocab >= cfg.vocab
    if cfg.vocab >= 1024:
        assert cfg.padded_vocab % 256 == 0
    if not cfg.attn_free:
        assert cfg.padded_heads % cfg.padded_kv == 0


def test_cache_specs_layout():
    cfg = registry.get_arch("qwen3-4b").model
    shape = SHAPES["decode_32k"]
    cache = registry.cache_specs(cfg, shape)
    groups = cache["blocks"][0]
    assert isinstance(groups, list) and len(groups) == cfg.n_layers
    k = groups[0]["0"]["k"]
    assert tuple(k.shape) == (shape.batch, shape.seq, cfg.padded_kv, cfg.d_head)
    stacked = registry.cache_specs(cfg, shape, stacked=True)
    ks = stacked["blocks"][0]["0"]["k"]
    assert tuple(ks.shape) == (cfg.n_layers,) + tuple(k.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_groups_cover_all_layers(arch):
    cfg = registry.get_arch(arch).model
    assert sum(len(pat) * rep for pat, rep in T.scan_groups(cfg)) == cfg.n_layers


def test_tp1_view_folds_model_into_data():
    mesh = _meta_mesh()
    view = builders.tp1_view(mesh)
    assert dict(view.shape) == {"data": 8, "model": 1} and view.size == mesh.size
    cell = builders.build_cell("phi3-mini-3.8b", "train_4k", mesh, builders.CellOpts(tp1=True),
                               spec=_smoke("phi3-mini-3.8b"), shape=SMOKE_SHAPES["train_4k"])
    assert cell.meta["tp1"] and cell.io["mesh"].shape["model"] == 1
    emb = cell.args[0].params["embed"]
    assert emb.spec == ("model", "data") and emb.local_shape()[1] == 64 // 8

