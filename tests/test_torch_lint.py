"""The port's lint (``repro_torch.analysis``): one flagged and one clean
snippet per rule, the seeded violations each rule exists to catch, its
engine and CLI, and parity with the reference lint (``repro.analysis``).

Parity: on the same snippet files the port's engine and its copied rules
give the same findings as the reference's, a finding being the tuple
(rule, line, col, snippet): obs-routing and bin-shape, the numpy
spellings of precision-drift and checkpoint-aliasing, and the engine's
suppressions, baseline, parse errors and ``--json`` payload.  The
lint's verdict on the real repo is the last test: clean at merge.
"""
import json
import pathlib
import shutil
import textwrap

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.analysis import engine as r_engine  # noqa: E402
from repro.analysis.__main__ import main as r_cli_main  # noqa: E402
from repro.analysis.rules.bin_shape import BinShapeRule as RBinShape  # noqa: E402
from repro.analysis.rules.checkpoint_aliasing import \
    CheckpointAliasingRule as RCheckpointAliasing  # noqa: E402
from repro.analysis.rules.obs_routing import ObsRoutingRule as RObsRouting  # noqa: E402
from repro.analysis.rules.precision_drift import \
    PrecisionDriftRule as RPrecisionDrift  # noqa: E402
from repro_torch.analysis import engine  # noqa: E402
from repro_torch.analysis.__main__ import DEFAULT_BASELINE  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.analysis.engine import (AnalysisConfig, Baseline, Finding,  # noqa: E402
                                         iter_python_files, run_analysis)
from repro_torch.analysis.rules import ALL_RULES, get_rules, rule_names  # noqa: E402
from repro_torch.analysis.rules.backend_routing import BackendRoutingRule  # noqa: E402
from repro_torch.analysis.rules.bin_shape import BinShapeRule  # noqa: E402
from repro_torch.analysis.rules.checkpoint_aliasing import CheckpointAliasingRule  # noqa: E402
from repro_torch.analysis.rules.obs_routing import ObsRoutingRule  # noqa: E402
from repro_torch.analysis.rules.precision_drift import PrecisionDriftRule  # noqa: E402
from repro_torch.analysis.rules.shard_safety import (ShardSafetyRule,  # noqa: E402
                                                     axes_from_mesh_builder)
from repro_torch.analysis.rules.smem_budget import (SmemBudgetRule,  # noqa: E402
                                                    constexpr_value)

REPO = pathlib.Path(__file__).resolve().parent.parent
KERNELS = REPO / "src" / "repro_torch" / "kernels"
AXES = frozenset({"data", "model", "pod"})


def write(tmp_path, source, rel):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def run_rule(tmp_path, rule, source, rel="src/repro_torch/mod.py"):
    """Write ``source`` at ``tmp_path/rel`` and run one port rule over it."""
    path = write(tmp_path, source, rel)
    new, _ = run_analysis(AnalysisConfig(root=tmp_path, rules=[rule], paths=[path]))
    return new


def keys(findings):
    return [(f.rule, f.line, f.col, f.snippet) for f in findings]


def both(tmp_path, port_rule, ref_rule, source, rel="src/pkg/mod.py"):
    """The port's and the reference's findings on one snippet file."""
    path = write(tmp_path, source, rel)
    mine, _ = run_analysis(AnalysisConfig(root=tmp_path, rules=[port_rule], paths=[path]))
    ref, _ = r_engine.run_analysis(r_engine.AnalysisConfig(
        root=tmp_path, rules=[ref_rule], paths=[path]))
    return keys(mine), keys(ref)


# ---------------------------------------------------------------------------
# backend-routing
# ---------------------------------------------------------------------------

ROUTING_FLAGGED = {
    "lazy_jax_import": """
        def f(x):
            import jax
            return jax.numpy.asarray(x)
    """,
    "module_jax_import": "import jax.numpy as jnp\n",
    "jaxlib": "from jaxlib import xla_client\n",
    "reference_package": "from repro.core import als\n",
    "import_module": """
        import importlib

        def f():
            return importlib.import_module("repro.kernels.ops")
    """,
    "dunder_import": "m = __import__('jax')\n",
    "ifexp_probe": """
        import torch
        dev = "cuda" if torch.cuda.is_available() else "cpu"
    """,
    "device_count_probe": """
        import torch
        dev = torch.device("cuda:0" if torch.cuda.device_count() > 0 else "cpu")
    """,
    "probe_through_a_name": """
        import torch

        def pick():
            ok = torch.cuda.is_available()
            return torch.device("cuda" if ok else "cpu")
    """,
    "if_statement_probe": """
        import torch

        def pick():
            if torch.cuda.is_available():
                dev = "cuda"
            else:
                dev = "cpu"
            return dev
    """,
    "plain_in_except": """
        from repro_torch.kernels.hermitian import fused_herm_cuda, fused_herm_plain

        def herm(*a):
            try:
                return fused_herm_cuda(*a)
            except RuntimeError:
                return fused_herm_plain(*a)
    """,
    "kref_in_except": """
        from repro_torch.kernels import ref as kref
        from repro_torch.kernels.batch_solve import batch_solve_cuda

        def solve(A, B):
            try:
                return batch_solve_cuda(A, B)
            except (RuntimeError, OSError):
                return kref.solve_spd(A, B)
    """,
}


@pytest.mark.parametrize("case", sorted(ROUTING_FLAGGED))
def test_backend_routing_flags(tmp_path, case):
    found = run_rule(tmp_path, BackendRoutingRule(), ROUTING_FLAGGED[case])
    assert len(found) == 1, found
    assert found[0].rule == "backend-routing"


def test_backend_routing_seeded_violations_yield_exactly_their_finding(tmp_path):
    found = run_rule(tmp_path, BackendRoutingRule(), """
        import torch

        def run(x):
            import jax
            return x

        dev = "cuda" if torch.cuda.is_available() else "cpu"
    """)
    assert [(f.rule, f.line) for f in found] == [("backend-routing", 5),
                                                ("backend-routing", 8)]
    assert "jax" in found[0].message and "CPU branch" in found[1].message


def test_backend_routing_clean_spellings(tmp_path):
    found = run_rule(tmp_path, BackendRoutingRule(), """
        import importlib
        import numpy as np
        import torch
        from repro_torch.backend import resolve_device
        from repro_torch.kernels import ref as kref

        def pick(device=None):
            return resolve_device(device)

        def cards():
            return torch.cuda.device_count() if torch.cuda.is_available() else 0

        def need_card(n):
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if count < n:
                raise RuntimeError("pass devices=['cpu'] to run on the CPU")
            if not torch.cuda.is_available():
                raise RuntimeError("no card; pass device='cpu'")
            return [f"cuda:{i}" for i in range(n)]

        def call(fn, *a):
            try:
                return fn(*a)
            except RuntimeError as e:
                raise RuntimeError(f"kernel failed: {e}") from e

        def reference_side(A, B):
            return kref.batch_solve_ref(A, B)        # not in an except

        mod = importlib.import_module("repro_torch.kernels.ops")
    """)
    assert found == []


def test_backend_routing_excludes_the_backend_and_honours_a_tag_suppression(tmp_path):
    probe = 'dev = "cuda" if torch.cuda.is_available() else "cpu"'
    assert run_rule(tmp_path, BackendRoutingRule(), f"import torch\n{probe}\n",
                    rel="src/repro_torch/backend.py") == []
    assert run_rule(tmp_path, BackendRoutingRule(),
                    f"import torch\n{probe}  # a tag, not a device  "
                    "# reprolint: disable=backend-routing\n") == []


def test_backend_routing_scans_the_isolation_roots():
    rule = BackendRoutingRule()
    assert set(rule.roots) == {"src/repro_torch", "examples_torch", "benchmarks_torch",
                               "chip_smoke.py"}
    files = {p.relative_to(REPO).as_posix() for p in iter_python_files(REPO, rule.roots)}
    assert "chip_smoke.py" in files
    assert "src/repro_torch/analysis/engine.py" in files
    assert any(f.startswith("examples_torch/") for f in files)
    assert any(f.startswith("benchmarks_torch/") for f in files)


def test_the_two_provenance_tags_are_suppressed_as_tags():
    """core/autotune.py's and benchmarks_torch/history.py's card probes are
    tags: each carries a suppression on a line that says so, and neither
    is a baseline entry."""
    for rel in ("src/repro_torch/core/autotune.py", "benchmarks_torch/history.py"):
        path = REPO / rel
        mod = engine.ParsedModule.parse(path, REPO)
        raw = BackendRoutingRule().check_module(mod)
        assert len(raw) == 1, (rel, raw)
        line = mod.lines[raw[0].line - 1]
        assert "a tag, not a device" in line
        assert "backend-routing" in mod.suppressed_rules(raw[0].line)
    assert json.loads((REPO / DEFAULT_BASELINE).read_text()) == {"findings": []}


# ---------------------------------------------------------------------------
# smem-budget
# ---------------------------------------------------------------------------

@pytest.fixture
def kernels_copy(tmp_path):
    """A copy of ``src/repro_torch/kernels`` (Python modules and CUDA
    sources) under a scratch repo root."""
    dst = tmp_path / "src" / "repro_torch" / "kernels"
    shutil.copytree(KERNELS, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return tmp_path, dst


def _smem(root):
    new, _ = run_analysis(AnalysisConfig(root=root, rules=[SmemBudgetRule()]))
    return new


def _edit(path, old, new):
    text = path.read_text()
    assert old in text, (path, old)
    path.write_text(text.replace(old, new, 1))


def test_smem_budget_copy_is_clean(kernels_copy):
    root, _ = kernels_copy
    assert _smem(root) == []


def test_smem_budget_flags_kchunk_drift(kernels_copy):
    """The seeded violation: ``kChunk = 64`` in a copy of herm_tile.cuh
    yields exactly one finding, on budgets.py's HERM_CHUNK."""
    root, k = kernels_copy
    _edit(k / "csrc" / "herm_tile.cuh", "constexpr int kChunk = 32;",
          "constexpr int kChunk = 64;")
    found = _smem(root)
    assert [(f.rule, f.path, f.snippet.split("#")[0].strip()) for f in found] == \
        [("smem-budget", "src/repro_torch/kernels/budgets.py", "HERM_CHUNK = 32")]
    assert "kChunk = 64" in found[0].message


def test_smem_budget_flags_knb_drift(kernels_copy):
    root, k = kernels_copy
    _edit(k / "csrc" / "batch_solve.cu", "constexpr int kNB = 16;", "constexpr int kNB = 8;")
    found = _smem(root)
    assert [f.snippet.split("#")[0].strip() for f in found] == ["SOLVE_NB = 16"]


def test_smem_budget_flags_kmaxf_drift_in_every_copy(kernels_copy):
    """kMaxF of batch_solve.cu is copied twice: batch_solve.py's MAX_F and
    the batch_solve budget's f bound."""
    root, k = kernels_copy
    _edit(k / "csrc" / "batch_solve.cu", "constexpr int kMaxF = 128;",
          "constexpr int kMaxF = 96;")
    found = _smem(root)
    where = sorted((f.path.rsplit("/", 1)[1], f.snippet) for f in found)
    assert where == [("batch_solve.py", "MAX_F = 128"),
                     ("budgets.py", '"batch_solve": KernelBudget(')]


def test_smem_budget_flags_an_unbudgeted_library(kernels_copy):
    root, k = kernels_copy
    (k / "scan.py").write_text(
        "from repro_torch.kernels import build\n\n\n"
        "def _launcher():\n    return build.load(\"scan\").scan_launch\n")
    (k / "fine.py").write_text(
        "from repro_torch.kernels import build\n\n\n"
        "def _launcher():\n    return build.load(\"sgd_update\").sgd_plan_launch\n")
    found = _smem(root)
    assert [(f.path.rsplit("/", 1)[1], f.line) for f in found] == [("scan.py", 5)]
    assert "'scan'" in found[0].message


def test_smem_budget_flags_a_footprint_over_its_limit(kernels_copy):
    root, k = kernels_copy
    _edit(k / "budgets.py", "SMEM_BYTES = 227 * 1024", "SMEM_BYTES = 48 * 1024")
    found = _smem(root)
    assert sorted(f.snippet for f in found) == ['"fused_herm": KernelBudget(',
                                                '"herm_hbm_accum": KernelBudget(']
    assert all("66048 B" in f.message for f in found)


def test_smem_budget_declares_every_library_and_mirror():
    from repro_torch.kernels import budgets, build

    assert {b.library for b in budgets.BUDGETS.values()} | set(budgets.SMEM_FREE) \
        == set(build.KERNELS)
    assert len(budgets.MIRRORS) == 6
    for module, const, source, cname in budgets.MIRRORS:
        text = (KERNELS / "csrc" / source).read_text()
        assert constexpr_value(text, cname) is not None, (source, cname)
        assert (KERNELS / module).is_file()
    for name, b in budgets.BUDGETS.items():
        # the launch's bytes are exported for chip_smoke.py to hold
        src = (build.CSRC / f"{b.library}.cu").read_text()
        assert f'extern "C" size_t {name}_smem_bytes(int f)' in src, name


def test_constexpr_value_reads_integer_literals():
    text = ("namespace x {\nconstexpr int kA = 32;   // slots\n"
            "constexpr unsigned kB = 7u;\nconstexpr int kC = (kA + 1) / 8;\n}\n")
    assert constexpr_value(text, "kA") == 32
    assert constexpr_value(text, "kB") == 7
    assert constexpr_value(text, "kC") is None
    assert constexpr_value(text, "kD") is None


# ---------------------------------------------------------------------------
# precision-drift
# ---------------------------------------------------------------------------

DRIFT = """
    import numpy as np
    import torch
    from repro_torch.distributed.reduce import topology_reduce

    def wave(acc, part, plan):
        {line}
        return topology_reduce(list(acc), plan)
"""

DRIFT_FLAGGED = {
    "float_method": "acc = acc.float()",
    "half_method": "acc = acc.half()",
    "bfloat16_method": "acc = acc.bfloat16()",
    "to_narrow": "acc = acc.to(torch.float32)",
    "to_alias": "acc.to(torch.float)",
    "type_narrow": "acc = acc.type(torch.half)",
    "dtype_keyword": "acc = torch.zeros((4, 4), dtype=torch.bfloat16)",
    "dtype_alias": "acc = torch.zeros((4, 4), dtype=torch.float)",
    "narrow_term": "acc += part.float()",
    "astype": "acc.astype(np.float16)",
    "string_dtype": 'acc = acc.to(dtype=getattr(torch, "float16"))',
}


@pytest.mark.parametrize("case", sorted(DRIFT_FLAGGED))
def test_precision_drift_flags_torch_narrowings(tmp_path, case):
    found = run_rule(tmp_path, PrecisionDriftRule(), DRIFT.format(line=DRIFT_FLAGGED[case]))
    assert len(found) == 1, found
    assert found[0].rule == "precision-drift" and found[0].line == 7


@pytest.mark.parametrize("line", [
    "acc = acc.to(torch.float64)",
    "acc = torch.zeros((4, 4), dtype=torch.float64)",
    "acc += part.double()",
    "acc = acc.to(part.device)",
    "acc = np.zeros((4, 4), dtype=float)",
])
def test_precision_drift_clean_float64(tmp_path, line):
    assert run_rule(tmp_path, PrecisionDriftRule(), DRIFT.format(line=line)) == []


def test_precision_drift_seeded_float_before_reduce(tmp_path):
    """The seeded violation, through one level of in-file calls (the
    driver's ``_reduce_and_solve`` shape)."""
    found = run_rule(tmp_path, PrecisionDriftRule(), """
        from repro_torch.distributed import reduce as dreduce

        def _reduce(acc, topo):
            return dreduce.topology_reduce(list(acc), topo)

        def drive(acc, topo):
            acc = acc.float()
            out = _reduce(acc, topo)
            return out.float()             # after the reduce: fine
    """)
    assert [(f.rule, f.line) for f in found] == [("precision-drift", 8)]


def test_precision_drift_keeps_the_driver_dataflow_bound(tmp_path):
    """The streaming mesh driver's partials are reduction-bound where the
    rule looks: the file is clean, and one narrowing cast before its
    reduce is flagged."""
    rel = "src/repro_torch/outofcore/driver.py"
    text = (REPO / rel).read_text()
    old = "A = dreduce.topology_reduce(list(A_dev), topo, tracer=tracer)"
    assert old in text
    assert run_rule(tmp_path, PrecisionDriftRule(), text, rel=rel) == []
    cast = "A_dev = A_dev.astype(np.float32)\n            " + old
    found = run_rule(tmp_path, PrecisionDriftRule(), text.replace(old, cast), rel=rel)
    assert len(found) == 1, found


REF_DRIFT = {
    "narrow_accumulator": """
        import numpy as np
        from repro.distributed.reduce import topology_reduce

        def wave(parts, plan):
            acc = np.zeros((4, 4), dtype=np.float32)
            return topology_reduce(acc, plan)
    """,
    "one_call_level": """
        import numpy as np
        from repro.distributed.reduce import topology_reduce

        def _reduce_and_solve(A_dev, plan):
            return topology_reduce(A_dev, plan)

        def driver(plan):
            A_dev = np.zeros((4,), dtype=np.float32)
            return _reduce_and_solve(A_dev, plan)
    """,
    "astype": """
        import numpy as np
        from repro.distributed.reduce import topology_reduce

        def wave(acc, plan):
            acc.astype(np.float32)
            return topology_reduce(acc, plan)
    """,
    "inline_and_aug": """
        import numpy as np

        def wave(parts, plan, topology_reduce):
            acc = np.zeros((4,), np.float64)
            acc += parts[0].astype("float16")
            return topology_reduce([p.astype(np.float16) for p in acc], plan)
    """,
    "clean": """
        import numpy as np
        from repro.distributed.reduce import topology_reduce

        def wave(parts, plan):
            acc = np.zeros((4, 4), dtype=np.float64)
            acc += parts[0]
            total = topology_reduce(acc, plan)
            return total.astype(np.float32)
    """,
}


@pytest.mark.parametrize("case", sorted(REF_DRIFT))
def test_precision_drift_numpy_parity(tmp_path, case):
    mine, ref = both(tmp_path, PrecisionDriftRule(), RPrecisionDrift(), REF_DRIFT[case])
    assert mine == ref
    assert (case == "clean") == (mine == [])


# ---------------------------------------------------------------------------
# shard-safety
# ---------------------------------------------------------------------------

SHARD_FLAGGED = {
    "policy_rule_tuple": """
        def policy(mesh):
            return ShardingPolicy(name="x", rules={"ff": ("data", "modle"), "heads": "model"})
    """,
    "with_overrides": "p2 = policy.with_overrides(name='y', ff='modle')\n",
    "arg_specs": """
        io = {"in_place": (), "arg_specs": [("modle", None), ("data", None)]}
    """,
    "layout_spec": "out = Layout((4, 8), (\"modle\", None), torch.float32)\n",
    "collective_axes": "y = all_reduce(parts, dtype, axes=\"modle\")\n",
    "fast_and_slow_axes": "y = two_level_reduce_scatter(p, 2, fast_axes=(\"modle\",), slow_axes=(\"pod\",))\n",
    "unit_cut": "um = unit_mesh(mesh, cut=(\"modle\",))\n",
    "mesh_shape_key": "tp = mesh.shape[\"modle\"]\n",
    "mesh_shape_get": "tp = self.mesh.shape.get(\"modle\", 1)\n",
    "axis_names_test": "ok = \"modle\" in mesh.axis_names\n",
    "axis_filter": "ax = tuple(a for a in (\"modle\", \"pod\") if a in mesh.axis_names)\n",
    "parameter_default": "def decode(q, *, mesh, seq_axis=\"modle\", kv_axis=None):\n    pass\n",
}


@pytest.mark.parametrize("case", sorted(SHARD_FLAGGED))
def test_shard_safety_flags_unknown_axes(tmp_path, case):
    found = run_rule(tmp_path, ShardSafetyRule(axes=AXES), SHARD_FLAGGED[case])
    assert len(found) == 1, found
    assert found[0].rule == "shard-safety" and "'modle'" in found[0].message


def test_shard_safety_clean_axes_and_logical_dims(tmp_path):
    found = run_rule(tmp_path, ShardSafetyRule(axes=AXES), """
        def layouts(mesh, policy, parts, x):
            p = ShardingPolicy(rules={"ff": ("data", "model"), "vocab": "model",
                                      "norm": None, "qheads": "model" if x else None})
            spec = policy.spec(("vocab", "embed_d"))        # logical dims
            q = p.with_overrides(name="serve", ff="data")
            y = all_gather(parts, axis=0, axes="model")
            tp = mesh.shape.get("model", 1) * mesh.shape["data"] * x.shape[0]
            dims = x.sum(axis=-1)
            cfg = {"heads": 4}.get("heads")
            io = {"arg_specs": [(None, "model"), ("data", ("pod", "model"))]}
            return Layout((4, 4), ("data", None), None), unit_mesh(mesh, cut=("pod", "data"))
    """)
    assert found == []


def test_shard_safety_vocabulary_comes_from_the_scanned_mesh_builders(tmp_path):
    assert axes_from_mesh_builder(REPO / "src/repro_torch/launch/mesh.py") == AXES
    write(tmp_path, 'AXES = ("data", "expert")\n', "src/repro_torch/launch/mesh.py")
    found = run_rule(tmp_path, ShardSafetyRule(), """
        y = all_reduce(parts, dtype, axes="expert")
        z = all_reduce(parts, dtype, axes="model")
    """)
    assert [f.line for f in found] == [3]
    assert axes_from_mesh_builder(tmp_path / "missing.py") == AXES


# ---------------------------------------------------------------------------
# checkpoint-aliasing
# ---------------------------------------------------------------------------

COMMIT = """
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager

    def save(ckpt_dir, step, t, a):
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(step, {{"x": {value}}})
"""

ALIAS_FLAGGED = ["t.numpy()", "t.cpu()", "t.detach()", "t.detach().cpu().numpy()",
                 "t.to('cpu')", "t.contiguous()", "t.view(-1)", "t.reshape(4, -1)",
                 "torch.from_numpy(a)", "torch.as_tensor(a)", "np.asarray(a)",
                 "t[1:]", "state.x"]
ALIAS_CLEAN = ["t.clone()", "t.detach().clone()", "np.array(t.cpu())", "torch.tensor(a)",
               "t.clone().numpy()", "torch.zeros(3).numpy()", "a.copy()",
               "np.array(a, np.float64)", "torch.cat([t, t])", "3"]


@pytest.mark.parametrize("value", ALIAS_FLAGGED)
def test_checkpoint_aliasing_flags_torch_aliases(tmp_path, value):
    found = run_rule(tmp_path, CheckpointAliasingRule(), COMMIT.format(value=value))
    assert len(found) == 1, found
    assert found[0].rule == "checkpoint-aliasing" and found[0].line == 8


@pytest.mark.parametrize("value", ALIAS_CLEAN)
def test_checkpoint_aliasing_clean_copies(tmp_path, value):
    assert run_rule(tmp_path, CheckpointAliasingRule(), COMMIT.format(value=value)) == []


def test_checkpoint_aliasing_seeded_thunk_mutation(tmp_path):
    """The seeded violation: ``tree["x"] = t.cpu().numpy()`` in a
    WaveCheckpointer thunk — on the CPU both calls return views of ``t``."""
    found = run_rule(tmp_path, CheckpointAliasingRule(), """
        from repro_torch.outofcore.runtime import WaveCheckpointer

        def run(mgr, step, t, theta):
            ck = WaveCheckpointer(mgr)

            def tree_fn():
                tree = {"theta": theta.copy()}
                tree["x"] = t.cpu().numpy()
                return tree

            ck.save(step, tree_fn)
    """)
    assert [(f.rule, f.line) for f in found] == [("checkpoint-aliasing", 9)]
    assert ".numpy()" in found[0].message


@pytest.mark.parametrize("rel,old,new", [
    ("src/repro_torch/sgd/train.py", 'np.array(state.x.cpu())', "state.x.cpu().numpy()"),
    ("src/repro_torch/outofcore/sgd_driver.py", '"x": factors.x.copy()', '"x": factors.x'),
    ("src/repro_torch/outofcore/driver.py", "factors.x.copy(), factors.theta.copy()",
     "factors.x, factors.theta.copy()"),
], ids=["sgd_train", "sgd_driver", "als_driver"])
def test_checkpoint_aliasing_guards_the_three_commit_paths(tmp_path, rel, old, new):
    """Each commit path is clean as it stands, and the rule reaches it: the
    same file with one copy taken out is flagged once."""
    text = (REPO / rel).read_text()
    assert old in text
    assert run_rule(tmp_path, CheckpointAliasingRule(), text, rel=rel) == []
    found = run_rule(tmp_path, CheckpointAliasingRule(), text.replace(old, new, 1), rel=rel)
    assert len(found) == 1, found


REF_ALIAS = {
    "asarray": """
        import numpy as np
        from repro.checkpoint.manager import CheckpointManager

        def save(ckpt_dir, step, acc):
            mgr = CheckpointManager(ckpt_dir)
            tree = {"a_acc": np.asarray(acc, np.float64)}
            mgr.save(step, tree)
    """,
    "attribute_and_view": """
        from repro.checkpoint.manager import CheckpointManager

        def save(ckpt_dir, step, state, buf):
            mgr = CheckpointManager(ckpt_dir)
            mgr.save(step, {"x": state.x, "rows": buf[2:]})
    """,
    "thunk_mutation": """
        import numpy as np
        from repro.outofcore.runtime import WaveCheckpointer

        def run(ckpt_dir, step, acc):
            ck = WaveCheckpointer(ckpt_dir)

            def tree_fn():
                tree = {}
                tree["a_acc"] = np.asarray(acc, np.float64)
                tree["b"], tree["c"] = np.ascontiguousarray(acc), acc.copy()
                return tree

            ck.save(step, tree_fn)
    """,
    "lambda_and_conditional_manager": """
        import numpy as np

        def run(ckpt_dir, step, x):
            mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
            mgr.save(step, lambda: {"x": np.atleast_1d(x), "y": [x[0], 1]})
    """,
    "clean": """
        import numpy as np
        from repro.checkpoint.manager import CheckpointManager

        def save(ckpt_dir, step, x, acc):
            mgr = CheckpointManager(ckpt_dir)
            tree = {"x": x.copy(),
                    "a_acc": np.array(acc, np.float64),
                    "step": step}
            mgr.save(step, tree)
    """,
}


@pytest.mark.parametrize("case", sorted(REF_ALIAS))
def test_checkpoint_aliasing_numpy_parity(tmp_path, case):
    mine, ref = both(tmp_path, CheckpointAliasingRule(), RCheckpointAliasing(), REF_ALIAS[case])
    assert mine == ref
    assert (case == "clean") == (mine == [])


# ---------------------------------------------------------------------------
# obs-routing and bin-shape: copies of the reference rules
# ---------------------------------------------------------------------------

OBS = {
    "bare_clocks": """
        import time

        def slow_path():
            t0 = time.perf_counter()
            t1 = time.time()
            return t1 - t0
    """,
    "aliases": """
        import time as clock
        from time import perf_counter as pc, monotonic_ns

        def f():
            return clock.monotonic() + pc() + monotonic_ns()
    """,
    "suppressed": """
        import time

        def probe():
            return time.time()  # reprolint: disable=obs-routing
    """,
    "clean": """
        import time

        def fmt(t):
            return time.strftime("%H:%M", t)
    """,
}

BINS = {
    "grid_k_in_bin_loop": """
        def solve_all(fixed, binned, ell, kern):
            for b, rows in zip(binned.bins, binned.rows):
                kern(fixed, ell.idx[:, :ell.K], b.cnt)
    """,
    "comprehension_and_groups": """
        def sizes(binned, ell):
            return [b.m * ell.K for b in binned.bins]

        def sweep(grid, idx, kern):
            for k_t, ii, jj in _set_k_groups(grid, 0):
                kern(idx[ii, jj, :, :grid.K])
            return {b.K: ell.K for b in grid.bins}
    """,
    "clean": """
        def solve_all(fixed, binned, kern):
            out = []
            for b, rows in zip(binned.bins, binned.rows):
                kb = b.K
                out.append(kern(fixed, b.idx[:, :kb], b.cnt))
            return out

        def uniform(ell, kern):
            return kern(ell.idx[:, :ell.K])
    """,
}


@pytest.mark.parametrize("case", sorted(OBS))
def test_obs_routing_parity(tmp_path, case):
    mine, ref = both(tmp_path, ObsRoutingRule(), RObsRouting(), OBS[case])
    assert mine == ref
    assert len(mine) == {"bare_clocks": 2, "aliases": 3}.get(case, 0)


def test_obs_routing_exempts_the_ports_obs_layer(tmp_path):
    src = "import time\n\ndef now():\n    return time.perf_counter()\n"
    assert run_rule(tmp_path, ObsRoutingRule(), src, rel="src/repro_torch/obs/trace.py") == []
    assert len(run_rule(tmp_path, ObsRoutingRule(), src,
                        rel="src/repro_torch/outofcore/driver.py")) == 1


@pytest.mark.parametrize("case", sorted(BINS))
def test_bin_shape_parity(tmp_path, case):
    mine, ref = both(tmp_path, BinShapeRule(), RBinShape(), BINS[case])
    assert mine == ref
    assert len(mine) == {"grid_k_in_bin_loop": 1, "comprehension_and_groups": 3}.get(case, 0)


# ---------------------------------------------------------------------------
# engine: suppressions, baseline, parse errors — against the reference's
# ---------------------------------------------------------------------------

BAD_CLOCK = "import time\nt = time.perf_counter()\n"


def _both_engines(tmp_path, source, baseline=None, ref_baseline=None):
    path = write(tmp_path, source, "src/pkg/mod.py")
    mine = run_analysis(AnalysisConfig(root=tmp_path, rules=[ObsRoutingRule()],
                                       baseline=baseline, paths=[path]))
    ref = r_engine.run_analysis(r_engine.AnalysisConfig(
        root=tmp_path, rules=[RObsRouting()], baseline=ref_baseline, paths=[path]))
    return [keys(m) for m in mine], [keys(r) for r in ref]


@pytest.mark.parametrize("comment,silenced", [
    ("  # reprolint: disable=obs-routing", True),
    ("  # reprolint: disable=all", True),
    ("  # reprolint: disable=bin-shape, obs-routing", True),
    ("  # reprolint: disable=bin-shape", False),
    ("", False),
])
def test_engine_suppressions_match_the_reference(tmp_path, comment, silenced):
    mine, ref = _both_engines(tmp_path, BAD_CLOCK.rstrip("\n") + comment + "\n")
    assert mine == ref
    assert (mine[0] == []) == silenced


def test_engine_baseline_round_trip_and_line_churn_match_the_reference(tmp_path):
    first, _ = _both_engines(tmp_path, BAD_CLOCK)
    path = tmp_path / "src/pkg/mod.py"
    new, _ = run_analysis(AnalysisConfig(root=tmp_path, rules=[ObsRoutingRule()], paths=[path]))
    assert new and keys(new) == first[0]
    bl = tmp_path / "baseline.json"
    Baseline.write(bl, new)
    r_bl = tmp_path / "ref_baseline.json"
    r_engine.Baseline.write(r_bl, r_engine.run_analysis(r_engine.AnalysisConfig(
        root=tmp_path, rules=[RObsRouting()], paths=[path]))[0])
    assert json.loads(bl.read_text())["findings"][0]["justification"].startswith("TODO")
    for text in (BAD_CLOCK, "# a new comment\n\n" + BAD_CLOCK):
        # identity is (rule, path, snippet): pushing the line down keeps it
        mine, ref = _both_engines(tmp_path, text, Baseline.load(bl),
                                  r_engine.Baseline.load(r_bl))
        assert mine == ref
        assert mine[0] == [] and len(mine[1]) == 1


def test_engine_baseline_refuses_an_empty_justification_and_keeps_old_ones(tmp_path):
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": [
        {"rule": "obs-routing", "path": "src/mod.py", "snippet": "x = 1",
         "justification": "  "}]}))
    with pytest.raises(ValueError, match="justification"):
        Baseline.load(bl)
    with pytest.raises(ValueError, match="justification"):
        r_engine.Baseline.load(bl)
    f = Finding(rule="obs-routing", path="src/mod.py", line=1, col=0, message="m",
                snippet="bad line")
    Baseline.write(bl, [f], old=Baseline(entries={f.fingerprint: "known debt"}))
    assert json.loads(bl.read_text())["findings"][0]["justification"] == "known debt"


def test_engine_parse_error_matches_the_reference(tmp_path):
    mine, ref = _both_engines(tmp_path, "def broken(:\n    pass\n")
    assert mine == ref
    assert [k[0] for k in mine[0]] == ["parse-error"]


def test_engine_roots_may_be_files_and_skip_dirs_below_the_root(tmp_path):
    write(tmp_path, "x = 1\n", "tool.py")
    write(tmp_path, "x = 1\n", "pkg/a.py")
    write(tmp_path, "x = 1\n", "pkg/build/gen.py")
    write(tmp_path, "x = 1\n", "pkg/__pycache__/c.py")
    got = [p.relative_to(tmp_path).as_posix()
           for p in iter_python_files(tmp_path, ("pkg", "tool.py", "missing", "pkg/a.py"))]
    assert got == ["pkg/a.py", "tool.py"]
    # a root that itself lies under a directory named like a skipped one
    nested = tmp_path / "build" / "checkout"
    write(nested, "x = 1\n", "pkg/a.py")
    assert [p.name for p in iter_python_files(nested, ("pkg",))] == ["a.py"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_rule_catalog_pairs_each_reference_rule():
    assert rule_names() == ["backend-routing", "smem-budget", "precision-drift",
                            "shard-safety", "checkpoint-aliasing", "obs-routing",
                            "bin-shape"]
    assert len(ALL_RULES) == 7
    with pytest.raises(ValueError, match="unknown rule name"):
        get_rules(["smem-budget", "nope"])
    assert [r.name for r in get_rules(["bin-shape", "smem-budget"])] == \
        ["bin-shape", "smem-budget"]


def test_cli_unknown_rule_exits_2(capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--rule", "nope"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "unknown rule name" in err and "smem-budget" in err


def test_cli_list_rules_prints_seven(capsys):
    assert cli_main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == rule_names()


def test_cli_json_payload_matches_the_reference(tmp_path, capsys):
    bad = write(tmp_path, BAD_CLOCK, "src/repro_torch/mod.py")
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    rc = cli_main([str(bad), "--root", str(tmp_path), "--rule", "obs-routing", "--json", "-"])
    assert rc == 1
    out = capsys.readouterr().out
    payload = json.loads(out[:out.rindex("}") + 1])
    assert payload["rules"] == ["obs-routing"] and payload["grandfathered"] == []
    assert [(f["path"], f["line"]) for f in payload["new"]] == [("src/repro_torch/mod.py", 2)]
    out_json = tmp_path / "ref.json"
    assert r_cli_main([str(bad), "--root", str(tmp_path), "--rule", "obs-routing",
                       "--json", str(out_json)]) == 1
    ref = json.loads(out_json.read_text())
    assert set(payload) == set(ref)
    assert [set(f) for f in payload["new"]] == [set(f) for f in ref["new"]]
    assert [(f["rule"], f["line"], f["col"], f["snippet"]) for f in payload["new"]] == \
        [(f["rule"], f["line"], f["col"], f["snippet"]) for f in ref["new"]]


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    bad = write(tmp_path, BAD_CLOCK, "src/repro_torch/mod.py")
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    args = [str(bad), "--root", str(tmp_path), "--rule", "obs-routing"]
    assert cli_main(args) == 1
    assert cli_main(args + ["--write-baseline"]) == 0
    bl = tmp_path / DEFAULT_BASELINE
    assert len(json.loads(bl.read_text())["findings"]) == 1
    assert cli_main(args) == 0             # grandfathered now
    data = json.loads(bl.read_text())
    data["findings"][0]["justification"] = "measured on purpose"
    bl.write_text(json.dumps(data))
    assert cli_main(args + ["--write-baseline"]) == 0
    assert json.loads(bl.read_text())["findings"][0]["justification"] == "measured on purpose"


def test_cli_repo_is_clean_at_merge():
    """The acceptance criterion: ``python -m repro_torch.analysis`` exits
    0 on the repo, against an empty baseline."""
    assert json.loads((REPO / DEFAULT_BASELINE).read_text()) == {"findings": []}
    assert cli_main(["--root", str(REPO)]) == 0
