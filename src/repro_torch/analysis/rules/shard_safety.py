"""shard-safety: the port's mesh axis names come from the mesh builders.

The reference rule (``repro/analysis/rules/shard_safety.py``) reads
``P(...)`` specs, ``shard_map`` and ``lax`` collectives; the port spells
none of them.  Its layouts are plain tuples (``distributed/sharding.py``),
its collectives take ``axes=`` (``distributed/collectives.py``), and a
typo in an axis name raises only at run time, on a mesh, in whichever
path reaches it (``sharding.entry_axes``, ``mesh_forward``'s axis check).

The vocabulary is parsed from the mesh-builder module's AST (string
elements of tuple literals — the axes tuples of ``launch/mesh.py``), so
adding an axis to the builders widens the checker; ("data", "model",
"pod") if that module cannot be read.  Checked against it:

- the mesh-axis entries of layout specs: the rule values of
  ``ShardingPolicy(rules={...})`` and the overrides of
  ``.with_overrides(...)`` (their keys are logical dims — "heads", "ff",
  "vocab" — and are not checked), the ``"arg_specs"`` of a cell's io dict,
  and the spec of ``Layout(shape, spec, dtype)``;
- the string values of the axis keywords of the collectives and the
  dry-run units (``axes=``, ``fast_axes=``, ``slow_axes=``,
  ``col_axes=``, ``cut=``, and flash-decode's ``axis=``, ``seq_axis=``,
  ``kv_axis=``), in calls and in parameter defaults;
- the keys of ``<mesh>.shape[...]`` / ``<mesh>.shape.get(...)``, the
  left side of ``"<axis>" in <mesh>.axis_names``, and the string
  iterable of a comprehension filtered by ``a in <mesh>.axis_names``.

Only string literals are checked; names, calls and anything computed are
left alone — when in doubt, stay silent.  The reference's arity half
(``shard_map`` in_specs/out_specs against the mapped function) has no
counterpart: the port has no ``shard_map``.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Optional

from repro_torch.analysis.engine import (Finding, ParsedModule, Rule,
                                         dotted_name, keyword_arg)

#: fallback vocabulary if the mesh-builder module cannot be parsed
DEFAULT_AXES = frozenset({"data", "model", "pod"})

#: repo-relative module the axis vocabulary is declared in
MESH_BUILDER = "src/repro_torch/launch/mesh.py"

#: keyword arguments (and parameters) whose string values name mesh axes
AXIS_KEYWORDS = frozenset({"axes", "fast_axes", "slow_axes", "col_axes", "cut",
                           "axis", "seq_axis", "kv_axis"})

#: dict keys whose values are lists of layout specs
SPEC_KEYS = frozenset({"arg_specs"})


def axes_from_mesh_builder(path: pathlib.Path) -> frozenset[str]:
    """Axis names declared by the mesh builders: every string element of a
    tuple literal in the module (the ``axes`` tuples; shape tuples are
    ints and contribute nothing)."""
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return DEFAULT_AXES
    axes = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    axes.add(elt.value)
    return frozenset(axes) or DEFAULT_AXES


def _is_mesh_attr(node: ast.AST, attr: str) -> bool:
    """``<expr>.<attr>``: ``mesh.shape``, ``self.mesh.axis_names``."""
    return isinstance(node, ast.Attribute) and node.attr == attr


def _axis_names_test(test: ast.AST) -> Optional[str]:
    """The variable ``v`` of a ``v in <mesh>.axis_names`` test."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.In)
            and isinstance(test.left, ast.Name)
            and _is_mesh_attr(test.comparators[0], "axis_names")):
        return test.left.id
    return None


class ShardSafetyRule(Rule):
    name = "shard-safety"
    description = ("mesh axis names in layout specs, collective axes= "
                   "arguments and mesh.shape keys must come from the mesh "
                   "builders' declared vocabulary (launch/mesh.py)")

    def __init__(self, axes: Optional[frozenset[str]] = None):
        self._axes = axes

    def axes(self, repo_root: pathlib.Path) -> frozenset[str]:
        if self._axes is not None:
            return self._axes
        return axes_from_mesh_builder(repo_root / MESH_BUILDER)

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []
        vocab = self.axes(mod.root)
        seen: set[int] = set()          # a literal two checks reach counts once

        def check(node: Optional[ast.AST], what: str) -> None:
            """Every string literal in ``node`` must be a declared axis."""
            if node is None:
                return
            for n in ast.walk(node):
                if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                        and n.value not in vocab and id(n) not in seen):
                    seen.add(id(n))
                    out.append(mod.finding(
                        self.name, n,
                        f"{what} names axis '{n.value}', which no mesh "
                        f"builder declares (known: {sorted(vocab)})"))

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                fn = dotted_name(node.func) or ""
                leaf = fn.split(".")[-1]
                for kw in node.keywords:
                    if kw.arg in AXIS_KEYWORDS:
                        check(kw.value, f"{leaf}({kw.arg}=...)")
                if leaf == "ShardingPolicy":
                    rules = keyword_arg(node, "rules")
                    if isinstance(rules, ast.Dict):
                        for v in rules.values:
                            check(v, "a sharding policy's rule")
                elif leaf == "with_overrides":
                    for kw in node.keywords:
                        if kw.arg not in (None, "name"):
                            check(kw.value, f"with_overrides({kw.arg}=...)")
                elif leaf == "Layout":
                    check(node.args[1] if len(node.args) > 1
                          else keyword_arg(node, "spec"), "a Layout's spec")
                elif (leaf == "get" and node.args
                      and isinstance(node.func, ast.Attribute)
                      and _is_mesh_attr(node.func.value, "shape")):
                    check(node.args[0], "mesh.shape.get")
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value in SPEC_KEYS:
                        check(v, f"'{k.value}'")
            elif (isinstance(node, ast.Subscript)
                  and _is_mesh_attr(node.value, "shape")):
                # a tensor's shape is indexed by ints, a mesh's by axis
                check(node.slice, "mesh.shape[...]")
            elif (isinstance(node, ast.Compare)
                  and isinstance(node.left, ast.Constant)
                  and all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
                  and any(_is_mesh_attr(c, "axis_names") for c in node.comparators)):
                check(node.left, "a test on mesh.axis_names")
            elif isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
                for gen in node.generators:
                    if (isinstance(gen.target, ast.Name)
                            and any(_axis_names_test(t) == gen.target.id
                                    for t in gen.ifs)
                            and isinstance(gen.iter, (ast.Tuple, ast.List))):
                        check(gen.iter, "an axis filtered by mesh.axis_names")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                positional = args.posonlyargs + args.args
                pairs = list(zip(positional[len(positional) - len(args.defaults):],
                                 args.defaults))
                pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                          if d is not None]
                for a, d in pairs:
                    if a.arg in AXIS_KEYWORDS:
                        check(d, f"the default of '{a.arg}'")
        return out
