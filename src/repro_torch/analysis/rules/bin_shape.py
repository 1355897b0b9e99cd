"""bin-shape: per-bin kernel dispatches must use the bin's own K.

A copy of the reference rule (``repro/analysis/rules/bin_shape.py``) on
the port's tree.  The degree-binned layout (``sparse.padded.BinnedELL``,
per-tile ``tile_K`` grids) exists to dispatch each bin/group at its *own*
tight K.  The bug this rule catches statically: code inside a bin loop
that shapes a kernel argument with the grid-wide ``.K`` of an enclosing
object —

    for b, rows in zip(binned.bins, binned.rows):
        xb = solve(fixed, ell.idx[..., :ell.K], ...)   # <- grid-wide K

which silently re-pads every bin back to the global maximum, erasing the
entire fill win while staying numerically correct (masked padding slots
are exact zeros), so no test catches it.  Inside a bin-scoped loop or
comprehension the only legitimate ``.K`` is the one hanging off a
loop-bound name (``b.K``) — any other root is the enclosing layout's
grid-wide K and gets flagged.

Bin scope is syntactic: a ``for`` loop or comprehension whose iterable
mentions a ``.bins`` attribute or calls a ``*_k_groups`` helper.  False
positives (e.g. deliberately comparing against the grid K) carry a
``# reprolint: disable=bin-shape`` suppression with the reason.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ParsedModule, Rule, dotted_name


def _iter_is_bin_scoped(it: ast.AST) -> bool:
    """True when the iterable walks degree bins: references a ``.bins``
    attribute anywhere (``binned.bins``, ``zip(x.bins, x.rows)``) or calls
    a ``*_k_groups`` grouping helper."""
    for n in ast.walk(it):
        if isinstance(n, ast.Attribute) and n.attr == "bins":
            return True
        if isinstance(n, ast.Call):
            name = (dotted_name(n.func) or "").split(".")[-1]
            if name.endswith("_k_groups"):
                return True
    return False


def _target_names(target: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _root_name(node: ast.AST) -> str | None:
    """Leftmost Name of an attribute/subscript chain (``a.b[c].K`` -> a)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


class BinShapeRule(Rule):
    name = "bin-shape"
    description = ("inside a bin loop, kernel shapes must come from the "
                   "loop-bound bin's K, never the enclosing grid-wide .K")

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []

        def check_body(body_nodes: list[ast.AST], bound: set[str]) -> None:
            for stmt in body_nodes:
                for n in ast.walk(stmt):
                    # names (re)bound inside the loop body count as local
                    if isinstance(n, (ast.Assign, ast.AugAssign,
                                      ast.AnnAssign)):
                        tgts = n.targets if isinstance(n, ast.Assign) \
                            else [n.target]
                        for t in tgts:
                            bound |= _target_names(t)
                for n in ast.walk(stmt):
                    if (isinstance(n, ast.Attribute) and n.attr == "K"
                            and _root_name(n) not in bound):
                        out.append(mod.finding(
                            self.name, n,
                            f"'{ast.unparse(n)}' is the grid-wide K but a "
                            "per-bin K is in scope here — shape this "
                            "dispatch with the loop-bound bin's own K"))

        class V(ast.NodeVisitor):
            def visit_For(self, node: ast.For) -> None:
                if _iter_is_bin_scoped(node.iter):
                    check_body(node.body, _target_names(node.target))
                self.generic_visit(node)

            def _comp(self, node) -> None:
                bound: set[str] = set()
                scoped = False
                for gen in node.generators:
                    bound |= _target_names(gen.target)
                    scoped = scoped or _iter_is_bin_scoped(gen.iter)
                if scoped:
                    elts = [node.elt] if not isinstance(node, ast.DictComp) \
                        else [node.key, node.value]
                    check_body(elts, bound)
                self.generic_visit(node)

            visit_GeneratorExp = _comp
            visit_ListComp = _comp
            visit_SetComp = _comp
            visit_DictComp = _comp

        V().visit(mod.tree)
        return out
