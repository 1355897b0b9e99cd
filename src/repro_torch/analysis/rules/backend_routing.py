"""backend-routing: the port stands alone and never falls back from the card.

The reference's compat-routing keeps every version-sensitive JAX surface
in one shim.  The port's counterpart guards the two ground rules of
``repro_torch.backend``, the module that chooses devices and kernel modes:

(a) **no JAX and nothing of the reference.**  Any import of ``jax``,
    ``jaxlib`` or ``repro`` — at module scope, inside a function (a lazy
    import), or through ``importlib.import_module("...")`` /
    ``__import__("...")`` with a constant name — is flagged.  The roots are
    the ones ``tests/test_torch_isolation.py`` holds to the same rule:
    the package, its examples and benches, and ``chip_smoke.py``.
(b) **no probe-and-fallback device choice.**  A conditional whose test
    probes ``torch.cuda.is_available()`` / ``torch.cuda.device_count()``
    (directly, or through a name assigned from a probe) and whose branches
    name the ``"cpu"`` device quietly moves a run off the card; devices
    come from ``backend.resolve_device``, which raises instead.  A probe
    whose result is a tag (provenance, a cache key) and not the device the
    work runs on carries a suppression whose line says so.
(c) **no kernel quietly giving way.**  An ``except`` handler that calls a
    plain version — a ``kernels.ref`` function, or any ``*_plain`` /
    ``*_ref`` callable — turns a failed launch into a slow, silent run.

``backend.py`` itself is excluded: it is where the device is chosen.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ParsedModule, Rule, dotted_name

#: top-level packages the port must never import
BANNED_ROOTS = frozenset({"jax", "jaxlib", "repro"})

#: ``torch.cuda`` calls that probe for a card
PROBES = ("cuda.is_available", "cuda.device_count")

#: the module of the kernels' plain versions
REF_MODULE = "repro_torch.kernels.ref"


def import_sites(tree: ast.AST) -> list[tuple[ast.AST, str]]:
    """Every import in ``tree`` with the top-level package it names: the
    ``import`` statements, absolute ``from`` imports, and
    ``importlib.import_module`` / ``__import__`` calls with a constant."""
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            sites += [(node, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            sites.append((node, (node.module or "").split(".")[0]))
        elif isinstance(node, ast.Call):
            leaf = (dotted_name(node.func) or "").split(".")[-1]
            if (leaf in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                sites.append((node, str(node.args[0].value).split(".")[0]))
    return sites


def _is_probe(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (dotted_name(node.func) or "").endswith(PROBES))


def _mentions(node: ast.AST, probe_names: set[str]) -> bool:
    """``node`` calls a probe or reads a name assigned from one."""
    return any(_is_probe(n) or (isinstance(n, ast.Name) and n.id in probe_names)
               for n in ast.walk(node))


def _names_cpu(nodes) -> bool:
    """Some ``"cpu"`` / ``"cpu:N"`` literal lies in ``nodes``."""
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str)
               and (n.value == "cpu" or n.value.startswith("cpu:"))
               for node in nodes for n in ast.walk(node))


class BackendRoutingRule(Rule):
    name = "backend-routing"
    description = ("the port imports no jax/jaxlib/repro, chooses no device "
                   "by probing torch.cuda with a CPU branch, and calls no "
                   "plain version from an except handler (repro_torch.backend "
                   "owns device choice)")
    roots = ("src/repro_torch", "examples_torch", "benchmarks_torch",
             "chip_smoke.py")
    exclude = ("src/repro_torch/backend.py",)

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []

        def flag(node: ast.AST, msg: str) -> None:
            out.append(mod.finding(self.name, node, msg))

        # (a) imports
        for node, root in import_sites(mod.tree):
            if root in BANNED_ROOTS:
                flag(node, f"import of '{root}': the port imports nothing of "
                           "JAX or of the reference package")

        # (b) probe-and-fallback device choice
        probe_names = {t.id for n in ast.walk(mod.tree)
                       if isinstance(n, ast.Assign) and _mentions(n.value, set())
                       for t in n.targets if isinstance(t, ast.Name)}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.IfExp, ast.If)):
                if not _mentions(node.test, probe_names):
                    continue
                branches = ([node.body, node.orelse] if isinstance(node, ast.IfExp)
                            else node.body + node.orelse)
                if _names_cpu(branches):
                    flag(node, "device chosen by probing torch.cuda with a "
                               "CPU branch; take it from backend.resolve_device "
                               "(which raises without a card) or the caller")

        # (c) plain versions called from an except handler
        ref_aliases = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "repro_torch.kernels":
                ref_aliases |= {a.asname or a.name for a in node.names if a.name == "ref"}
            elif isinstance(node, ast.ImportFrom) and node.module == REF_MODULE:
                ref_aliases |= {a.asname or a.name for a in node.names}
        for handler in ast.walk(mod.tree):
            if not isinstance(handler, ast.ExceptHandler):
                continue
            for stmt in handler.body:
                for n in ast.walk(stmt):
                    if not isinstance(n, ast.Call):
                        continue
                    dotted = dotted_name(n.func) or ""
                    leaf = dotted.split(".")[-1]
                    if (leaf.endswith(("_plain", "_ref"))
                            or dotted.split(".")[0] in ref_aliases
                            or dotted.startswith(REF_MODULE + ".")):
                        flag(n, f"'{dotted}' called from an except handler: a "
                                "kernel that fails must raise, not give way "
                                "to its plain version")
        return out
