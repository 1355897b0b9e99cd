"""smem-budget: the kernels' shared-memory budgets agree with the CUDA sources.

The reference's pallas-budget sizes every ``pallas_call`` against a
declared VMEM budget; the port has no ``pallas_call``.  Its fast-memory
contract is ``kernels/budgets.py``: each CUDA kernel's dynamic shared
memory (``footprint_bytes``), which the streaming driver's ledger
records, and which rests on constants copied by hand from the sources
(``HERM_CHUNK`` = ``kChunk``, ``SOLVE_NB`` = ``kNB``, the f bound =
``kMaxF``).  An edit to a source that leaves its copy behind would pass
every other check.  This rule reads the sources as text (no ``nvcc``)
and holds:

(a) every pair ``budgets.MIRRORS`` declares: the module-level constant
    of the Python module equals the ``constexpr`` of the source; and each
    ``BUDGETS`` entry's ``dim_bounds["f"]`` equals ``kMaxF`` of its
    ``source``;
(b) every ``build.load("<lib>")`` site in ``kernels/`` loads a library
    whose kernel has a ``BUDGETS`` entry, or one ``budgets.SMEM_FREE``
    declares free of dynamic shared memory;
(c) every entry's ``footprint_bytes`` over its declared range of f fits
    its ``smem_limit``.

``budgets.py`` is loaded by file path from the scanned tree, so the rule
needs no ``torch`` and checks the tree it scans.
"""
from __future__ import annotations

import ast
import importlib.util
import pathlib
import re
import sys
from typing import Optional

from repro_torch.analysis.engine import Finding, ParsedModule, Rule, dotted_name

#: repo-relative directory of the kernels, their budgets and ``csrc/``
KERNELS_DIR = "src/repro_torch/kernels"


def constexpr_value(text: str, name: str) -> Optional[int]:
    """The integer literal ``constexpr <type> <name> = <n>;`` gives in a
    CUDA source, or None when ``name`` is not such a constant."""
    m = re.search(rf"\bconstexpr\s+[\w:\s]*?\b{re.escape(name)}\s*=\s*"
                  rf"(\d+)[uUlL]*\s*;", text)
    return int(m.group(1)) if m else None


def module_constants(tree: ast.Module) -> dict[str, tuple[ast.AST, object]]:
    """Module-level ``NAME = <literal>`` assignments: name -> (node, value)."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)):
            out[node.targets[0].id] = (node, node.value.value)
    return out


def load_budgets(path: pathlib.Path):
    """``budgets.py`` at ``path``, imported under a private name (held in
    ``sys.modules`` while it runs, as its dataclasses need)."""
    name = "_reprolint_budgets"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules[name]
    return module


class SmemBudgetRule(Rule):
    name = "smem-budget"
    description = ("kernels/budgets.py's copies of CUDA constants equal their "
                   "constexprs, every build.load library has a budget or is "
                   "declared free of dynamic shared memory, and every "
                   "footprint fits its limit")
    roots = (KERNELS_DIR,)

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []
        kdir = mod.root / KERNELS_DIR
        if mod.path.resolve().parent != kdir.resolve():
            return out
        here = mod.path.name

        def flag(node: ast.AST, msg: str) -> None:
            out.append(mod.finding(self.name, node, msg))

        try:
            budgets = load_budgets(kdir / "budgets.py")
        except Exception as e:          # a lint reports what it cannot read
            if here == "budgets.py":
                flag(mod.tree, f"budgets.py does not load: {e!r}")
            return out
        csrc = kdir / "csrc"
        sources: dict[str, str] = {}

        def constexpr(source: str, name: str) -> Optional[int]:
            if source not in sources:
                path = csrc / source
                sources[source] = path.read_text() if path.is_file() else ""
            return constexpr_value(sources[source], name)

        # (a) this module's mirrored constants
        consts = module_constants(mod.tree)
        for module, const, source, cname in budgets.MIRRORS:
            if module != here:
                continue
            want = constexpr(source, cname)
            if const not in consts:
                flag(mod.tree, f"budgets.MIRRORS names {const} in {module}, "
                               "which defines no such module-level constant")
            elif want is None:
                flag(consts[const][0], f"{const} mirrors {cname} of "
                                       f"csrc/{source}, which has no integer "
                                       f"constexpr {cname}")
            elif consts[const][1] != want:
                flag(consts[const][0], f"{const} = {consts[const][1]!r} but "
                                       f"csrc/{source} has {cname} = {want}: "
                                       "the copy fell behind its source")

        # (b) every library loaded here has a budget or is declared free
        budgeted = {b.library for b in budgets.BUDGETS.values()}
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and (dotted_name(node.func) or "").endswith("build.load")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                lib = node.args[0].value
                if lib not in budgeted and lib not in budgets.SMEM_FREE:
                    flag(node, f"library '{lib}' has no budgets.BUDGETS "
                               "entry and is not in budgets.SMEM_FREE: "
                               "declare its kernel's shared memory")

        if here != "budgets.py":
            return out
        # (a) each entry's bounds against its source; (c) its footprint
        entries = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and k.value in budgets.BUDGETS:
                        entries[k.value] = k
        for kernel, b in budgets.BUDGETS.items():
            at = entries.get(kernel, mod.tree)
            bound = b.dim_bounds.get("f", 0)
            want = constexpr(b.source, "kMaxF")
            if bound != want:
                flag(at, f"{kernel}: dim_bounds['f'] = {bound} but "
                         f"csrc/{b.source} has kMaxF = {want}")
            worst = max((budgets.footprint_bytes(kernel, f=f)
                         for f in range(1, bound + 1)), default=0)
            if worst > b.smem_limit:
                flag(at, f"{kernel}: footprint {worst} B at f <= {bound} "
                         f"exceeds its smem_limit {b.smem_limit} B")
        return out
