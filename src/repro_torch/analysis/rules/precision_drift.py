"""precision-drift: reduction-bound accumulators must stay float64.

The reference rule's dataflow (``repro/analysis/rules/precision_drift.py``)
keyed on the port's ``distributed.reduce.topology_reduce``, which the
streaming mesh driver calls on its per-data-shard Hermitian partials
(``outofcore/driver.py`` ``_reduce_and_solve``).  Those partials are
accumulated in float64 on the host: an f64 sum of f32 summands is exact,
hence association-free, which is the *only* reason the topology-aware
schedule can promise bit-identity with the flat all-reduce oracle.  One
stray narrowing cast on that dataflow silently re-introduces association
order into the result.

The rule runs per module, intraprocedurally with one level of in-file
call propagation:

1. every variable passed (possibly through ``list(x)`` / ``x[i]``) to a
   ``topology_reduce`` call is *reduction-bound*;
2. if a function's parameters are reduction-bound, the argument variables
   at that function's in-file call sites become reduction-bound too;
3. any assignment / aug-assignment to a reduction-bound variable whose
   right-hand side mentions a narrower dtype, and any narrowing method
   call on one (``.astype``, ``.to``, ``.type``, ``.float()``, ``.half()``,
   ``.bfloat16()``), is flagged; so is a narrow dtype inside the
   ``topology_reduce`` argument itself.

A narrower dtype is any spelling of float32/float16/bfloat16: numpy's and
torch's names (``np.float32``, ``torch.bfloat16``, ``"float32"``), and
torch's aliases ``torch.float`` and ``torch.half`` and methods
``.float()`` and ``.half()``.  A bare ``float`` (Python's, 64 bits) and the
string ``"float"`` (numpy's float64) are not narrow.

Downstream casts of the *result* (solving in f32 after the reduce) are
deliberately fine — the contract covers the summands, not the solve.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ParsedModule, Rule, dotted_name

NARROW = {"float32", "float16", "bfloat16", "f32", "half"}
#: attribute spellings: NARROW plus torch's ``torch.float`` / ``.float()``
NARROW_ATTRS = NARROW | {"float"}
#: methods whose call on a reduction-bound variable may narrow it
CASTS = ("astype", "to", "type", "float", "half", "bfloat16")
REDUCE_FUNCS = ("topology_reduce",)


def _base_var(node: ast.expr) -> str | None:
    """The variable a reduce argument ultimately reads: unwrap list()/
    slices/indexing; attributes and other calls are opaque."""
    while True:
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func)
            if fn in ("list", "tuple") and node.args:
                node = node.args[0]
                continue
            return None
        if isinstance(node, ast.Subscript):
            node = node.value
            continue
        if isinstance(node, ast.Name):
            return node.id
        return None


def _narrow_mentions(node: ast.AST) -> list[ast.AST]:
    """dtype-narrowing spellings anywhere in the subtree."""
    hits = []
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in NARROW_ATTRS:
            hits.append(n)
        elif isinstance(n, ast.Name) and n.id in NARROW:
            hits.append(n)
        elif (isinstance(n, ast.Constant) and isinstance(n.value, str)
              and n.value in NARROW):
            hits.append(n)
    return hits


class _FuncInfo:
    def __init__(self, node):
        self.node = node
        self.params = [a.arg for a in node.args.args]
        self.bound: set[str] = set()           # reduction-bound names


class PrecisionDriftRule(Rule):
    name = "precision-drift"
    description = ("accumulators feeding distributed.reduce.topology_reduce "
                   "must be created and kept float64; narrowing casts on "
                   "that dataflow break the bit-exact reduction contract")
    # the reduction implementation converts internally by design
    exclude = ("src/repro_torch/distributed/reduce.py",)

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []

        def flag(node: ast.AST, msg: str) -> None:
            out.append(mod.finding(self.name, node, msg))

        funcs = [_FuncInfo(n) for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

        # pass 1: direct topology_reduce arguments (+ narrow dtypes inline)
        def reduce_calls(scope: ast.AST):
            for n in ast.walk(scope):
                if (isinstance(n, ast.Call)
                        and (dotted_name(n.func) or "").split(".")[-1]
                        in REDUCE_FUNCS):
                    yield n

        for info in funcs:
            for call in reduce_calls(info.node):
                for arg in call.args[:1]:      # parts argument
                    for hit in _narrow_mentions(arg):
                        flag(hit, "narrow dtype inside a topology_reduce "
                                  "argument; the summands must be float64 "
                                  "for the staged reduction to be bit-exact")
                    var = _base_var(arg)
                    if var:
                        info.bound.add(var)

        # pass 2: one level of in-file propagation — if f's params are
        # bound, the caller's argument variables are bound too
        bound_params = {
            info.node.name: {info.params.index(v) for v in info.bound
                             if v in info.params}
            for info in funcs if info.bound
        }
        if bound_params:
            for info in funcs:
                for n in ast.walk(info.node):
                    if not isinstance(n, ast.Call):
                        continue
                    callee = (dotted_name(n.func) or "").split(".")[-1]
                    idxs = bound_params.get(callee)
                    if not idxs:
                        continue
                    for i, arg in enumerate(n.args):
                        if i in idxs:
                            var = _base_var(arg)
                            if var:
                                info.bound.add(var)

        # pass 3: check every assignment/cast touching a bound variable.
        # Nested defs appear in both their own _FuncInfo and the enclosing
        # function's walk; dedupe findings by node identity.
        seen: set[int] = set()

        def flag_once(hits: list[ast.AST], msg: str) -> None:
            for hit in hits:
                if id(hit) not in seen:
                    seen.add(id(hit))
                    flag(hit, msg)

        def check_scope(info: _FuncInfo) -> None:
            for n in ast.walk(info.node):
                if isinstance(n, ast.Assign):
                    names = {t.id for t in n.targets
                             if isinstance(t, ast.Name)}
                    if names & info.bound:
                        flag_once(_narrow_mentions(n.value),
                                  f"reduction-bound accumulator "
                                  f"{sorted(names & info.bound)} assigned "
                                  "from a narrow-dtype expression; keep it "
                                  "float64 up to topology_reduce")
                elif isinstance(n, ast.AugAssign):
                    if (isinstance(n.target, ast.Name)
                            and n.target.id in info.bound):
                        flag_once(_narrow_mentions(n.value),
                                  f"narrow-dtype term accumulated into "
                                  f"reduction-bound '{n.target.id}'; "
                                  "partial sums must stay float64")
                elif isinstance(n, ast.Call):
                    f = n.func
                    if (isinstance(f, ast.Attribute) and f.attr in CASTS
                            and isinstance(f.value, ast.Name)
                            and f.value.id in info.bound):
                        flag_once(_narrow_mentions(n),
                                  f"'{f.value.id}.{f.attr}' narrows a "
                                  "reduction-bound accumulator; cast after "
                                  "the reduce, not before")

        for info in funcs:
            if info.bound:
                check_scope(info)
        return out
