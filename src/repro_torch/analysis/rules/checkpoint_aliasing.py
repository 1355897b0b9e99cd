"""checkpoint-aliasing: commit materialized copies, not live tensors.

The reference rule (``repro/analysis/rules/checkpoint_aliasing.py``)
taught two torch facts.  ``CheckpointManager.save`` commits on a
background thread, so anything reachable from the committed tree that a
later wave mutates in place races the writer and corrupts the checkpoint
silently.  The port's contract is that every value passed to a commit
path is a *materialized host copy* — and on the CPU two torch spellings
that look like copies are not: ``Tensor.numpy()`` shares the tensor's
storage, and ``.cpu()`` (like ``.to("cpu")``, ``.detach()``,
``.contiguous()``) of a CPU tensor returns the tensor itself.

The rule tracks, per function, variables bound to
``CheckpointManager(...)`` / ``WaveCheckpointer(...)`` and inspects every
``<mgr>.save(step, tree)`` call site:

- dict literals are checked value by value;
- a ``Name`` argument is resolved one level through local assignments;
- a function/lambda passed as the tree thunk (the ``WaveCheckpointer``
  protocol) is analyzed through its returned dict *and* any
  ``tree[key] = ...`` mutations on the returned variable;
- **OK**: ``x.clone()``, ``x.copy()``, ``np.array(...)`` and
  ``torch.tensor(...)`` (always copy), fresh allocations
  (``np.zeros``, ``torch.zeros``, ``torch.cat``, ...), scalar wrappers,
  constants, containers thereof, and an aliasing method called on one of
  those (``t.clone().numpy()``);
- **flagged**: ``.numpy()``, ``.cpu()``, ``.detach()`` and the other
  methods that may return their receiver or a view of it;
  ``torch.from_numpy`` / ``torch.as_tensor`` / ``np.asarray`` and the rest
  of that family (they share their input's memory); bare attribute reads
  (``state.x``); and subscripts/slices (views);
- anything unresolvable is left alone — the rule prefers silence to
  noise.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.engine import Finding, ParsedModule, Rule, dotted_name

MANAGER_TYPES = {"CheckpointManager", "WaveCheckpointer"}

#: calls that always return fresh storage
FRESH_CALLS = {"array", "zeros", "ones", "full", "empty", "eye", "stack",
               "concatenate", "copy", "deepcopy", "float", "int", "bool",
               "str", "clone", "tensor", "cat", "zeros_like", "ones_like",
               "full_like", "empty_like", "arange"}

#: calls that share their argument's memory
BAD_CALL_MSG = {
    "asarray": ("np.asarray / torch.asarray alias their input when the "
                "dtype already matches; use np.array (always copies) on a "
                "commit path"),
    "ascontiguousarray": ("np.ascontiguousarray aliases already-contiguous "
                          "input; use np.array on a commit path"),
    "atleast_1d": "may alias its input; use np.array on a commit path",
    "from_numpy": ("torch.from_numpy shares the array's memory; commit "
                   "np.array(...) or a .clone()"),
    "as_tensor": ("torch.as_tensor shares its input's memory when it can; "
                  "commit torch.tensor(...) or a .clone()"),
}

#: tensor/array methods that may return their receiver or a view of it
ALIASING_METHODS = {
    "numpy", "cpu", "detach", "to", "contiguous", "view", "view_as",
    "reshape", "flatten", "ravel", "squeeze", "unsqueeze", "transpose",
    "permute", "expand", "narrow", "t", "float", "double",
}


class CheckpointAliasingRule(Rule):
    name = "checkpoint-aliasing"
    description = ("values committed through CheckpointManager/"
                   "WaveCheckpointer must be materialized copies, not live "
                   "tensors, their storage-sharing numpy views or slices")
    # the manager/checkpointer implementations themselves snapshot by
    # design (``manager._host_copy``, the checkpointer's thunk)
    exclude = ("src/repro_torch/checkpoint/",
               "src/repro_torch/outofcore/runtime.py")

    # -- expression classification -------------------------------------
    def _check_value(self, node: ast.expr, scope: ast.AST, flag,
                     depth: int = 0) -> None:
        """Flag ``node`` if it is provably a live/aliasing commit value."""
        if depth > 4:
            return
        if isinstance(node, ast.Constant):
            return
        if isinstance(node, ast.Dict):
            for v in node.values:
                self._check_value(v, scope, flag, depth + 1)
            return
        if isinstance(node, (ast.Tuple, ast.List)):
            for v in node.elts:
                self._check_value(v, scope, flag, depth + 1)
            return
        if isinstance(node, ast.Call):
            if self._aliases(node):
                f = node.func
                dotted = dotted_name(f) or ast.unparse(f)
                leaf = f.attr if isinstance(f, ast.Attribute) else dotted
                flag(node, BAD_CALL_MSG.get(leaf) or
                     f"'.{leaf}()' may return its receiver or a view of it "
                     "(on the CPU, .numpy() shares the tensor's storage and "
                     ".cpu() returns the tensor itself); commit a copy "
                     "(np.array(...), .clone())")
            return                          # fresh, or unknown: stay silent
        if isinstance(node, ast.Name):
            resolved = self._resolve_local(node.id, scope)
            if resolved is not None:
                self._check_value(resolved, scope, flag, depth + 1)
            return
        if isinstance(node, ast.Attribute):
            flag(node, f"live tensor reference "
                       f"'{dotted_name(node) or node.attr}' committed; the "
                       "async writer races later in-place updates — pass a "
                       "materialized copy (.clone() / np.array)")
            return
        if isinstance(node, ast.Subscript):
            flag(node, "subscript/slice committed; tensor and numpy slices "
                       "are views of the live storage — pass a "
                       "materialized copy")
            return

    @staticmethod
    def _fresh(call: ast.Call) -> bool:
        return (dotted_name(call.func) or "").split(".")[-1] in FRESH_CALLS

    def _aliases(self, call: ast.Call) -> bool:
        """True for a call that shares memory with a live value: a
        storage-sharing constructor, or an aliasing method whose receiver
        is not itself a fresh copy."""
        f = call.func
        leaf = (dotted_name(f) or "").split(".")[-1]
        if leaf in BAD_CALL_MSG:
            return True
        if isinstance(f, ast.Attribute) and f.attr in ALIASING_METHODS:
            recv = f.value
            while (isinstance(recv, ast.Call)
                   and isinstance(recv.func, ast.Attribute)
                   and recv.func.attr in ALIASING_METHODS):
                recv = recv.func.value
            return not (isinstance(recv, ast.Call) and self._fresh(recv))
        return False

    @staticmethod
    def _resolve_local(name: str, scope: ast.AST) -> Optional[ast.expr]:
        """Last single-target assignment to ``name`` in ``scope``."""
        found = None
        for n in ast.walk(scope):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t = n.targets[0]
                if isinstance(t, ast.Name) and t.id == name:
                    found = n.value
        return found

    def _check_tree_fn(self, fn: ast.AST, flag) -> None:
        """Analyze a tree thunk: returned dicts + tree[key] mutations."""
        if isinstance(fn, ast.Lambda):
            self._check_value(fn.body, fn, flag)
            return
        ret_names = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Return) and n.value is not None:
                if isinstance(n.value, ast.Name):
                    ret_names.add(n.value.id)
                else:
                    self._check_value(n.value, fn, flag)
        # `tree[...] = value` mutations on the returned dict variable
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    targets = [t]
                    if isinstance(t, ast.Tuple):
                        targets = list(t.elts)
                    for tt in targets:
                        if (isinstance(tt, ast.Subscript)
                                and isinstance(tt.value, ast.Name)
                                and tt.value.id in ret_names):
                            vals = [n.value]
                            if (isinstance(t, ast.Tuple)
                                    and isinstance(n.value, ast.Tuple)
                                    and len(t.elts) == len(n.value.elts)):
                                vals = [n.value.elts[t.elts.index(tt)]]
                            for v in vals:
                                self._check_value(v, fn, flag)

    # -- module walk ----------------------------------------------------
    def check_module(self, mod: ParsedModule) -> list[Finding]:
        out: list[Finding] = []

        def flag(node: ast.AST, msg: str) -> None:
            out.append(mod.finding(self.name, node, msg))

        scope = mod.tree
        managers = set()
        for n in ast.walk(scope):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t, v = n.targets[0], n.value
                if isinstance(v, ast.IfExp):      # mgr = X if c else None
                    v = v.body
                if (isinstance(t, ast.Name) and isinstance(v, ast.Call)
                        and (dotted_name(v.func) or "").split(".")[-1]
                        in MANAGER_TYPES):
                    managers.add(t.id)
        for n in ast.walk(scope):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if not (isinstance(f, ast.Attribute) and f.attr == "save"):
                continue
            if not (isinstance(f.value, ast.Name) and f.value.id in managers):
                continue
            if len(n.args) < 2:
                continue
            tree = n.args[1]
            if isinstance(tree, ast.Name):
                fn = self._resolve_fn(tree.id, scope)
                if fn is not None:
                    self._check_tree_fn(fn, flag)
                    continue
                resolved = self._resolve_local(tree.id, scope)
                if resolved is not None:
                    self._check_value(resolved, scope, flag)
                continue
            if isinstance(tree, ast.Lambda):
                self._check_tree_fn(tree, flag)
                continue
            self._check_value(tree, scope, flag)
        return out

    @staticmethod
    def _resolve_fn(name: str, scope: ast.AST) -> Optional[ast.AST]:
        for n in ast.walk(scope):
            if (isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name == name):
                return n
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t = n.targets[0]
                if (isinstance(t, ast.Name) and t.id == name
                        and isinstance(n.value, ast.Lambda)):
                    return n.value
        return None
