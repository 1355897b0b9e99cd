"""Rule registry.

``ALL_RULES`` is the ordered list of rule *instances* the CLI and tests
run, each the port's counterpart of the reference rule in the same place
of ``repro/analysis/rules/__init__.py``'s list; ``get_rules(names)``
resolves a ``--rule`` selection and fails loudly on unknown names.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.rules.backend_routing import BackendRoutingRule
from repro_torch.analysis.rules.bin_shape import BinShapeRule
from repro_torch.analysis.rules.checkpoint_aliasing import CheckpointAliasingRule
from repro_torch.analysis.rules.obs_routing import ObsRoutingRule
from repro_torch.analysis.rules.precision_drift import PrecisionDriftRule
from repro_torch.analysis.rules.shard_safety import ShardSafetyRule
from repro_torch.analysis.rules.smem_budget import SmemBudgetRule

ALL_RULES: tuple[Rule, ...] = (
    BackendRoutingRule(),
    SmemBudgetRule(),
    PrecisionDriftRule(),
    ShardSafetyRule(),
    CheckpointAliasingRule(),
    ObsRoutingRule(),
    BinShapeRule(),
)


def rule_names() -> list[str]:
    return [r.name for r in ALL_RULES]


def get_rules(names: Optional[Sequence[str]] = None) -> list[Rule]:
    """Resolve a ``--rule`` selection; unknown names raise ValueError with
    the full catalog."""
    if not names:
        return list(ALL_RULES)
    known = {r.name: r for r in ALL_RULES}
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(
            f"unknown rule name(s) {unknown}; choose from {sorted(known)}")
    return [known[n] for n in names]


__all__ = ["ALL_RULES", "BackendRoutingRule", "BinShapeRule",
           "CheckpointAliasingRule", "ObsRoutingRule", "PrecisionDriftRule",
           "ShardSafetyRule", "SmemBudgetRule", "get_rules", "rule_names"]
