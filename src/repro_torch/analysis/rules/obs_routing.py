"""obs-routing: raw wall-clock reads in ``src/repro_torch/`` route through obs.

A copy of the reference rule (``repro/analysis/rules/obs_routing.py``) on
the port's tree.  The port times its drivers through its own obs layer:
``obs.trace.phase`` (span + always-on per-phase metrics from one clock
pair) and the ``Tracer`` span API.  A bare ``time.perf_counter()`` /
``time.time()`` call gives wall-clock numbers that exist next to, and
drift from, the telemetry the registry reports.

The rule flags calls to ``time.time``, ``time.perf_counter``,
``time.monotonic`` (and their ``_ns`` variants) anywhere under
``src/repro_torch/`` except ``obs/`` itself — the one place allowed to
read the clock, since every sanctioned timer is built there.  Device work
is timed with ``torch.cuda.Event``, which the rule does not see.  Scope is
``src/repro_torch`` only: benches, examples and ``chip_smoke.py`` time
things ad hoc by design.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ParsedModule, Rule, call_name

#: clock-reading callables that must not be spelled directly
BANNED_CLOCKS = ("time", "perf_counter", "monotonic",
                 "time_ns", "perf_counter_ns", "monotonic_ns")


class ObsRoutingRule(Rule):
    name = "obs-routing"
    description = ("bare time.time()/time.perf_counter() in src/repro_torch/ "
                   "outside obs/; time code with obs.trace.phase or a "
                   "Tracer span")
    exclude = (
        "src/repro_torch/obs",       # the layer that implements the timers
    )

    def check_module(self, mod: ParsedModule) -> list[Finding]:
        # which local names are the time module / its clock functions?
        # (`import time`, `import time as t`, `from time import perf_counter`)
        time_aliases: set[str] = set()
        clock_names: dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        time_aliases.add(alias.asname or "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in BANNED_CLOCKS:
                        clock_names[alias.asname or alias.name] = alias.name

        out: list[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = call_name(node)
            if dotted is None:
                continue
            parts = dotted.split(".")
            offender = None
            if (len(parts) == 2 and parts[0] in time_aliases
                    and parts[1] in BANNED_CLOCKS):
                offender = f"time.{parts[1]}"
            elif len(parts) == 1 and parts[0] in clock_names:
                offender = f"time.{clock_names[parts[0]]}"
            if offender is not None:
                out.append(mod.finding(
                    self.name, node,
                    f"bare {offender}() in src/repro_torch/ — time phases "
                    f"with obs.trace.phase(cat=...) or tracer.span(), device "
                    f"work with torch.cuda.Event; only repro_torch.obs may "
                    f"read the clock directly"))
        return out
