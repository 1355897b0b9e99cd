"""The port's lint: static checks of the invariants ``repro_torch`` rests on.

The reference lint (``repro.analysis``, "reprolint") speaks JAX and numpy:
its rules look for ``pallas_call``, ``shard_map``, ``P(...)`` and
``jnp``, which the port never spells.  This package is its counterpart for
the port — the same engine semantics (shared parse, ``Finding``
fingerprints, the ``# reprolint: disable=<rule>`` comment, a justified
baseline) and one rule for each of the reference's seven:

==================== =====================================================
reference rule       port rule: what it holds in ``src/repro_torch``
==================== =====================================================
compat-routing       backend-routing: no jax/jaxlib/repro import, no
                     device chosen by probing ``torch.cuda`` with a CPU
                     branch, no plain version called from an ``except``
                     (also ``examples_torch``, ``benchmarks_torch``,
                     ``chip_smoke.py``)
pallas-budget        smem-budget: ``kernels/budgets.py``'s copies of the
                     CUDA constants equal their ``constexpr``; every
                     loaded library budgeted; every footprint fits
precision-drift      precision-drift: partials feeding ``topology_reduce``
                     stay float64 (numpy and torch narrowings)
shard-safety         shard-safety: axis names in specs, collective
                     ``axes=`` and ``mesh.shape`` keys are declared by
                     ``launch/mesh.py``
checkpoint-aliasing  checkpoint-aliasing: commits are copies, not
                     ``.numpy()`` / ``.cpu()`` aliases, views or slices
obs-routing          obs-routing: no bare clock outside ``obs/``
bin-shape            bin-shape: per-bin dispatches use the bin's own K
==================== =====================================================

Usage::

    PYTHONPATH=src python -m repro_torch.analysis            # human output
    PYTHONPATH=src python -m repro_torch.analysis --json -   # JSON on stdout
    PYTHONPATH=src python -m repro_torch.analysis --rule smem-budget
    PYTHONPATH=src python -m repro_torch.analysis --list-rules

The default baseline is ``reprolint_torch_baseline.json`` at the repo
root.  The reference lint scans these files too (its rules cover all of
``src/``), so each must also stay clean under ``python -m repro.analysis``.
"""
from repro_torch.analysis.engine import (AnalysisConfig, Baseline, Finding,
                                         ParsedModule, Rule, iter_python_files,
                                         run_analysis)
from repro_torch.analysis.rules import ALL_RULES, get_rules, rule_names

__all__ = [
    "ALL_RULES", "AnalysisConfig", "Baseline", "Finding", "ParsedModule",
    "Rule", "get_rules", "iter_python_files", "rule_names", "run_analysis",
]
