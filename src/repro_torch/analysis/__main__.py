"""``python -m repro_torch.analysis`` — run the port's lint over the repo.

Exit status: 0 when every finding is suppressed or grandfathered in the
baseline, 1 when new findings exist, 2 on usage errors.

``--rule <name>`` is repeatable, and unknown names fail loudly with the
full catalog instead of silently matching nothing.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis.engine import AnalysisConfig, Baseline, run_analysis
from repro_torch.analysis.rules import ALL_RULES, get_rules, rule_names

DEFAULT_BASELINE = "reprolint_torch_baseline.json"


def find_repo_root(start: pathlib.Path) -> pathlib.Path:
    """Nearest ancestor carrying pyproject.toml (the scan anchor)."""
    for cand in [start] + list(start.parents):
        if (cand / "pyproject.toml").is_file():
            return cand
    return start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="explicit files to check (default: each rule's "
                         "declared roots under the repo root)")
    ap.add_argument("--root", type=pathlib.Path, default=None,
                    help="repo root (default: nearest ancestor of cwd with "
                         "a pyproject.toml)")
    ap.add_argument("--rule", action="append", default=[], metavar="NAME",
                    help="run only the named rule (repeatable); names: "
                         f"{', '.join(rule_names())}")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="FILE", help="emit findings as JSON to FILE "
                                         "(or stdout with no argument)")
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    metavar="FILE",
                    help=f"baseline file (default: <root>/{DEFAULT_BASELINE} "
                         "when it exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline "
                         "(preserves existing justifications) and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name}: {r.description}")
        return 0

    try:
        rules = get_rules(args.rule)
    except ValueError as e:
        ap.error(str(e))        # exits 2

    root = (args.root or find_repo_root(pathlib.Path.cwd())).resolve()
    baseline_path = args.baseline or (root / DEFAULT_BASELINE)
    baseline = None
    if baseline_path.is_file():
        try:
            baseline = Baseline.load(baseline_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    paths = [p.resolve() for p in args.paths] or None
    cfg = AnalysisConfig(root=root, rules=rules, baseline=baseline,
                         paths=paths)
    new, grandfathered = run_analysis(cfg)

    if args.write_baseline:
        Baseline.write(baseline_path, new + grandfathered, old=baseline)
        print(f"wrote {len(new) + len(grandfathered)} finding(s) to "
              f"{baseline_path}")
        return 0

    if args.json is not None:
        payload = {
            "root": str(root),
            "rules": [r.name for r in rules],
            "new": [f.to_json() for f in new],
            "grandfathered": [f.to_json() for f in grandfathered],
        }
        if args.json == "-":
            json.dump(payload, sys.stdout, indent=2)
            print()
        else:
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2)

    for f in new:
        print(f.format())
    print(f"reprolint (port): {len(new)} new finding(s), "
          f"{len(grandfathered)} grandfathered, {len(rules)} rule(s)",
          file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
