"""No module of the benchmark imports JAX or the reference package, by
whole top-level name; the reference imports nothing of the program; no
file reads the repository's other benchmark folders."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_other_benchmark_folder(path):
    text = path.read_text()
    for folder in ("benchmarks_torch", "benchmarks/", '"benchmarks"'):
        assert folder not in text


def test_reference_and_yardstick_take_nothing_of_the_program():
    for name in ("reference.py", "data.py", "work.py", "peaks.py"):
        assert "repro_torch" not in top_level_imports(BENCH / "mfbench" / name)


def test_whole_name_comparison(bench_run):
    assert bench_run.forbidden_modules({"repro_torch": 0, "repro_torch.core.als": 0,
                                        "reprolint": 0, "jaxtyping": 0}) == []
    assert bench_run.forbidden_modules({"repro": 0, "repro.core": 0, "jax.numpy": 0,
                                        "jaxlib": 0, "flax.linen": 0}) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]
