"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU
fallback, and no kernel build at import time."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
ENTRY_FILES = sorted((REPO / "examples_torch").glob("*.py")) + \
    sorted((REPO / "benchmarks_torch").glob("*.py"))
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + ENTRY_FILES


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import build\n"
        "print(json.dumps({'n': len(mods), 'loaded': list(build.loaded()),\n"
        "                  'jax': [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "                          if sys.modules[k] is not None]}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 42
    assert res["loaded"] == []          # importing built and loaded nothing
    assert res["jax"] == []


def test_entry_points_import_with_jax_and_repro_blocked():
    """Every script of ``examples_torch/`` and module of
    ``benchmarks_torch/`` imports with ``jax`` and ``repro`` blocked, and
    importing builds no kernel."""
    code = (
        "import sys, importlib, importlib.util, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"paths = {[str(p) for p in ENTRY_FILES]!r}\n"
        "for p in paths:\n"
        "    if '/benchmarks_torch/' in p:\n"
        "        importlib.import_module('benchmarks_torch.' + p.rsplit('/', 1)[1][:-3])\n"
        "    else:\n"
        "        spec = importlib.util.spec_from_file_location('ex_' + p.rsplit('/', 1)[1][:-3], p)\n"
        "        spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from repro_torch.kernels import build\n"
        "print(json.dumps({'n': len(paths), 'loaded': list(build.loaded()),\n"
        "                  'jax': [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "                          if sys.modules[k] is not None]}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] == len(ENTRY_FILES) >= 13
    assert res["loaded"] == [] and res["jax"] == []


def _imported_roots(path: Path) -> set[str]:
    """The top-level packages ``path`` imports, as the port's lint rule
    backend-routing reads them (lazy imports and ``import_module`` too)."""
    from repro_torch.analysis.rules.backend_routing import import_sites

    tree = ast.parse(path.read_text(), filename=str(path))
    return {root for _, root in import_sites(tree)}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_repro(path):
    assert path.is_file(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import numpy as np

    from repro_torch import backend
    from repro_torch.core import als
    from repro_torch.sgd import blocking, train

    with pytest.raises(RuntimeError, match="cuda"):
        als.AlsConfig(f=8, lam=0.05)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        als.state_from_numpy([[0.0]], [[0.0]])
    assert als.AlsConfig(f=8, lam=0.05, device="cpu").mode == "ref"
    assert backend.default_mode("cpu") == "ref"
    with pytest.raises(ValueError):
        als.AlsConfig(f=8, lam=0.05, device="cpu", mode="kernel_interpret")

    grid = blocking.block_coo(np.array([0, 1]), np.array([1, 0]),
                              np.ones(2, np.float32), 2, 2, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        train.SgdConfig(f=8, lam=0.05)
    with pytest.raises(RuntimeError, match="cuda"):
        train.sgd_state_from_numpy([[0.0]], [[0.0]])
    with pytest.raises(RuntimeError, match="cuda"):
        train.grid_triplet(grid)
    assert train.SgdConfig(f=8, lam=0.05, device="cpu").mode == "ref"
    assert train.grid_triplet(grid, "cpu")[0].device.type == "cpu"
    with pytest.raises(ValueError):
        train.SgdConfig(f=8, lam=0.05, device="cpu", mode="kernel_interpret")


def test_kernel_modules_do_not_build_on_import():
    code = (
        "import json\n"
        "from repro_torch.kernels import build, hermitian, batch_solve, ops, sgd_update, sq_err\n"
        "from repro_torch.core import als\n"
        "from repro_torch import sgd, checkpoint, training, obs, data, outofcore\n"
        "print(json.dumps({'loaded': list(build.loaded()),\n"
        "  'cached': hermitian._launcher.cache_info().currsize\n"
        "            + hermitian._bin_launcher.cache_info().currsize\n"
        "            + batch_solve._launcher.cache_info().currsize\n"
        "            + sgd_update._launcher.cache_info().currsize\n"
        "            + sq_err._launcher.cache_info().currsize,\n"
        "  'launches': sum(obs.kernel_launches().values())\n"
        "              + sum(obs.kernel_launches('cuda_launches').values()),\n"
        "  'counted': sorted(obs.kernel_launches())}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PATH="/nonexistent")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        {"loaded": [], "cached": 0, "launches": 0,
         "counted": ["batch_solve", "fused_herm", "herm_hbm_accum", "sgd_tile", "sq_err"]}


def test_build_names_sources_that_exist():
    from repro_torch.kernels import build

    for name in build.KERNELS:
        src = build.CSRC / f"{name}.cu"
        assert src.is_file()
        assert 'extern "C"' in src.read_text()
        assert build.library_path(name).parent == build.BUILD_DIR
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
