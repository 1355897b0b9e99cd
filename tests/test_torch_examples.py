"""The port's user entry points (``examples_torch/``) on the CPU, against
the reference's ``examples/``.

Each script's ``main(argv)`` runs in-process with ``--device cpu`` (and
``--mesh-device cpu`` for a mesh) at ``--small``, 1-2 iterations or
epochs: every solver in core and out of core, the resume, the ledger, the
trace, the autotune cache, the argument errors, and the refusal to run
without a card unless the CPU is asked for.  The out-of-core plan and
schedule strings equal the reference example's for the same spec and
arguments (its helpers are imported by path, as tests/test_ledger.py
imports ``benchmarks``).  The quickstart meets tests/test_convergence.py's
relative criteria.  The ``mesh``-marked case runs the reference example on
a 2 x 2 mesh of 8 forced host devices in a subprocess and holds the port's
mesh run to its plan, schedule, streamed bytes and reduction traffic.
"""
import argparse
import importlib.util
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.sparse import synth as r_synth  # noqa: E402
from repro_torch.obs import validate_chrome_trace, validate_ledger  # noqa: E402
from repro_torch.sparse import synth as p_synth  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--small", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this file's runs: the suite's workers share the
    machine's cores (spinning thread pools slow every worker down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load(REPO / "examples_torch" / "train_als_netflix.py", "port_train_als_netflix")


@pytest.fixture(scope="module")
def ref():
    return _load(REPO / "examples" / "train_als_netflix.py", "ref_train_als_netflix")


@pytest.fixture
def run(port, tmp_path, capsys):
    """``main(argv)`` of the port's example with a fresh ``--ckpt``;
    returns its standard output."""
    def go(*argv, ckpt="ck"):
        port.main([*SMALL, *argv, "--ckpt", str(tmp_path / ckpt)])
        return capsys.readouterr().out
    return go


def _launch_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("kernel launches: ")]
    assert len(lines) == 1, out
    counts = json.loads(lines[0].removeprefix("kernel launches: "))
    assert set(counts) == {"fused_herm", "batch_solve", "sgd_tile", "herm_hbm_accum", "sq_err"}
    return counts


def _rmses(out: str) -> list[float]:
    return [float(v) for v in re.findall(r"test_rmse=([0-9.]+)", out)]


@pytest.mark.parametrize("solver,argv", [
    ("als", ["--iters", "2"]),
    ("sgd", ["--epochs", "2"]),
    ("hybrid", ["--iters", "1", "--epochs", "2"]),
])
@pytest.mark.parametrize("where", ["incore", "out_of_core"])
def test_every_solver_runs(run, solver, argv, where):
    extra = ["--out-of-core", "--device-mb", "8"] if where == "out_of_core" else []
    out = run("--solver", solver, *argv, *extra)
    rmses = _rmses(out)
    assert rmses and all(0.1 < v < 1.2 for v in rmses), out
    assert rmses[-1] < rmses[0] or len(rmses) == 1, out
    # on the CPU the wrappers run their plain versions and count nothing
    assert _launch_line(out) == dict.fromkeys(
        ("fused_herm", "batch_solve", "sgd_tile", "herm_hbm_accum", "sq_err"), 0)
    if where == "out_of_core" and solver != "sgd":
        assert "out-of-core plan: " in out and "schedule: waves=" in out
    if where == "out_of_core" and solver != "als":
        assert "schedule: sgd waves=" in out


def test_incore_als_resumes(run):
    first = run("--iters", "2")
    assert "resuming" not in first and len(_rmses(first)) == 2
    again = run("--iters", "3")
    assert "resuming from checkpoint at iteration 2" in again
    assert re.findall(r"iter +(\d+) ", again) == ["3"]


def test_out_of_core_ledger_and_trace(run, tmp_path):
    ledger, trace = tmp_path / "L.json", tmp_path / "t.json"
    out = run("--out-of-core", "--iters", "2", "--device-mb", "8",
              "--ledger", str(ledger), "--trace", str(trace))
    obj = json.loads(ledger.read_text())
    validate_ledger(obj)
    assert obj["ok"] and obj["records"] and all(r["ok"] for r in obj["records"])
    assert obj["run"]["mode"] == "ref" and obj["run"]["device"] == "cpu"
    tr = json.loads(trace.read_text())
    validate_chrome_trace(tr)
    assert {e["cat"] for e in tr["traceEvents"] if e.get("ph") == "X"} >= {"driver", "solve"}
    assert f"ledger: {len(obj['records'])} plan-vs-actual records" in out
    assert "trace: " in out
    # the process-wide tracer is put back when the run ends
    from repro_torch.obs import current_tracer
    assert not current_tracer().enabled


@pytest.mark.parametrize("solver,argv", [("als", ["--iters", "1"]),
                                         ("sgd", ["--epochs", "1"])])
def test_mesh_on_cpu_cells(run, solver, argv):
    out = run("--out-of-core", "--mesh", "2,2", "--mesh-device", "cpu",
              "--device-mb", "8", "--solver", solver, *argv)
    assert "mesh[data=2 x model=2] on 1 device(s) (cpu)" in out
    assert _rmses(out)
    if solver == "als":
        assert "reduction topology" in out


def test_autotune_writes_and_reuses_its_cache(run, tmp_path):
    out = run("--out-of-core", "--autotune", "--iters", "1", "--device-mb", "8")
    assert "(cache_miss)" in out
    cache = json.loads((tmp_path / "ck" / "tune_cache.json").read_text())
    assert cache["schema"] == "repro.core/tunecache-v1"
    # a second run under the same --ckpt finds the sweep's winner
    again = run("--out-of-core", "--autotune", "--iters", "1", "--device-mb", "8")
    assert "(cache_hit)" in again
    sgd = run("--autotune", "--solver", "sgd", "--epochs", "1", ckpt="ck_sgd")
    assert "autotune: per_tile_k=" in sgd


@pytest.mark.parametrize("argv,msg", [
    (["--ledger", "x.json"], "--ledger requires --out-of-core"),
    (["--mesh", "2,2"], "--mesh requires --out-of-core"),
    (["--out-of-core", "--mesh-device", "cpu"], "--mesh-device requires --mesh"),
])
def test_argument_errors(port, capsys, argv, msg):
    with pytest.raises(SystemExit) as e:
        port.main([*SMALL, *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_mesh_without_enough_cards_raises(port, tmp_path):
    if torch.cuda.device_count() >= 4:
        pytest.skip("this host has enough cards for a 2 x 2 mesh")
    with pytest.raises(SystemExit, match="needs 4 cards"):
        port.main([*SMALL, "--out-of-core", "--mesh", "2,2", "--ckpt", str(tmp_path)])


@pytest.mark.parametrize("script", ["train_als_netflix.py", "quickstart.py"])
def test_no_device_flag_raises_without_a_card(script, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    mod = _load(REPO / "examples_torch" / script, "port_" + script[:-3])
    synthesized = []
    monkeypatch.setattr(mod.synth, "make_synthetic_ratings",
                        lambda *a, **k: synthesized.append(a))
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--small"] if script.startswith("train") else [])
    assert synthesized == []          # it raised before building anything


def test_quickstart_meets_the_relative_criteria(capsys):
    mod = _load(REPO / "examples_torch" / "quickstart.py", "port_quickstart")
    hist = mod.main(["--device", "cpu"])
    rmses = [h["test_rmse"] for h in hist]
    assert len(rmses) == 8
    assert rmses[-1] < 0.5 * rmses[0], rmses          # tests/test_convergence.py:32
    assert rmses[-1] <= min(rmses) * 1.05             # tests/test_convergence.py:35
    assert "converged." in capsys.readouterr().out


# ---------------------------------------------------------------------------
# plan and schedule strings against the reference example's helpers
# ---------------------------------------------------------------------------

SPEC = ("netflix-small", 8_192, 2_048, 400_000, 16, 0.05)


@pytest.fixture(scope="module")
def ratings():
    r_ref, _, _, _ = r_synth.make_synthetic_ratings(r_synth.SynthSpec(*SPEC), seed=0, noise=0.1)
    r_port, _, _, _ = p_synth.make_synthetic_ratings(p_synth.SynthSpec(*SPEC), seed=0,
                                                     noise=0.1)
    return r_ref, r_port


def _args(tmp_path, side, **kw):
    base = dict(device_mb=8, n_data=2, autotune=False, g=4, ckpt=str(tmp_path / side))
    base.update(kw)
    return argparse.Namespace(**base)


def _printed(fn, capsys, *a, **k):
    fn(*a, **k)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("p,kw", [(1, {}), (2, {}), (1, {"autotune": True}),
                                  (1, {"device_mb": 64, "n_data": 4}),
                                  (2, {"autotune": True})])
def test_als_store_and_schedule_match_reference(port, ref, ratings, tmp_path, capsys, p, kw):
    r_ref, r_port = ratings
    want = _printed(ref._als_store_and_schedule, capsys, r_synth.SynthSpec(*SPEC), r_ref,
                    _args(tmp_path, "ref", **kw), p=p)
    got = _printed(port._als_store_and_schedule, capsys, p_synth.SynthSpec(*SPEC), r_port,
                   _args(tmp_path, "port", **kw), p=p)
    assert any(ln.startswith("out-of-core plan: ") for ln in got)
    assert any(ln.startswith("schedule: ") for ln in got)
    assert got == want


@pytest.mark.parametrize("kw", [{}, {"autotune": True}, {"g": 8, "n_data": 3}])
def test_sgd_tiles_and_schedule_match_reference(port, ref, ratings, tmp_path, capsys, kw):
    r_ref, r_port = ratings
    want = _printed(ref._sgd_tiles_and_schedule, capsys, r_synth.SynthSpec(*SPEC), r_ref,
                    _args(tmp_path, "ref", **kw))
    got = _printed(port._sgd_tiles_and_schedule, capsys, p_synth.SynthSpec(*SPEC), r_port,
                   _args(tmp_path, "port", **kw))
    assert any(ln.startswith("schedule: sgd waves=") for ln in got)
    assert got == want


# ---------------------------------------------------------------------------
# the mesh run against the reference's on 8 forced host devices
# ---------------------------------------------------------------------------

def _mesh_facts(out: str) -> list[str]:
    """The deterministic lines of a mesh run: plan, schedule, the streamed
    bytes and waves, the reduction traffic."""
    facts = [ln for ln in out.splitlines()
             if ln.startswith(("out-of-core plan: ", "schedule: ", "reduction "))]
    facts += re.findall(r"MiB budget; ([0-9.]+MiB streamed over \d+ waves)", out)
    return facts


@pytest.mark.mesh
def test_mesh_run_matches_reference_example(run, tmp_path):
    from test_distributed import run_script

    argv = ["--small", "--out-of-core", "--mesh", "2,2", "--iters", "1",
            "--device-mb", "8", "--ckpt", str(tmp_path / "ref")]
    ref_out = run_script(
        "import sys, runpy\n"
        f"sys.argv = ['train_als_netflix.py'] + {argv!r}\n"
        f"runpy.run_path({str(REPO / 'examples' / 'train_als_netflix.py')!r}, "
        "run_name='__main__')\n")
    out = run("--out-of-core", "--mesh", "2,2", "--mesh-device", "cpu", "--iters", "1",
              "--device-mb", "8")
    want = _mesh_facts(ref_out)
    assert len(want) == 4, ref_out
    assert _mesh_facts(out) == want
