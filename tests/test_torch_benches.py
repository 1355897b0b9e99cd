"""The port's benches (``benchmarks_torch/``) on the CPU, against the
reference's ``benchmarks/``.

Every module runs with ``device="cpu"``; its CSV rows come from standard
output and carry the reference's row names in the reference's order.
Deterministic fields equal the reference's: Fig. 5's link bytes,
``bench_huge.measure_outofcore``'s plan, stream and fill fields (the
metered peak left out: it is thread-timed in both packages), and
``bench_sgd(quick=True)``'s bytes and slots.  ``bench_convergence`` from
the reference's injected ``als_init`` follows the reference's curve within
3e-3 (tests/test_convergence.py:80).  ``run.py`` writes its JSON files and
a history that ``repro_torch.obs.regress`` accepts, and refuses unknown
names and a run without a card unless the CPU is asked for.  The
``mesh``-marked cases run the reference's mesh rows on 8 forced host
devices in a subprocess.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))     # for benchmarks.* and benchmarks_torch.*

from benchmarks import bench_huge as r_huge  # noqa: E402
from benchmarks import bench_sgd as r_sgd  # noqa: E402
from benchmarks_torch import bench_huge as p_huge  # noqa: E402
from benchmarks_torch import bench_sgd as p_sgd  # noqa: E402
from benchmarks_torch import history, run as p_run  # noqa: E402


def _rows(out: str) -> list[tuple[str, float, str]]:
    rows = []
    for line in out.splitlines():
        if not line or line.startswith("#") or line == "name,us_per_call,derived":
            continue
        name, us, derived = line.split(",", 2)
        rows.append((name, float(us), derived))
    return rows


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


def test_reduction_bytes_equal_reference(capsys):
    from benchmarks import bench_reduction as r_red
    from benchmarks_torch import bench_reduction as p_red

    r_red.run()
    ref = _rows(capsys.readouterr().out)
    p_red.run()
    port = _rows(capsys.readouterr().out)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (name, _, rd), (_, us, pd) in zip(ref, port):
        assert _fields(pd)["slow_link_bytes"] == _fields(rd)["slow_link_bytes"], name
        assert us > 0
    # the link bytes themselves, unrounded
    from repro.distributed.collectives import collective_bytes_reduce as r_bytes
    from repro_torch.distributed.collectives import collective_bytes_reduce as p_bytes
    for p_slow in (2, 4):
        assert p_bytes(32768 * 128 * 128 * 4, 16, p_slow) == \
            r_bytes(32768 * 128 * 128 * 4, 16, p_slow)


def _small_problem(monkeypatch):
    """Shrink the kernel benches' shared problem (m=2048, K=256 on the
    card) to a CPU-quick one; the rows and their order stay."""
    from benchmarks_torch import bench_kernels

    full = bench_kernels._problem
    monkeypatch.setattr(bench_kernels, "_problem",
                        lambda device="cuda": full(m=64, n=256, K=32, f=16, device=device))
    for mod in ("bench_register_ablation", "bench_texture"):
        monkeypatch.setattr(f"benchmarks_torch.{mod}._problem", bench_kernels._problem)


REF_NAMES = {
    "bench_kernels": ["kern_fused_AB_one_pass", "kern_paper_two_pass", "kern_batch_solve"],
    "bench_register_ablation": ["fig7_register_fused", "fig7_register_hbm_binned"],
    "bench_texture": ["fig8_texture_fused_gather", "fig8_texture_materialized"],
}


@pytest.mark.parametrize("mod", list(REF_NAMES))
def test_kernel_bench_rows(mod, monkeypatch, capsys):
    import importlib

    _small_problem(monkeypatch)
    importlib.import_module(f"benchmarks_torch.{mod}").run(device="cpu")
    rows = _rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == REF_NAMES[mod]
    assert all(r[1] > 0 for r in rows)
    # the reference emits the same names, in this order
    src = (REPO / "benchmarks" / f"{mod}.py").read_text()
    assert [src.index(f'"{n}"') for n in REF_NAMES[mod]] == \
        sorted(src.index(f'"{n}"') for n in REF_NAMES[mod])
    if mod == "bench_register_ablation":
        d = _fields(rows[1][2])
        assert d["modeled_write_ratio"] == "8x"
        assert int(d["A_hbm_writes"]) == 8 * int(_fields(rows[0][2])["A_hbm_writes"])
    if mod == "bench_texture":
        assert _fields(rows[1][2])["extra_hbm_bytes"] == str(64 * 32 * 16 * 8)


def test_kernel_benches_compute_the_reference_quantities():
    """The fused, two-pass, materialized and binned variants give the same
    A and B as the reference's ``herm_ref`` on the same draws (atol 2e-4,
    rtol 1e-4: tests/test_kernels.py:44)."""
    import jax.numpy as jnp

    from benchmarks_torch import bench_kernels, bench_register_ablation, bench_texture
    from repro.kernels import ref as r_ref

    args = bench_kernels._problem(m=64, n=256, K=32, f=16, device="cpu")
    theta, idx, val, cnt, diag = (np.asarray(a) for a in args)
    g = jnp.take(jnp.asarray(theta), jnp.asarray(idx), axis=0)
    A_ref, B_ref = r_ref.herm_ref(g, jnp.asarray(val),
                                  r_ref.mask_from_cnt(jnp.asarray(cnt), 32, jnp.float32),
                                  jnp.asarray(diag))
    ident = torch.arange(64 * 32, dtype=torch.int32).view(64, 32)
    for A, B in (bench_kernels.one_pass(*args), bench_kernels.two_pass(*args),
                 bench_register_ablation.binned_hbm_accum(*args),
                 bench_texture.gather_materialized(*args, ident)):
        np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), atol=2e-4, rtol=1e-4)


def test_scaling_rows(capsys):
    from benchmarks_torch import bench_scaling as p_scal

    src = (REPO / "benchmarks" / "bench_scaling.py").read_text()
    assert "fig9_scaling_1dev_measured" in src and "fig9_scaling_modeled_p{p}" in src
    assert "(1, 2, 4, 8, 16)" in src
    p_scal.run(device="cpu")
    rows = _rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == ["fig9_scaling_1dev_measured"] + [
        f"fig9_scaling_modeled_p{p}" for p in (1, 2, 4, 8, 16)]
    assert _fields(rows[0][2])["nnz"] == "259801"
    assert all(_fields(d)["f"] == "100" for _, _, d in rows[1:])
    assert float(_fields(rows[1][2])["eff"]) == 1.0


def test_huge_modelled_rows(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(p_huge, "measure_outofcore", lambda **kw: [])
    p_huge.run(device="cpu")
    rows = _rows(capsys.readouterr().out)
    from repro.sparse.synth import DATASETS
    assert [r[0] for r in rows] == [f"fig11_huge_{n}" for n in DATASETS]
    for name, us, d in rows:
        f = _fields(d)
        assert "usd_per_iter" not in f
        key = name.removeprefix("fig11_huge_")
        assert ("speedup_vs_baseline" in f) == bool(r_huge.PAPER_BASELINES[key][0])
        t, *_ = p_huge.iteration_time_s(DATASETS[key])
        assert us == pytest.approx(t * 1e6, rel=1e-3)


# deterministic fields of a streaming row (the metered peak, thread-timed
# in both packages, and every time are left out)
OOC_FIELDS = ("name", "m", "n", "nnz", "f", "p", "q", "n_data", "waves", "iters",
              "n_bins", "bytes_streamed_per_iter", "capacity_bytes",
              "required_capacity_bytes", "padded_slots", "nnz_streamed",
              "fill_waste_ratio", "fill_waste_vs_uniform", "factors_match_uniform",
              "ledger_ok", "reduce_fast_bytes", "reduce_slow_bytes", "topology",
              "factors_match_incore", "fits")


def _det(rec: dict) -> dict:
    return {k: rec[k] for k in OOC_FIELDS if k in rec}


def test_measure_outofcore_matches_reference(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)                         # the ledger files land here
    monkeypatch.setattr(r_huge, "measure_outofcore_mesh", lambda **kw: [])
    monkeypatch.setattr(p_huge, "measure_outofcore_mesh", lambda **kw: [])
    ref = r_huge.measure_outofcore(iters=1, scale=0.008)
    capsys.readouterr()
    port = p_huge.measure_outofcore(iters=1, scale=0.008, device="cpu")
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    for a, b in zip(port, ref):
        assert _det(a) == _det(b)
        assert a["ledger_ok"] and a["fits"]
    assert port[-1]["fill_waste_vs_uniform"] >= 1.5
    assert (tmp_path / p_huge.LEDGER_OUT).is_file()
    rows = _rows(capsys.readouterr().out)
    assert [n for n, _, _ in rows if n.startswith("outofcore_q")] == [r["name"] for r in ref]


def test_measure_outofcore_autotune_matches_reference(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    ref = r_huge.measure_outofcore_autotune(iters=1, scale=0.008)
    port = p_huge.measure_outofcore_autotune(iters=1, scale=0.008, device="cpu")
    assert _det(port[0]) == _det(ref[0])
    assert port[0]["autotune"]["config"] == ref[0]["autotune"]["config"]
    assert port[0]["autotune_ladder"] == ref[0]["autotune_ladder"]


def test_convergence_follows_reference_from_injected_factors(capsys):
    from benchmarks_torch import bench_convergence as p_conv
    from repro.core import als as r_als
    from repro.sparse import synth as r_synth

    init, want = {}, {}
    for name, lam in p_conv.SPECS:
        spec = r_synth.SynthSpec(f"{name}-mini", m=1536, n=256, nnz=90_000, f=16, lam=lam)
        r, rt, rte, _ = r_synth.make_synthetic_ratings(spec, seed=3, noise=0.1)
        cfg = r_als.AlsConfig(f=spec.f, lam=spec.lam, iters=8, mode="ref")
        st = r_als.als_init(r.m, rt.m, cfg)
        init[name] = (np.asarray(st.x), np.asarray(st.theta))
        # the reference bench's own run: als_train draws the same als_init
        _, hist = r_als.als_train(r_als.ell_triplet(r), r_als.ell_triplet(rt),
                                  r.m, rt.m, cfg, test=r_als.ell_triplet(rte))
        want[name] = [h["test_rmse"] for h in hist]
    got = p_conv.run(device="cpu", init=init)
    rows = _rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == ["fig6_convergence_netflix", "fig6_convergence_yahoomusic"]
    for name, _ in p_conv.SPECS:
        np.testing.assert_allclose([h["test_rmse"] for h in got[name]], want[name],
                                   atol=3e-3, rtol=0)   # tests/test_convergence.py:80


SGD_FIELDS = ("solver", "m", "n", "nnz", "f", "g", "epochs", "waves_per_epoch",
              "capacity_bytes", "bytes_streamed", "padded_slots", "nnz_streamed",
              "fill_waste_ratio", "fill_waste_vs_uniform", "per_tile_k", "degree_sorted")


@pytest.fixture(scope="module")
def port_sgd_quick():
    """``bench_sgd.run(quick=True)`` of the port on the CPU: its records
    and its CSV row names."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = p_sgd.run(quick=True, device="cpu")
    return recs, [r[0] for r in _rows(buf.getvalue())]


def test_bench_sgd_quick_bytes_and_slots_match_reference(port_sgd_quick, monkeypatch,
                                                         tmp_path, capsys):
    import jax

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "devices", lambda *a: [None])   # the reference skips its mesh row
    ref = r_sgd.run(quick=True)
    ref_rows = [r[0] for r in _rows(capsys.readouterr().out)]
    port, port_rows = port_sgd_quick
    assert [r["solver"] for r in port] == [r["solver"] for r in ref] + ["sgd_stream_mesh"]
    for a, b in zip(port, ref):
        assert {k: a[k] for k in SGD_FIELDS if k in a} == \
            {k: b[k] for k in SGD_FIELDS if k in b}, a["solver"]
        assert len(a["curve"]) == len(b["curve"])
    assert port_rows == [n for n in ref_rows if n != "sgd_stream_mesh_skipped"] + \
        ["sgd_vs_als_sgd_stream_mesh"]
    mesh = port[-1]
    assert mesh["mesh_shape"] == {"data": 4, "model": 2} and mesh["mesh_device"] == "cpu"
    assert abs(mesh["final_rmse"] - port[3]["final_rmse"]) < 1e-3


def test_provenance_never_raises(monkeypatch):
    prov = history.provenance(quick=True, device="cpu")
    assert prov["backend"] == "cpu" and prov["device_count"] == 0
    assert prov["torch"] == torch.__version__ and prov["quick"] is True
    monkeypatch.setenv("PATH", "/nonexistent")           # no git, no nvidia-smi
    bare = history.provenance()
    assert bare["git_sha"] == "unknown" and bare["gpu"] == "unknown"
    assert bare["power_limit"] == "unknown"
    assert set(bare) == set(prov)


def test_run_writes_json_and_a_history_regress_accepts(monkeypatch, tmp_path, capsys):
    from repro_torch.obs import regress

    monkeypatch.chdir(tmp_path)
    hist = tmp_path / "h.jsonl"
    for _ in range(2):
        p_run.main(["--only", "huge", "--only", "reduction", "--quick", "--device", "cpu",
                    "--history", str(hist)])
    out = capsys.readouterr().out
    assert "# wrote 4 records to BENCH_torch_outofcore.json" in out
    assert (tmp_path / "BENCH_torch_outofcore.json").is_file()
    lines = [json.loads(ln) for ln in hist.read_text().splitlines()]
    assert len(lines) == 2 and lines[0]["schema"] == "repro.obs/bench-history-v1"
    assert lines[0]["bench"] == "bench_huge"
    assert lines[0]["provenance"]["backend"] == "cpu"
    assert regress.main(["--history", str(hist)]) == 0
    assert not (tmp_path / "BENCH_torch_HISTORY.jsonl").exists()


def test_run_refuses_unknown_names_and_no_card(capsys):
    with pytest.raises(SystemExit) as e:
        p_run.main(["--only", "nope", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown benchmark name" in capsys.readouterr().err
    assert [n for n, _ in p_run.MODULES] == [
        "convergence", "register_ablation", "texture", "scaling", "huge", "reduction",
        "kernels", "lm_substrate", "sgd"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p_run.main(["--only", "reduction", "--no-history"])


def test_run_quick_passes_device_and_traces(monkeypatch, tmp_path, capsys):
    from repro_torch.obs import current_tracer

    monkeypatch.chdir(tmp_path)
    _small_problem(monkeypatch)
    seen = {}
    from benchmarks_torch import bench_convergence
    monkeypatch.setattr(bench_convergence, "run", lambda device="cuda": seen.update(dev=device))
    trace = tmp_path / "t.json"
    p_run.main(["--quick", "--device", "cpu", "--trace", str(trace)])
    rows = _rows(capsys.readouterr().out)
    assert seen == {"dev": "cpu"}
    assert [r[0] for r in rows] == ["fig7_register_fused", "fig7_register_hbm_binned"]
    assert json.loads(trace.read_text())["traceEvents"] is not None
    assert not current_tracer().enabled


# ---------------------------------------------------------------------------
# the mesh rows against the reference's on 8 forced host devices
# ---------------------------------------------------------------------------

@pytest.mark.mesh
def test_mesh_rows_match_reference(port_sgd_quick, monkeypatch, tmp_path):
    from test_distributed import run_script

    out = tmp_path / "ref.json"
    # bench_huge's mesh row, and bench_sgd(quick=True)'s mesh row as that
    # bench builds it (its other rows are held in the test above)
    run_script(f"""
import json, os, sys
sys.path.insert(0, {str(REPO)!r})
os.chdir({str(tmp_path)!r})
from benchmarks import bench_huge
from repro.core import als as als_mod
from repro.launch.mesh import make_mesh
from repro.outofcore import TileStore, build_sgd_schedule, run_streaming_sgd
from repro.sgd import SgdConfig, block_ell
from repro.sparse import synth
huge = bench_huge.measure_outofcore_mesh(iters=1)
spec = synth.SynthSpec("netflix-micro", m=512, n=128, nnz=20_000, f=8, lam=0.05)
r, rt, rte, _ = synth.make_synthetic_ratings(spec, seed=3, noise=0.1)
grid = block_ell(r, g=4)
sched = build_sgd_schedule(grid, spec.f, n_workers=2)
cfg = SgdConfig(f=spec.f, lam=spec.lam, lr=0.15, epochs=8, schedule="cosine",
                mode="ref", seed=1)
_, _, tel = run_streaming_sgd(TileStore(grid), sched, cfg,
                              test_eval=als_mod.ell_triplet(rte),
                              mesh=make_mesh((4, 2), ("data", "model")))
sgd = dict(waves_per_epoch=sched.waves_per_epoch, capacity_bytes=tel.capacity_bytes,
           bytes_streamed=tel.bytes_streamed, padded_slots=tel.padded_slots,
           nnz_streamed=tel.nnz_streamed, fill_waste_ratio=round(tel.fill_waste_ratio, 6))
json.dump({{"huge": huge, "sgd": sgd}}, open({str(out)!r}, "w"))
""")
    ref = json.loads(out.read_text())
    monkeypatch.chdir(tmp_path)
    port = p_huge.measure_outofcore_mesh(iters=1, device="cpu")
    assert _det(port[0]) == _det(ref["huge"][0])
    assert port[0]["factors_match_incore"] and port[0]["mesh_device"] == "cpu"
    mesh = port_sgd_quick[0][-1]
    assert mesh["solver"] == "sgd_stream_mesh"
    assert {k: mesh[k] for k in ref["sgd"]} == ref["sgd"]
