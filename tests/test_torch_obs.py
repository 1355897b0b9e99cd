"""The port's obs layer against the reference's ``repro.obs``, on the CPU.

Both layers are stdlib-only, so the same calls go through both and their
outputs are compared as plain data: metric snapshots, span structure,
Chrome-trace objects, ledgers (each package validates and renders the
other's), the report text and the regress verdicts.  The last test holds
the SGD driver's spans against the reference's for a 2-epoch run.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as r_obs  # noqa: E402
from repro.obs import export as r_export  # noqa: E402
from repro.obs import ledger as r_ledger  # noqa: E402
from repro.obs import regress as r_regress  # noqa: E402
from repro.obs import report as r_report  # noqa: E402
from repro_torch import obs as p_obs  # noqa: E402
from repro_torch.obs import export as p_export  # noqa: E402
from repro_torch.obs import ledger as p_ledger  # noqa: E402
from repro_torch.obs import regress as p_regress  # noqa: E402
from repro_torch.obs import report as p_report  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BOTH = pytest.mark.parametrize("mod", [r_obs, p_obs], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _restore_process_tracers():
    prev = (r_obs.current_tracer(), p_obs.current_tracer())
    yield
    r_obs.set_tracer(prev[0])
    p_obs.set_tracer(prev[1])


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("waves_run").inc()
    reg.counter("waves_run").inc(2)
    reg.counter("bytes_streamed").inc(1234)
    reg.gauge("prefetch/queue_depth").set(3)
    reg.gauge("prefetch/queue_depth").set(1)
    h = reg.histogram("lat", edges=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 1.0, 20.0):
        h.observe(v)
    reg.add_phase("solve", 0.25)
    reg.add_phase("solve", 0.5)
    reg.add_phase("prefetch", 0.125)
    return reg


def test_metrics_snapshot_and_phase_seconds_match_reference():
    a, b = _drive_registry(r_obs), _drive_registry(p_obs)
    assert a.snapshot() == b.snapshot()
    assert a.phase_seconds() == b.phase_seconds() == {"solve": 0.75, "prefetch": 0.125}
    assert p_obs.DEFAULT_LATENCY_BUCKETS == r_obs.DEFAULT_LATENCY_BUCKETS
    for bad in ((), (1.0, 0.5), (1.0, 1.0)):
        for mod in (r_obs, p_obs):
            with pytest.raises(AssertionError):
                mod.Histogram(bad)


def _drive_tracer(mod):
    tr = mod.Tracer()
    reg = mod.MetricsRegistry()
    with tr.span("outer", cat="half", it=1):
        with mod.phase("inner", cat="solve", tracer=tr, registry=reg, wave=0):
            pass
        tr.instant("mark", cat="solve", k=2)
        tr.counter("depth", 3, cat="prefetch")

    def work():
        with tr.span("load", cat="prefetch_load"):
            pass

    t = threading.Thread(target=work, name="prefetch-worker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    return tr, reg


@BOTH
def test_null_tracer_is_a_constant_noop(mod):
    assert mod.current_tracer() is mod.NULL_TRACER
    assert mod.NULL_TRACER.span("x", cat="solve", a=1) is mod.NOOP_SPAN
    assert mod.NULL_TRACER.spans() == []
    tr = mod.Tracer()
    assert mod.set_tracer(tr) is mod.NULL_TRACER
    assert mod.current_tracer() is tr

    @mod.traced(cat="solve")
    def f(v):
        return v + 1

    assert f(1) == 2
    assert [e.cat for e in tr.spans()] == ["solve"]
    mod.set_tracer(None)
    assert mod.current_tracer() is mod.NULL_TRACER


def test_tracer_records_the_same_structure_as_the_reference():
    (ta, ra), (tb, rb) = _drive_tracer(r_obs), _drive_tracer(p_obs)

    def shape(tr):
        return [(e.name, e.cat, e.ph, e.args) for e in tr.events]

    assert shape(ta) == shape(tb)
    assert [e.name for e in tb.spans(cat="solve")] == ["inner"]
    assert "prefetch-worker" in tb.thread_names.values()
    assert set(ra.phase_seconds()) == set(rb.phase_seconds()) == {"solve"}
    assert rb.snapshot()["histograms"]["solve_seconds"]["count"] == 1


def test_chrome_trace_schema_and_cross_validation(tmp_path):
    (ta, ra), (tb, rb) = _drive_tracer(r_obs), _drive_tracer(p_obs)
    ca = r_export.chrome_trace(ta, registry=ra, process_name="mf")
    cb = p_export.chrome_trace(tb, registry=rb, process_name="mf")

    def strip(obj):
        return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "tid", "pid")}
                for ev in obj["traceEvents"]]

    assert sorted(map(json.dumps, strip(ca))) == sorted(map(json.dumps, strip(cb)))
    assert set(cb) == {"traceEvents", "displayTimeUnit", "otherData"}
    # each package's validator accepts the other's trace, with equal summaries
    sa, sb = r_export.validate_chrome_trace(cb), p_export.validate_chrome_trace(ca)
    assert (sa["events"], sa["spans"], sa["cats"]) == (sb["events"], sb["spans"], sb["cats"])
    assert p_export.span_counts(cb) == r_export.span_counts(ca) == \
        {"half": 1, "solve": 1, "prefetch_load": 1}
    path = tmp_path / "trace.json"
    p_export.write_trace(str(path), tb, registry=rb)
    assert r_export.load_and_validate(str(path))["spans"] == 3
    assert json.loads(path.read_text())["otherData"]["metrics"] == rb.snapshot()


@pytest.mark.parametrize("bad", ["no_events", "negative_ts", "no_dur", "overlap"])
def test_chrome_trace_validator_rejects_what_the_reference_rejects(bad):
    ev = {"name": "a", "cat": "solve", "ph": "X", "ts": 0.0, "dur": 10.0,
          "pid": 1, "tid": 1, "args": {}}
    events = [ev]
    if bad == "negative_ts":
        events = [dict(ev, ts=-1.0)]
    elif bad == "no_dur":
        events = [{k: v for k, v in ev.items() if k != "dur"}]
    elif bad == "overlap":
        events = [ev, dict(ev, name="b", ts=5.0, dur=10.0)]
    obj = {"displayTimeUnit": "ms"} if bad == "no_events" else {"traceEvents": events}
    for mod in (r_export, p_export):
        with pytest.raises(ValueError):
            mod.validate_chrome_trace(obj)


def _ledger(mod):
    led = mod.Ledger(solver="als", waves=2, phase_seconds={"driver": 2.0, "solve": 1.5})
    led.record("bytes_streamed", 4096, 4096, unit="bytes")
    led.record("peak_device_bytes", 1 << 20, 900_000, unit="bytes", check="le")
    led.record("fill_waste_ratio", 1.5, 1.5 + 1e-12, unit="ratio", check="rel",
               rel_tol=1e-9)
    led.record("wave_seconds", 1.0, 3.0, unit="seconds", check="rel", rel_tol=0.5,
               severity="warn")
    led.record("zero", 0, 0, unit="slots")
    return led


def test_ledger_equals_reference_and_validates_both_ways():
    a, b = _ledger(r_ledger).to_obj(), _ledger(p_ledger).to_obj()
    assert p_ledger.LEDGER_SCHEMA == r_ledger.LEDGER_SCHEMA == "repro.obs/ledger-v1"
    assert a == b
    assert r_ledger.validate_ledger(b) == p_ledger.validate_ledger(a) == \
        {"records": 5, "errors": 0, "warnings": 1, "ok": True}
    assert b["flags"] == ["warn:wave_seconds"]
    assert p_report.render_ledger(a) == r_report.render_ledger(b)
    merged_a = r_ledger.merge_ledgers({"als": a, "sgd": a, "none": None})
    merged_b = p_ledger.merge_ledgers({"als": b, "sgd": b, "none": None})
    assert merged_a == merged_b
    r_ledger.validate_ledger(merged_b)
    p_ledger.validate_ledger(merged_a)


@pytest.mark.parametrize("tamper", ["ok", "drift", "overall", "flags", "schema",
                                    "missing", "nan_type"])
def test_tampered_ledgers_are_rejected_both_ways(tamper):
    obj = _ledger(p_ledger).to_obj()
    rec = obj["records"][1]
    if tamper == "ok":
        rec["measured"] = 2 << 20            # over budget, still says ok
    elif tamper == "drift":
        rec["drift"] = 0.5
    elif tamper == "overall":
        obj["ok"] = False
    elif tamper == "flags":
        obj["flags"] = []
    elif tamper == "schema":
        obj["schema"] = "repro_torch.obs/ledger-v1"
    elif tamper == "missing":
        del rec["check"]
    else:
        rec["predicted"] = True
    for mod in (r_ledger, p_ledger):
        with pytest.raises(ValueError):
            mod.validate_ledger(obj)


def test_regress_classifies_and_gates_like_the_reference(tmp_path):
    keys = ["bytes_streamed", "waves", "peak_bytes", "wall_seconds", "epochs_per_sec",
            "test_rmse", "n_data", "fill_waste_ratio", "per_iter_s", "q"]
    assert [p_regress.classify(k) for k in keys] == [r_regress.classify(k) for k in keys]

    def entry(bytes_, secs, rmse):
        return {"schema": "repro.obs/bench-history-v1", "bench": "oc",
                "provenance": {"quick": True, "backend": "cuda", "device_count": 1},
                "records": [{"name": "row", "bytes_streamed": bytes_,
                             "wall_seconds": secs, "test_rmse": rmse}]}

    hist = [entry(100, 1.0, 0.5), entry(100, 1.1, 0.5), entry(101, 3.0, 0.6)]
    path = tmp_path / "h.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in hist))
    ra = r_regress.compare_history(r_regress.load_history(str(path)))
    pa = p_regress.compare_history(p_regress.load_history(str(path)))
    assert ra == pa and pa[1] == 1
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(_ledger(p_ledger).to_obj()))
    obj = _ledger(p_ledger).to_obj()
    obj["records"][0]["ok"] = False
    bad.write_text(json.dumps(obj))
    for f in (good, bad):
        assert p_regress.check_ledger(str(f)) == r_regress.check_ledger(str(f))
    assert p_regress.main(["--ledger", str(good)]) == 0
    assert p_regress.main(["--ledger", str(bad)]) == 1
    assert p_regress.main(["--history", str(path)]) == 1


def test_report_and_regress_run_as_modules(tmp_path):
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps(_ledger(p_ledger).to_obj()))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(path)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == r_report.render_ledger(json.loads(path.read_text()))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.regress",
                          "--ledger", str(path)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0 and "regress: PASS" in out.stdout, out.stdout + out.stderr


def test_sgd_train_spans_match_reference(tmp_path):
    """A 2-epoch in-core SGD run with a checkpoint directory records the
    reference's spans (one ``epoch`` and one ``checkpoint`` per epoch) and
    phase categories."""
    import jax.numpy as jnp

    from repro.sgd import blocking as r_blocking
    from repro.sgd import train as r_train
    from repro.sparse import synth
    from repro_torch.sgd import blocking as p_blocking
    from repro_torch.sgd import train as p_train

    spec = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
    r, _, _, _ = synth.make_synthetic_ratings(spec, seed=0)
    rng = np.random.default_rng(0)
    runs = {}
    for name, blocking, train, obs in (("ref", r_blocking, r_train, r_obs),
                                       ("port", p_blocking, p_train, p_obs)):
        grid = blocking.block_ell(r, g=4)
        x0 = rng.uniform(0, 0.3, (grid.g * grid.mb, spec.f)).astype(np.float32)
        t0 = rng.uniform(0, 0.3, (grid.g * grid.nb, spec.f)).astype(np.float32)
        tr, reg = obs.Tracer(), obs.MetricsRegistry()
        if name == "ref":
            cfg = train.SgdConfig(f=spec.f, lam=spec.lam, epochs=2, mode="ref")
            init = train.SgdState(jnp.asarray(x0), jnp.asarray(t0), jnp.int32(0))
        else:
            cfg = train.SgdConfig(f=spec.f, lam=spec.lam, epochs=2, device="cpu",
                                  mode="kernel")
            init = train.sgd_state_from_numpy(x0, t0, device="cpu")
        train.sgd_train(grid, cfg, init_state=init, ckpt_dir=str(tmp_path / name),
                        tracer=tr, registry=reg)
        runs[name] = ([(e.name, e.cat, sorted(e.args)) for e in tr.spans()],
                      sorted(reg.phase_seconds()))
    assert runs["port"] == runs["ref"]
    assert runs["port"][1] == ["checkpoint", "epoch"]
    assert [s[0] for s in runs["port"][0]] == ["sgd.epoch", "checkpoint.commit"] * 2
