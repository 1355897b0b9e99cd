"""The port's spans and counters on its main paths, on the CPU at tiny sizes.

``als_train_binned`` and ``sgd_train`` report through the current tracer
(``repro_torch.obs``): the span tree, each span's args against the host
layouts' own counts, the step spans' counter deltas, factors unchanged by
tracing, no device read and no CUDA event or synchronise added by it, and
a device-clock tracer's events resolved only in ``Tracer.resolve``; the
streaming driver's spans under its phases.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import als  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.outofcore import schedule, store  # noqa: E402
from repro_torch.outofcore.driver import run_streaming_als  # noqa: E402
from repro_torch.sgd import blocking, train  # noqa: E402
from repro_torch.sparse import synth  # noqa: E402
from repro_torch.sparse.padded import bin_rows, csr_from_coo  # noqa: E402

SPEC = synth.SynthSpec("tiny", m=300, n=80, nnz=4000, f=8, lam=0.05)
BATCH_ROWS = 50
G = 4


@pytest.fixture(autouse=True)
def _restore_tracer():
    prev = obs.set_tracer(None)
    yield
    obs.set_tracer(prev)


@pytest.fixture(scope="module")
def binned():
    rb, rtb, te, _ = synth.make_synthetic_ratings_binned(SPEC, n_bins=4, seed=0)
    return rb, rtb, te


@pytest.fixture(scope="module")
def grid_problem():
    r, _, te, _ = synth.make_synthetic_ratings(SPEC, seed=1)
    return blocking.block_ell(r, G), te


class _Calls:
    """Counts the calls of the ``torch.cuda`` functions a traced run must
    not make (and of every host read of a tensor's value)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for name in ("synchronize", "Event", "current_stream"):
            monkeypatch.setattr(torch.cuda, name, self._counted(name, getattr(torch.cuda, name)))
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
            monkeypatch.setattr(torch.Tensor, name,
                                self._counted(name, getattr(torch.Tensor, name)))

    def _counted(self, name, fn):
        def wrapped(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped


def _run_als(binned, tracer=None):
    rb, rtb, te = binned
    cfg = als.AlsConfig(f=SPEC.f, lam=SPEC.lam, iters=2, batch_rows=BATCH_ROWS, device="cpu")
    init = als.als_init(rb.m, rtb.m, cfg)
    prev = obs.set_tracer(tracer)
    try:
        return als.als_train_binned(rb, rtb, cfg, test=als.ell_triplet(te, "cpu"), init=init)
    finally:
        obs.set_tracer(prev)


def _run_sgd(grid_problem, tracer=None, registry=None, init=None):
    grid, te = grid_problem
    cfg = train.SgdConfig(f=SPEC.f, lam=SPEC.lam, lr=0.05, epochs=2, mode="kernel", device="cpu")
    init = train.sgd_init(grid, cfg) if init is None else init
    prev = obs.set_tracer(tracer)
    try:
        return train.sgd_train(grid, cfg, test=als.ell_triplet(te, "cpu"), init_state=init,
                               registry=registry)
    finally:
        obs.set_tracer(prev)


def _children(spans, parent):
    return [e for e in spans if e.parent == parent]


def test_als_train_binned_span_tree_args_and_counters(binned):
    rb, rtb, te = binned
    tr = obs.Tracer()
    _run_als(binned, tr)
    spans = tr.spans()
    assert len({e.id for e in spans}) == len(spans)
    iters = [e for e in spans if e.parent is None]
    assert [(e.name, e.cat, e.args["iteration"]) for e in iters] == \
        [("als.iteration", "iteration", 1), ("als.iteration", "iteration", 2)]
    r_bins = [b for b in rb.bins if b.m]
    for it in iters:
        assert [e.name for e in _children(spans, it.id)] == ["als.half", "als.half", "als.evaluate"]
        halves = _children(spans, it.id)[:2]
        assert [h.args["side"] for h in halves] == ["x", "theta"]
        for half, (layout, fixed_rows) in zip(halves, ((rb, rtb.m), (rtb, rb.m))):
            bins = [b for b in layout.bins if b.m]
            want = []
            for i, b in enumerate(bins):
                for q, lo in enumerate(range(0, b.m, BATCH_ROWS)):
                    hi = min(lo + BATCH_ROWS, b.m)
                    want.append(("als.bin", dict(bin=i, batch=q, rows=hi - lo, K=b.K,
                                                 nnz=int(b.cnt[lo:hi].sum()),
                                                 fixed_rows=fixed_rows, f=SPEC.f)))
                want.append(("als.scatter", {"bin": i}))
            got = _children(spans, half.id)
            assert [(e.name, e.args) for e in got] == want
            assert sum(e.args["nnz"] for e in got if e.name == "als.bin") == layout.nnz
            if layout is rb:       # R's bins hold more rows than a q-batch
                assert any(e.args["batch"] > 0 for e in got if e.name == "als.bin")
            for e in got:
                kids = [(k.name, k.cat) for k in _children(spans, e.id)]
                if e.name == "als.bin":
                    assert kids == [("kernel.fused_herm", "kernel"),
                                    ("kernel.batch_solve", "kernel")]
                    herm = _children(spans, e.id)[0]
                    assert herm.args == dict(rows=e.args["rows"], K=e.args["K"], f=SPEC.f,
                                             fixed_rows=fixed_rows)
                else:
                    assert kids == []
        ev = _children(spans, it.id)[2]
        assert ev.cat == "objective"
        assert [(e.name, e.args) for e in _children(spans, ev.id)] == \
            [("als.rmse_test", {}), ("als.rmse_train", {"nnz": rb.nnz})]
        rmse_test, rmse_train = _children(spans, ev.id)
        assert [(e.name, e.cat, e.args) for e in _children(spans, rmse_test.id)] == \
            [("kernel.sq_err", "kernel", dict(rows=te.m, K=te.K, f=SPEC.f, fixed_rows=rtb.m))]
        assert [(e.name, e.cat, e.args) for e in _children(spans, rmse_train.id)] == \
            [("kernel.sq_err", "kernel", dict(rows=b.m, K=b.K, f=SPEC.f, fixed_rows=rtb.m))
             for b in r_bins]
        # one host read of the train RMSE's accumulator, one for the test RMSE;
        # no launch on the CPU
        assert it.args["counters"] == {"host/syncs": 2}


def test_sgd_train_span_tree_args_and_counters(grid_problem):
    grid, te = grid_problem
    tr = obs.Tracer()
    _, hist = _run_sgd(grid_problem, tr)
    spans = tr.spans()
    epochs = [e for e in spans if e.parent is None]
    assert [(e.name, e.cat, e.args["epoch"]) for e in epochs] == \
        [("sgd.epoch", "epoch", 1), ("sgd.epoch", "epoch", 2)]
    ar = np.arange(G)
    plans = train.build_set_plans(train.grid_triplet(grid, "cpu"), grid)
    for ep, rec in zip(epochs, hist):
        assert ep.args["lr"] == rec["lr"]
        kids = _children(spans, ep.id)
        assert [e.name for e in kids] == ["sgd.set"] * G + ["sgd.evaluate"]
        order = train.epoch_set_order(0, ep.args["epoch"] - 1, G).tolist()
        assert [e.args["set"] for e in kids[:G]] == order
        for e in kids[:G]:
            s = e.args["set"]
            assert e.cat == "set"
            assert e.args == dict(set=s, live=int(grid.cnt[ar, (ar + s) % G].sum()),
                                  slots=plans[s].n_slots, x_rows=G * grid.mb,
                                  theta_rows=G * grid.nb, g=G, mb=grid.mb, f=SPEC.f)
            (tile,) = _children(spans, e.id)
            assert (tile.name, tile.cat) == ("kernel.sgd_tile", "kernel")
            assert tile.args["entries"] == e.args["live"]
            assert tile.args["slots"] == e.args["slots"]
        assert sum(e.args["live"] for e in kids[:G]) == grid.nnz
        assert [(e.name, e.cat) for e in _children(spans, kids[-1].id)] == \
            [("sgd.rmse_test", "objective")]
        (rmse_test,) = _children(spans, kids[-1].id)
        assert [(e.name, e.cat, e.args) for e in _children(spans, rmse_test.id)] == \
            [("kernel.sq_err", "kernel", dict(rows=te.m, K=te.K, f=SPEC.f, fixed_rows=grid.n))]
        assert ep.args["counters"] == {"host/syncs": 1}


def test_factors_are_bitwise_equal_with_and_without_tracing(binned, grid_problem):
    (s0, h0), (s1, h1) = _run_als(binned), _run_als(binned, obs.Tracer(device_clock=True))
    assert torch.equal(s0.x, s1.x) and torch.equal(s0.theta, s1.theta) and h0 == h1
    grid, _ = grid_problem
    init = train.sgd_init(grid, train.SgdConfig(f=SPEC.f, lam=SPEC.lam, device="cpu"))
    (s0, h0) = _run_sgd(grid_problem, init=init)
    (s1, h1) = _run_sgd(grid_problem, obs.Tracer(device_clock=True), init=init)
    assert torch.equal(s0.x, s1.x) and torch.equal(s0.theta, s1.theta) and h0 == h1


def test_tracing_adds_no_device_read_and_off_records_nothing(binned, grid_problem, monkeypatch):
    """The span args come from the host layouts: a traced run reads no more
    tensor values than an untraced one, and neither makes a CUDA event or
    a synchronise; with tracing off no span is recorded anywhere."""
    reads = {}
    for name, tracer in (("off", None), ("on", obs.Tracer())):
        calls = _Calls(monkeypatch)
        syncs = obs.process_registry().counter("host/syncs").value
        _run_als(binned, tracer)
        _run_sgd(grid_problem, tracer)
        reads[name] = (calls.n, obs.process_registry().counter("host/syncs").value - syncs)
        monkeypatch.undo()
        assert not {"synchronize", "Event", "current_stream"} & set(calls.n)
    assert reads["on"] == reads["off"]
    # two ALS iterations of two RMSE reads each, two SGD epochs of one
    assert reads["on"][1] == 2 * 2 + 2
    assert obs.current_tracer() is obs.NULL_TRACER
    assert obs.NULL_TRACER.step_span("x", cat="iteration", a=1) is obs.NOOP_SPAN
    assert obs.NULL_TRACER.resolve() is None and obs.NULL_TRACER.spans() == []


class _CudaLooking(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` reads True, so the driver takes its
    card-only branches (the stream synchronise) on the CPU."""

    @property
    def is_cuda(self):
        return True


def _fake_stream(monkeypatch):
    class Stream:
        syncs = 0

        def synchronize(self):
            Stream.syncs += 1

    stream = Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    return Stream


def test_sgd_train_synchronises_only_for_a_registry(grid_problem, monkeypatch):
    grid, _ = grid_problem
    init = train.sgd_init(grid, train.SgdConfig(f=SPEC.f, lam=SPEC.lam, device="cpu"))
    init = train.SgdState(x=torch.Tensor._make_subclass(_CudaLooking, init.x),
                          theta=torch.Tensor._make_subclass(_CudaLooking, init.theta), epoch=0)
    Stream = _fake_stream(monkeypatch)
    tr = obs.Tracer(device_clock=True)
    _run_sgd(grid_problem, tr, init=init)
    assert Stream.syncs == 0
    assert [e.name for e in tr.spans() if e.parent is None] == ["sgd.epoch"] * 2
    reg = obs.MetricsRegistry()
    _run_sgd(grid_problem, tr, registry=reg, init=init)
    assert Stream.syncs == 2           # the registry's host-clock epoch phases
    assert reg.histogram("epoch_seconds").count == 2


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.recorded = self.waited = False

    def record(self):
        self.recorded = True

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        assert self.recorded and end.recorded and end.waited
        return 1.5


def test_device_clock_events_resolve_only_in_resolve(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    with obs.NULL_TRACER.span("off", cat="kernel"):
        pass
    assert _FakeEvent.made == 0
    tr = obs.Tracer(device_clock=True)
    with tr.step_span("step", cat="iteration"):
        with tr.span("inner", cat="kernel", rows=3):
            pass
    assert _FakeEvent.made == 2              # a step span keeps the host clock
    inner, step = tr.events
    assert (inner.device_ms, step.device_ms) == (None, pytest.approx(step.dur / 1e3))
    assert (inner.clock, step.clock) == ("device", "host")
    assert sorted(tr.spans(), key=lambda e: e.ts) == [step, inner]
    assert (inner.parent, step.parent) == (step.id, None)
    assert inner.device_ms == 1.5
    assert step.args == {"counters": {}} and inner.args == {"rows": 3}
    obj = obs.chrome_trace(tr)
    obs.validate_chrome_trace(obj)
    assert [(ev["args"].get("device_ms"), ev["args"].get("clock"))
            for ev in obj["traceEvents"] if ev["ph"] == "X"] == \
        [(step.device_ms, "host"), (1.5, "device")]
    host = obs.Tracer()
    with host.span("h", cat="kernel"):
        pass
    (h,) = host.spans()
    assert (h.device_ms, h.clock) == (None, None)
    assert "device_ms" not in obs.chrome_trace(host)["traceEvents"][-1]["args"]


def test_device_clock_on_the_cpu_is_the_host_duration(binned):
    tr = obs.Tracer(device_clock=True)
    _run_als(binned, tr)
    spans = tr.spans()
    assert all(e.device_ms == pytest.approx(e.dur / 1e3) and e.clock == "host" for e in spans)
    obs.validate_chrome_trace(obs.chrome_trace(tr))


def test_spans_annotate_the_profiler_timeline(binned):
    tr = obs.Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_als(binned, tr)
    names = {e.key for e in prof.key_averages()}
    assert {"als.iteration", "als.half", "als.bin", "kernel.fused_herm", "kernel.batch_solve",
            "als.scatter", "als.evaluate", "als.rmse_train"} <= names


def test_layout_spans_carry_the_layouts_counts():
    r, _, _, _ = synth.make_synthetic_ratings(SPEC, seed=1)
    rows, cols, vals = blocking.ell_to_coo(r)
    tr = obs.Tracer()
    obs.set_tracer(tr)
    ptr, cc, vv = csr_from_coo(rows, cols, vals, r.m)
    b = bin_rows(ptr, cc, vv, r.n_cols, n_bins=4)
    grid = blocking.block_coo(rows, cols, vals, r.m, r.n_cols, G)
    obs.set_tracer(None)
    spans = tr.spans()
    top = [e for e in spans if e.parent is None]
    assert [(e.name, e.cat) for e in top] == [("layout.bin_rows", "layout"),
                                               ("layout.block_coo", "layout")]
    fills = _children(spans, top[0].id)
    assert [(e.name, e.args) for e in fills] == [
        ("layout.bin", dict(bin=i, rows=x.m, K=x.K, nnz=x.nnz)) for i, x in enumerate(b.bins)]
    assert all([k.name for k in _children(spans, e.id)] == ["layout.pad_csr"] for e in fills)
    tiles = _children(spans, top[1].id)
    assert [e.name for e in tiles] == ["layout.pad_csr"] * G * G
    assert sum(e.args["nnz"] for e in tiles) == grid.nnz == top[1].args["nnz"]


def test_kernel_load_span(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(build, "build", lambda names: list(names))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("lib", path))
    tr = obs.Tracer()
    obs.set_tracer(tr)
    build.load("hermitian")
    (tmp_path / "batch_solve.so").write_bytes(b"")
    build.load("batch_solve")
    build.load("hermitian")
    obs.set_tracer(None)
    assert [(e.name, e.cat, e.args) for e in tr.spans()] == [
        ("kernel.load", "build", {"library": "hermitian", "compiled": True}),
        ("kernel.load", "build", {"library": "batch_solve", "compiled": False})]


def test_phase_is_a_parent_like_a_span():
    tr, reg = obs.Tracer(), obs.MetricsRegistry()
    with tr.span("outer", cat="half"):
        with obs.phase("wave", cat="solve", tracer=tr, registry=reg):
            with tr.span("inner", cat="kernel"):
                pass
            with obs.phase("commit", cat="checkpoint", tracer=tr):
                tr.instant("mark", cat="checkpoint")
        with tr.span("after", cat="kernel"):
            pass
    ids = {e.name: e for e in tr.events}
    assert ids["outer"].parent is None
    assert ids["wave"].parent == ids["outer"].id
    assert ids["inner"].parent == ids["commit"].parent == ids["wave"].id
    assert ids["mark"].parent == ids["commit"].id
    assert ids["after"].parent == ids["outer"].id
    assert len({e.id for e in tr.events}) == len(tr.events)
    assert tr._stack() == []
    assert reg.phase_seconds().keys() == {"solve"}
    with obs.phase("untraced", cat="solve", tracer=obs.NULL_TRACER, registry=reg):
        pass
    assert len(tr.events) == 6


def test_streaming_driver_spans_sit_under_its_phases():
    """``run_streaming_als`` on the binned schedule: the in-core bins'
    ``als.bin`` and ``kernel.*`` spans hang under the wave phase that ran
    them, up through the half and the iteration to the run's
    ``als.stream``; the prefetch worker's loads are its own thread's top."""
    spec = synth.SynthSpec("oc", 96, 40, 1500, 8, 0.05)
    r, _, rte, _ = synth.make_synthetic_ratings(spec, seed=0)
    st = store.RatingStore(r, q=4, n_bins=4)
    plan = partition.plan_for(spec.m, spec.n, r.nnz, spec.f, p=1, q=4, n_data=2,
                              eps=spec.n * (spec.f * spec.f + 3 * spec.f + 1) * 4,
                              buffers=4, hbm_bytes=1 << 22, bin_fills=st.bin_fill_pairs())
    sched = schedule.build_schedule(plan, spec.m, spec.n, n_data=2)
    cfg = als.AlsConfig(f=spec.f, lam=spec.lam, iters=1, mode="kernel", device="cpu")
    tr = obs.Tracer()
    obs.set_tracer(tr)                 # as --trace installs it
    run_streaming_als(st, sched, cfg, train_eval=als.ell_triplet(r, "cpu"),
                      test_eval=als.ell_triplet(rte, "cpu"))
    obs.set_tracer(None)
    spans = tr.spans()
    by_id = {e.id: e for e in spans}
    (top,) = [e for e in spans if e.name == "als.stream"]
    assert top.parent is None
    for e in spans:
        if e.tid != top.tid:
            assert (e.name, e.parent) == ("prefetch.load", None)
            continue
        chain = [e.name]
        while by_id[e.id].parent is not None:
            e = by_id[e.parent]
            chain.append(e.name)
        assert chain[-1] == "als.stream", chain
        if chain[0] == "als.bin":
            assert chain[1:] == ["als.wave_x", "als.solve_x_half", "als.iteration",
                                 "als.stream"]
        if chain[0] == "kernel.fused_herm":
            assert chain[1] in ("als.bin", "als.wave_theta"), chain
    names = [e.name for e in spans]
    assert "als.bin" in names
    assert names.count("als.wave_x") == names.count("als.wave_theta") == len(sched.waves)
    assert {by_id[e.parent].name for e in spans if e.name == "kernel.fused_herm"} == \
        {"als.bin", "als.wave_theta"}
    assert any(by_id[e.parent].name == "als.wave_theta"
               for e in spans if e.name == "kernel.batch_solve")
