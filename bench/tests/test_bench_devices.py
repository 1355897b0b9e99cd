"""A cell on the cards it asks for: the profiler's reduction per card, the
count of cards a run used, and ``run_cell``'s result line over more than
one card, on the CPU with stand-in drivers that report fake cards, and on
the card (``card``) with a stand-in that spreads its work over them."""
import importlib
import random
import sys
import textwrap
import time
from collections import defaultdict

import pytest
import torch

from mfbench import devtrace, registry
from mfbench.devtrace import DEVICE_CATS, TOP, _merge, reduce_trace
from mfbench.window import used_cards

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
TRACED_KEYS = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
DEVICE_KEYS = ["platform", "kind", "count", "memory_peak_bytes"]


# -- reduce_trace -------------------------------------------------------------

def _kernel(card, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"device": card}}


def _host(ts, dur, name):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur}


def _four_card_trace():
    """Kernels on cards 0-3 (microseconds): card 0 has two that overlap,
    card 1 one inside another, cards 2 and 3 overlap card 0 in time; two
    host operations."""
    return [
        _kernel(0, 0, 100, "a"), _kernel(0, 50, 100, "a"), _kernel(0, 400, 100, "b"),
        _kernel(1, 10, 300, "a"), _kernel(1, 20, 50, "b"),
        _kernel(2, 0, 1000, "c"),
        _kernel(3, 100, 50, "b"), _kernel(3, 900, 50, "b"),
        _host(0, 1000, "step"), _host(160, 200, "aten::item"),
    ]


def test_busy_is_each_cards_union_and_the_mean_over_the_cards():
    got = reduce_trace(_four_card_trace(), 2.0, cards=[0, 1, 2, 3])
    assert got["card_busy_s"] == pytest.approx({0: 250e-6, 1: 300e-6, 2: 1000e-6, 3: 100e-6})
    assert got["busy_s"] == pytest.approx((250 + 300 + 1000 + 100) / 4 * 1e-6)
    assert got["window_s"] == 2.0
    # operations summed over the cards, as on one
    assert dict((k, v) for k, v in got["device_ops"]) == pytest.approx(
        {"a": 500e-6, "b": 250e-6, "c": 1000e-6})
    # gaps of one card each, pooled longest first: card 3's 750, card 0's 250
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx([750e-6, 250e-6])
    assert got["idle_gaps"][1][0] == "aten::item"


def test_only_the_cells_cards_are_kept():
    events = _four_card_trace() + [_kernel(5, 0, 5000, "other")]
    got = reduce_trace(events, 1.0, cards=[0, 1])
    assert set(got["card_busy_s"]) == {0, 1}
    assert got["busy_s"] == pytest.approx(275e-6)
    assert "other" not in dict(got["device_ops"]) and "c" not in dict(got["device_ops"])


def test_a_card_without_work_is_left_out_of_the_mean():
    got = reduce_trace(_four_card_trace(), 1.0, cards=[0, 7])
    assert got["card_busy_s"][7] == 0.0
    assert got["busy_s"] == pytest.approx(250e-6)


def _one_card_reduce(events: list, window_s: float) -> dict:
    """The reduction as it was before it split the trace by card: one
    union of every device interval."""
    dev, host = [], []
    by_name: dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a, d = float(ev["ts"]), float(ev["dur"])
        if ev.get("cat") in DEVICE_CATS:
            dev.append((a, a + d))
            by_name[ev.get("name", "?")] += d * 1e-6
        elif ev.get("cat") == "cpu_op":
            host.append((a, a + d, ev.get("name", "?")))
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:TOP]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        before = [h for h in host if h[1] <= mid]
        if inside:
            name = min(inside, key=lambda h: h[1] - h[0])[2]
        elif before:
            name = "after " + max(before, key=lambda h: h[1])[2]
        else:
            name = "no host operation"
        idle.append([name, length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": window_s,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": idle}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_device_arg", [True, False])
def test_one_card_is_the_one_card_reduction_bit_for_bit(seed, with_device_arg):
    rng = random.Random(seed)
    events, t = [], 0.0
    for _ in range(rng.randrange(0, 300)):
        t += rng.uniform(0, 40)
        ev = {"ph": "X", "cat": rng.choice(DEVICE_CATS + ("cpu_op", "cuda_runtime")),
              "name": rng.choice("abcdefghijklmn"), "ts": t + rng.random(),
              "dur": rng.uniform(0.1, 60)}
        if with_device_arg:
            ev["args"] = {"device": 0}
        events.append(ev)
    events.append({"ph": "i", "cat": "kernel", "ts": 1.0})
    window_s = rng.uniform(0.5, 2.0)
    want = _one_card_reduce(events, window_s)
    got = reduce_trace(events, window_s, cards=[0])
    assert got.pop("card_busy_s") == {0: want["busy_s"]}
    assert got == want


# -- the cards a run used -----------------------------------------------------

@pytest.mark.parametrize("peaks,busy,want", [
    ({0: (5, 9), 1: (5, 8), 2: (5, 8), 3: (5, 7)}, None, [0, 1, 2, 3]),
    ({0: (5, 9), 1: (0, 0), 2: (0, 0), 3: (0, 0)}, None, [0]),
    ({0: (0, 0), 1: (0, 0), 2: (0, 0), 3: (0, 0)}, None, []),
    ({0: (5, 9), 1: (7, 0), 2: (0, 0), 3: (0, 0)}, None, [0]),       # freed before the window
    ({0: (5, 9), 1: (5, 8), 2: (5, 8), 3: (5, 7)}, {0: 0.5, 1: 0.4, 2: 0.0, 3: 0.3}, [0, 1, 3]),
    ({0: (5, 9), 1: (5, 0)}, {0: 0.5, 1: 0.4}, [0]),
], ids=["4_of_4", "1_of_4", "none", "setup_only", "traced_idle_card", "traced_no_memory"])
def test_used_cards(peaks, busy, want):
    assert used_cards(peaks, busy) == want


def test_cards_are_distinct_cuda_devices_in_order():
    cuda = [torch.device("cuda", i) for i in (2, 0, 2, 1, 0)]
    assert devtrace.cards(cuda) == [torch.device("cuda", i) for i in (2, 0, 1)]
    assert devtrace.cards([torch.device("cpu")] * 4) == []


# -- run_cell over stand-in cards ---------------------------------------------

FAKE_CARDS = '''
"""A stand-in driver that reports the peaks (and, traced, the busy
seconds) of fake cards named in its traffic mix."""


def run(cfg, traffic, seed, seconds, trace, devices, t_start):
    peaks = {int(c): tuple(p) for c, p in traffic["peaks"].items()}
    ctx = None
    if trace:
        busy = {int(c): b for c, b in traffic["busy"].items()}
        ctx = {"solver": "als", "device": {
            "busy_s": -1.0, "window_s": 2.0, "card_busy_s": busy,
            "device_ops": [["k", 1.0]], "idle_gaps": [["step", 0.5]]}}
    e2e = {"setup_s": 1.5, "peak_mem_GiB": max(w for _, w in peaks.values()) / 2**30}
    return {"e2e": e2e, "ctx": ctx, "numbers": {"gap": 0.0}, "attempted": 3, "failed": 0,
            "peaks": peaks}
'''

SPREAD = '''
"""A stand-in driver that spreads its work over every entry of
``devices``: a matrix on each, squared each step, through the Window."""
import sys
from types import SimpleNamespace

import torch

from mfbench.window import Window

#: what the test reads after the run: each timed call and the cards
LAST = {}


def square(a):
    return a @ a


def run(cfg, traffic, seed, seconds, trace, devices, t_start):
    n = int(traffic["n"])
    w = Window(seconds, trace, devices, t_start, keep=lambda s: (s.x, s.theta))
    if trace:
        w.timer.wrap(sys.modules[__name__], "square", "square")
    mats = [torch.full((n, n), 1.0 / n, device=d) for d in devices]

    def driver(callback):
        while True:
            out = [square(a) for a in mats]
            total = sum(float(o.sum()) for o in out)
            callback(SimpleNamespace(x=out[0], theta=out[-1]), {"total": total})

    w.run(driver)
    LAST.update(calls=list(w.timer.calls["square"]), cards=[a.device for a in mats])
    ctx = {"solver": "standin", "device": w.prof.reduce()} if trace else None
    return {"e2e": w.e2e("step_ms"), "ctx": ctx, "numbers": {"gap": 0.0},
            "attempted": w.steps, "failed": w.failed, "peaks": w.peaks}
'''


STANDIN_CFG = {"name": "standin"}


def _spec(chips, per_layer=()):
    return {"configs": [{"name": "standin", "file": "none"}],
            "workloads": [{"name": "standin.cell", "config": "standin",
                           "traffic": "standin", "chips": chips}],
            "end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "peak_mem_GiB", "unit": "GiB"}],
            "per_layer": list(per_layer)}


@pytest.fixture
def standin(tmp_path, monkeypatch):
    """Installs a stand-in driver module, made in ``tmp_path`` on the import
    path, as the driver of the traffic mix ``traffic``."""
    def install(source, traffic):
        name = f"standin_{len(list(tmp_path.iterdir()))}_cell"
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(source))
        monkeypatch.syspath_prepend(str(tmp_path))
        monkeypatch.delitem(sys.modules, name, raising=False)
        module = importlib.import_module(name)
        monkeypatch.setattr(registry, "traffic", lambda _: dict(traffic, solver="standin"))
        monkeypatch.setattr(registry, "driver", lambda _: module)
        return module
    return install


GiB = 2**30


@pytest.mark.parametrize("peaks,count,fullest", [
    ({0: (3 * GiB, 2 * GiB), 1: (1 * GiB, 5 * GiB)}, 2, 5 * GiB),
    ({0: (9 * GiB, 2 * GiB), 1: (1 * GiB, 5 * GiB), 2: (1, 1), 3: (4 * GiB, 4 * GiB)}, 4, 9 * GiB),
    ({0: (9 * GiB, 2 * GiB), 1: (0, 0), 2: (0, 0), 3: (0, 0)}, 1, 9 * GiB),
], ids=["2_of_2", "4_of_4", "1_of_4"])
def test_run_cell_counts_the_cards_used(bench_run, standin, peaks, count, fullest):
    standin(FAKE_CARDS, {"peaks": peaks})
    res = bench_run.run_cell("standin.cell", 7, 0.1, False, [torch.device("cpu")],
                             spec=_spec(len(peaks)), config=STANDIN_CFG, limits={"gap": 0.0})
    assert res["device"]["count"] == count
    assert res["device"]["memory_peak_bytes"] == fullest
    assert res["metrics"]["peak_mem_GiB"]["value"] == max(w for _, w in peaks.values()) / GiB
    assert list(res) == RESULT_KEYS and list(res["device"]) == DEVICE_KEYS
    assert res["correct"]


def test_traced_run_cell_averages_busy_over_the_cards_used(bench_run, standin):
    peaks = {0: (GiB, GiB), 1: (GiB, GiB), 2: (GiB, 0), 3: (GiB, GiB)}
    busy = {0: 1.5, 1: 1.0, 2: 2.0, 3: 0.0}
    standin(FAKE_CARDS, {"peaks": peaks, "busy": busy})
    idle = {"name": "device_idle.als", "unit": "%", "better": "lower", "source": "device_trace",
            "layer": "device", "moves": "setup_s"}
    res = bench_run.run_cell("standin.cell", 7, 0.1, True, [torch.device("cpu")],
                             spec=_spec(4, [idle]), config=STANDIN_CFG, limits={"gap": 0.0})
    assert res["device"]["count"] == 2                  # card 2 held nothing, card 3 did nothing
    assert res["device"]["busy_s"] == 1.25 and res["device"]["window_s"] == 2.0
    assert res["metrics"]["device_idle.als"]["value"] == pytest.approx(37.5)
    assert list(res) == TRACED_KEYS
    assert list(res["device"]) == DEVICE_KEYS + ["busy_s", "window_s"]


def test_spread_standin_on_the_cpu(bench_run, standin):
    module = standin(SPREAD, {"n": 8})
    res = bench_run.run_cell("standin.cell", 7, 0.05, True, [torch.device("cpu")] * 4,
                             spec=_spec(4), config=STANDIN_CFG, limits={"gap": 0.0},
                             t_start=time.perf_counter())
    assert res["device"]["count"] == 0                   # no card
    assert res["correct"] and res["attempted"] >= 1
    assert len(module.LAST["calls"]) >= 4


@pytest.mark.card
def test_spread_standin_on_the_cards(bench_run, standin, card):
    """Over min(4, cards) cards, or over one card listed four times; the
    count is the distinct cards, and each call is timed on its tensor's
    card."""
    k = min(4, torch.cuda.device_count())
    devices = ([torch.device("cuda", i) for i in range(k)] if k > 1
               else [torch.device("cuda", 0)] * 4)
    module = standin(SPREAD, {"n": 1024})
    res = bench_run.run_cell("standin.cell", 7, 1.0, True, devices, spec=_spec(len(devices)),
                             config=STANDIN_CFG, limits={"gap": 0.0},
                             t_start=time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == len(set(devices))
    assert res["device"]["memory_peak_bytes"] >= 2 * 1024 * 1024 * 4
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res["device"]) == DEVICE_KEYS + ["busy_s", "window_s", "power_limit_w"]
    calls, cards = module.LAST["calls"], module.LAST["cards"]
    assert len(calls) >= len(cards)
    for i, (t0, t1, _) in enumerate(calls):
        assert t0.device == t1.device == cards[i % len(cards)]
