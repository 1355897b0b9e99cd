"""What a traced run collects: device-clock spans around the program's
calls, and a ``torch.profiler`` window reduced to busy time, the top
device operations and the longest idle gaps, each card of the cell on
its own."""
from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

import torch

#: chrome-trace categories that occupy the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each breakdown list
TOP = 10


def cards(devices) -> list[torch.device]:
    """The distinct CUDA cards of a cell's device list, in its order: a
    card listed twice, as a mesh whose cells share it lists it, is one."""
    out: list[torch.device] = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d not in out:
            out.append(d)
    return out


def _card_of(args, kwargs):
    """The card of a call's first CUDA tensor argument (None: the current
    card)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


class OpTimer:
    """Wraps module attributes so that each call, while ``on``, is timed on
    the device's clock (CUDA events on the current stream of the card its
    first CUDA tensor argument lives on; the host clock on the CPU, for
    tests) and its arguments' shapes are kept for the work counts.  The
    program looks these names up at call time, so a wrapper sees every
    call the program makes through them."""

    def __init__(self, devices):
        self.cards = cards(devices)
        self.cuda = bool(self.cards)
        self.on = False
        self.calls: dict[str, list] = defaultdict(list)
        self._undo: list = []

    def _mark(self, card):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(card))
            return ev
        return time.perf_counter()

    def wrap(self, module, attr: str, key: str, shapes=None) -> None:
        orig = getattr(module, attr)

        def timed(*args, **kwargs):
            if not self.on:
                return orig(*args, **kwargs)
            card = _card_of(args, kwargs) if self.cuda else None
            t0 = self._mark(card)
            out = orig(*args, **kwargs)
            self.calls[key].append((t0, self._mark(card), shapes(*args) if shapes else None))
            return out

        setattr(module, attr, timed)
        self._undo.append((module, attr, orig))

    def restore(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()

    def ms(self, key: str) -> list[tuple[float, object]]:
        """(milliseconds, shapes) of every timed call under ``key``."""
        if self.cuda:
            for card in self.cards:
                torch.cuda.synchronize(card)
            return [(a.elapsed_time(b), s) for a, b, s in self.calls.get(key, [])]
        return [((b - a) * 1e3, s) for a, b, s in self.calls.get(key, [])]


class Profile:
    """A ``torch.profiler`` window opened and closed from a driver's
    callbacks, both at points where the device is idle, over the cell's
    cards."""

    def __init__(self, devices):
        self.cards = [c.index for c in cards(devices)]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cards:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
            self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
            self.prof.stop()

    def reduce(self) -> dict:
        """busy_s, window_s, each card's busy seconds and the breakdown of
        the traced window."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        return reduce_trace(events, self.t1 - self.t0, self.cards)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list, window_s: float, cards: list[int] | None = None) -> dict:
    """Each card's busy seconds (the union of its device intervals, by the
    chrome trace's ``args.device``; ``cards`` keeps those cards, None
    keeps every card the trace has), ``busy_s``: their mean over the cards
    that show work, the device operations that took most time, summed over
    the cards, and the longest idle gaps between one card's device work,
    pooled over the cards, each named by the innermost host operation
    running at its middle (or, where none runs, the last one that ended
    before it)."""
    home = cards[0] if cards else 0
    dev: dict[int, list] = defaultdict(list)
    host = []
    by_name: dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a, d = float(ev["ts"]), float(ev["dur"])
        if ev.get("cat") in DEVICE_CATS:
            card = int(ev.get("args", {}).get("device", home))
            if cards is not None and card not in cards:
                continue
            dev[card].append((a, a + d))
            by_name[ev.get("name", "?")] += d * 1e-6
        elif ev.get("cat") == "cpu_op":
            host.append((a, a + d, ev.get("name", "?")))
    card_busy, gaps = {}, []
    for card in (cards if cards is not None else sorted(dev)):
        merged = _merge(dev.get(card, []))
        card_busy[card] = sum(b - a for a, b in merged) * 1e-6
        gaps += [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                 for i in range(len(merged) - 1)]
    working = [b for b in card_busy.values() if b > 0]
    busy = sum(working) / len(working) if working else 0.0
    idle = []
    for length, a, b in sorted(gaps, reverse=True)[:TOP]:
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
    return {"busy_s": busy, "window_s": window_s, "card_busy_s": card_busy,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": idle}
