"""The measured window of a training job, driven from its driver's callback.

Set-up ends at the callback after the first step: the window opens there
and closes at the callback of the step that crosses the run's seconds.
A traced run then keeps a ``torch.profiler`` window open for a few more
steps.  Each callback comes after the step's RMSE ``float()``, so the
device is idle at both ends.  The callback stops the driver by raising
:class:`Closed`.

The window covers every card of the cell: it waits for each, and reads and
resets each card's allocator peak at the opening and at the close.
"""
from __future__ import annotations

import math
import sys
import time
from collections import defaultdict

import torch

from mfbench import devtrace

#: steps of the traced run's profiler window, and its least seconds
PROFILE_STEPS = 3
PROFILE_MIN_S = 1.0


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Closed(Exception):
    """Raised from the callback to stop the driver at the window's close."""


def used_cards(peaks: dict, card_busy: dict | None = None) -> list[int]:
    """The cards a run used, from ``peaks`` ({card: (set-up peak, window
    peak)}): those that held or allocated memory in the window (its peak,
    read after the reset at the opening, above 0), and, where a traced
    run gives ``card_busy`` ({card: busy seconds}), showed device work in
    the profiler's window."""
    return [card for card, (_, window) in peaks.items()
            if window > 0 and (card_busy is None or card_busy.get(card, 0) > 0)]


class Window:
    """Callback state of one run.  After the driver stops it holds the
    set-up seconds, the window's seconds and steps, each card's allocator
    peaks (``peaks``), the first step's factors, the last state, ``prev``:
    the tensors that ``keep`` picks of the state before it, and every
    step's record.

    ``prev`` lives on the host: each callback starts a copy of ``keep`` of
    its state into pinned host buffers, on a side stream of each card
    those tensors live on, which runs beside the next step, so that the
    benchmark holds no factor on a card and the allocator's peaks are the
    program's own.  The callback's own state is held until the next
    callback, as the driver itself holds it through the next step's
    update."""

    def __init__(self, seconds: float, trace: bool, devices, t_start: float,
                 keep=lambda state: (state.x, state.theta)):
        self.seconds, self.trace, self.t_start = seconds, trace, t_start
        self.keep = keep
        self.cards = devtrace.cards(devices)
        self.cuda = bool(self.cards)
        self.timer = devtrace.OpTimer(devices)
        self.prof = devtrace.Profile(devices) if trace else None
        self.phase = "setup"
        self.steps = self.prof_steps = 0
        self.history: list[dict] = []
        self.prev = self.last = self.first = None
        self.setup_peaks = {c.index: 0 for c in self.cards}
        self.window_peaks = dict(self.setup_peaks)
        self.t_close = None
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._bufs: list[tuple] = []
        self._pending = None

    def _side_stream(self, card: torch.device):
        if card not in self._streams:
            self._streams[card] = torch.cuda.Stream(card)
        return self._streams[card]

    def _hold(self, state) -> tuple | None:
        """Starts the host copy of ``keep(state)`` and returns the finished
        copy of the state before it.  Two sets of buffers, used in turn,
        are made at the first call, in set-up."""
        tensors = self.keep(state)
        if not self._bufs:
            self._bufs = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                                for t in tensors) for _ in range(2)]
        done = self._pending
        buf = self._bufs[0] if done is not self._bufs[0] else self._bufs[1]
        if self.cuda:
            by_card = defaultdict(list)
            for b, t in zip(buf, tensors):
                by_card[t.device].append((b, t))
            for card, pairs in by_card.items():
                stream = self._side_stream(card)
                stream.wait_stream(torch.cuda.current_stream(card))
                with torch.cuda.stream(stream):
                    for b, t in pairs:
                        b.copy_(t, non_blocking=True)
        else:
            for b, t in zip(buf, tensors):
                b.copy_(t)
        self._pending = buf
        return done

    def _sync(self) -> None:
        for card in self.cards:
            torch.cuda.synchronize(card)

    def _read_peaks(self) -> dict:
        return {c.index: torch.cuda.max_memory_allocated(c) for c in self.cards}

    def __call__(self, state, rec) -> None:
        now = time.perf_counter()
        for stream in self._streams.values():
            stream.synchronize()            # the last callback's copy has landed
        self.prev = self._hold(state)
        self.last = state
        self.history.append(rec)
        if self.phase == "setup":
            self.first = (state.x.cpu(), state.theta.cpu())
            self._sync()
            now = time.perf_counter()
            self.setup_s = now - self.t_start
            self.setup_peaks = self._read_peaks()
            for card in self.cards:
                torch.cuda.reset_peak_memory_stats(card)
            log(f"set-up {self.setup_s:.2f} s; window opens")
            self.phase, self.t_open = "window", now
            self.timer.on = self.trace
            return
        if self.phase == "window":
            self.steps += 1
            if now - self.t_open < self.seconds:
                return
            self.t_close = now
            self.window_peaks = self._read_peaks()
            self.timer.on = False
            if not self.trace:
                raise Closed
            self.phase = "profile"
            self.prof.start()
            return
        self.prof_steps += 1
        if self.prof_steps >= PROFILE_STEPS and now - self.prof.t0 >= PROFILE_MIN_S:
            self.prof.stop()
            raise Closed

    def run(self, driver, *args, **kwargs) -> None:
        """Calls ``driver(*args, callback=self, **kwargs)`` until the window
        (and a traced run's profiler window) closes."""
        try:
            driver(*args, callback=self, **kwargs)
        except Closed:
            pass
        finally:
            self.timer.restore()
        if self.t_close is None:
            raise RuntimeError("the driver returned before the window closed")
        self._sync()
        log(f"window {self.window_s:.3f} s, {self.steps} steps; judging")

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def step_ms(self) -> float:
        return self.window_s / self.steps * 1e3

    @property
    def failed(self) -> int:
        """Steps of the window whose record holds a value that is not finite."""
        return sum(1 for h in self.history[1:self.steps + 1]
                   if not all(math.isfinite(v) for v in h.values()))

    def e2e(self, step_metric: str) -> dict:
        """The end-to-end values; ``peak_mem_GiB`` is the fullest card's
        window peak."""
        return {"setup_s": self.setup_s, step_metric: self.step_ms,
                "peak_mem_GiB": max(self.window_peaks.values(), default=0) / 2**30}

    @property
    def peaks(self) -> dict:
        """{card: (set-up peak, window peak)} in bytes, for each of the
        cell's cards."""
        return {c: (self.setup_peaks[c], self.window_peaks[c]) for c in self.setup_peaks}
