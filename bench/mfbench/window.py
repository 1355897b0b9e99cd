"""The measured window of a training job, driven from its driver's callback.

Set-up ends at the callback after the first step: the window opens there
and closes at the callback of the step that crosses the run's seconds.
A traced run then keeps a ``torch.profiler`` window open for a few more
steps.  Each callback comes after the step's RMSE ``float()``, so the
device is idle at both ends.  The callback stops the driver by raising
:class:`Closed`.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from mfbench import devtrace

#: steps of the traced run's profiler window, and its least seconds
PROFILE_STEPS = 3
PROFILE_MIN_S = 1.0


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Closed(Exception):
    """Raised from the callback to stop the driver at the window's close."""


class Window:
    """Callback state of one run.  After the driver stops it holds the
    set-up seconds, the window's seconds and steps, the allocator's peaks,
    the first step's factors, the last state, ``prev``: the tensors that
    ``keep`` picks of the state before it, and every step's record.

    ``prev`` lives on the host: each callback starts a copy of ``keep`` of
    its state into pinned host buffers on a side stream, which runs beside
    the next step, so that the benchmark holds no factor on the card and
    the allocator's peak is the program's own.  The callback's own state
    is held until the next callback, as the driver itself holds it
    through the next step's update."""

    def __init__(self, seconds: float, trace: bool, device: torch.device, t_start: float,
                 keep=lambda state: (state.x, state.theta)):
        self.seconds, self.trace, self.t_start = seconds, trace, t_start
        self.keep = keep
        self.cuda = device.type == "cuda"
        self.timer = devtrace.OpTimer(device)
        self.prof = devtrace.Profile(device) if trace else None
        self.phase = "setup"
        self.steps = self.prof_steps = 0
        self.history: list[dict] = []
        self.prev = self.last = self.first = None
        self.setup_peak = self.window_peak = 0
        self.t_close = None
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        self._bufs: list[tuple] = []
        self._pending = None

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
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                for b, t in zip(buf, tensors):
                    b.copy_(t, non_blocking=True)
        else:
            for b, t in zip(buf, tensors):
                b.copy_(t)
        self._pending = buf
        return done

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self, state, rec) -> None:
        now = time.perf_counter()
        if self.cuda:
            self._stream.synchronize()      # the last callback's copy has landed
        self.prev = self._hold(state)
        self.last = state
        self.history.append(rec)
        if self.phase == "setup":
            self.first = (state.x.cpu(), state.theta.cpu())
            self._sync()
            now = time.perf_counter()
            self.setup_s = now - self.t_start
            if self.cuda:
                self.setup_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            log(f"set-up {self.setup_s:.2f} s; window opens")
            self.phase, self.t_open = "window", now
            self.timer.on = self.trace
            return
        if self.phase == "window":
            self.steps += 1
            if now - self.t_open < self.seconds:
                return
            self.t_close = now
            if self.cuda:
                self.window_peak = torch.cuda.max_memory_allocated()
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
        return {"setup_s": self.setup_s, step_metric: self.step_ms,
                "peak_mem_GiB": self.window_peak / 2**30}

    @property
    def memory_peak(self) -> int:
        return max(self.setup_peak, self.window_peak)
