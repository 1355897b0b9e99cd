"""The window's callback: where it opens and closes, and the state before
the last kept as a copy off the program's tensors."""
import time
from types import SimpleNamespace

import pytest
import torch

from mfbench.window import Window


def _states(n):
    return [SimpleNamespace(x=torch.full((3, 2), float(i)), theta=torch.full((2, 2), -float(i)))
            for i in range(n)]


def _drive(w, states, pause=0.0):
    def driver(callback):
        for s in states:
            time.sleep(pause)
            callback(s, {"rmse": 1.0})
    w.run(driver)


@pytest.mark.parametrize("seconds,pause", [(0.0, 0.0), (0.05, 0.02)])
def test_prev_is_a_copy_of_the_state_before_the_last(seconds, pause):
    states = _states(40)
    w = Window(seconds, False, [torch.device("cpu")], time.perf_counter())
    _drive(w, states, pause)
    last = next(i for i, s in enumerate(states) if s is w.last)
    assert w.steps == last >= 1
    x, theta = w.prev
    assert torch.equal(x, states[last - 1].x) and torch.equal(theta, states[last - 1].theta)
    assert x.data_ptr() != states[last - 1].x.data_ptr()
    assert torch.equal(w.first[0], states[0].x)


def test_keep_picks_what_is_copied():
    states = _states(5)
    w = Window(0.0, False, [torch.device("cpu")], time.perf_counter(),
               keep=lambda state: (state.theta,))
    _drive(w, states)
    assert len(w.prev) == 1 and torch.equal(w.prev[0], states[0].theta)


def test_driver_that_stops_early_is_an_error():
    w = Window(60.0, False, [torch.device("cpu")], time.perf_counter())
    with pytest.raises(RuntimeError):
        _drive(w, _states(3))
