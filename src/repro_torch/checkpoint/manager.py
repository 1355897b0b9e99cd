"""Checkpoint manager: async writes, retention, restart-from-latest.

Paper §4.4: "During ALS execution we asynchronously checkpoint X and Theta
generated from the latest iteration ... When the machine fails, the latest
X or Theta (whichever is more recent) is used to restart ALS."

``save`` snapshots every tensor leaf to a host numpy copy synchronously
and commits to disk on a background thread; numpy leaves are taken as
they are, so callers pass copies they will not mutate.
``restore_or_init`` implements the restart path.  ``keep`` bounds disk
usage.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (_flatten, _unflatten, latest_step,
                                          restore_checkpoint, save_checkpoint)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu())
    return leaf


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any):
        """Snapshot to host then commit (async unless configured otherwise)."""
        self.wait()
        host_tree = _unflatten(tree, iter(_host_copy(leaf) for _, leaf in _flatten(tree)))

        def commit():
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()
            except BaseException as e:   # surfaced on next wait()/save()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=commit, daemon=True)
            self._thread.start()
        else:
            commit()

    def restore_or_init(self, tree_like: Any, init_fn: Callable[[], Any]):
        """The restart path: latest checkpoint if one committed, else init."""
        step = latest_step(self.directory) if os.path.isdir(self.directory) else None
        if step is None:
            return init_fn(), 0
        return restore_checkpoint(self.directory, tree_like, step), step
