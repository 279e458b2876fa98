"""Wall-clock timing.

Port of ``nngparareal_tpu/utils/timing.py``. CUDA work is queued
asynchronously, so ``wall_timed`` and ``Timer.time`` wait for every card
that holds a tensor of the result before they read the clock.
"""

import time

import torch


def _block(x):
    """Wait for every CUDA device that holds a tensor in ``x``."""
    tensors = x if isinstance(x, (tuple, list)) else [x]
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


def wall_timed(fn):
    """Wrap fn so it returns (result, seconds), waiting for device work."""

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        return out, time.perf_counter() - t0

    return wrapper


class Timer:
    """Accumulating named wall-clock timer."""

    def __init__(self):
        self.totals = {}

    def add(self, name, seconds):
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def time(self, name, fn, *args, **kwargs):
        out, seconds = wall_timed(fn)(*args, **kwargs)
        self.add(name, seconds)
        return out

    def get(self, name):
        return self.totals.get(name, 0.0)
