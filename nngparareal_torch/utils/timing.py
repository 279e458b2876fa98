"""Wall-clock timing.

Port of ``nngparareal_tpu/utils/timing.py``. CUDA work is queued
asynchronously, so ``wall_timed`` waits for every card that holds a
tensor of the result before it reads the clock.
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
