"""The fine fan-out's slice axis over several devices.

Port of ``nngparareal_tpu/parallel/mesh.py``. The JAX package shards the
(N, d) slice states over a 1-D device mesh with ``shard_map``: each device
integrates its contiguous block of slices and XLA gathers the endpoints.
Here a mesh is a tuple of torch devices, and ``shard_fine_fanout`` does
the same by hand: each block moves to its device, its fan-out is queued
on that device's current stream (the CUDA kernel on a card, the plain
integrator on the CPU, in the solver's fine arithmetic, f64 or
double-single), every block is launched before any result is
gathered, so that separate cards run at once, and the blocks come back in
order onto the mesh's first device.

A mesh may name one device more than once (``devices=["cpu"] * 8``, or a
card repeated): its blocks then run one after another on that device, as
the JAX tests' 8 virtual CPU devices share one host. Such a mesh drives
the real split, gather and per-block launches, and gives the same values
as the unsharded fan-out; its time says nothing about separate cards.
"""

import numpy as np
import torch

SLICE_AXIS = "slices"


class Mesh:
    """A 1-D mesh: ``devices``, an array of torch devices (``.size`` as a
    JAX mesh's), and ``axis_names``."""

    def __init__(self, devices, axis_names=(SLICE_AXIS,)):
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        self.devices = arr
        self.axis_names = tuple(axis_names)


def _checked(device):
    """``device`` as a torch.device that exists here (a CUDA index beyond
    the visible cards, or any card where there is none, raises)."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = 0 if device.index is None else device.index
        if index >= count:
            raise RuntimeError(f"mesh device {device} does not exist: "
                               f"{count} CUDA device(s) visible")
        device = torch.device("cuda", index)
    elif device.type != "cpu":
        raise ValueError(f"mesh devices are cuda or cpu, not {device}")
    return device


def make_mesh(n_devices=None, axis_name=SLICE_AXIS, devices=None):
    """1-D mesh over the time-slice axis.

    By default every visible CUDA card (raises when there is none);
    ``devices`` is taken as given, and may repeat a device. ``n_devices``
    takes the first n of them, and raises when there are fewer."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] (e.g. ['cpu'] * 8) for a mesh "
                               "on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_checked(d) for d in devices]
    if n_devices is not None:
        n = int(n_devices)
        if not 1 <= n <= len(devices):
            raise ValueError(f"make_mesh: {n} devices asked for, "
                             f"{len(devices)} available")
        devices = devices[:n]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, (axis_name,))


class SliceSharding:
    """The contiguous block split of a slice axis over a mesh, as the JAX
    package's ``NamedSharding(mesh, P(axis))``: block j of a batch of B
    (B divisible by the mesh's size) is rows [j B/n, (j+1) B/n) on device
    j."""

    def __init__(self, mesh, axis_name=SLICE_AXIS):
        if axis_name not in mesh.axis_names:
            raise ValueError(f"axis {axis_name!r} is not among the mesh's "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.axis_name = axis_name

    def blocks(self, B):
        """[(device, slice)] of each block of a batch of B rows."""
        n = self.mesh.devices.size
        if B % n:
            raise ValueError(f"a batch of {B} slices does not divide over "
                             f"{n} devices; pad it to a multiple of {n}")
        b = B // n
        return [(dev, slice(j * b, (j + 1) * b))
                for j, dev in enumerate(self.mesh.devices)]


def slice_sharding(mesh, axis_name=SLICE_AXIS):
    return SliceSharding(mesh, axis_name)


def _to(x, device):
    # a copy to a card is queued without a wait; to the host it waits,
    # so that the values are there when the host reads them
    return x.to(device, non_blocking=device.type == "cuda")


def shard_fine_fanout(fine_batch_fn, mesh, axis_name=SLICE_AXIS):
    """Wrap a fan-out ``(t0s, t1s, U) -> U'`` that runs on its inputs'
    device: each device integrates its own contiguous block of slices.

    The batch size must be divisible by the mesh size (the driver pads
    the slice axis). All blocks are launched before any is gathered; the
    result comes back in order on the mesh's first device."""
    sharding = slice_sharding(mesh, axis_name)
    first = mesh.devices[0]

    def sharded(t0s, t1s, U):
        outs = [fine_batch_fn(_to(t0s[sl], dev), _to(t1s[sl], dev),
                              _to(U[sl], dev))
                for dev, sl in sharding.blocks(int(U.shape[0]))]
        return torch.cat([_to(o, first) for o in outs])

    return sharded
