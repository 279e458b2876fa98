"""Problem-definition base class.

Port of ``nngparareal_tpu/systems/base.py``: a named system with an
optional [-1,1]^d normalisation wrapper, a default initial condition and a
``(t, u) -> du/dt`` vector field written in torch ops over the last axis,
so the same function serves one state (d,) and a batch of slices (B, d).

A system that the CUDA fan-out kernel can integrate also returns a
*device field* (``get_device_field``): the kernel cannot run an arbitrary
Python field, so it takes the field's constants instead.
"""

import numpy as np
import torch

from nngparareal_torch.utils.device import resolve_device
from nngparareal_torch.utils.normalize import Normalize


class ODE:
    def __init__(self, name, mn, mx, u0, normalization=None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.normalizer = Normalize(mn, mx, normalization)
        self.u0 = np.asarray(self.normalizer.fit(np.asarray(u0, dtype=float)))

    # subclasses implement the raw (unnormalised) field in torch ops
    def _f(self, t, u):
        raise NotImplementedError("abstract vector field")

    def get_vector_field(self):
        norm = self.normalizer
        raw = self._f
        if norm.is_identity:
            return raw
        # systems may provide an algebraically fused normalized field
        # (saves the affine unwrap/rescale ops in the RK hot loop)
        fused = getattr(self, "_f_norm11", None)
        if fused is not None and norm.norm_type == "-11":
            return fused
        mn, mx, scale = (torch.as_tensor(x, dtype=torch.float64,
                                         device=self.device)
                         for x in (norm.mn, norm.mx, norm.get_scale()))
        span = mx - mn

        def f_normalized(t, u):
            # norm.inverse(u) with the bounds already on the device
            return raw(t, (u + 1.0) / 2.0 * span + mn) * scale

        return f_normalized

    def get_device_field(self):
        """Constants of the field for the CUDA fan-out kernel, or None
        when the kernel has no form of this system's field yet."""
        return None

    def set_default_init_cond(self, u0):
        self.u0 = np.asarray(self.normalizer.fit(np.asarray(u0, dtype=float)))

    def get_init_cond(self, u0=None):
        if u0 is None:
            u0 = np.array(self.u0, dtype=float)
        else:
            u0 = self.normalizer.fit(np.asarray(u0, dtype=float))
        return torch.as_tensor(u0, dtype=torch.float64, device=self.device)

    def get_dim(self):
        return int(self.u0.shape[0])
