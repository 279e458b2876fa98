"""Problem-definition base class.

Port of ``nngparareal_tpu/systems/base.py``: a named system with an
optional [-1,1]^d normalisation wrapper, a default initial condition and a
``(t, u) -> du/dt`` vector field written in torch ops over the last axis,
so the same function serves one state (d,) and a batch of slices (B, d).

A system that the CUDA fan-out kernel can integrate also returns a
*device field* (``get_device_field``): the kernel cannot run an arbitrary
Python field, so it takes the field's constants instead. An ODE names its
functor in the kernel (``device_kind``), and hands over its constants and
its normalisation map. The same device field serves the kernel's f64 and
double-single forms. ``get_ds_vector_field`` is the field in
double-single arithmetic, for ``RKSolver(fine_ds=...)``.
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

    def get_ds_vector_field(self):
        """The double-single (f32 pair) twin of the vector field for the
        compensated fine solver (``RKSolver(fine_ds=...)``): the torch
        field lifted by ops/ds_lift.py, ``f_ds(t, (uh, ul)) -> (kh, kl)``.
        Burgers overrides it with its hand-fused field."""
        from nngparareal_torch.ops.ds_lift import ds_lift

        return ds_lift(self.get_vector_field())

    def get_vector_field_numpy(self):
        """Host/numpy twin of the field for scipy-based validation."""
        return numpy_field(self.get_vector_field(), self.device)

    # the fan-out kernel's one-thread-per-slice functor of this system's
    # field (ops/rk_cuda.py:ODE_DIMS), or None
    device_kind = None

    def device_constants(self):
        """The field's constants that the kernel's functor takes."""
        return ()

    def get_device_field(self):
        """The field as the CUDA fan-out kernel takes it, or None when the
        kernel has no form of this system's field yet.

        For an ODE with a ``device_kind``: the functor's kind, its
        constants and the normalisation's affine map per coordinate (mn,
        span = mx - mn, scale), the values ``get_vector_field`` computes
        with; None for the identity map."""
        if self.device_kind is None:
            return None
        from nngparareal_torch.ops.rk_cuda import OdeField

        norm = self.normalizer
        affine = {}
        if not norm.is_identity:
            affine = dict(mn=tuple(norm.mn.tolist()),
                          span=tuple((norm.mx - norm.mn).tolist()),
                          scale=tuple(norm.get_scale().tolist()))
        return OdeField(self.device_kind, tuple(self.device_constants()),
                        **affine)

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


def numpy_field(f, device):
    """``f_np(t, u)``: the torch field ``f`` with numpy in and out,
    evaluated on ``device`` (one round trip per call on a card)."""
    def f_np(t, u):
        u = torch.as_tensor(np.asarray(u, dtype=float), device=device)
        return f(t, u).cpu().numpy()

    return f_np
