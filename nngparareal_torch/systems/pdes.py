"""Discretised PDE systems: viscous Burgers.

Port of ``nngparareal_tpu/systems/pdes.py:Burgers``. The periodic 3-point
stencils are ``torch.roll`` over the last axis. The [-1,1]-normalised form
is also integrated by the CUDA fan-out kernel (ops/rk_cuda.py), which takes
the two stencil constants ``_inv_h2`` and ``0.5 * _inv_2h`` as arguments.
"""

import numpy as np
import torch

from nngparareal_torch.systems.base import ODE


class Burgers(ODE):
    """Viscous Burgers 1D, periodic BC, nu=1/100, d=d_x.
    u0 = 0.5(cos(4.5 pi x) + 1)."""

    def __init__(self, d_x, nu=1.0 / 100.0, **kwargs):
        self.d_x = int(d_x)
        self.nu = float(nu)
        d = self.d_x
        self.d = d
        h = 2.0 / (d - 1)
        self._h = h
        self._inv_h2 = nu / (h * h)
        self._inv_2h = 1.0 / (2.0 * h)

        mn, mx = np.array([[0.0] * d, [1.0] * d])
        x = np.linspace(-1.0, 1.0, num=d)
        u0 = 0.5 * (np.cos(4.5 * np.pi * x) + 1.0)
        super().__init__(f"Burgers_{d_x}", mn, mx, u0, **kwargs)

    def _f(self, t, u):
        up = torch.roll(u, -1, dims=-1)  # u[i+1], periodic
        um = torch.roll(u, 1, dims=-1)   # u[i-1], periodic
        u_xx = (up - 2.0 * u + um) * self._inv_h2
        u_x = (up - um) * self._inv_2h
        return u_xx - u * u_x

    def _f_norm11(self, t, v):
        """[-1,1]-normalized field fused algebraically (bounds [0,1]^d):
        u=(v+1)/2 and scale=2 give f_n(v) = Dxx v - (v+1)(Dx v)/2."""
        vp = torch.roll(v, -1, dims=-1)
        vm = torch.roll(v, 1, dims=-1)
        v_xx = (vp - 2.0 * v + vm) * self._inv_h2
        v_x = (vp - vm) * (0.5 * self._inv_2h)
        return v_xx - (v + 1.0) * v_x

    def get_device_field(self):
        if self.normalizer.norm_type != "-11":
            return None
        from nngparareal_torch.ops.rk_cuda import BurgersField

        return BurgersField(inv_h2=self._inv_h2,
                            half_inv_2h=0.5 * self._inv_2h)
