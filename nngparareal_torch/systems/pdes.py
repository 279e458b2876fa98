"""Discretised PDE systems: the FitzHugh-Nagumo 2D PDE and viscous Burgers.

Port of ``nngparareal_tpu/systems/pdes.py:FHNPDE`` and ``:Burgers``. The
periodic stencils are ``torch.roll`` over the grid axes, written over the
last axes so that one state and a batch of slices go through the same
field. The [-1,1]-normalised forms are also integrated by the CUDA fan-out
kernel (ops/rk_cuda.py), which takes each field's constants as arguments
(``get_device_field``).
"""

import numpy as np
import torch

from nngparareal_torch.systems.base import ODE


def _periodic_second_diff(n, h):
    """(1/h^2) * tridiag(1, -2, 1) with periodic wrap."""
    T = -2.0 * np.eye(n)
    idx = np.arange(n - 1)
    T[idx, idx + 1] = 1.0
    T[idx + 1, idx] = 1.0
    T[0, -1] = 1.0
    T[-1, 0] = 1.0
    return T / (h * h)


class FHNPDE(ODE):
    """FitzHugh-Nagumo 2-species 2D reaction-diffusion PDE, periodic BC,
    d = 2*dx*dy. The state is [u1 row-major (d_y, d_x), u2 row-major]; the
    initial condition is the legacy-seeded numpy draw of the JAX package,
    bit for bit. ``dense_laplacian()`` is the dense Kronecker operator, a
    test oracle for the 5-point stencil."""

    # reaction and diffusion constants; get_device_field hands the same
    # values to the kernel
    A, B, K, TAU = 2.8e-4, 5e-3, -5e-3, 0.1

    def __init__(self, d_x, seed=45, **kwargs):
        self.d_x = int(d_x)
        self.d_y = int(d_x)
        d = 2 * self.d_x * self.d_y
        self.d = d

        self._hx2 = (2.0 / (self.d_x - 1)) ** 2
        self._hy2 = (2.0 / (self.d_y - 1)) ** 2

        mn, mx = np.array([[-1.0] * d, [1.0] * d])

        # legacy bit-generator shim: seed the *global* numpy RNG, then wrap
        # its bit generator, as the JAX package does
        np.random.seed(seed)
        if hasattr(np.random, "get_bit_generator"):
            rng = np.random.Generator(np.random.get_bit_generator())
        else:  # pragma: no cover
            rng = np.random.default_rng(seed)
        u0 = rng.uniform(size=d)

        super().__init__(f"FHN_PDE_{d_x}", mn, mx, u0, **kwargs)
        # the diffusion coefficients of the two species, made on the
        # device once: a tensor built from a list in the field would be a
        # host-to-device copy in every evaluation
        self._ab = torch.tensor([self.A, self.B], dtype=torch.float64,
                                device=self.device)[:, None, None]

    def _lap_stencil(self, g):
        """Periodic 5-point Laplacian of g with shape (..., d_y, d_x)."""
        g2 = 2.0 * g
        gxx = (torch.roll(g, -1, dims=-1) - g2
               + torch.roll(g, 1, dims=-1)) / self._hx2
        gyy = (torch.roll(g, -1, dims=-2) - g2
               + torch.roll(g, 1, dims=-2)) / self._hy2
        return gxx + gyy

    def dense_laplacian(self):
        """Reference-style dense Kronecker operator (test oracle)."""
        h_x = 2.0 / (self.d_x - 1)
        h_y = 2.0 / (self.d_y - 1)
        Dxx = _periodic_second_diff(self.d_x, h_x)
        Dyy = _periodic_second_diff(self.d_y, h_y)
        return np.kron(np.eye(self.d_y), Dxx) + np.kron(Dyy, np.eye(self.d_x))

    def _f(self, t, u):
        # both species as one (..., 2, d_y, d_x) view, so that one launch
        # of each op serves both: one stencil pass, then a*L(u1) + u1 and
        # b*L(u2) + u1 together. Per element the arithmetic and its order
        # are the JAX package's:
        #   U = a*L(u1) + u1 - u1**3 - u2 + k
        #   V = (1/tau) * (b*L(u2) + u1 - u2)
        g = u.reshape(*u.shape[:-1], 2, self.d_y, self.d_x)
        u1, u2 = g[..., 0:1, :, :], g[..., 1, :, :]
        s = self._lap_stencil(g) * self._ab + u1
        out = torch.empty_like(g)
        torch.add(s[..., 0, :, :] - u1[..., 0, :, :] ** 3 - u2, self.K,
                  out=out[..., 0, :, :])
        torch.mul(s[..., 1, :, :] - u2, 1.0 / self.TAU, out=out[..., 1, :, :])
        return out.reshape(u.shape)

    def _f_norm11(self, t, v):
        """The [-1,1]-normalised field. The bounds are [-1, 1], so the
        generic wrapper's raw((v + 1) / 2 * 2 + (-1)) * 1 is bitwise
        raw((v + 1) - 1): halving and doubling are exact, and so is the
        scale of 1. Two launches instead of five."""
        return self._f(t, (v + 1.0) - 1.0)

    def get_device_field(self):
        if self.normalizer.norm_type != "-11":
            return None
        from nngparareal_torch.ops.rk_cuda import FhnPdeField

        return FhnPdeField(d_x=self.d_x, d_y=self.d_y,
                           inv_hx2=1.0 / self._hx2, inv_hy2=1.0 / self._hy2,
                           a=self.A, b=self.B, k=self.K,
                           inv_tau=1.0 / self.TAU)


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
