"""The ODE zoo: the seven d < 64 systems of the paper.

Port of ``nngparareal_tpu/systems/odes.py``. Each field is written over
the last axis so that it takes one state (d,) or a batch (B, d), with the
JAX package's arithmetic in the same order: the CUDA fan-out kernel's
functors (csrc/rk_fanout.cu) repeat these expressions op by op, and the
tests hold both against JAX. ``device_kind`` names the kernel's functor
of each system (``ODE.get_device_field``).
"""

import numpy as np
import torch

from nngparareal_torch.systems.base import ODE


class FHNODE(ODE):
    """FitzHugh-Nagumo ODE."""

    device_kind = "fhn_ode"

    def __init__(self, **kwargs):
        mn, mx = np.array([[-2.0, -1.0], [2.1, 1.2]])
        super().__init__("FHN_ODE", mn, mx, np.array([-1.0, 1.0]), **kwargs)

    @staticmethod
    def _f(t, u):
        a, b, c = 0.2, 0.2, 3.0
        u0, u1 = u[..., 0], u[..., 1]
        return torch.stack(
            [
                c * (u0 - (u0 * u0 * u0) / 3.0 + u1),
                -(1.0 / c) * (u0 - a + b * u1),
            ],
            dim=-1,
        )


class Rossler(ODE):
    """Rossler attractor."""

    device_kind = "rossler"

    def __init__(self, **kwargs):
        mn, mx = np.array([[-10.0, -11.0, 0.0], [12.0, 8.0, 23.0]])
        super().__init__("Rossler", mn, mx, np.array([0.0, -6.78, 0.02]),
                         **kwargs)

    @staticmethod
    def _f(t, u):
        a, b, c = 0.2, 0.2, 5.7
        u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
        return torch.stack([-u1 - u2, u0 + a * u1, b + u2 * (u0 - c)], dim=-1)


class Hopf(ODE):
    """Non-autonomous Hopf bifurcation; time is the third state coordinate.
    ``maxtime`` = tspan[1]."""

    device_kind = "hopf"

    def __init__(self, tspan=(-20.0, 500.0), **kwargs):
        mn, mx = np.array([[-23.0, -23.0, 0.0], [23.0, 23.0, 1.0]])
        self.maxtime = float(tspan[1])
        u0 = np.array([0.1, 0.1, float(tspan[0])])
        super().__init__("Hopf", mn, mx, u0, **kwargs)

    def _f(self, t, u):
        u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
        mu = u2 / self.maxtime - u0 * u0 - u1 * u1
        return torch.stack([-u1 + u0 * mu, u0 + u1 * mu, torch.ones_like(u0)],
                           dim=-1)

    def device_constants(self):
        return (self.maxtime,)


class DblPend(ODE):
    """Planar double pendulum."""

    device_kind = "dblpend"

    def __init__(self, **kwargs):
        mn, mx = np.array([[-2.0, -2.5, -17.0, -3.5], [2.0, 2.5, 1.0, 3.5]])
        super().__init__("DblPend", mn, mx, np.array([-0.5, 0.0, 0.0, 0.0]),
                         **kwargs)

    @staticmethod
    def _f(t, u):
        u0, u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
        dq = u0 - u2
        cd, sd = torch.cos(dq), torch.sin(dq)
        sin0, sin2 = torch.sin(u0), torch.sin(u2)
        sq1, sq3 = u1 * u1, u3 * u3
        den = -1.0 / (2.0 - cd * cd)
        d1 = den * (sq1 * cd * sd + sq3 * sd + 2.0 * sin0 - cd * sin2)
        d3 = den * (-2.0 * sq1 * sd - sq3 * sd * cd - 2.0 * cd * sin0
                    + 2.0 * sin2)
        return torch.stack([u1, d1, u3, d3], dim=-1)


class Brusselator(ODE):
    """Brusselator reaction."""

    device_kind = "brusselator"

    def __init__(self, **kwargs):
        mn, mx = np.array([[0.4, 0.9], [4.0, 5.0]])
        super().__init__("Brusselator", mn, mx, np.array([1.0, 3.07]),
                         **kwargs)

    @staticmethod
    def _f(t, u):
        u0, u1 = u[..., 0], u[..., 1]
        sq0_u1 = u0 * u0 * u1
        return torch.stack([1.0 + sq0_u1 - 4.0 * u0, 3.0 * u0 - sq0_u1],
                           dim=-1)


class Lorenz(ODE):
    """Lorenz '63."""

    device_kind = "lorenz"

    def __init__(self, **kwargs):
        mn, mx = np.array([[-17.1, -23.0, 6.0], [18.1, 25.0, 45.0]])
        super().__init__("Lorenz", mn, mx, np.array([-15.0, -15.0, 20.0]),
                         **kwargs)

    @staticmethod
    def _f(t, u):
        u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
        return torch.stack(
            [
                10.0 * (u1 - u0),
                28.0 * u0 - u1 - u0 * u2,
                u0 * u1 - (8.0 / 3.0) * u2,
            ],
            dim=-1,
        )


class ThomasLabyrinth(ODE):
    """Thomas' cyclically symmetric attractor."""

    device_kind = "tomlab"

    def __init__(self, **kwargs):
        mn, mx = np.array([[-12.0, -12.0, -12.0], [12.0, 12.0, 12.0]])
        u0 = np.array([4.6722764, 5.2437205e-10, -6.4444208e-10])
        super().__init__("ThomasLabyrinth", mn, mx, u0, **kwargs)

    @staticmethod
    def _f(t, u):
        a, b = 0.5, 10.0
        s = b * torch.sin(u)
        return -a * u + torch.roll(s, -1, dims=-1)
