"""Canonical per-system run parameters from the paper.

Port of ``nngparareal_tpu/systems/configs.py``: the seven ODEs, FHN-PDE
and Burgers (DiffReact has none, as in the JAX package).
``Config(ode).get()`` yields {tspan, u0, N, Ng, Nf, G, F} with per-slice
step counts Ng/Nf (and
``epsilon`` for FHN-PDE). Hopf and ThomasLabyrinth need ``N``, and their
Config appends ``_{N}`` to the system's name, as in the JAX package.
"""

import numpy as np

from nngparareal_torch.systems.base import ODE
from nngparareal_torch.systems.odes import (
    FHNODE,
    Rossler,
    Hopf,
    DblPend,
    Brusselator,
    Lorenz,
    ThomasLabyrinth,
)
from nngparareal_torch.systems.pdes import FHNPDE, Burgers


class Config:
    """Config(ode, N=..., d_x=...).get() -> dict of run parameters."""

    def __init__(self, ode: ODE, N=None, d_x=None):
        if isinstance(ode, FHNODE):
            cfg = self._fhn_ode()
        elif isinstance(ode, Rossler):
            cfg = self._rossler()
        elif isinstance(ode, Hopf):
            cfg = self._hopf(N)
            ode.name += f"_{N}"
        elif isinstance(ode, DblPend):
            cfg = self._pend()
        elif isinstance(ode, Brusselator):
            cfg = self._brus()
        elif isinstance(ode, Lorenz):
            cfg = self._lorenz()
        elif isinstance(ode, ThomasLabyrinth):
            cfg = self._tomlab(N)
            ode.name += f"_{N}"
        elif isinstance(ode, FHNPDE):
            cfg = self._fhn_pde(d_x)
        elif isinstance(ode, Burgers):
            cfg = self._burgers(ode.d_x, N)
        else:
            # as the JAX package: DiffReact has no configuration
            raise Exception("No config for input ODE")

        if "u0" in cfg:
            ode.set_default_init_cond(cfg["u0"])
        self.config = cfg

    @staticmethod
    def _fhn_ode():
        N = 40
        Ng = N * 4
        Nf = int(160000 / 160 * Ng)
        return dict(
            tspan=[0, 40], u0=np.array([-1.0, 1.0]), N=N, Ng=Ng / N, Nf=Nf / N,
            G="RK2", F="RK4",
        )

    @staticmethod
    def _rossler():
        N, Ng, Nf = 20, 45000, 2250000
        return dict(
            tspan=[0, 340], u0=np.array([0.0, -6.78, 0.02]), N=N * 2,
            Ng=2 * Ng / (2 * N), Nf=2 * Nf / (2 * N), G="RK1", F="RK4",
        )

    @staticmethod
    def _hopf(N):
        if N is None:
            raise Exception("N must be provided for Hopf")
        Ng = 2 * 1024
        Nf = Ng * 85
        return dict(
            tspan=[-20, 500], u0=np.array([0.1, 0.1, -20.0]), N=N,
            Ng=Ng / N, Nf=Nf / N, G="RK1", F="RK8",
        )

    @staticmethod
    def _pend():
        N = 32
        Ng = 3072 + N
        Nf = Ng * 70
        return dict(
            tspan=[0, 80], u0=np.array([-0.5, 0.0, 0.0, 0.0]), N=N,
            Ng=Ng / N, Nf=Nf / N, G="RK1", F="RK8",
        )

    @staticmethod
    def _brus():
        N = 25
        Ng = N * 10
        Nf = Ng * 100
        return dict(
            tspan=[0, 100], u0=np.array([1.0, 3.07]), N=N,
            Ng=Ng / N, Nf=Nf / N, G="RK4", F="RK4",
        )

    @staticmethod
    def _lorenz():
        N = 50
        Ng = N * 6
        Nf = Ng * 75
        return dict(
            tspan=[0, 18], u0=np.array([-15.0, -15.0, 20.0]), N=N,
            Ng=Ng / N, Nf=Nf / N, G="RK4", F="RK4",
        )

    @staticmethod
    def _tomlab(N):
        tot_time = {32: 10, 64: 10, 128: 40, 256: 100, 512: 100}.get(N)
        if tot_time is None:
            raise Exception("Invalid N value for ThomasLabyrinth")
        Ng = N * 10
        Nf = Ng * int(np.ceil(1e6 / Ng))
        u0 = np.array([4.6722764, 5.2437205e-10, -6.4444208e-10])
        return dict(
            tspan=[0, tot_time], u0=u0, N=N, Ng=Ng / N, Nf=Nf / N,
            G="RK1", F="RK4",
        )

    @staticmethod
    def _fhn_pde(d_x):
        # the d-scaling experiment: N=512; (coarse steps per slice, T,
        # coarse method) per grid width, dx=16's row for any other width
        N = 512
        params = {
            10: (3, 150, "RK2"),
            12: (12, 550, "RK2"),
            14: (25, 950, "RK2"),
            16: (25, 1100, "RK4"),
        }
        mul, T, G = params.get(d_x, (25, 1100, "RK4"))
        Ng = N * mul
        Nf = int(np.ceil(1e4 / Ng) * Ng)
        return dict(
            tspan=[0, T], N=N, Ng=Ng / N, Nf=Nf / N, G=G, F="RK8",
            epsilon=5e-7,
        )

    @staticmethod
    def _burgers(d_x, N=None):
        # scalability-driver setup: N=d=128, Ng = 4N total, Nf = 1e4 * Ng
        # total, RK1/RK8, T=5.9
        N = 128 if N is None else int(N)
        Ng = 4 * N
        Nf = int(1e4) * Ng
        return dict(
            tspan=[0, 5.9], N=N, Ng=Ng / N, Nf=Nf / N, G="RK1", F="RK8",
        )

    @staticmethod
    def _enforce_types(cfg):
        for key, val in cfg.items():
            if key in ("N", "Ng", "Nf"):
                cfg[key] = int(val)
            elif key == "u0":
                cfg[key] = np.array(val)
        return cfg

    def get(self):
        return self._enforce_types(self.config)
