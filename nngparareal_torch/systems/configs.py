"""Canonical per-system run parameters from the paper.

Port of ``nngparareal_tpu/systems/configs.py`` for the systems the port
has: FHN ODE, FHN-PDE and Burgers. ``Config(ode).get()`` yields {tspan,
u0, N, Ng, Nf, G, F} with per-slice step counts Ng/Nf (and ``epsilon`` for
FHN-PDE).
"""

import numpy as np

from nngparareal_torch.systems.base import ODE
from nngparareal_torch.systems.odes import FHNODE
from nngparareal_torch.systems.pdes import FHNPDE, Burgers


class Config:
    """Config(ode, N=..., d_x=...).get() -> dict of run parameters."""

    def __init__(self, ode: ODE, N=None, d_x=None):
        if isinstance(ode, FHNODE):
            cfg = self._fhn_ode()
        elif isinstance(ode, FHNPDE):
            cfg = self._fhn_pde(d_x)
        elif isinstance(ode, Burgers):
            cfg = self._burgers(ode.d_x, N)
        else:
            raise NotImplementedError(
                f"No config for {type(ode).__name__} in the port yet "
                "(ROADMAP.md, modules still to port)"
            )

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
