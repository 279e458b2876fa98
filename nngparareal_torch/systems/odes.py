"""ODE systems: FitzHugh-Nagumo.

Port of ``nngparareal_tpu/systems/odes.py:FHNODE``; its iteration counts
are the end-to-end oracles of the test suite. The field is written over
the last axis so that it takes one state (2,) or a batch (B, 2).
"""

import numpy as np
import torch

from nngparareal_torch.systems.base import ODE


class FHNODE(ODE):
    """FitzHugh-Nagumo ODE."""

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
