"""nngparareal_torch: the PyTorch/CUDA port of nngparareal_tpu.

Parareal, GParareal and nnGParareal for NVIDIA GPUs. Plain tensor code is PyTorch in
float64; the fine fan-out, the JAX package's one Pallas TPU kernel, is a
hand-written CUDA kernel in f64 (csrc/rk_fanout.cu) and, for
``RKSolver(fine='pallas')``, in the Pallas kernel's own double-single
arithmetic (csrc/ds_fanout.cu), each built with nvcc at first use and
bound with ctypes. The package imports neither jax nor nngparareal_tpu.

Entry points (the systems, ``RKSolver``, ``Parareal``) put their tensors
on the CUDA card unless the caller passes ``device="cpu"``. ``make_mesh``
builds the device mesh that ``Parareal.run(mesh=...)`` splits the fine
fan-out over (every visible card by default).
"""

from nngparareal_torch.systems import (
    ODE,
    FHNODE,
    Rossler,
    Hopf,
    DblPend,
    Brusselator,
    Lorenz,
    ThomasLabyrinth,
    FHNPDE,
    Burgers,
    DiffReact,
)
from nngparareal_torch.systems.configs import Config
from nngparareal_torch.solver import RKSolver, ScipySolver
from nngparareal_torch.driver import Parareal, PararealLight
from nngparareal_torch.parallel import make_mesh

__all__ = [
    "ODE",
    "FHNODE",
    "Rossler",
    "Hopf",
    "DblPend",
    "Brusselator",
    "Lorenz",
    "ThomasLabyrinth",
    "FHNPDE",
    "Burgers",
    "DiffReact",
    "Config",
    "RKSolver",
    "ScipySolver",
    "Parareal",
    "PararealLight",
    "make_mesh",
]

__version__ = "0.1.0"
