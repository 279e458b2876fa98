"""nngparareal_torch: the PyTorch/CUDA port of nngparareal_tpu.

Parareal and nnGParareal for NVIDIA GPUs. Plain tensor code is PyTorch in
float64; the fine fan-out, the JAX package's one Pallas TPU kernel, is a
hand-written CUDA kernel (csrc/rk_fanout.cu) built with nvcc at first use
and bound with ctypes. The package imports neither jax nor nngparareal_tpu.

Entry points (the systems, ``RKSolver``, ``Parareal``) put their tensors
on the CUDA card unless the caller passes ``device="cpu"``.
"""

from nngparareal_torch.systems import ODE, FHNODE, FHNPDE, Burgers
from nngparareal_torch.systems.configs import Config
from nngparareal_torch.solver import RKSolver
from nngparareal_torch.driver import Parareal

__all__ = [
    "ODE",
    "FHNODE",
    "FHNPDE",
    "Burgers",
    "Config",
    "RKSolver",
    "Parareal",
]
