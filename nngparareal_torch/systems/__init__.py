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
from nngparareal_torch.systems.pdes import FHNPDE, Burgers, DiffReact
from nngparareal_torch.systems.registry import make_system

__all__ = ["ODE", "FHNODE", "Rossler", "Hopf", "DblPend", "Brusselator",
           "Lorenz", "ThomasLabyrinth", "FHNPDE", "Burgers", "DiffReact",
           "make_system"]
