from nngparareal_torch.systems.base import ODE
from nngparareal_torch.systems.odes import FHNODE
from nngparareal_torch.systems.pdes import FHNPDE, Burgers

__all__ = ["ODE", "FHNODE", "FHNPDE", "Burgers"]
