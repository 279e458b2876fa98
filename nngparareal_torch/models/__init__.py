from nngparareal_torch.models.base import ModelBase, Dataset
from nngparareal_torch.models.bare import BareParareal
from nngparareal_torch.models.gp import GParareal
from nngparareal_torch.models.gp_scipy import GPScipy
from nngparareal_torch.models.nngp import NNGParareal

__all__ = ["ModelBase", "Dataset", "BareParareal", "GParareal", "GPScipy",
           "NNGParareal"]
