from nngparareal_torch.models.base import ModelBase, Dataset
from nngparareal_torch.models.bare import BareParareal
from nngparareal_torch.models.elm import ELM
from nngparareal_torch.models.gp import GParareal
from nngparareal_torch.models.gp_scipy import GPScipy
from nngparareal_torch.models.knn_mean import KNNMean
from nngparareal_torch.models.nngp import NNGParareal
from nngparareal_torch.models.nngp_scipy import NNGPScipy
from nngparareal_torch.models.nngp_time import NNGPTime

__all__ = ["ModelBase", "Dataset", "BareParareal", "ELM", "GParareal",
           "GPScipy", "KNNMean", "NNGParareal", "NNGPScipy", "NNGPTime"]
