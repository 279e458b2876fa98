from nngparareal_torch.utils.normalize import Normalize
from nngparareal_torch.utils.timing import Timer, wall_timed
from nngparareal_torch.utils.io import (
    store_pickle,
    read_pickle,
    store_fig,
    slim_run,
    print_cond,
)

__all__ = [
    "Normalize",
    "Timer",
    "wall_timed",
    "store_pickle",
    "read_pickle",
    "store_fig",
    "slim_run",
    "print_cond",
]
