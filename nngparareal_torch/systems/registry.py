"""String registry of systems, covering the reference's legacy names.

Port of ``nngparareal_tpu/systems/registry.py``: names like
``'rossler_long_n'`` or ``'non_aut512_n'``, where the ``_n`` suffix turns
on the [-1,1] normalisation and an embedded integer selects N, and the
modern class names.
"""

import re

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

_ALIASES = {
    "fhn": FHNODE,
    "fhn_ode": FHNODE,
    "rossler": Rossler,
    "rossler_long": Rossler,
    "hopf": Hopf,
    "non_aut": Hopf,
    "dbl_pend": DblPend,
    "dblpend": DblPend,
    "brus_2d": Brusselator,
    "brusselator": Brusselator,
    "lorenz": Lorenz,
    "tom_lab": ThomasLabyrinth,
    "thomaslabyrinth": ThomasLabyrinth,
    "fhn_pde": FHNPDE,
    "burgers": Burgers,
    "diffreact": DiffReact,
}


def make_system(name, **kwargs):
    """make_system('non_aut512_n') -> (ode, {'N': 512}).

    Returns the constructed ODE plus any parameters embedded in the name.
    Keywords go to the system's constructor (``device=`` among them).
    """
    key = name.lower()
    params = {}
    if key.endswith("_n"):
        kwargs.setdefault("normalization", "-11")
        key = key[:-2]
    m = re.match(r"^(non_aut|hopf|tom_lab)(\d+)$", key)
    if m:
        key = m.group(1)
        params["N"] = int(m.group(2))
    if key not in _ALIASES:
        raise KeyError(f"Unknown system {name!r}; known: {sorted(_ALIASES)}")
    cls = _ALIASES[key]
    if cls in (FHNPDE, Burgers, DiffReact) and "d_x" not in kwargs:
        raise TypeError(f"{cls.__name__} requires d_x=")
    return cls(**kwargs), params
