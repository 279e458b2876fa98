"""Affine state normalisation to [-1, 1]^d.

Port of ``nngparareal_tpu/utils/normalize.py``: states map through
2(x-mn)/(mx-mn)-1 and the vector field is rescaled by 2/(mx-mn). The
bounds are numpy arrays; ``ODE.get_vector_field`` applies the inverse map
to tensors with the bounds moved to the device once.
"""

import numpy as np


class Normalize:
    def __init__(self, mn, mx, norm_type=None):
        self.mn = np.asarray(mn, dtype=float)
        self.mx = np.asarray(mx, dtype=float)
        if norm_type is None:
            norm_type = "identity"
        norm_type = str(norm_type).lower()
        if norm_type not in ("identity", "-11"):
            raise NotImplementedError("Only 'identity' and '-11' normalisations exist")
        self.norm_type = norm_type

    @property
    def is_identity(self):
        return self.norm_type == "identity"

    def fit(self, x):
        if self.is_identity:
            return x
        return 2.0 * (x - self.mn) / (self.mx - self.mn) - 1.0

    def inverse(self, x):
        if self.is_identity:
            return x
        return (x + 1.0) / 2.0 * (self.mx - self.mn) + self.mn

    def get_scale(self):
        if self.is_identity:
            return 1.0
        return 2.0 / (self.mx - self.mn)
