"""Classic Parareal correction: pred = F(u^k) - G(u^k).

Port of ``nngparareal_tpu/models/bare.py``.
"""

from nngparareal_torch.models.base import ModelBase


class BareParareal(ModelBase):
    name = "Parareal"
    needs_dataset = False

    def predict_fn(self, ds, q, uF_prev, uG_prev, i):
        return uF_prev - uG_prev
