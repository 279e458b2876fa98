"""Read the JAX package's per-iteration checkpoints.

The JAX driver pickles its state after every iteration
(``nngparareal_tpu/driver.py:_store_int``): u, uG, uF, the padded dataset,
k, I, the timings and the model state, all as numpy arrays and Python
scalars. ``from_jax_checkpoint`` turns such a payload into the port's
form, and ``load_checkpoint`` unpickles a file without importing jax: it
refuses any class outside numpy, so a pickle that holds JAX objects fails
with a clear message instead. ``elm_params_from_jax`` carries an ELM's
random projection across from the JAX model's arrays.
"""

import pickle

import numpy as np
import torch

from nngparareal_torch.utils.device import resolve_device

_ARRAYS = ("u", "uG", "uF", "ds_X", "ds_D", "ds_valid")
_SCALARS = (bool, int, float, str, type(None), np.generic)


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".", 1)[0]
        if root == "numpy":
            return super().find_class(module, name)
        if root in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"checkpoint holds a JAX object ({module}.{name}); the port "
                "reads only numpy arrays and Python scalars — convert it "
                "with np.asarray before pickling"
            )
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}; only numpy arrays and "
            "Python scalars are allowed"
        )


def load_checkpoint(path):
    """Unpickle a checkpoint file that holds only numpy and Python data."""
    with open(path, "rb") as fh:
        return _NumpyOnlyUnpickler(fh).load()


def _check_plain(x, where):
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            raise TypeError(f"{where}: object arrays are not allowed")
        return
    if isinstance(x, _SCALARS):
        return
    if isinstance(x, dict):
        for k, v in x.items():
            _check_plain(v, f"{where}[{k!r}]")
        return
    if isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _check_plain(v, f"{where}[{i}]")
        return
    mod = type(x).__module__.split(".", 1)[0]
    if mod in ("jax", "jaxlib"):
        raise TypeError(
            f"{where} is a JAX object ({type(x).__name__}); convert it with "
            "np.asarray before handing the checkpoint to the port"
        )
    raise TypeError(
        f"{where} is a {type(x).__module__}.{type(x).__name__}; only numpy "
        "arrays and Python scalars are allowed"
    )


def from_jax_checkpoint(payload, device=None):
    """Convert a JAX checkpoint payload (a dict) into the port's form.

    The state arrays (u, uG, uF, ds_X, ds_D, ds_valid) become float64
    tensors on ``device`` (None: the CUDA card; it raises without one);
    everything else (k, I, err_cols, conv_int, the
    timings, model_state, the run's identity) is returned as it was.
    """
    if not isinstance(payload, dict):
        raise TypeError("a checkpoint payload is a dict")
    _check_plain(payload, "checkpoint")
    missing = [k for k in _ARRAYS + ("k", "I", "model_state") if k not in payload]
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    device = resolve_device(device)
    out = dict(payload)
    for k in _ARRAYS:
        # a copy: unpickled arrays may be read-only, and the driver
        # appends to the dataset in place
        out[k] = torch.tensor(np.asarray(payload[k], dtype=np.float64),
                              device=device)
    out["err_cols"] = [np.asarray(e) for e in payload.get("err_cols", [])]
    out["conv_int"] = [int(c) for c in payload.get("conv_int", [])]
    out["k"] = int(payload["k"])
    out["I"] = int(payload["I"])
    return out


def elm_params_from_jax(bias, C):
    """The random projection of a JAX ``ELM`` (its ``_bias`` (res, 1) and
    ``_C`` (res, P), handed over as numpy arrays) as the keywords of the
    port's ``ELM.set_projection``: f64 copies, checked to be plain numpy
    data of the right ranks."""
    _check_plain([bias, C], "ELM projection")
    out = {"bias": np.array(bias, dtype=np.float64),
           "C": np.array(C, dtype=np.float64)}
    if out["bias"].ndim != 2 or out["bias"].shape[1] != 1 or (
            out["C"].ndim != 2 or out["C"].shape[0] != out["bias"].shape[0]):
        raise ValueError(f"ELM projection shapes {out['bias'].shape} and "
                         f"{out['C'].shape}; expected (res, 1) and (res, P)")
    return out
