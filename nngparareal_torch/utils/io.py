"""Result artifacts.

Port of ``nngparareal_tpu/utils/io.py``: pickled results, figures saved
as png and pdf, slimmed run dicts and a Gram matrix's conditioning. None
of it needs matplotlib at import time.
"""

import os
import pickle

import numpy as np
import torch


def store_pickle(obj, name, path=""):
    if path and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "wb") as fh:
        pickle.dump(obj, fh, pickle.HIGHEST_PROTOCOL)


def read_pickle(name, path=""):
    with open(os.path.join(path, name), "rb") as fh:
        return pickle.load(fh)


def store_fig(fig, name, img_dir="img"):
    """Save a matplotlib figure as both png and pdf under ``img_dir``."""
    os.makedirs(img_dir, exist_ok=True)
    fig.savefig(os.path.join(img_dir, f"{name}.png"), dpi=200)
    fig.savefig(os.path.join(img_dir, f"{name}.pdf"))


def slim_run(out, drop=("u", "u_hist", "x", "D", "data_x", "data_D")):
    """A shallow copy of a run dict without its bulky arrays."""
    return {k: v for k, v in out.items() if k not in drop}


def print_cond(K, jitted=False):
    """Print the eigenvalue magnitudes' range and the condition number of
    ``K`` (a tensor or an array)."""
    if isinstance(K, torch.Tensor):
        K = K.detach().cpu().numpy()
    K = np.asarray(K)
    e_vals = np.abs(np.linalg.eig(K)[0])
    tag = "--- Jitted:" if jitted else "--"
    print(
        f"{tag} max |eig|: {e_vals.max():0.2e}, min |eig|: {e_vals.min():0.2e}, "
        f"ratio: {e_vals.max() / e_vals.min():0.2e}, "
        f"truth: {np.linalg.cond(K):0.2e}"
    )
