"""Result artifacts.

Port of ``store_pickle`` from ``nngparareal_tpu/utils/io.py``: the
experiment drivers pickle their summary rows under ``results_dir``.
"""

import os
import pickle


def store_pickle(obj, name, path=""):
    if path and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "wb") as fh:
        pickle.dump(obj, fh, pickle.HIGHEST_PROTOCOL)
