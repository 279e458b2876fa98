"""``run_table2(pool=k)``: whole-system runs fanned over k spawned worker
processes (the JAX package's ``run_table2(pool=...)``, the reference's
``pool.map(do, systems)``), each worker on ``device`` (the card unless
``device="cpu"``; the JAX package's workers force the CPU because a TPU
chip cannot be shared between processes, a card can).

* FHN's bare Parareal through a pool of 2 spawned workers on the CPU:
  K=11, conv_int and the errors equal to the in-process run's (~40 s:
  skipped unless RUN_SLOW=1, as the JAX package's own pool test is; the
  card runs it in chip_smoke.py's mesh phase).
* ``pool`` with ``mesh`` raises the JAX package's ValueError before any
  run, and each system's task pickles: plain values only.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from nngparareal_torch import experiments as texp
from nngparareal_torch.parallel import make_mesh

RUN_SLOW = os.environ.get("RUN_SLOW", "0") == "1"
KW = dict(models=("parareal",), results_dir=None, systems=["FHN_ODE"],
          device="cpu")


@pytest.mark.skipif(not RUN_SLOW,
                    reason="spawns torch workers (set RUN_SLOW=1)")
def test_table2_pool_matches_sequential():
    seq = texp.run_table2(**KW)
    par = texp.run_table2(pool=2, **KW)
    assert [r["system"] for r in par] == [r["system"] for r in seq] == [
        "FHN_ODE"]
    (rp,), (rs,) = par[0]["runs"], seq[0]["runs"]
    assert rp["k"] == rs["k"] == 11
    assert rp["conv_int"] == rs["conv_int"]
    np.testing.assert_array_equal(rp["err"], rs["err"])


def test_table2_pool_and_mesh_exclude_each_other_and_tasks_pickle():
    assert texp.run_table2(results_dir=None, systems=["nope"],
                           device="cpu") == []
    with pytest.raises(ValueError, match="mutually exclusive"):
        texp.run_table2(results_dir=None, systems=["nope"], pool=2,
                        mesh=make_mesh(devices=["cpu"] * 2), device="cpu")
    tasks = texp._table2_tasks([0, 4], 5e-7, ["parareal", "nngp"], "cpu",
                               dict(optimizer="grid"), None)
    back = pickle.loads(pickle.dumps(tasks))
    assert back == [(0, 5e-7, ("parareal", "nngp"), torch.device("cpu"),
                     dict(optimizer="grid"), None),
                    (4, 5e-7, ("parareal", "nngp"), torch.device("cpu"),
                     dict(optimizer="grid"), None)]
    # the worker's function pickles by reference, as spawn ships it
    assert pickle.loads(pickle.dumps(texp._run_table2_system)) is (
        texp._run_table2_system)
