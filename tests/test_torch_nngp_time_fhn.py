"""Port parity for the time-augmented nnGP end to end: FHN at its
configuration, two iterations (tests/test_variants.py:30-35: nn=10,
reps=2, nn_iters=2, nm_max_iters=40), against the JAX package on the CPU.

Both reach K=2 with the same conv_int, and the iterates of every
iteration lie within 10x JAX's own control (u0 moved by 4e-16, one sign
draw): the searches differ from JAX's at the rounding level
(tests/test_torch_nngp_time.py), and the control moves JAX's own
iterates by ~2e-7 here. Its own file: the port's eager searches take
~35 s on one CPU thread, JAX and its control ~20 s each.
"""

import numpy as np

from test_torch_knn_elm import _one_torch_thread, fhn_pair  # noqa: F401

CONFIG = dict(model="nngp_time", nn=10, reps=2, nn_iters=2, nm_max_iters=40,
              early_stop=2, keep_history=True, measure_serial_fine=False)


def test_fhn_two_iterations_within_the_jax_control():
    pj, pt = fhn_pair()
    oj, ot = pj.run(**CONFIG), pt.run(**CONFIG)
    pc, _ = fhn_pair(nudge=4e-16)
    oc = pc.run(**CONFIG)
    assert ot["k"] == oj["k"] == 2 and ot["conv_int"] == oj["conv_int"]
    assert np.isfinite(ot["u"]).all()
    hj, ht, hc = oj["u_hist"], ot["u_hist"], oc["u_hist"]
    assert ht.shape == hj.shape
    for it in range(1, hj.shape[2]):
        gap = np.abs(ht[:, :, it] - hj[:, :, it]).max()
        ctl = np.abs(hc[:, :, it] - hj[:, :, it]).max()
        assert gap <= 10.0 * ctl, (it, gap, ctl)
    tm = ot["timings"]
    # one search per round per active interval; 40 iterations at most
    assert len(tm["nm_iterations"]) == 2 * ((pt.N - 1) + (pt.N - 2))
    assert max(tm["nm_iterations"]) <= 40 and tm["nm_graph_replays"] == 0
