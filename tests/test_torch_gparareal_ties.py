"""Port parity for models/gp.py where a pick is a near tie.

The datasets and helpers of tests/test_torch_gparareal.py, with smooth
targets or the default warm start [1, 1], where the GP's Grams are near
singular and the NLL that ranks two candidates is decided at the rounding
level. The control is the JAX package against itself with the dataset's
X moved by 4e-16 (each entry up or down, by a seeded sign draw), the gap
the two packages' factorisations start from:

* grid, 24 rows, smooth targets: coordinate 0 picks as JAX; coordinate
  1's pick differs, and JAX's own control moves its pick, and its NLL by
  more than the port's differs from JAX's (three sign draws).
* Nelder-Mead, 100 rows: the first simplex of the jitter-1e-15 task sits
  at the edge of positive definiteness. Which of its Grams factor changes
  under JAX's control (two sign draws); the port's NLL there is +inf or
  above 1e9 (a barely factorable Gram), and the winning NLLs of the
  search lie within its ``fatol`` (1e-6) of JAX's.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from nngparareal_tpu.models.base import Dataset as JDataset
from nngparareal_tpu.models.gp import GParareal as JGP

from nngparareal_torch.models.gp import task_nll
from nngparareal_torch.ops import gp as tgp

from test_torch_gparareal import TOL, _both, _data, _one_torch_thread  # noqa: F401


def _control_fits(X, D, V, N, draws=3, **kw):
    out = []
    for s in range(draws):
        sg = np.random.default_rng(s).choice([-1.0, 1.0], X.shape)
        c = JGP(2, N, **kw)
        c.fit(JDataset(jnp.asarray(X * (1 + 4e-16 * sg)), jnp.asarray(D),
                       jnp.asarray(V)), 1)
        out.append(c)
    return out


def test_grid_pick_near_a_tie_moves_under_jax_control():
    X, D, V = _data(24, 32, rough=False)
    j, t = _both(X, D, V, 12, optimizer="grid")
    # coordinate 0 is not near a tie: the same pick
    np.testing.assert_array_equal(t.thetas[0], j.thetas[0])
    assert t.jitter_sel[0] == j.jitter_sel[0]
    ctl = _control_fits(X, D, V, 12, optimizer="grid")
    # coordinate 1 is: JAX's own control moves its pick, and its NLL by
    # more than the port's differs
    assert any(not np.array_equal(c.thetas[1], j.thetas[1]) for c in ctl)
    ctl_gap = max(abs(c.fvals[1] - j.fvals[1]) for c in ctl)
    assert abs(t.fvals[1] - j.fvals[1]) <= ctl_gap


def test_nm_first_simplex_at_the_factorisation_edge():
    X, D, V = _data(100, 128)
    sim = np.array([[1.0, 1.0], [1.05, 1.0], [1.0, 1.05]])
    pts = np.repeat(sim[None], 18, 0)  # every task's first simplex

    def jax_edge(Xm):
        j = JGP(2, 50)
        obj = jax.jit(j._get_fns(128)[2](jnp.asarray(Xm), jnp.asarray(D),
                                         jnp.asarray(V)))
        f = np.asarray(obj(jnp.asarray(pts))).reshape(2, 9, 3)[:, 5]
        return tuple(np.isfinite(f).ravel())  # the jitter-1e-15 task

    patterns = {jax_edge(X)}
    for s in range(2):
        sg = np.random.default_rng(s).choice([-1.0, 1.0], X.shape)
        patterns.add(jax_edge(X * (1 + 4e-16 * sg)))
    assert len(patterns) >= 2  # the control changes which Grams factor
    # the port's NLL there: finite or not, a Gram barely factorable
    Xt = torch.tensor(X)
    f = task_nll(torch.tensor(pts), tgp.pairwise_sq_dists(Xt, Xt),
                 torch.tensor(D).T.repeat_interleave(9, 0), torch.tensor(V),
                 torch.arange(-20.0, -11.0, dtype=torch.float64).repeat(2))
    f5 = f.reshape(2, 9, 3)[:, 5].numpy()
    assert np.all(~np.isfinite(f5) | (f5 > 1e9))
    # the winners: within fatol of JAX's NLLs
    j, t = _both(X, D, V, 50, fatol=TOL, xatol=TOL)
    assert np.abs(t.fvals - j.fvals).max() <= TOL
