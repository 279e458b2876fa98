"""Port parity: the batched lockstep Nelder-Mead and the grid argmin
(``nngparareal_torch/ops/optim.py``) against the JAX package's
(``nngparareal_tpu/ops/optim.py``) on the same objectives and starts.

The objectives are low-degree polynomials, which XLA may evaluate with
fused multiply-adds: the two packages' scores can differ in the last bit,
so a simplex may take a different step at a near tie. The minima agree
within 1e-8 (the tolerances of the searches are 1e-10); where no
objective value is rounded differently (the +inf regions, the grid) the
results are equal.

The port's ``nelder_mead_fixed`` stops once every simplex has frozen,
checked every ``check_every`` iterations; its result is bitwise that of
all its iterations (``check_every=0``), for every check interval.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nngparareal_tpu.ops import optim as jopt
from nngparareal_torch.ops import optim as topt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several pytest-xdist workers whose idle OpenMP threads would spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-8


def _quad(xp):
    def f(pts):  # (B, C, 2) -> (B, C): offset bowls, one per task
        offs = xp.arange(pts.shape[0], dtype=pts.dtype)[:, None]
        return (pts[..., 0] - offs) ** 2 + 2.0 * (pts[..., 1] + offs) ** 2
    return f


def _rosen(xp):
    def f(pts):
        x, y = pts[..., 0], pts[..., 1]
        return (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2
    return f


def _walled(xp):
    """+inf for x < 0 (a failed factorisation's score), a bowl at (1, 0)
    elsewhere."""
    def f(pts):
        v = (pts[..., 0] - 1.0) ** 2 + pts[..., 1] ** 2
        return xp.where(pts[..., 0] < 0, xp.inf, v)
    return f


def _nan_hole(xp):
    """NaN inside the unit disc around (2, 2) (counted as +inf), a bowl at
    (-1, 0.5) elsewhere."""
    def f(pts):
        x, y = pts[..., 0], pts[..., 1]
        v = (x + 1.0) ** 2 + (y - 0.5) ** 2
        hole = (x - 2.0) ** 2 + (y - 2.0) ** 2 < 1.0
        return xp.where(hole, xp.nan, v)
    return f


OBJECTIVES = {"quadratics": _quad, "rosenbrock": _rosen, "inf": _walled,
              "nan": _nan_hole}


def _starts(name, B=6, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-3.0, 3.0, (B, 2))
    if name == "inf":
        # both a start on the +inf side and one whose simplex straddles it
        x0[0] = [-1.0, 2.0]
        x0[1] = [0.0, 1.0]
    if name == "nan":
        x0[0] = [2.0, 2.5]  # starts inside the NaN hole
    x0[-1] = [0.0, 0.0]  # the zero-coordinate perturbation (2.5e-4)
    return x0


def _feasible_starts(name, B=6, seed=0):
    """Starts whose simplexes all leave the +inf and NaN regions: a simplex
    wholly inside one never moves (in both packages), nor converges."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-3.0, 3.0, (B, 2))
    if name == "inf":
        x0[:, 0] = rng.uniform(0.2, 3.0, B)
    if name == "nan":
        x0[:, 0] = rng.uniform(-3.0, 0.5, B)
    x0[-1] = [0.0, 0.0]
    return x0


def _both(name, x0):
    return (OBJECTIVES[name](jnp), jnp.asarray(x0),
            OBJECTIVES[name](torch), torch.as_tensor(x0))


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_nelder_mead_matches_jax(name):
    fj, xj, ft, xt = _both(name, _starts(name))
    x_j, f_j, it_j = jopt.nelder_mead(fj, xj, max_iters=400, fatol=1e-10,
                                      xatol=1e-10)
    x_t, f_t, it_t = topt.nelder_mead(ft, xt, max_iters=400, fatol=1e-10,
                                      xatol=1e-10)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=ATOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)
    assert it_t == int(it_j)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_nelder_mead_fixed_matches_jax(name):
    fj, xj, ft, xt = _both(name, _starts(name, seed=1))
    x_j, f_j = jopt.nelder_mead_fixed(fj, xj, iters=200, fatol=1e-10,
                                      xatol=1e-10)
    x_t, f_t = topt.nelder_mead_fixed(ft, xt, iters=200, fatol=1e-10,
                                      xatol=1e-10)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=ATOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)


def test_known_minima():
    """The searches find the bowls' minima: quadratics at (b, -b), the
    walled bowl at (1, 0), the holed bowl at (-1, 0.5)."""
    for name, want in (("quadratics", [[b, -b] for b in range(6)]),
                       ("inf", [[1.0, 0.0]] * 6), ("nan", [[-1.0, 0.5]] * 6)):
        _, _, ft, xt = _both(name, _feasible_starts(name))
        x_t, _, _ = topt.nelder_mead(ft, xt, max_iters=400, fatol=1e-12,
                                     xatol=1e-12)
        np.testing.assert_allclose(x_t.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_early_stop_is_bitwise_the_full_run(name, check_every):
    """Loose tolerances make most simplexes freeze early; stopping when
    all have frozen gives the full 200 iterations' result bitwise."""
    _, _, ft, xt = _both(name, _feasible_starts(name, B=16, seed=2))
    stats = {}
    full = topt.nelder_mead_fixed(ft, xt, iters=200, fatol=1e-3, xatol=1e-3,
                                  check_every=0, stats=stats)
    assert stats["run"] == 200
    early = topt.nelder_mead_fixed(ft, xt, iters=200, fatol=1e-3,
                                   xatol=1e-3, check_every=check_every,
                                   stats=stats)
    assert stats["run"] < 200
    for a, b in zip(early, full):
        assert torch.equal(a, b)


def test_the_sort_keeps_the_order_of_infinite_scores():
    """Two +inf vertices keep their order (a stable sort), as in JAX: the
    simplex after one step from a start with two infeasible vertices."""
    x0 = np.array([[-0.5, 1.0], [-2.0, 0.0]])
    fj, xj, ft, xt = _both("inf", x0)
    sim_t, f_t, _ = topt.nm_start(ft, xt, 1e-10, 1e-10)
    assert torch.isinf(f_t).sum() >= 4
    x_j, f_j = jopt.nelder_mead_fixed(fj, xj, iters=1, fatol=1e-10,
                                      xatol=1e-10)
    x_t, f_t = topt.nelder_mead_fixed(ft, xt, iters=1, fatol=1e-10,
                                      xatol=1e-10)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def test_init_simplex_matches_jax():
    x0 = np.array([[0.0, -3.0], [2.5, 0.0], [-8.0, -1.0]])
    np.testing.assert_array_equal(
        topt._init_simplex(torch.as_tensor(x0)).numpy(),
        np.asarray(jopt._init_simplex(jnp.asarray(x0))))


def test_grid_search_matches_jax():
    g = np.mgrid[-2:2:41j, -2:2:41j].reshape(2, -1).T
    grid = np.stack([g, g + 0.25, g[::-1]])  # three tasks
    offs = np.array([0.5, -1.0, 0.0])

    def obj(xp, o):
        def f(pts):
            v = (pts[..., 0] - o[:, None]) ** 2 + (pts[..., 1] + 1.0) ** 2
            # a NaN score and exact ties: the first minimum wins
            v = xp.where(pts[..., 0] > 1.9, xp.nan, v)
            return xp.where(pts[..., 1] < -1.5, 0.25, v)
        return f

    x_j, f_j = jopt.grid_search(obj(jnp, jnp.asarray(offs)),
                                jnp.asarray(grid))
    x_t, f_t = topt.grid_search(obj(torch, torch.as_tensor(offs)),
                                torch.as_tensor(grid))
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
