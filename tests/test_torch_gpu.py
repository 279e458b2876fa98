"""The CUDA fine fan-out kernel against its plain torch version, on the
card, for every field it has: Burgers and FHN-PDE (one thread per cell),
and the seven ODE fields (one thread per slice); the latency probe, the
refusal of a tableau the kernels are not compiled for, and each instance's
registers; and the nnGP's Nelder-Mead search as CUDA graphs: its replay
bitwise the eager search and the full 200-iteration loop, a capture that
reads back raising, the lane-major sums as FMAs, bitwise the CPU's, and a
candidate's NLL independent of the lanes beside it; GParareal's search
replayed bitwise its eager run, its fit against the CPU's, cuSOLVER's
failed factor mapped to NaN, and the f32 blocked factor against f64; the
comparison models and variants against the port on the CPU: kNN-mean
bitwise, the ELM within the CPU's control, the neighbour strategies'
indices exactly, ``loo_lanes`` and the LU posterior, and one NNGPTime
prediction from graphs bitwise its eager run; ``build_cont_traj`` on the
card against its one-slice trajectories, the plain fan-out and the
kernel; the double-single kernel bitwise its plain version for every
field, and the 'pallas' mode launching it. Run on a machine with one:
``python -m pytest -m gpu -p no:xdist tests/test_torch_gpu.py``.
Without a card every test here skips.

Whether a card exists is decided inside each test (never at import or in a
``skipif``), so every pytest-xdist worker collects the same tests.

Tolerance: rtol 1e-12 of max|U| after 200 steps. In the per-cell kernel
nvcc contracts a*b+c into FMAs, the plain version does not: the two differ
by rounding only. The per-slice kernel rounds op by op in the plain
version's order, so the ODE fields without sin or cos are held bitwise as
well, against the plain version run on the CPU: on the card, torch
divides a tensor by a Python scalar as a product with the scalar's
reciprocal (the per-slice step h = (t1 - t0) / steps among them), which
rounds otherwise than the CPU's division and the kernel's.
"""

import numpy as np
import pytest
import torch

import nngparareal_torch as nt
from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.ops.rk import integrate_last, make_batched_last_integrator

pytestmark = pytest.mark.gpu
RTOL = 1e-12


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(B, d, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    ode = nt.Burgers(d_x=d, normalization="-11", device=dev)
    U = ode.get_init_cond()[None, :] + 0.05 * (
        torch.rand((B, d), generator=g, dtype=torch.float64).to(dev) - 0.5)
    t0 = torch.rand(B, generator=g, dtype=torch.float64).to(dev)
    # unequal widths: each slice takes its own step
    t1 = t0 + 0.046 * (1.0 + 0.1 * torch.rand(B, generator=g,
                                               dtype=torch.float64).to(dev))
    return ode, t0, t1, U.contiguous()


def _fhn_pde_inputs(B, d_x, dev, seed=0):
    """FHN-PDE states around u0, on slices of the configuration's width."""
    rng = np.random.default_rng(seed)
    ode = nt.FHNPDE(d_x=d_x, normalization="-11", device=dev)
    cfg = nt.Config(ode, d_x=d_x).get()
    width = (cfg["tspan"][1] - cfg["tspan"][0]) / cfg["N"]
    d = ode.get_dim()
    U = ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (B, d))
    t0 = rng.uniform(0.0, cfg["tspan"][1] - width, B)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    return ode, as_t(t0), as_t(t0 + width), as_t(U).contiguous()


@pytest.mark.parametrize("tab,B,d,steps", [
    ("RK8", 128, 128, 200),
    ("RK8", 37, 128, 200),
    ("RK4", 5, 64, 100),
    ("RK2", 3, 16, 100),
    ("RK1", 2, 128, 100),
])
def test_kernel_matches_plain(tab, B, d, steps):
    dev = _card()
    ode, t0, t1, U = _inputs(B, d, dev)
    before = rk_cuda.rk_fanout.launches
    got = rk_cuda.rk_fanout(t0, t1, U, tab, steps, ode.get_device_field(),
                            ode.get_vector_field())
    torch.cuda.synchronize()
    assert rk_cuda.rk_fanout.launches == before + 1
    want = make_batched_last_integrator(ode.get_vector_field(), tab, steps)(
        t0, t1, U)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= RTOL, err


@pytest.mark.parametrize("B", [512, 37])
@pytest.mark.parametrize("d_x", [10, 16])
def test_fhn_pde_kernel_matches_plain(B, d_x):
    dev = _card()
    ode, t0, t1, U = _fhn_pde_inputs(B, d_x, dev)
    f = ode.get_vector_field()
    before = rk_cuda.rk_fanout.launches_by_field["fhn_pde"]
    got = rk_cuda.rk_fanout(t0, t1, U, "RK8", 200, ode.get_device_field(), f)
    torch.cuda.synchronize()
    assert rk_cuda.rk_fanout.launches_by_field["fhn_pde"] == before + 1
    want = make_batched_last_integrator(f, "RK8", 200)(t0, t1, U)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= RTOL, err


def test_kernel_rejects_bad_inputs():
    dev = _card()
    ode, t0, t1, U = _inputs(4, 128, dev)
    fld, f = ode.get_device_field(), ode.get_vector_field()
    with pytest.raises(TypeError, match="float64"):
        rk_cuda.rk_fanout(t0, t1, U.float(), "RK8", 5, fld, f)
    with pytest.raises(ValueError, match="contiguous"):
        rk_cuda.rk_fanout(t0, t1, U.t().contiguous().t(), "RK8", 5, fld, f)
    with pytest.raises(ValueError, match="shape"):
        rk_cuda.rk_fanout(t0[:3], t1, U, "RK8", 5, fld, f)
    # a grid of more cells than a block has threads
    big = nt.FHNPDE(d_x=24, normalization="-11", device=dev)
    Ub = big.get_init_cond()[None].expand(2, -1).contiguous()
    with pytest.raises(ValueError, match="threads"):
        rk_cuda.rk_fanout(t0[:2], t1[:2], Ub, "RK8", 5,
                          big.get_device_field(), big.get_vector_field())


def test_solver_auto_uses_kernel_on_card():
    dev = _card()
    ode, t0, t1, U = _inputs(6, 128, dev)
    s = nt.RKSolver(ode.get_vector_field(), 4, 50, G="RK1", F="RK8",
                    device_field=ode.get_device_field(), device=dev)
    assert s.fine == "cuda"
    before = rk_cuda.rk_fanout.launches
    got = s.run_F_batch(t0, t1, U)
    assert rk_cuda.rk_fanout.launches == before + 1
    want = make_batched_last_integrator(ode.get_vector_field(), "RK8", 50)(
        t0, t1, U)
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    fhn = nt.FHNODE(normalization="-11", device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nt.RKSolver(fhn.get_vector_field(), 4, 8, device=dev)
    pde = nt.FHNPDE(d_x=10, normalization="-11", device=dev)
    s = nt.RKSolver(pde.get_vector_field(), 3, 50, G="RK2", F="RK8",
                    device_field=pde.get_device_field(), device=dev)
    assert s.fine == "cuda"


ODES = {  # system: (Config's N, the tableaus its Table-2 path launches)
    "FHNODE": (None, ("RK2", "RK4")),
    "Rossler": (None, ("RK1", "RK4")),
    "Hopf": (32, ("RK1", "RK8")),
    "DblPend": (None, ("RK1", "RK8")),
    "Brusselator": (None, ("RK4",)),
    "Lorenz": (None, ("RK4",)),
    "ThomasLabyrinth": (32, ("RK1", "RK4")),
}
POLYNOMIAL = ("FHNODE", "Rossler", "Hopf", "Brusselator", "Lorenz")


def _ode_inputs(name, B, dev, seed=0):
    """States around the system's u0, on slices of its configuration's
    width."""
    N, _ = ODES[name]
    rng = np.random.default_rng(seed)
    ode = getattr(nt, name)(normalization="-11", device=dev)
    cfg = nt.Config(ode, N=N).get()
    width = (cfg["tspan"][1] - cfg["tspan"][0]) / cfg["N"]
    U = ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (B, ode.get_dim()))
    t0 = rng.uniform(cfg["tspan"][0], cfg["tspan"][1] - width, B)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    return ode, cfg, as_t(t0), as_t(t0 + width), as_t(U).contiguous()


@pytest.mark.parametrize("B", [1, 37, "N", 512])
@pytest.mark.parametrize("tab", ["RK1", "RK2", "RK4", "RK8"])
@pytest.mark.parametrize("name", sorted(ODES))
def test_ode_kernel_matches_plain(name, tab, B):
    dev = _card()
    if B == "N":
        B = nt.Config(getattr(nt, name)(normalization="-11", device=dev),
                      N=ODES[name][0]).get()["N"]
    ode, _, t0, t1, U = _ode_inputs(name, B, dev)
    fld, f = ode.get_device_field(), ode.get_vector_field()
    before = rk_cuda.rk_fanout.launches_by_field[fld.name]
    got = rk_cuda.rk_fanout(t0, t1, U, tab, 200, fld, f)
    torch.cuda.synchronize()
    assert rk_cuda.rk_fanout.launches_by_field[fld.name] == before + 1
    plain = make_batched_last_integrator(f, tab, 200)
    want = plain(t0, t1, U)
    assert torch.isfinite(want).all()
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= RTOL, err
    if name in POLYNOMIAL:
        f_cpu = getattr(nt, name)(normalization="-11",
                                  device="cpu").get_vector_field()
        cpu = make_batched_last_integrator(f_cpu, tab, 200)(
            t0.cpu(), t1.cpu(), U.cpu())
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("name", sorted(ODES))
def test_ode_coarse_solves_launch_the_kernel(name):
    """On the card an ODE solver's coarse solves are the kernel at B=1,
    with the coarse tableau, one launch per solve."""
    dev = _card()
    ode, cfg, _, _, U = _ode_inputs(name, 1, dev)
    fld, f = ode.get_device_field(), ode.get_vector_field()
    s = nt.RKSolver(f, cfg["Ng"], 50, G=cfg["G"], F=cfg["F"],
                    device_field=fld, device=dev)
    assert s.fine == "cuda" and s.coarse_kernel
    dt_slice = (cfg["tspan"][1] - cfg["tspan"][0]) / cfg["N"]
    before = rk_cuda.rk_fanout.launches_by_field[fld.name]
    got = s.coarse_step_raw(3.0, dt_slice, U[0])
    assert rk_cuda.rk_fanout.launches_by_field[fld.name] == before + 1
    want = integrate_last(f, cfg["G"], 3.0, dt_slice / cfg["Ng"], cfg["Ng"],
                          U[0])
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    t = np.linspace(0.0, 4 * dt_slice, 5)
    chain = s.run_G_chain(t, U[0])
    assert rk_cuda.rk_fanout.launches_by_field[fld.name] == before + 5
    assert chain.shape == (5, ode.get_dim())
    assert torch.equal(chain[1], got)


@pytest.mark.parametrize("kind,threads", [
    ("add", 1), ("mul", 1), ("fma", 1), ("div", 1), ("sin", 1),
    ("sync", 128), ("sync", 256), ("add_f32", 1), ("mul_f32", 1),
    ("div_f32", 1), ("fma_f32", 1),
])
def test_latency_probe_gives_finite_positive_cycles(kind, threads):
    dev = _card()
    before = rk_cuda.rk_fanout.launches
    cycles, ms = rk_cuda.latency_probe(kind, n=1 << 14, threads=threads,
                                       device=dev)
    assert np.isfinite(cycles) and cycles > 0
    assert np.isfinite(ms) and ms > 0
    assert rk_cuda.rk_fanout.launches == before  # not a fan-out launch


def test_kernel_refuses_a_tableau_it_is_not_compiled_for():
    """A tableau named as a compiled one but with other coefficients, or
    with a name the kernel has no instance for, raises on the card before
    any launch."""
    from nngparareal_torch.ops.butcher import Tableau, get_tableau

    dev = _card()
    rk4 = get_tableau("RK4")
    other = Tableau("RK4", rk4.a, (0.25, 0.25, 0.25, 0.25), rk4.c, 4)
    unknown = Tableau("RK3", rk4.a, rk4.b, rk4.c, 4)
    ode, t0, t1, U = _inputs(4, 128, dev)
    fhn = nt.FHNODE(normalization="-11", device=dev)
    _, _, t0o, t1o, Uo = _ode_inputs("FHNODE", 4, dev)
    before = rk_cuda.rk_fanout.launches
    for tab in (other, unknown):
        with pytest.raises(ValueError, match="tableau"):
            rk_cuda.rk_fanout(t0, t1, U, tab, 5, ode.get_device_field(),
                              ode.get_vector_field())
        with pytest.raises(ValueError, match="tableau"):
            rk_cuda.rk_fanout(t0o, t1o, Uo, tab, 5, fhn.get_device_field(),
                              fhn.get_vector_field())
    assert rk_cuda.rk_fanout.launches == before


@pytest.mark.parametrize("name", ["Burgers", "FHNPDE", *sorted(ODES)])
def test_kernel_instances_do_not_spill(name):
    """Every instance a system can launch (RK1-RK8, its path's block size)
    has its registers and no local memory, and fits on an SM. The fields
    with sin or cos keep the 40-byte stack frame of CUDA's argument
    reduction for large arguments ("40 bytes cumulative stack size" in
    ptxas' report), whatever the tableau: that is not a spill."""
    dev = _card()
    if name in ("Burgers", "FHNPDE"):
        ode = getattr(nt, name)(d_x=128 if name == "Burgers" else 16,
                                normalization="-11", device=dev)
        B = 128 if name == "Burgers" else 512
    else:
        ode = getattr(nt, name)(normalization="-11", device=dev)
        B = 512
    for tab in ("RK1", "RK2", "RK4", "RK8"):
        attrs = rk_cuda.kernel_attributes(ode.get_device_field(), tab, B,
                                          ode.get_dim(), device=dev)
        assert 0 < attrs["registers"] <= 255, attrs
        assert attrs["local_bytes"] == (
            40 if name in ("DblPend", "ThomasLabyrinth") else 0), attrs
        assert attrs["blocks_per_sm"] >= 1, attrs


# --- the nnGP's Nelder-Mead search as CUDA graphs ---


def _nm_problem(n, m, dev, seed=0):
    """A search's inputs: m neighbours of n coordinates (near-duplicate
    rows included), their defects and the starts the model draws."""
    from nngparareal_torch.models import NNGParareal

    rng = np.random.default_rng(seed)
    mdl = NNGParareal(n=n, N=8, nn=m, seed=seed)
    x = rng.standard_normal((m, n)) * 0.05
    x[1] = x[0] + 1e-9
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    X = as_t(x)
    sqd = ((X[:, None] - X[None]) ** 2).sum(-1)
    ym = as_t(rng.standard_normal((m, n)) * 1e-3)
    mask = torch.ones(m, dtype=torch.float64, device=dev)
    theta0 = as_t(mdl.sweep_aux(0, 8)[0])
    return mdl, sqd, ym, mask, theta0


@pytest.mark.parametrize("n,m", [(2, 15), (3, 14), (4, 15), (128, 18)])
def test_nm_graph_replay_is_bitwise_the_eager_search(n, m):
    """The replayed graphs, the same search with eager launches and the
    full 200-iteration loop give bitwise the same thetas and scores."""
    from nngparareal_torch.models.nngp import _nm_objective
    from nngparareal_torch.ops.optim import nelder_mead_fixed

    dev = _card()
    mdl, sqd, ym, mask, theta0 = _nm_problem(n, m, dev)
    th_g, fv_g = mdl._nm_search(sqd, ym, mask, theta0, graphed=True)
    assert mdl.nm_stats["replays"] > 0
    th_e, fv_e = mdl._nm_search(sqd, ym, mask, theta0, graphed=False)
    data = (sqd, ym.repeat_interleave(mdl.per, 1), mask,
            mdl._task_jitters(sqd.dtype, dev))
    th_f, fv_f = nelder_mead_fixed(lambda p: _nm_objective(p, *data),
                                   theta0, iters=200, fatol=mdl.fatol,
                                   xatol=mdl.xatol, check_every=0)
    for a, b in ((th_g, th_e), (fv_g, fv_e), (th_g, th_f), (fv_g, fv_f)):
        assert torch.equal(a, b)
    # a second search reuses the captured graphs
    mdl._nm_search(sqd, ym, mask, theta0.flip(0), graphed=True)
    assert len(mdl._graphs) == 1


def test_lane_sums_on_card_are_fmas_and_lane_independent():
    """addcmul is a fused multiply-add on the card (bitwise the CPU's, which
    is one too), and a candidate's NLL does not depend on the lanes beside
    it."""
    from nngparareal_torch.ops import gp_lanes

    dev = _card()
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096) for _ in range(3))
    cpu = torch.addcmul(*(torch.as_tensor(v) for v in (c, a, b)))
    card = torch.addcmul(*(torch.as_tensor(v, device=dev)
                           for v in (c, a, b)))
    assert torch.equal(card.cpu(), cpu)
    mdl, sqd, ym, mask, theta0 = _nm_problem(3, 15, dev)
    B = theta0.shape[0]
    jit = mdl._task_jitters(sqd.dtype, dev)
    y = ym.repeat_interleave(mdl.per, 1)[:, None, :]
    batch = gp_lanes.nll_lanes(sqd, y, theta0, jit, mask)
    alone = torch.cat([gp_lanes.nll_lanes(sqd, y[:, :, i:i + 1],
                                          theta0[i:i + 1], jit[i:i + 1],
                                          mask) for i in range(B)], dim=1)
    assert torch.equal(batch, alone)


def _gp_problem(rows, cap, dev, n=3, seed=0):
    """A padded GParareal dataset on the card: rough targets at smooth
    inputs, a masked hole."""
    from nngparareal_torch.models import Dataset

    rng = np.random.default_rng(seed)
    X = np.zeros((cap, n))
    D = np.zeros((cap, n))
    V = np.zeros(cap)
    X[:rows] = rng.uniform(-1, 1, (rows, n))
    D[:rows] = rng.normal(size=(rows, n)) * 1e-3
    V[:rows] = 1.0
    V[3] = 0.0
    return Dataset(*(torch.tensor(a, device=dev) for a in (X, D, V)))


@pytest.mark.parametrize("rows,cap", [(24, 32), (100, 128), (400, 512)])
def test_gp_search_graph_replay_is_bitwise_the_eager_search(rows, cap):
    """GParareal's Nelder-Mead fit replayed from its graphs and run with
    eager launches: bitwise the same winners, on both sides of the 48-row
    switch (the column loop, and cuSOLVER's batched potrf)."""
    from nngparareal_torch.models import GParareal

    dev = _card()
    ds = _gp_problem(rows, cap, dev)
    mdl = GParareal(3, 40, fatol=1e-6, xatol=1e-6, nm_max_iters=64,
                    theta=[0.3, 0.001])
    x0 = torch.as_tensor(np.repeat(mdl.thetas, 9, axis=0), device=dev)
    args = (ds.X, ds.D, ds.valid, x0)
    got = mdl._fit_warm(*args, graphed=True)
    assert mdl.nm_stats["replays"] > 0
    want = mdl._fit_warm(*args, graphed=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.isfinite(got[2]).all()


def test_gp_fit_on_card_matches_cpu():
    """A whole fit on the card against the same fit on the CPU: each
    coordinate's winning NLL within the search's fatol (cuSOLVER and
    LAPACK round otherwise). On these well-conditioned Grams the jitters
    1e-20..1e-12 change the NLL by less than that, so which jitter wins
    is a rounding-level tie (measured on an H100: -19 on the card against
    -20 on the CPU for one coordinate)."""
    from nngparareal_torch.models import Dataset, GParareal

    dev = _card()
    ds = _gp_problem(100, 128, dev)
    fits = []
    for d in (ds, Dataset(ds.X.cpu(), ds.D.cpu(), ds.valid.cpu())):
        m = GParareal(3, 40, fatol=1e-6, xatol=1e-6, theta=[0.3, 0.001])
        m.fit(d, 1)
        fits.append(m)
    card, cpu = fits
    assert np.abs(card.fvals - cpu.fvals).max() <= 1e-6


@pytest.mark.parametrize("M", [64, 512])
def test_cholesky_failure_is_nan_on_card(M):
    """cholesky_ex's failure is an all-NaN factor (as JAX returns one),
    without a read back, and the NLL is +inf; the good matrices of the
    batch are unaffected."""
    from nngparareal_torch.ops import gp as gpops

    dev = _card()
    rng = np.random.default_rng(M)
    X = torch.tensor(rng.uniform(-1, 1, (M, 3)), device=dev)
    sqd = gpops.pairwise_sq_dists(X, X)
    th = torch.tensor([[0.3, 1.0], [0.3, 1.0]], device=dev)
    K = gpops.k_se_linear(sqd, th)
    K[1, M // 2, M // 2] = -1.0
    mask = torch.ones(M, dtype=torch.float64, device=dev)
    jit = torch.full((2,), -6.0, dtype=torch.float64, device=dev)
    Kj = gpops._masked_gram(K, mask, jit)
    L = gpops.cholesky_nan(Kj)
    assert torch.isnan(L[1]).all() and torch.isfinite(L[0]).all()
    y = torch.tensor(rng.normal(size=M), device=dev)
    nll = gpops.gp_nll(K, y, jit, mask)
    assert torch.isfinite(nll[0]) and nll[1] == float("inf")
    ref = gpops.gp_nll(K[0].cpu(), y.cpu(), jit[0].cpu(), mask.cpu())
    assert abs(float(nll[0]) - float(ref)) <= 1e-9 * abs(float(ref))


@pytest.mark.parametrize("M", [300, 512])
def test_f32_blocked_factor_on_card_tracks_f64(M):
    """The blocked IEEE-f32 factorisation on the card against cuSOLVER in
    f64 (cond 1e4: a relative error of about cond x eps32), with TF32
    allowed by the caller: it is not used."""
    from nngparareal_torch.ops.chol_blocked import chol_diag_solve

    dev = _card()
    rng = np.random.default_rng(M)
    Q, _ = np.linalg.qr(rng.normal(size=(M, M)))
    K = (Q * np.logspace(0.0, -4.0, M)) @ Q.T
    y = rng.normal(size=M)
    K64 = torch.tensor(K, device=dev)
    y64 = torch.tensor(y, device=dev)
    L = torch.linalg.cholesky(K64)
    z = torch.linalg.solve_triangular(L, y64[:, None], upper=False)[:, 0]
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")  # TF32 allowed
    try:
        d32, z32 = chol_diag_solve(K64.float(), y64.float())
    finally:
        torch.set_float32_matmul_precision(prev)
    d32, z32 = d32[:M].double(), z32[:M].double()
    assert torch.allclose(d32, torch.diagonal(L), rtol=5e-3)
    assert torch.allclose(z32, z, rtol=2e-2, atol=5e-3 * float(z.abs().max()))


def _padded_dataset(dev, seed=0, cap=64, rows=40, n=3):
    """A padded dataset with masked-out rows and exact duplicates, on
    ``dev``: (Dataset, numpy X)."""
    from nngparareal_torch.models import Dataset

    rng = np.random.default_rng(seed)
    X = np.zeros((cap, n))
    D = np.zeros((cap, n))
    X[:rows] = rng.standard_normal((rows, n))
    D[:rows] = 1e-3 * rng.standard_normal((rows, n))
    X[30:33] = X[12]
    V = np.zeros(cap)
    V[:rows] = 1.0
    V[[5, 21]] = 0.0
    return Dataset(*(torch.tensor(a, device=dev) for a in (X, D, V))), X


def _predict(mdl, ds, q):
    z = torch.zeros_like(q)
    return mdl.predict_fn(ds, q, z, z, 0)


def test_knn_mean_on_card_is_bitwise_the_cpu():
    from nngparareal_torch.models import Dataset, KNNMean

    dev = _card()
    ds, X = _padded_dataset(dev)
    cpu = Dataset(ds.X.cpu(), ds.D.cpu(), ds.valid.cpu())
    for nn in (5, 15, 60):
        mdl = KNNMean(3, 8, nn=nn)
        for q in (X[12], X[5], X[0] + 1e-9):
            q = torch.tensor(q)
            assert torch.equal(_predict(mdl, ds, q.to(dev)).cpu(),
                               _predict(mdl, cpu, q))


def test_elm_on_card_within_the_cpu_control():
    """The ELM's near-singular ridge solve (cuSOLVER on the card, LAPACK
    on the CPU) against the CPU's own control: its dataset's X moved by
    4e-16 (tests/test_torch_knn_elm.py)."""
    from nngparareal_torch.models import ELM, Dataset

    dev = _card()
    ds, X = _padded_dataset(dev, seed=4)
    cpu = Dataset(ds.X.cpu(), ds.D.cpu(), ds.valid.cpu())
    mdl = ELM(3, 8, m=10, res_size=20)
    moved = [Dataset(cpu.X * (1.0 + 4e-16 * torch.tensor(
        np.random.default_rng(s).choice([-1.0, 1.0], X.shape))), cpu.D,
        cpu.valid) for s in range(3)]
    for q in (X[12], X[0] + 1e-3):
        q = torch.tensor(q)
        want = _predict(mdl, cpu, q)
        got = _predict(mdl, ds, q.to(dev)).cpu()
        ctl = max(float((_predict(mdl, m, q) - want).abs().max())
                  for m in moved)
        gap = float((got - want).abs().max())
        assert gap <= 10.0 * max(ctl, 1e-15 * float(want.abs().max()))


@pytest.mark.parametrize("strategy", ["col_only", "col+rnd", "row_col",
                                      "row", "col_full"])
def test_strategy_indices_on_card_are_the_cpu(strategy):
    from nngparareal_torch.models import Dataset, NNGParareal

    dev = _card()
    ds, X = _padded_dataset(dev, cap=64, rows=48, n=2)
    cpu = Dataset(ds.X.cpu(), ds.D.cpu(), ds.valid.cpu())
    rand = np.round(np.random.default_rng(0).random((8, 64)), 1)
    for k in (0, 2, 5):
        mdl = NNGParareal(2, 8, nn=12, optimizer="grid", strategy=strategy)
        mdl.fit(None, k)
        for i in range(8):
            q = torch.tensor(X[i])
            got = mdl._select_neighbors(ds, q.to(dev), 12, i,
                                        {"rand": torch.tensor(rand[i],
                                                              device=dev)})
            want = mdl._select_neighbors(cpu, q, 12, i,
                                         {"rand": torch.tensor(rand[i])})
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)


def test_loo_and_lu_on_card_within_the_cpu_control():
    """loo_lanes (the lane-major factor and solves; exp rounds otherwise on
    the card) and the LU posterior (cuSOLVER's getrf against LAPACK's):
    finite in the same places, and within 10x the CPU's own control, the
    distances moved by 4e-16 (each entry up or down, three draws; ~3e-11
    of the largest LOO score, ~1e-15 of the largest posterior on these
    36 thetas x jitters 1e-12..1e-8)."""
    from nngparareal_torch.ops import gp as gpops
    from nngparareal_torch.ops import gp_lanes

    dev = _card()
    rng = np.random.default_rng(1)
    X = torch.tensor(0.5 * rng.standard_normal((18, 4)))
    sqd = gpops.pairwise_sq_dists(X, X)
    sqd_q = gpops.sq_dists_to(X[0] + 1e-3, X)
    ym = torch.tensor(rng.standard_normal((18, 4)))
    mask = torch.ones(18, dtype=torch.float64)
    mask[11] = 0.0
    g = np.arange(-4.0, 2.0)
    th = torch.tensor(np.stack(np.meshgrid(g, g), -1).reshape(-1, 2))
    th = th.repeat_interleave(3, 0)
    jit = torch.tensor([-12.0, -10.0, -8.0], dtype=torch.float64).repeat(36)
    sel = torch.arange(0, 108, 27)
    moved = [sqd * (1.0 + 4e-16 * torch.tensor(np.random.default_rng(
        s).choice([-1.0, 1.0], sqd.shape))) for s in range(3)]
    for fn, args in (
            (gp_lanes.loo_lanes, lambda d: (d, ym, th, jit, mask)),
            (gp_lanes.posterior_mean_lu,
             lambda d: (d, sqd_q, ym, th[sel], jit[sel], mask))):
        want = fn(*args(sqd))
        got = fn(*(a.to(dev) for a in args(sqd))).cpu()
        ok = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), ok) and ok.any()
        ctl = max(float((fn(*args(d)) - want)[ok].abs().max())
                  for d in moved)
        assert float((got - want)[ok].abs().max()) <= 10.0 * max(
            ctl, 1e-15 * float(want[ok].abs().max()))


def test_nngp_time_graph_replay_is_bitwise_the_eager_prediction():
    """One NNGPTime prediction with its searches replayed from CUDA graphs
    and with eager launches: bitwise the same, every round."""
    from nngparareal_torch.models import Dataset, NNGPTime

    dev = _card()
    ds, X = _padded_dataset(dev, cap=128, rows=100, n=3)
    preds = []
    for graphed in (True, False):
        mdl = NNGPTime(3, 20, nn=10, reps=2, nn_iters=2, nm_max_iters=40)
        mdl.fit(ds, 4)
        aux = {k: torch.tensor(v[7], device=dev)
               for k, v in mdl.sweep_aux(4, 20, 128).items()}
        search = mdl._search
        mdl._search = lambda x0, data, g=None: search(x0, data, graphed)
        q = ds.X[13] + 1e-3
        preds.append((_predict_i(mdl, ds, q, 7, aux), mdl.nm_stats))
    (g, g_stats), (e, e_stats) = preds
    assert torch.equal(g, e) and torch.isfinite(g).all()
    assert g_stats["replays"] > 0 and e_stats["replays"] == 0
    assert g_stats["iterations"] == e_stats["iterations"]


def _predict_i(mdl, ds, q, i, aux):
    z = torch.zeros_like(q)
    return mdl.predict_fn(ds, q, z, z, i, aux_i=aux)


def test_nm_graph_capture_that_reads_back_raises():
    """An objective that reads a value back cannot be captured: the search
    raises instead of running eagerly. (Last in the file: a failed capture
    may leave the card's stream unusable for the tests after it.)"""
    from nngparareal_torch.ops.optim import NelderMeadGraphs

    dev = _card()
    x0 = torch.zeros((4, 2), dtype=torch.float64, device=dev)

    def obj(pts, shift):
        return ((pts - shift) ** 2).sum(-1) * float(shift.sum())

    shift = torch.ones(2, dtype=torch.float64, device=dev)
    nmg = NelderMeadGraphs(obj, (shift,), 4, 2, iters=16, fatol=1e-3,
                           xatol=1e-3)
    with pytest.raises(RuntimeError):
        nmg.run(x0, shift)


def test_cont_traj_on_card_is_the_plain_fanout():
    """The trajectory API on the card (torch ops, as the JAX package runs
    it as XLA): ``build_cont_traj``'s batched slices equal their one-slice
    trajectories bitwise, start at u[i], and end bitwise where the plain
    fan-out on the card ends (both divide the step width on the card) and
    within RTOL of max|u| of the kernel's fan-out."""
    dev = _card()
    ode = nt.Lorenz(normalization="-11", device=dev)
    cfg = nt.Config(ode).get()
    s = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"] // 10,
                    G=cfg["G"], F=cfg["F"],
                    device_field=ode.get_device_field(), device=dev)
    p = nt.Parareal(ode, s, cfg["tspan"], cfg["N"], verbose=None, device=dev)
    N, nf = p.N, s.Nf
    rng = np.random.default_rng(5)
    u = ode.u0[None, :] + 0.1 * rng.standard_normal((N + 1, ode.get_dim()))
    t = np.linspace(cfg["tspan"][0], cfg["tspan"][1], N + 1)
    traj = p.build_cont_traj({"t": t, "u": u})
    rows = traj.reshape(N, nf + 1, -1)
    np.testing.assert_array_equal(rows[:, 0], u[:-1])
    for i in (0, N // 2, N - 1):
        np.testing.assert_array_equal(
            rows[i], s.run_F_full(t[i], t[i + 1], u[i]).cpu().numpy())
    plain = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], nf, G=cfg["G"],
                        F=cfg["F"], fine="torch", device=dev)
    np.testing.assert_array_equal(
        rows[:, -1], plain.run_F_batch(t[:-1], t[1:], u[:-1]).cpu().numpy())
    kernel = s.run_F_batch(t[:-1], t[1:], u[:-1]).cpu().numpy()
    assert np.abs(rows[:, -1] - kernel).max() <= RTOL * np.abs(u).max()


DS_SYSTEMS = [("Burgers", {"d_x": 64}), ("FHNPDE", {"d_x": 8})] + [
    (name, {}) for name in sorted(ODES)]


@pytest.mark.parametrize("tab", ["RK4", "RK8"])
@pytest.mark.parametrize("name,kw", DS_SYSTEMS,
                         ids=[s[0] for s in DS_SYSTEMS])
def test_ds_kernel_is_bitwise_its_plain_version(name, kw, tab):
    """The double-single kernel (csrc/ds_fanout.cu) against its plain torch
    version on the card, 10 steps at B=5: bitwise, since every ds
    operation is rounded alone in the plain version's order; one launch,
    counted under the field's ds key; near the f64 kernel."""
    from nngparareal_torch.ops import rk_cuda_ds

    dev = _card()
    ode = getattr(nt, name)(normalization="-11", device=dev, **kw)
    fld, f_ds = ode.get_device_field(), ode.get_ds_vector_field()
    rng = np.random.default_rng(0)
    U = torch.as_tensor(ode.u0[None, :] + 0.05 * rng.uniform(
        -1.0, 1.0, (5, ode.get_dim())), dtype=torch.float64, device=dev)
    before = rk_cuda.rk_fanout.launches_by_field[f"{fld.name}_ds"]
    got = rk_cuda_ds.ds_fanout(U, tab, 10, 1e-3, fld, f_ds)
    torch.cuda.synchronize()
    assert rk_cuda.rk_fanout.launches_by_field[f"{fld.name}_ds"] == before + 1
    want = rk_cuda_ds.plain_fanout_ds(f_ds, tab, 10, U, 1e-3)
    assert torch.equal(got, want)
    t0 = torch.zeros(5, dtype=torch.float64, device=dev)
    f64 = rk_cuda.rk_fanout(t0, t0 + 1e-2, U, tab, 10, fld,
                            ode.get_vector_field())
    assert (got - f64).abs().max().item() <= 1e-12


@pytest.mark.parametrize("name", ["DblPend", "ThomasLabyrinth", "Lorenz"])
def test_ds_kernel_lanes_span_blocks_bitwise(name):
    """The per-slice ds form at B=37: four lanes a slice for DblPend and
    ThomasLabyrinth (148 threads, three blocks, the last warp ragged),
    one for Lorenz; bitwise its plain version at 4 RK4 steps, and the
    instance's block size as csrc/ds_fanout.cu sets it."""
    from nngparareal_torch.ops import rk_cuda_ds

    dev = _card()
    ode = getattr(nt, name)(normalization="-11", device=dev)
    fld, f_ds = ode.get_device_field(), ode.get_ds_vector_field()
    rng = np.random.default_rng(1)
    U = torch.as_tensor(ode.u0[None, :] + 0.05 * rng.uniform(
        -1.0, 1.0, (37, ode.get_dim())), dtype=torch.float64, device=dev)
    got = rk_cuda_ds.ds_fanout(U, "RK4", 4, 1e-2, fld, f_ds)
    want = rk_cuda_ds.plain_fanout_ds(f_ds, "RK4", 4, U, 1e-2)
    assert torch.equal(got, want)
    attrs = rk_cuda_ds.kernel_attributes(fld, "RK4", 37, ode.get_dim())
    assert attrs["threads"] == 64 and attrs["local_bytes"] == 0


def test_pallas_mode_launches_the_ds_kernel():
    dev = _card()
    ode = nt.Lorenz(normalization="-11", device=dev)
    s = nt.RKSolver(ode.get_vector_field(), 4, 50, G="RK1", F="RK4",
                    fine="pallas", fine_ds=ode.get_ds_vector_field(),
                    device_field=ode.get_device_field(), device=dev)
    t = torch.linspace(0.0, 1.0, 9, dtype=torch.float64, device=dev)
    U = ode.get_init_cond().expand(8, -1).contiguous()
    before = dict(rk_cuda.rk_fanout.launches_by_field)
    s.run_F_batch(t[:-1], t[1:], U)
    after = rk_cuda.rk_fanout.launches_by_field
    assert after["lorenz_ds"] == before["lorenz_ds"] + 1
    assert after["lorenz"] == before["lorenz"]
