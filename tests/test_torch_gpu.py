"""The CUDA fine fan-out kernel against its plain torch version, on the
card, for every field it has: Burgers and FHN-PDE (one thread per cell),
and the seven ODE fields (one thread per slice). Run on a machine with
one: ``python -m pytest -m gpu -p no:xdist tests/test_torch_gpu.py``.
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
