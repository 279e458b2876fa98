"""Batched lockstep Nelder-Mead and a dense grid argmin.

Port of ``nngparareal_tpu/ops/optim.py``. B independent simplex searches
advance together: every iteration scores all candidate points of all
simplexes (reflection, expansion, both contractions, then the D shrink
points) in one batched objective call. NaN scores count as +inf, the
simplex is sorted stably (ties of +inf keep their order), convergence is
scipy's simultaneous fatol/xatol test per simplex, and a converged simplex
is frozen: it never moves again, so further iterations leave it bitwise as
it was.

Freezing is what lets ``nelder_mead_fixed`` stop early. The JAX package
always runs its ``iters`` iterations (a ``fori_loop``); the port checks on
the host, every ``check_every`` iterations, whether every simplex has
frozen, and stops there, never past ``iters``. The result is bitwise that
of the full loop. ``NelderMeadGraphs`` runs the same iterations on a CUDA
card as captured CUDA graphs (one for the initial simplex, one for a block
of iterations), replayed until every simplex has frozen.
"""

import torch

RHO, CHI, PSI, SIGMA = 1.0, 2.0, 0.5, 0.5


def _init_simplex(x0):
    """scipy-style initial simplex: perturb each coordinate by 5% (or
    2.5e-4 if it is zero). x0: (B, D) -> (B, D+1, D)."""
    B, D = x0.shape
    sim = x0[:, None, :].expand(B, D + 1, D).clone()
    eye = torch.eye(D, dtype=x0.dtype, device=x0.device)
    pert = torch.where(x0 == 0.0, 2.5e-4, 0.05 * x0)  # (B, D)
    sim[:, 1:, :] += pert[:, :, None] * eye[None, :, :]
    return sim


def _evaluate(obj_fn, pts):
    f = obj_fn(pts)
    return torch.where(torch.isnan(f), torch.inf, f)


def _sort_simplex(sim, fvals):
    order = torch.argsort(fvals, dim=1, stable=True)
    sim = torch.gather(sim, 1, order[:, :, None].expand(sim.shape))
    return sim, torch.gather(fvals, 1, order)


def _converged(sim, fvals, fatol, xatol):
    x_spread = torch.amax(torch.abs(sim[:, 1:, :] - sim[:, :1, :]),
                          dim=(1, 2))
    f_spread = torch.amax(torch.abs(fvals[:, 1:] - fvals[:, :1]), dim=1)
    return (x_spread <= xatol) & (f_spread <= fatol)


def nm_start(obj_fn, x0, fatol, xatol):
    """The sorted initial simplexes, their scores and which have already
    converged: (sim (B, D+1, D), fvals (B, D+1), done (B,))."""
    sim = _init_simplex(x0)
    sim, fvals = _sort_simplex(sim, _evaluate(obj_fn, sim))
    return sim, fvals, _converged(sim, fvals, fatol, xatol)


def nm_step(obj_fn, sim, fvals, done, fatol, xatol):
    """One lockstep iteration over all B simplexes; frozen ones (``done``)
    come back unchanged. Returns (sim, fvals, done)."""
    best = sim[:, 0, :]
    worst = sim[:, -1, :]
    f0 = fvals[:, 0]
    fsw = fvals[:, -2]
    fw = fvals[:, -1]
    xbar = torch.mean(sim[:, :-1, :], dim=1)

    xr = (1 + RHO) * xbar - RHO * worst
    xe = (1 + RHO * CHI) * xbar - RHO * CHI * worst
    xc = (1 + PSI * RHO) * xbar - PSI * RHO * worst
    xcc = (1 - PSI) * xbar + PSI * worst
    shrunk = best[:, None, :] + SIGMA * (sim[:, 1:, :] - best[:, None, :])

    cands = torch.cat([xr[:, None], xe[:, None], xc[:, None], xcc[:, None],
                       shrunk], dim=1)  # (B, 4+D, D)
    fcands = _evaluate(obj_fn, cands)
    fxr, fxe, fxc, fxcc = (fcands[:, 0], fcands[:, 1], fcands[:, 2],
                           fcands[:, 3])
    f_shrunk = fcands[:, 4:]

    # reflection / expansion
    take_xe = (fxr < f0) & (fxe < fxr)
    cand_refl = torch.where(take_xe[:, None], xe, xr)
    f_refl = torch.where(take_xe, fxe, fxr)
    accept_refl = fxr < fsw

    # contraction
    outside = fxr < fw
    cand_con = torch.where(outside[:, None], xc, xcc)
    f_con = torch.where(outside, fxc, fxcc)
    con_ok = torch.where(outside, fxc <= fxr, fxcc < fw)

    do_shrink = ~accept_refl & ~con_ok
    new_pt = torch.where(accept_refl[:, None], cand_refl, cand_con)
    f_new = torch.where(accept_refl, f_refl, f_con)

    sim_replace = torch.cat([sim[:, :-1, :], new_pt[:, None, :]], dim=1)
    f_replace = torch.cat([fvals[:, :-1], f_new[:, None]], dim=1)
    sim_shrink = torch.cat([sim[:, :1, :], shrunk], dim=1)
    f_shrink = torch.cat([fvals[:, :1], f_shrunk], dim=1)

    sim_next = torch.where(do_shrink[:, None, None], sim_shrink, sim_replace)
    f_next = torch.where(do_shrink[:, None], f_shrink, f_replace)
    sim_next, f_next = _sort_simplex(sim_next, f_next)

    # freeze converged simplexes (scipy would have returned already)
    sim_out = torch.where(done[:, None, None], sim, sim_next)
    f_out = torch.where(done[:, None], fvals, f_next)
    return sim_out, f_out, done | _converged(sim_out, f_out, fatol, xatol)


def nelder_mead(obj_fn, x0, max_iters=200, fatol=1e-4, xatol=1e-4):
    """Minimise obj_fn over B independent simplexes, until every simplex
    has converged or ``max_iters`` iterations (the host checks after each
    iteration, as the JAX package's ``while_loop`` does on the device).

    obj_fn: (B, C, D) -> (B, C) batched objective; NaNs count as +inf.
    x0:     (B, D) initial points.
    Returns (x_best (B, D), f_best (B,), iters_used (int)).
    """
    sim, fvals, done = nm_start(obj_fn, x0, fatol, xatol)
    it = 0
    while it < max_iters and not bool(torch.all(done)):
        sim, fvals, done = nm_step(obj_fn, sim, fvals, done, fatol, xatol)
        it += 1
    return sim[:, 0, :], fvals[:, 0], it


def grid_search(obj_fn, grid):
    """Dense argmin over a candidate grid, per task.

    obj_fn: (B, G, D) -> (B, G); grid: (B, G, D).
    Returns (x_best (B, D), f_best (B,)); the first of equal minima wins.
    """
    f = _evaluate(obj_fn, grid)
    i = torch.argmin(f, dim=1)
    x_best = torch.gather(grid, 1, i[:, None, None].expand(-1, 1,
                                                            grid.shape[2]))
    return x_best[:, 0, :], torch.gather(f, 1, i[:, None])[:, 0]


def nelder_mead_fixed(obj_fn, x0, iters=40, fatol=0.0, xatol=0.0,
                      check_every=1, stats=None):
    """Fixed-iteration batched Nelder-Mead: ``nelder_mead``'s algorithm
    for ``iters`` iterations, converged simplexes frozen in place.

    With ``check_every`` = c > 0 the host looks after every c iterations
    whether every simplex has frozen, and stops there: frozen simplexes
    never move, so the result is bitwise that of all ``iters`` iterations.
    ``check_every=0`` runs them all, as the JAX package does. A dict
    ``stats`` receives the iterations run (``"run"``).
    Returns (x_best (B, D), f_best (B,)).
    """
    sim, fvals, done = nm_start(obj_fn, x0, fatol, xatol)
    it = 0
    while it < iters:
        if check_every and it % check_every == 0 and bool(torch.all(done)):
            break
        sim, fvals, done = nm_step(obj_fn, sim, fvals, done, fatol, xatol)
        it += 1
    if stats is not None:
        stats["run"] = it
    return sim[:, 0, :], fvals[:, 0]


class NelderMeadGraphs:
    """``nelder_mead_fixed`` for one objective and one set of shapes, as
    CUDA graphs.

    ``obj_fn(pts, *data)`` scores (B, C, D) points against the data
    tensors; it must queue device work only: no tensor built from host
    values and nothing read back. Two graphs are captured at the first
    call: the initial simplex, and ``block`` iterations. ``run`` copies
    its data and starting points into the graphs' input buffers, replays
    the first graph, then the second until every simplex has frozen (read
    on the host after each replay) or ``iters`` iterations have run; a
    last partial block has its own graph. A capture that fails raises:
    nothing falls back to eager launches. The values are bitwise those of
    ``nelder_mead_fixed`` run eagerly on the same card.

    ``live`` counts, on the device, the iterations in which some simplex
    had not converged yet: the iterations a search that stops exactly at
    convergence would take (the JAX package's ``nelder_mead``).
    """

    def __init__(self, obj_fn, data_like, B, D, iters, fatol, xatol,
                 block=8):
        self.obj_fn = obj_fn
        self.iters = int(iters)
        self.fatol, self.xatol = fatol, xatol
        self.block = max(1, min(int(block), self.iters))
        dev = data_like[0].device
        self.data = [torch.empty_like(d) for d in data_like]
        self.x0 = torch.zeros((B, D), dtype=data_like[0].dtype, device=dev)
        self.sim = torch.empty((B, D + 1, D), dtype=self.x0.dtype,
                               device=dev)
        self.fvals = torch.empty((B, D + 1), dtype=self.x0.dtype, device=dev)
        self.done = torch.zeros(B, dtype=torch.bool, device=dev)
        self.live = torch.zeros((), dtype=torch.int64, device=dev)
        self.last = None
        self._graphs = {}

    def _obj(self, pts):
        return self.obj_fn(pts, *self.data)

    def _start(self):
        sim, fvals, done = nm_start(self._obj, self.x0, self.fatol,
                                    self.xatol)
        self.sim.copy_(sim)
        self.fvals.copy_(fvals)
        self.done.copy_(done)
        self.live.zero_()

    def _steps(self, n):
        sim, fvals, done = self.sim, self.fvals, self.done
        for _ in range(n):
            self.live += ~torch.all(done)
            sim, fvals, done = nm_step(self._obj, sim, fvals, done,
                                       self.fatol, self.xatol)
        self.sim.copy_(sim)
        self.fvals.copy_(fvals)
        self.done.copy_(done)

    def _graph(self, key, fn):
        g = self._graphs.get(key)
        if g is None:
            # warm the ops once on a side stream (the inputs hold whatever
            # the first run copied in), then capture
            side = torch.cuda.Stream(device=self.x0.device)
            side.wait_stream(torch.cuda.current_stream(self.x0.device))
            state = [t.clone() for t in (self.sim, self.fvals, self.done,
                                         self.live)]
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(self.x0.device).wait_stream(side)
            for t, s in zip((self.sim, self.fvals, self.done, self.live),
                            state):
                t.copy_(s)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            self._graphs[key] = g
        return g

    def run(self, x0, *data):
        """Returns (x_best (B, D), f_best (B,)), copies; ``last`` then
        holds the search's iterations until convergence (``live``), the
        iterations run and the replays."""
        for buf, d in zip(self.data, data):
            buf.copy_(d)
        self.x0.copy_(x0)
        self._graph("start", self._start).replay()
        done_iters = replays = 0
        while done_iters < self.iters and not bool(torch.all(self.done)):
            n = min(self.block, self.iters - done_iters)
            self._graph(n, lambda: self._steps(n)).replay()
            done_iters += n
            replays += 1
        self.last = {"live": int(self.live), "run": done_iters,
                     "replays": replays}
        return self.sim[:, 0, :].clone(), self.fvals[:, 0].clone()
