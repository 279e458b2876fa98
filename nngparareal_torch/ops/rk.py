"""Fixed-step explicit Runge-Kutta integrators in torch f64.

Port of ``nngparareal_tpu/ops/rk.py``. The stage loop is unrolled over the
tableau's nonzero coefficients in the same order as the JAX package, and
the step time is ``t0 + n*dt`` (no accumulation drift). Batching over time
slices is a leading batch axis: ``make_batched_last_integrator`` takes
(B,) slice bounds and a (B, d) state, with a per-slice step ``dt`` of
shape (B, 1).

``make_batched_last_integrator`` is the plain version of the CUDA fine
fan-out kernel (ops/rk_cuda.py): the CPU runs and the tests use it, and on
the card it serves only to check the kernel. The TPU lane-packing layouts
of the JAX fan-out have no counterpart here.

The trajectory functions (``integrate_traj``, ``integrate_traj_times``,
``make_traj_integrator``) keep every step's state; the JAX package runs
them as a ``lax.scan``, and here they are the same steps as torch ops on
any device (no kernel holds a trajectory).

Huge step counts are paged in chunks of ``thresh`` steps, as in the JAX
package; in eager torch paging only splits the loop, it changes no value.
"""

import torch

from nngparareal_torch.ops.butcher import get_tableau


def stage_coefficients(tableau, h):
    """The per-step constants of a tableau at step ``h``: (h*a_ij) for the
    nonzero a_ij of each stage, as (j, value) pairs, and c_i*h. Computed
    once per integration instead of once per step."""
    tab = get_tableau(tableau)
    ha = [[(j, h * tab.a[i][j]) for j in range(i) if tab.a[i][j] != 0.0]
          for i in range(tab.stages)]
    ch = [ci * h for ci in tab.c]
    return ha, ch


def rk_step(f, tableau, t, u, h, coefs=None):
    """One explicit RK step for du/dt = f(t, u); stages unrolled.

    ``coefs`` is ``stage_coefficients(tableau, h)``, when the caller has it.
    """
    tab = get_tableau(tableau)
    ha, ch = stage_coefficients(tab, h) if coefs is None else coefs
    ks = []
    for i in range(tab.stages):
        ui = u
        for j, hc in ha[i]:
            ui = ui + hc * ks[j]
        ks.append(f(t + ch[i], ui))
    acc = None
    for bi, ki in zip(tab.b, ks):
        if bi == 0.0:
            continue
        term = bi * ki
        acc = term if acc is None else acc + term
    return u + h * acc


def integrate_last(f, tableau, t0, dt, steps, u0):
    """Integrate ``steps`` fixed RK steps from (t0, u0); return final state.

    ``t0`` and ``dt`` are scalars, or (B, 1) tensors for a batch of slices.
    """
    tab = get_tableau(tableau)
    coefs = stage_coefficients(tab, dt)
    u = u0
    for n in range(int(steps)):
        u = rk_step(f, tab, t0 + n * dt, u, dt, coefs)
    return u


def integrate_traj(f, tableau, t0, dt, steps, u0):
    """Integrate ``steps`` fixed RK steps from (t0, u0) and return every
    state, (steps+1, d) with row 0 equal to ``u0``; with (B, 1) ``t0`` and
    ``dt`` and a (B, d) ``u0``, (steps+1, B, d)."""
    tab = get_tableau(tableau)
    coefs = stage_coefficients(tab, dt)
    rows = [u0]
    u = u0
    for n in range(int(steps)):
        u = rk_step(f, tab, t0 + n * dt, u, dt, coefs)
        rows.append(u)
    return torch.stack(rows)


def integrate_traj_times(f, tableau, t, u0):
    """The trajectory on an arbitrary (possibly non-uniform) grid ``t``
    (a sequence, an array or a 1-d tensor, read to the host once): one
    step from each t[n] to t[n+1]; (len(t), d) with row 0 equal to
    ``u0``."""
    tab = get_tableau(tableau)
    t = torch.as_tensor(t, dtype=torch.float64).tolist()
    rows = [u0]
    u = u0
    for t_n, t_np1 in zip(t[:-1], t[1:]):
        u = rk_step(f, tab, t_n, u, t_np1 - t_n)
        rows.append(u)
    return torch.stack(rows)


def make_last_integrator(f, tableau, steps, thresh=int(1e7)):
    """Build ``step_fn(t0, t1, u0) -> u(t1)`` doing ``steps`` RK steps,
    paged in chunks of at most ``thresh`` steps."""
    tab = get_tableau(tableau)
    steps = int(steps)
    thresh = int(thresh)
    n_full, rem = divmod(steps, thresh)

    def run(t0, t1, u0):
        dt = (t1 - t0) / steps
        if steps <= thresh:
            return integrate_last(f, tab, t0, dt, steps, u0)
        u = u0
        for i in range(n_full):
            u = integrate_last(f, tab, t0 + (i * thresh) * dt, dt, thresh, u)
        if rem:
            u = integrate_last(f, tab, t0 + (n_full * thresh) * dt, dt, rem, u)
        return u

    return run


def make_traj_integrator(f, tableau, steps):
    """Build ``traj_fn(t0, t1, u0) -> (steps+1, d)``: the trajectory of
    ``steps`` RK steps of width (t1 - t0) / steps (no paging, as in the
    JAX package). Batched as ``integrate_traj`` is."""
    tab = get_tableau(tableau)
    steps = int(steps)

    def run(t0, t1, u0):
        dt = (t1 - t0) / steps
        return integrate_traj(f, tab, t0, dt, steps, u0)

    return run


def make_batched_last_integrator(f, tableau, steps, thresh=int(1e7)):
    """Build ``fan_out(t0s, t1s, U) -> (B, d)``: the parareal fine fan-out.

    t0s, t1s: (B,) slice bounds; U: (B, d) states. Each slice takes
    ``steps`` steps of its own width (t1s - t0s) / steps.
    """
    single = make_last_integrator(f, tableau, steps, thresh)

    def run(t0s, t1s, U):
        return single(t0s[:, None], t1s[:, None], U)

    return run
