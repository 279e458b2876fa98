"""Fixed-step RK integration in double-single (f32 pair) arithmetic.

Port of ``nngparareal_tpu/ops/rk_ds.py``. The state is a pair of f32
tensors (hi, lo) carried through the compensated operations of
ops/ds32.py; the field is given in ds form, ``f_ds(t, (uh, ul)) -> (kh,
kl)`` (``ode.get_ds_vector_field()``: lifted by ops/ds_lift.py, or
Burgers' hand-fused ``make_burgers_ds_field``). Time and the step width
stay f64; each step coefficient h*a_ij and h*b_i is formed in f64 and
split into a (hi, lo) pair, as the JAX package does.

``make_batched_last_integrator_ds`` is the plain version of the CUDA ds
fan-out kernel (ops/rk_cuda_ds.py:make_cuda_fanout_ds): the CPU runs and the
tests use it, and on a card it serves ``fine='ds'`` when asked for and
the kernel's check. Batching over slices is a leading batch axis with a
per-slice step width of shape (B, 1). The JAX fan-out's packed and
transposed layouts put the slices in a TPU vector register's 128 lanes;
they change where values sit, not what is computed, and have no
counterpart here, so ``pack=``, ``min_rows=``, ``jit=`` and ``unroll=``
are taken for the JAX package's signature and ignored.
"""

import torch

from nngparareal_torch.ops import ds32
from nngparareal_torch.ops.butcher import get_tableau


def _ds_scalar(x_f64):
    """Split an f64 scalar, or an f64 tensor, into an f32 (hi, lo) pair."""
    if not isinstance(x_f64, torch.Tensor):
        x_f64 = torch.as_tensor(x_f64, dtype=torch.float64)
    return ds32.ds_from_f64(x_f64)


def ds_axpy(uh, ul, ch, cl, kh, kl):
    """(u + c * k) with ds scalar c and ds array k."""
    ph, pl_ = ds32.ds_mul_f32(kh, kl, ch)
    pl_ = pl_ + kh * cl  # cross term of the scalar's low part
    ph, pl_ = ds32.fast_two_sum(ph, pl_)
    return ds32.ds_add(uh, ul, ph, pl_)


def stage_coefficients_ds(tableau, h64):
    """The pairs of a step: for each stage i, (j, pair of h*a_ij) over
    the nonzero a_ij; then (i, pair of h*b_i) over the nonzero b_i; and
    the stage times' offsets c_i*h. ``h64`` is an f64 scalar or (B, 1)
    tensor. The same pairs every step: made once per integration."""
    tab = get_tableau(tableau)
    ha = [[(j, _ds_scalar(h64 * tab.a[i][j])) for j in range(i)
           if tab.a[i][j] != 0.0] for i in range(tab.stages)]
    hb = [(i, _ds_scalar(h64 * bi)) for i, bi in enumerate(tab.b)
          if bi != 0.0]
    ch = [ci * h64 for ci in tab.c]
    return ha, hb, ch


def rk_step_ds(f_ds, tableau, t, uh, ul, h64, coefs=None):
    """One explicit RK step in ds arithmetic; stages unrolled.

    ``t`` and ``h64`` stay f64; all state arithmetic is f32. ``coefs`` is
    ``stage_coefficients_ds(tableau, h64)``, when the caller has it."""
    tab = get_tableau(tableau)
    ha, hb, ch = stage_coefficients_ds(tab, h64) if coefs is None else coefs
    ks = []
    for i in range(tab.stages):
        vh, vl = uh, ul
        for j, (cah, cal) in ha[i]:
            vh, vl = ds_axpy(vh, vl, cah, cal, *ks[j])
        ks.append(f_ds(t + ch[i], (vh, vl)))
    outh, outl = uh, ul
    for i, (cbh, cbl) in hb:
        outh, outl = ds_axpy(outh, outl, cbh, cbl, *ks[i])
    return outh, outl


def integrate_last_ds(f_ds, tableau, t0, dt, steps, u0h, u0l):
    """ds twin of ops/rk.py integrate_last: final state after ``steps``.
    ``t0`` and ``dt`` are f64 scalars, or (B, 1) tensors for a batch."""
    tab = get_tableau(tableau)
    coefs = stage_coefficients_ds(tab, dt)
    uh, ul = u0h, u0l
    for n in range(int(steps)):
        uh, ul = rk_step_ds(f_ds, tab, t0 + n * dt, uh, ul, dt, coefs)
    return uh, ul


def slice_widths(t0s, t1s, steps):
    """Each slice's step width (t1s - t0s) / steps, (B, 1) f64, divided
    as a tensor: torch on a card would multiply by the rounded reciprocal
    of a Python divisor."""
    width = (t1s - t0s)[:, None]
    return width / torch.full_like(width, float(steps))


def integrate_batch_ds(f_ds, tableau, steps, t0s, dts, U, thresh=int(1e7)):
    """``steps`` ds RK steps of B slices from f64 states U (B, d), with
    step widths ``dts`` (B, 1) f64, paged in chunks of ``thresh`` steps;
    returns the f64 end states."""
    tab = get_tableau(tableau)
    steps, thresh = int(steps), int(thresh)
    t0s = t0s[:, None]
    uh, ul = ds32.ds_from_f64(U)
    done = 0
    while done < steps:
        n = min(thresh, steps - done)
        uh, ul = integrate_last_ds(f_ds, tab, t0s + done * dts, dts, n, uh,
                                   ul)
        done += n
    return ds32.ds_to_f64(uh, ul)


def make_batched_last_integrator_ds(f_ds, tableau, steps, thresh=int(1e7),
                                    jit=True, unroll=1, pack=None,
                                    min_rows=1):
    """ds twin of make_batched_last_integrator: ``fan_out(t0s, t1s, U)``.

    U is (B, d) f64, split into f32 pairs, integrated, and recombined:
    callers see the f64 contract of the f64 fan-out. Each slice steps
    with its own width (t1s - t0s) / steps. Above ``thresh`` steps the
    loop is paged (``run.paged``; ``run.warm`` runs one page of each
    size), which in eager torch changes no value. ``jit``, ``unroll``,
    ``pack`` and ``min_rows`` are ignored (see the module's note)."""
    tab = get_tableau(tableau)
    steps, thresh = int(steps), int(thresh)

    def run(t0s, t1s, U):
        return integrate_batch_ds(f_ds, tab, steps, t0s,
                                  slice_widths(t0s, t1s, steps), U, thresh)

    if steps > thresh:
        def warm(t0s, t1s, U):
            dts = slice_widths(t0s, t1s, steps)
            sizes = {thresh}
            if steps % thresh:
                sizes.add(steps % thresh)
            for n in sorted(sizes):
                U = integrate_batch_ds(f_ds, tab, n, t0s, dts, U)
            return U

        run.paged = True
        run.warm = warm
    return run


# --- ds vector fields for the hot systems -------------------------------


def _ds_scale(xh, xl, c_f64):
    """Multiply a ds array by an f64 Python-float constant, split on the
    host."""
    ch, cl = ds32._ds_const(c_f64)
    ph, pl_ = ds32.ds_mul_f32(xh, xl, ch)
    pl_ = pl_ + xh * cl
    return ds32.fast_two_sum(ph, pl_)


def make_burgers_ds_field(ode):
    """ds twin of Burgers._f_norm11 (systems/pdes.py): periodic 3-point
    stencils via roll, f(v) = c2*(vp - 2v + vm) - (v+1)*c1*(vp - vm), in
    the JAX package's order of operations (csrc/ds_fanout.cu's
    BurgersDs repeats it)."""
    c2 = float(ode._inv_h2)
    c1 = float(0.5 * ode._inv_2h)

    def f_ds(t, v):
        vh, vl = v
        vph, vpl = torch.roll(vh, -1, dims=-1), torch.roll(vl, -1, dims=-1)
        vmh, vml = torch.roll(vh, 1, dims=-1), torch.roll(vl, 1, dims=-1)
        # v_xx = (vp - 2v + vm) * c2
        sh, sl = ds32.ds_add(vph, vpl, vmh, vml)
        th_, tl_ = ds32.ds_mul_f32(vh, vl, -2.0)
        sh, sl = ds32.ds_add(sh, sl, th_, tl_)
        xx_h, xx_l = _ds_scale(sh, sl, c2)
        # v_x = (vp - vm) * c1
        dh, dl = ds32.ds_sub(vph, vpl, vmh, vml)
        x_h, x_l = _ds_scale(dh, dl, c1)
        # (v + 1) * v_x
        wh, wl = ds32.ds_add_f32(vh, vl, 1.0)
        ph, pl_ = ds32.ds_mul(wh, wl, x_h, x_l)
        return ds32.ds_sub(xx_h, xx_l, ph, pl_)

    return f_ds
