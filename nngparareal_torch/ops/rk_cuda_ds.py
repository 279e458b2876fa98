"""Fine fan-out in double-single arithmetic as a hand-written CUDA kernel
(csrc/ds_fanout.cu).

Replaces the Pallas TPU kernel ``nngparareal_tpu/ops/rk_pallas.py``
(``make_pallas_fanout_ds``) in its own arithmetic: B time slices of
fixed-step explicit RK, every step inside one launch, the state held as
(hi, lo) f32 pairs (ops/ds32.py). It serves ``RKSolver(fine='pallas')``.
The card has f64 units, so ``fine='auto'`` never picks it
(solver.py:select_fine_mode); it is there to run the JAX package's
flagship in the TPU's own arithmetic.

``make_cuda_fanout_ds(f_ds, tableau, steps, device_field)`` has the
contract of the Pallas fan-out: ``(t0s, t1s, U) -> (B, d)`` f64. As
there, one step width is taken from slice 0, ``(t1s[0] - t0s[0]) /
steps``: the step coefficients h*a_ij and h*b_i are formed from it in f64
on the host and split into pairs (``step_pairs``, the order of
rk_pallas.py:_coef_layout). Slices of other widths raise ``ValueError``
(rtol 1e-12), and a field that reads its time argument raises
``NotImplementedError`` when the fan-out is built
(``ds_field_is_autonomous``): the kernel forms no stage time.

The kernel has a device form of each field (the device field of
``ode.get_device_field()``, the same one as the f64 kernel's), in the
order of operations of the system's ds field (``ode.
get_ds_vector_field()``). Its plain version is
ops/rk_ds.py:make_batched_last_integrator_ds over ``f_ds`` with slice
0's width for every slice (``plain_fanout_ds``): the CPU runs and the
tests take it for CPU tensors, and chip_smoke.py holds the kernel to it
on the card. For CUDA tensors the fan-out launches the kernel or raises.
Each launch adds one to ``rk_cuda.rk_fanout.launches``, and to
``launches_by_field`` and ``launches_by_shape`` under the field's name
with ``_ds`` appended.
"""

import ctypes
import functools

import numpy as np
import torch

from nngparareal_torch.ops import rk_cuda
from nngparareal_torch.ops.butcher import get_tableau
from nngparareal_torch.ops.rk_ds import integrate_batch_ds


def coef_layout(tableau):
    """The nonzero tableau multipliers, a_ij row by row and then b_i, in
    the order of rk_pallas.py:_coef_layout (csrc/ds_fanout.cu: coef_a,
    coef_b)."""
    tab = get_tableau(tableau)
    vals = [tab.a[i][j] for i in range(tab.stages) for j in range(i)
            if tab.a[i][j] != 0.0]
    vals += [bi for bi in tab.b if bi != 0.0]
    return np.asarray(vals, np.float64)


def step_pairs(tableau, dt):
    """The (hi, lo) f32 pairs of the step coefficients ``vals * dt``, formed
    in f64 on the host as the Pallas kernel's wrapper forms them."""
    coefs = coef_layout(tableau) * float(dt)
    hi = coefs.astype(np.float32)
    lo = (coefs - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


class _TimeRead(Exception):
    pass


class _TimeProbe:
    """A time argument that raises ``_TimeRead`` at any use."""

    def _read(self, *args, **kwargs):
        raise _TimeRead

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _read
    __truediv__ = __rtruediv__ = __neg__ = __pow__ = __float__ = _read
    __lt__ = __gt__ = __le__ = __ge__ = __index__ = __getitem__ = _read
    __array__ = _read

    def __getattr__(self, name):
        raise _TimeRead

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise _TimeRead


def ds_field_is_autonomous(f_ds, dim, device="cpu"):
    """True when the ds field never reads its time argument, the
    condition of the kernel (it forms no stage time). The field is called
    once on a zero state on ``device`` with a time argument that raises
    at any use; a field that fails for another reason is not taken
    either."""
    z = torch.zeros((1, int(dim)), dtype=torch.float32, device=device)
    try:
        f_ds(_TimeProbe(), (z, z))
    except Exception:  # _TimeRead among them
        return False
    return True


def uniform_step(t0s, t1s, steps):
    """Slice 0's step width (t1s[0] - t0s[0]) / steps, in f64 on the
    host; raises ValueError when the slices' widths are not all that of
    slice 0 (rtol 1e-12)."""
    w = (torch.as_tensor(t1s, dtype=torch.float64)
         - torch.as_tensor(t0s, dtype=torch.float64)).cpu().numpy()
    if w.size > 1 and not np.allclose(w, w.flat[0], rtol=1e-12, atol=0.0):
        raise ValueError(
            "the double-single fan-out kernel requires uniform slice "
            f"widths; got spread [{w.min()!r}, {w.max()!r}] — use "
            "fine='ds' (ops/rk_ds.py) for slices of their own widths")
    return float(w.flat[0]) / int(steps)


def plain_fanout_ds(f_ds, tableau, steps, U, dt):
    """The kernel's plain version: ``steps`` ds RK steps of ``f_ds`` from
    U (B, d) f64, every slice with the step width ``dt``, on U's device."""
    dts = torch.full((U.shape[0], 1), float(dt), dtype=torch.float64,
                     device=U.device)
    t0s = torch.zeros(U.shape[0], dtype=torch.float64, device=U.device)
    return integrate_batch_ds(f_ds, tableau, steps, t0s, dts, U)


@functools.cache
def _library():
    """The C entry point of each field by name (ops/rk_cuda.py's field
    names), each from the field's own library: (U, out, tableau, B,
    <grid>, steps, coef_hi, coef_lo, n_coef, <field's constants>, query,
    stream)."""
    rk_cuda.build()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ll = ctypes.c_longlong
    coefs = [ctypes.POINTER(ctypes.c_float)] * 2 + [i]
    tail = [ctypes.POINTER(i), p]
    args = {"burgers": [p, p, i, i, i, ll] + coefs + [f, f] + tail,
            "fhn_pde": [p, p, i, i, i, i, ll] + coefs + [f] * 6 + tail}
    for kind in rk_cuda.ODE_DIMS:
        consts = [f] if kind == "hopf" else []
        args[kind] = ([p, p, i, i, ll] + coefs + [ctypes.POINTER(f)]
                      + consts + tail)
    fns = {}
    for name, argtypes in args.items():
        lib = ctypes.CDLL(str(rk_cuda.library_path(f"ds_fanout_{name}")))
        prefix = "ds_fanout" if name in ("burgers", "fhn_pde") else "ds_slice"
        fn = getattr(lib, f"{prefix}_{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _constants(field):
    """The field's constants as the ds entry point takes them."""
    if isinstance(field, rk_cuda.BurgersField):
        return (field.inv_h2, field.half_inv_2h)
    if isinstance(field, rk_cuda.FhnPdeField):
        if field.hx2 is None or field.hy2 is None:
            raise ValueError("the ds kernel needs FHN-PDE's squared "
                             "spacings (FhnPdeField.hx2, hy2)")
        return (field.hx2, field.hy2, field.a, field.b, field.k,
                field.inv_tau)
    return field.constants()


def _launch(field, tab_id, B, d, U, out, steps, hi, lo, device, query=None):
    """Call the field's ds entry point: launch on the current stream of
    ``device`` (U, out tensors there), or with ``query`` report the
    instance instead."""
    grid = rk_cuda._grid(field, d)
    fn = _library()[field.name]
    hi_c = (ctypes.c_float * len(hi))(*hi.tolist())
    lo_c = (ctypes.c_float * len(lo))(*lo.tolist())
    with torch.cuda.device(device):
        stream = (None if query is not None
                  else torch.cuda.current_stream(device).cuda_stream)
        return fn(None if U is None else U.data_ptr(),
                  None if out is None else out.data_ptr(), tab_id, B, *grid,
                  steps, hi_c, lo_c, len(hi), *_constants(field), query,
                  stream)


def ds_fanout(U, tableau, steps, dt, field, f_ds):
    """U(t + steps * dt) for B slices of ``steps`` ds RK steps of width
    ``dt`` each: the kernel for CUDA tensors, its plain version
    (``plain_fanout_ds``) for CPU tensors. U: (B, d) f64 contiguous."""
    if not isinstance(field, rk_cuda.FIELDS):
        raise TypeError(f"the ds fan-out kernel has no form of {field!r}")
    tab = get_tableau(tableau)
    tab_id = rk_cuda.compiled_tableau_id(tab)
    steps = int(steps)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if U.device.type == "cpu":
        return plain_fanout_ds(f_ds, tab, steps, U, dt)
    if U.device.type != "cuda":
        raise ValueError(f"ds_fanout runs on cuda or cpu, not {U.device}")
    if U.dim() != 2:
        raise ValueError(f"U must be (B, d), got shape {tuple(U.shape)}")
    rk_cuda._check("U", U, tuple(U.shape), U.device)
    out = torch.empty_like(U)
    if U.shape[0] == 0:
        return out
    hi, lo = step_pairs(tab, dt)
    B, d = U.shape
    rc = _launch(field, tab_id, B, d, U, out, steps, hi, lo, U.device)
    if rc != 0:
        raise RuntimeError(f"ds_fanout kernel launch failed: cudaError {rc}")
    fan = rk_cuda.rk_fanout
    name = f"{field.name}_ds"
    fan.launches += 1
    fan.launches_by_field[name] += 1
    shape = (name, tab.name, steps)
    fan.launches_by_shape[shape] = fan.launches_by_shape.get(shape, 0) + 1
    return out


def make_cuda_fanout_ds(f_ds, tableau, steps, device_field):
    """Build ``fan_out(t0s, t1s, U) -> (B, d)`` f64: the ds kernel at slice
    0's step width (``uniform_step``) for CUDA tensors, its plain version
    for CPU tensors. ``device_field`` is ``ode.get_device_field()``;
    ``f_ds`` the same system's ds field (``ode.get_ds_vector_field()``),
    whose order of operations the kernel's form of the field follows."""
    if device_field is None:
        raise ValueError("the ds fan-out kernel needs the system's device "
                         "field (ode.get_device_field())")
    if not isinstance(device_field, rk_cuda.FIELDS):
        raise TypeError(f"the ds fan-out kernel has no form of "
                        f"{device_field!r}")
    tab = get_tableau(tableau)
    rk_cuda.compiled_tableau_id(tab)
    steps = int(steps)
    checked = set()

    def run(t0s, t1s, U):
        key = (int(U.shape[-1]), str(U.device))
        if key not in checked:
            if not ds_field_is_autonomous(f_ds, key[0], U.device):
                raise NotImplementedError(
                    "the ds fan-out kernel requires an autonomous vector "
                    "field (it forms no stage time); this field reads t — "
                    "use fine='ds'")
            checked.add(key)
        dt = uniform_step(t0s, t1s, steps)
        return ds_fanout(U, tab, steps, dt, device_field, f_ds)

    return run


def kernel_attributes(field, tableau, B, d, device=None):
    """The ds kernel instance a fan-out of B slices of d values would
    launch, as the card reports it (as rk_cuda.kernel_attributes)."""
    tab = get_tableau(tableau)
    tab_id = rk_cuda.compiled_tableau_id(tab)
    query = (ctypes.c_int * 4)()
    device = torch.device("cuda") if device is None else torch.device(device)
    hi, lo = step_pairs(tab, 0.0)
    rc = _launch(field, tab_id, B, d, None, None, 0, hi, lo, device,
                 query=query)
    if rc != 0:
        raise RuntimeError(f"ds kernel attributes of {field.name}: "
                           f"cudaError {rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm",
                     "threads"), query))
