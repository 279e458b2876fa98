"""Fine fan-out as a hand-written CUDA kernel (csrc/rk_fanout.cu).

Replaces the Pallas TPU kernel ``nngparareal_tpu/ops/rk_pallas.py``
(``make_pallas_fanout_ds``): B time slices of fixed-step explicit RK, every
step inside one launch, computed in native f64 on the card. The Pallas
kernel traced any JAX field; this one has a device form of each field it
serves, and a system hands it that field's constants
(``ode.get_device_field()``):

* ``BurgersField`` and ``FhnPdeField``, the PDE fields (d >= 64): one
  block per slice, one thread per grid cell;
* ``OdeField``, the seven d < 64 ODE fields (``ODE_DIMS``): one thread per
  slice. The solver also launches it at B=1 for each coarse solve of these
  systems (solver.py:RKSolver.coarse_step_raw).

Build and binding: ``nvcc`` compiles the source into a shared library with
a plain C interface the first time the kernel is needed, into
``nngparareal_torch/_build/<hash of sources and flags>/``; ``ctypes`` loads
it. Nothing here includes PyTorch's C++ headers, so the build takes
seconds, and importing this module needs neither a card nor ``nvcc``.

The tableau is compiled in (csrc/tableaus.cuh, generated from
ops/butcher.py): ``rk_fanout`` picks the kernel instance by the tableau's
name and refuses a tableau whose coefficients are not the compiled ones.

``rk_fanout`` takes its plain version (ops/rk.py) only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls
back. ``rk_fanout.launches`` counts the kernel's launches,
``rk_fanout.launches_by_field`` the same launches per field, keyed by the
field's ``name``, and ``rk_fanout.launches_by_shape`` per (field, tableau,
steps): a path's fine fan-outs apart from its coarse solves.
``latency_probe`` runs the source's probe of the card's latencies (the
yardstick of chip_smoke.py's chain bound); ``kernel_attributes`` reads an
instance's registers and occupancy.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

from nngparareal_torch.ops.butcher import TABLEAUS, dense_a, get_tableau
from nngparareal_torch.ops.rk import make_batched_last_integrator

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "rk_fanout.cu"
TABLEAUS_H = CSRC / "tableaus.cuh"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_THREADS = 512  # the kernel's __launch_bounds__: one thread per cell


def compiled_tableau_id(tableau):
    """The C entry points' index of the compiled tableau of the same name
    (its ``id`` in csrc/tableaus.cuh, which is generated from
    ``butcher.TABLEAUS`` in its order). Raises if there is none, or if its
    coefficients are not exactly the given tableau's: no tableau runs with
    another one's coefficients."""
    tab = get_tableau(tableau)
    shipped = TABLEAUS.get(tab.name)
    if shipped is None:
        raise ValueError(f"the kernel is compiled for no tableau named "
                         f"{tab.name!r} (it has {sorted(TABLEAUS)})")
    if tab is not shipped and (
            dense_a(tab) != dense_a(shipped)
            or tuple(map(float, tab.b)) != tuple(map(float, shipped.b))):
        raise ValueError(f"tableau {tab.name!r}: its coefficients are not "
                         f"the kernel's compiled {tab.name} "
                         f"(csrc/tableaus.cuh)")
    return list(TABLEAUS).index(tab.name)


@dataclass(frozen=True)
class BurgersField:
    """The [-1,1]-normalised Burgers field as the kernel takes it: its two
    stencil constants (systems/pdes.py:Burgers._f_norm11 evaluates the same
    field in torch). One thread per grid point: d of them per slice."""

    inv_h2: float
    half_inv_2h: float

    name = "burgers"
    values = 1  # state values per thread

    def grid(self, d):
        """The C entry point's grid arguments for a state of d values."""
        return (d,)

    def constants(self):
        return (self.inv_h2, self.half_inv_2h)


@dataclass(frozen=True)
class FhnPdeField:
    """The [-1,1]-normalised FitzHugh-Nagumo 2D field as the kernel takes
    it: the grid, the inverse squared spacings and the reaction constants
    (systems/pdes.py:FHNPDE._f evaluates the same field in torch). One
    thread per cell, carrying both species: d_y * d_x per slice."""

    d_x: int
    d_y: int
    inv_hx2: float
    inv_hy2: float
    a: float
    b: float
    k: float
    inv_tau: float

    name = "fhn_pde"
    values = 2  # both species of a cell in one thread

    def grid(self, d):
        """The C entry point's grid arguments for a state of d values."""
        if d != 2 * self.d_x * self.d_y:
            raise ValueError(f"FHN-PDE on a {self.d_y}x{self.d_x} grid has "
                             f"d={2 * self.d_x * self.d_y}, got d={d}")
        return (self.d_x, self.d_y)

    def constants(self):
        return (self.inv_hx2, self.inv_hy2, self.a, self.b, self.k,
                self.inv_tau)


# the ODE fields of the one-thread-per-slice kernel: kind -> state
# dimension; each kind is a functor in csrc/rk_fanout.cu and the
# ``device_kind`` of a system in systems/odes.py
ODE_DIMS = {"fhn_ode": 2, "rossler": 3, "hopf": 3, "dblpend": 4,
            "brusselator": 2, "lorenz": 3, "tomlab": 3}


@dataclass(frozen=True)
class OdeField:
    """A d < 64 ODE field as the one-thread-per-slice kernel takes it: the
    functor's kind (a key of ``ODE_DIMS``), its constants (Hopf: the end
    of its tspan) and the normalisation's affine map per coordinate (mn,
    span = mx - mn, scale), or None for each of the three for the raw
    field (systems/base.py:ODE.get_device_field). One thread per slice:
    it carries all d values of the state."""

    name: str
    consts: tuple = ()
    mn: tuple = None
    span: tuple = None
    scale: tuple = None

    def __post_init__(self):
        if self.name not in ODE_DIMS:
            raise ValueError(f"the kernel has no ODE field {self.name!r}")

    @property
    def values(self):
        """State values per thread: the whole state of a slice."""
        return ODE_DIMS[self.name]

    def grid(self, d):
        """The C entry point's grid arguments (none) for d values."""
        if d != self.values:
            raise ValueError(f"the {self.name} field has d={self.values}, "
                             f"got d={d}")
        return ()

    def constants(self):
        """The map, as a host array of 3*d f64 values (NULL for the
        identity), then the field's own constants."""
        if self.mn is None:
            return (None, *self.consts)
        vals = (*self.mn, *self.span, *self.scale)
        return ((ctypes.c_double * len(vals))(*vals), *self.consts)


FIELDS = (BurgersField, FhnPdeField, OdeField)
FIELD_NAMES = ("burgers", "fhn_pde", *ODE_DIMS)


def find_nvcc():
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path():
    """Where the library for the current sources and flags lives: the key
    hashes every file under csrc/, the .cu and any header it may include,
    so that no edit there loads a stale library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    key = digest.hexdigest()[:16]
    return BUILD_ROOT / key / "librk_fanout.so"


def ptxas_report_path():
    """Where ``build`` keeps ptxas' report (``-Xptxas -v``: registers,
    stack and spills of each kernel instance) beside the library."""
    return library_path().with_suffix(".ptxas.txt")


def build(timeout=600.0):
    """Compile the kernel library unless it exists; return its path.

    The output is written under a temporary name and renamed into place, so
    a build that is cut short leaves no library behind; ptxas' report is
    written first (``ptxas_report_path``).
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        ptxas_report_path().write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def _library():
    """The C entry point of each field, by name: (t0s, t1s, U, out,
    tableau, B, <field's grid>, steps, <field's constants>, query,
    stream); and the latency probe."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    head = [p, p, p, p, i, i]
    tail = [ctypes.POINTER(i), p]
    burgers = lib.rk_fanout_burgers_launch
    burgers.argtypes = head + [i, ctypes.c_longlong, f, f] + tail
    fhn_pde = lib.rk_fanout_fhn_pde_launch
    fhn_pde.argtypes = head + [i, i, ctypes.c_longlong, f, f, f, f, f,
                               f] + tail
    fns = {"burgers": burgers, "fhn_pde": fhn_pde}
    for kind in ODE_DIMS:
        fn = getattr(lib, f"rk_slice_{kind}_launch")
        consts = [f] if kind == "hopf" else []
        fn.argtypes = (head + [ctypes.c_longlong, ctypes.POINTER(f)] + consts
                       + tail)
        fns[kind] = fn
    probe = lib.rk_latency_probe_launch
    probe.argtypes = [i, ctypes.c_longlong, i, f, p, p, p]
    fns["probe"] = probe
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def _check(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != torch.float64:
        raise TypeError(f"{name} must be float64, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rk_fanout(t0s, t1s, U, tableau, steps, field, f):
    """U(t1) for B slices: ``steps`` fixed RK steps of the field per slice.

    t0s, t1s: (B,) f64; U: (B, d) f64 contiguous. ``field`` is the device
    field the kernel takes (``BurgersField``, ``FhnPdeField`` or
    ``OdeField``); ``f`` is
    the same system's torch vector field (``ode.get_vector_field()``),
    which the plain version integrates for CPU tensors. Each slice steps
    with its own h = (t1s[b] - t0s[b]) / steps. The tableau must be one the
    kernel is compiled for (``compiled_tableau_id``), on the CPU too.
    """
    if not isinstance(field, FIELDS):
        raise TypeError(f"the fan-out kernel has no form of {field!r}")
    tab = get_tableau(tableau)
    tab_id = compiled_tableau_id(tab)
    steps = int(steps)
    if U.device.type == "cpu":
        return make_batched_last_integrator(f, tab, steps)(t0s, t1s, U)
    if U.device.type != "cuda":
        raise ValueError(f"rk_fanout runs on cuda or cpu, not {U.device}")
    if U.dim() != 2:
        raise ValueError(f"U must be (B, d), got shape {tuple(U.shape)}")
    B, d = U.shape
    _check("U", U, (B, d), U.device)
    _check("t0s", t0s, (B,), U.device)
    _check("t1s", t1s, (B,), U.device)
    grid = _grid(field, d)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    out = torch.empty_like(U)
    if B == 0:
        return out
    launch = _library()[field.name]
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = launch(t0s.data_ptr(), t1s.data_ptr(), U.data_ptr(),
                    out.data_ptr(), tab_id, B, *grid, steps,
                    *field.constants(), None, stream)
    if rc != 0:
        raise RuntimeError(f"rk_fanout kernel launch failed: cudaError {rc}")
    rk_fanout.launches += 1
    rk_fanout.launches_by_field[field.name] += 1
    shape = (field.name, tab.name, steps)
    rk_fanout.launches_by_shape[shape] = (
        rk_fanout.launches_by_shape.get(shape, 0) + 1)
    return out


def _grid(field, d):
    """The C entry point's grid arguments for a state of d values; checks
    the threads a slice needs."""
    grid = field.grid(d)
    threads = d // field.values
    if not 1 <= threads <= MAX_THREADS:
        raise ValueError(f"the kernel takes 1 to {MAX_THREADS} threads per "
                         f"slice, {field.name} at d={d} needs {threads}")
    return grid


def kernel_attributes(field, tableau, B, d, device=None):
    """The kernel instance that a fan-out of B slices of d values would
    launch, as the card reports it (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor): registers a thread,
    local memory a thread (bytes; nonzero where it spills), resident
    blocks per SM at that launch's block size, and that block size."""
    tab_id = compiled_tableau_id(tableau)
    grid = _grid(field, d)
    query = (ctypes.c_int * 4)()
    device = torch.device("cuda") if device is None else torch.device(device)
    with torch.cuda.device(device):
        rc = _library()[field.name](None, None, None, None, tab_id, B, *grid,
                                    0, *field.constants(), query, None)
    if rc != 0:
        raise RuntimeError(f"kernel attributes of {field.name}: cudaError "
                           f"{rc}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm",
                     "threads"), query))


rk_fanout.launches = 0
rk_fanout.launches_by_field = dict.fromkeys(FIELD_NAMES, 0)
rk_fanout.launches_by_shape = {}

# the latency probe's chains (csrc/rk_fanout.cu:ProbeKind), each with the
# constant c it runs with: x + c, x * c, fma(x, c, c - 1), x / c,
# sin(x) + c, and the exchange round of the per-cell kernel
PROBE_KINDS = {"add": (0, 1e-3), "mul": (1, 1.0 + 2.0 ** -30),
               "fma": (2, 1.0 + 2.0 ** -30), "div": (3, 1.0 + 2.0 ** -30),
               "sin": (4, 1.5), "sync": (5, 0.5)}


def latency_probe(kind, n=1 << 20, threads=1, device=None):
    """Run the probe's chain of ``n`` dependent operations of ``kind`` (a
    key of ``PROBE_KINDS``; "sync": n exchange rounds in a block of
    ``threads``) in one thread on the card. Returns (cycles per operation
    by clock64(), the launch's milliseconds by CUDA events). Not counted in
    ``rk_fanout.launches``."""
    code, c = PROBE_KINDS[kind]
    device = torch.device("cuda") if device is None else torch.device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.float64, device=device)
    launch = _library()["probe"]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = launch(code, int(n), int(threads), float(c), cycles.data_ptr(),
                    sink.data_ptr(), stream.cuda_stream)
        stop.record(stream)
    if rc != 0:
        raise RuntimeError(f"latency probe launch failed: cudaError {rc}")
    stop.synchronize()
    if not torch.isfinite(sink).all():
        raise RuntimeError(f"latency probe {kind}: the chain's value is "
                           f"{sink.item()}")
    return cycles.item() / n, start.elapsed_time(stop)
