"""Fine fan-out as a hand-written CUDA kernel (csrc/rk_fanout.cu).

Replaces the Pallas TPU kernel ``nngparareal_tpu/ops/rk_pallas.py``
(``make_pallas_fanout_ds``): B time slices of fixed-step explicit RK, every
step inside one launch, computed in native f64 on the card. The Pallas
kernel traced any JAX field; this one has a device form of each field it
serves, and a system hands it that field's constants
(``ode.get_device_field()``): ``BurgersField`` or ``FhnPdeField``.

Build and binding: ``nvcc`` compiles the source into a shared library with
a plain C interface the first time the kernel is needed, into
``nngparareal_torch/_build/<hash of sources and flags>/``; ``ctypes`` loads
it. Nothing here includes PyTorch's C++ headers, so the build takes
seconds, and importing this module needs neither a card nor ``nvcc``.

``rk_fanout`` takes its plain version (ops/rk.py) only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls
back. ``rk_fanout.launches`` counts the kernel's launches, and
``rk_fanout.launches_by_field`` the same launches per field, keyed by the
field's ``name``.
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

from nngparareal_torch.ops.butcher import flat_coefficients, get_tableau
from nngparareal_torch.ops.rk import make_batched_last_integrator

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "rk_fanout.cu"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_THREADS = 512  # the kernel's __launch_bounds__: one thread per cell
STAGES = (1, 2, 4, 11)  # the tableaus the kernel is instantiated for


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


FIELDS = (BurgersField, FhnPdeField)


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


def build(timeout=600.0):
    """Compile the kernel library unless it exists; return its path.

    The output is written under a temporary name and renamed into place, so
    a build that is cut short leaves no library behind.
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
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def _library():
    """The C entry point of each field: (t0s, t1s, U, out, tab, stages, B,
    <field's grid>, steps, <field's constants>, stream)."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    head = [p, p, p, p, p, i, i]
    burgers = lib.rk_fanout_burgers_launch
    burgers.argtypes = head + [i, ctypes.c_longlong, f, f, p]
    fhn_pde = lib.rk_fanout_fhn_pde_launch
    fhn_pde.argtypes = head + [i, i, ctypes.c_longlong, f, f, f, f, f, f, p]
    for fn in (burgers, fhn_pde):
        fn.restype = ctypes.c_int
    return {"burgers": burgers, "fhn_pde": fhn_pde}


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
    field the kernel takes (``BurgersField`` or ``FhnPdeField``); ``f`` is
    the same system's torch vector field (``ode.get_vector_field()``),
    which the plain version integrates for CPU tensors. Each slice steps
    with its own h = (t1s[b] - t0s[b]) / steps.
    """
    if not isinstance(field, FIELDS):
        raise TypeError(f"the fan-out kernel has no form of {field!r}")
    tab = get_tableau(tableau)
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
    grid = field.grid(d)
    threads = d // field.values
    if not 1 <= threads <= MAX_THREADS:
        raise ValueError(f"the kernel takes 1 to {MAX_THREADS} threads per "
                         f"slice, {field.name} at d={d} needs {threads}")
    if tab.stages not in STAGES:
        raise ValueError(f"no kernel instance for {tab.stages} stages")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    out = torch.empty_like(U)
    if B == 0:
        return out
    launch = _library()[field.name]
    coefs = torch.tensor(flat_coefficients(tab), dtype=torch.float64,
                         device=U.device)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = launch(t0s.data_ptr(), t1s.data_ptr(), U.data_ptr(),
                    out.data_ptr(), coefs.data_ptr(), tab.stages, B, *grid,
                    steps, *field.constants(), stream)
    if rc != 0:
        raise RuntimeError(f"rk_fanout kernel launch failed: cudaError {rc}")
    rk_fanout.launches += 1
    rk_fanout.launches_by_field[field.name] += 1
    return out


rk_fanout.launches = 0
rk_fanout.launches_by_field = {cls.name: 0 for cls in FIELDS}
