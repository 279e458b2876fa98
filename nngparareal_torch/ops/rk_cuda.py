"""Fine fan-out as a hand-written CUDA kernel (csrc/rk_fanout.cu).

Replaces the Pallas TPU kernel ``nngparareal_tpu/ops/rk_pallas.py``
(``make_pallas_fanout_ds``): B time slices of fixed-step explicit RK, every
step inside one launch, computed in native f64 on the card.

Build and binding: ``nvcc`` compiles the source into a shared library with
a plain C interface the first time the kernel is needed, into
``nngparareal_torch/_build/<hash of source and flags>/``; ``ctypes`` loads
it. Nothing here includes PyTorch's C++ headers, so the build takes
seconds, and importing this module needs neither a card nor ``nvcc``.

``rk_fanout`` takes its plain version (ops/rk.py) only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls
back. ``rk_fanout.launches`` counts the kernel's launches.
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
SOURCE = _PKG / "csrc" / "rk_fanout.cu"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_D = 512  # the kernel's __launch_bounds__: one thread per grid point
STAGES = (1, 2, 4, 11)  # the tableaus the kernel is instantiated for


@dataclass(frozen=True)
class BurgersField:
    """The [-1,1]-normalised Burgers field as the kernel takes it: its two
    stencil constants (systems/pdes.py:Burgers._f_norm11 evaluates the same
    field in torch)."""

    inv_h2: float
    half_inv_2h: float


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
    """Where the library for the current source and flags lives."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
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
    lib = ctypes.CDLL(str(build()))
    fn = lib.rk_fanout_burgers_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_double, ctypes.c_double, p]
    fn.restype = ctypes.c_int
    return fn


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

    t0s, t1s: (B,) f64; U: (B, d) f64 contiguous. ``field`` is the
    BurgersField the kernel takes; ``f`` is the same system's torch vector
    field (``ode.get_vector_field()``), which the plain version integrates
    for CPU tensors. Each slice steps with its own
    h = (t1s[b] - t0s[b]) / steps.
    """
    if not isinstance(field, BurgersField):
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
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes 1 <= d <= {MAX_D}, got d={d}")
    if tab.stages not in STAGES:
        raise ValueError(f"no kernel instance for {tab.stages} stages")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    out = torch.empty_like(U)
    if B == 0:
        return out
    launch = _library()
    coefs = torch.tensor(flat_coefficients(tab), dtype=torch.float64,
                         device=U.device)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        rc = launch(t0s.data_ptr(), t1s.data_ptr(), U.data_ptr(),
                    out.data_ptr(), coefs.data_ptr(), tab.stages, B, d, steps,
                    float(field.inv_h2), float(field.half_inv_2h), stream)
    if rc != 0:
        raise RuntimeError(f"rk_fanout kernel launch failed: cudaError {rc}")
    rk_fanout.launches += 1
    return out


rk_fanout.launches = 0
