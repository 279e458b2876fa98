#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nngparareal_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it ends with its seconds:

1. env       torch and CUDA versions, the card, its power limit.
2. build     nvcc builds the fan-out kernels from csrc/rk_fanout.cu (with
             the tableaus of csrc/tableaus.cuh compiled in) and prints
             ptxas' registers and spills of every instance (any spill
             fails), each path instance's registers and resident blocks
             per SM as the card reports them, and the latency probe: the
             card's cycles per dependent f64 add, multiply, FMA, division
             and sin, and per exchange round (store, barrier, load) of a
             128- and a 256-thread block, with the clock they imply
             beside nvidia-smi's clocks.sm.
3. kernels   the kernels against their plain torch version, for each field
             at its path's shapes (max error relative to max|U| must be
             <= 1e-12, 200 steps): Burgers d=128 at B=128 and a ragged
             B=37, and FHN-PDE dx=16 (d=512) at B=512 and B=37, RK8; the
             seven ODE fields (FHN, Rossler, Hopf, DblPend, Brusselator,
             Lorenz, ThomasLabyrinth) at B = the configuration's N, 37 and
             1 (the coarse solves' shape), with RK8 and the tableaus of
             their Table-2 path. The states are u0 plus a seeded
             perturbation, on slices of the configuration's width. Then
             each kernel's time at its path's full fine shape, the ODE
             fields' also at B=1 with the coarse tableau and step count
             (``coarse_ms``), the plain version's time at min(1000, steps)
             steps (as measured, never scaled up), and the bound: the
             largest of the operation, byte and chain bounds (``bound``);
             Hopf also at B=512 with run_hopf's 3.4e6 RK8 steps per slice.
4. flagship  the port's first path: Burgers d=128 nnGParareal
             (bench.py:90-121: N=128 over [0, 5.9], RK1 x4 / RK8 x40000
             per slice, m=18, grid search, seed 45, eps=5e-7) through
             Parareal.run. It must converge with 10 <= K <= 14, and the
             Burgers kernel must have run in it.
5. fhn_pde   the second path: the FHN-PDE d-scaling run at dx=16 (d=512,
             N=512 over [0, 1100], RK4 x25 / RK8 x195 325 per slice,
             nnGP nn=20, grid search, seed 45, eps=5e-7) through
             experiments.run_fhn_pde. It must converge with 4 <= K <= 7,
             and the FHN-PDE kernel must have run in it.
6. table2    the third path: experiments.run_table2 at eps=5e-7 with the
             parareal and nngp (grid search) models, all six systems at
             their published configurations. Each system's path must have
             launched its own field's kernel (fine fan-outs and coarse
             solves) and no other. Parareal K must equal the CPU IEEE-f64
             oracle (FHN 11, Rossler 18, Hopf 19, Brusselator 19, Lorenz
             15, DblPend 15), and nnGP K lie in the range
             tests/test_parity_slow.py allows the JAX package (Rossler's
             widened to 11-13: see TABLE2). Then
             ThomasLabyrinth N=32 with the parareal model through
             Parareal.run (K=30, the JAX package's on the CPU).
7. serial    the runs' converged iterates against fine solves, slice by
             slice (atol 2e-5, as tests/test_parareal.py holds the JAX
             package): Burgers one slice after another from u0; FHN-PDE
             and each Table-2 run with one kernel fan-out from the
             converged starts.

Then one JSON line describing each kernel (its launches on its path's
run, split by shape into fine fan-outs and coarse solves,
``launches_by_shape``; ``chain_ms``, the chain bound: the path's steps
times the dependent operations through one step, ``chain_depth``, at the
probe's latencies), the card's name and power limit as nvidia-smi prints
them, and as the last line
{"ok": true, "device": {...}}. A deadline at two thirds of the 1200 s the
run is given stops it with an error that names the running phase. Any
failure exits nonzero and prints no result; so does a machine with no
card, or a directory without the package.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT_S = 1200
DEADLINE_S = LIMIT_S * 2 // 3

# NVIDIA H100 SXM data sheet: f64 without the tensor cores, and HBM3
FP64_PEAK = 34e12
HBM_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(d_x=128, N=128, T=5.9, Ng=4, Nf=40000, G="RK1", F="RK8",
                eps=5e-7, nn=18, seed=45)
FHN_PDE_DX = 16
CHECK_STEPS = 200
PLAIN_STEPS = 1000
RAGGED = 37
KERNEL_RTOL = 1e-12
K_RANGE = (10, 14)
FHN_PDE_K_RANGE = (4, 7)
SERIAL_ATOL = 2e-5

TABLE2_EPS = 5e-7
# system: (its field, Parareal K, nnGP K range, nnGP K of the exact CPU
# grid-search run), from PARITY.md:9-16 and tests/test_parity_slow.py:19-30.
# Rossler's range also takes 11: the JAX package's nnGP gives 11 in three
# of ten draws of a 4e-16 move of u0 (tests/test_torch_table2.py:
# test_rossler_nngp_k_under_the_control), the reference implementation
# gives 11 for one of five seeds at m=15 (PARITY.md:197), and the port on
# the CPU gives 11, within the control's gap to JAX in every iteration
# (tests/test_torch_table2_rossler_slow.py)
TABLE2 = {
    "FHN_ODE": ("fhn_ode", 11, (5, 5), 5),
    "Rossler": ("rossler", 18, (11, 13), 13),
    "Hopf_32": ("hopf", 19, (9, 10), 9),
    "Brusselator": ("brusselator", 19, (16, 19), 18),
    "Lorenz": ("lorenz", 15, (9, 10), 9),
    "DblPend": ("dblpend", 15, (9, 11), 11),
}
# the ODE fields: the system and the N its Config takes (Table 2 runs Hopf
# at N=32; ThomasLabyrinth's smallest N is 32)
ODE_SYSTEMS = {"fhn_ode": ("FHNODE", None), "rossler": ("Rossler", None),
               "hopf": ("Hopf", 32), "dblpend": ("DblPend", None),
               "brusselator": ("Brusselator", None),
               "lorenz": ("Lorenz", None), "tomlab": ("ThomasLabyrinth", 32)}
# ThomasLabyrinth N=32, Parareal: the JAX package's K on the CPU
# (tests/test_torch_table2.py:test_tomlab_parareal_k_of_the_jax_package)
TOMLAB_K = 30
HOPF_FINE_MULT = 10000  # run_hopf's fine steps: Config(N=512)'s Nf x 10000

# f64 operations of one field evaluation, per thread of the kernel (one
# grid point of Burgers, one cell of FHN-PDE with both species, one slice
# of an ODE), counted from csrc/rk_fanout.cu. An f64 sin or cos counts as
# 20 (a range reduction and a polynomial of degree ~13 in CUDA's math
# library, estimated), DblPend's __ddiv_rn as 1; FHN's division by 3 is 3
# (a multiply and two FMAs), Hopf's by maxtime 5 (csrc/rk_fanout.cu:div_by).
# The ODE fields' [-1,1] map adds 5 per coordinate.
FIELD_OPS = {"burgers": 9, "fhn_pde": 29, "fhn_ode": 12, "rossler": 7,
             "hopf": 14, "dblpend": 26 + 4 * 20, "brusselator": 7,
             "lorenz": 9, "tomlab": 3 * (3 + 20)}
MAP_OPS = 5
# Dependent f64 operations through one field evaluation, in the order the
# kernel computes it, counted by hand from csrc/rk_fanout.cu. An ODE field
# has a matrix: row i, column j is the longest path from state coordinate
# i to component j of the field (None: no path). An entry "5" is five
# adds, multiplies or FMAs; each "d" adds a __ddiv_rn and each "t" a sin or
# cos; "a|b" holds two paths whose order depends on the latencies. A PDE
# field has one row: the path from its neighbours' loads (after the
# stage's store and barrier) to each of its values.
#   fhn_ode  f0 = c*(u0 - u0*u0*u0/3 + u1): u0: mul mul, the division by
#            3 (mul fma fma), sub add mul; f1 = -(1/c)*(u0 - a + b*u1): u0:
#            sub add mul, u1: mul add mul
#   rossler  f2 = b + u2*(u0 - c): u0: sub mul add; f1 = u0 + a*u1
#   hopf     mu = u2/maxtime - u0*u0 - u1*u1, f0 = -u1 + u0*mu: u0: mul sub
#            sub mul add; the time coordinate u2 reaches mu through the
#            division (mul and four FMAs), and f2 = 1 reads nothing
#   dblpend  f1 = den*(sq1*cd*sd + ...), den = -1/(2 - cd*cd): u0 or u2:
#            sub, sin/cos, then 6 (through sd) or mul sub div mul (den);
#            u1: mul mul mul add add sub mul; f0 = u1 and f2 = u3 copy
#   brusselator  f0 = 1 + u0*u0*u1 - 4*u0: u0: mul mul add sub
#   lorenz   f1 = 28*u0 - u1 - u0*u2: u0: mul sub sub
#   tomlab   f0 = -a*u0 + b*sin(u1): u1: sin mul add
#   burgers  fma(-2, v, vp), + vm, * inv_h2, fma(-(v + 1), v_x, v_xx)
#   fhn_pde  the Laplacian (sub add mul fma), then fma(a, l1, u1), - u1^3,
#            - u2, + k; V: fma(b, l2, u1), - u2, * inv_tau
FIELD_DEPTH = {
    "fhn_ode": [["8", "3"], ["2", "3"]],
    "rossler": [[None, "1", "3"], ["1", "2", None], ["1", None, "2"]],
    "hopf": [["5", "5", None], ["4", "4", None], ["9", "9", None]],
    "dblpend": [[None, "7t|4dt", None, "7t|4dt"], ["0", "7", None, "7"],
                [None, "7t|4dt", None, "7t|4dt"], [None, "6", "0", "7"]],
    "brusselator": [["4", "3"], ["3", "2"]],
    "lorenz": [["2", "3", "2"], ["2", "2", "2"], [None, "2", "2"]],
    "tomlab": [["2", None, "2t"], ["2t", "2", None], [None, "2t", "2"]],
    "burgers": [["4"]],
    "fhn_pde": [["8", "7"]],
}
# the [-1,1] map on each path of an ODE field: (v + 1), * 0.5, * span, + mn
# before the raw field, * scale after
MAP_DEPTH = 5
PER_CELL = ("burgers", "fhn_pde")
# unit latencies: chain_depth counts operations, a division or a sin as one
UNIT = {"op": 1, "div": 1, "trig": 1, "sync": 0}


class PhaseError(RuntimeError):
    pass


class Phases:
    """Names the running phase, for the deadline and for failures."""

    def __init__(self):
        self.current = "start"

    def run(self, name, fn, *args):
        import torch

        self.current = name
        tic = time.perf_counter()
        info = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        print(f"[{name}] {json.dumps(info)} {secs:.3f}s", flush=True)
        return info


def nvidia_smi_line():
    return nvidia_smi_query("name,power.limit")


def nvidia_smi_query(fields):
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    lines = proc.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi gave nothing ({proc.returncode})"


def phase_env():
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi_line()}


def phase_build(state):
    from nngparareal_torch.ops import rk_cuda

    lib = rk_cuda.library_path()
    fresh = not lib.exists()
    tic = time.perf_counter()
    rk_cuda.build()
    build_s = time.perf_counter() - tic
    state["latency"] = latency = probe_latency()
    return {"library": os.path.relpath(lib, HERE), "fresh": fresh,
            "build_s": round(build_s, 3),
            "ptxas": ptxas_report(rk_cuda.ptxas_report_path().read_text()),
            "occupancy": occupancy(), "latency": latency}


# the exchange rounds probed: the per-cell kernel's block sizes on its paths
# (Burgers d=128, FHN-PDE dx=16)
SYNC_THREADS = (128, 256)
PROBE_N = 1 << 20


def probe_latency():
    """The card's cycles per dependent operation (clock64() in one
    thread), for the chain bound: add, multiply, FMA, division, sin (less
    the add that closes its chain), and the per-cell kernel's exchange
    round (store, barrier, a neighbour's load) in a block of each of
    SYNC_THREADS. The clock is the add chain's cycles over its time by
    CUDA events; nvidia-smi's clocks.sm is printed beside it."""
    from nngparareal_torch.ops import rk_cuda

    cycles, ms = {}, {}
    for kind in ("add", "mul", "fma", "div", "sin"):
        rk_cuda.latency_probe(kind, n=1 << 12)  # warm
        cycles[kind], ms[kind] = rk_cuda.latency_probe(kind, n=PROBE_N)
    for threads in SYNC_THREADS:
        cycles[f"sync{threads}"], ms[f"sync{threads}"] = (
            rk_cuda.latency_probe("sync", n=PROBE_N // 16, threads=threads))
    clock_hz = cycles["add"] * PROBE_N / (ms["add"] * 1e-3)
    ns = {k: v / clock_hz * 1e9 for k, v in cycles.items()}
    for key, val in {**cycles, "clock_hz": clock_hz}.items():
        if not (val > 0 and val < float("inf")):
            raise PhaseError(f"latency probe: {key} = {val}")
    return {"cycles": cycles, "ns": ns, "clock_hz": clock_hz,
            "clocks_sm": nvidia_smi_query("clocks.sm,clocks.max.sm")}


# the kernels' functors in their mangled names, and their fields
PTXAS_FUNCTORS = (("FhnPdeField", "fhn_pde"), ("BurgersField", "burgers"),
                  ("FhnOde", "fhn_ode"), ("Rossler", "rossler"),
                  ("Hopf", "hopf"), ("DblPend", "dblpend"),
                  ("Brusselator", "brusselator"), ("Lorenz", "lorenz"),
                  ("ThomasLabyrinth", "tomlab"))


def ptxas_report(text):
    """Registers and spills of each kernel instance, keyed by field,
    tableau and (ODE fields) "map" or "raw", from ``-Xptxas -v`` output;
    the probe's instances under "probe"."""
    report = {}
    key = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            tab = re.search(r"tableau\d+(RK\d+)", name)
            field = next((f for functor, f in PTXAS_FUNCTORS
                          if functor in name), "probe")
            mapped = re.search(r"SliceField.*?Lb([01])E", name)
            key = "/".join([field, tab.group(1) if tab else name[-12:]]
                           + ([("raw", "map")[int(mapped.group(1))]]
                              if mapped else []))
            report[key] = {}
        elif key and "spill" in ln:
            report[key]["spills"] = ln.split(":", 1)[-1].strip()
        elif key and "registers" in ln:
            report[key]["registers"] = ln.split(":", 1)[-1].strip()
    spilling = [k for k, v in report.items()
                if not re.search(r"0 bytes spill stores, 0 bytes spill loads",
                                 v.get("spills", ""))]
    if not report or spilling:
        raise PhaseError(f"ptxas: spills in {spilling} (or no report): "
                         f"{text.strip().splitlines()[-5:]}")
    return report


def occupancy():
    """Registers, local memory and resident blocks per SM of each kernel
    instance on the paths, at its path's block size, as the card reports
    them (rk_cuda.kernel_attributes). The local memory of the fields with
    sin or cos is the 40-byte stack of CUDA's argument reduction;
    ptxas_report holds every instance to no spills."""
    import nngparareal_torch as nt
    from nngparareal_torch.ops import rk_cuda

    out = {}
    ode = nt.Burgers(d_x=FLAGSHIP["d_x"], normalization="-11", device="cpu")
    out["burgers/RK8"] = rk_cuda.kernel_attributes(
        ode.get_device_field(), "RK8", FLAGSHIP["N"], FLAGSHIP["d_x"])
    ode = nt.FHNPDE(d_x=FHN_PDE_DX, normalization="-11", device="cpu")
    out["fhn_pde/RK8"] = rk_cuda.kernel_attributes(
        ode.get_device_field(), "RK8", 512, ode.get_dim())
    for kind, (cls, N_arg) in ODE_SYSTEMS.items():
        ode = getattr(nt, cls)(normalization="-11", device="cpu")
        cfg = nt.Config(ode, N=N_arg).get()
        for tab, B in ((cfg["F"], cfg["N"]), (cfg["G"], 1)):
            out[f"{kind}/{tab}/B={B}"] = rk_cuda.kernel_attributes(
                ode.get_device_field(), tab, B, ode.get_dim())
    out["hopf/RK8/B=512"] = rk_cuda.kernel_attributes(
        nt.Hopf(normalization="-11", device="cpu").get_device_field(), "RK8",
        512, 3)
    return out


def flops_per_thread_step(tab, field):
    """f64 operations per kernel thread per RK step: one field evaluation
    per stage (9 for a Burgers point; 29 for an FHN-PDE cell: two 5-point
    Laplacians of 9, the u1 reaction 7, the u2 reaction 4; an ODE's field
    and its [-1,1] map, FIELD_OPS), and for each state value of the thread
    2 per nonzero a_ij and b_i and 2 for the step update."""
    nz_a = sum(1 for row in tab.a for x in row if x != 0.0)
    nz_b = sum(1 for x in tab.b if x != 0.0)
    ops = FIELD_OPS[field.name]
    if getattr(field, "mn", None) is not None:
        ops += MAP_OPS * field.values
    return ops * tab.stages + field.values * (2 * nz_a + 2 * nz_b + 2)


def _path_cycles(entry, lat, extra):
    """The latency of one FIELD_DEPTH entry (None: no path)."""
    if entry is None:
        return None
    best = 0.0
    for path in entry.split("|"):
        ops = int("".join(ch for ch in path if ch.isdigit()) or 0) + extra
        best = max(best, ops * lat["op"] + path.count("d") * lat["div"]
                   + path.count("t") * lat["trig"])
    return best


def chain_cycles(tab, field, lat, steps=64):
    """The longest chain of dependent operations through one RK step, in
    steady state, at the latencies ``lat`` (cycles of one add or multiply,
    "op"; of a __ddiv_rn, "div"; of a sin or cos, "trig"; of the per-cell
    kernel's store, barrier and load, "sync").

    Each value's ready time is followed through ``steps`` steps in the
    kernel's order, the look-ahead order of ops/rk.py:rk_step: stage s's
    input is the running sum u + (h a_s0) k_0 + ..., whose last term waits
    for k_(s-1); k_s waits for its input through the field's FIELD_DEPTH
    paths (a per-cell field also for the stage's exchange, after every
    value of the stage was stored); the weight sum starts at its first
    nonzero b_i k_i; then u + h * acc. The ODE kernel rounds each add and
    multiply (a term is two operations); the per-cell kernel contracts
    them (one FMA). Returns the growth of the latest ready time per step
    over the last half of the steps."""
    per_cell = field.name in PER_CELL
    depth = FIELD_DEPTH[field.name]
    extra = MAP_DEPTH if getattr(field, "mn", None) is not None else 0
    L = [[_path_cycles(e, lat, extra) for e in row] for row in depth]
    op = lat["op"]
    term = op if per_cell else 2 * op  # (h a_ij) k_j into a running sum
    S, D = tab.stages, len(L[0])
    u = [0.0] * D
    marks = []
    for _ in range(steps):
        acc = [list(u) for _ in range(S)]
        bsum = None
        for s in range(S):
            v = acc[s]
            if per_cell:
                ready = max(v) + lat["sync"]
                k = [ready + L[0][c] for c in range(D)]
            else:
                k = [max([v[i] + L[i][c] for i in range(D)
                          if L[i][c] is not None], default=0.0)
                     for c in range(D)]
            for i in range(s + 1, S):
                if tab.a[i][s] != 0.0:
                    acc[i] = [max(acc[i][c], k[c] + term - op) + op
                              for c in range(D)]
            if tab.b[s] != 0.0:
                bsum = ([kc + op for kc in k] if bsum is None else
                        [max(bsum[c], k[c] + term - op) + op
                         for c in range(D)])
        u = [max(bsum[c] + term - op, u[c]) + op for c in range(D)]
        marks.append(max(u))
    half = steps // 2
    return (marks[-1] - marks[half - 1]) / (steps - half)


def chain_depth(tab, field):
    """Dependent operations on the longest path through one RK step (a
    division or a sin counted as one; the per-cell exchange not at all)."""
    return chain_cycles(tab, field, UNIT)


def bound(tab, field, B, d, steps, latency):
    """The least time of a fan-out, the largest of three:

    * operations: f64 operations (``flops_per_thread_step``; an FMA counts
      as two) over the 34 TFLOP/s f64 peak, which counts an FMA as two
      operations. The per-slice kernel rounds each add and multiply
      (``Ieee``: no contraction), and an unfused operation issues at half
      that rate, so its operations go over 17 T/s;
    * bytes: each input read once, the output written once, over the
      memory rate;
    * chain: the steps times the dependent chain through one step
      (``chain_cycles``) at the card's measured latencies (``latency``,
      from the probe), over its measured clock: no slice can go faster,
      however many threads the card has.
    """
    threads = B * (d // field.values)
    flops = threads * steps * flops_per_thread_step(tab, field)
    peak = FP64_PEAK if field.name in PER_CELL else FP64_PEAK / 2
    nbytes = 8 * (2 * B + 2 * B * d)
    times = {"operations": flops / peak * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "chain": (steps * chain_cycles(tab, field, chain_latency(
                 latency, field, d)) / latency["clock_hz"] * 1e3)}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by, "flops": flops,
            "operations_ms": times["operations"], "bytes_ms": times["bytes"],
            "chain_ms": times["chain"]}


def chain_latency(latency, field, d):
    """The probe's cycles as chain_cycles takes them for a kernel: its
    fastest arithmetic operation (the ODE kernel's add or multiply, the
    per-cell kernel's add, multiply or FMA), and for the per-cell kernel
    the exchange round of its block."""
    cyc = latency["cycles"]
    if field.name in PER_CELL:
        return {"op": min(cyc["add"], cyc["mul"], cyc["fma"]),
                "div": cyc["div"], "trig": cyc["sin"] - cyc["add"],
                "sync": cyc[f"sync{d // field.values}"]}
    return {"op": min(cyc["add"], cyc["mul"]), "div": cyc["div"],
            "trig": cyc["sin"] - cyc["add"], "sync": 0.0}


def kernel_entry(state, field, max_abs_err, ms, plain_ms, plain_steps, B,
                 d, steps, tab):
    """A kernel's entry of the JSON line; its launches come from its
    path's run."""
    return {"name": f"rk_fanout[{field.name}]", "route": "cuda",
            "source": "nngparareal_torch/csrc/rk_fanout.cu",
            "replaces": "nngparareal_tpu/ops/rk_pallas.py:194",
            "launches": None, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "plain_steps": plain_steps,
            **bound(tab, field, B, d, steps, state["latency"]),
            "library_ms": None, "shape": [B, d], "steps": steps,
            "tableau": tab.name}


def _event_ms(fn, reps, warm=True):
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernel(state, key, ode, t0s, t1s, U, tabs, steps, sizes,
                 coarse=None):
    """Hold a field's kernel against its plain version at 200 steps, for
    each tableau of ``tabs`` (the path's fine tableau last) and each B of
    ``sizes`` (the path's B first), on the last B rows of U; time the
    kernel with the fine tableau at the path's full step count and B, and,
    where ``coarse`` = (tableau, steps) is given, at B=1 with the coarse
    solves' tableau and step count; time the plain version at min(1000,
    steps) steps; record the kernel's entry for the JSON line (its launches
    come from its path's run). The plain version runs once per tableau
    over all the rows: its rows are independent."""
    from nngparareal_torch.ops import rk_cuda
    from nngparareal_torch.ops.butcher import get_tableau
    from nngparareal_torch.ops.rk import make_batched_last_integrator

    field, f = ode.get_device_field(), ode.get_vector_field()
    rows, d = U.shape
    checks = {}
    worst = 0.0
    for name in dict.fromkeys(tabs):
        tab = get_tableau(name)
        want = make_batched_last_integrator(f, tab, CHECK_STEPS)(t0s, t1s, U)
        for B in sizes:
            lo = rows - B
            got = rk_cuda.rk_fanout(t0s[lo:].contiguous(),
                                    t1s[lo:].contiguous(),
                                    U[lo:].contiguous(), tab, CHECK_STEPS,
                                    field, f)
            abs_err = (got - want[lo:]).abs().max().item()
            rel = abs_err / want[lo:].abs().max().item()
            if not (rel <= KERNEL_RTOL):
                raise PhaseError(f"{key} kernel vs plain, {name} at B={B}: "
                                 f"max error {rel:.3e} of max|U| > "
                                 f"{KERNEL_RTOL}")
            checks[f"{name}/B={B}"] = abs_err
            worst = max(worst, abs_err)

    tab, B = get_tableau(tabs[-1]), sizes[0]
    lo = rows - B
    Ub, t0b, t1b = (x[lo:].contiguous() for x in (U, t0s, t1s))
    ms = _event_ms(lambda: rk_cuda.rk_fanout(t0b, t1b, Ub, tab, steps,
                                             field, f), reps=2)
    plain_steps = min(PLAIN_STEPS, steps)
    plain = make_batched_last_integrator(f, tab, plain_steps)
    # once: the comparison above has already run its ops
    plain_ms = _event_ms(lambda: plain(t0b, t1b, Ub), reps=1, warm=False)
    entry = kernel_entry(state, field, worst, ms, plain_ms, plain_steps, B,
                         d, steps, tab)
    info = {"max_abs_err": checks, "ms": ms, "B": B, "steps": steps,
            "tableau": tab.name, "plain_ms": plain_ms,
            "plain_steps": plain_steps,
            **{k: entry[k] for k in ("bound_ms", "bound_by", "chain_ms",
                                     "operations_ms", "flops")}}
    if coarse is not None:
        ctab, csteps = get_tableau(coarse[0]), coarse[1]
        U1, t01, t11 = (x[-1:].contiguous() for x in (U, t0s, t1s))
        cms = _event_ms(lambda: rk_cuda.rk_fanout(t01, t11, U1, ctab, csteps,
                                                  field, f), reps=10)
        cb = bound(ctab, field, 1, d, csteps, state["latency"])
        entry["coarse"] = info["coarse"] = {
            "tableau": ctab.name, "steps": csteps, "ms": cms,
            "bound_ms": cb["bound_ms"], "bound_by": cb["bound_by"],
            "chain_ms": cb["chain_ms"]}
        entry["coarse_ms"] = cms
    state["kernels"][key] = entry
    return info


def check_ode_kernel(state, kind):
    """An ODE field's kernel: u0 plus a seeded perturbation, on slices of
    its configuration's width, with RK8 and the tableaus of its Table-2
    path, at B = N, a ragged 37 and 1 (the coarse solves' shape)."""
    import numpy as np
    import torch
    import nngparareal_torch as nt

    dev = state["device"]
    cls, N_arg = ODE_SYSTEMS[kind]
    ode = getattr(nt, cls)(normalization="-11", device=dev)
    cfg = nt.Config(ode, N=N_arg).get()
    N, d = cfg["N"], ode.get_dim()
    rows = max(N, RAGGED)
    width = (cfg["tspan"][1] - cfg["tspan"][0]) / N
    rng = np.random.default_rng(0)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    U = as_t(ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (rows, d)))
    t0 = as_t(rng.uniform(cfg["tspan"][0], cfg["tspan"][1] - width, rows))
    info = check_kernel(state, kind, ode, t0, t0 + width, U,
                        ("RK8", cfg["G"], cfg["F"]), cfg["Nf"],
                        (N, RAGGED, 1), coarse=(cfg["G"], cfg["Ng"]))
    if kind == "hopf":
        state["kernels"][kind]["b512"] = info["b512"] = time_hopf512(
            state, ode)
    return info


def time_hopf512(state, ode):
    """Hopf at run_hopf's size, the next ODE path: B=512 slices of
    Config(N=512)'s width, its fine step count x 10 000, RK8; one launch
    (seconds long), after the ones above."""
    import numpy as np
    import torch
    import nngparareal_torch as nt
    from nngparareal_torch.ops import rk_cuda
    from nngparareal_torch.ops.butcher import get_tableau

    dev = state["device"]
    field, f = ode.get_device_field(), ode.get_vector_field()
    cfg = nt.Config(nt.Hopf(normalization="-11", device=dev), N=512).get()
    tab, steps, B = get_tableau(cfg["F"]), cfg["Nf"] * HOPF_FINE_MULT, 512
    t = np.linspace(cfg["tspan"][0], cfg["tspan"][1], B + 1)
    rng = np.random.default_rng(1)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    U = as_t(ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0,
                                                    (B, ode.get_dim())))
    t0, t1 = as_t(t[:-1]), as_t(t[1:])
    ms = _event_ms(lambda: rk_cuda.rk_fanout(t0, t1, U, tab, steps, field,
                                             f), reps=1, warm=False)
    return {"B": B, "steps": steps, "tableau": tab.name, "ms": ms,
            **bound(tab, field, B, ode.get_dim(), steps, state["latency"])}


def phase_kernels(state):
    import numpy as np
    import torch
    import nngparareal_torch as nt

    dev = state["device"]
    info = {}

    # Burgers: the flagship's first fan-out, from its coarse chain
    cfg = FLAGSHIP
    ode = nt.Burgers(d_x=cfg["d_x"], normalization="-11", device=dev)
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"],
                         device_field=ode.get_device_field(), device=dev)
    t = torch.linspace(0.0, cfg["T"], cfg["N"] + 1, dtype=torch.float64,
                       device=dev)
    U = solver.run_G_chain(t, ode.get_init_cond())[:-1].contiguous()
    info["burgers"] = check_kernel(state, "burgers", ode, t[:-1], t[1:], U,
                                   (cfg["F"],), cfg["Nf"],
                                   (cfg["N"], RAGGED))

    # FHN-PDE: u0 plus a seeded perturbation, 512 slices of the
    # configuration's width (its coarse chain would take 512 coarse steps)
    from nngparareal_torch.experiments import fhn_pde_parareal

    p = fhn_pde_parareal(FHN_PDE_DX, device=dev)
    rng = np.random.default_rng(0)
    Up = p.ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (p.N, p.n))
    tt = np.linspace(p.tspan[0], p.tspan[1], p.N + 1)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    info["fhn_pde"] = check_kernel(state, "fhn_pde", p.ode, as_t(tt[:-1]),
                                   as_t(tt[1:]), as_t(Up),
                                   (p.solver.F.name,), p.solver.Nf,
                                   (p.N, RAGGED))

    # the ODE fields of the one-thread-per-slice kernel
    for kind in ODE_SYSTEMS:
        info[kind] = check_ode_kernel(state, kind)
    return info


def phase_flagship(state):
    import torch
    import nngparareal_torch as nt

    cfg = FLAGSHIP
    dev = state["device"]
    ode = nt.Burgers(d_x=cfg["d_x"], normalization="-11", device=dev)
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"],
                         device_field=ode.get_device_field(), device=dev)
    p = nt.Parareal(ode, solver, [0.0, cfg["T"]], cfg["N"],
                    epsilon=cfg["eps"], verbose=None, device=dev)
    zero_counts()
    out = p.run(model="nngp", nn=cfg["nn"], seed=cfg["seed"],
                optimizer="grid")
    torch.cuda.synchronize()
    launches = read_counts(state, "burgers")
    state["flagship"] = (p, out)
    tm = out["timings"]
    intervals, per_interval = sweep_stats(out, cfg["N"])
    info = {"K": out["k"], "converged": out["converged"],
            "conv_int": out["conv_int"], "runtime_s": tm["runtime"],
            "fine_s": tm["F_time"], "model_s": tm["mdl_pred_t"],
            "coarse_s": tm["G_time"], "sweep_s": tm["sweep_time"],
            "sweep_share": tm["sweep_time"] / tm["runtime"],
            "intervals": intervals,
            "sweep_ms_per_interval": 1e3 * per_interval,
            "warmup_s": tm["warmup_t"], "total_wall_s": tm["total_wall"],
            "fanout_launches": launches}
    check_iterates("flagship", p, out)
    if not out["converged"] or not K_RANGE[0] <= out["k"] <= K_RANGE[1]:
        raise PhaseError(f"flagship: converged={out['converged']} K="
                         f"{out['k']}, expected convergence with K in "
                         f"{list(K_RANGE)}")
    return info


def zero_counts():
    """Set every kernel's launch count to 0, just before a path runs."""
    from nngparareal_torch.ops import rk_cuda

    rk_cuda.rk_fanout.launches = 0
    for name in rk_cuda.rk_fanout.launches_by_field:
        rk_cuda.rk_fanout.launches_by_field[name] = 0
    rk_cuda.rk_fanout.launches_by_shape.clear()


def record_launches(state, field):
    """A path's launches of its field's kernel into the kernel's entry:
    the total, and by (tableau, steps): its fine fan-outs and its coarse
    solves."""
    from nngparareal_torch.ops import rk_cuda

    entry = state["kernels"][field]
    entry["launches"] = rk_cuda.rk_fanout.launches_by_field[field]
    entry["launches_by_shape"] = {
        f"{tab} x {steps}": n for (name, tab, steps), n
        in rk_cuda.rk_fanout.launches_by_shape.items() if name == field}
    return entry["launches"]


def read_counts(state, field):
    """Read the counts just after a path ran; its field's kernel must have
    launched, and no other."""
    from nngparareal_torch.ops import rk_cuda

    counts = dict(rk_cuda.rk_fanout.launches_by_field)
    if counts[field] < 1:
        raise PhaseError(f"the {field} fan-out kernel was not launched on "
                         f"its path: {counts}")
    others = {k: v for k, v in counts.items() if k != field and v}
    if others or rk_cuda.rk_fanout.launches != counts[field]:
        raise PhaseError(f"the {field} path launched other kernels: {counts}")
    return record_launches(state, field)


def sweep_stats(out, N):
    """Active intervals swept (N - (I + 1) in each iteration that swept)
    and the sweep's wall per interval."""
    starts = [0] + out["conv_int"][:-1]
    intervals = sum(N - (i + 1) for i in starts if i + 1 < N)
    return intervals, out["timings"]["sweep_time"] / max(intervals, 1)


def phase_fhn_pde(state):
    import torch
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal

    dev = state["device"]
    kept = []
    run = keep_runs(kept)
    try:
        zero_counts()
        rows = experiments.run_fhn_pde(
            FHN_PDE_DX, models=("nngp",), results_dir=None,
            nngp_kw=dict(optimizer="grid"), device=dev)
        torch.cuda.synchronize()
        launches = read_counts(state, "fhn_pde")
    finally:
        Parareal.run = run
    (p, out), = kept
    state["fhn_pde"] = (p, out)
    row = rows[0]
    tm = out["timings"]
    intervals, per_interval = sweep_stats(out, p.N)
    info = {"K": row["k"], "converged": row["converged"],
            "conv_int": row["conv_int"], "runtime_s": row["runtime"],
            "fine_s": tm["F_time"], "model_s": tm["mdl_pred_t"],
            "coarse_s": tm["G_time"], "coarse_init_s": tm["G_init_time"],
            "sweep_s": tm["sweep_time"],
            "sweep_share": tm["sweep_time"] / tm["runtime"],
            "intervals": intervals,
            "sweep_s_per_interval": per_interval,
            "est_serial_s": row["est_serial"], "calc_speedup": row["speedup"],
            "warmup_s": tm["warmup_t"], "total_wall_s": tm["total_wall"],
            "fanout_launches": launches}
    check_iterates("fhn_pde", p, out)
    lo, hi = FHN_PDE_K_RANGE
    if not row["converged"] or not lo <= row["k"] <= hi:
        raise PhaseError(f"fhn_pde: converged={row['converged']} K="
                         f"{row['k']}, expected convergence with K in "
                         f"{list(FHN_PDE_K_RANGE)}")
    return info


def keep_runs(kept):
    """Make Parareal.run append (its Parareal, its output) to ``kept``:
    the drivers' summary rows hold no iterates, and the serial phase
    checks them. Returns the unwrapped run."""
    from nngparareal_torch.driver import Parareal

    run = Parareal.run

    def keep(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        kept.append((self, out))
        return out

    Parareal.run = keep
    return run


def run_info(out, N):
    """K, conv_int, the runtime and its split of one run."""
    tm = out["timings"]
    intervals, per_interval = sweep_stats(out, N)
    return {"K": out["k"], "converged": out["converged"],
            "conv_int": out["conv_int"], "runtime_s": tm["runtime"],
            "fine_s": tm["F_time"], "model_s": tm["mdl_pred_t"],
            "coarse_s": tm["G_time"], "coarse_init_s": tm["G_init_time"],
            "sweep_s": tm["sweep_time"], "intervals": intervals,
            "sweep_ms_per_interval": 1e3 * per_interval}


def check_iterates(name, p, out):
    """A run's iterates: (N + 1, d), all finite."""
    import numpy as np

    u = out["u"]
    if u.shape != (p.N + 1, p.n) or not np.isfinite(u).all():
        raise PhaseError(f"{name} iterates: shape {u.shape}, "
                         f"finite={bool(np.isfinite(u).all())}")


def phase_table2(state):
    import torch
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal
    from nngparareal_torch.ops import rk_cuda

    dev = state["device"]
    # each system's launches: the counts set to 0 just before it runs and
    # read just after
    per_system = experiments._run_table2_system
    counts = {}

    def counted(*args, **kwargs):
        zero_counts()
        row = per_system(*args, **kwargs)
        torch.cuda.synchronize()
        counts[row["system"]] = dict(rk_cuda.rk_fanout.launches_by_field)
        record_launches(state, TABLE2[row["system"]][0])
        return row

    kept = []
    run = keep_runs(kept)
    experiments._run_table2_system = counted
    try:
        rows = experiments.run_table2(
            TABLE2_EPS, models=("parareal", "nngp"), results_dir=None,
            nngp_kw=dict(optimizer="grid"), device=dev)
    finally:
        experiments._run_table2_system = per_system
        Parareal.run = run
    if [r["system"] for r in rows] != list(TABLE2):
        raise PhaseError(f"table2 ran {[r['system'] for r in rows]}")
    info = {}
    failures = []
    for row, runs in zip(rows, zip(kept[0::2], kept[1::2])):
        system = row["system"]
        field, bare_k, (lo, hi), grid_k = TABLE2[system]
        launches = counts[system]
        others = {k: v for k, v in launches.items() if k != field and v}
        if launches[field] < 1 or others:
            raise PhaseError(f"{system}: its path must launch the {field} "
                             f"kernel and no other: {launches}")
        sys_info = {"launches": launches[field],
                    "launches_by_shape":
                        state["kernels"][field]["launches_by_shape"]}
        for (p, out), model in zip(runs, ("parareal", "nngp")):
            check_iterates(f"{system} {model}", p, out)
            sys_info[model] = run_info(out, p.N)
            state.setdefault("table2", []).append((f"{system} {model}", p,
                                                   out))
            k = out["k"]
            ok = out["converged"] and (
                k == bare_k if model == "parareal" else lo <= k <= hi)
            if not ok:
                failures.append(f"{system} {model}: converged="
                                f"{out['converged']} K={k}")
        sys_info["nngp_K_vs_cpu_grid"] = sys_info["nngp"]["K"] - grid_k
        info[system] = sys_info
    if failures:
        raise PhaseError("table2 K outside its limits: "
                         + "; ".join(failures))
    info["ThomasLabyrinth_32"] = run_tomlab(state)
    return info


def run_tomlab(state):
    """ThomasLabyrinth N=32 (tspan [0, 10], RK1 x10 / RK4 x31 250 per
    slice) with the parareal model: the path of the tomlab field's kernel.
    Its K must be the JAX package's on the CPU (30)."""
    import torch
    import nngparareal_torch as nt

    dev = state["device"]
    ode = nt.ThomasLabyrinth(normalization="-11", device=dev)
    cfg = nt.Config(ode, N=32).get()
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"],
                         device_field=ode.get_device_field(), device=dev)
    p = nt.Parareal(ode, solver, cfg["tspan"], cfg["N"], epsilon=TABLE2_EPS,
                    verbose=None, device=dev)
    zero_counts()
    out = p.run(model="parareal")
    torch.cuda.synchronize()
    launches = read_counts(state, "tomlab")
    check_iterates("ThomasLabyrinth_32", p, out)
    if not out["converged"] or out["k"] != TOMLAB_K:
        raise PhaseError(f"ThomasLabyrinth_32 parareal: converged="
                         f"{out['converged']} K={out['k']}, expected "
                         f"{TOMLAB_K}")
    state["table2"].append(("ThomasLabyrinth_32 parareal", p, out))
    return {"launches": launches, "parareal": run_info(out, p.N)}


def phase_serial(state):
    import numpy as np
    import torch

    # Burgers: one slice after another from u0
    p, out = state["flagship"]
    t = out["t"]
    u = p.u0
    rows = [u]
    tic = time.perf_counter()
    for i in range(p.N):
        u = p.solver.run_F_batch(t[i:i + 1], t[i + 1:i + 2], u[None])[0]
        rows.append(u)
    serial = torch.stack(rows).cpu().numpy()
    serial_s = time.perf_counter() - tic
    err = float(np.abs(serial - out["u"]).max())
    if not err <= SERIAL_ATOL:
        raise PhaseError(f"flagship vs serial fine: max |du| {err:.3e} > "
                         f"{SERIAL_ATOL}")
    info = {"burgers": {
        "max_abs_diff": err, "serial_fine_s": serial_s,
        "speedup_vs_serial_fine": serial_s / out["timings"]["runtime"]}}

    # FHN-PDE: every slice's fine solve from its converged start, in one
    # kernel fan-out, against the converged end of that slice
    p, out = state["fhn_pde"]
    t, u = out["t"], out["u"]
    tic = time.perf_counter()
    ends = p.solver.run_F_batch(t[:-1], t[1:], u[:-1]).cpu().numpy()
    fan_s = time.perf_counter() - tic
    err = float(np.abs(ends - u[1:]).max())
    if not err <= SERIAL_ATOL:
        raise PhaseError(f"fhn_pde vs fine solves from the converged starts:"
                         f" max |du| {err:.3e} > {SERIAL_ATOL}")
    info["fhn_pde"] = {"max_abs_diff": err, "fanout_s": fan_s}
    info["table2"] = serial_table2(state)
    return info


def serial_table2(state):
    """Each Table-2 run's converged iterates against one kernel fan-out
    from its converged starts."""
    import numpy as np

    info = {}
    for name, p, out in state["table2"]:
        t, u = out["t"], out["u"]
        ends = p.solver.run_F_batch(t[:-1], t[1:], u[:-1]).cpu().numpy()
        err = float(np.abs(ends - u[1:]).max())
        if not err <= SERIAL_ATOL:
            raise PhaseError(f"{name} vs fine solves from the converged "
                             f"starts: max |du| {err:.3e} > {SERIAL_ATOL}")
        info[name] = err
    return info


def main():
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is missing: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import nngparareal_torch
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    pkg_dir = os.path.dirname(os.path.abspath(nngparareal_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: found nngparareal_torch at {pkg_dir}, not beside "
              "this script", file=sys.stderr)
        return 2

    phases = Phases()

    def on_alarm(signum, frame):
        raise PhaseError(f"deadline of {DEADLINE_S}s hit in phase "
                         f"'{phases.current}'")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(DEADLINE_S)
    state = {"device": torch.device("cuda", 0), "kernels": {}}
    t_start = time.perf_counter()
    try:
        env = phases.run("env", phase_env)
        phases.run("build", phase_build, state)
        phases.run("kernels", phase_kernels, state)
        phases.run("flagship", phase_flagship, state)
        phases.run("fhn_pde", phase_fhn_pde, state)
        phases.run("table2", phase_table2, state)
        phases.run("serial", phase_serial, state)
    except Exception as exc:  # report the phase, exit nonzero
        signal.alarm(0)
        print(f"chip_smoke: FAILED in phase '{phases.current}': "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        import traceback

        traceback.print_exc()
        return 1
    signal.alarm(0)
    print(f"[total] {time.perf_counter() - t_start:.3f}s", flush=True)
    print(json.dumps({"kernels": list(state["kernels"].values())}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
