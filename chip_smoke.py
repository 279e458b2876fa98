#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nngparareal_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it ends with its seconds:

1. env       torch and CUDA versions, the card, its power limit.
2. build     nvcc builds the fan-out kernel from csrc/rk_fanout.cu, and
             prints the compiler's register and spill report.
3. kernels   the kernel against its plain torch version, for each field
             at its path's shapes (max error relative to max|U| must be
             <= 1e-12, RK8, 200 steps): Burgers d=128 at B=128 and a
             ragged B=37; FHN-PDE dx=16 (d=512) at B=512 and B=37, from
             u0 plus a seeded perturbation, on slices of the
             configuration's width. Then each kernel's time at its full
             step count (40 000 and 195 325), the plain version's time
             at 1000 steps (as measured, never scaled up), and the bound.
4. flagship  the port's first path: Burgers d=128 nnGParareal
             (bench.py:90-121: N=128 over [0, 5.9], RK1 x4 / RK8 x40000
             per slice, m=18, grid search, seed 45, eps=5e-7) through
             Parareal.run. It must converge with 10 <= K <= 14, and the
             Burgers kernel must have run in it. The run's first
             corrector sweep keeps a copy of its inputs; after the run it
             is replayed once for its wall time and once under
             torch.profiler for its launches and device time.
5. fhn_pde   the second path: the FHN-PDE d-scaling run at dx=16 (d=512,
             N=512 over [0, 1100], RK4 x25 / RK8 x195 325 per slice,
             nnGP nn=20, grid search, seed 45, eps=5e-7) through
             experiments.run_fhn_pde. It must converge with 4 <= K <= 7,
             and the FHN-PDE kernel must have run in it.
6. serial    both runs' converged iterates against serial fine solves,
             slice by slice (atol 2e-5, as tests/test_parareal.py holds
             the JAX package): Burgers one slice after another from u0,
             FHN-PDE with one kernel fan-out from the converged starts.

Then one JSON line describing each kernel, the card's name and power limit
as nvidia-smi prints them, and as the last line
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
KERNEL_RTOL = 1e-12
K_RANGE = (10, 14)
FHN_PDE_K_RANGE = (4, 7)
SERIAL_ATOL = 2e-5

# f64 operations of one field evaluation, per thread of the kernel (one
# grid point of Burgers, one cell of FHN-PDE with both species), counted
# from csrc/rk_fanout.cu
FIELD_OPS = {"burgers": 9, "fhn_pde": 29}


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
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
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


def phase_build():
    from nngparareal_torch.ops import rk_cuda

    lib = rk_cuda.library_path()
    fresh = not lib.exists()
    tic = time.perf_counter()
    rk_cuda.build()
    build_s = time.perf_counter() - tic
    # the compiler's resource report (registers, spills) for the record
    obj = lib.with_suffix(".ptxas.o")
    proc = subprocess.run(
        [rk_cuda.find_nvcc(), *[f for f in rk_cuda.NVCC_FLAGS
                                if f not in ("-shared",)],
         "-Xptxas", "-v", "-c", "-o", str(obj), str(rk_cuda.SOURCE)],
        capture_output=True, text=True, timeout=300)
    obj.unlink(missing_ok=True)
    return {"library": os.path.relpath(lib, HERE), "fresh": fresh,
            "build_s": round(build_s, 3),
            "ptxas": ptxas_report(proc.stderr)}


def ptxas_report(text):
    """Registers and spills of each kernel instance, keyed by field and
    stage count, from ``-Xptxas -v`` output."""
    report = {}
    key = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            stages = re.search(r"ILi(\d+)E", m.group(1))
            field = "fhn_pde" if "FhnPdeField" in m.group(1) else "burgers"
            key = f"{field}/{stages.group(1) if stages else '?'} stages"
            report[key] = {}
        elif key and "spill" in ln:
            report[key]["spills"] = ln.split(":", 1)[-1].strip()
        elif key and "registers" in ln:
            report[key]["registers"] = ln.split(":", 1)[-1].strip()
    return report or text.strip().splitlines()[-5:]


def flops_per_thread_step(tab, field):
    """f64 operations per kernel thread per RK step: one field evaluation
    per stage (9 for a Burgers point; 29 for an FHN-PDE cell: two 5-point
    Laplacians of 9, the u1 reaction 7, the u2 reaction 4), and for each
    state value of the thread 2 per nonzero a_ij and b_i and 2 for the
    step update."""
    nz_a = sum(1 for row in tab.a for x in row if x != 0.0)
    nz_b = sum(1 for x in tab.b if x != 0.0)
    return (FIELD_OPS[field.name] * tab.stages
            + field.values * (2 * nz_a + 2 * nz_b + 2))


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


def check_kernel(state, ode, t0s, t1s, U, steps, ragged):
    """Hold the kernel against its plain version at 200 steps (all slices
    and the last ``ragged`` ones), time both, and record the kernel's
    entry for the JSON line (its launches come from its path's run)."""
    from nngparareal_torch.ops import rk_cuda
    from nngparareal_torch.ops.butcher import get_tableau
    from nngparareal_torch.ops.rk import make_batched_last_integrator

    field = ode.get_device_field()
    f = ode.get_vector_field()
    tab = get_tableau("RK8")
    B, d = U.shape

    def compare(lo):
        args = (t0s[lo:].contiguous(), t1s[lo:].contiguous(),
                U[lo:].contiguous())
        got = rk_cuda.rk_fanout(*args, tab, CHECK_STEPS, field, f)
        # the plain version integrates the system's own torch field
        want = make_batched_last_integrator(f, tab, CHECK_STEPS)(*args)
        abs_err = (got - want).abs().max().item()
        rel = abs_err / want.abs().max().item()
        if not (rel <= KERNEL_RTOL):
            raise PhaseError(f"{field.name} kernel vs plain at B={B - lo}: "
                             f"max error {rel:.3e} of max|U| > {KERNEL_RTOL}")
        return {"B": B - lo, "max_abs_err": abs_err, "max_rel_err": rel}

    full = compare(0)
    part = compare(max(B - ragged, 0))

    ms = _event_ms(
        lambda: rk_cuda.rk_fanout(t0s, t1s, U, tab, steps, field, f), reps=2)
    # the plain version over PLAIN_STEPS steps, once: the comparison above
    # has already run its ops
    plain = make_batched_last_integrator(f, tab, PLAIN_STEPS)
    plain_ms = _event_ms(lambda: plain(t0s, t1s, U), reps=1, warm=False)
    flops = B * (d // field.values) * steps * flops_per_thread_step(tab, field)
    nbytes = 8 * (2 * B + 2 * B * d + tab.stages * (tab.stages + 1))
    flop_ms = flops / FP64_PEAK * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    entry = {
        "name": f"rk_fanout[{field.name}]",
        "route": "cuda",
        "source": "nngparareal_torch/csrc/rk_fanout.cu",
        "replaces": "nngparareal_tpu/ops/rk_pallas.py:194",
        "launches": None,  # filled in from the path's run
        "max_abs_err": full["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "plain_steps": PLAIN_STEPS,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
        "shape": [B, d],
        "steps": steps,
        "flops": flops,
    }
    state["kernels"][field.name] = entry
    return {"all": full, "ragged": part, "ms": ms, "steps": steps,
            "plain_ms": plain_ms, "plain_steps": PLAIN_STEPS,
            "bound_ms": entry["bound_ms"], "flops": flops}


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
    info["burgers"] = check_kernel(state, ode, t[:-1].contiguous(),
                                   t[1:].contiguous(), U, cfg["Nf"], 37)

    # FHN-PDE: u0 plus a seeded perturbation, 512 slices of the
    # configuration's width (its coarse chain would take 512 coarse steps)
    from nngparareal_torch.experiments import fhn_pde_parareal

    p = fhn_pde_parareal(FHN_PDE_DX, device=dev)
    rng = np.random.default_rng(0)
    Up = p.ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (p.N, p.n))
    tt = np.linspace(p.tspan[0], p.tspan[1], p.N + 1)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    info["fhn_pde"] = check_kernel(state, p.ode, as_t(tt[:-1]),
                                   as_t(tt[1:]), as_t(Up).contiguous(),
                                   p.solver.Nf, 37)
    return info


def keep_first_sweep(p):
    """Make the run's first corrector sweep keep a copy of its inputs and
    outputs (a few device copies, no host sync) for a replay after the
    run; returns the unwrapped sweep and the dict that receives them."""
    from nngparareal_torch.models import Dataset

    sweep = p._sweep
    kept = {}

    def first_kept(model, ds, I, *rest):
        out = sweep(model, ds, I, *rest)
        if not kept:
            *tensors, clip = rest
            kept["args"] = (model, Dataset(ds.X.clone(), ds.D.clone(),
                                           ds.valid.clone()), I,
                            *[x.clone() for x in tensors], clip)
            kept["out"] = [x.clone() for x in out]
        return out

    p._sweep = first_kept
    return sweep, kept


def profile_sweep(sweep, kept, N):
    """Replay one kept sweep: once for its wall time, once under
    torch.profiler for its kernel launches and the card's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = kept["args"]
    intervals = N - args[2]
    with torch.inference_mode():
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = sweep(*args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - tic
        replay_diff = max(float((a - b).abs().max())
                          for a, b in zip(out, kept["out"]))
        # the card's activity only: nothing here reads the host's ops
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sweep(*args)
            torch.cuda.synchronize()
    kernels = copies = 0
    busy_ns = 0
    # the raw events: the profiler's per-op event tree, slow to build for
    # a few hundred thousand launches, is not needed for sums and counts
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            if e.name().startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    busy_s = busy_ns * 1e-9
    return {"intervals": intervals, "wall_s": wall_s,
            "replay_max_abs_diff": replay_diff,
            "kernels": kernels, "copies": copies,
            "kernels_per_interval": kernels / intervals,
            "device_busy_s": busy_s,
            "device_busy_ms_per_interval": 1e3 * busy_s / intervals,
            "wall_ms_per_interval": 1e3 * wall_s / intervals,
            "device_idle_share": (1.0 - busy_s / wall_s if busy_s > 0
                                  else "not measured")}


def phase_flagship(state):
    import numpy as np
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
    sweep, kept = keep_first_sweep(p)
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
    u = out["u"]
    if u.shape != (cfg["N"] + 1, cfg["d_x"]) or not np.isfinite(u).all():
        raise PhaseError(f"flagship iterates: shape {u.shape}, "
                         f"finite={bool(np.isfinite(u).all())}")
    if not out["converged"] or not K_RANGE[0] <= out["k"] <= K_RANGE[1]:
        raise PhaseError(f"flagship: converged={out['converged']} K="
                         f"{out['k']}, expected convergence with K in "
                         f"{list(K_RANGE)}")
    info["first_sweep_profile"] = profile_sweep(sweep, kept, cfg["N"])
    return info


def zero_counts():
    """Set every kernel's launch count to 0, just before a path runs."""
    from nngparareal_torch.ops import rk_cuda

    rk_cuda.rk_fanout.launches = 0
    for name in rk_cuda.rk_fanout.launches_by_field:
        rk_cuda.rk_fanout.launches_by_field[name] = 0


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
    state["kernels"][field]["launches"] = counts[field]
    return counts[field]


def sweep_stats(out, N):
    """Active intervals swept (N - (I + 1) in each iteration that swept)
    and the sweep's wall per interval."""
    starts = [0] + out["conv_int"][:-1]
    intervals = sum(N - (i + 1) for i in starts if i + 1 < N)
    return intervals, out["timings"]["sweep_time"] / max(intervals, 1)


def phase_fhn_pde(state):
    import numpy as np
    import torch
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal

    dev = state["device"]
    # keep the run's Parareal and its output: the summary rows hold no
    # iterates, and the serial phase checks them
    kept = {}
    run = Parareal.run

    def keep(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        kept["run"] = (self, out)
        return out

    Parareal.run = keep
    try:
        zero_counts()
        rows = experiments.run_fhn_pde(
            FHN_PDE_DX, models=("nngp",), results_dir=None,
            nngp_kw=dict(optimizer="grid"), device=dev)
        torch.cuda.synchronize()
        launches = read_counts(state, "fhn_pde")
    finally:
        Parareal.run = run
    p, out = kept["run"]
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
    u = out["u"]
    if u.shape != (p.N + 1, p.n) or not np.isfinite(u).all():
        raise PhaseError(f"fhn_pde iterates: shape {u.shape}, "
                         f"finite={bool(np.isfinite(u).all())}")
    lo, hi = FHN_PDE_K_RANGE
    if not row["converged"] or not lo <= row["k"] <= hi:
        raise PhaseError(f"fhn_pde: converged={row['converged']} K="
                         f"{row['k']}, expected convergence with K in "
                         f"{list(FHN_PDE_K_RANGE)}")
    return info


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
        phases.run("build", phase_build)
        phases.run("kernels", phase_kernels, state)
        phases.run("flagship", phase_flagship, state)
        phases.run("fhn_pde", phase_fhn_pde, state)
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
