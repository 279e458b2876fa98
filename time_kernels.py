#!/usr/bin/env python3
"""Time the fine fan-out kernels of one or more checkouts of the port, in
turns, at every path shape, on one CUDA card.

    python3 time_kernels.py [TREE ...] [--ds] [--out FILE]
    python3 time_kernels.py --sass [TREE]

Each TREE is a directory that holds an ``nngparareal_torch`` package (by
default ``.``). Each is timed in a process of its own, in the order given,
so that ``python3 time_kernels.py parent_checkout . . parent_checkout``
times a parent commit's kernels and this tree's in turns (old, new, new,
old) on one card. Unpack the parent's port first, into the git-ignored
``parent_checkout/``:

    mkdir -p parent_checkout
    git archive <commit> nngparareal_torch | tar -x -C parent_checkout

A process builds its tree's kernels (in that tree's ``_build``), then
launches each shape through the tree's own ``rk_fanout`` and times it with
CUDA events (one warm-up launch, then the mean of ``reps`` launches): the
shapes of the paths of ``chip_smoke.py``, Burgers (128, 128) RK8 x 40 000,
FHN-PDE (512, 512) RK8 x 195 325, each ODE field at B = its
configuration's N with its fine tableau and steps and at B=1 with its
coarse ones, and Hopf (512, 3) RK8 x 3.4e6. The inputs are each system's
u0 plus a seeded perturbation, the same in every process. Every run's
results are compared with the first run's (max |difference| relative to
max |U|). Prints one JSON object per run, then a table of the times;
``--out`` also writes all of it as JSON. Exits 2 without a card.

``--ds`` times the double-single kernel instead (``rk_cuda_ds.ds_fanout``,
``fine='pallas'``) at the nine shapes of chip_smoke.py's ds phase: Burgers
(128, 128) RK8 x 40 000, FHN-PDE (512, 512) RK8 at 1/8 of its 195 325
steps, each ODE field at its configuration's B, fine tableau and steps,
every slice at the width of the configuration's slices. Every kernel of
the port gives its plain version's bits, so the runs must agree exactly.

``--sass`` builds TREE's kernels (default ``.``) and reads the double-
single libraries' machine code with ``cuobjdump -sass``: per kernel
instance its instructions, branches, calls, barriers, exchanges, f32
divisions' checks and local-memory accesses (JSON, one line per library);
the whole listing goes to ``chiprun_out/sass/``. Then it times each ODE
field's ds kernel at RK4 and RK8 (B=32, 2000 steps): cycles a step
beside the instance's instruction count and code size.
"""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))

# kind: (system, Config's N); the Table-2 systems, ThomasLabyrinth at N=32
ODES = {"fhn_ode": ("FHNODE", None), "rossler": ("Rossler", None),
        "hopf": ("Hopf", 32), "dblpend": ("DblPend", None),
        "brusselator": ("Brusselator", None), "lorenz": ("Lorenz", None),
        "tomlab": ("ThomasLabyrinth", 32)}
HOPF_FINE_MULT = 10000  # run_hopf's fine steps: Config(N=512)'s Nf x 10000


def shapes(nt, dev):
    """(name, system, device field, t0s, t1s, U, tableau, steps, reps) for
    every path shape."""
    import numpy as np
    import torch

    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)

    def around(ode, B, lo, hi, seed):
        rng = np.random.default_rng(seed)
        U = ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0,
                                                   (B, ode.get_dim()))
        t = np.linspace(lo, hi, B + 1)
        return as_t(t[:-1]), as_t(t[1:]), as_t(U).contiguous()

    out = []
    ode = nt.Burgers(d_x=128, normalization="-11", device=dev)
    out.append(("burgers", ode, *around(ode, 128, 0.0, 5.9, 0), "RK8",
                40000, 3))
    ode = nt.FHNPDE(d_x=16, normalization="-11", device=dev)
    out.append(("fhn_pde", ode, *around(ode, 512, 0.0, 1100.0, 0), "RK8",
                195325, 1))
    for kind, (cls, N) in ODES.items():
        ode = getattr(nt, cls)(normalization="-11", device=dev)
        cfg = nt.Config(ode, N=N).get()
        lo, hi = cfg["tspan"]
        t0, t1, U = around(ode, cfg["N"], lo, hi, 0)
        out.append((f"{kind}/fine", ode, t0, t1, U, cfg["F"], cfg["Nf"],
                    3))
        out.append((f"{kind}/coarse", ode, t0[:1].contiguous(),
                    t1[:1].contiguous(), U[:1].contiguous(), cfg["G"],
                    cfg["Ng"], 20))
    ode = nt.Hopf(normalization="-11", device=dev)
    cfg = nt.Config(ode, N=512).get()
    out.append(("hopf512", ode, *around(ode, 512, *cfg["tspan"], 1),
                cfg["F"], cfg["Nf"] * HOPF_FINE_MULT, 1))
    return out


DS_FHN_PDE_CUT = 8  # chip_smoke.py's: FHN-PDE at 1/8 of its steps


def ds_shapes(nt, dev):
    """(name, system, U, step width, tableau, steps, reps) for the ds
    kernel at the ds phase's shapes."""
    import numpy as np
    import torch

    def around(ode, B, seed=0):
        rng = np.random.default_rng(seed)
        U = ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0,
                                                   (B, ode.get_dim()))
        return torch.as_tensor(U, dtype=torch.float64, device=dev)

    out = []
    ode = nt.Burgers(d_x=128, normalization="-11", device=dev)
    out.append(("burgers", ode, around(ode, 128), 5.9 / 128 / 40000, "RK8",
                40000, 3))
    ode = nt.FHNPDE(d_x=16, normalization="-11", device=dev)
    steps = 195325
    out.append(("fhn_pde/8", ode, around(ode, 512), 1100.0 / 512 / steps,
                "RK8", steps // DS_FHN_PDE_CUT, 1))
    for kind, (cls, N) in ODES.items():
        ode = getattr(nt, cls)(normalization="-11", device=dev)
        cfg = nt.Config(ode, N=N).get()
        lo, hi = cfg["tspan"]
        out.append((kind, ode, around(ode, cfg["N"]),
                    (hi - lo) / cfg["N"] / cfg["Nf"], cfg["F"], cfg["Nf"],
                    3))
    return out


def fanouts(nt, dev, ds):
    """(name, launch, reps) of every shape: the f64 kernel's, or with
    ``ds`` the double-single kernel's."""
    from nngparareal_torch.ops import rk_cuda, rk_cuda_ds

    runs = []
    if ds:
        for name, ode, U, dt, tab, steps, reps in ds_shapes(nt, dev):
            field, f_ds = ode.get_device_field(), ode.get_ds_vector_field()
            runs.append((name, lambda U=U, dt=dt, tab=tab, steps=steps,
                         field=field, f_ds=f_ds: rk_cuda_ds.ds_fanout(
                             U, tab, steps, dt, field, f_ds), reps))
        return runs
    for name, ode, t0, t1, U, tab, steps, reps in shapes(nt, dev):
        field, f = ode.get_device_field(), ode.get_vector_field()
        runs.append((name, lambda t0=t0, t1=t1, U=U, tab=tab, steps=steps,
                     field=field, f=f: rk_cuda.rk_fanout(
                         t0, t1, U, tab, steps, field, f), reps))
    return runs


def worker(tree, results_path, ds=False):
    """Time every shape with the kernels of ``tree``; write the results
    (times and outputs) to ``results_path``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import nngparareal_torch as nt
    from nngparareal_torch.ops import rk_cuda

    pkg = os.path.dirname(os.path.abspath(nt.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise RuntimeError(f"imported {pkg}, not the one in {tree}")
    dev = torch.device("cuda", 0)
    rk_cuda.build()
    times, outs = {}, {}
    for name, run, reps in fanouts(nt, dev, ds):
        outs[name] = run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(stop) / reps
    torch.save({"tree": tree, "ms": times,
                "out": {k: v.cpu() for k, v in outs.items()}}, results_path)


# the SASS opcodes counted per kernel instance, by what they show
SASS_COUNTS = {"branches": ("BRA",), "calls": ("CALL",),
               "barriers": ("BAR",), "exchanges": ("SHFL",),
               "div_checks": ("FCHK",), "local": ("LDL", "STL"),
               "ffma": ("FFMA",), "fadd": ("FADD",), "fmul": ("FMUL",)}


def sass(tree):
    """Build ``tree``'s kernels and summarise each double-single kernel
    instance's machine code (cuobjdump -sass); the listings go to
    chiprun_out/sass/."""
    import re

    sys.path.insert(0, os.path.abspath(tree))
    from nngparareal_torch.ops import rk_cuda

    rk_cuda.build()
    cuobjdump = os.path.join(os.path.dirname(rk_cuda.find_nvcc()),
                             "cuobjdump")
    outdir = os.path.join(HERE, "chiprun_out", "sass")
    os.makedirs(outdir, exist_ok=True)
    summaries = {}
    for name in rk_cuda.LIBRARIES:
        if name == "rk_fanout":
            continue
        text = subprocess.run([cuobjdump, "-sass",
                               str(rk_cuda.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        with open(os.path.join(outdir, f"{name}.sass"), "w") as fh:
            fh.write(text)
        summary = {}
        for chunk in re.split(r"\n\s*Function : ", text)[1:]:
            fn, body = chunk.split("\n", 1)
            tab = re.search(r"tableau\d+(RK\d+)", fn)
            mapped = re.search(r"SliceField.*?Lb([01])E", fn)
            key = "/".join([("cells" if "cells" in fn else "slice"),
                            tab.group(1) if tab else fn[-16:]]
                           + ([("raw", "map")[int(mapped.group(1))]]
                              if mapped else []))
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9]*)", body)
            summary[key] = {"instructions": len(ops), **{
                k: sum(op in v for op in ops)
                for k, v in SASS_COUNTS.items()}}
        print(json.dumps({"library": name, "instances": summary}),
              flush=True)
        summaries[name] = summary
    code_size_rates(summaries)


def code_size_rates(summaries, B=32, steps=2000):
    """Each ODE field's ds kernel ([-1,1]-mapped) at RK4 and at RK8, B
    slices of ``steps`` steps: the time and the cycles a step (at the
    clock of the latency probe's add chain) beside the instance's SASS
    instructions and code size (16 bytes an instruction). Where the
    stages are unrolled, the instructions are those of one step."""
    import numpy as np
    import torch
    import nngparareal_torch as nt
    from nngparareal_torch.ops import rk_cuda, rk_cuda_ds

    dev = torch.device("cuda", 0)
    n = 1 << 20
    rk_cuda.latency_probe("add", n=1 << 12)
    cycles, ms = rk_cuda.latency_probe("add", n=n)
    clock_hz = cycles * n / (ms * 1e-3)
    for kind, (cls, _) in ODES.items():
        ode = getattr(nt, cls)(normalization="-11", device=dev)
        rng = np.random.default_rng(0)
        U = torch.as_tensor(ode.u0[None, :] + 0.05 * rng.uniform(
            -1.0, 1.0, (B, ode.get_dim())), dtype=torch.float64, device=dev)
        field, f_ds = ode.get_device_field(), ode.get_ds_vector_field()
        out = {}
        for tab in ("RK4", "RK8"):
            run = lambda: rk_cuda_ds.ds_fanout(U, tab, steps, 1e-4, field,
                                               f_ds)
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            step_ns = start.elapsed_time(stop) * 1e6 / steps
            instr = summaries[f"ds_fanout_{kind}"][f"slice/{tab}/map"][
                "instructions"]
            out[tab] = {"ns_per_step": step_ns,
                        "cycles_per_step": step_ns * 1e-9 * clock_hz,
                        "instructions": instr, "code_kb": instr * 16 / 1024}
        print(json.dumps({"field": kind, "B": B, "steps": steps,
                          "clock_hz": clock_hz, **out}), flush=True)


def main(argv):
    out_path = None
    if "--out" in argv:
        k = argv.index("--out")
        out_path = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    ds = "--ds" in argv
    argv = [a for a in argv if a != "--ds"]
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2], ds)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--sass"]:
        sass(argv[1] if len(argv) > 1 else ".")
        return 0
    trees = argv or ["."]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for n, tree in enumerate(trees):
            path = os.path.join(tmp, f"run{n}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", tree, path]
                           + (["--ds"] if ds else []), check=True, cwd=HERE)
            runs.append(torch.load(path))
    for n, (tree, res) in enumerate(zip(trees, runs)):
        first = runs[0]["out"]
        res["max_rel_diff_vs_run0"] = {
            k: ((v - first[k]).abs().max() / first[k].abs().max()).item()
            for k, v in res["out"].items()}
        print(json.dumps({"run": n, "tree": tree, "ms": res["ms"],
                          "max_rel_diff_vs_run0":
                              res["max_rel_diff_vs_run0"]}), flush=True)
    names = list(runs[0]["ms"])
    print("shape | " + " | ".join(f"{n}:{r['tree']}"
                                  for n, r in enumerate(runs)))
    for name in names:
        print(name + " | " + " | ".join(f"{r['ms'][name]:.4f}"
                                        for r in runs))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump([{k: v for k, v in r.items() if k != "out"}
                       for r in runs], fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
