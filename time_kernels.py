#!/usr/bin/env python3
"""Time the fine fan-out kernels of one or more checkouts of the port, in
turns, at every path shape, on one CUDA card.

    python3 time_kernels.py [TREE ...] [--out FILE]

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


def worker(tree, results_path):
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
    for name, ode, t0, t1, U, tab, steps, reps in shapes(nt, dev):
        field, f = ode.get_device_field(), ode.get_vector_field()
        run = lambda: rk_cuda.rk_fanout(t0, t1, U, tab, steps, field, f)
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


def main(argv):
    out_path = None
    if "--out" in argv:
        k = argv.index("--out")
        out_path = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    trees = argv or ["."]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for n, tree in enumerate(trees):
            path = os.path.join(tmp, f"run{n}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", tree, path], check=True, cwd=HERE)
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
