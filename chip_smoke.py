#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nngparareal_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it ends with its seconds:

1. env       torch and CUDA versions, the card, its power limit.
2. build     nvcc builds the fan-out kernels from csrc/rk_fanout.cu and
             their double-single form from csrc/ds_fanout.cu, one nvcc
             each, at once (with the tableaus of csrc/tableaus.cuh
             compiled in), and prints ptxas' registers and spills of
             every instance (any spill of the f64 kernels fails; the ds
             kernel's are reported), each path instance's registers and
             resident blocks per SM as the card reports them, and the
             latency probe: the card's cycles per dependent f64 add,
             multiply, FMA, division and sin, f32 add, multiply,
             division and FMA (the ds kernel's, ``ds_latency_cycles``),
             and per exchange round (store, barrier, load) of
             a 128- and a 256-thread block, with the clock they imply
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
             experiments.run_burgers. It must converge with 10 <= K <= 14,
             and the Burgers kernel must have run in it. Then the
             reporting surface at that width: p.print_times() (its Fine
             row times one 40 000-step RK8 solve over the whole span at
             B=1 through the kernel, as the JAX package's does: no serial
             fine time) and p.print_speedup() in Markdown and LaTeX, the
             tables printed on lines of their own; p.store(slim=True) into
             the log's directory, read back with read_pickle, its keys and K
             checked; timings must name sweep_mode and sync_mode.
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
             experiments.run_tomlab (K=30, the JAX package's on the CPU).
7. table2_nm the fourth path: experiments.run_table2 at eps=5e-7 with the
             nngp model and no nngp_kw: the JAX package's default search,
             batched Nelder-Mead (random integer starts, fatol = xatol =
             0.1, at most 200 iterations), run as CUDA graphs replayed
             until every simplex has frozen. Each system's K must lie in
             TABLE2_NM (the seed bands at its m of PARITY.md:190-199,
             widened to the CPU oracle of PARITY.md:9-16), and its path
             must have launched its own field's kernel and no other. Per
             system: the runtime and its split, the sweep's ms per
             interval, the Nelder-Mead iterations per search until every
             simplex froze (mean, max), the graph replays, the launches by
             shape. Then one prediction's search, replayed from the graphs
             and run with eager launches: bitwise equal.
8. table2_gp the fifth path: experiments.run_table2 at eps=5e-7 with the
             gpjax model (GParareal: one GP per coordinate on the whole
             dataset, padded to a power-of-two bucket of rows; Nelder-Mead
             at the JAX driver's Table-2 settings, fatol = xatol = 1e-6,
             at most 400 iterations, as CUDA graphs; above 48 rows the
             Cholesky is torch.linalg.cholesky_ex, cuSOLVER), all six
             systems at their published configurations. Each system's K
             must lie in TABLE2_GP, and its path must have launched its
             own field's kernel and no other. Per system: K and conv_int,
             the runtime and its split (fine, train, predict, coarse), the
             bucket of each fit, the Nelder-Mead iterations per fit until
             every simplex froze (mean, max) and the graph replays,
             alpha_rejects and alpha_unusable, the fan-out launches by
             shape, and the Cholesky batch (6 candidates x 9 jitters x n
             coordinates) at the run's largest bucket with its time. Then
             FHN once more with the grid search (gp_kw): K must be 5; its
             conv_int is printed beside the JAX package's on the CPU.
             Then cholesky_ex's time per batch of 162 at each bucket from
             64 to 1024 rows (its kernels: phase 15), and one
             fit's search replayed from its graphs and run with eager
             launches: bitwise equal.
9. figure2   the sixth path: study 1 of the paper's Figure 2
             (scripts/figure2_rossler.py): Rossler (N=40, eps=5e-7), bare
             Parareal with debug=True and eight kNN-mean shadows (nn 1, 2,
             3, 4, 5, 10, 15, 30) through the driver's comp_models: each
             iteration one truth fan-out of every slice, the shadows fitted
             on the same dataset and predicting every active interval. K
             must be 18, every shadow must hold 18 finite error arrays,
             and at every k from 1 to 7 the log10 mean error of each
             shadow and of the Parareal correction must lie within 0.02
             decades of results/figure2_rossler.pkl (the JAX package's run
             on the CPU, which its current code reproduces exactly); every
             shadow must lie below the Parareal correction at k = 5, 6, 7.
             Prints the 9 x 3 table of log10 errors at k = 5, 6, 7.
10. variants the seventh path, one run after another, each with its
             kernel's launches counted alone: the time-augmented nnGP
             (NNGPTime) on Lorenz at tests/test_variants.py's bounded
             configuration (nn=14, reps=2, nn_iters=2, nm_max_iters=80,
             its searches as CUDA graphs), K in 20-23 (the JAX package's
             23 on the CPU, and 20 and 20 under its 4e-16 control), and
             one round's search replayed bitwise its eager run; NNGPTime
             at the reference's full configuration (nn=11, n_restarts=20,
             nn_iters=20, reps=10, nm_max_iters=150) timed on the last
             interval of that run's last dataset (a finite prediction);
             the nnGP's col+rnd and row neighbour strategies on FHN (nn=16,
             grid), K 7 and 10; ELM (m=10, res_size=20) and kNN-mean
             (nn=15) on FHN, K 14 and 39; Hopf N=32 with the grid nnGP
             (nn=15) under selector='loo' and under posterior='lu', K 9
             each, with the LU and Cholesky shares of the 'lu' run's
             predictions. Each K is the JAX package's on the CPU; every
             conv_int is printed beside JAX's.
11. api      the driver's options and result surface on Table 2's FHN
             (N=40) and Lorenz (N=50) at their published configurations,
             each run's launches counted: bare Parareal and PararealLight
             on FHN, K=11 both and the iterates bitwise equal; the bare run
             again with store_int=True, int_name="api_fhn", early_stop=4,
             resumed from its iteration-4 checkpoint with
             load_int_dump(cstm_mdl_name="resumed"): K=11, the iterates
             bitwise the full run's, the run kept as runs["resumed"]; the
             nnGP (nn=15, grid) with lag_k=3, K in 5-7 (the JAX package
             gives 6 on the CPU, 5 or 6 under its 4e-16 control, the port
             7 on the CPU), conv_int printed beside JAX's; the nnGP at the
             table2 phase's configuration with cap_iters=1,
             sync_mode="fast" and calc_detail_avg=True: K=5 and the table2
             phase's conv_int [1, 2, 5, 25, 40], a (K, 40) record of
             interval walls, positive and finite on the intervals each
             sweep predicted; Lorenz bare Parareal (K=15), then
             build_cont_traj(): (50 (Nf + 1), 3), each slice's first row
             its start u[i], its last row bitwise the plain torch fan-out
             on the card and within 1e-12 of max|u| of the kernel's;
             print_times and print_speedup on each Parareal object.
12. mesh     the scale-out (parallel/mesh.py), each part held bitwise
             (max |difference| 0.0) against the same work unsharded, on a
             mesh of this one card or of the card named several times (a
             stand-in for separate cards: its blocks run one after another
             on one stream, so its times say nothing about several cards):
             (a) shard_fine_fanout of Burgers (128, 128) RK8 x 40 000 (the
             per-cell kernel) on make_mesh() and on 4 blocks, and of FHN
             (40, 2) RK4 x 4000 (the per-slice kernel) on 4 blocks, and at
             B=37 through the driver's padding (to 40); the ms of each,
             its launches and the mesh size; (b) Table 2's FHN and Lorenz,
             bare Parareal, on 4 blocks (Lorenz's 50 slices padded by 2):
             K 11 and 15 and the table2 phase's iterates; (c) GParareal
             on FHN with the grid search (the table2_gp phase's
             configuration) with its task pool on 2 blocks: K=5, conv_int
             [1, 2, 3, 9, 40] and the table2_gp phase's iterates; (d)
             GParareal with score_lanes=True (the blocked lane-major NLL)
             on FHN cut to 16 slices and Nf/10, buckets 16-128 (the cut of
             tests/test_torch_gparareal_cut.py): the JAX package's K=6 and
             conv_int [1, 2, 3, 5, 14, 16] on the CPU, its run time and
             the calls of the blocked factor; (e) run_table2(pool=2) of FHN and
             Lorenz, bare Parareal, in two spawned processes on the card:
             K 11 and 15, conv_int and errors those of the table2 phase;
             the wall time.
13. ds       the double-single fan-out (ops/rk_cuda_ds.py,
             csrc/ds_fanout.cu), the Pallas kernel's own arithmetic: (a)
             for each of the nine fields at its path's shape and tableau
             (the f64 kernels phase's), the ds kernel against its plain
             torch version on the card at 20 steps (10 for the ODEs):
             bitwise, max |diff| 0.0 (both round every ds operation
             alone, in one order, or take an exact shortcut that gives
             its bits: csrc/ds32.cuh); (b) the ds kernel at the
             path's full steps (FHN-PDE at 1/8 of them, the time scaled
             by 8), timed with CUDA events, against the f64 kernel on the
             same inputs (at most 1e-9) and its bound (``ds_bound``),
             each field's kernel an entry of the kernels line; (c)
             the flagship with fine='pallas' through Parareal.run
             (bench.py:90-121's configuration): K in 10-14, printed beside
             the f64 flagship's K and the TPU's double-single K=12
             (BENCH_r05.json), its fine/model/coarse split, its ds
             launches (the only kernel of that path) and its final
             iterate's gap to the f64 flagship's; (d) the per-slice
             form's path: bare Parareal on Lorenz with fine='pallas',
             K=15 as the api phase's f64 run, its ds launches (the f64
             kernel's coarse solves counted apart).
14. serial    the runs' converged iterates against fine solves, slice by
             slice (atol 2e-5, as tests/test_parareal.py holds the JAX
             package): Burgers one slice after another from u0; FHN-PDE
             and each Table-2, figure2, variants and mesh run (every
             search and model) with one kernel fan-out from the converged
             starts.
15. profile  the cuSOLVER kernels of one cholesky_ex call at 512 rows (the
             table2_gp phase's batch) under torch.profiler, last: a CUDA
             profiler session leaves every later launch of the process
             slower, and the host microseconds per small torch op before
             and after it are printed beside the kernels.

Then one JSON line describing each kernel (its launches on its path's
run, split by shape into fine fan-outs and coarse solves,
``launches_by_shape``, and by path, ``launches_by_path``; ``chain_ms``,
the chain bound: the path's steps times the dependent operations through
one step, ``chain_depth``, at the probe's latencies), the card's name and
power limit as nvidia-smi prints them, and as the last line
{"ok": true, "device": {...}}. The drivers print each iteration; those
lines go to chiprun_out/chip_smoke.log (git-ignored) with every line
above, so the standard output holds the phases' lines only. A deadline
at five sixths of the 1200 s the run is given stops it with an error that
names the running phase. Any failure exits nonzero and prints no result;
so does a machine with no card, or a directory without the package.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = "chiprun_out"  # git-ignored, as the output of GPU runs
LIMIT_S = 1200
# the run stops itself here, naming its phase, well inside the limit: on
# the slower hosts the phases before the ds phase alone took 670 s of an
# H100 call, so two thirds of the limit no longer holds them
DEADLINE_S = LIMIT_S * 5 // 6

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
# system: the nnGP K range with the JAX package's default search,
# Nelder-Mead: the seed band of PARITY.md:190-199 ("ours") at the system's
# m, widened to hold the CPU IEEE-f64 oracle of PARITY.md:9-16 (5, 13, 10,
# 17, 9, 10)
TABLE2_NM = {"FHN_ODE": (5, 5), "Rossler": (12, 13), "Hopf_32": (9, 10),
             "Brusselator": (17, 18), "Lorenz": (9, 11), "DblPend": (9, 10)}
# system: GParareal's K range under the JAX Table-2 settings (Nelder-Mead,
# fatol = xatol = 1e-6): the smallest range that holds the published K
# (PARITY.md:11-16: 5, 13, 10, 20, 11, 10), the scipy oracle's
# (PARITY.md:262-267: 5, 12, 10, 19, 11, 10) and the CPU grid run's
# (results/table2_cpu_gpgrid.json: 5, 12, 10, 21, 10, 10)
TABLE2_GP = {"FHN_ODE": (5, 5), "Rossler": (12, 13), "Hopf_32": (10, 10),
             "Brusselator": (19, 21), "Lorenz": (10, 11),
             "DblPend": (10, 10)}
# FHN with GParareal's grid search: the JAX package's K and conv_int on the
# CPU (tests/test_parareal.py:test_fhn_gparareal_grid_k5)
GP_GRID_FHN_K = 5
GP_GRID_FHN_CONV_INT_CPU = [1, 2, 3, 9, 40]
# cholesky_ex timed at these buckets, on GP_CHOL_BATCH Grams (6
# candidates x 9 jitters x 3 coordinates: a Nelder-Mead iteration's)
GP_CHOL_BUCKETS = (64, 128, 256, 512, 1024)
GP_CHOL_BATCH = 162
# ThomasLabyrinth N=32, Parareal: the JAX package's K on the CPU
# (tests/test_torch_table2.py:test_tomlab_parareal_k_of_the_jax_package)
TOMLAB_K = 30
HOPF_FINE_MULT = 10000  # run_hopf's fine steps: Config(N=512)'s Nf x 10000

# Figure 2, study 1 (scripts/figure2_rossler.py:37-51): the kNN-mean
# shadows beside bare Parareal on Rossler; K and the log10 mean errors of
# the JAX package's run on the CPU (results/figure2_rossler.pkl)
FIG2_NN = (1, 2, 3, 4, 5, 10, 15, 30)
FIG2_K = 18
FIG2_PICKLE = os.path.join("results", "figure2_rossler.pkl")
FIG2_DECADES = 0.02  # the gap allowed for the card's ulp-level fan-out
# the variants, each with the JAX package's K and conv_int on the CPU
# NNGPTime on Lorenz at tests/test_variants.py:61's bounded configuration:
# JAX's K=23 on the CPU; under its control (u0 moved by 4e-16, three sign
# draws) 23, 20 and 20, hence the range (the test there asserts K <= 13,
# which the current JAX package does not reach)
NNGP_TIME_LORENZ = dict(nn=14, reps=2, nn_iters=2, nm_max_iters=80, seed=45)
NNGP_TIME_K = (20, 23)
NNGP_TIME_CONV_INT_CPU = [1, 2, 3, 4, 5, 6, 8, 9, 17, 18, 19, 24, 28, 33,
                          34, 35, 36, 37, 39, 40, 44, 47, 50]
# the reference's full configuration (PARITY.md:366-400), timed only, on
# one interval (two measured 6.0-6.9 s each on an H100, the first with
# the capture of its graphs: the script's 600 s budget keeps one)
NNGP_TIME_FULL = dict(nn=11, n_restarts=20, nn_iters=20, reps=10,
                      nm_max_iters=150)
# FHN, nnGP grid search with nn=16 (scripts/strategy_table.py:58-59): the
# current JAX package on the CPU. results/strategy_k.json, written by an
# earlier revision, has col+rnd 6
STRATEGIES_FHN = {"col+rnd": (7, [1, 2, 3, 5, 15, 37, 40]),
                  "row": (10, [1, 2, 3, 4, 5, 6, 8, 11, 32, 40])}
ELM_FHN = (14, [1, 2, 3, 4, 5, 6, 7, 9, 14, 18, 23, 27, 37, 40])
KNN_FHN = (39, list(range(1, 31)) + list(range(32, 41)))
# Hopf N=32, grid nnGP nn=15, with the LOO selector and the LU posterior
HOPF_VARIANT_K = 9
HOPF_VARIANT_CONV_INT_CPU = [1, 2, 3, 4, 5, 6, 7, 26, 32]

# the api phase: FHN bare Parareal (K as in TABLE2); the nnGP (nn=15, grid)
# with lag_k=3: the band of the JAX package on the CPU (6; 5 or 6 under its
# 4e-16 control) and of the port on the CPU (7; 5 or 6 under the same
# control), with JAX's conv_int (tests/test_torch_driver_lag_k.py); the
# nnGP at the table2 phase's FHN configuration, K and conv_int as that
# phase gives them on the card; Lorenz bare Parareal
API_LAG_K = (5, 7)
API_LAG_CONV_INT_CPU = [1, 2, 3, 25, 38, 40]
API_FHN_GRID = (5, [1, 2, 5, 25, 40])
API_LORENZ_K = 15
API_TRAJ_RTOL = 1e-12
# the mesh phase: blocks of the repeated-card meshes, Table 2's bare K,
# and the cut FHN of tests/test_torch_gparareal_cut.py with score_lanes
# (the JAX package's K and conv_int on the CPU,
# tests/test_torch_gparareal_cut_lanes.py)
MESH_BLOCKS = 4
MESH_GP_BLOCKS = 2
LANES_CUT = dict(fine_cut=10, slices=16)
LANES_K = 6
LANES_CONV_INT_CPU = [1, 2, 3, 5, 14, 16]
# the payload keys of Parareal.store, as the JAX package writes them
STORE_KEYS = {"ode_name", "tspan", "N", "epsilon", "n", "runs", "fine_t"}

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
    """Names the running phase, for the deadline and for failures. What a
    phase prints itself (the drivers' per-iteration lines) goes to the
    log file ``log`` alone; the phase's line, and every line ``emit``
    prints, go to the standard output and the log."""

    def __init__(self, log):
        self.current = "start"
        self.log = log
        # lines a phase hands over, printed after its own line
        self.notes = []

    def emit(self, line):
        print(line, flush=True)
        self.log.write(line + "\n")
        self.log.flush()

    def run(self, name, fn, *args):
        import contextlib
        import torch

        self.current = name
        tic = time.perf_counter()
        with contextlib.redirect_stdout(self.log):
            info = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        self.emit(f"[{name}] {json.dumps(info)} {secs:.3f}s")
        for line in self.notes:
            self.emit(line)
        self.notes.clear()
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
    ds_text = "".join(rk_cuda.ptxas_report_path(name).read_text()
                      for name in rk_cuda.LIBRARIES if name != "rk_fanout")
    return {"library": os.path.relpath(lib, HERE), "fresh": fresh,
            "build_s": round(build_s, 3),
            "ptxas": ptxas_report(rk_cuda.ptxas_report_path().read_text()),
            "ptxas_ds": ptxas_report(ds_text, PTXAS_FUNCTORS_DS,
                                     strict=False),
            "occupancy": occupancy(), "occupancy_ds": occupancy_ds(),
            "latency": latency,
            "ds_latency_cycles": {k: latency["cycles"][k] for k in (
                "add_f32", "mul_f32", "fma_f32", "div_f32")}}


# the exchange rounds probed: the per-cell kernel's block sizes on its paths
# (Burgers d=128, FHN-PDE dx=16)
SYNC_THREADS = (128, 256)
PROBE_N = 1 << 20


def probe_latency():
    """The card's cycles per dependent operation (clock64() in one
    thread), for the chain bound: add, multiply, FMA, division, sin (less
    the add that closes its chain), the f32 add, multiply, division and
    FMA of the double-single kernel, and the per-cell kernel's exchange
    round (store, barrier, a neighbour's load) in a block of each of
    SYNC_THREADS. The clock is the add chain's cycles over its time by
    CUDA events; nvidia-smi's clocks.sm is printed beside it."""
    from nngparareal_torch.ops import rk_cuda

    cycles, ms = {}, {}
    for kind in ("add", "mul", "fma", "div", "sin", "add_f32", "mul_f32",
                 "div_f32", "fma_f32"):
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


# the double-single kernel's functors (csrc/ds_fanout.cu)
PTXAS_FUNCTORS_DS = (("FhnPdeDs", "fhn_pde"), ("BurgersDs", "burgers"),
                     ("FhnOdeDs", "fhn_ode"), ("RosslerDs", "rossler"),
                     ("HopfDs", "hopf"), ("DblPendDs", "dblpend"),
                     ("BrusselatorDs", "brusselator"), ("LorenzDs", "lorenz"),
                     ("ThomasLabyrinthDs", "tomlab"))


def ptxas_report(text, functors=PTXAS_FUNCTORS, strict=True):
    """Registers and spills of each kernel instance, keyed by field,
    tableau and (ODE fields) "map" or "raw", from ``-Xptxas -v`` output;
    the probe's instances under "probe". ``strict``: any spill fails (the
    f64 kernels); the ds kernel's spills are reported only."""
    report = {}
    key = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            tab = re.search(r"tableau\d+(RK\d+)", name)
            field = next((f for functor, f in functors
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
    if not report or (strict and spilling):
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


def occupancy_ds():
    """The ds kernel's registers, local memory, blocks per SM and block
    size at each field's path shape (rk_cuda_ds.kernel_attributes): the
    flagship's, FHN-PDE's, and each ODE's fine fan-out (four lanes a slice
    for DblPend and ThomasLabyrinth)."""
    import nngparareal_torch as nt
    from nngparareal_torch.ops import rk_cuda_ds

    out = {}
    ode = nt.Burgers(d_x=FLAGSHIP["d_x"], normalization="-11", device="cpu")
    out["burgers/RK8"] = rk_cuda_ds.kernel_attributes(
        ode.get_device_field(), "RK8", FLAGSHIP["N"], FLAGSHIP["d_x"])
    ode = nt.FHNPDE(d_x=FHN_PDE_DX, normalization="-11", device="cpu")
    out["fhn_pde/RK8"] = rk_cuda_ds.kernel_attributes(
        ode.get_device_field(), "RK8", 512, ode.get_dim())
    for kind, (cls, N_arg) in ODE_SYSTEMS.items():
        ode = getattr(nt, cls)(normalization="-11", device="cpu")
        cfg = nt.Config(ode, N=N_arg).get()
        out[f"{kind}/{cfg['F']}/B={cfg['N']}"] = (
            rk_cuda_ds.kernel_attributes(ode.get_device_field(), cfg["F"],
                                         cfg["N"], ode.get_dim()))
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
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal

    cfg = FLAGSHIP
    dev = state["device"]
    kept = []
    run = keep_runs(kept)
    try:
        zero_counts()
        experiments.run_burgers(T=cfg["T"], N=cfg["N"], models=("nngp",),
                                results_dir=None, nn=cfg["nn"],
                                seed=cfg["seed"],
                                nngp_kw=dict(optimizer="grid"), device=dev)
        torch.cuda.synchronize()
        launches = read_counts(state, "burgers", "flagship")
    finally:
        Parareal.run = run
    (p, out), = kept
    built = (p.ode.get_dim(), p.N, p.tspan, p.solver.Ng, p.solver.Nf,
             p.solver.G.name, p.solver.F.name, p.epsilon)
    if built != (cfg["d_x"], cfg["N"], (0.0, cfg["T"]), cfg["Ng"], cfg["Nf"],
                 cfg["G"], cfg["F"], cfg["eps"]):
        raise PhaseError(f"run_burgers built {built}, not bench.py's run")
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
    info.update(reporting_surface(state, "flagship", p, out))
    return info


def reporting_surface(state, name, p, out, store=True):
    """print_times and print_speedup (Markdown, LaTeX) on a Parareal
    object, the tables handed to the phase's notes; with ``store``, the
    runs stored slim into LOG_DIR, read back and checked; timings must
    name sweep_mode and sync_mode. Returns the Fine row's seconds and the
    modes."""
    from nngparareal_torch.utils.io import read_pickle

    tm = out["timings"]
    if "sweep_mode" not in tm or "sync_mode" not in tm:
        raise PhaseError(f"{name}: timings lack sweep_mode/sync_mode")
    tables = [p.print_times(), p.print_speedup(),
              p.print_speedup(md=False, mdl_title=name)]
    state["notes"].extend(f"[{name} table] {line}" for t in tables
                          for line in t.splitlines())
    info = {"print_times_fine_s": p.fine_t, "sweep_mode": tm["sweep_mode"],
            "sync_mode": tm["sync_mode"]}
    if store:
        path = os.path.join(HERE, LOG_DIR)
        fname = f"{name}_store.pkl"
        p.store(fname, path=path, slim=True)
        back = read_pickle(fname, path)
        (key, run), = [(k, v) for k, v in p.runs.items() if v is out]
        stored = back["runs"].get(key, {})
        if (set(back) != STORE_KEYS or set(back["runs"]) != set(p.runs)
                or stored.get("k") != out["k"] or "u" in stored
                or back["fine_t"] != p.fine_t):
            raise PhaseError(f"{name}: store(slim=True) read back as keys "
                             f"{sorted(back)}, runs {sorted(back['runs'])}")
        info["stored"] = {"file": os.path.join(LOG_DIR, fname),
                          "keys": sorted(back), "run": key,
                          "k": stored["k"]}
    return info


def zero_counts():
    """Set every kernel's launch count to 0, just before a path runs."""
    from nngparareal_torch.ops import rk_cuda

    rk_cuda.rk_fanout.launches = 0
    for name in rk_cuda.rk_fanout.launches_by_field:
        rk_cuda.rk_fanout.launches_by_field[name] = 0
    rk_cuda.rk_fanout.launches_by_shape.clear()


def record_launches(state, field, path):
    """A run's launches of its field's kernel into the kernel's entry:
    the total (``launches`` holds the first path's; ``launches_by_path``
    each path's, summed over its runs), and by (tableau, steps): its fine
    fan-outs and its coarse solves."""
    entry = state["kernels"][field]
    from nngparareal_torch.ops import rk_cuda

    n = rk_cuda.rk_fanout.launches_by_field[field]
    by_path = entry.setdefault("launches_by_path", {})
    by_path[path] = by_path.get(path, 0) + n
    shapes = shape_counts(field)
    if entry["launches"] is None:
        entry["launches"] = n
        entry["launches_by_shape"] = shapes
    else:
        path_shapes = entry.setdefault("launches_by_shape_by_path",
                                       {}).setdefault(path, {})
        for key, k in shapes.items():
            path_shapes[key] = path_shapes.get(key, 0) + k
    return n, shapes


def read_counts(state, field, path):
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
    return record_launches(state, field, path)[0]


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
        launches = read_counts(state, "fhn_pde", "fhn_pde")
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

    shapes = {}

    def counted(*args, **kwargs):
        zero_counts()
        row = per_system(*args, **kwargs)
        torch.cuda.synchronize()
        counts[row["system"]] = dict(rk_cuda.rk_fanout.launches_by_field)
        shapes[row["system"]] = record_launches(
            state, TABLE2[row["system"]][0], "table2")[1]
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
                    "launches_by_shape": shapes[system]}
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
    slice) with the parareal model through experiments.run_tomlab: the
    path of the tomlab field's kernel. Its K must be the JAX package's on
    the CPU (30)."""
    import torch
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal

    dev = state["device"]
    kept = []
    run = keep_runs(kept)
    try:
        zero_counts()
        experiments.run_tomlab(32, models=("parareal",), results_dir=None,
                               device=dev)
        torch.cuda.synchronize()
        launches = read_counts(state, "tomlab", "table2")
    finally:
        Parareal.run = run
    (p, out), = kept
    check_iterates("ThomasLabyrinth_32", p, out)
    if not out["converged"] or out["k"] != TOMLAB_K:
        raise PhaseError(f"ThomasLabyrinth_32 parareal: converged="
                         f"{out['converged']} K={out['k']}, expected "
                         f"{TOMLAB_K}")
    state["table2"].append(("ThomasLabyrinth_32 parareal", p, out))
    return {"launches": launches, "parareal": run_info(out, p.N)}


def phase_table2_nm(state):
    """Table 2 with the JAX package's default nnGP search (Nelder-Mead):
    run_table2 with no nngp_kw, each system's launches counted alone."""
    import numpy as np
    import torch
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal
    from nngparareal_torch.models.nngp import NM_BLOCK

    dev = state["device"]
    per_system = experiments._run_table2_system
    shapes = {}

    def counted(*args, **kwargs):
        zero_counts()
        row = per_system(*args, **kwargs)
        torch.cuda.synchronize()
        field = TABLE2[row["system"]][0]
        read_counts(state, field, "table2_nm")
        shapes[row["system"]] = shape_counts(field)
        return row

    kept = []
    run = keep_runs(kept)
    experiments._run_table2_system = counted
    try:
        rows = experiments.run_table2(TABLE2_EPS, models=("nngp",),
                                      results_dir=None, device=dev)
    finally:
        experiments._run_table2_system = per_system
        Parareal.run = run
    if [r["system"] for r in rows] != list(TABLE2):
        raise PhaseError(f"table2_nm ran {[r['system'] for r in rows]}")
    info = {}
    failures = []
    for row, (p, out) in zip(rows, kept):
        system = row["system"]
        check_iterates(f"{system} nngp (NM)", p, out)
        state["table2"].append((f"{system} nngp (NM)", p, out))
        its = out["timings"]["nm_iterations"]
        sys_info = run_info(out, p.N)
        sys_info.update(
            launches=state["kernels"][TABLE2[system][0]]["launches_by_path"]
            ["table2_nm"], launches_by_shape=shapes[system],
            nm_searches=len(its), nm_iterations_mean=float(np.mean(its)),
            nm_iterations_max=int(max(its)),
            nm_graph_replays=out["timings"]["nm_graph_replays"],
            # the card runs whole blocks of NM_BLOCK iterations
            nm_iterations_run=NM_BLOCK * out["timings"]["nm_graph_replays"])
        info[system] = sys_info
        lo, hi = TABLE2_NM[system]
        if not out["converged"] or not lo <= out["k"] <= hi:
            failures.append(f"{system}: converged={out['converged']} "
                            f"K={out['k']}, expected {lo}-{hi}")
    if failures:
        raise PhaseError("table2_nm K outside its limits: "
                         + "; ".join(failures))
    info["graph_vs_eager"] = graph_vs_eager(state, *kept[-1])
    return info


def graph_vs_eager(state, p, out):
    """One prediction's Nelder-Mead search from a run's converged data:
    the graphs' replay and the same search with eager launches must be
    bitwise equal. Each is timed by the host clock between synchronises
    (the graphs captured by a first search), per iteration run: the
    replays' whole blocks, and the eager search's iterations up to the
    one where every simplex had frozen (one host sync per iteration)."""
    import torch
    from nngparareal_torch.models import NNGParareal
    from nngparareal_torch.ops import gp as gpops
    from nngparareal_torch.ops.nn_select import nearest_neighbors

    dev = state["device"]
    X = torch.as_tensor(out["x"], device=dev)
    D = torch.as_tensor(out["D"], device=dev)
    valid = torch.ones(X.shape[0], dtype=X.dtype, device=dev)
    mdl = NNGParareal(n=p.n, N=p.N, nn=15)
    q = torch.as_tensor(out["u"][p.N // 2], device=dev)
    idx, _ = nearest_neighbors(q, X, valid, 15)
    sqd = gpops.pairwise_sq_dists(X[idx], X[idx])
    mask = torch.ones(15, dtype=X.dtype, device=dev)
    theta0 = torch.as_tensor(mdl.sweep_aux(0, p.N)[0], device=dev)
    args = (sqd, D[idx], mask, theta0)
    mdl._nm_search(*args, graphed=True)  # captures the graphs
    timed = {}
    for graphed in (True, False):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        timed[graphed] = mdl._nm_search(*args, graphed=graphed)
        torch.cuda.synchronize()
        timed[graphed] += (time.perf_counter() - tic,)
    (th_g, fv_g, graph_s), (th_e, fv_e, eager_s) = timed[True], timed[False]
    same = torch.equal(th_g, th_e) and torch.equal(fv_g, fv_e)
    if not same:
        raise PhaseError("Nelder-Mead graph replay differs from the eager "
                         f"run: max |dtheta| "
                         f"{(th_g - th_e).abs().max().item():.3e}")
    run_graph = next(iter(mdl._graphs.values())).last["run"]
    run_eager = mdl.nm_stats["iterations"][-1]
    return {"bitwise": same, "tasks": mdl.B, "m": 15,
            "iterations_graph": run_graph, "iterations_eager": run_eager,
            "graph_ms_per_iteration": 1e3 * graph_s / run_graph,
            "eager_ms_per_iteration": 1e3 * eager_s / max(run_eager, 1)}


def phase_table2_gp(state):
    """Table 2 with GParareal (gpjax) at the JAX driver's settings, each
    system's launches counted alone; then FHN with the grid search, the
    Cholesky timings and the graph check."""
    import torch
    from nngparareal_torch import experiments
    from nngparareal_torch.driver import Parareal

    dev = state["device"]
    per_system = experiments._run_table2_system
    shapes = []  # each run's launches by shape, in order
    path = ["table2_gp"]

    def counted(*args, **kwargs):
        zero_counts()
        row = per_system(*args, **kwargs)
        torch.cuda.synchronize()
        field = TABLE2[row["system"]][0]
        read_counts(state, field, path[0])
        shapes.append(shape_counts(field))
        return row

    kept = []
    run = keep_runs(kept)
    experiments._run_table2_system = counted
    try:
        rows = experiments.run_table2(TABLE2_EPS, models=("gpjax",),
                                      results_dir=None, device=dev)
        path[0] = "table2_gp_grid"
        grid_rows = experiments.run_table2(
            TABLE2_EPS, models=("gpjax",), results_dir=None, device=dev,
            systems=["FHN_ODE"], gp_kw=dict(optimizer="grid"))
    finally:
        experiments._run_table2_system = per_system
        Parareal.run = run
    if [r["system"] for r in rows] != list(TABLE2):
        raise PhaseError(f"table2_gp ran {[r['system'] for r in rows]}")
    info = {}
    failures = []
    for row, (p, out), shape in zip(rows, kept, shapes):
        system = row["system"]
        check_iterates(f"{system} GP", p, out)
        state["table2"].append((f"{system} GP", p, out))
        info[system] = gp_run_info(state, p, out, shape)
        lo, hi = TABLE2_GP[system]
        if not out["converged"] or not lo <= out["k"] <= hi:
            failures.append(f"{system}: converged={out['converged']} "
                            f"K={out['k']}, expected {lo}-{hi}")
    p, out = kept[-1]
    check_iterates("FHN_ODE GP (grid)", p, out)
    state["table2"].append(("FHN_ODE GP (grid)", p, out))
    grid = gp_run_info(state, p, out, shapes[-1])
    grid["conv_int_jax_cpu"] = GP_GRID_FHN_CONV_INT_CPU
    info["FHN_ODE_grid"] = grid
    if not out["converged"] or out["k"] != GP_GRID_FHN_K:
        failures.append(f"FHN_ODE grid: converged={out['converged']} "
                        f"K={out['k']}, expected {GP_GRID_FHN_K}")
    if [r["system"] for r in grid_rows] != ["FHN_ODE"]:
        raise PhaseError(f"table2_gp grid ran {grid_rows}")
    if failures:
        raise PhaseError("table2_gp K outside its limits: "
                         + "; ".join(failures))
    info["cholesky_by_bucket"] = cholesky_by_bucket(dev)
    big = max(kept[:-1], key=lambda r: max(r[1]["timings"]["gp_buckets"]))
    info["graph_vs_eager"] = gp_graph_vs_eager(dev, *big)
    return info


def _gp_grams(X, T, dev):
    """6T masked SE Grams of the rows X (B, n), thetas spread over the
    search's range, jitter 1e-12: the shape of a Nelder-Mead iteration's
    batch (6 candidates of T tasks)."""
    import torch
    from nngparareal_torch.ops import gp as gpops

    sqd = gpops.pairwise_sq_dists(X, X)
    sx = torch.logspace(-1.0, 0.5, 6 * T, dtype=torch.float64, device=dev)
    th = torch.stack([sx, torch.full_like(sx, 1e-2)], dim=1)
    mask = torch.ones(X.shape[0], dtype=torch.float64, device=dev)
    jit = torch.full((6 * T,), -12.0, dtype=torch.float64, device=dev)
    return gpops._masked_gram(gpops.k_se_linear(sqd, th), mask, jit)


def gp_run_info(state, p, out, shapes):
    """A GParareal run's numbers, with its Cholesky batch at its largest
    bucket (the run's newest dataset rows, topped up with uniform points
    in their range where it has fewer) and that batch's time."""
    import numpy as np
    import torch
    from nngparareal_torch.ops import gp as gpops

    tm = out["timings"]
    its = tm.get("nm_iterations") or [0]
    B = max(tm["gp_buckets"])
    T = 9 * p.n
    x = out["x"][-B:]
    if x.shape[0] < B:
        rng = np.random.default_rng(0)
        x = np.concatenate([x, rng.uniform(x.min(0), x.max(0),
                                           (B - x.shape[0], p.n))])
    chol_ms = None
    if B > gpops.SMALL_M:
        Kj = _gp_grams(torch.as_tensor(x, device=state["device"]), T,
                       state["device"])
        chol_ms = _event_ms(lambda: gpops.cholesky_nan(Kj), 3)
        del Kj
    info = run_info(out, p.N)
    info.update(
        train_s=tm["mdl_train_t"], gp_buckets=tm["gp_buckets"],
        nm_iterations_mean=float(np.mean(its)),
        nm_iterations_max=int(max(its)),
        nm_graph_replays=tm.get("nm_graph_replays", 0),
        alpha_rejects=tm["alpha_rejects"],
        alpha_unusable=tm["alpha_unusable"],
        launches_by_shape=shapes,
        cholesky_batch=[6 * T, B, B], cholesky_ms=chol_ms)
    return info


def cholesky_by_bucket(dev):
    """cholesky_ex (through ops.gp.cholesky_nan) on GP_CHOL_BATCH Grams at
    each bucket: ms per batch (its kernels: ``phase_profile``)."""
    import torch
    from nngparareal_torch.ops import gp as gpops

    g = torch.Generator(device="cpu").manual_seed(0)
    out = {}
    for B in GP_CHOL_BUCKETS:
        X = torch.rand((B, 3), generator=g, dtype=torch.float64).to(dev)
        Kj = _gp_grams(X, GP_CHOL_BATCH // 6, dev)
        out[str(B)] = _event_ms(lambda: gpops.cholesky_nan(Kj), 3)
        del Kj
    torch.cuda.empty_cache()
    return {"batch": GP_CHOL_BATCH, "ms_by_bucket": out}


def _us_per_launch(dev, n=20000):
    """Host microseconds per small torch op on the card (a chain of n
    multiply-adds on 64 values, synchronised at both ends)."""
    import torch

    x = torch.rand(64, device=dev)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        x = x * 1.0000001 + 1e-9
    torch.cuda.synchronize()
    return (time.perf_counter() - tic) / (2 * n) * 1e6


def phase_profile(state):
    """The card's kernels of one cholesky_ex call on GP_CHOL_BATCH Grams of
    512 rows under torch.profiler (cuSOLVER's batched potrf names its
    kernels *batch*). Last, because a CUDA profiler session leaves every
    later launch of the process slower: the microseconds per small torch
    op before and after the session are printed beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nngparareal_torch.ops import gp as gpops

    dev = state["device"]
    g = torch.Generator(device="cpu").manual_seed(0)
    X = torch.rand((512, 3), generator=g, dtype=torch.float64).to(dev)
    Kj = _gp_grams(X, GP_CHOL_BATCH // 6, dev)
    gpops.cholesky_nan(Kj)
    _us_per_launch(dev, 2000)
    before = _us_per_launch(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gpops.cholesky_nan(Kj)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if "potrf" in e.key})
    after = _us_per_launch(dev)
    return {"potrf_kernels": [n[:60] for n in names],
            "batched": any("atch" in n for n in names),
            "us_per_op_before": before, "us_per_op_after": after}


def gp_graph_vs_eager(dev, p, out, iters=48):
    """One GParareal Nelder-Mead fit on a run's valid dataset rows (the
    newest, at most its largest bucket), replayed from its graphs and run
    with eager launches (``iters`` iterations at most): bitwise equal.
    Each timed by the host clock between synchronises, per iteration
    run."""
    import numpy as np
    import torch
    from nngparareal_torch.models import GParareal

    B = max(out["timings"]["gp_buckets"])
    X = torch.as_tensor(out["x"][-B:], device=dev)
    D = torch.as_tensor(out["D"][-B:], device=dev)
    valid = torch.ones(X.shape[0], dtype=torch.float64, device=dev)
    mdl = GParareal(p.n, p.N, fatol=1e-6, xatol=1e-6, nm_max_iters=iters)
    x0 = torch.as_tensor(np.repeat(mdl.thetas, 9, axis=0), device=dev)
    mdl._fit_warm(X, D, valid, x0, graphed=True)  # captures the graphs
    timed = {}
    for graphed in (True, False):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        res = mdl._fit_warm(X, D, valid, x0, graphed=graphed)
        torch.cuda.synchronize()
        timed[graphed] = (res, time.perf_counter() - tic)
    (got, graph_s), (want, eager_s) = timed[True], timed[False]
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        raise PhaseError("GParareal's Nelder-Mead graph replay differs from "
                         "the eager run")
    run_graph = next(iter(mdl._graphs.values())).last["run"]
    run_eager = mdl.nm_stats["iterations"][-1]
    return {"bitwise": same, "bucket": int(X.shape[0]),
            "tasks": 9 * p.n, "iterations_graph": run_graph,
            "iterations_eager": run_eager,
            "graph_ms_per_iteration": 1e3 * graph_s / max(run_graph, 1),
            "eager_ms_per_iteration": 1e3 * eager_s / max(run_eager, 1)}


def fig2_log_errors(errs):
    """log10 of the mean error of each of an iteration list's arrays."""
    import numpy as np

    out = []
    for e in errs:
        e = np.where(np.isfinite(e), e, np.nan)
        out.append(float(np.log10(np.nanmean(e))))
    return out


def _system_parareal(name, dev, N=None, cls=None):
    """A Table-2 system's Parareal (or ``cls``) at its published
    configuration, the kernel as its fine fan-out."""
    import nngparareal_torch as nt

    ode = getattr(nt, name)(normalization="-11", device=dev)
    cfg = nt.Config(ode, N=N).get()
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"],
                         device_field=ode.get_device_field(), device=dev)
    return (cls or nt.Parareal)(ode, solver, cfg["tspan"], cfg["N"],
                                epsilon=5e-7, device=dev)


def counted_run(state, field, path, p, **kw):
    """One run of ``p`` with its kernel's launches counted alone: (out,
    launches, launches by shape)."""
    import torch

    zero_counts()
    out = p.run(**kw)
    torch.cuda.synchronize()
    launches = read_counts(state, field, path)
    return out, launches, shape_counts(field)


def shape_counts(field):
    """The field's launches since the counts were set to 0, by (tableau,
    steps): its fine fan-outs and its coarse solves."""
    from nngparareal_torch.ops import rk_cuda

    return {f"{tab} x {steps}": k for (name, tab, steps), k
            in rk_cuda.rk_fanout.launches_by_shape.items() if name == field}


def phase_figure2(state):
    """Study 1 of Figure 2: bare Parareal on Rossler with eight kNN-mean
    shadows, against the JAX package's run (the pickle)."""
    import numpy as np
    from nngparareal_torch.convert import load_checkpoint

    dev = state["device"]
    p = _system_parareal("Rossler", dev)
    shadows = [("knn_mean", {"nn": nn, "cstm_name": f"{nn}-NN"})
               for nn in FIG2_NN]
    out, launches, shapes = counted_run(
        state, "rossler", "figure2", p, model="parareal",
        comp_models=shadows, debug=True, cstm_mdl_name="para_study")
    check_iterates("figure2", p, out)
    state["table2"].append(("Rossler parareal (figure2)", p, out))
    # numpy arrays and Python data only, as a checkpoint holds
    ref = load_checkpoint(os.path.join(HERE, FIG2_PICKLE))
    dd = out["debug_dict"]
    errs = {"Para": dd["all_pred_err"], **dd["err_store_mdls"]}
    want = {"Para": ref["para_err"], **ref["para_shadows"]}
    failures = []
    if not out["converged"] or out["k"] != FIG2_K:
        failures.append(f"K={out['k']} converged={out['converged']}, "
                        f"expected {FIG2_K}")
    if p.runs.get("para_study") is not out:
        failures.append("the run is not kept as runs['para_study']")
    logs, gaps = {}, {}
    for name, e in errs.items():
        if len(e) != FIG2_K or not all(np.isfinite(x).all() for x in e):
            failures.append(f"{name}: {len(e)} error arrays, finite="
                            f"{all(np.isfinite(x).all() for x in e)}")
            continue
        logs[name] = fig2_log_errors(e)
        ref_logs = fig2_log_errors(want[name])
        gaps[name] = max(abs(a - b) for a, b in zip(logs[name][:7],
                                                    ref_logs[:7]))
        if gaps[name] > FIG2_DECADES:
            failures.append(f"{name}: log10 mean error {gaps[name]:.4f} "
                            f"decades from the JAX run at k <= 7")
    for name in list(logs)[1:]:
        if not all(logs[name][k] < logs["Para"][k] for k in (4, 5, 6)):
            failures.append(f"{name} is not below the Parareal correction "
                            "at k = 5, 6, 7")
    if failures:
        raise PhaseError("figure2: " + "; ".join(failures))
    info = run_info(out, p.N)
    info.update(launches=launches, launches_by_shape=shapes,
                max_gap_decades=max(gaps.values()),
                log10_err_k5_k6_k7={n: [round(v, 3) for v in l[4:7]]
                                    for n, l in logs.items()})
    return info


def run_variant(state, name, field, p, want_k, conv_int_cpu, **kw):
    """One variant run with its kernel's launches counted alone, held to
    its K; returns (out, info)."""
    out, launches, shapes = counted_run(state, field, "variants", p, **kw)
    check_iterates(name, p, out)
    state["table2"].append((name, p, out))
    info = run_info(out, p.N)
    info.update(launches=launches, launches_by_shape=shapes,
                conv_int_jax_cpu=conv_int_cpu)
    tm = out["timings"]
    if "nm_iterations" in tm:
        its = tm["nm_iterations"] or [0]
        info.update(nm_searches=len(tm["nm_iterations"]),
                    nm_iterations_mean=sum(its) / len(its),
                    nm_iterations_max=max(its),
                    nm_graph_replays=tm["nm_graph_replays"])
    lo, hi = want_k if isinstance(want_k, tuple) else (want_k, want_k)
    if not out["converged"] or not lo <= out["k"] <= hi:
        raise PhaseError(f"variants, {name}: converged={out['converged']} "
                         f"K={out['k']}, expected {lo}-{hi}")
    return out, info


def phase_variants(state):
    """The comparison models and research variants, each run on its
    system's kernel with its launches counted alone."""
    from nngparareal_torch.models import NNGParareal

    dev = state["device"]
    info = {}
    p = _system_parareal("Lorenz", dev)
    out, info["nngp_time_lorenz"] = run_variant(
        state, "Lorenz NNGPtime", "lorenz", p, NNGP_TIME_K,
        NNGP_TIME_CONV_INT_CPU, model="nngp_time", add_model=True,
        **NNGP_TIME_LORENZ)
    import torch

    # the run's graphs hold inference tensors (the driver's loop runs in
    # inference mode): replay them in it
    with torch.inference_mode():
        info["nngp_time_lorenz"]["graph_vs_eager"] = time_graph_vs_eager(
            dev, p, out)
        info["nngp_time_full"] = time_full_config(dev, p, out)
    for strategy, (k, conv) in STRATEGIES_FHN.items():
        p = _system_parareal("FHNODE", dev)
        info[f"fhn_{strategy}"] = run_variant(
            state, f"FHN NNGP{strategy}", "fhn_ode", p, k, conv,
            model="nngp", nn=16, strategy=strategy, optimizer="grid")[1]
    p = _system_parareal("FHNODE", dev)
    info["fhn_elm"] = run_variant(state, "FHN ELM", "fhn_ode", p, *ELM_FHN,
                                  model="elm", m=10, res_size=20)[1]
    p = _system_parareal("FHNODE", dev)
    info["fhn_knn_mean"] = run_variant(state, "FHN kNN-mean", "fhn_ode", p,
                                       *KNN_FHN, model="knn_mean", nn=15)[1]
    for key, kw in (("loo", dict(selector="loo")), ("lu", dict(posterior="lu"))):
        p = _system_parareal("Hopf", dev, N=32)
        mdl = NNGParareal(p.n, p.N, nn=15, optimizer="grid", **kw)
        out, info[f"hopf_{key}"] = run_variant(
            state, f"Hopf_32 nnGP {key}", "hopf", p, HOPF_VARIANT_K,
            HOPF_VARIANT_CONV_INT_CPU, model=mdl)
        if key == "lu":
            tm = out["timings"]
            info["hopf_lu"].update(lu_taken=tm["lu_taken"],
                                   chol_taken=tm["chol_taken"])
    return info


def time_graph_vs_eager(dev, p, out):
    """One NNGPTime round's search from a run's data: the replay of its
    graphs and the same search with eager launches must be bitwise equal;
    each timed by the host clock between synchronises, per iteration."""
    import torch
    from nngparareal_torch.models.base import Dataset

    mdl = out["mdl"]
    X = torch.as_tensor(out["x"], device=dev)
    D = torch.as_tensor(out["D"], device=dev)
    ds = Dataset(X, D, torch.ones(X.shape[0], dtype=X.dtype, device=dev))
    searches = []
    search = mdl._search

    def keep(x0, data, graphed=None):
        searches.append((x0.clone(), [d.clone() for d in data]))
        return search(x0, data, graphed)

    mdl._search = keep
    try:
        i = p.N - 1
        aux = {k: torch.as_tensor(v[i], device=dev) for k, v in
               mdl.sweep_aux(mdl.k, p.N, ds.capacity).items()}
        q = torch.as_tensor(out["u"][i], device=dev)
        mdl.predict_fn(ds, q, q, q, i, aux_i=aux)
    finally:
        mdl._search = search
    x0, data = searches[0]
    timed = {}
    for graphed in (True, False):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        res = mdl._search(x0, data, graphed=graphed)
        torch.cuda.synchronize()
        timed[graphed] = (res, time.perf_counter() - tic,
                          mdl.nm_stats["iterations"][-1])
    (got, graph_s, _), (want, eager_s, live) = timed[True], timed[False]
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        raise PhaseError("NNGPTime's Nelder-Mead graph replay differs from "
                         "the eager run")
    nmg = mdl._graphs[(x0.device, data[0].shape[1])]
    run = nmg.last["run"]
    return {"bitwise": same, "simplexes": int(x0.shape[0]),
            "m": int(data[0].shape[1]), "iterations_graph": run,
            "iterations_eager": live,
            "graph_ms_per_iteration": 1e3 * graph_s / max(run, 1),
            "eager_ms_per_iteration": 1e3 * eager_s / max(live, 1)}


def time_full_config(dev, p, out):
    """NNGPTime at the reference's full configuration, timed on the last
    interval of a run's last dataset (its valid rows, at the run's last
    k), with the model's own draws: seconds (the capture of its graphs
    included), Nelder-Mead iterations and replays, and the peak of the
    memory it allocated above what was allocated before it; the
    prediction finite."""
    import numpy as np
    import torch
    from nngparareal_torch.models import NNGPTime
    from nngparareal_torch.models.base import Dataset

    X = torch.as_tensor(out["x"], device=dev)
    D = torch.as_tensor(out["D"], device=dev)
    ds = Dataset(X, D, torch.ones(X.shape[0], dtype=X.dtype, device=dev))
    mdl = NNGPTime(p.n, p.N, **NNGP_TIME_FULL)
    k = out["k"] - 1
    mdl.fit(ds, k)
    aux = mdl.sweep_aux(k, p.N, ds.capacity)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    i = p.N - 1
    aux_i = {key: torch.as_tensor(v[i], device=dev) for key, v in aux.items()}
    q = torch.as_tensor(out["u"][i], device=dev)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    pred = mdl.predict_fn(ds, q, q, q, i, aux_i=aux_i)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    its = mdl.nm_stats["iterations"]
    if not np.isfinite(pred.cpu().numpy()).all():
        raise PhaseError(f"NNGPTime full configuration: interval {i} "
                         "predicts non-finite values")
    return {"rows_in_dataset": int(X.shape[0]), "k": k, "interval": i,
            "simplexes": mdl.chains * mdl.tasks_per_chain, "s": secs,
            "nm_rounds": len(its), "nm_iterations_mean": float(np.mean(its)),
            "nm_iterations_max": int(max(its)),
            "replays": mdl.nm_stats["replays"],
            "peak_mem_mb": (torch.cuda.max_memory_allocated(dev) - base)
            / 2**20}


def phase_api(state):
    """The driver's options and result surface on FHN and Lorenz (the api
    phase of the module docstring)."""
    import numpy as np
    import torch
    import nngparareal_torch as nt

    dev = state["device"]
    tic = time.perf_counter()
    info, failures, launches = {}, [], {"fhn_ode": 0, "lorenz": 0}

    def counted(field, p, **kw):
        out, n, _ = counted_run(state, field, "api", p, **kw)
        launches[field] += n
        return out

    def held(name, out, lo, hi, conv_int=None):
        k = out["k"]
        info[name] = {"K": k, "K_oracle": [lo, hi] if lo != hi else lo,
                      "conv_int": out["conv_int"]}
        if not out["converged"] or not lo <= k <= hi or (
                conv_int is not None and out["conv_int"] != conv_int):
            failures.append(f"{name}: converged={out['converged']} K={k} "
                            f"conv_int={out['conv_int']}")

    # 1. bare Parareal and PararealLight on FHN
    bare_k = TABLE2["FHN_ODE"][1]
    p_bare = _system_parareal("FHNODE", dev)
    o_bare = counted("fhn_ode", p_bare, model="parareal")
    held("fhn_parareal", o_bare, bare_k, bare_k)
    p_light = _system_parareal("FHNODE", dev, cls=nt.PararealLight)
    o_light = counted("fhn_ode", p_light, model="parareal")
    held("fhn_parareal_light", o_light, bare_k, bare_k)
    if not np.array_equal(o_light["u"], o_bare["u"]):
        failures.append("PararealLight's iterates differ from Parareal's")

    # 2. checkpoints under int_name, resumed with cstm_mdl_name
    p_ck = _system_parareal("FHNODE", dev)
    int_dir = os.path.join(HERE, LOG_DIR, "api_int")
    counted("fhn_ode", p_ck, model="parareal", store_int=True,
            int_name="api_fhn", early_stop=4, int_dir=int_dir)
    zero_counts()
    o_res = p_ck.load_int_dump(os.path.join(int_dir, "api_fhn", "api_fhn_3"),
                               model="parareal", cstm_mdl_name="resumed")
    torch.cuda.synchronize()
    launches["fhn_ode"] += read_counts(state, "fhn_ode", "api")
    held("fhn_resumed", o_res, bare_k, bare_k)
    if not np.array_equal(o_res["u"], o_bare["u"]):
        failures.append("the resumed run's iterates differ from the full "
                        "run's")
    if p_ck.runs.get("resumed") is not o_res:
        failures.append(f"the resumed run is not runs['resumed']: "
                        f"{sorted(p_ck.runs)}")

    # 3. lag_k
    p_lag = _system_parareal("FHNODE", dev)
    o_lag = counted("fhn_ode", p_lag, model="nngp", nn=15, optimizer="grid",
                    lag_k=3)
    held("fhn_nngp_lag_k3", o_lag, *API_LAG_K)
    info["fhn_nngp_lag_k3"]["conv_int_jax_cpu"] = API_LAG_CONV_INT_CPU

    # 4. cap_iters=1, sync_mode='fast', calc_detail_avg
    k_grid, conv_grid = API_FHN_GRID
    table2_conv = [out["conv_int"] for name, _, out in state["table2"]
                   if name == "FHN_ODE nngp"]
    p_opt = _system_parareal("FHNODE", dev)
    o_opt = counted("fhn_ode", p_opt, model="nngp", nn=15, optimizer="grid",
                    cap_iters=1, sync_mode="fast", calc_detail_avg=True)
    held("fhn_nngp_options", o_opt, k_grid, k_grid, conv_grid)
    if table2_conv != [o_opt["conv_int"]]:
        failures.append(f"the options changed conv_int: {o_opt['conv_int']}"
                        f" against table2's {table2_conv}")
    tm = o_opt["timings"]
    detail = tm["calc_detail_avg"]
    starts = [0] + o_opt["conv_int"][:-1]
    swept = np.zeros((o_opt["k"], p_opt.N), dtype=bool)
    for k, I in enumerate(starts):
        swept[k, I + 1:] = True
    if (detail is None or detail.shape != swept.shape
            or not np.isfinite(detail).all()
            or not (detail[swept] > 0).all() or detail[~swept].any()):
        failures.append("calc_detail_avg: "
                        f"{None if detail is None else detail.shape}")
    info["fhn_nngp_options"].update(
        sync_mode=tm["sync_mode"], fused_iter_s=tm["fused_iter_t"],
        detail_shape=list(detail.shape) if detail is not None else None,
        interval_ms_mean=1e3 * float(detail[swept].mean())
        if detail is not None and swept.any() else None)

    # 5. Lorenz and its continuous trajectory
    p_lor = _system_parareal("Lorenz", dev)
    o_lor = counted("lorenz", p_lor, model="parareal")
    held("lorenz_parareal", o_lor, API_LORENZ_K, API_LORENZ_K)
    torch.cuda.synchronize()
    tt = time.perf_counter()
    traj = p_lor.build_cont_traj()
    traj_s = time.perf_counter() - tt
    solver = p_lor.solver
    nf, N = solver.Nf, p_lor.N
    t, u = o_lor["t"], o_lor["u"]
    plain = nt.RKSolver(solver.f, solver.Ng, nf, G=solver.G, F=solver.F,
                        fine="torch", device=dev).run_F_batch(t[:-1], t[1:],
                                                              u[:-1])
    kernel = solver.run_F_batch(t[:-1], t[1:], u[:-1])
    rows = traj.reshape(N, nf + 1, -1)
    scale = float(np.abs(u).max())
    kernel_gap = float(np.abs(rows[:, -1] - kernel.cpu().numpy()).max())
    if traj.shape != (N * (nf + 1), p_lor.n):
        failures.append(f"build_cont_traj shape {traj.shape}")
    else:
        if not np.array_equal(rows[:, 0], u[:-1]):
            failures.append("build_cont_traj's first rows are not u[i]")
        if not np.array_equal(rows[:, -1], plain.cpu().numpy()):
            failures.append("build_cont_traj's last rows differ from the "
                            "plain fan-out on the card")
        if not kernel_gap <= API_TRAJ_RTOL * scale:
            failures.append(f"build_cont_traj's last rows lie {kernel_gap:.3e}"
                            f" from the kernel's fan-out")
    info["lorenz_build_cont_traj"] = {
        "shape": list(traj.shape), "s": traj_s,
        "max_abs_err_vs_kernel": kernel_gap,
        "max_rel_err_vs_kernel": kernel_gap / scale}

    # 6. the tables of every Parareal object above
    for name, p, out in (("fhn_parareal", p_bare, o_bare),
                         ("fhn_parareal_light", p_light, o_light),
                         ("fhn_resumed", p_ck, o_res),
                         ("fhn_nngp_lag_k3", p_lag, o_lag),
                         ("fhn_nngp_options", p_opt, o_opt),
                         ("lorenz_parareal", p_lor, o_lor)):
        info[name].update(reporting_surface(state, f"api {name}", p, out,
                                            store=False))
    if failures:
        raise PhaseError("api: " + "; ".join(failures))
    info["launches"] = launches
    info["s"] = time.perf_counter() - tic
    return info


def phase_mesh(state):
    """The scale-out (the mesh phase of the module docstring)."""
    import numpy as np
    import torch
    import nngparareal_torch as nt
    from nngparareal_torch import experiments
    from nngparareal_torch.parallel import make_mesh, shard_fine_fanout

    dev = state["device"]
    card = [dev] * MESH_BLOCKS
    info, failures, parts = {}, [], {}

    def part(name, fn):
        tic = time.perf_counter()
        info[name] = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - tic

    def bitwise(name, got, want):
        gap = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        if gap != 0.0:
            failures.append(f"{name}: max |difference| {gap:.3e}")
        return gap

    # (a) the fan-out through shard_fine_fanout
    def fanouts():
        out = {}
        p, run = state["flagship"]
        cases = [("burgers", p, run, make_mesh(), None),
                 ("burgers", p, run, make_mesh(devices=card), None)]
        fhn = _system_parareal("FHNODE", dev)
        fhn_run = next(o for n, _, o in state["table2"]
                       if n == "FHN_ODE parareal")
        cases += [("fhn_ode", fhn, fhn_run, make_mesh(devices=card), None),
                  ("fhn_ode", fhn, fhn_run, make_mesh(devices=card), RAGGED)]
        for field, p, run, mesh, B in cases:
            solver = p.solver
            t = torch.as_tensor(run["t"], device=dev)
            u = torch.as_tensor(run["u"], device=dev)
            B = B or p.N
            args = (t[:B].contiguous(), t[1:B + 1].contiguous(),
                    u[:B].contiguous())
            want = solver.run_F_batch(*args)
            if B % mesh.devices.size:
                fan = p._make_fanout(mesh)  # the driver's padding
            else:
                fan = shard_fine_fanout(solver.fine_batch_raw, mesh)
            zero_counts()
            got = fan(*args)
            torch.cuda.synchronize()
            launches = read_counts(state, field, "mesh")
            key = f"{field} B={B} on {mesh.devices.size}"
            out[key] = {
                "mesh_size": int(mesh.devices.size), "launches": launches,
                "pad": (-B) % mesh.devices.size,
                "max_abs_diff": bitwise(key, got.cpu(), want.cpu()),
                "ms": _event_ms(lambda: fan(*args), 3),
                "unsharded_ms": _event_ms(
                    lambda: solver.run_F_batch(*args), 3)}
            if launches != mesh.devices.size:
                failures.append(f"{key}: {launches} launches")
        return out

    # (b) Table 2's FHN and Lorenz, bare Parareal, on 4 blocks
    def table2_bare():
        out = {}
        for name, system, field in (("FHN_ODE", "FHNODE", "fhn_ode"),
                                    ("Lorenz", "Lorenz", "lorenz")):
            want = next(o for n, _, o in state["table2"]
                        if n == f"{name} parareal")
            p = _system_parareal(system, dev)
            got, launches, shapes = counted_run(
                state, field, "mesh", p, model="parareal",
                mesh=make_mesh(devices=card))
            check_iterates(f"{name} parareal (mesh)", p, got)
            state["table2"].append((f"{name} parareal (mesh)", p, got))
            out[name] = {"K": got["k"], "K_oracle": TABLE2[name][1],
                         "conv_int": got["conv_int"],
                         "runtime_s": got["timings"]["runtime"],
                         "fine_s": got["timings"]["F_time"],
                         "unsharded_fine_s": want["timings"]["F_time"],
                         "launches": launches,
                         "launches_by_shape": shapes,
                         "max_abs_diff": bitwise(f"{name} mesh u", got["u"],
                                                 want["u"])}
            if got["k"] != TABLE2[name][1] or not got["converged"]:
                failures.append(f"{name} mesh: K={got['k']}")
        return out

    # (c) GParareal's grid search with its task pool on 2 blocks
    def gp_grid():
        want = next(o for n, _, o in state["table2"]
                    if n == "FHN_ODE GP (grid)")
        p = _system_parareal("FHNODE", dev)
        got, launches, _ = counted_run(
            state, "fhn_ode", "mesh", p, model="gpjax", optimizer="grid",
            fatol=1e-6, xatol=1e-6,
            mesh=make_mesh(devices=[dev] * MESH_GP_BLOCKS), add_model=True)
        check_iterates("FHN_ODE GP (grid, mesh)", p, got)
        state["table2"].append(("FHN_ODE GP (grid, mesh)", p, got))
        if (got["k"], got["conv_int"]) != (GP_GRID_FHN_K,
                                           GP_GRID_FHN_CONV_INT_CPU):
            failures.append(f"GP grid mesh: K={got['k']} "
                            f"conv_int={got['conv_int']}")
        if got["mdl"].mesh is None:
            failures.append("GP grid mesh: the model did not shard")
        tm = got["timings"]
        return {"K": got["k"], "conv_int": got["conv_int"],
                "runtime_s": tm["runtime"], "train_s": tm["mdl_train_t"],
                "unsharded_train_s": want["timings"]["mdl_train_t"],
                "buckets": tm["gp_buckets"], "launches": launches,
                "max_abs_diff": bitwise("GP grid mesh u", got["u"],
                                        want["u"])}

    # (d) score_lanes on the cut FHN
    def lanes():
        from nngparareal_torch.ops import gp_lanes

        ode = nt.FHNODE(normalization="-11", device=dev)
        cfg = nt.Config(ode).get()
        cfg["Nf"] //= LANES_CUT["fine_cut"]
        width = (cfg["tspan"][1] - cfg["tspan"][0]) / cfg["N"]
        n = LANES_CUT["slices"]
        solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                             G=cfg["G"], F=cfg["F"],
                             device_field=ode.get_device_field(), device=dev)
        p = nt.Parareal(ode, solver, [cfg["tspan"][0],
                                      cfg["tspan"][0] + n * width], n,
                        epsilon=5e-7, device=dev)
        factor = gp_lanes.cholesky_lanes_blocked
        calls = {}

        def counted_factor(A, *args, **kwargs):
            calls[A.shape[0]] = calls.get(A.shape[0], 0) + 1
            return factor(A, *args, **kwargs)

        gp_lanes.cholesky_lanes_blocked = counted_factor
        try:
            got, launches, _ = counted_run(
                state, "fhn_ode", "mesh", p, model="gpjax",
                optimizer="grid", score_lanes=True, fatol=1e-6, xatol=1e-6)
        finally:
            gp_lanes.cholesky_lanes_blocked = factor
        check_iterates("FHN_ODE GP (score_lanes, cut)", p, got)
        state["table2"].append(("FHN_ODE GP (score_lanes, cut)", p, got))
        if (got["k"], got["conv_int"]) != (LANES_K, LANES_CONV_INT_CPU):
            failures.append(f"score_lanes: K={got['k']} "
                            f"conv_int={got['conv_int']}")
        tm = got["timings"]
        return {"K": got["k"], "K_jax_cpu": LANES_K,
                "conv_int": got["conv_int"],
                "conv_int_jax_cpu": LANES_CONV_INT_CPU,
                "runtime_s": tm["runtime"], "train_s": tm["mdl_train_t"],
                "buckets": tm["gp_buckets"],
                "factor_calls_by_rows": calls, "launches": launches}

    # (e) run_table2(pool=2) in two spawned processes on the card
    def pool():
        # the workers' own prints go to the log, as the phase's do
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(state["log_fd"], 1)
        tic = time.perf_counter()
        try:
            rows = experiments.run_table2(
                TABLE2_EPS, models=("parareal",), results_dir=None,
                systems=["FHN_ODE", "Lorenz"], pool=2)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        wall = time.perf_counter() - tic
        out = {"wall_s": wall}
        for row in rows:
            (r,) = row["runs"]
            want = next(o for n, _, o in state["table2"]
                        if n == f"{row['system']} parareal")
            out[row["system"]] = {"K": r["k"], "conv_int": r["conv_int"]}
            if (r["k"], r["conv_int"]) != (want["k"], want["conv_int"]) or (
                    r["k"] != TABLE2[row["system"]][1]):
                failures.append(f"pool {row['system']}: K={r['k']}")
            bitwise(f"pool {row['system']} err", r["err"], want["err"])
        if [r["system"] for r in rows] != ["FHN_ODE", "Lorenz"]:
            failures.append(f"pool ran {[r['system'] for r in rows]}")
        return out

    part("fanout", fanouts)
    part("table2_bare", table2_bare)
    part("gp_grid", gp_grid)
    part("score_lanes", lanes)
    part("pool", pool)
    info["parts_s"] = parts
    if failures:
        raise PhaseError("mesh: " + "; ".join(failures))
    return info


# --- the double-single fan-out: ops/rk_cuda_ds.py, csrc/ds_fanout.cu

# NVIDIA H100 SXM data sheet: f32 without the tensor cores (an FMA counted
# as two operations); the ds kernel's operations are mostly unfused (its
# only FMAs are TwoProd's error terms and the fixed divisions'
# corrections), each an instruction slot, so they go at half that rate,
# as the f64 per-slice kernel's do
FP32_PEAK = 67e12
# the cut steps of the kernel against its plain version on the card (held
# bitwise: max |diff| 0.0), and the tolerance against the f64 kernel at
# the full steps (tests/test_rk_ds.py: 3.3e-11 at the flagship's slice).
# The plain version's eager ds ops cost ~0.4 s a step for DblPend on an
# H100 (83.1 s for 200 steps; the seven ODE fields 118 s at 200 steps), so
# the ODE fields are checked at 10 steps and the PDEs at 20
DS_CHECK_STEPS = {"pde": 20, "ode": 10}
DS_F64_ATOL = 1e-9
# FHN-PDE at full steps would take ~9 s in ds: one launch at 1/8 of them,
# timed and scaled by 8
DS_FHN_PDE_CUT = 8
# the TPU's double-single flagship (BENCH_r05.json: fine_resolved
# "pallas", K=12)
TPU_DS_FLAGSHIP_K = 12
# the per-slice form's path: bare Parareal on Lorenz with fine='pallas',
# the K of the api phase's f64 run (API_LORENZ_K)
DS_LORENZ_K = API_LORENZ_K
# the fields whose ds kernel a path of the ds phase drives
DS_PATHS = ("burgers", "lorenz")

# f32 operations of one ds operation of csrc/ds32.cuh (every intrinsic and
# rintf; a division one, a negation none), as the header's host build
# counts them (tests/test_torch_ds32_host.py): TwoProd by FMA, add, add of
# an f32, multiply (TwoProd 2, cross terms 3, their add into the error 1,
# FastTwoSum 3), multiply by an f32, division by a divisor that changes
# (three __fdiv_rn), by a divisor fixed for the launch with one or two
# corrections (div_by, straight-line), an exact power-of-two scaling,
# ds_axpy, ds_scale, and one reduction giving sin and cos. The kernel's
# first form took Dekker's TwoProd (17) and divided everywhere: 24 a
# multiply, 82 a division, 38 a ds_axpy and 630 a sin_cos (PERF.md keeps
# its bound).
DS_OPS = {"two_prod": 2, "add": 11, "add_f32": 10, "mul": 9, "mul_f32": 7,
          "div": 52, "div_by1": 58, "div_by2": 64, "pow2": 2, "axpy": 23,
          "scale": 12, "sin_cos": 354}
# Dependent f32 operations from each operand of a ds operation to its
# result, "d" for each __fdiv_rn on the path (taken at its own latency),
# counted by the same host build: e.g. ds_axpy from the running sum u 9,
# from k 17
DS_DEPTH = {"two_prod": {"a": "2"}, "add": {"x": "9", "y": "9"},
            "add_f32": {"x": "9", "y": "9"}, "mul": {"x": "6", "y": "6"},
            "mul_f32": {"x": "6", "y": "6"},
            "div": {"x": "31ddd", "y": "31ddd"}, "div_by1": {"x": "40"},
            "div_by2": {"x": "46"}, "pow2": {"x": "1"},
            "axpy": {"u": "9", "k": "17"}, "scale": {"x": "10"},
            "sin_cos": {"x": "136"}}


def _depth_cost(entry, lat):
    """The latency of a DS_DEPTH entry: its operations at lat["op"], its
    divisions at lat["div"]."""
    ops = int("".join(ch for ch in entry if ch.isdigit()) or 0)
    return ops * lat["op"] + entry.count("d") * lat["div"]


class _DsTrace:
    """Evaluates a ds field's expression for its cost: each value is a
    dict from input coordinate to the latest path from it (at the
    latencies ``lat``), a constant None; ``ops`` sums the f32 operations
    (DS_OPS) of the operations called."""

    def __init__(self, lat):
        self.lat = lat
        self.ops = 0

    def op(self, name, **operands):
        self.ops += DS_OPS[name]
        out = {}
        for group, val in operands.items():
            for src, t in (val or {}).items():
                t += _depth_cost(DS_DEPTH[name][group], self.lat)
                out[src] = max(out.get(src, t), t)
        return out

    def add(self, x, y):  # ds_add, ds_sub
        return self.op("add", x=x, y=y)

    def add32(self, x, y):
        return self.op("add_f32", x=x, y=y)

    def mul(self, x, y):
        return self.op("mul", x=x, y=y)

    def div(self, x, y):
        return self.op("div", x=x, y=y)

    def div_by(self, x, corrections):
        return self.op(f"div_by{corrections}", x=x)

    def pow2(self, x):
        return self.op("pow2", x=x)

    def scale(self, x):
        return self.op("scale", x=x)

    def sin_cos(self, x):
        return self.op("sin_cos", x=x)


# Each ds field of csrc/ds_fanout.cu as ``_DsTrace`` calls, in its own
# expression's order: (t, u) -> f, with u and f lists of values. A lane
# field's reductions count once each (its fourth lane's repeat is no work
# the result needs), and the lanes' exchange is not on the path.
def _ds_fhn_ode(t, u):
    cube = t.mul(t.mul(u[0], u[0]), u[0])
    return [t.mul(None, t.add(t.add(u[0], t.div_by(cube, 1)), u[1])),
            t.mul(None, t.add(t.add(u[0], None), t.mul(None, u[1])))]


def _ds_rossler(t, u):
    return [t.add(u[1], u[2]), t.add(u[0], t.mul(None, u[1])),
            t.add(None, t.mul(u[2], t.add(u[0], None)))]


def _ds_hopf(t, u):
    mu = t.add(t.add(t.div_by(u[2], 2), t.mul(u[0], u[0])),
               t.mul(u[1], u[1]))
    return [t.add(u[1], t.mul(u[0], mu)), t.add(u[0], t.mul(u[1], mu)),
            None]


def _ds_dblpend(t, u):
    sd = cd = t.sin_cos(t.add(u[0], u[2]))
    sin0, sin2 = t.sin_cos(u[0]), t.sin_cos(u[2])
    sq1, sq3 = t.mul(u[1], u[1]), t.mul(u[3], u[3])
    den_in = t.add(None, t.mul(cd, cd))
    d1 = t.add(t.add(t.add(t.mul(t.mul(sq1, cd), sd), t.mul(sq3, sd)),
                     t.pow2(sin0)), t.mul(cd, sin2))
    d3 = t.add(t.add(t.add(t.mul(t.pow2(sq1), sd),
                           t.mul(t.mul(sq3, sd), cd)),
                     t.mul(t.pow2(cd), sin0)), t.pow2(sin2))
    den = t.div(None, den_in)
    return [u[1], t.mul(den, d1), u[3], t.mul(den, d3)]


def _ds_brusselator(t, u):
    sq = t.mul(t.mul(u[0], u[0]), u[1])
    return [t.add(t.add(None, sq), t.pow2(u[0])),
            t.add(t.mul(None, u[0]), sq)]


def _ds_lorenz(t, u):
    return [t.mul(None, t.add(u[1], u[0])),
            t.add(t.add(t.mul(None, u[0]), u[1]), t.mul(u[0], u[2])),
            t.add(t.mul(u[0], u[1]), t.mul(None, u[2]))]


def _ds_tomlab(t, u):
    s = [t.mul(None, t.sin_cos(u[c])) for c in range(3)]
    return [t.add(t.pow2(u[c]), s[(c + 1) % 3]) for c in range(3)]


def _ds_burgers(t, u):
    # u: the stage input, its neighbours loaded after the exchange alike
    v = vp = vm = u[0]
    s = t.add(t.add(vp, vm), t.pow2(v))
    x = t.scale(t.add(vp, vm))
    return [t.add(t.scale(s), t.mul(t.add32(v, None), x))]


def _ds_fhn_pde(t, u):
    # the fold w = (v + 1) - 1 of each species before the exchange, then
    # the two Laplacians of the loaded neighbours
    w = [t.add(t.add(u[c], None), None) for c in range(2)]

    def lap(g):
        c2 = t.pow2(g)
        return t.add(t.div_by(t.add(t.add(g, c2), g), 2),
                     t.div_by(t.add(t.add(g, c2), g), 2))

    u1, u2 = w
    s1 = t.add(t.mul(lap(u1), None), u1)
    s2 = t.add(t.mul(lap(u2), None), u1)
    cube = t.mul(u1, t.mul(u1, u1))
    return [t.add(t.add(t.add(s1, cube), u2), None),
            t.mul(t.add(s2, u2), None)]


DS_FIELDS = {"fhn_ode": _ds_fhn_ode, "rossler": _ds_rossler,
             "hopf": _ds_hopf, "dblpend": _ds_dblpend,
             "brusselator": _ds_brusselator, "lorenz": _ds_lorenz,
             "tomlab": _ds_tomlab, "burgers": _ds_burgers,
             "fhn_pde": _ds_fhn_pde}


def ds_field_trace(field, lat):
    """(f32 operations of one evaluation per kernel thread, paths): paths
    [i][c] is the latest path from state coordinate i to component c at
    the latencies ``lat`` (None: no path), through the ODE fields' [-1,1]
    map where they have one, ((v + 1) halved) * span + mn before the raw
    field and * scale after it. A per-cell field has one row, from its
    stage input (the PDE fields: FHN-PDE's two species together)."""
    t = _DsTrace(lat)
    per_cell = field.name in PER_CELL
    u = [{0 if per_cell else i: 0.0} for i in range(field.values)]
    mapped = getattr(field, "mn", None) is not None
    if mapped:
        u = [t.add(t.mul(t.pow2(t.add(v, None)), None), None) for v in u]
    f = DS_FIELDS[field.name](t, u)
    if mapped:
        f = [t.mul(v, None) if v is not None else None for v in f]
    rows = 1 if per_cell else field.values
    paths = [[(v or {}).get(i) for v in f] for i in range(rows)]
    return t.ops, paths


def ds_ops_per_thread_step(tab, field):
    """f32 operations per ds kernel thread (per slice for the ODE fields)
    per RK step: one field evaluation per stage (and the ODE fields' map),
    and a ds_axpy for each state value of the thread per nonzero a_ij and
    b_i."""
    nz = (sum(1 for row in tab.a for x in row if x != 0.0)
          + sum(1 for x in tab.b if x != 0.0))
    ops, _ = ds_field_trace(field, UNIT)
    return ops * tab.stages + field.values * nz * DS_OPS["axpy"]


def ds_chain_cycles(tab, field, lat, steps=64):
    """The longest chain of dependent f32 operations through one ds RK
    step in steady state, at the latencies ``lat`` (cycles of an f32 add,
    multiply or FMA, "op"; of a __fdiv_rn, "div"; of the per-cell
    exchange, "sync"). As ``chain_cycles``, in the kernel's order: stage
    s's input is u plus its ds_axpy terms in increasing j (from k_j and
    from the running sum, DS_DEPTH["axpy"]); the step's weight sum starts
    at u and is the next u; the field's paths from ``ds_field_trace``."""
    per_cell = field.name in PER_CELL
    _, L = ds_field_trace(field, lat)
    from_k = _depth_cost(DS_DEPTH["axpy"]["k"], lat)
    from_sum = _depth_cost(DS_DEPTH["axpy"]["u"], lat)
    S, D = tab.stages, len(L[0])
    u = [0.0] * D
    marks = []
    for _ in range(steps):
        acc = [list(u) for _ in range(S)]
        out = list(u)
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
                    acc[i] = [max(acc[i][c] + from_sum, k[c] + from_k)
                              for c in range(D)]
            if tab.b[s] != 0.0:
                out = [max(out[c] + from_sum, k[c] + from_k)
                       for c in range(D)]
        u = out
        marks.append(max(u))
    half = steps // 2
    return (marks[-1] - marks[half - 1]) / (steps - half)


def ds_chain_latency(latency, field, d):
    """The probe's cycles as ds_chain_cycles takes them: the fastest f32
    add, multiply or FMA, the __fdiv_rn, the per-cell exchange round."""
    cyc = latency["cycles"]
    return {"op": min(cyc["add_f32"], cyc["mul_f32"], cyc["fma_f32"]),
            "div": cyc["div_f32"],
            "sync": cyc[f"sync{d // field.values}"]
            if field.name in PER_CELL else 0.0}


def ds_bound(tab, field, B, d, steps, latency):
    """The least time of a ds fan-out, the largest of: f32 operations
    (``ds_ops_per_thread_step``) over half the 67 TFLOP/s f32 peak (one
    operation an instruction slot: the peak counts an FMA as two); the bytes
    (the f64 state read and written once) over the memory rate; the chain
    (``ds_chain_cycles``) at the probe's latencies over its clock."""
    threads = B * (d // field.values)
    ops = threads * steps * ds_ops_per_thread_step(tab, field)
    times = {"operations": ops / (FP32_PEAK / 2) * 1e3,
             "bytes": 16 * B * d / HBM_BYTES_PER_S * 1e3,
             "chain": (steps * ds_chain_cycles(tab, field, ds_chain_latency(
                 latency, field, d)) / latency["clock_hz"] * 1e3)}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by, "f32_ops": ops,
            "operations_ms": times["operations"], "bytes_ms": times["bytes"],
            "chain_ms": times["chain"]}


def ds_cases(dev):
    """Each field's ds path shape: (key, ode, U, width, tableau, steps, B)
    at the f64 kernels phase's shapes (Burgers the flagship's first
    fan-out's states, FHN-PDE and the ODEs u0 plus a seeded perturbation
    on slices of the configuration's width)."""
    import numpy as np
    import torch
    import nngparareal_torch as nt
    from nngparareal_torch.experiments import fhn_pde_parareal

    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    cases = []
    cfg = FLAGSHIP
    ode = nt.Burgers(d_x=cfg["d_x"], normalization="-11", device=dev)
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"], fine="torch", device=dev)
    t = torch.linspace(0.0, cfg["T"], cfg["N"] + 1, dtype=torch.float64,
                       device=dev)
    U = solver.run_G_chain(t, ode.get_init_cond())[:-1].contiguous()
    cases.append(("burgers", ode, U, (t[1] - t[0]).item(), cfg["F"],
                  cfg["Nf"]))
    p = fhn_pde_parareal(FHN_PDE_DX, device=dev)
    rng = np.random.default_rng(0)
    Up = p.ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0, (p.N, p.n))
    cases.append(("fhn_pde", p.ode, as_t(Up),
                  (p.tspan[1] - p.tspan[0]) / p.N, p.solver.F.name,
                  p.solver.Nf))
    for kind, (cls, N_arg) in ODE_SYSTEMS.items():
        ode = getattr(nt, cls)(normalization="-11", device=dev)
        c = nt.Config(ode, N=N_arg).get()
        rng = np.random.default_rng(0)
        Uo = ode.u0[None, :] + 0.05 * rng.uniform(-1.0, 1.0,
                                                   (c["N"], ode.get_dim()))
        cases.append((kind, ode, as_t(Uo),
                      (c["tspan"][1] - c["tspan"][0]) / c["N"], c["F"],
                      c["Nf"]))
    return cases


def ds_flagship(state):
    """(c): bench.py:90-121's flagship with fine='pallas' through
    Parareal.run; its launches counted alone."""
    import numpy as np
    import torch
    import nngparareal_torch as nt

    cfg = FLAGSHIP
    dev = state["device"]
    ode = nt.Burgers(d_x=cfg["d_x"], normalization="-11", device=dev)
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"],
                         fine_ds=ode.get_ds_vector_field(), fine="pallas",
                         device_field=ode.get_device_field(), device=dev)
    p = nt.Parareal(ode, solver, [0.0, cfg["T"]], cfg["N"],
                    epsilon=cfg["eps"], device=dev)
    zero_counts()
    out = p.run(model="nngp", nn=cfg["nn"], seed=cfg["seed"],
                optimizer="grid")
    torch.cuda.synchronize()
    launches = read_counts(state, "burgers_ds", "ds_flagship")
    check_iterates("ds flagship", p, out)
    _, f64_out = state["flagship"]
    diff = float(np.abs(np.asarray(out["u"]) - np.asarray(f64_out["u"]))
                 .max())
    tm = out["timings"]
    info = {"K": out["k"], "converged": out["converged"],
            "conv_int": out["conv_int"], "K_f64": f64_out["k"],
            "K_tpu_ds": TPU_DS_FLAGSHIP_K, "runtime_s": tm["runtime"],
            "fine_s": tm["F_time"], "model_s": tm["mdl_pred_t"],
            "coarse_s": tm["G_time"], "ds_launches": launches,
            "max_abs_diff_vs_f64_flagship": diff}
    if not out["converged"] or not K_RANGE[0] <= out["k"] <= K_RANGE[1]:
        raise PhaseError(f"ds flagship: converged={out['converged']} K="
                         f"{out['k']}, expected convergence with K in "
                         f"{list(K_RANGE)}")
    return info


def ds_lorenz(state):
    """(d): the per-slice form's path, bare Parareal on Lorenz at its
    Table-2 configuration with fine='pallas' through Parareal.run; the ds
    kernel's launches counted (its coarse solves launch the f64 kernel at
    B=1, counted apart); K as the f64 run's."""
    import torch
    import nngparareal_torch as nt
    from nngparareal_torch.ops import rk_cuda

    dev = state["device"]
    ode = nt.Lorenz(normalization="-11", device=dev)
    cfg = nt.Config(ode).get()
    solver = nt.RKSolver(ode.get_vector_field(), cfg["Ng"], cfg["Nf"],
                         G=cfg["G"], F=cfg["F"],
                         fine_ds=ode.get_ds_vector_field(), fine="pallas",
                         device_field=ode.get_device_field(), device=dev)
    p = nt.Parareal(ode, solver, cfg["tspan"], cfg["N"], epsilon=5e-7,
                    device=dev)
    zero_counts()
    out = p.run(model="parareal")
    torch.cuda.synchronize()
    counts = dict(rk_cuda.rk_fanout.launches_by_field)
    others = {k: v for k, v in counts.items()
              if v and k not in ("lorenz_ds", "lorenz")}
    if counts["lorenz_ds"] < 1 or others:
        raise PhaseError(f"ds Lorenz: the ds kernel must launch, and no "
                         f"kernel but it and the f64 coarse solves: {counts}")
    launches, shapes = record_launches(state, "lorenz_ds", "ds_lorenz")
    coarse, _ = record_launches(state, "lorenz", "ds_lorenz")
    check_iterates("ds Lorenz", p, out)
    info = {"K": out["k"], "converged": out["converged"],
            "conv_int": out["conv_int"], "runtime_s":
            out["timings"]["runtime"], "fine_s": out["timings"]["F_time"],
            "ds_launches": launches, "ds_launches_by_shape": shapes,
            "f64_coarse_launches": coarse}
    if not out["converged"] or out["k"] != DS_LORENZ_K:
        raise PhaseError(f"ds Lorenz: converged={out['converged']} K="
                         f"{out['k']}, expected {DS_LORENZ_K}")
    return info


def phase_ds(state):
    """The double-single fan-out (ops/rk_cuda_ds.py): (a) each field's ds
    kernel against its plain version on the card at cut steps, bitwise;
    (b) at its path's full shape and steps, timed, against the f64 kernel
    on the same inputs; (c) the flagship with fine='pallas' (the per-cell
    form's path) and (d) Lorenz with fine='pallas' (the per-slice
    form's). Each field's kernel is an entry of the kernels line."""
    import torch
    from nngparareal_torch.ops import rk_cuda, rk_cuda_ds
    from nngparareal_torch.ops.butcher import get_tableau

    dev = state["device"]
    info = {}
    parts = {}
    for key, ode, U, width, tab_name, steps in ds_cases(dev):
        tic = time.perf_counter()
        tab = get_tableau(tab_name)
        field, f_ds = ode.get_device_field(), ode.get_ds_vector_field()
        B, d = U.shape
        dt_cut = width / steps
        cut = DS_CHECK_STEPS["pde" if key in PER_CELL else "ode"]
        # (a) at the cut steps, the same step width as the full run's
        got = rk_cuda_ds.ds_fanout(U, tab, cut, dt_cut, field, f_ds)
        torch.cuda.synchronize()
        tic_p = time.perf_counter()
        want = rk_cuda_ds.plain_fanout_ds(f_ds, tab, cut, U, dt_cut)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - tic_p) * 1e3
        err = (got - want).abs().max().item()
        if not err == 0.0:
            raise PhaseError(f"{key} ds kernel vs plain at {cut} steps: max "
                             f"|diff| {err:.3e}, not bitwise")
        # (b) full steps (FHN-PDE: 1/8 of them, the time scaled by 8),
        # against the f64 kernel at the same width
        full = steps // DS_FHN_PDE_CUT if key == "fhn_pde" else steps
        scale = steps / full
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        got = rk_cuda_ds.ds_fanout(U, tab, full, dt_cut, field, f_ds)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) * scale
        t0s = torch.zeros(B, dtype=torch.float64, device=dev)
        t1s = torch.full((B,), dt_cut * full, dtype=torch.float64,
                         device=dev)
        f64 = rk_cuda.rk_fanout(t0s, t1s, U, tab, full, field,
                                ode.get_vector_field())
        err64 = (got - f64).abs().max().item()
        if not err64 <= DS_F64_ATOL:
            raise PhaseError(f"{key} ds kernel vs f64 kernel at {full} "
                             f"steps: max |diff| {err64:.3e} > "
                             f"{DS_F64_ATOL}")
        bnd = ds_bound(tab, field, B, d, steps, state["latency"])
        # the kernels line: every field's ds kernel; its launches come from
        # its path's run, (c) or (d), and stay 0 where no path drives it
        state["kernels"][f"{key}_ds"] = {
            "name": f"ds_fanout[{key}]", "route": "cuda",
            "source": "nngparareal_torch/csrc/ds_fanout.cu",
            "replaces": "nngparareal_tpu/ops/rk_pallas.py:194",
            "form": "per cell" if key in PER_CELL else "per slice",
            "launches": None if key in DS_PATHS else 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_steps": cut, **bnd, "library_ms": None, "shape": [B, d],
            "steps": steps, "steps_timed": full, "tableau": tab.name,
            "max_abs_err_vs_f64": err64}
        info[key] = {"B": B, "d": d, "tableau": tab.name, "steps": steps,
                     "max_abs_diff_plain": err, "plain_steps": cut,
                     "plain_ms": plain_ms, "ms": ms, "steps_timed": full,
                     "max_abs_diff_f64": err64,
                     **{k: bnd[k] for k in ("bound_ms", "bound_by",
                                            "chain_ms", "operations_ms",
                                            "bytes_ms")}}
        parts[key] = time.perf_counter() - tic
    for name, fn in (("flagship_pallas", ds_flagship),
                     ("lorenz_pallas", ds_lorenz)):
        tic = time.perf_counter()
        info[name] = fn(state)
        parts[name] = time.perf_counter() - tic
    info["parts_s"] = parts
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

    # the whole output, the drivers' per-iteration lines included, also
    # goes to a file: the standard output keeps the phases' lines only
    os.makedirs(os.path.join(HERE, LOG_DIR), exist_ok=True)
    log = open(os.path.join(HERE, LOG_DIR, "chip_smoke.log"), "w")
    phases = Phases(log)

    def on_alarm(signum, frame):
        raise PhaseError(f"deadline of {DEADLINE_S}s hit in phase "
                         f"'{phases.current}'")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(DEADLINE_S)
    state = {"device": torch.device("cuda", 0), "kernels": {},
             "notes": phases.notes, "log_fd": log.fileno()}
    t_start = time.perf_counter()
    try:
        env = phases.run("env", phase_env)
        phases.run("build", phase_build, state)
        phases.run("kernels", phase_kernels, state)
        phases.run("flagship", phase_flagship, state)
        phases.run("fhn_pde", phase_fhn_pde, state)
        phases.run("table2", phase_table2, state)
        phases.run("table2_nm", phase_table2_nm, state)
        phases.run("table2_gp", phase_table2_gp, state)
        phases.run("figure2", phase_figure2, state)
        phases.run("variants", phase_variants, state)
        phases.run("api", phase_api, state)
        phases.run("mesh", phase_mesh, state)
        phases.run("ds", phase_ds, state)
        phases.run("serial", phase_serial, state)
        phases.run("profile", phase_profile, state)
    except Exception as exc:  # report the phase, exit nonzero
        signal.alarm(0)
        print(f"chip_smoke: FAILED in phase '{phases.current}': "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        import traceback

        traceback.print_exc()
        return 1
    signal.alarm(0)
    phases.emit(f"[total] {time.perf_counter() - t_start:.3f}s")
    phases.emit(json.dumps({"kernels": list(state["kernels"].values())}))
    phases.emit(env["nvidia_smi"])
    log.close()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
