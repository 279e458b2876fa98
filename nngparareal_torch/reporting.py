"""Timing tables, speedup calculators and diagnostic plots.

Port of ``nngparareal_tpu/reporting.py``: the theoretical speedup
calculators, the Markdown/LaTeX tables ``print_times`` and
``print_speedup``, the convergence plots and the Figure-1 mechanics figure
and animation. matplotlib (with cycler and PillowWriter) is imported only
inside the plotting functions: the calculators and tables need none of it.
The mechanics helpers build their own toy Parareal with the port's
classes, on the CUDA card unless ``device`` says otherwise (``"cpu"``), as
every entry point of the port: with no card and no ``device`` they raise.
"""

import numpy as np
import torch

from nngparareal_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# theoretical speedup machinery (article_lib.py:58-115)
# ---------------------------------------------------------------------------

def est_serial(run, N):
    """Estimated serial fine cost: per-slice fine time x N.

    run['timings']['F_time_serial_avg'] accumulates one per-slice fine
    time per iteration (K terms), so divide by K first.
    """
    k = max(run["k"], 1)
    return run["timings"]["F_time_serial_avg"] / k * N


def get_act_cost(run):
    return run["timings"]["runtime"]


def get_act_mdl_cost(run):
    return run["timings"]["mdl_tot_t"]


def calc_speedup(run, N=None, serial=None):
    if serial is None:
        if N is None:
            raise Exception("Cannot compute speedup without either N or serial.")
        serial = est_serial(run, N)
    return serial / get_act_cost(run)


def calc_exp_gp_cost(run, n_cores, d, n_jitter=9, **kwargs):
    """Expected full-GP model cost on n_cores workers (article_lib.py:57-61)."""
    Tm = run["timings"].get("avg_serial_train_time", 0.0)
    return run["timings"]["mdl_pred_t"] + np.sum(
        Tm * max(n_jitter * d / n_cores, 1)
    )


def calc_exp_nngp_cost_rough(run, n_cores, N, d, n_jitter=9, n_restarts=1, **kw):
    k = run["k"]
    Tm = run["timings"].get("avg_serial_train_time", 0.0)
    return k * (Tm * max((n_jitter * n_restarts * d) / n_cores, 1)) * (N - (k + 1) / 2)


def calc_exp_nngp_cost_precise(run, n_cores, N, d, n_jitter=9, n_restarts=1, **kw):
    Tm = run["timings"].get("avg_serial_train_time", 0.0)
    conv_int = np.array([0] + list(run["conv_int"][:-1]))
    return float(
        ((N - conv_int) * (Tm * max((n_jitter * n_restarts * d) / n_cores, 1))).sum()
    )


def calc_exp_speedup(run, mdl_cost_fn, N, **kwargs):
    serial = est_serial(run, N)
    Tf = run["timings"]["F_time_serial_avg"]
    Tg = run["timings"]["G_time"]
    return serial / (Tf + Tg + mdl_cost_fn(run, N=N, **kwargs))


# ---------------------------------------------------------------------------
# tables (parareal.py:636-758)
# ---------------------------------------------------------------------------

def _np(x):
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def print_times(p, mdl_speedup=None, expected_fine=None):
    """Markdown table of G/F/model/total times + speedup per stored run.

    As in the JAX package, the "Fine" row's time (``p.fine_t``, measured
    here when it is unknown) is ``p.solver.run_F_timed(tspan[0],
    tspan[-1], u0)``: ONE solve of Nf steps (the per-slice count) over the
    whole span, not the serial fine solve of all N slices, so its
    "Speedup" column is no speed-up over a serial fine run.
    """
    if mdl_speedup is None and p.fine is None:
        fine, fine_t = p.solver.run_F_timed(p.tspan[0], p.tspan[-1], p.u0)
        p.fine, p.fine_t = _np(fine), fine_t

    use_mdl_speedup = False
    s_ref = None
    if mdl_speedup is not None and mdl_speedup in p.runs:
        s_ref = p.runs[mdl_speedup]["timings"]["mdl_tot_t"]
        use_mdl_speedup = True

    cols = ["Model", "K", "G", "F", "Train", "Pred", "Mdl Tot", "Overall", "Speedup"]
    if use_mdl_speedup:
        cols[-1] = "Mdl Speedup"
    fmt = lambda x: f"{x:.2e}"
    attrs = ["G_time", "F_time", "mdl_train_t", "mdl_pred_t", "mdl_tot_t", "runtime"]

    rows = []
    if use_mdl_speedup:
        rows.append(["Fine", "-", "-", "-", "-", "-", "-", "-", "-"])
    else:
        rows.append(
            ["Fine", "-", "-", "-", "-", "-", "-", fmt(p.fine_t), "1"]
        )
    for name, v in p.runs.items():
        row = [name, str(v["k"])]
        row += [fmt(v["timings"][a]) for a in attrs]
        if use_mdl_speedup:
            row.append(f"{s_ref / v['timings']['mdl_tot_t']:.2f}")
        else:
            row.append(f"{p.fine_t / v['timings']['runtime']:.2f}")
        rows.append(row)

    widths = [
        max(len(cols[i]), max(len(r[i]) for r in rows)) for i in range(len(cols))
    ]
    lines = ["|" + "|".join(f"{c:^{widths[i]}}" for i, c in enumerate(cols)) + "|"]
    lines.append("|" + "|".join("-" * w for w in widths) + "|")
    for r in rows:
        lines.append("|" + "|".join(f"{c:^{widths[i]}}" for i, c in enumerate(r)) + "|")
    out = "\n".join(lines)
    print(out)
    return out


def print_speedup(p, mdls=None, md=True, fine_t=None, F_t=None, mdl_title=""):
    """Markdown or LaTeX speedup table (parareal.py:697-758)."""
    out = []
    if md:
        beg, end, sep, F, G = "|", "|", " | ", "F", "G"
    else:
        beg, end, sep = "", r"\\", " & "
        F, G = r"$T_{\f}$", r"$T_{\g}$"
    fmt = lambda x: f"{x:.2e}"
    out.append(["Model", "K", G, F, "Model", "Total", "Speed-up"])
    n_cols = len(out[0])
    if F_t is not None:
        fine_t = F_t * p.N
    out.append(["---"] * n_cols if md else [r"\hline"])
    if fine_t is None:
        fine_t = p.fine_t
    if fine_t is None:
        raise Exception("Running time of fine solver unknown/not provided")
    mdl_map = {"GP": "GParareal", "NNGP": "NN-GParareal"}
    out.append(["Fine", "-", "-", "-", "-", fmt(fine_t), "1"])
    if mdls is None:
        mdls = {i: i for i in p.runs}
    for key, label in mdls.items():
        if key not in p.runs:
            raise Exception("Unknown model", key)
        r = p.runs[key]
        if F_t is not None:
            tot = F_t * r["k"] + r["timings"]["mdl_tot_t"]
            speedup = f"{fine_t / tot:.2f}"
        else:
            speedup = f"{fine_t / r['timings']['runtime']:.2f}"
        out.append(
            [
                mdl_map.get(label, label),
                str(r["k"]),
                fmt(r["timings"]["G_time"] / r["k"]),
                fmt(r["timings"]["F_time"] / r["k"]),
                fmt(r["timings"]["mdl_tot_t"]),
                fmt(r["timings"]["runtime"]),
                speedup,
            ]
        )
    out = [[str(j) for j in i] for i in out]
    out = [beg + sep.join(i) + end for i in out]
    if not md:
        res = [r"\caption*{" + mdl_title + r", $N=" + f"{p.N}" + r"$}"]
        res.append(r"\begin{tabular}{lcccccc}")
        res.extend(out)
        res.append(r"\end{tabular}\\    \bigskip" + "\n")
        out = res
    else:
        out = [f"$N={p.N}$\n"] + out
    out = "\n".join(out)
    print(out)
    return out


# ---------------------------------------------------------------------------
# plots (parareal.py:513-634, 763-779)
# ---------------------------------------------------------------------------

def conv_intervals_per_iter(err, epsilon):
    """Converged-intervals-per-iteration reconstruction from the err matrix
    (parareal.py:596-610)."""
    idx = 1
    out = np.full(err.shape[1], np.nan)
    one_step = np.full(err.shape[1], np.nan)
    for i in range(err.shape[1]):
        one_step[i] = err[np.argmax(err[:, i] > 0), i]
        if not np.any(err[idx:, i] >= epsilon):
            n_conv = err.shape[0] - idx
        else:
            n_conv = np.argmax(err[idx:, i] >= epsilon)
            n_conv = n_conv if err[idx + n_conv, i] else err.shape[0] - idx
            idx += n_conv
        out[i] = n_conv
    return out, one_step


def plot_run(p, skip=(), add_name=True, add_title=""):
    import matplotlib.pyplot as plt
    from cycler import cycler

    if len(add_title):
        add_title = add_title + " - "
    figs = []

    if 2 not in skip:
        fig, ax = plt.subplots()
        for name, run in p.runs.items():
            err = run["err"]
            x_plot = np.arange(1, err.shape[-1] + 1)
            y_plot = np.log10(np.nanmax(err, axis=0))
            (line,) = ax.plot(x_plot, y_plot, linewidth=0.5, label=name)
            ax.scatter(x_plot, y_plot, s=1, color=line.get_color())
        ax.set_ylabel("Max. absolute error (log)")
        ax.axhline(
            np.log10(p.epsilon), linestyle="dashed", color="gray",
            linewidth=1, label="Tolerance",
        )
        ax.legend()
        ax.set_xlabel("$k$")
        title = "Max. abs. error over parareal iterations"
        fig.suptitle(f"{p.ode_name} - {add_title}{title}" if add_name else title)
        fig.tight_layout()
        figs.append(fig)

    if 3 not in skip:
        cols = ["b", "g", "r", "c", "m", "y", "k"]
        styles = ["solid", "dotted", "dashed", "dashdot"]
        fig, ax = plt.subplot_mosaic("AAA.BBCC", constrained_layout=True)
        cycl = cycler(linestyle=styles, lw=[0.5, 1, 1, 1]) * cycler(color=cols)
        for a in "ABC":
            ax[a].set_prop_cycle(cycl)
        for name, run in p.runs.items():
            err = run["err"]
            x_plot = np.arange(1, err.shape[-1] + 1)
            out, one_step = conv_intervals_per_iter(err, p.epsilon)
            (l1,) = ax["B"].plot(x_plot, out, label=name)
            ax["B"].scatter(x_plot, out, s=1, color=l1.get_color())
            (l2,) = ax["A"].plot(x_plot, np.cumsum(out), label=name[:18])
            ax["A"].scatter(x_plot, np.cumsum(out), s=1, color=l2.get_color())
            (l3,) = ax["C"].plot(x_plot, np.log10(one_step), label=name)
            ax["C"].scatter(x_plot, np.log10(one_step), s=1, color=l3.get_color())
        ax["B"].set_title("# Converged Intervals per iteration")
        ax["C"].set_title("Error on 1st interval")
        ax["A"].axhline(p.N, linestyle="dashed", color="gray", linewidth=1)
        ax["C"].axhline(
            np.log10(p.epsilon), linestyle="dashed", color="gray", linewidth=1
        )
        leg = ax["A"].legend(loc="upper left", bbox_to_anchor=(1, 1), fontsize="small")
        leg.set_in_layout(False)
        ax["B"].set_xlabel("$k$")
        ax["C"].set_xlabel("$k$")
        title = "# Converged Intervals"
        ax["A"].set_title(f"{p.ode_name} - {add_title}{title}" if add_name else title)
        figs.append(fig)

    return figs


def plot_dataset_geometry(run, coords=(0, 1), nn=15):
    """Dataset geometry + nearest-neighbour distance structure of a run
    (reference dataset_visualization.py:20-160): a scatter of the
    accumulated training states on two coordinates, and the distribution
    of distances to the nn-th nearest neighbour across the dataset."""
    import matplotlib.pyplot as plt

    x = np.asarray(run["x"])
    if x.shape[0] == 0:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    axes[0].scatter(x[:, coords[0]], x[:, coords[1]], s=3, alpha=0.5)
    axes[0].set_xlabel(f"$x_{{{coords[0]}}}$")
    axes[0].set_ylabel(f"$x_{{{coords[1]}}}$")
    axes[0].set_title("training states")

    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    kth = np.sort(d2, axis=1)[:, : min(nn, x.shape[0] - 1)]
    axes[1].hist(np.log10(np.maximum(kth[:, -1], 1e-300)), bins=40)
    axes[1].set_xlabel(f"log10 sq-dist to {nn}th neighbour")
    axes[1].set_title("neighbourhood scale")
    fig.tight_layout()
    return fig


def plot_all_err(p, key):
    import matplotlib.pyplot as plt

    if key not in p.runs or not p.runs[key]["debug_dict"]:
        return None
    figs = []
    for idx, pred_err in enumerate(p.runs[key]["debug_dict"]["all_pred_err"]):
        fig, ax = plt.subplots()
        ax.plot(np.max(np.log10(pred_err), axis=1), label="true err comp")
        l = p.runs[key]["err"][:, idx]
        start = (l != 0).argmax()
        ax.plot(np.log10(l[start:]), label="conv err")
        for y, c in [(-6, "gray"), (-8, "black"), (-10, "gray")]:
            ax.axhline(y, ls="dashed", lw=1, color=c)
        ax.set_title(idx + 1)
        ax.legend()
        figs.append(fig)
    return figs


def _mechanics_data(n_iters, N, device=None):
    """Shared data prep for the Figure-1 mechanics figure/animation: runs
    plain Parareal with history on the paper's toy 1D ODE
    du/dt = -0.3 (t-5) u and precomputes the exact fine solution plus every
    per-slice fine trajectory F(u_i^k). Returns
    (t, hist, t_fine_grid, u_exact, fine_segs) where fine_segs[k][i] is
    (ts, traj) for slice i at iteration k. Runs on the card unless
    ``device`` says otherwise, and raises when there is none."""
    from nngparareal_torch.systems.base import ODE
    from nngparareal_torch.solver import RKSolver
    from nngparareal_torch.driver import Parareal

    device = resolve_device(device)

    class Ode1d(ODE):
        def __init__(self, **kwargs):
            mn, mx = np.array([[0.1], [14700.0]])
            super().__init__("OneDim", mn, mx, np.array([0.1]), **kwargs)

        @staticmethod
        def _f(t, u):
            return -(t - 5.0) * u * 0.3

    ode = Ode1d(device=device)
    tspan = (0.0, 10.0)
    solver = RKSolver(ode.get_vector_field(), Ng=4, Nf=200, G="RK1", F="RK4",
                      fine="torch", device=device)
    p = Parareal(ode, solver, tspan, N, epsilon=5e-7, verbose=None,
                 device=device)
    out = p.run(model="parareal", keep_history=True, early_stop=None,
                measure_serial_fine=False)
    hist = out["u_hist"]  # (N+1, n, k+1)
    t = out["t"]

    u_exact = _np(solver.run_F_full(tspan[0], tspan[1], [0.1]))
    t_fine_grid = np.linspace(tspan[0], tspan[1], u_exact.shape[0])

    k_show = min(n_iters, hist.shape[2])
    fine_segs = []
    for k in range(k_show):
        segs = []
        for i in range(N):
            traj = _np(solver.run_F_full(t[i], t[i + 1], hist[i, :, k]))
            segs.append((np.linspace(t[i], t[i + 1], traj.shape[0]), traj))
        fine_segs.append(segs)
    return t, hist, t_fine_grid, u_exact, fine_segs


def plot_parareal_mechanics(n_iters=3, N=10, path=None, device=None):
    """Static equivalent of the reference's Figure-1 animation
    (Figure_1.py:17-285): the parareal mechanics on the paper's toy 1D
    ODE du/dt = -0.3 (t-5) u (a Gaussian-bump solution).

    One panel per iteration k = 0..n_iters-1: the converged prefix, the
    per-slice fine propagations F(u_i^k) from the current iterates, the
    sequential coarse predictions, and the exact fine solution. Returns
    the matplotlib figure; stores png+pdf via store_fig when ``path`` is
    given.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t, hist, t_fine_grid, u_exact, fine_segs = _mechanics_data(n_iters, N,
                                                                device)
    k_show = len(fine_segs)
    fig, axes = plt.subplots(1, k_show, figsize=(4.2 * k_show, 3.4),
                             sharey=True)
    if k_show == 1:
        axes = [axes]
    for k, ax in enumerate(axes):
        ax.plot(t_fine_grid, u_exact[:, 0], "k-", lw=1,
                label="fine solution", alpha=0.6)
        # per-slice fine propagations from iteration k's iterates
        for i, (ts, traj) in enumerate(fine_segs[k]):
            ax.plot(ts, traj[:, 0], "C0-", lw=1.6,
                    label="F(u_i^k)" if i == 0 else None)
        ax.plot(t, hist[:, 0, k], "C3o", ms=5, label="iterates u^k")
        if k + 1 < hist.shape[2]:
            ax.plot(t, hist[:, 0, k + 1], "C2s", ms=3.5,
                    label="updated u^{k+1}")
        ax.set_title(f"iteration k={k}")
        ax.set_xlabel("t")
        if k == 0:
            ax.set_ylabel("u")
            ax.legend(fontsize=8, loc="upper left")
    fig.tight_layout()
    if path is not None:
        from nngparareal_torch.utils.io import store_fig

        store_fig(fig, path)
    return fig


def animate_parareal_mechanics(path, n_iters=3, N=10, fps=2, device=None):
    """Animated equivalent of the reference's Figure-1
    (Figure_1.py:340-718): one GIF where each iteration's per-slice fine
    propagations F(u_i^k) appear one slice at a time (the reference
    animates exactly this fan-out), followed by a frame showing the
    corrector-updated iterates u^{k+1}. Writes ``img/{path}.gif`` and
    returns the file path."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    t, hist, t_fine_grid, u_exact, fine_segs = _mechanics_data(n_iters, N,
                                                                device)
    k_show = len(fine_segs)

    fig, ax = plt.subplots(figsize=(6.4, 4.2))
    ax.plot(t_fine_grid, u_exact[:, 0], "k-", lw=1, alpha=0.6,
            label="fine solution")
    ax.set_xlabel("t")
    ax.set_ylabel("u")
    ax.set_ylim(float(u_exact.min()) - 0.1 * float(np.ptp(u_exact)),
                float(u_exact.max()) + 0.25 * float(np.ptp(u_exact)))
    title = ax.set_title("")
    iter_dots, = ax.plot([], [], "C3o", ms=6, label="iterates $u^k$")
    upd_dots, = ax.plot([], [], "C2s", ms=4.5, label="updated $u^{k+1}$")
    seg_lines = [ax.plot([], [], "C0-", lw=1.6,
                         label="$F(u_i^k)$" if i == 0 else None)[0]
                 for i in range(N)]
    ax.legend(fontsize=8, loc="upper left")
    fig.tight_layout()
    fig.subplots_adjust(top=0.92)  # keep the per-frame title visible

    # frame layout: per iteration k -> N slice-reveal frames + 1 update frame
    per_k = N + 1

    def draw(frame):
        k, step = divmod(frame, per_k)
        k = min(k, k_show - 1)
        iter_dots.set_data(t, hist[:, 0, k])
        if step < N:  # revealing fine propagations slice by slice
            upd_dots.set_data([], [])
            for i, line in enumerate(seg_lines):
                if i <= step:
                    ts, traj = fine_segs[k][i]
                    line.set_data(ts, traj[:, 0])
                else:
                    line.set_data([], [])
            title.set_text(f"iteration k={k}: fine fan-out, "
                           f"slice {step + 1}/{N}")
        else:  # the predictor-corrector update
            if k + 1 < hist.shape[2]:
                upd_dots.set_data(t, hist[:, 0, k + 1])
            title.set_text(f"iteration k={k}: corrector update "
                           r"$u^{k+1}$")
        return [iter_dots, upd_dots, title, *seg_lines]

    anim = FuncAnimation(fig, draw, frames=k_show * per_k, blit=False)
    os.makedirs("img", exist_ok=True)
    out = os.path.join("img", f"{path}.gif")
    anim.save(out, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out
