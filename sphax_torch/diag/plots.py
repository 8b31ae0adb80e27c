"""Diagnostic plots (torch twin of ``sphax.diag.plots``).

Each function takes the port's ParticleState (host copies of its fields
are taken here) and run metadata, writes a PNG and returns its path;
analytic overlays come from ``sphax_torch.diag.riemann`` and ``.sedov``.
matplotlib is imported on the first call, not with the module (the
machine with the card has none). Used by the CLI's ``plot=1`` or
directly:

    from sphax_torch.diag import plots
    plots.sod_profile(state, t, "sod.png")
"""
from __future__ import annotations

import json

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    return x.detach().cpu().numpy()


def sod_profile(state, t, path, x0=0.5, gamma=1.4):
    """rho/vx/P profiles along x with the exact Riemann solution overlaid."""
    from sphax_torch.diag import riemann

    plt = _mpl()
    x = _np(state.pos[:, 0])
    xs = np.linspace(0, 1, 500)
    exact = riemann.sod_solution(xs, t, x0=x0, gamma=gamma)
    fields = [(_np(state.rho), exact[0], r"$\rho$"),
              (_np(state.vel[:, 0]), exact[1], r"$v_x$"),
              (_np(state.P), exact[2], r"$P$")]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2), constrained_layout=True)
    for ax, (val, ex, label) in zip(axes, fields):
        ax.plot(x, val, ".", ms=1.5, alpha=0.5, label="SPH")
        ax.plot(xs, ex, "k-", lw=1, label="exact")
        ax.set_xlabel("x")
        ax.set_ylabel(label)
    axes[0].legend(loc="best", fontsize=8)
    fig.suptitle(f"Sod shock tube, t={t:.3f}")
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def sedov_profile(state, t, path, E=1.0, rho0=1.0, gamma=5.0 / 3.0,
                  centre=(0.5, 0.5, 0.5)):
    """Radial density profile with the analytic shock radius marked."""
    from sphax_torch.diag import sedov

    plt = _mpl()
    r = np.sqrt(np.sum((_np(state.pos) - np.asarray(centre)) ** 2, axis=-1))
    rho = _np(state.rho)
    r_th = sedov.shock_radius(t, E, rho0, gamma)
    fig, ax = plt.subplots(figsize=(5, 3.5), constrained_layout=True)
    ax.plot(r, rho, ".", ms=1.5, alpha=0.4)
    ax.axvline(r_th, color="k", ls="--", lw=1,
               label=rf"$R_{{shock}}(t)={r_th:.3f}$")
    ax.set_xlabel("r")
    ax.set_ylabel(r"$\rho$")
    ax.set_title(f"Sedov–Taylor blast, t={t:.3f}")
    ax.legend(fontsize=8)
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def slice_2d(state, path, field="rho", axis=2, title=None):
    """Scatter slice (2D runs) or thin-slab projection (3D) of a field."""
    plt = _mpl()
    pos = _np(state.pos)
    val = _np(getattr(state, field))
    if state.dim == 3:
        z = pos[:, axis]
        zc = np.median(z)
        h = _np(state.h)
        keep = np.abs(z - zc) < 2 * np.median(h)
        pos, val = pos[keep], val[keep]
        dims = [d for d in range(3) if d != axis]
    else:
        dims = [0, 1]
    fig, ax = plt.subplots(figsize=(5, 4.2), constrained_layout=True)
    sc = ax.scatter(pos[:, dims[0]], pos[:, dims[1]], c=val, s=2,
                    cmap="viridis")
    fig.colorbar(sc, ax=ax, label=field)
    ax.set_aspect("equal")
    ax.set_title(title or field)
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def metrics_history(jsonl_path, path):
    """Energy/momentum/Mach history from a metrics.jsonl run log."""
    plt = _mpl()
    with open(jsonl_path) as f:
        recs = [json.loads(line) for line in f]
    t = [r["t"] for r in recs]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2), constrained_layout=True)
    axes[0].plot(t, [r["e_total"] for r in recs], label="total")
    axes[0].plot(t, [r["e_kin"] for r in recs], label="kinetic")
    axes[0].plot(t, [r["e_int"] for r in recs], label="internal")
    axes[0].set_ylabel("energy")
    axes[0].legend(fontsize=8)
    axes[1].plot(t, [abs(r["px"]) + abs(r["py"]) + abs(r.get("pz", 0))
                     for r in recs])
    axes[1].set_ylabel(r"$\sum |p|$")
    axes[2].plot(t, [r["mach_rms"] for r in recs])
    axes[2].set_ylabel("Mach rms")
    for ax in axes:
        ax.set_xlabel("t")
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path
