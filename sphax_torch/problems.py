"""Named problem registry: ICs + config + engine wiring (torch twin of
``sphax.problems``), used by ``python -m sphax_torch <problem>`` and the
tests.

Every problem function takes ``device`` (default: CUDA, which raises where
no card is visible; the CPU runs only when a caller passes
``device="cpu"``) and ``dtype`` (default float32). The engine is chosen per
problem and device:

- on CUDA, the sorted-window engine (kernels A and C) where the window
  planner accepts the box;
- otherwise (on the CPU, or where the planner rejects the box) the cell
  list above 3,000 particles (``choose_grid`` at h_max = h_margin max h)
  and the dense engine at or below it;
- ``turb`` and ``cloud`` always take the window engine and ``evrard``
  always dense.

This is the JAX version's choice on every device. ``Problem.engine_name``
says which ran, and ``Problem.grid`` holds the cell list's grid. A driven
problem (``turb``) carries its noise source: standard normals from a
``torch.Generator`` seeded with ``seed`` (the JAX version keeps a
``jax.random`` key instead).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from sphax_torch import configs
from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import Domain, ParticleState, box, make_state
from sphax_torch.neighbors import window as win
from sphax_torch.neighbors.cell_list import Grid, choose_grid
from sphax_torch.neighbors.window import WindowSpec
from sphax_torch.physics import clist, dense, driving, wengine
from sphax_torch.physics.driving import DriveSpec, DriveState


class Problem(NamedTuple):
    name: str
    state: ParticleState
    cfg: SPHConfig
    domain: Domain
    engine: Callable            # state -> state (fresh derived fields)
    t_end: float
    drive: Optional[DriveState] = None
    drive_spec: Optional[DriveSpec] = None
    wspec: Optional[WindowSpec] = None   # when the window engine is used
    engine_name: str = "dense"           # "window", "clist" or "dense"
    noise: Optional[driving.GaussianNoise] = None  # driven problems only
    seed: int = 0                        # the noise stream's seed
    grid: Optional[Grid] = None          # when the cell list is used
    rung_limiter: int = 0                # block timesteps' limiter A (0: off)


_CFG_FIELDS = {f.name: f.type for f in dataclasses.fields(SPHConfig)}
_TRUE, _FALSE = ("1", "true", "yes", "on"), ("0", "false", "no", "off")


def _as_bool(key: str, v) -> bool:
    """A CLI value for a bool field: 0/1 or true/false, yes/no, on/off;
    anything else raises (a typo must not silently flip physics)."""
    s = str(v).strip().lower()
    if isinstance(v, bool) or s in _TRUE + _FALSE:
        return v if isinstance(v, bool) else s in _TRUE
    raise SystemExit(f"option {key}={v!r}: expected a bool "
                     f"(0/1, true/false, yes/no, on/off)")


def _cfg_kw(cfg: SPHConfig, kw: dict) -> SPHConfig:
    """Apply leftover CLI ``key=value`` pairs as SPHConfig overrides.
    Unknown keys raise; bool fields parse as ``_as_bool`` says."""
    if not kw:
        return cfg
    bad = sorted(set(kw) - set(_CFG_FIELDS))
    if bad:
        raise SystemExit(
            f"unknown option(s) {bad}; valid config overrides: "
            f"{sorted(_CFG_FIELDS)}")
    conv = {k: (_as_bool(k, v) if "bool" in str(_CFG_FIELDS[k]) else v)
            for k, v in kw.items()}
    return dataclasses.replace(cfg, **conv)


def _device(device) -> torch.device:
    """``None`` means CUDA; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _state(ic, dtype, device, alpha0: float = 1.0) -> ParticleState:
    return make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=device)
                        for k in ("pos", "vel", "mass", "u", "h")),
                      alpha0=alpha0)


def _box(ic, dim, dtype, device) -> Domain:
    return box(torch.zeros(dim, dtype=dtype, device=device),
               torch.as_tensor(ic["box"], dtype=dtype, device=device))


def _window_engine(st, cfg, dom, h_margin=1.3, cutoff_scale=1.25):
    """The window engine with the production knobs (fast_sub=3,
    rgroups=2); a small or thin box that rejects the fine fast-axis grid
    takes the plain plan. Raises ValueError where no plan fits."""
    kw = dict(h_max=float(st.h.max()) * h_margin, dim=cfg.dim,
              cutoff_scale=cutoff_scale)
    try:
        spec = win.plan_measured(st.pos, dom, fast_sub=3, rgroups=2, **kw)
    except ValueError:
        spec = win.plan_measured(st.pos, dom, **kw)

    def eng(s):
        return wengine.update_derived(s, cfg, dom, spec)
    return eng, spec


def _dense_engine(cfg, dom):
    def eng(s):
        return dense.update_derived(s, cfg, dom)
    return eng


def _auto_engine(st, cfg, dom, h_margin=1.3, cutoff_scale=1.25):
    """(engine, spec or grid, name): the window engine on CUDA where the
    planner accepts the box, else the cell list above 3,000 particles and
    dense at or below (see the module docstring)."""
    if st.pos.is_cuda:
        try:
            eng, spec = _window_engine(st, cfg, dom, h_margin, cutoff_scale)
            return eng, spec, "window"
        except ValueError:
            pass  # box too small/thin for the window grid
    if st.n > 3000:
        grid = choose_grid(dom, h_max=float(st.h.max()) * h_margin, n=st.n)

        def eng(s):
            return clist.update_derived(s, cfg, dom, grid)
        return eng, grid, "clist"
    return _dense_engine(cfg, dom), None, "dense"


def _engine_kw(spec, name):
    """Problem fields for ``_auto_engine``'s answer."""
    return dict(wspec=spec if name == "window" else None,
                grid=spec if name == "clist" else None, engine_name=name)


def sod(n: int = 32, dtype=torch.float32, device=None, **kw) -> Problem:
    from sphax_torch.ics import sod as ics
    dev = _device(device)
    ic = ics.build(nx_left=int(n), n_trans=max(4, int(n) // 4))
    cfg = _cfg_kw(SPHConfig(dim=3, gamma=1.4, adaptive_h=True,
                            newton_iters=6), kw)
    dom = _box(ic, 3, dtype, dev)
    st = _state(ic, dtype, dev)
    eng, spec, name = _auto_engine(st, cfg, dom)
    return Problem("sod", eng(st), cfg, dom, eng, t_end=0.1,
                   **_engine_kw(spec, name))


def sedov(n: int = 20, visc: str = "balsara", limiter: int = 0,
          dtype=torch.float32, device=None, **kw) -> Problem:
    """visc: "balsara" (default) or "mm" (Morris-Monaghan time-dependent
    alpha, through kernel C's viscosity-factor channel). ``limiter=A`` (a
    power of two, 0 = off) runs block timesteps (``rungs=B``) with Saitoh &
    Makino's limiter, neighbours' steps within a factor A, and the wake-up
    of sleeping neighbours (``integrate.rungs``)."""
    from sphax_torch.ics import sedov as ics
    from sphax_torch.integrate import rungs
    dev = _device(device)
    try:
        rungs.limiter_exponent(limiter)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    ic = ics.build(n_side=int(n))
    cfg = configs.SEDOV
    if visc == "mm":
        cfg = dataclasses.replace(cfg, balsara=False, mm_visc=True,
                                  alpha_visc=1.0, beta_visc=2.0)
    elif visc != "balsara":
        raise SystemExit(f"visc={visc!r}: expected 'balsara' or 'mm'")
    cfg = _cfg_kw(cfg, kw)
    dom = _box(ic, 3, dtype, dev)
    st = _state(ic, dtype, dev,
                alpha0=cfg.mm_alpha_min if visc == "mm" else 1.0)
    # the blast centre evacuates -> h grows ~1.6x; margin 1.5 covers it
    eng, spec, name = _auto_engine(st, cfg, dom, h_margin=1.5)
    return Problem("sedov", eng(st), cfg, dom, eng, t_end=0.06,
                   rung_limiter=int(limiter), **_engine_kw(spec, name))


def kh(n: int = 64, smooth=0, dtype=torch.float32, device=None,
       **kw) -> Problem:
    """2D Kelvin-Helmholtz: N = 1.5 n^2 (n = 1024 gives 1,572,864).
    ``smooth=1``: McNally et al. 2012's well-posed test (smoothed
    interfaces, ``ics.kh.build_mcnally``) in place of the sharp ones."""
    from sphax_torch.ics import kh as ics
    dev = _device(device)
    smooth = _as_bool("smooth", smooth)
    eta = configs.KH.eta
    ic = (ics.build_mcnally(int(n), eta=eta) if smooth
          else ics.build(nx=int(n), eta=eta))
    cfg = _cfg_kw(configs.KH, kw)
    dom = _box(ic, 2, dtype, dev)
    st = _state(ic, dtype, dev)
    plan = st
    if smooth:
        # the profile's rho never falls below rho1 = 1, so no h exceeds
        # eta (m / rho1)^(1/2) = eta / n: the window is planned for that h,
        # which the rows far from the band approach
        plan = st._replace(h=torch.full_like(st.h, eta / int(n)))
    eng, spec, name = _auto_engine(plan, cfg, dom)
    return Problem("kh", eng(st), cfg, dom, eng, t_end=1.0,
                   **_engine_kw(spec, name))


def evrard(n: int = 4096, solver: str = "direct", mesh: int = 64,
           dtype=torch.float32, device=None, **kw) -> Problem:
    """solver: "direct" (exact O(N^2)) or "p3m" (Ewald-split FFT mesh +
    screened pairs). Always the dense engine: self-gravity is all-pairs
    anyway, and the open box's near-vacuum envelope would pin h at the
    window engine's structural cap."""
    from sphax_torch.ics import evrard as ics
    dev = _device(device)
    ic = ics.build(n=int(n))
    cfg = configs.EVRARD
    if solver == "p3m":
        cfg = dataclasses.replace(cfg, grav_solver="p3m",
                                  grav_mesh=int(mesh))
    cfg = _cfg_kw(cfg, kw)
    dom = Domain(lo=torch.as_tensor(ic["lo"], dtype=dtype, device=dev),
                 hi=torch.as_tensor(ic["hi"], dtype=dtype, device=dev),
                 periodic=False)
    st = _state(ic, dtype, dev)
    eng = _dense_engine(cfg, dom)
    return Problem("evrard", eng(st), cfg, dom, eng, t_end=0.8)


def turb(n: int = 48, accel_rms: float = 3.0, tau: float = 0.5, seed: int = 1,
         dtype=torch.float32, device=None, **kw) -> Problem:
    """Driven isothermal turbulence: always the window engine (its plain
    versions on the CPU), OU driving with noise from a generator seeded
    with ``seed``."""
    from sphax_torch.ics import turbulence as ics
    dev = _device(device)
    ic = ics.build(n_side=int(n))
    cfg = _cfg_kw(dataclasses.replace(configs.TURB, newton_iters=2), kw)
    dom = _box(ic, 3, dtype, dev)
    st = _state(ic, dtype, dev)
    eng, spec = _window_engine(st, cfg, dom)
    modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
    dspec = DriveSpec(modes=modes, tau=float(tau), accel_rms=float(accel_rms))
    drv = driving.init(len(modes), dtype=dtype, device=dev)
    noise = driving.gaussian_noise(
        torch.Generator(device=dev).manual_seed(int(seed)))
    return Problem("turb", eng(st), cfg, dom, eng, t_end=2.0, drive=drv,
                   drive_spec=dspec, wspec=spec, engine_name="window",
                   noise=noise, seed=int(seed))


def cloud(n: int = 256, jeans: float = 222.0, mesh: int = 384,
          rs_cells: float = 1.25, eps: float = 0.0018, kmax: float = 16.0,
          delta: float = 0.1, seed: int = 1, dtype=torch.float32,
          device=None, **kw) -> Problem:
    """A periodic self-gravitating isothermal cloud (``ics.cloud``): the
    unit box holds ``jeans`` Jeans masses, P3M gravity on a ``mesh``^3 FFT
    mesh with r_s = ``rs_cells`` mesh cells and Plummer softening ``eps``,
    the Zel'dovich-displaced lattice of a Gaussian field (P(k) ~ k^-2 for
    1 <= |k| <= ``kmax``, rms ``delta``) drawn from ``seed``. Undriven;
    always the window engine, planned as ``turb`` plans it at the lattice
    h (eta / n), so the structural h cap is 1.625 eta / n. Runs to one
    free-fall time: at n = 256 the collapse outgrows that plan's window
    structure between 1.2 and 1.6 free-fall times (wider window segments
    put it off by a few dozen steps), which aborts a run."""
    from sphax_torch.ics import cloud as ics
    dev = _device(device)
    eta = configs.TURB.eta
    ic = ics.build(int(n), jeans=float(jeans), kmax=float(kmax),
                   delta_rms=float(delta), seed=int(seed), eta=eta,
                   device=dev)
    cfg = _cfg_kw(dataclasses.replace(
        configs.TURB, newton_iters=2, gravity=True, G=ic["G"],
        grav_solver="p3m", grav_mesh=int(mesh),
        grav_rs_cells=float(rs_cells), grav_eps=float(eps)), kw)
    dom = _box(ic, 3, dtype, dev)
    st = _state(ic, dtype, dev)
    plan = st._replace(h=torch.full_like(st.h, eta / int(n)))
    eng, spec = _window_engine(plan, cfg, dom)
    return Problem("cloud", eng(st), cfg, dom, eng,
                   t_end=ics.free_fall_time(cfg.G), wspec=spec,
                   engine_name="window")


REGISTRY = dict(sod=sod, sedov=sedov, kh=kh, evrard=evrard, turb=turb,
                cloud=cloud)
