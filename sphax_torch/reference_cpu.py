"""Float64 NumPy O(N^2) SPH reference: the parity ground truth (a copy of
``sphax.reference_cpu``, which cannot be imported without JAX;
``tests/test_torch_contract.py`` holds the two equal).

A frozen, maximally simple float64 NumPy implementation of the numerical
contract in SURVEY.md §2.1: full [N, N] pairwise matrices, no neighbour
structure. The engines reproduce its density, pressure and force values to
1e-6 relative tolerance on identical ICs. Do not optimise this file; its
only job is to be obviously correct.
"""
from __future__ import annotations

import numpy as np

from sphax_torch.configs import SPHConfig
from sphax_torch.physics import kernels as K

# ---------------------------------------------------------------------------
# kernel (NumPy mirror of sphax_torch.physics.kernels, same frozen convention)
# ---------------------------------------------------------------------------


def kernel_W(r, h, dim):
    q = r / h
    s = K.sigma(dim) / h**dim
    f = np.where(q < 1.0, 1.0 - 1.5 * q**2 + 0.75 * q**3,
                 np.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0))
    return s * f


def kernel_gradW_over_r(r, h, dim, eps=1e-300):
    """g such that grad_i W = g * (x_i - x_j); exact at r=0 (see kernels.py)."""
    q = r / h
    s = K.sigma(dim) / h**dim
    g1 = (-3.0 + 2.25 * q) / h
    g2 = -0.75 * (2.0 - q) ** 2 / np.maximum(r, eps)
    g = np.where(q < 1.0, g1, np.where(q < 2.0, g2, 0.0))
    return s * g / h


def kernel_dW_dh(r, h, dim):
    q = r / h
    s = K.sigma(dim) / h**dim
    f = np.where(q < 1.0, 1.0 - 1.5 * q**2 + 0.75 * q**3,
                 np.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0))
    df = np.where(q < 1.0, (-3.0 + 2.25 * q) * q,
                  np.where(q < 2.0, -0.75 * (2.0 - q) ** 2, 0.0))
    return -(dim * s * f + q * s * df) / h


# ---------------------------------------------------------------------------
# pairwise geometry
# ---------------------------------------------------------------------------


def _pair_disp(pos, box=None):
    """dx[i, j] = x_i - x_j with optional min-image wrapping; r matrix."""
    dx = pos[:, None, :] - pos[None, :, :]
    if box is not None:
        box = np.asarray(box, dtype=np.float64)
        dx = dx - box * np.round(dx / box)
    r = np.sqrt(np.sum(dx * dx, axis=-1))
    return dx, r


# ---------------------------------------------------------------------------
# density + adaptive smoothing length (SURVEY.md §2.1.2-3)
# ---------------------------------------------------------------------------


def density(pos, mass, h, dim, box=None):
    """rho_i = sum_j m_j W(|r_ij|, h_i)  (self term included: W(0, h_i))."""
    _, r = _pair_disp(pos, box)
    w = kernel_W(r, h[:, None], dim)
    return w @ mass


def density_and_omega(pos, mass, h, dim, box=None):
    """rho_i and Omega_i = 1 + (h_i / (d rho_i)) sum_j m_j dW/dh(r_ij, h_i)."""
    _, r = _pair_disp(pos, box)
    w = kernel_W(r, h[:, None], dim)
    rho = w @ mass
    dwdh = kernel_dW_dh(r, h[:, None], dim)
    drho_dh = dwdh @ mass
    omega = 1.0 + h / (dim * rho) * drho_dh
    return rho, omega


def solve_h(pos, mass, h0, cfg: SPHConfig, box=None, iters=None, tol=1e-12):
    """Newton-solve h_i so that rho_sum(h_i) == m_i (eta / h_i)^dim.

    Standard adaptive-h consistency relation (Price 2012; SURVEY.md §2.1.3):
        phi(h) = rho_sum(h) - rho_h(h),  rho_h(h) = m (eta/h)^d
        phi'(h) = drho_sum/dh + d * rho_h / h
    Newton with a bounded step; float64, iterate to convergence.
    """
    dim = cfg.dim
    h = np.asarray(h0, dtype=np.float64).copy()
    n_it = iters if iters is not None else 60
    for _ in range(n_it):
        _, r = _pair_disp(pos, box)
        w = kernel_W(r, h[:, None], dim)
        rho = w @ mass
        drho_dh = kernel_dW_dh(r, h[:, None], dim) @ mass
        rho_h = mass * (cfg.eta / h) ** dim
        phi = rho - rho_h
        dphi = drho_dh + dim * rho_h / h
        # guard: dphi should be negative (rho falls, rho_h falls slower);
        # clamp to avoid division blow-ups in pathological configs
        dphi = np.where(np.abs(dphi) < 1e-300, -1e-300, dphi)
        dh = -phi / dphi
        dh = np.clip(dh, -0.5 * h, 0.5 * h)
        h = h + dh
        if np.max(np.abs(dh) / h) < tol:
            break
    return h


# ---------------------------------------------------------------------------
# EOS (SURVEY.md §2.1.4)
# ---------------------------------------------------------------------------


def eos(rho, u, cfg: SPHConfig):
    """Return (P, cs)."""
    if cfg.isothermal:
        P = cfg.cs_iso**2 * rho
        cs = np.full_like(rho, cfg.cs_iso)
    else:
        P = (cfg.gamma - 1.0) * rho * u
        cs = np.sqrt(cfg.gamma * np.maximum(P, 0.0) / rho)
    return P, cs


# ---------------------------------------------------------------------------
# forces: symmetrized pressure gradient + artificial viscosity + du/dt
# (SURVEY.md §2.1.5-7)
# ---------------------------------------------------------------------------


def forces(pos, vel, mass, h, rho, P, cs, omega, cfg: SPHConfig, box=None,
           balsara_f=None):
    """Return (acc[N,D], du_dt[N]).

    dv_i/dt = - sum_j m_j [ P_i/(Om_i rho_i^2) gradW(h_i)
                          + P_j/(Om_j rho_j^2) gradW(h_j) ]
              - sum_j m_j Pi_ij gradWbar_ij
    du_i/dt =   P_i/(Om_i rho_i^2) sum_j m_j v_ij . gradW(h_i)
              + 1/2 sum_j m_j Pi_ij v_ij . gradWbar_ij
    with gradWbar = (gradW(h_i) + gradW(h_j))/2 and Monaghan
    Pi_ij = (-alpha cbar mu + beta mu^2)/rhobar for approaching pairs.
    """
    dim = cfg.dim
    n = pos.shape[0]
    dx, r = _pair_disp(pos, box)
    dv = vel[:, None, :] - vel[None, :, :]

    gi = kernel_gradW_over_r(r, h[:, None], dim)  # g(h_i): [N,N]
    gj = kernel_gradW_over_r(r, h[None, :], dim)  # g(h_j): [N,N]
    np.fill_diagonal(gi, 0.0)
    np.fill_diagonal(gj, 0.0)

    # pressure term coefficients
    ci = P / (omega * rho**2)  # [N]
    cj = ci                    # same array indexed as j

    # scalar pair coefficient for the pressure force (times dx later)
    pres = ci[:, None] * gi + cj[None, :] * gj  # [N,N]

    # artificial viscosity
    vdotr = np.einsum("ijk,ijk->ij", dv, dx)
    hbar = 0.5 * (h[:, None] + h[None, :])
    mu = hbar * vdotr / (r**2 + cfg.eps_visc * hbar**2)
    mu = np.where(vdotr < 0.0, mu, 0.0)
    cbar = 0.5 * (cs[:, None] + cs[None, :])
    rhobar = 0.5 * (rho[:, None] + rho[None, :])
    Pi = (-cfg.alpha_visc * cbar * mu + cfg.beta_visc * mu**2) / rhobar
    if balsara_f is not None:
        Pi = Pi * 0.5 * (balsara_f[:, None] + balsara_f[None, :])
    gbar = 0.5 * (gi + gj)
    visc = Pi * gbar  # [N,N]

    coeff = (pres + visc) * mass[None, :]  # [N,N]
    acc = -np.einsum("ij,ijk->ik", coeff, dx)

    # energy equation
    du_p = ci * np.einsum("ij,ij->i", gi * mass[None, :], vdotr)
    du_v = 0.5 * np.einsum("ij,ij->i", Pi * gbar * mass[None, :], vdotr)
    du = du_p + du_v
    return acc, du


def div_curl(pos, vel, mass, h, rho, dim, box=None):
    """Standard SPH gather estimators (div v, |curl v|) using gradW(h_i)."""
    dx, r = _pair_disp(pos, box)
    dv = vel[:, None, :] - vel[None, :, :]
    g = kernel_gradW_over_r(r, h[:, None], dim)
    np.fill_diagonal(g, 0.0)
    mw = mass[None, :] * g  # [N,N]
    vdotr = np.einsum("ijk,ijk->ij", dv, dx)
    divv = -np.einsum("ij,ij->i", mw, vdotr) / rho
    if dim == 3:
        cx = dv[..., 1] * dx[..., 2] - dv[..., 2] * dx[..., 1]
        cy = dv[..., 2] * dx[..., 0] - dv[..., 0] * dx[..., 2]
        cz = dv[..., 0] * dx[..., 1] - dv[..., 1] * dx[..., 0]
        curl = np.stack([
            np.einsum("ij,ij->i", mw, cx),
            np.einsum("ij,ij->i", mw, cy),
            np.einsum("ij,ij->i", mw, cz),
        ], axis=-1) / rho[:, None]
        curl_mag = np.sqrt(np.sum(curl**2, axis=-1))
    elif dim == 2:
        cz = dv[..., 0] * dx[..., 1] - dv[..., 1] * dx[..., 0]
        curl_mag = np.abs(np.einsum("ij,ij->i", mw, cz)) / rho
    else:
        curl_mag = np.zeros_like(rho)
    return divv, curl_mag


def balsara_switch(pos, vel, mass, h, rho, cs, dim, box=None):
    """Balsara (1995) limiter f_i = |div v| / (|div v| + |curl v| + 1e-4 c/h)."""
    divv, curl_mag = div_curl(pos, vel, mass, h, rho, dim, box)
    return np.abs(divv) / (np.abs(divv) + curl_mag + 1e-4 * cs / h)


def gravity(pos, mass, cfg: SPHConfig, box=None):
    """Softened direct-sum gravity: a_i = -G sum_j m_j r_ij/(r^2+eps^2)^1.5."""
    dx, r = _pair_disp(pos, box)
    r2 = r**2 + cfg.grav_eps**2
    inv = r2 ** (-1.5)
    np.fill_diagonal(inv, 0.0)
    return -cfg.G * np.einsum("ij,ijk->ik", inv * mass[None, :], dx)


# ---------------------------------------------------------------------------
# full derived-quantity pass + timestep + KDK step (SURVEY.md §2.1.8, §3.1)
# ---------------------------------------------------------------------------


def update_derived(pos, vel, mass, u, h, cfg: SPHConfig, box=None,
                   alpha=None):
    """density (+h solve) -> EOS -> forces (+gravity). Returns dict.

    ``alpha``: per-particle Morris-Monaghan alpha(t) (used when cfg.mm_visc;
    it multiplies Pi_ij through the same channel as the Balsara factor —
    see SPHConfig.mm_visc for why that is exact under beta = 2 alpha).
    """
    dim = cfg.dim
    if cfg.adaptive_h:
        h = solve_h(pos, mass, h, cfg, box)
    if cfg.grad_h:
        rho, omega = density_and_omega(pos, mass, h, dim, box)
    else:
        rho = density(pos, mass, h, dim, box)
        omega = np.ones_like(rho)
    P, cs = eos(rho, u, cfg)
    if cfg.need_divv:
        divv, curl_mag = div_curl(pos, vel, mass, h, rho, dim, box)
    else:
        divv = np.zeros_like(rho)
    vf = None
    if cfg.balsara:
        vf = np.abs(divv) / (np.abs(divv) + curl_mag + 1e-4 * cs / h)
    if cfg.mm_visc:
        a = np.ones_like(rho) if alpha is None else np.asarray(alpha)
        vf = a if vf is None else vf * a
    acc, du = forces(pos, vel, mass, h, rho, P, cs, omega, cfg, box,
                     balsara_f=vf)
    if cfg.gravity:
        acc = acc + gravity(pos, mass, cfg, box)
    return dict(h=h, rho=rho, omega=omega, P=P, cs=cs, acc=acc, du_dt=du,
                divv=divv)


def timestep(h, cs, acc, vel, cfg: SPHConfig):
    """Global dt = min(CFL h/vsig, force sqrt(h/|a|)) (SURVEY.md §2.1.8)."""
    vsig = cs + 0.6 * (cfg.alpha_visc * cs + cfg.beta_visc * cs)  # Monaghan-style
    dt_cfl = cfg.cfl * h / np.maximum(vsig, 1e-300)
    amag = np.sqrt(np.sum(acc**2, axis=-1))
    dt_f = cfg.dt_force * np.sqrt(h / np.maximum(amag, 1e-300))
    return min(float(np.min(dt_cfl)), float(np.min(dt_f)), cfg.dt_max)


def step(pos, vel, mass, u, h, der, cfg: SPHConfig, box=None, dt=None,
         alpha=None):
    """One leapfrog KDK step; ``der`` is the dict from update_derived.

    Sequence (frozen; the engines replicate this EXACTLY):
      1. dt from current state
      2. half-kick:  v += a dt/2 ; u += du dt/2 (floored)
      3. drift:      x += v dt (wrapped)
      4. recompute derived quantities at new positions
      5. half-kick:  v += a' dt/2 ; u += du' dt/2 (floored)
      6. (cfg.mm_visc) explicit-Euler alpha update from the fresh divv
    Returns (pos, vel, u, h, der, dt); with cfg.mm_visc the evolved alpha
    is in der["alpha"].
    """
    if dt is None:
        dt = timestep(der["h"], der["cs"], der["acc"], vel, cfg)
    vel = vel + 0.5 * dt * der["acc"]
    u = np.maximum(u + 0.5 * dt * der["du_dt"], cfg.u_floor)
    pos = pos + dt * vel
    if box is not None:
        box_arr = np.asarray(box, dtype=np.float64)
        pos = np.mod(pos, box_arr)
    der = update_derived(pos, vel, mass, u, der["h"], cfg, box, alpha=alpha)
    vel = vel + 0.5 * dt * der["acc"]
    u = np.maximum(u + 0.5 * dt * der["du_dt"], cfg.u_floor)
    if cfg.mm_visc:
        a = np.ones_like(u) if alpha is None else np.asarray(alpha)
        h_n, cs_n, divv_n = der["h"], der["cs"], der["divv"]
        s = np.maximum(-divv_n, 0.0) * (cfg.mm_alpha_max - a)
        decay = (a - cfg.mm_alpha_min) * (cfg.mm_sigma * cs_n
                                          / np.maximum(h_n, 1e-300))
        der["alpha"] = np.clip(a + dt * (s - decay), cfg.mm_alpha_min,
                               cfg.mm_alpha_max)
    return pos, vel, u, der["h"], der, dt
