"""Plain torch SPH reference of the 2D configurations' step, for the check.

The equations of ``portbench/reference.py`` with D = 2 wherever the
dimension enters: the 2D cubic spline (sigma = 10 / (7 pi)), dW/dh with the
factor D, h = eta (m / rho)^(1/2) by the configuration's Newton updates from
the step's input h with kernel A's clamps and structural cap, Omega = 1 +
h / (2 rho) d rho / d h, the Balsara switch from the gather div v and the
scalar curl dvy/dx - dvx/dy (its magnitude), the Monaghan viscosity, the
symmetrised pressure force and du/dt, and a global KDK step. Neighbours come
from a cell list over the periodic unit square, a block of rows at a time;
only the rows asked for, and the rows their answers depend on, are computed.

The state is stored in its own dtype (that of the arrays handed in), as
the program stores it: a periodic image of x_j lies at x_j + k L rounded to
that dtype, and the step's half-kicked velocities and energies and its
drifted positions are rounded to it before the derived pass (the drift is
left where it lands: images follow from the minimum image in that frame).
Every other operation is float64, or the control's. At 1024^2 a float32
state holds a pair's separation (about 5e-4) to 1e-4 of it at x near 1, and
the velocities (|v| = 0.5 across the shear) to 3e-8, against neighbour
differences of 1e-4 to 1e-2 on the first steps: gaps of 1e-4 to 3e-4 against
a reference that does not round them, which a float64 state, where the
rounding is a no-op, does not show.

It imports nothing of the program (nor JAX): it works from the arrays it is
handed and the configuration's file. ``Arith`` (float64, or the control,
float32 with TF32 operands in every sum over neighbours), ``eos``,
``particle_dt`` and ``cast`` are the 3D reference's, which do not depend on
the dimension. A 2D configuration is undriven and runs at global dt: the
driving and the rung tick raise.

Departures from McNally, Lyra & Passy 2012 (ApJS 201, 18) that the
configurations make and this reference computes: SPH with the cubic spline
and grad-h terms, where the paper compares grid codes and a Gaussian-kernel
SPH; the Monaghan viscosity (alpha 1, beta 2) limited by the Balsara switch,
where the paper adds no explicit viscosity; no thermal conduction; equal
particle masses on stretched rows, with a jitter of at most 1e-3 lattice
spacings; float32 state in the program.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import Arith, cast, eos, particle_dt  # noqa: F401

_TINY = 1e-30
DIM = 2

# ---- cubic spline in 2D -----------------------------------------------------

_S2 = 10.0 / (7.0 * math.pi)


def _f(q):
    t = torch.clamp_min(2.0 - q, 0.0)
    return torch.where(q < 1.0, 1.0 - 1.5 * q * q + 0.75 * q * q * q,
                       0.25 * t * t * t)


def W(r, h):
    return _S2 / h**2 * _f(r / h)


def dW_dh(r, h):
    q = r / h
    t = torch.clamp_min(2.0 - q, 0.0)
    df = torch.where(q < 1.0, (-3.0 + 2.25 * q) * q, -0.75 * t * t)
    return -(DIM * _S2 / h**2 * _f(q) + q * _S2 / h**2 * df) / h


def gradW_over_r(r, h):
    """g with grad_i W(r_ij, h) = g (x_i - x_j); the q < 1 branch has q
    factored out, so it is exact at r = 0."""
    q = r / h
    t = torch.clamp_min(2.0 - q, 0.0)
    g = torch.where(q < 1.0, (-3.0 + 2.25 * q) / h,
                    -0.75 * t * t / torch.clamp_min(r, _TINY))
    return torch.where(q < 2.0, _S2 / h**2 * g / h, torch.zeros_like(q))


# ---- neighbours -------------------------------------------------------------


class Grid:
    """A cell list of the periodic square [0, L)^2 with cells at least
    ``radius`` wide; ``pairs(rows)`` gives every (row, j) closer than
    ``radius`` by the minimum image, self pairs included."""

    def __init__(self, pos, radius: float, box: float = 1.0,
                 block: int = 16384, store=None):
        self.pos, self.radius, self.box, self.block = pos, radius, box, block
        self.store = store or pos.dtype
        self.nc = int(math.floor(box / radius))
        if self.nc >= 3:
            cid = self._cell(pos)
            flat = cid[:, 0] * self.nc + cid[:, 1]
            self.order = torch.argsort(flat)
            count = torch.bincount(flat, minlength=self.nc ** 2)
            self.start = torch.cumsum(count, 0) - count
            self.count = count
            self.off = torch.tensor([(a, b) for a in (-1, 0, 1)
                                     for b in (-1, 0, 1)], device=pos.device)

    def _cell(self, x):
        x = torch.remainder(x, self.box)
        c = torch.floor(x / self.box * self.nc).long()
        return torch.clamp(c, 0, self.nc - 1)

    def _candidates(self, rows):
        """[B, K] candidate j (-1 padded) of ``rows``."""
        if self.nc < 3:
            n = self.pos.shape[0]
            return torch.arange(n, device=rows.device).expand(len(rows), n)
        nc = self.nc
        c = (self._cell(self.pos[rows])[:, None, :] + self.off) % nc
        flat = c[..., 0] * nc + c[..., 1]                           # [B, 9]
        st, ct = self.start[flat], self.count[flat]
        kmax = int(ct.max())
        ar = torch.arange(kmax, device=rows.device)
        idx = st[..., None] + ar                                    # [B,9,k]
        ok = ar < ct[..., None]
        j = self.order[torch.where(ok, idx, 0)]
        return torch.where(ok, j, -1).reshape(len(rows), -1)

    def pairs(self, rows):
        """(i, j, dx, r): i indexes ``rows``, j the whole box, dx = x_i -
        x_j by the minimum image (the image of x_j at x_j + k L, rounded to
        ``store``), r = |dx| < radius."""
        out = []
        for b0 in range(0, len(rows), self.block):
            blk = rows[b0:b0 + self.block]
            cand = self._candidates(blk)
            bi, kk = torch.nonzero(cand >= 0, as_tuple=True)
            j = cand[bi, kk]
            xi, xj = self.pos[blk[bi]], self.pos[j]
            img = xj + self.box * torch.round((xi - xj) / self.box)
            dx = xi - img.to(self.store).to(xi.dtype)
            r = torch.sqrt(torch.sum(dx * dx, dim=-1))
            near = r < self.radius
            out.append((bi[near] + b0, j[near], dx[near], r[near]))
        return tuple(torch.cat([o[k] for o in out]) for k in range(4))


# ---- the derived pass -------------------------------------------------------


def density(ar: Arith, pairs, rows, pos, vel, mass, u_rows, h0_rows, sph,
            hcap: float):
    """Kernel A's stage for ``rows``: ``newton_iters`` Newton updates of h
    from h0 (kernel A's clamps and cap), the final sums at that h, rho,
    Omega, div v, |curl v| and the Balsara factor. ``pairs`` holds every
    pair of ``rows`` within 2 h of any h the solve reaches."""
    i, j, dx, r = pairs
    n = len(rows)
    m_j = mass[j]
    m_safe = torch.clamp_min(mass[rows], _TINY)
    eta_d = sph["eta"] ** DIM
    h = h0_rows.clone()
    h_peak = h.max() if n else h.new_zeros(())

    def walk(h):
        hi = h[i]
        return (ar.psum(m_j, W(r, hi), i, n),
                ar.psum(m_j, dW_dh(r, hi), i, n))

    iters = sph["newton_iters"] if sph["adaptive_h"] else 0
    for _ in range(iters):
        rho, drdh = walk(h)
        rho = torch.clamp_min(rho, _TINY)
        rho_h = m_safe * eta_d / h**DIM
        dphi = drdh + DIM * rho_h / h
        dphi = torch.where(torch.abs(dphi) < _TINY, -_TINY, dphi)
        dh = torch.clamp(-(rho - rho_h) / dphi, -0.5 * h, 0.5 * h)
        h = torch.clamp_max(h + dh, hcap)
        h_peak = torch.maximum(h_peak, h.max())
    rho, drdh = walk(h)
    rho = torch.clamp_min(rho, 1e-15)
    om = (1.0 + h / (DIM * rho) * drdh if sph["grad_h"]
          else torch.ones_like(rho))
    out = dict(h=h, rho=rho, omega=om, divv=torch.zeros_like(rho),
               bf=torch.ones_like(rho), div_abs=torch.zeros_like(rho),
               h_peak=float(h_peak))
    if sph["balsara"]:
        g = gradW_over_r(r, h[i])
        dv = vel[rows][i] - vel[j]
        vdotr = torch.sum(dv * dx, dim=-1)
        w = m_j * g
        div = ar.psum(w, vdotr, i, n)
        # the one component of dv x dx in the plane's normal
        cross = dv[:, 0] * dx[:, 1] - dv[:, 1] * dx[:, 0]
        divv = -div / rho
        curl = torch.abs(ar.psum(w, cross, i, n)) / rho
        _, cs = eos(rho, u_rows, sph)
        out.update(divv=divv, bf=torch.abs(divv) / (
            torch.abs(divv) + curl + 1e-4 * cs / h + 1e-30),
            div_abs=ar.psum(torch.abs(w), torch.abs(vdotr), i, n) / rho)
    return out


def forces(ar: Arith, pairs, rows, vel, mass, f, sph):
    """Kernel C for ``rows``: acc and du/dt from the per-particle fields
    ``f`` (h, rho, P, cs, omega, bf; whole-box arrays, valid on every j of
    ``pairs``), with each row's sum of absolute pair terms beside them."""
    i, j, dx, r = pairs
    gi_row = rows[i]
    live = (r > 0) & (r < 2.0 * torch.maximum(f["h"][gi_row], f["h"][j]))
    i, j, dx, r, gi_row = i[live], j[live], dx[live], r[live], gi_row[live]
    n = len(rows)
    h_i, h_j = f["h"][gi_row], f["h"][j]
    gi, gj = gradW_over_r(r, h_i), gradW_over_r(r, h_j)
    gbar = 0.5 * (gi + gj)
    ci = f["P"][gi_row] / (f["omega"][gi_row] * f["rho"][gi_row] ** 2)
    cj = f["P"][j] / (f["omega"][j] * f["rho"][j] ** 2)
    dv = vel[gi_row] - vel[j]
    vdotr = torch.sum(dv * dx, dim=-1)
    hbar = 0.5 * (h_i + h_j)
    mu = hbar * vdotr / (r * r + sph["eps_visc"] * hbar * hbar)
    mu = torch.where(vdotr < 0.0, mu, torch.zeros_like(mu))
    cbar = 0.5 * (f["cs"][gi_row] + f["cs"][j])
    rhobar = 0.5 * (f["rho"][gi_row] + f["rho"][j])
    Pi = (-sph["alpha_visc"] * cbar * mu + sph["beta_visc"] * mu * mu) / rhobar
    if sph["balsara"]:
        Pi = Pi * (0.5 * (f["bf"][gi_row] + f["bf"][j]))
    m_j = mass[j]
    fcoef = m_j * (ci * gi + cj * gj + Pi * gbar)
    wdu = m_j * (ci * gi + 0.5 * Pi * gbar)
    return dict(
        acc=-ar.psum(fcoef[:, None], dx, i, n),
        du_dt=ar.psum(wdu, vdotr, i, n),
        acc_abs=ar.psum(torch.abs(fcoef), r, i, n),
        du_abs=ar.psum(torch.abs(wdu), torch.abs(vdotr), i, n))


class Derived:
    """The derived pass at positions ``x`` for the rows ``rows``: the rows
    their forces need get kernel A's stage from h0, then kernel C.
    ``hcap`` is the structural h cap the configuration states; ``store``
    the state's dtype, which images are rounded to."""

    def __init__(self, ar, x, vel, mass, u, sph, hcap, box, h_hint, store):
        self.ar, self.x, self.vel, self.mass, self.u = ar, x, vel, mass, u
        self.sph, self.hcap, self.box, self.store = sph, hcap, box, store
        self.radius = 2.0 * min(hcap, 1.15 * h_hint)

    def run(self, rows, h0):
        while True:
            grid = Grid(self.x, self.radius, self.box, store=self.store)
            pr = grid.pairs(rows)
            need = torch.unique(torch.cat([rows, pr[1]]))
            d = density(self.ar, grid.pairs(need), need, self.x, self.vel,
                        self.mass, self.u[need], h0[need], self.sph,
                        self.hcap)
            if (self.radius >= 2.0 * self.hcap
                    or 2.0 * d["h_peak"] < self.radius):
                break
            self.radius = 2.0 * self.hcap
        n = self.x.shape[0]
        nan = torch.full((n,), float("nan"), dtype=self.x.dtype,
                         device=self.x.device)
        f = {}
        for k in ("h", "rho", "omega", "bf", "divv", "div_abs"):
            f[k] = nan.clone()
            f[k][need] = d[k]
        f["P"], f["cs"] = nan.clone(), nan.clone()
        f["P"][need], f["cs"][need] = eos(f["rho"][need], self.u[need],
                                          self.sph)
        out = forces(self.ar, pr, rows, self.vel, self.mass, f, self.sph)
        out.update({k: f[k][rows] for k in ("h", "rho", "omega", "P", "cs",
                                             "divv", "div_abs")})
        return out


# ---- what check.py calls ----------------------------------------------------


def derived_start(ar, ics, rows, sph, hcap, box):
    """The set-up's derived pass on the ICs (dict pos, vel, mass, u, h)."""
    s = cast(ics, ar)
    d = Derived(ar, torch.remainder(s["pos"], box), s["vel"], s["mass"],
                s["u"], sph, hcap, box, float(s["h"].max()), ics["pos"].dtype)
    return d.run(rows, s["h"])


def kdk_step(ar, st, rows, sph, hcap, box, drive=None):
    """One global KDK step from the state ``st`` (pos, vel, mass, u, h, cs,
    acc, du_dt) for ``rows``: dt from the state, half-kick, drift, the
    derived pass, half-kick. A 2D configuration is undriven. The half-kicked
    velocities and energies and the drifted positions are rounded to the
    state's dtype, and the positions stay in its frame."""
    if drive is not None:
        raise ValueError("the 2D reference computes no driving")
    s = cast(st, ar)
    store = st["pos"].dtype

    def stored(t):
        return t.to(store).to(ar.dtype)
    dt = particle_dt(s["h"], s["cs"], s["acc"], sph).min()
    v_h = stored(s["vel"] + 0.5 * dt * s["acc"])
    u_h = stored(torch.clamp_min(s["u"] + 0.5 * dt * s["du_dt"],
                                 sph["u_floor"]))
    x = stored(s["pos"] + dt * v_h)
    d = Derived(ar, x, v_h, s["mass"], u_h, sph, hcap, box,
                float(s["h"].max()), store)
    out = d.run(rows, s["h"])
    out["vel"] = v_h[rows] + 0.5 * dt * out["acc"]
    out["u"] = torch.clamp_min(u_h[rows] + 0.5 * dt * out["du_dt"],
                               sph["u_floor"])
    out["pos"], out["dt"] = x[rows], dt
    return out


def _not_2d(what: str):
    raise NotImplementedError(f"the 2D reference computes no {what}: a 2D "
                              "configuration runs undriven at global dt")


def rung_tick(*args, **kwargs):
    _not_2d("rung tick")


def drive_modes(*args, **kwargs):
    _not_2d("driving modes")


def ou_update(*args, **kwargs):
    _not_2d("driving")
