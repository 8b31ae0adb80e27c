"""Plain torch SPH reference of the configurations' step, for the check.

Straightforward SPH on the same equations the configurations state: the
cubic spline in 3D, Newton iterations for h (the configuration's count, from
the step's input h, with kernel A's clamps), density, grad-h Omega, the
Balsara switch from the gather div and curl, the Monaghan viscosity, the
symmetrised pressure force and du/dt, a global KDK step, the Ornstein-
Uhlenbeck driving on the configuration's modes, and one tick of block
timesteps on power-of-two rungs. Neighbours come from a cell list over the
whole box; only the rows asked for, and the rows their answers depend on,
are computed, one block of rows at a time.

It imports nothing of the program: it works from the arrays it is handed
(the inputs the benchmark made, or the program's state before the step it
judges) and the configuration's file.

``Arith`` fixes the precision: float64, or the control, float32 with the
operands of every sum over neighbours rounded to TF32 (10 mantissa bits,
as a tensor-core matmul rounds them; fp32 accumulation).
"""
from __future__ import annotations

import math

import torch

_TINY = 1e-30


def tf32(x):
    """Round float32 ``x`` to TF32 (nearest, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """float64, or (``control``) float32 with TF32 operands in sums."""

    def __init__(self, control: bool = False):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def psum(self, a, b, idx, n):
        """sum over pairs p with idx[p] = i of a[p] * b[p] -> [n, ...]."""
        if self.control:
            a, b = tf32(a), tf32(b)
        vals = a * b
        out = vals.new_zeros((n,) + vals.shape[1:])
        return out.index_add_(0, idx, vals)

    def matmul(self, a, b):
        if self.control:
            a, b = tf32(a), tf32(b)
        return a @ b


# ---- cubic spline in 3D -----------------------------------------------------

_S3 = 1.0 / math.pi


def _f(q):
    t = torch.clamp_min(2.0 - q, 0.0)
    return torch.where(q < 1.0, 1.0 - 1.5 * q * q + 0.75 * q * q * q,
                       0.25 * t * t * t)


def W(r, h):
    return _S3 / h**3 * _f(r / h)


def dW_dh(r, h):
    q = r / h
    t = torch.clamp_min(2.0 - q, 0.0)
    df = torch.where(q < 1.0, (-3.0 + 2.25 * q) * q, -0.75 * t * t)
    return -(3.0 * _S3 / h**3 * _f(q) + q * _S3 / h**3 * df) / h


def gradW_over_r(r, h):
    """g with grad_i W(r_ij, h) = g (x_i - x_j); the q < 1 branch has q
    factored out, so it is exact at r = 0."""
    q = r / h
    t = torch.clamp_min(2.0 - q, 0.0)
    g = torch.where(q < 1.0, (-3.0 + 2.25 * q) / h,
                    -0.75 * t * t / torch.clamp_min(r, _TINY))
    return torch.where(q < 2.0, _S3 / h**3 * g / h, torch.zeros_like(q))


def eos(rho, u, sph):
    if sph["isothermal"]:
        return sph["cs_iso"] ** 2 * rho, torch.full_like(rho, sph["cs_iso"])
    P = (sph["gamma"] - 1.0) * rho * u
    return P, torch.sqrt(sph["gamma"] * torch.clamp_min(P, 0.0) / rho)


def particle_dt(h, cs, acc, sph):
    """Each particle's wanted dt: min of the CFL and force criteria."""
    vsig = cs + 0.6 * (sph["alpha_visc"] * cs + sph["beta_visc"] * cs)
    dt_cfl = sph["cfl"] * h / torch.clamp_min(vsig, _TINY)
    amag = torch.sqrt(torch.sum(acc * acc, dim=-1))
    dt_f = sph["dt_force"] * torch.sqrt(h / torch.clamp_min(amag, _TINY))
    return torch.clamp_max(torch.minimum(dt_cfl, dt_f), sph["dt_max"])


def rung_of(dt_des, dt_min, n_rungs: int):
    r = torch.floor(torch.log2(torch.clamp_min(dt_des / dt_min, 1.0)))
    return torch.clamp(r, 0, n_rungs - 1).to(torch.int32)


# ---- neighbours -------------------------------------------------------------


class Grid:
    """A cell list of the periodic box [0, L)^3 with cells at least
    ``radius`` wide; ``pairs(rows)`` gives every (row, j) closer than
    ``radius`` by the minimum image, self pairs included."""

    def __init__(self, pos, radius: float, box: float = 1.0,
                 block: int = 8192):
        self.pos, self.radius, self.box, self.block = pos, radius, box, block
        self.nc = int(math.floor(box / radius))
        if self.nc >= 3:
            cid = self._cell(pos)
            flat = (cid[:, 0] * self.nc + cid[:, 1]) * self.nc + cid[:, 2]
            self.order = torch.argsort(flat)
            count = torch.bincount(flat, minlength=self.nc ** 3)
            self.start = torch.cumsum(count, 0) - count
            self.count = count
            off = torch.tensor([(a, b, c) for a in (-1, 0, 1)
                                for b in (-1, 0, 1) for c in (-1, 0, 1)],
                               device=pos.device)
            self.off = off

    def _cell(self, x):
        c = torch.floor(x / self.box * self.nc).long()
        return torch.clamp(c, 0, self.nc - 1)

    def _candidates(self, rows):
        """[B, K] candidate j (-1 padded) of ``rows``."""
        if self.nc < 3:
            n = self.pos.shape[0]
            return torch.arange(n, device=rows.device).expand(len(rows), n)
        nc = self.nc
        c = (self._cell(self.pos[rows])[:, None, :] + self.off) % nc
        flat = (c[..., 0] * nc + c[..., 1]) * nc + c[..., 2]      # [B, 27]
        st, ct = self.start[flat], self.count[flat]
        kmax = int(ct.max())
        ar = torch.arange(kmax, device=rows.device)
        idx = st[..., None] + ar                                   # [B,27,k]
        ok = ar < ct[..., None]
        j = self.order[torch.where(ok, idx, 0)]
        return torch.where(ok, j, -1).reshape(len(rows), -1)

    def pairs(self, rows):
        """(i, j, dx, r): i indexes ``rows``, j the whole box, dx = x_i -
        x_j by the minimum image, r = |dx| < radius."""
        out = []
        for b0 in range(0, len(rows), self.block):
            blk = rows[b0:b0 + self.block]
            cand = self._candidates(blk)
            ok = cand >= 0
            bi, kk = torch.nonzero(ok, as_tuple=True)
            j = cand[bi, kk]
            dx = self.pos[blk[bi]] - self.pos[j]
            dx = dx - self.box * torch.round(dx / self.box)
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
    eta3 = sph["eta"] ** 3
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
        rho_h = m_safe * eta3 / h**3
        dphi = drdh + 3.0 * rho_h / h
        dphi = torch.where(torch.abs(dphi) < _TINY, -_TINY, dphi)
        dh = torch.clamp(-(rho - rho_h) / dphi, -0.5 * h, 0.5 * h)
        h = torch.clamp_max(h + dh, hcap)
        h_peak = torch.maximum(h_peak, h.max())
    rho, drdh = walk(h)
    rho = torch.clamp_min(rho, 1e-15)
    om = (1.0 + h / (3.0 * rho) * drdh if sph["grad_h"]
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
        cross = torch.stack([dv[:, 1] * dx[:, 2] - dv[:, 2] * dx[:, 1],
                             dv[:, 2] * dx[:, 0] - dv[:, 0] * dx[:, 2],
                             dv[:, 0] * dx[:, 1] - dv[:, 1] * dx[:, 0]], -1)
        curl = ar.psum(w[:, None], cross, i, n)
        divv = -div / rho
        curl = torch.sqrt(torch.sum(curl * curl, dim=-1)) / rho
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
    rn = torch.sqrt(torch.sum(dx * dx, dim=-1))
    return dict(
        acc=-ar.psum(fcoef[:, None], dx, i, n),
        du_dt=ar.psum(wdu, vdotr, i, n),
        acc_abs=ar.psum(torch.abs(fcoef), rn, i, n),
        du_abs=ar.psum(torch.abs(wdu), torch.abs(vdotr), i, n))


# ---- driving ----------------------------------------------------------------


def drive_modes(kmin: int, kmax: int, device):
    """Integer wavevectors with kmin <= |k| <= kmax, one of each +/- pair,
    in the order of a lexicographic sweep from -kmax."""
    rng = range(-kmax, kmax + 1)
    seen, keep = set(), []
    for k in ((a, b, c) for a in rng for b in rng for c in rng):
        if kmin**2 <= sum(x * x for x in k) <= kmax**2:
            if tuple(-x for x in k) not in seen:
                seen.add(k)
                keep.append(k)
    return torch.tensor(keep, dtype=torch.float64, device=device)


def ou_update(amp_re, amp_im, modes, dt, drv, xi_re, xi_im):
    """One Ornstein-Uhlenbeck step of the mode amplitudes, solenoidal."""
    k = modes * (2.0 * math.pi / drv["box"])
    khat = k / torch.linalg.norm(k, dim=-1, keepdim=True)
    f = math.exp(-dt / drv["tau"])
    sig = drv["accel_rms"] / math.sqrt(amp_re.shape[0])
    scale = sig * math.sqrt(1.0 - f * f)
    out = []
    for a, xi in ((amp_re, xi_re), (amp_im, xi_im)):
        a = a * f + scale * xi
        out.append(a - torch.sum(a * khat, dim=-1, keepdim=True) * khat)
    return out


def drive_accel(ar: Arith, x, amp_re, amp_im, modes, drv):
    k = (modes * (2.0 * math.pi / drv["box"])).to(ar.dtype)
    phase = ar.matmul(x, k.T)
    return (ar.matmul(torch.cos(phase), amp_re.to(ar.dtype))
            - ar.matmul(torch.sin(phase), amp_im.to(ar.dtype)))


# ---- a derived pass, a KDK step, a rung tick --------------------------------


def _wrap(x, box):
    return torch.remainder(x, box)


class Derived:
    """The derived pass at positions ``x`` for the rows ``rows``: the rows
    their forces need get kernel A's stage (``fresh`` rows from h0, the
    others keep ``stale`` values), then kernel C. ``hcap`` is the
    structural h cap the configuration states."""

    def __init__(self, ar, x, vel, mass, u, sph, hcap, box, h_hint):
        self.ar, self.x, self.vel, self.mass, self.u = ar, x, vel, mass, u
        self.sph, self.hcap, self.box = sph, hcap, box
        self.radius = 2.0 * min(hcap, 1.15 * h_hint)

    def run(self, rows, h0, fresh=None, stale=None):
        """h0: whole-box start h; ``fresh`` a whole-box bool (None: all),
        ``stale`` whole-box h, rho, omega, bf for the other rows."""
        while True:
            grid = Grid(self.x, self.radius, self.box)
            pr = grid.pairs(rows)
            need = torch.unique(torch.cat([rows, pr[1]]))
            dens_rows = need if fresh is None else need[fresh[need]]
            d = density(self.ar, grid.pairs(dens_rows), dens_rows, self.x,
                        self.vel, self.mass, self.u[dens_rows],
                        h0[dens_rows], self.sph, self.hcap)
            if (self.radius >= 2.0 * self.hcap
                    or 2.0 * d["h_peak"] < self.radius):
                break
            self.radius = 2.0 * self.hcap
        n = self.x.shape[0]
        nan = torch.full((n,), float("nan"), dtype=self.x.dtype,
                         device=self.x.device)
        f = {}
        for k in ("h", "rho", "omega", "bf", "divv", "div_abs"):
            base = nan.clone()
            if stale is not None and k in stale:
                base[need] = stale[k][need].to(self.x.dtype)
            base[dens_rows] = d[k]
            f[k] = base
        f["P"], f["cs"] = nan.clone(), nan.clone()
        f["P"][need], f["cs"][need] = eos(f["rho"][need], self.u[need],
                                          self.sph)
        out = forces(self.ar, pr, rows, self.vel, self.mass, f, self.sph)
        out.update({k: f[k][rows] for k in ("h", "rho", "omega", "P", "cs",
                                             "divv", "div_abs")})
        return out


def cast(arrays: dict, ar: Arith) -> dict:
    return {k: (v.to(ar.dtype) if torch.is_floating_point(v) else v)
            for k, v in arrays.items()}


def derived_start(ar, ics, rows, sph, hcap, box):
    """The set-up's derived pass on the ICs (dict pos, vel, mass, u, h)."""
    s = cast(ics, ar)
    d = Derived(ar, _wrap(s["pos"], box), s["vel"], s["mass"], s["u"], sph,
                hcap, box, float(s["h"].max()))
    return d.run(rows, s["h"])


def kdk_step(ar, st, rows, sph, hcap, box, drive=None):
    """One global KDK step from the state ``st`` (pos, vel, mass, u, h, cs,
    acc, du_dt) for ``rows``: dt from the state, half-kick, drift, the
    derived pass (plus the driving acceleration of ``drive`` =
    (amp_re, amp_im, modes, spec) at the new positions), half-kick."""
    s = cast(st, ar)
    dt = particle_dt(s["h"], s["cs"], s["acc"], sph).min()
    v_h = s["vel"] + 0.5 * dt * s["acc"]
    u_h = torch.clamp_min(s["u"] + 0.5 * dt * s["du_dt"], sph["u_floor"])
    x = _wrap(s["pos"] + dt * v_h, box)
    d = Derived(ar, x, v_h, s["mass"], u_h, sph, hcap, box,
                float(s["h"].max()))
    out = d.run(rows, s["h"])
    if drive is not None:
        amp_re, amp_im, modes, spec = drive
        out["acc"] = out["acc"] + drive_accel(ar, x[rows], amp_re, amp_im,
                                              modes, spec)
    out["vel"] = v_h[rows] + 0.5 * dt * out["acc"]
    out["u"] = torch.clamp_min(u_h[rows] + 0.5 * dt * out["du_dt"],
                               sph["u_floor"])
    out["pos"], out["dt"] = x[rows], dt
    return out


def rung_tick(ar, st, rows, k: int, dt_min, n_rungs: int, sph, hcap, box):
    """Tick ``k`` of a span for ``rows`` from the state before it (pos, vel,
    mass, u, h, rho, omega, divv, acc, du_dt, the carried viscosity factor
    bf and the rung of every particle): open the steps that start at k, drift all
    by dt_min, the derived pass for the closers (the others keep their
    stale h, rho, Omega and factor), their closing half-kick and their new
    rung. Rows that do not close come back drifted, with their stale
    fields. Returns whole-row fields and ``close`` and ``rung``."""
    s = cast(st, ar)
    dt_min = dt_min.to(ar.dtype)
    rung = s["rung"].long()
    mask = (1 << rung) - 1
    dt_r = dt_min * torch.exp2(rung.to(ar.dtype))
    open_m = (k & mask) == 0
    close = ((k + 1) & mask) == 0
    half = torch.where(open_m, 0.5 * dt_r, 0.0)
    v_h = s["vel"] + half[:, None] * s["acc"]
    u_h = torch.clamp_min(s["u"] + half * s["du_dt"], sph["u_floor"])
    x = _wrap(s["pos"] + dt_min * v_h, box)
    d = Derived(ar, x, v_h, s["mass"], u_h, sph, hcap, box,
                float(s["h"].max()))
    stale = dict(h=s["h"], rho=s["rho"], omega=s["omega"], bf=s["bf"],
                 divv=s["divv"])
    out = d.run(rows, s["h"], fresh=close, stale=stale)
    c = close[rows]
    half_c = torch.where(c, 0.5 * dt_r[rows], 0.0)
    out["acc"] = torch.where(c[:, None], out["acc"], s["acc"][rows])
    out["du_dt"] = torch.where(c, out["du_dt"], s["du_dt"][rows])
    out["vel"] = v_h[rows] + half_c[:, None] * out["acc"]
    out["u"] = torch.clamp_min(u_h[rows] + half_c * out["du_dt"],
                               sph["u_floor"])
    out["pos"] = x[rows]
    dt_des = particle_dt(out["h"], out["cs"], out["acc"], sph)
    r_des = rung_of(dt_des, dt_min, n_rungs).long()
    kp = k + 1
    align = sum(int(kp % (1 << j) == 0) for j in range(1, n_rungs))
    r_new = torch.where(r_des < rung[rows], r_des,
                        torch.clamp_max(r_des, align))
    out["rung"] = torch.where(c, r_new, rung[rows])
    out["log2_ratio"] = torch.log2(torch.clamp_min(dt_des / dt_min, 1.0))
    out["close"] = c
    return out
