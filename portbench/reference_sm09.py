"""Plain torch reference of block timesteps with Saitoh & Makino's timestep
limiter and the wake-up of sleeping neighbours, for the check.

The configurations that name it (``"reference": "reference_sm09"``) run
``sedov ... limiter=4``: every particle's step within a factor A = 4 of its
neighbours' (Saitoh & Makino 2009), and a particle asleep on a long step
woken when a closing neighbour's new step is more than A times shorter
(Durier & Dalla Vecchia 2012). Neighbours are the pairs |x_i - x_j| < 2
max(h_i, h_j), j another particle, by the minimum image. The scheme, on
rungs r (dt_r = 2^r dt_min) and with A = 2^a:

- at a span's sync point each rung is cut to at most a above the lowest
  rung among its neighbours, repeated until no rung changes
  (``sync_limit``);
- at tick k a closer's wanted dt is cut to at most A min_j dt_{r_j} over
  its neighbours' current rungs, then turned into a rung as without the
  limiter (decrease freely, increase onto ticks the new rung divides);
- a row j that does not close, with a closing neighbour i whose new rung
  r_i' has r_j > r_i' + a, takes the rung max(r_i' + a, ceil(log2(k + 2 -
  k0))), the least over such i (k0 = k - k mod 2^{r_j}, its opening tick),
  and its velocity and u lose 1/2 (2^{r_j} - 2^{r'}) dt_min times its
  stored acceleration and du/dt.

``rung_tick`` is ``reference.rung_tick`` with these: the derived pass of a
closer is the same, its rung is limited, and a sampled row that does not
close comes back woken where a closing neighbour wakes it (the closers
near it are computed for that). Its ``log2_ratio`` tells the check which
closers' rungs are certain: log2(dt / dt_min) where the closer's own dt
decides, a half past the cap where the cap decides, and a whole number
(never certain) where a neighbour within 1e-5 of the edge 2 max(h_i, h_j)
could move the cap.

The rest is ``reference``'s, unchanged. It imports nothing of the program.
"""
from __future__ import annotations

import torch

from portbench.reference import (Arith, Derived, Grid, _wrap, cast,  # noqa
                                 density, derived_start, drive_modes, eos,
                                 forces, kdk_step, ou_update, particle_dt,
                                 rung_of)

# the configurations' limiter: neighbours' steps within a factor A = 2^a
A = 4
_A = 2
# relative half-width of the band around the edge 2 max(h_i, h_j) in which a
# pair's rounding could decide whether it is a neighbour
_EDGE = 1e-5


class _Derived(Derived):
    """The derived pass, with the neighbour search at the structural cap
    from the start (every row within 2 hcap of a row asked for gets its
    fields), and the whole-box fields it computed kept beside its
    answer."""

    def __init__(self, ar, x, vel, mass, u, sph, hcap, box):
        super().__init__(ar, x, vel, mass, u, sph, hcap, box, hcap)
        self.radius = 2.0 * hcap

    def run(self, rows, h0, fresh=None, stale=None):
        grid = Grid(self.x, self.radius, self.box)
        pr = grid.pairs(rows)
        need = torch.unique(torch.cat([rows, pr[1]]))
        dens_rows = need if fresh is None else need[fresh[need]]
        d = density(self.ar, grid.pairs(dens_rows), dens_rows, self.x,
                    self.vel, self.mass, self.u[dens_rows], h0[dens_rows],
                    self.sph, self.hcap)
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
        return out, f


def neighbour_pairs(grid: Grid, h, rows):
    """(i, j, r, edge): i indexes ``rows``, j another particle with r =
    |x_i - x_j| (minimum image) below the grid's radius, edge = 2 max(h_i,
    h_j); ``h`` a whole-box array valid on the rows and their partners."""
    i, j, _, r = grid.pairs(rows)
    other = j != rows[i]
    i, j, r = i[other], j[other], r[other]
    return i, j, r, 2.0 * torch.maximum(h[rows][i], h[j])


def _lowest(i, rung_j, n: int, n_rungs: int):
    m = torch.full((n,), n_rungs - 1, dtype=torch.long, device=rung_j.device)
    return m.scatter_reduce(0, i, rung_j, reduce="amin")


def sync_limit(ar, pos, h, rung, n_rungs: int, box: float):
    """The span's sync point: every rung cut to at most a above the lowest
    rung among its neighbours, repeated until no rung changes. ``pos``,
    ``h`` and ``rung`` of every particle; returns the rungs (int32)."""
    x = _wrap(pos.to(ar.dtype), box)
    h = h.to(ar.dtype)
    rung = rung.long()
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    grid = Grid(x, 2.0 * float(h.max()) * (1.0 + 2.0 * _EDGE), box)
    i, j, r, edge = neighbour_pairs(grid, h, rows)
    keep = r < edge
    i, j = i[keep], j[keep]
    for _ in range(n_rungs):
        new = torch.minimum(rung, _lowest(i, rung[j], n, n_rungs) + _A)
        if torch.equal(new, rung):
            break
        rung = new
    return rung.to(torch.int32)


def _aligned(r_des, rung, k: int, n_rungs: int):
    kp = k + 1
    align = sum(int(kp % (1 << j) == 0) for j in range(1, n_rungs))
    return torch.where(r_des < rung, r_des, torch.clamp_max(r_des, align))


def rung_tick(ar, st, rows, k: int, dt_min, n_rungs: int, sph, hcap, box):
    """Tick ``k`` of a span for ``rows`` from the state before it (pos,
    vel, mass, u, h, rho, omega, divv, acc, du_dt, the carried viscosity
    factor bf and the rung of every particle), as ``reference.rung_tick``
    with the limiter and the wake-up: closers come back with their fresh
    fields, closing half-kick and limited rung, the other rows drifted with
    their stale fields, woken where a closing neighbour wakes them (their
    new rung, velocity and u). Returns whole-row fields and ``close``,
    ``rung`` and ``log2_ratio``."""
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

    # the closers a sampled row depends on: its own rows, and the closers
    # near a sampled row that does not close (they may wake it)
    grid = Grid(x, 2.0 * hcap * (1.0 + 2.0 * _EDGE), box)
    asleep = rows[~close[rows]]
    near = grid.pairs(asleep)[1] if len(asleep) else asleep
    near = torch.unique(near[close[near]])
    extra = near[~torch.isin(near, rows)]
    rows2 = torch.cat([rows, extra])

    # the derived pass for the closers alone: the other rows keep their
    # stale fields, drift and are not kicked
    c = close[rows2]
    cl = torch.nonzero(c).reshape(-1)
    n_all = x.shape[0]
    out = {f: s[f][rows2].clone() for f in ("h", "rho", "omega", "divv")}
    out["acc"], out["du_dt"] = s["acc"][rows2].clone(), \
        s["du_dt"][rows2].clone()
    zero = torch.zeros(len(rows2), dtype=x.dtype, device=x.device)
    for f in ("cs", "div_abs", "acc_abs", "du_abs"):
        out[f] = zero.clone()
    h_now = s["h"].clone()
    if len(cl):
        d = _Derived(ar, x, v_h, s["mass"], u_h, sph, hcap, box)
        stale = dict(h=s["h"], rho=s["rho"], omega=s["omega"], bf=s["bf"],
                     divv=s["divv"])
        fresh, f = d.run(rows2[cl], s["h"], fresh=close, stale=stale)
        for key in ("h", "rho", "omega", "divv", "acc", "du_dt", "cs",
                    "div_abs", "acc_abs", "du_abs"):
            out[key][cl] = fresh[key]
        h_now = torch.where(torch.isnan(f["h"]), h_now, f["h"])
    half_c = torch.where(c, 0.5 * dt_r[rows2], 0.0)
    out["vel"] = v_h[rows2] + half_c[:, None] * out["acc"]
    out["u"] = torch.clamp_min(u_h[rows2] + half_c * out["du_dt"],
                               sph["u_floor"])
    out["pos"] = x[rows2]
    dt_des = particle_dt(out["h"], out["cs"], out["acc"], sph)
    r_des = rung_of(dt_des, dt_min, n_rungs).long()
    lr = torch.log2(torch.clamp_min(dt_des / dt_min, 1.0))

    # the limiter: each closer's neighbours' lowest current rung, with the
    # pairs at the edge counted in and out
    new = rung[rows2].clone()
    if len(cl):
        i, j, r, edge = neighbour_pairs(grid, h_now, rows2[cl])
        inner, outer = r < edge * (1.0 - _EDGE), r < edge * (1.0 + _EDGE)
        lows = [_lowest(i[w], rung[j[w]], len(cl), n_rungs)
                for w in (inner, outer, r < edge)]
        ri = rung[rows2[cl]]
        got = [_aligned(torch.minimum(r_des[cl], m + _A), ri, k, n_rungs)
               for m in lows]
        new[cl] = got[2]
        cap = lows[2] + _A
        lr_c = torch.minimum(lr[cl], cap.to(lr.dtype) + 0.5)
        lr[cl] = torch.where(got[0] == got[1], lr_c, torch.round(lr_c))

    # the wake-up of each sampled row that does not close
    n_rows = len(rows)
    sl = torch.nonzero(~c[:n_rows]).reshape(-1)
    if len(sl) and len(cl):
        where_cl = torch.full((n_all,), -1, dtype=torch.long,
                              device=x.device)
        where_cl[rows2[cl]] = cl
        i, j, r, edge = neighbour_pairs(grid, h_now, rows2[sl])
        by = where_cl[j]
        hit = (by >= 0) & (r < edge)
        i, by = i[hit], by[hit]
        rj = rung[rows2[sl]]
        pv = new[by] + _A
        k0 = k - (k % (1 << rj))
        need = torch.ceil(torch.log2((k + 2 - k0).double())).long()
        v = torch.maximum(pv, need[i])
        lands = v < rj[i]
        target = rj.clone().scatter_reduce(0, i[lands], v[lands],
                                           reduce="amin")
        woken = target < rj
        back = torch.where(woken, 0.5 * dt_min * (
            torch.exp2(rj.to(ar.dtype)) - torch.exp2(target.to(ar.dtype))),
            0.0)
        rs = sl[woken]
        acc_j, du_j = s["acc"][rows2[rs]], s["du_dt"][rows2[rs]]
        out["vel"][rs] = out["vel"][rs] - back[woken][:, None] * acc_j
        out["u"][rs] = torch.clamp_min(out["u"][rs] - back[woken] * du_j,
                                       sph["u_floor"])
        new[sl] = target
    out["rung"] = new
    out["log2_ratio"] = lr
    out["close"] = c
    return {key: (v[:n_rows] if torch.is_tensor(v) and v.dim()
                  and len(v) == len(rows2) else v)
            for key, v in out.items()}
