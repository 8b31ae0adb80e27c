"""The CUDA kernels A, C (with and without its P3M gravity mode; A and C
in 3D, 2D and 1D, in place and compact, on the masked tables of the
block-timestep path and on a slab shard's masked structure; on clustered
states whose h varies about 6x inside a warp, with more survivors than a
batch; one launch a call under their pair walks' names, bitwise
repeatable) and G against
their plain torch versions, on a card; a block-timestep tick's pass
through the row-packing kernels against the same pass through their plain
versions; block timesteps with one rung
against the global-dt loop; and the slab decomposition's ranks, sharing
the card over gloo, against the single-device engine, with block
timesteps too (kernels A and C on a shard masked to a rung tick's
closers, a quiet rank's fully masked pass among them); and a 2x2 grid of
pencil ranks: A and C (and C's gravity mode) on a pencil shard's
structure, and a lockstep with one device; the flagship step of
``sphax_torch.entry.entry()`` against its plain step; the small
launches that ``compute-sanitizer`` checks; and the cell-list engine
against the window engine, the equal-extent slabs against one device,
the sorted-order P3M mesh against the scatter mesh, and the P3M mesh's CIC
kernels against their plain versions (the interpolation bit for bit),
and the timestep limiter's kernels against theirs (bit for bit).

These tests import no JAX (the machine with the card has none) and skip
where no CUDA device is visible. Run them on the card without the suite's
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Rows that are not particles (ghost images, padding) are don't-care by
contract, so every comparison is on ``is_real`` rows. Tolerances: fp32
3e-5 (rtol, and atol 3e-5 of the largest value: the sums are taken in
another order), fp64 1e-10, and 2e-3 for fp32 ``fast_math`` against the
exact plain version. Kernel G's fp32 tolerance is 1e-4 (rtol, and atol 1e-4
of the largest value): each row sums N terms in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sphax_torch import configs, convert, make_state, problems
from sphax_torch.core.state import box
from sphax_torch.dist import comm, pencil, wslab
from sphax_torch.ics import kh, lattice, turbulence
from sphax_torch.integrate import leapfrog, rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import direct_gravity as dg
from sphax_torch.physics import pm, rowpack, wengine
from sphax_torch.physics import window_kernels as wk
from tests._slab_helpers import kernel_calls, lockstep, pencil_lockstep

TOL = {torch.float32: 3e-5, torch.float64: 1e-10}
A_CASES = {
    "cold_newton2": dataclasses.replace(configs.TURB, newton_iters=2),
    "h_predict": dataclasses.replace(configs.TURB, newton_iters=1,
                                     h_predict=True),
    "balsara_off": configs.SPHConfig(dim=3, adaptive_h=True, newton_iters=2),
}
KNOBS = dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2)
# 2D: the kh problem's configuration and window knobs (problems.kh)
A_CASES_2D = {
    "kh_cold": configs.KH,
    "kh_balsara_off": dataclasses.replace(configs.KH, balsara=False),
}
KNOBS_2D = dict(cutoff_scale=1.25, fast_sub=3, rgroups=2)
# 1D: a periodic line of 2^15 particles, the production window knobs
CFG_1D = configs.SPHConfig(dim=1, gamma=1.4, adaptive_h=True, grad_h=True,
                           balsara=True, newton_iters=2)
N_1D = 1 << 15
P3M = dataclasses.replace(configs.TURB, newton_iters=1, gravity=True,
                          grav_solver="p3m", grav_mesh=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, n_side=16, seed=0, periodic=True, dim=3,
            compact=False):
    """Sorted inputs at the production window geometry, owner-consistent on
    ghost rows, from the turbulence ICs (3D) or the Kelvin-Helmholtz ICs
    with nx = 4 n_side (2D) and a seeded generator; ``compact`` plans the
    compacted candidate lists (``window.plan_compact``)."""
    if dim == 1:
        ic = dict(pos=lattice.cubic_lattice((N_1D,), [0.0], [1.0]),
                  vel=0.0, mass=1.0 / N_1D, u=1.0, h=CFG_1D.eta / N_1D)
        ic = {k: torch.as_tensor(v, dtype=dtype).expand(
            (N_1D, 1) if k in ("pos", "vel") else (N_1D,)).clone()
            for k, v in ic.items()}
    else:
        ic = (turbulence.build(n_side=n_side) if dim == 3
              else kh.build(nx=4 * n_side))
    st = make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=device)
                      for k in ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(dim, dtype=dtype, device=device),
              torch.ones(dim, dtype=dtype, device=device), periodic=periodic)
    h_max = float(st.h.max()) * (1.05 if dim == 3 else 1.3)
    plan = win.plan_compact if compact else win.plan_measured
    # the 1D line takes the 2D problem's knobs (problems._window_engine's)
    spec = plan(st.pos, dom, h_max=h_max, dim=dim,
                **(KNOBS if dim == 3 else KNOBS_2D))
    wd = win.build(st.pos, dom, spec)
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(lo, hi):
        return lo + (hi - lo) * torch.rand(st.n, generator=g, dtype=dtype,
                                           device=device)
    vel = 0.4 * torch.randn(st.vel.shape, generator=g, dtype=dtype,
                            device=device)
    rho = rnd(0.8, 1.2)
    cols = dict(vel_s=(vel, 0.0), mass_s=(st.mass, 0.0), h0_s=(st.h, 1.0),
                h_s=(st.h * rnd(0.95, 1.05), 1.0), rho_s=(rho, 1.0),
                P_s=(rho * rnd(0.9, 1.1), 1.0), cs_s=(rnd(0.8, 1.2), 1.0),
                om_s=(rnd(0.9, 1.1), 1.0), bf_s=(rnd(0.0, 1.0), 0.0))
    f = {k: win.gather_sorted(v, wd, fill) for k, (v, fill) in cols.items()}
    f["pos_s"] = wd.pos_s
    return st, dom, spec, wd, f


def _compare(got, want, real, tol, what):
    got, want = got[real].double().cpu(), want[real].double().cpu()
    assert bool(torch.isfinite(got).all()), what
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()), msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(A_CASES))
def test_solve_h_density_kernel_matches_plain(cuda, dtype, case):
    cfg = A_CASES[case]
    _, _, spec, wd, f = _inputs(cuda, dtype)
    vel = f["vel_s"] if cfg.need_divv else None
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    n0 = wk.LAUNCHES["solve_h_density"]
    got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=vel)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["solve_h_density"] == n0 + 1
    want = wk.solve_h_density_plain(wd, spec, *args, cfg, vel_s=vel)
    assert len(got) == len(want) == (5 if cfg.need_divv else 3)
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, wd.is_real, TOL[dtype], f"{case} output {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.float64, False),
                                        (torch.float32, True)])
@pytest.mark.parametrize("balsara", [True, False])
def test_forces_kernel_matches_plain(cuda, dtype, fast, balsara):
    cfg = dataclasses.replace(configs.TURB, balsara=balsara, fast_math=fast)
    _, _, spec, wd, f = _inputs(cuda, dtype, seed=1)
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    n0 = wk.LAUNCHES["forces"]
    got = wk.forces(wd, spec, *args, cfg)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["forces"] == n0 + 1
    want = wk.forces_plain(wd, spec, *args, cfg)
    tol = 2e-3 if fast else TOL[dtype]
    _compare(got[0], want[0], wd.is_real, tol, "acc")
    _compare(got[1], want[1], wd.is_real, tol, "du")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(A_CASES_2D))
def test_solve_h_density_2d_kernel_matches_plain(cuda, dtype, case):
    """Kernel A's dim=2 instantiation at the kh problem's geometry."""
    cfg = A_CASES_2D[case]
    _, _, spec, wd, f = _inputs(cuda, dtype, dim=2)
    assert spec.n_seg == 3
    vel = f["vel_s"] if cfg.need_divv else None
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    n0 = dict(wk.LAUNCHES)
    got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=vel)
    torch.cuda.synchronize()
    assert {k: wk.LAUNCHES[k] - n0[k] for k in n0} == {
        k: int(k == "solve_h_density_2d") for k in n0}
    want = wk.solve_h_density_plain(wd, spec, *args, cfg, vel_s=vel)
    assert len(got) == len(want) == (5 if cfg.need_divv else 3)
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, wd.is_real, TOL[dtype], f"{case} output {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.float64, False),
                                        (torch.float32, True)])
@pytest.mark.parametrize("balsara", [True, False])
def test_forces_2d_kernel_matches_plain(cuda, dtype, fast, balsara):
    """Kernel C's dim=2 instantiation; its gravity mode is 3D only."""
    cfg = dataclasses.replace(configs.KH, balsara=balsara, fast_math=fast)
    _, dom, spec, wd, f = _inputs(cuda, dtype, seed=1, dim=2)
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    n0 = dict(wk.LAUNCHES)
    got = wk.forces(wd, spec, *args, cfg)
    torch.cuda.synchronize()
    assert {k: wk.LAUNCHES[k] - n0[k] for k in n0} == {
        k: int(k == "forces_2d") for k in n0}
    assert tuple(got[0].shape) == (spec.n_sorted, 2)
    want = wk.forces_plain(wd, spec, *args, cfg)
    tol = 2e-3 if fast else TOL[dtype]
    _compare(got[0], want[0], wd.is_real, tol, "acc")
    _compare(got[1], want[1], wd.is_real, tol, "du")
    rs = torch.ones((), dtype=dtype, device=cuda)
    with pytest.raises(NotImplementedError):
        wk.forces(wd, spec, *args, cfg, grav=(rs, 0.01))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.float64, False),
                                        (torch.float32, True)])
def test_forces_grav_kernel_matches_plain(cuda, dtype, fast):
    """Kernel C's gravity mode: the fused screened P3M short range, split
    scalars from pm.rs_traced at the structure's cutoff."""
    cfg = dataclasses.replace(P3M, fast_math=fast)
    _, dom, spec, wd, f = _inputs(cuda, dtype, seed=2)
    grav = (pm.rs_traced(cfg, dom, dtype, cutoff=spec.cutoff), cfg.grav_eps)
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    n0 = dict(wk.LAUNCHES)
    got = wk.forces(wd, spec, *args, cfg, grav=grav)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["forces_grav"] == n0["forces_grav"] + 1
    assert wk.LAUNCHES["forces"] == n0["forces"]
    want = wk.forces_plain(wd, spec, *args, cfg, grav=grav)
    tol = 2e-3 if fast else TOL[dtype]
    _compare(got[0], want[0], wd.is_real, tol, "acc")
    _compare(got[1], want[1], wd.is_real, tol, "du")


def _launched(n0, key):
    """Only ``key`` launched, once, since the counts ``n0``."""
    return {k: wk.LAUNCHES[k] - n0[k] for k in n0} == {
        k: int(k == key) for k in n0}


COMPACT_A = {"cold_newton2": 3, "h_predict": 3, "kh_cold": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(COMPACT_A))
def test_solve_h_density_compact_kernel_matches_plain(cuda, dtype, case):
    """Kernel A's compact walk against the compact plain version, and
    against the in-place kernel on the same inputs (the same pairs)."""
    dim = COMPACT_A[case]
    cfg = A_CASES[case] if dim == 3 else A_CASES_2D[case]
    _, _, spec, wd, f = _inputs(cuda, dtype, dim=dim, compact=True)
    assert spec.cwidth > 0 and int(wd.overflow) == 0
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    n0 = dict(wk.LAUNCHES)
    got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
    torch.cuda.synchronize()
    assert _launched(n0, wk._kernel_name("solve_h_density_compact", dim))
    want = wk.solve_h_density_plain(wd, spec, *args, cfg, vel_s=f["vel_s"])
    inplace = wk.solve_h_density(wd, dataclasses.replace(spec, cwidth=0),
                                 *args, cfg, vel_s=f["vel_s"])
    for k, (a, b, c) in enumerate(zip(got, want, inplace)):
        _compare(a, b, wd.is_real, TOL[dtype], f"{case} output {k}")
        _compare(a, c, wd.is_real, 3e-5, f"{case} output {k} vs in place")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.float64, False),
                                        (torch.float32, True)])
@pytest.mark.parametrize("mode", ["3d", "2d", "grav"])
def test_forces_compact_kernel_matches_plain(cuda, dtype, fast, mode):
    """Kernel C's compact walk (3D, 2D, and the gravity mode, whose
    screened pairs reach to the cutoff) against the compact plain version,
    and against the in-place kernel."""
    dim = 2 if mode == "2d" else 3
    cfg = {"3d": configs.TURB, "2d": configs.KH, "grav": P3M}[mode]
    cfg = dataclasses.replace(cfg, fast_math=fast)
    _, dom, spec, wd, f = _inputs(cuda, dtype, seed=1, dim=dim, compact=True)
    grav = None
    if mode == "grav":
        grav = (pm.rs_traced(cfg, dom, dtype, cutoff=spec.cutoff),
                cfg.grav_eps)
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    n0 = dict(wk.LAUNCHES)
    got = wk.forces(wd, spec, *args, cfg, grav=grav)
    torch.cuda.synchronize()
    key = "forces_grav_compact" if grav else wk._kernel_name(
        "forces_compact", dim)
    assert _launched(n0, key)
    want = wk.forces_plain(wd, spec, *args, cfg, grav=grav)
    inplace = wk.forces(wd, dataclasses.replace(spec, cwidth=0), *args, cfg,
                        grav=grav)
    tol = 2e-3 if fast else TOL[dtype]
    for k, what in ((0, "acc"), (1, "du")):
        _compare(got[k], want[k], wd.is_real, tol, what)
        _compare(got[k], inplace[k], wd.is_real, 3e-5, f"{what} vs in place")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [False, True])
def test_1d_kernels_match_plain(cuda, dtype, compact):
    """The dim=1 instantiations of kernels A (cold, 2 Newton updates; its
    curl output is zero) and C (exact, and fp32 fast_math), in place and
    compact, each under its own launch key."""
    _, _, spec, wd, f = _inputs(cuda, dtype, dim=1, compact=compact)
    assert spec.n_seg == 1 and bool(spec.cwidth) == compact
    tag = "_compact" if compact else ""
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    n0 = dict(wk.LAUNCHES)
    got = wk.solve_h_density(wd, spec, *args, CFG_1D, vel_s=f["vel_s"])
    torch.cuda.synchronize()
    assert _launched(n0, f"solve_h_density{tag}_1d")
    want = wk.solve_h_density_plain(wd, spec, *args, CFG_1D,
                                    vel_s=f["vel_s"])
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, wd.is_real, TOL[dtype], f"A 1d output {k}")
    assert not bool(got[4][wd.is_real].any())
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    want = wk.forces_plain(wd, spec, *args, CFG_1D)
    for fast in ((False, True) if dtype == torch.float32 else (False,)):
        n0 = dict(wk.LAUNCHES)
        got = wk.forces(wd, spec, *args,
                        dataclasses.replace(CFG_1D, fast_math=fast))
        torch.cuda.synchronize()
        assert _launched(n0, f"forces{tag}_1d")
        assert tuple(got[0].shape) == (spec.n_sorted, 1)
        tol = 2e-3 if fast else TOL[dtype]
        _compare(got[0], want[0], wd.is_real, tol, "acc")
        _compare(got[1], want[1], wd.is_real, tol, "du")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [False, True])
def test_masked_kernels_match_plain(cuda, dtype, compact):
    """Kernels A and C on ``rungs.mask_structure``d tables (the rows within
    0.25 of the box centre active, about 7 % of the box): against the plain
    versions on the real rows of active groups; on the masked groups h is
    h0 and every other output exactly zero."""
    cfg = A_CASES["cold_newton2"]
    _, _, spec, wd, f = _inputs(cuda, dtype, compact=compact)
    act_s = (f["pos_s"] - 0.5).norm(dim=-1) < 0.25
    wm = rungs.mask_structure(wd, spec, act_s)
    act = act_s.reshape(spec.n_groups, spec.group).any(1).repeat_interleave(
        spec.group)
    assert 0 < int(act.sum()) < act.numel()
    assert torch.equal(wk._group_active(wm, spec).repeat_interleave(
        spec.group), act & wk._group_active(wd, spec).repeat_interleave(
            spec.group))
    rows = act & wd.is_real
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    got = wk.solve_h_density(wm, spec, *args, cfg, vel_s=f["vel_s"])
    want = wk.solve_h_density_plain(wm, spec, *args, cfg, vel_s=f["vel_s"])
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, rows, TOL[dtype], f"masked A output {k}")
    assert torch.equal(got[0][~act], f["h0_s"][~act])
    assert not any(bool(o[~act].any()) for o in got[1:])
    args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s",
                           "cs_s", "om_s", "bf_s")]
    got = wk.forces(wm, spec, *args, cfg)
    want = wk.forces_plain(wm, spec, *args, cfg)
    _compare(got[0], want[0], rows, TOL[dtype], "masked acc")
    _compare(got[1], want[1], rows, TOL[dtype], "masked du")
    assert not bool(got[0][~act].any()) and not bool(got[1][~act].any())


def _fields_a(st, wd, seed):
    """Kernel A's sorted inputs for ``st`` with a seeded 0.4 N(0,1)
    velocity (the Balsara sums vanish on a resting state)."""
    g = torch.Generator(device=st.pos.device).manual_seed(seed)
    vel = 0.4 * torch.randn(st.pos.shape, generator=g, dtype=st.pos.dtype,
                            device=st.pos.device)
    return dict(pos_s=wd.pos_s, mass_s=win.gather_sorted(st.mass, wd),
                h0_s=win.gather_sorted(st.h, wd, 1.0),
                vel_s=win.gather_sorted(vel, wd))


def _warp_h_ratio(f):
    """The largest ratio of h between two rows with mass of one warp."""
    wh = f["h0_s"].reshape(-1, 32)
    wm = f["mass_s"].reshape(-1, 32) > 0
    ratio = (torch.where(wm, wh, 0.0).amax(1)
             / torch.where(wm, wh, float("inf")).amin(1))
    return float(ratio[wm.any(1)].max())


def _clustered(dev, dtype, compact=False):
    """Half of the particles on a jittered 16^3 lattice, half drawn toward
    4 centres (sigma 0.02), h from the local density (a 32^3 histogram), as
    in ``chip_smoke.py`` phase 27 at an eighth of its size: h varies about
    5.5x inside one warp at a cluster's edge, and a cluster's warps keep
    more survivors than kernel A's pair walk stages at once, so a walk
    tests and walks several batches."""
    gen = torch.Generator(device=dev).manual_seed(11)
    n_lat = 16
    lat = torch.as_tensor(lattice.cubic_lattice((n_lat,) * 3, [0.0] * 3,
                                                [1.0] * 3),
                          dtype=torch.float32, device=dev)
    lat = (lat + (0.3 / n_lat) * (2.0 * torch.rand(
        lat.shape, generator=gen, device=dev) - 1.0)) % 1.0
    centres = torch.tensor([[0.3, 0.3, 0.35], [0.7, 0.35, 0.6],
                            [0.4, 0.7, 0.65], [0.65, 0.68, 0.3]], device=dev)
    blob = (centres[torch.randint(4, (lat.shape[0],), generator=gen,
                                  device=dev)]
            + 0.02 * torch.randn(lat.shape, generator=gen, device=dev))
    pos = torch.cat([lat, blob.clamp(0.05, 0.95)])
    n = pos.shape[0]
    bins = (pos * 32).long().clamp(0, 31)
    flat = (bins[:, 0] * 32 + bins[:, 1]) * 32 + bins[:, 2]
    count = torch.bincount(flat, minlength=32 ** 3)[flat].float()
    h_lat = 1.3 / n_lat
    h = (1.3 * (count * 32 ** 3) ** (-1.0 / 3.0)).clamp(h_lat / 12, h_lat)
    st = make_state(*(t.to(dtype) for t in (
        pos, torch.zeros_like(pos), torch.full((n,), 1.0 / n, device=dev),
        torch.ones(n, device=dev), h)))
    dom = box(torch.zeros(3, dtype=dtype, device=dev),
              torch.ones(3, dtype=dtype, device=dev))
    plan = win.plan_compact if compact else win.plan_measured
    spec = plan(st.pos, dom, h_max=h_lat * 1.05, dim=3, **KNOBS)
    wd = win.build(st.pos, dom, spec)
    assert int(wd.overflow) == 0
    return spec, wd, _fields_a(st, wd, seed=12)


def _sedov_core(dev, dtype):
    """The Sedov lattice (24^3, jittered by a seeded 0.2 of a spacing) with
    the particles within 0.25 of the centre pulled toward it by a factor
    0.17: their density rises about 200x and their h, set from it, falls
    about 5.9x, so the warps at the ball's edge hold rows whose h differ
    about 6x. Returns the structure, the sorted fields and the rows within
    0.1 of the centre, whose groups a rung mask keeps."""
    prob = problems.sedov(n=24, dtype=dtype, device=dev)
    st, dom = prob.state, prob.domain
    gen = torch.Generator(device=dev).manual_seed(21)
    pos = dom.wrap(st.pos + (0.2 / 24) * (2.0 * torch.rand(
        st.pos.shape, generator=gen, dtype=dtype, device=dev) - 1.0))
    r = pos - 0.5
    ball = r.norm(dim=-1) < 0.25
    pos = torch.where(ball[:, None], 0.5 + 0.17 * r, pos)
    st = st._replace(pos=pos, h=torch.where(ball, 0.17 * st.h, st.h))
    spec = win.plan_measured(pos, dom, h_max=float(st.h.max()) * 1.5, dim=3,
                             cutoff_scale=1.25, fast_sub=3, rgroups=2)
    wd = win.build(pos, dom, spec)
    assert int(wd.overflow) == 0
    f = _fields_a(st, wd, seed=22)
    return spec, wd, f, (f["pos_s"] - 0.5).norm(dim=-1) < 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [False, True])
def test_solve_h_density_clustered_matches_plain(cuda, dtype, compact):
    """Kernel A (2 Newton updates, Balsara) against plain where h varies
    about 5.5x inside one warp and a warp stages more survivors than its
    pair walk holds at once."""
    cfg = A_CASES["cold_newton2"]
    spec, wd, f = _clustered(cuda, dtype, compact)
    assert _warp_h_ratio(f) > 4.0
    _, surv = wk.cull_stats(wd, spec, f["pos_s"], f["mass_s"], f["h0_s"])
    assert surv > wk.pair_cap(dtype), surv
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
    want = wk.solve_h_density_plain(wd, spec, *args, cfg, vel_s=f["vel_s"])
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, wd.is_real, TOL[dtype], f"clustered A output {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_h_density_rung_masked_sedov_matches_plain(cuda, dtype):
    """Kernel A (Sedov: 6 Newton updates, grad-h, Balsara) on a rung mask
    of the Sedov lattice whose core was compressed, so that h varies about
    6x inside the warps at the core's edge: against plain on the real rows
    of the groups the mask keeps, h0 and zeros on the others."""
    spec, wd, f, close = _sedov_core(cuda, dtype)
    assert _warp_h_ratio(f) > 5.0
    wm = rungs.mask_structure(wd, spec, close)
    act = wk._group_active(wm, spec).repeat_interleave(spec.group)
    assert 0 < int(act.sum()) < act.numel()
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    got = wk.solve_h_density(wm, spec, *args, configs.SEDOV,
                             vel_s=f["vel_s"])
    want = wk.solve_h_density_plain(wm, spec, *args, configs.SEDOV,
                                    vel_s=f["vel_s"])
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, act & wd.is_real, TOL[dtype], f"sedov A output {k}")
    assert torch.equal(got[0][~act], f["h0_s"][~act])
    assert not any(bool(o[~act].any()) for o in got[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 2, 1])
@pytest.mark.parametrize("compact", [False, True])
def test_solve_h_density_is_one_launch_a_call(cuda, dim, compact):
    """The profiler sees one device kernel of A a call, named for the pair
    walk (``solve_h_density_pairs``), and never with ``forces_``."""
    cfg = {3: A_CASES["cold_newton2"], 2: configs.KH, 1: CFG_1D}[dim]
    _, _, spec, wd, f = _inputs(cuda, torch.float32, dim=dim,
                                compact=compact)
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "solve_h_density" in e.name]
    assert len(names) == 1, names
    assert "solve_h_density_pairs" in names[0], names
    assert "forces_" not in names[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [False, True])
def test_solve_h_density_is_bitwise_repeatable(cuda, dtype, compact):
    """Two launches of kernel A on one input give bitwise-equal outputs on
    every sorted row: each lane sums its own row's pairs in candidate
    order, with no atomics."""
    cfg = A_CASES["cold_newton2"]
    spec, wd, f = _clustered(cuda, dtype, compact)
    args = (f["pos_s"], f["mass_s"], f["h0_s"])
    a = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
    b = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
    torch.cuda.synchronize()
    for k, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"output {k}"


C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s", "om_s",
          "bf_s")


def _fields_c(f, seed):
    """``f`` (``_fields_a``'s) with kernel C's further inputs: h_s = h0_s,
    and seeded rho, P, cs, Omega and viscosity factor on the rows with
    mass, ``_inputs``' fills on the others."""
    m = f["mass_s"] > 0
    g = torch.Generator(device=m.device).manual_seed(seed)

    def rnd(lo, hi, fill):
        x = lo + (hi - lo) * torch.rand(m.shape, generator=g,
                                        dtype=f["h0_s"].dtype, device=m.device)
        return torch.where(m, x, fill)
    rho = rnd(0.8, 1.2, 1.0)
    return dict(f, h_s=f["h0_s"], rho_s=rho, P_s=rho * rnd(0.9, 1.1, 1.0),
                cs_s=rnd(0.8, 1.2, 1.0), om_s=rnd(0.9, 1.1, 1.0),
                bf_s=rnd(0.0, 1.0, 0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [False, True])
def test_forces_clustered_matches_plain(cuda, dtype, compact):
    """Kernel C against plain where h varies about 5.5x inside one warp, so
    that some pairs lie inside 2 h_j and outside 2 h_i (the j side of C's
    first test, which kernel A has not), and a warp stages more survivors
    than its pair walk holds at once."""
    cfg = A_CASES["cold_newton2"]
    spec, wd, f = _clustered(cuda, dtype, compact)
    f = _fields_c(f, seed=13)
    assert _warp_h_ratio(f) > 4.0
    cap = wk.force_cap(dtype)
    walk = dict(cap=cap, pair_h=True, step=wk.FORCE_STEP)
    c = wk.walk_stats(wd, spec, f["pos_s"], f["mass_s"], f["h_s"], **walk)
    a = wk.walk_stats(wd, spec, f["pos_s"], f["mass_s"], f["h_s"], cap)
    assert c["pairs"] > a["pairs"], (c, a)
    assert c["survivors"] > cap, c
    args = [f[k] for k in C_ARGS]
    got = wk.forces(wd, spec, *args, cfg)
    want = wk.forces_plain(wd, spec, *args, cfg)
    _compare(got[0], want[0], wd.is_real, TOL[dtype], "clustered acc")
    _compare(got[1], want[1], wd.is_real, TOL[dtype], "clustered du")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forces_rung_masked_sedov_matches_plain(cuda, dtype):
    """Kernel C (Sedov: grad-h, Balsara) on a rung mask of the Sedov
    lattice whose core was compressed, h about 6x apart inside the warps at
    the core's edge: against plain on the real rows of the groups the mask
    keeps, zeros on the others."""
    spec, wd, f, close = _sedov_core(cuda, dtype)
    f = _fields_c(f, seed=23)
    assert _warp_h_ratio(f) > 5.0
    wm = rungs.mask_structure(wd, spec, close)
    act = wk._group_active(wm, spec).repeat_interleave(spec.group)
    assert 0 < int(act.sum()) < act.numel()
    args = [f[k] for k in C_ARGS]
    got = wk.forces(wm, spec, *args, configs.SEDOV)
    want = wk.forces_plain(wm, spec, *args, configs.SEDOV)
    rows = act & wd.is_real
    _compare(got[0], want[0], rows, TOL[dtype], "sedov acc")
    _compare(got[1], want[1], rows, TOL[dtype], "sedov du")
    assert not bool(got[0][~act].any()) and not bool(got[1][~act].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [3, 2, 1])
@pytest.mark.parametrize("compact", [False, True])
def test_forces_is_one_launch_a_call(cuda, dim, compact):
    """The profiler sees one device kernel of C a call, named for the pair
    walk (``forces_pairs``), and never with ``solve_h_density``."""
    cfg = {3: A_CASES["cold_newton2"], 2: configs.KH, 1: CFG_1D}[dim]
    _, _, spec, wd, f = _inputs(cuda, torch.float32, dim=dim,
                                compact=compact)
    args = [f[k] for k in C_ARGS]
    wk.forces(wd, spec, *args, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wk.forces(wd, spec, *args, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "forces" in e.name]
    assert len(names) == 1, names
    assert "forces_pairs" in names[0], names
    assert "solve_h_density" not in names[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [False, True])
def test_forces_is_bitwise_repeatable(cuda, dtype, compact):
    """Two launches of kernel C on one input give bitwise-equal outputs on
    every sorted row: each lane sums its own row's pairs in candidate
    order, with no atomics."""
    cfg = A_CASES["cold_newton2"]
    spec, wd, f = _clustered(cuda, dtype, compact)
    args = [_fields_c(f, seed=13)[k] for k in C_ARGS]
    a = wk.forces(wd, spec, *args, cfg)
    b = wk.forces(wd, spec, *args, cfg)
    torch.cuda.synchronize()
    for k, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"output {k}"


@pytest.mark.gpu
def test_rungs_b1_matches_simulate_on_the_card(cuda):
    """Block timesteps with one rung against the global-dt loop from one
    state, fp32, 2 steps with a rebuild every step: dts at 1e-6, the state
    at rtol 5e-5 and atol 1e-6 (the two sum in other orders)."""
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    st, dom, spec, _, f = _inputs(cuda, torch.float32, n_side=28, seed=5)
    g = torch.Generator(device=cuda).manual_seed(5)
    st = st._replace(vel=0.3 * torch.randn(st.vel.shape, generator=g,
                                           device=cuda))
    st = wengine.update_derived(st, cfg, dom, spec)
    st_g, _, dts_g, ovf_g = wengine.simulate(st, cfg, dom, spec, 2,
                                             rebuild_every=1)
    n0 = dict(wk.LAUNCHES)
    st_r, dts_r, nact, ovf_r, viol, builds = rungs.simulate_rungs(
        st, cfg, dom, spec, nspans=2, n_rungs=1, rebuild_every=1)
    torch.cuda.synchronize()
    # the seeding pass of kernel A, then A and C once per tick
    assert {k: wk.LAUNCHES[k] - n0[k] for k in n0} == {
        k: {"solve_h_density": 3, "forces": 2}.get(k, 0) for k in n0}
    assert int(ovf_g) == 0 and int(ovf_r) == 0 and int(viol) == 0
    assert builds == 2 and bool((nact == st.n).all())
    torch.testing.assert_close(dts_r, dts_g, rtol=1e-6, atol=0.0)
    for k in ("pos", "vel", "u", "rho", "h"):
        torch.testing.assert_close(getattr(st_r, k), getattr(st_g, k),
                                   rtol=5e-5, atol=1e-6, msg=k)


def _cloud(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n)
    pos = torch.rand((n, 3), generator=g, dtype=dtype, device=dev)
    return pos, (torch.rand(n, generator=g, dtype=dtype, device=dev)
                 + 0.5) / n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096, 5000, 65537])
def test_gravity_kernel_matches_plain(cuda, dtype, n):
    """Kernel G, with N on both sides of the column tile (256) and of the
    split into slices (``gravity_plan``), and not a multiple of either."""
    pos, mass = _cloud(cuda, dtype, n)
    cfg = configs.SPHConfig(gravity=True, G=1.4, grav_eps=0.03)
    n0 = wk.LAUNCHES["gravity"]
    got = dg.gravity(pos, mass, cfg)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["gravity"] == n0 + 1
    want = dg.gravity_plain(pos, mass, cfg)
    every = torch.ones(n, dtype=torch.bool, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    _compare(got, want, every, tol, "acc")
    with pytest.raises(ValueError):
        dg.gravity(pos, mass, dataclasses.replace(cfg, grav_eps=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4096, 65537])
def test_gravity_kernel_is_bitwise_repeatable(cuda, dtype, n):
    """Two launches on one input give bitwise-equal outputs: the slices'
    partial sums are added in a fixed order, with no atomics. Also with the
    slices forced to 1 (no reduction pass) and to the most one-tile slices,
    which the launcher must take."""
    pos, mass = _cloud(cuda, dtype, n)
    cfg = configs.SPHConfig(gravity=True, G=1.4, grav_eps=0.03)
    a, b = dg.gravity(pos, mass, cfg), dg.gravity(pos, mass, cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = dg.gravity_plain(pos, mass, cfg)
    every = torch.ones(n, dtype=torch.bool, device=cuda)
    tiles = -(-n // dg.TILE)
    for slices, cols in ((1, tiles * dg.TILE), (tiles, dg.TILE)):
        plan = (dg.ROWS, dg.THREADS, slices, cols)
        got = dg._launch(pos, mass, cfg, plan)
        again = dg._launch(pos, mass, cfg, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, again), plan
        _compare(got, want, every,
                 1e-4 if dtype == torch.float32 else TOL[dtype],
                 f"acc {plan}")
    with pytest.raises(RuntimeError):   # a plan that leaves a slice empty
        dg._launch(pos, mass, cfg, (dg.ROWS, dg.THREADS, tiles + 1, dg.TILE))


@pytest.mark.gpu
def test_cuda_tensor_never_runs_the_plain_version(cuda, monkeypatch):
    """A derived pass on the card launches each kernel of its branch once,
    and each of the three row-packing kernels once, and calls no plain
    version: no gravity, P3M (kernel C in its gravity mode, and the mesh's
    two CIC kernels once each), direct gravity in an open box (kernel G),
    the 2D kh configuration (the dim=2 kernels) and the 1D line (the dim=1
    kernels); and all but the direct one with a compact spec (the compact
    walks)."""
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(wk, "solve_h_density_plain", refuse)
    monkeypatch.setattr(wk, "forces_plain", refuse)
    for name in ("gather_a_plain", "gather_c_plain", "scatter_out_plain"):
        monkeypatch.setattr(rowpack, name, refuse)
    monkeypatch.setattr(wengine, "gravity_short_pass", refuse)
    monkeypatch.setattr(dg, "gravity_plain", refuse)
    monkeypatch.setattr(pm, "_deposit_plain", refuse)
    monkeypatch.setattr(pm, "_interp_plain", refuse)
    direct = dataclasses.replace(P3M, grav_solver="direct")
    base = dataclasses.replace(configs.TURB, newton_iters=1)
    cases = [
        (base, True, False, ("solve_h_density", "forces")),
        (P3M, True, False, ("solve_h_density", "forces_grav")),
        (direct, False, False, ("solve_h_density", "forces", "gravity")),
        (configs.KH, True, False, ("solve_h_density_2d", "forces_2d")),
        (base, True, True, ("solve_h_density_compact", "forces_compact")),
        (P3M, True, True, ("solve_h_density_compact",
                           "forces_grav_compact")),
        (configs.KH, True, True, ("solve_h_density_compact_2d",
                                  "forces_compact_2d")),
        (CFG_1D, True, False, ("solve_h_density_1d", "forces_1d")),
        (CFG_1D, True, True, ("solve_h_density_compact_1d",
                              "forces_compact_1d")),
    ]
    for cfg, periodic, compact, kernels in cases:
        st, dom, spec, _, _ = _inputs(cuda, torch.float32, periodic=periodic,
                                      dim=cfg.dim, compact=compact)
        n0, r0 = dict(wk.LAUNCHES), dict(rowpack.LAUNCHES)
        c0 = dict(pm.LAUNCHES)
        out = wengine.update_derived(st, cfg, dom, spec)
        torch.cuda.synchronize()
        assert {k: wk.LAUNCHES[k] - n0[k] for k in n0} == {
            k: int(k in kernels) for k in n0}, (cfg, compact)
        assert {k: rowpack.LAUNCHES[k] - r0[k] for k in r0} == {
            k: 1 for k in r0}, (cfg, compact)
        mesh = int(cfg.gravity and cfg.grav_solver == "p3m")
        assert {k: pm.LAUNCHES[k] - c0[k] for k in c0} == {
            k: mesh for k in c0}, (cfg, compact)
        assert bool(torch.isfinite(out.acc).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rung_pass_packs_through_rowpack(cuda, dtype, monkeypatch):
    """One rung tick's pass (``rungs._derived_rungs``: the Sedov lattice,
    24^3, with a seeded velocity and a seeded drift after its cold pass, a
    seeded 30 % of it closing and a seeded stale viscosity factor) on the
    card launches each row-packing kernel once, and equals bit for bit the
    same pass with ``rowpack``'s plain versions patched in, on the card's
    tensors."""
    prob = problems.sedov(n=24, dtype=dtype, device=cuda)
    st, dom, cfg = prob.state, prob.domain, prob.cfg
    gen = torch.Generator(device=cuda).manual_seed(31)

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=cuda)
    st = st._replace(vel=0.1 * randn(st.vel.shape))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.5,
                             dim=3, cutoff_scale=1.25, fast_sub=3, rgroups=2)
    st = wengine.update_derived(st, cfg, dom, spec)
    st = st._replace(pos=dom.wrap(st.pos + 0.05 * st.h[:, None]
                                  * randn(st.pos.shape)))
    wd = win.build(st.pos, dom, spec)
    assert int(wd.overflow) == 0
    close = torch.rand(st.n, generator=gen, device=cuda) < 0.3
    bf_prev = torch.rand(st.n, generator=gen, dtype=dtype, device=cuda)
    n0 = dict(rowpack.LAUNCHES)
    got, bf_got = rungs._derived_rungs(st, bf_prev, wd, cfg, dom, spec,
                                       close)
    torch.cuda.synchronize()
    assert {k: rowpack.LAUNCHES[k] - n0[k] for k in n0} == {
        k: 1 for k in n0}
    for name in ("gather_a", "gather_c", "scatter_out"):
        monkeypatch.setattr(rowpack, name, getattr(rowpack, f"{name}_plain"))
    want, bf_want = rungs._derived_rungs(st, bf_prev, wd, cfg, dom, spec,
                                         close)
    for f in ("h", "rho", "P", "cs", "omega", "acc", "du_dt", "divv"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b), (f, int((a != b).sum()))
    assert torch.equal(bf_got, bf_want)
    assert torch.equal(got.acc[~close], st.acc[~close])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rung_limit_kernels_equal_plain(cuda, dtype):
    """The timestep limiter's kernels (``physics.rung_limit``) on the Sedov
    lattice, 24^3, with a seeded drift and seeded rungs and wanted rungs on
    8 rungs: the tick's pass at ticks with few closers, a half and all
    (the neighbours' lowest rungs, the wake targets, the lowered closers;
    rows wake at tick 3, where rungs above 3 sleep mid-step) and the sync
    point's pass, each ``torch.equal`` to its plain version on the card's
    tensors, one launch a call."""
    from sphax_torch.physics import rung_limit as rl

    prob = problems.sedov(n=24, dtype=dtype, device=cuda)
    st, dom, spec = prob.state, prob.domain, prob.wspec
    gen = torch.Generator(device=cuda).manual_seed(25)
    pos = dom.wrap(st.pos + 0.05 * st.h[:, None] * torch.randn(
        st.pos.shape, generator=gen, dtype=dtype, device=cuda))
    wd = win.build(pos, dom, spec)
    assert int(wd.overflow) == 0
    rung, r_des = (torch.randint(0, 8, (st.n,), generator=gen, device=cuda,
                                 dtype=torch.int32) for _ in range(2))
    for k in (0, 3, 63, 127):
        args = (wd, spec, pos, st.h, st.mass, rung, r_des, k, 2,
                rungs._alignment(k + 1, 8), 8)
        n0 = rl.LAUNCHES["rung_limit_tick"]
        got = rl.tick(*args)
        assert rl.LAUNCHES["rung_limit_tick"] == n0 + 1
        want = rl.tick_plain(*args)
        for name, a, b in zip(("m", "target", "limited"), got, want):
            assert torch.equal(a, b), (k, name, int((a != b).sum()))
        assert k != 3 or bool((got[1] < rung).any()), k
    n0 = rl.LAUNCHES["rung_limit_sync"]
    got = rl.sync(wd, spec, pos, st.h, st.mass, rung, 2, 8)
    assert rl.LAUNCHES["rung_limit_sync"] == n0 + 1
    want = rl.sync_plain(wd, spec, pos, st.h, st.mass, rung, 2, 8)
    assert torch.equal(got, want) and not torch.equal(got, rung)


@pytest.mark.gpu
def test_limited_span_launches_the_tick_kernel_once_a_tick(cuda,
                                                           monkeypatch):
    """One span of ``simulate_rungs(limiter=4)`` on 6 rungs on the card
    (Sedov, 24^3, fp32, the drift gate at 8): one ``rung_limit_tick``
    launch a tick, ``sync_passes`` launches of ``rung_limit_sync`` at the
    sync point, no plain version called, and no window overflow."""
    from sphax_torch.physics import rung_limit as rl

    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(rl, "tick_plain", refuse)
    monkeypatch.setattr(rl, "sync_plain", refuse)
    prob = problems.sedov(n=24, device=cuda)
    n0 = dict(rl.LAUNCHES)
    out = rungs.simulate_rungs(prob.state, prob.cfg, prob.domain, prob.wspec,
                               1, n_rungs=6, adaptive_rebuild=8, limiter=4)
    torch.cuda.synchronize()
    assert {k: rl.LAUNCHES[k] - n0[k] for k in n0} == {
        "rung_limit_tick": 32, "rung_limit_sync": rl.sync_passes(6, 2)}
    assert int(out[3]) == 0 and bool(torch.isfinite(out[0].u).all())


def _slab_state(dev, dtype, n_side, cfg):
    """Turbulence ICs with a seeded 0.3 N(0,1) velocity after one
    single-device derived pass, and their domain."""
    st, dom, spec, _, _ = _inputs(dev, dtype, n_side=n_side)
    g = torch.Generator(device=dev).manual_seed(7)
    st = st._replace(vel=0.3 * torch.randn(st.vel.shape, generator=g,
                                           dtype=dtype, device=dev))
    return wengine.update_derived(st, cfg, dom, spec), dom, spec


def _shard_parity(c, dtype, n_side):
    """Every rank: its shard of the 2-slab decomposition and one derived
    pass that records kernel A's and C's arguments; then each kernel
    against its plain version on the rank's own real rows, and finite on
    every row. Rank 0 returns the largest relative errors."""
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    st, dom, _ = _slab_state(c.device, dtype, n_side, cfg)
    spec = wslab.plan(dom, st.n, float(st.h.max()) * 1.1, c.world,
                      fast_sub=3, rgroups=2)
    cuts = wslab.equal_cuts(spec.ncell_ax, c.world)
    sh = wslab.distribute(st, dom, spec, cuts, c.rank)
    spec = wslab.refine_wseg(spec, wslab.max_run(c, sh, cuts, dom, spec)[0])
    calls, own = kernel_calls(c, sh, cuts, dom, cfg, spec)
    errs = {}
    for name, cuda_fn, plain in (("A", wk.solve_h_density,
                                  wk.solve_h_density_plain),
                                 ("C", wk.forces, wk.forces_plain)):
        a, k = calls[name]
        got, want = cuda_fn(*a, **k), plain(*a, **k)
        for i, (x, y) in enumerate(zip(got, want)):
            assert bool(torch.isfinite(x).all()), (name, i)
            _compare(x, y, own, TOL[dtype], f"shard {name} output {i}")
            x, y = x[own].double(), y[own].double()
            errs[f"{name}{i}"] = float((x - y).abs().max() / y.abs().max())
    return errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_shard_kernels_match_plain(cuda, dtype):
    """Kernels A and C on a slab shard's structure (local real rows
    active, slab ghosts imaged but inactive, padding in the trash band), 2
    ranks on the card: against the plain versions on the rank's own real
    rows, finite on every row."""
    errs = comm.launch(_shard_parity, 2, cuda, "gloo", timeout=120,
                       deadline=600, args=(dtype, 24))
    assert max(errs.values()) <= TOL[dtype]


@pytest.mark.gpu
def test_slab_lockstep_on_the_card(cuda):
    """3 distributed steps, then a 2-step chunk and a migration, on 2 ranks
    sharing the card (fp64), against the single-device CUDA engine at
    1e-8 (the dts at 1e-10)."""
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    st0, dom, spec1 = _slab_state(cuda, torch.float64, 24, cfg)
    ref, _, dts, ovf = wengine.simulate(st0, cfg, dom, spec1, 5,
                                        rebuild_every=1)
    assert int(ovf) == 0
    spec = wslab.plan(dom, st0.n, float(st0.h.max()) * 1.1, 2,
                      fast_sub=3, rgroups=2)
    cuts = wslab.equal_cuts(spec.ncell_ax, 2)
    shards = [convert.state_to_numpy(wslab.distribute(st0, dom, spec, cuts,
                                                      r)) for r in range(2)]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    recs = comm.launch(
        lockstep, 2, cuda, "gloo", timeout=120, deadline=600,
        args=(rows, (dom.lo.cpu().numpy(), dom.hi.cpu().numpy(),
                     dom.periodic), cfg, spec, cuts,
              [("step",)] * 3 + [("chunk", 2, 2, 0), ("migrate",)],
              None, True))
    got_dts = np.concatenate([r["dts"] for r in recs if "dts" in r])
    np.testing.assert_allclose(got_dts, dts.cpu().numpy(), rtol=1e-10)
    real = recs[-1]["rows"]["mass"] > 0
    got = {k: v[real] for k, v in recs[-1]["rows"].items()}
    pa = np.mod(got["pos"], 1.0)
    pb = np.mod(ref.pos.cpu().numpy(), 1.0)
    oi = np.lexsort((pa[:, 2], pa[:, 1], pa[:, 0]))
    oj = np.lexsort((pb[:, 2], pb[:, 1], pb[:, 0]))
    np.testing.assert_allclose(pa[oi], pb[oj], rtol=1e-8, atol=1e-8)
    for k in ("vel", "h", "rho", "acc", "du_dt"):
        b = getattr(ref, k).cpu().numpy()[oj]
        np.testing.assert_allclose(got[k][oi], b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)


def _pencil_parity(c, dtype, n_side, p3m):
    """Every rank: its pencil of the 2x2 decomposition and one derived pass
    that records kernel A's and C's arguments (with ``p3m``, C in its
    gravity mode); then each kernel against its plain version on the
    rank's own real rows, and finite on every row. Rank 0 returns the
    largest relative errors."""
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    if p3m:
        cfg = dataclasses.replace(cfg, gravity=True, grav_solver="p3m",
                                  grav_mesh=32)
    st, dom, _ = _slab_state(c.device, dtype, n_side, cfg)
    spec = pencil.plan(dom, st.n, float(st.h.max()) * 1.1, 2, 2,
                       fast_sub=3, rgroups=2)
    c.grid(2, 2)
    cuts = (pencil.equal_cuts(spec.ncell0, 2),
            pencil.equal_cuts(spec.ncell1, 2))
    sh = pencil.distribute(st, dom, spec, *cuts, c.rank)
    spec = pencil.refine_wseg(spec, pencil.max_run(c, sh, *cuts, dom,
                                                   spec)[0])
    calls, own = kernel_calls(c, sh, cuts, dom, cfg, spec)
    assert (calls["C"][1].get("grav") is not None) == p3m
    errs = {}
    for name, cuda_fn, plain in (("A", wk.solve_h_density,
                                  wk.solve_h_density_plain),
                                 ("C", wk.forces, wk.forces_plain)):
        a, k = calls[name]
        got, want = cuda_fn(*a, **k), plain(*a, **k)
        for i, (x, y) in enumerate(zip(got, want)):
            assert bool(torch.isfinite(x).all()), (name, i)
            _compare(x, y, own, TOL[dtype], f"pencil {name} output {i}")
            x, y = x[own].double(), y[own].double()
            errs[f"{name}{i}"] = float((x - y).abs().max() / y.abs().max())
    return errs


@pytest.mark.gpu
@pytest.mark.parametrize("p3m", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pencil_shard_kernels_match_plain(cuda, dtype, p3m):
    """Kernels A and C (with P3M, C's gravity mode) on a pencil shard's
    structure (local real rows active, x and y ghosts imaged but
    inactive, padding in the trash band below the x-slab), 4 ranks of a
    2x2 grid on the card: against the plain versions on the rank's own
    real rows, finite on every row."""
    errs = comm.launch(_pencil_parity, 4, cuda, "gloo", timeout=120,
                       deadline=600, args=(dtype, 24, p3m))
    assert max(errs.values()) <= TOL[dtype]


@pytest.mark.gpu
def test_pencil_lockstep_on_the_card(cuda):
    """2 steps, then a 2-step chunk, a rebalance and a migration, on a 2x2
    grid of ranks sharing the card (fp64), against the single-device CUDA
    engine at 1e-8 (the dts at 1e-10)."""
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    st0, dom, spec1 = _slab_state(cuda, torch.float64, 24, cfg)
    ref, _, dts, ovf = wengine.simulate(st0, cfg, dom, spec1, 4,
                                        rebuild_every=1)
    assert int(ovf) == 0
    spec = pencil.plan(dom, st0.n, float(st0.h.max()) * 1.1, 2, 2,
                       fast_sub=3, rgroups=2, pad_factor=2.0,
                       migrate_frac=1.0)
    cuts = (pencil.equal_cuts(spec.ncell0, 2),
            pencil.equal_cuts(spec.ncell1, 2))
    shards = [convert.state_to_numpy(pencil.distribute(st0, dom, spec, *cuts,
                                                       r)) for r in range(4)]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    recs = comm.launch(
        pencil_lockstep, 4, cuda, "gloo", timeout=120, deadline=600,
        args=(rows, (dom.lo.cpu().numpy(), dom.hi.cpu().numpy(),
                     dom.periodic), cfg, spec, cuts,
              [("step",)] * 2 + [("chunk", 2, 2), ("rebalance",),
                                 ("migrate",)], None, True))
    got_dts = np.concatenate([r["dts"] for r in recs if "dts" in r])
    np.testing.assert_allclose(got_dts, dts.cpu().numpy(), rtol=1e-10)
    real = recs[-1]["rows"]["mass"] > 0
    got = {k: v[real] for k, v in recs[-1]["rows"].items()}
    pa = np.mod(got["pos"], 1.0)
    pb = np.mod(ref.pos.cpu().numpy(), 1.0)
    oi = np.lexsort((pa[:, 2], pa[:, 1], pa[:, 0]))
    oj = np.lexsort((pb[:, 2], pb[:, 1], pb[:, 0]))
    np.testing.assert_allclose(pa[oi], pb[oj], rtol=1e-8, atol=1e-8)
    for k in ("vel", "h", "rho", "acc", "du_dt"):
        b = getattr(ref, k).cpu().numpy()[oj]
        np.testing.assert_allclose(got[k][oi], b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)


RUNG_CFG = dataclasses.replace(configs.SEDOV, newton_iters=2)


def _sedov_state(dev, dtype, centre):
    """The Sedov lattice at 16^3 with the blast at ``centre`` after one
    single-device derived pass (configs.SEDOV, newton_iters=2), its domain
    and plan."""
    from sphax_torch.ics import sedov

    ic = sedov.build(n_side=16, E=1.0, centre=centre)
    st = make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=dev)
                      for k in ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(3, dtype=dtype, device=dev),
              torch.ones(3, dtype=dtype, device=dev))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                             dim=3, cutoff_scale=1.05, fast_sub=3, rgroups=2)
    return wengine.update_derived(st, RUNG_CFG, dom, spec), dom, spec


def _rung_shard_parity(c, dtype):
    """Every rank: its shard of the off-centre blast, masked to the closers
    of a span's first tick (rung 0 at the span's start), and one rung
    derived pass that records kernel A's and C's arguments; each kernel
    against its plain version on the rank's own real rows. The pass runs
    on the real rows jittered by a seeded 0.2 of a spacing with a seeded
    0.4 N(0,1) velocity (on the resting lattice d rho/d h cancels and the
    Balsara sums vanish); the closers come from the unjittered derived
    state. The quiet rank (no closer) gets h0 and zeros from both. Rank 0
    returns every rank's closers."""
    from sphax_torch.integrate.rungs import _rung_of
    from sphax_torch.integrate.timestep import particle_dt

    st, dom, _ = _sedov_state(c.device, dtype, (0.15, 0.5, 0.5))
    spec = wslab.plan(dom, st.n, float(st.h.max()) * 1.1, c.world,
                      cutoff_scale=1.05, fast_sub=3, rgroups=2)
    cuts = wslab.equal_cuts(spec.ncell_ax, c.world)
    sh = wslab.distribute(st, dom, spec, cuts, c.rank)
    real = sh.mass > 0
    dt = torch.where(real, particle_dt(sh, RUNG_CFG), RUNG_CFG.dt_max)
    close_m = real & (_rung_of(dt, c.all_reduce_min(dt.amin()), 3) == 0)
    g = torch.Generator(device=c.device).manual_seed(3 + c.rank)
    jit = (0.2 / 16) * (2.0 * torch.rand(sh.pos.shape, generator=g,
                                         dtype=dtype, device=c.device) - 1.0)
    vel = 0.4 * torch.randn(sh.vel.shape, generator=g, dtype=dtype,
                            device=c.device)
    sh = sh._replace(pos=torch.where(real[:, None], sh.pos + jit, sh.pos),
                     vel=torch.where(real[:, None], vel, sh.vel))
    spec = wslab.refine_wseg(spec, wslab.max_run(c, sh, cuts, dom, spec)[0])
    calls, own = kernel_calls(c, sh, cuts, dom, RUNG_CFG, spec, close_m)
    for name, cuda_fn, plain in (("A", wk.solve_h_density,
                                  wk.solve_h_density_plain),
                                 ("C", wk.forces, wk.forces_plain)):
        a, k = calls[name]
        got, want = cuda_fn(*a, **k), plain(*a, **k)
        for i, (x, y) in enumerate(zip(got, want)):
            assert bool(torch.isfinite(x).all()), (name, i)
            _compare(x, y, own, TOL[dtype], f"rung shard {name} output {i}")
            if not bool(close_m.any()):
                want0 = a[4] if (name, i) == ("A", 0) else torch.zeros_like(x)
                assert torch.equal(x, want0) and torch.equal(y, want0)
    n = torch.zeros(c.world, dtype=torch.int64, device=c.device)
    n[c.rank] = close_m.sum()
    return c.all_reduce_sum(n).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rung_shard_kernels_match_plain(cuda, dtype):
    """Kernels A and C on a slab shard's structure masked again to a rung
    tick's closers (``dist.wrungs``), 2 ranks on the card, the blast in
    rank 0's slab: against plain on each rank's own real rows; rank 1
    has no closer and both give h0 and zeros."""
    closers = comm.launch(_rung_shard_parity, 2, cuda, "gloo", timeout=120,
                          deadline=600, args=(dtype,))
    assert closers[0] > 0 and closers[1] == 0, closers


@pytest.mark.gpu
def test_rung_lockstep_on_the_card(cuda):
    """A span of B = 3 on 2 ranks sharing the card (fp64), after a work
    rebalance of the off-centre blast and the migration, against the
    single-device rung integrator with the kernels: dts at 1e-12, closings
    per tick and dt violations equal, every field at 1e-8."""
    st0, dom, spec1 = _sedov_state(cuda, torch.float64, (0.15, 0.5, 0.5))
    ref, dts, nacts, ovf, viol, _ = rungs.simulate_rungs(
        st0, RUNG_CFG, dom, spec1, nspans=1, n_rungs=3, rebuild_every=2)
    assert int(ovf) == 0
    spec = wslab.plan(dom, st0.n, float(st0.h.max()) * 1.1, 2,
                      cutoff_scale=1.05, fast_sub=3, rgroups=2,
                      pad_factor=2.0, migrate_frac=1.0)
    cuts = wslab.equal_cuts(spec.ncell_ax, 2)
    shards = [convert.state_to_numpy(wslab.distribute(st0, dom, spec, cuts,
                                                      r)) for r in range(2)]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    rec = comm.launch(
        lockstep, 2, cuda, "gloo", timeout=120, deadline=600,
        args=(rows, (dom.lo.cpu().numpy(), dom.hi.cpu().numpy(),
                     dom.periodic), RUNG_CFG, spec, cuts,
              [("rebalance", 3), ("migrate",), ("refine",),
               ("rungs", 1, 3, 2, 0)], None, True))[-1]
    assert not np.any(rec["health"])
    np.testing.assert_allclose(rec["dts"], dts.cpu().numpy(), rtol=1e-12)
    np.testing.assert_array_equal(rec["nacts"], nacts.cpu().numpy())
    assert rec["dt_viol"] == int(viol)
    real = rec["rows"]["mass"] > 0
    got = {k: v[real] for k, v in rec["rows"].items()}
    pa = np.mod(got["pos"], 1.0)
    pb = np.mod(ref.pos.cpu().numpy(), 1.0)
    oi = np.lexsort((pa[:, 2], pa[:, 1], pa[:, 0]))
    oj = np.lexsort((pb[:, 2], pb[:, 1], pb[:, 0]))
    np.testing.assert_allclose(pa[oi], pb[oj], rtol=1e-8, atol=1e-8)
    for k in ("vel", "u", "h", "rho", "acc", "du_dt"):
        b = getattr(ref, k).cpu().numpy()[oj]
        np.testing.assert_allclose(got[k][oi], b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max(), err_msg=k)


@pytest.mark.gpu
def test_entry_step_matches_plain_on_the_card(cuda, monkeypatch):
    """``sphax_torch.entry.entry()`` (the twin of ``__graft_entry__.entry()``,
    fp32, 16^3) on the card: one launch of A and of C a call, no window
    overflow, and the step within 3e-5 of the same step through the plain
    versions, the row packing's included (``chip_smoke.py`` phase 39's
    check)."""
    from sphax_torch.entry import entry

    fn, (st,) = entry()
    assert st.pos.is_cuda and st.n == 16 ** 3
    n0 = {k: wk.LAUNCHES[k] for k in wk.LAUNCHES}
    got = fn(st)
    torch.cuda.synchronize()
    assert {k: wk.LAUNCHES[k] - n0[k] for k in n0 if wk.LAUNCHES[k] != n0[k]
            } == {"solve_h_density": 1, "forces": 1}
    assert int(wengine.overflow_count(got, fn.domain, fn.spec)) == 0
    monkeypatch.setattr(wk, "solve_h_density", wk.solve_h_density_plain)
    monkeypatch.setattr(wk, "forces", wk.forces_plain)
    for name in ("gather_a", "gather_c", "scatter_out"):
        monkeypatch.setattr(rowpack, name, getattr(rowpack, f"{name}_plain"))
    want = fn(st)
    every = torch.ones(st.n, dtype=torch.bool, device=cuda)
    for f in ("pos", "vel", "u", "h", "rho", "P", "cs", "omega", "divv",
              "acc", "du_dt"):
        _compare(getattr(got, f), getattr(want, f), every, 3e-5, f)


@pytest.mark.gpu
def test_sanitize_cases_launch_every_kernel(cuda):
    """The small launches that ``compute-sanitizer`` checks
    (``sphax_torch.sanitize``) run, one launch each, reach every launch key
    of the window kernels and kernel G, and give the same bits again over
    NaN-filled free memory."""
    from sphax_torch import _build, sanitize

    _build.load()
    names = sanitize.launch_all(cuda, poison=True)
    assert len(names) == len(set(names)) > len(wk.LAUNCHES)


# ---------------------------------------------------------------------------
# the cell-list engine, the equal-extent slabs and the sorted mesh
# ---------------------------------------------------------------------------


def _order(pos):
    p = np.mod(pos, 1.0)
    return np.lexsort((p[:, 2], p[:, 1], p[:, 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_clist_on_the_card_matches_the_window_engine(cuda, dtype):
    """clist.update_derived on the card (card blocks, and blocks of 7
    cells) against wengine.update_derived through kernels A and C on the
    same state: fp32 3e-5, fp64 1e-10; overflow and h saturation 0."""
    from sphax_torch.neighbors.cell_list import choose_grid
    from sphax_torch.physics import clist

    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    st, dom, spec = _slab_state(cuda, dtype, 20, cfg)
    grid = choose_grid(dom, float(st.h.max()) * 1.3, st.n)
    want = wengine.update_derived(st, cfg, dom, spec)
    every = torch.ones(st.n, dtype=torch.bool, device=cuda)
    for block in (0, 7):
        got = clist.update_derived(st, cfg, dom, grid, cell_block=block)
        for k in ("h", "rho", "P", "omega", "divv", "acc", "du_dt"):
            _compare(getattr(got, k), getattr(want, k), every, TOL[dtype],
                     f"clist {k}, cell_block {block}")
    assert int(clist.overflow_count(st, dom, grid)) == 0
    assert int(clist.h_saturation_count(got, dom, grid)) == 0


@pytest.mark.gpu
def test_eq_slab_on_the_card_matches_one_device(cuda):
    """dist.slab on 2 ranks sharing the card (fp64): 2 steps against the
    single-device cell list at 1e-10, health 0, no particle lost."""
    from sphax_torch.dist import slab
    from sphax_torch.integrate import leapfrog
    from sphax_torch.neighbors.cell_list import choose_grid
    from sphax_torch.physics import clist
    from tests._slab_helpers import eq_slab_lockstep

    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    st, dom, _ = _slab_state(cuda, torch.float64, 16, cfg)
    grid = choose_grid(dom, float(st.h.max()) * 1.3, st.n)

    def engine(s):
        return clist.update_derived(s, cfg, dom, grid)
    ref, dts = st, []
    for _ in range(2):
        ref, dt = leapfrog.step(ref, cfg, dom, engine, wrap=False)
        dts.append(float(dt))
    spec = slab.plan(dom, st.n, float(st.h.max()) * 1.1, 2)
    shards = [convert.state_to_numpy(slab.distribute(st, dom, spec, r))
              for r in range(2)]
    rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
    recs = comm.launch(
        eq_slab_lockstep, 2, cuda, "gloo", timeout=120, deadline=600,
        args=(rows, (dom.lo.cpu().numpy(), dom.hi.cpu().numpy(),
                     dom.periodic), cfg, spec, [("step",), ("step",)]))
    np.testing.assert_allclose(np.concatenate([r["dts"] for r in recs]),
                               dts, rtol=1e-10)
    assert not any(np.any(r["health"]) for r in recs)
    got = recs[-1]["real"]
    assert got["pos"].shape[0] == st.n
    oi, oj = _order(got["pos"]), _order(ref.pos.cpu().numpy())
    for k in ("pos", "vel", "u", "h", "rho", "acc", "du_dt"):
        b = getattr(ref, k).cpu().numpy()[oj]
        np.testing.assert_allclose(got[k][oi], b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max(), err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sorted_mesh_on_the_card(cuda, dtype):
    """pm.mesh_accel_sorted against pm.mesh_accel at M = 32 (fp32 3e-5,
    fp64 1e-10, with TF32 allowed by the process: the brick products
    switch it off), dropped 0; wengine.mesh_fallback_count counts the
    rows that fell back, as fallback_stats does."""
    st, dom, spec, wd, _ = _inputs(cuda, dtype)
    from sphax_torch.physics import pm_sorted

    plan = pm_sorted.plan_mesh(spec, 32)
    mass_s = win.gather_sorted(st.mass, wd)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, drop = pm.mesh_accel_sorted(wd.pos_s, mass_s, wd.is_real, P3M,
                                         dom, plan)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want = pm.mesh_accel(st.pos, st.mass, P3M, dom)
    assert int(drop) == 0
    every = torch.ones(st.n, dtype=torch.bool, device=cuda)
    _compare(got[wd.inv], want, every, TOL[dtype], "sorted mesh")
    stats = pm_sorted.fallback_stats(wd.pos_s, wd.is_real & (mass_s > 0),
                                     dom, 32, True, plan)
    n_fb, n_drop = wengine.mesh_fallback_count(st, P3M, dom, spec)
    assert (int(n_fb), int(n_drop)) == (int(stats[0]), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("compact", [False, True])
def test_candidate_counter_on_the_card(cuda, compact):
    """window.candidate_sums and count_candidates add a build's candidates
    to the record with no host synchronisation (the CUDA sync debug mode
    raises on one), and the record equals the count from the same tables
    on the CPU."""
    st, dom, spec, wd, _ = _inputs(cuda, torch.float32, dim=2,
                                   compact=compact)
    real = wd.is_real.reshape(spec.n_groups, spec.group)
    c_n = wd.c_n if compact else None
    torch.cuda.synchronize()
    saved = win.CANDIDATES["sums"]
    win.CANDIDATES["sums"] = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            win.count_candidates(win.candidate_sums(wd.w_lo, wd.w_nact, c_n,
                                                    real, spec))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        got, win.CANDIDATES["sums"] = win.CANDIDATES["sums"], saved
    want = win.candidate_sums(wd.w_lo.cpu(), wd.w_nact.cpu(),
                              None if c_n is None else c_n.cpu(),
                              real.cpu(), spec)
    assert got.is_cuda and got.cpu().tolist() == (2 * want).tolist()
    assert int(want[1]) == st.n


def _kh_box(device, n=128):
    from sphax_torch import problems

    p = problems.kh(n=n, smooth=1, device="cpu")
    st = p.state._replace(**{f: getattr(p.state, f).to(device)
                             for f in p.state._fields})
    dom = box(torch.zeros(2, device=device), torch.ones(2, device=device))
    _, spec = problems._window_engine(st, p.cfg, dom)
    return st, dom, spec, p.cfg


@pytest.mark.gpu
def test_graphed_build_equals_the_build(cuda):
    """window.GraphedBuild replays the wrap and the build bit for bit (the
    owner rows of pad rows aside, which are unspecified), on positions it
    did not capture and in a box it did not capture (its own copy of the
    corners), and counts its builds and candidates as build does."""
    st, dom, spec, _ = _kh_box(cuda)
    g = win.GraphedBuild(st.pos, dom, spec)
    assert g.pos is not st.pos
    shift = torch.tensor([0.3, -0.7], device=cuda)
    moved = box(dom.lo + 0.25, dom.hi + 0.25)
    for pos, d in ((st.pos, dom), (st.pos + shift, dom),
                   (st.pos - 2.0 * shift, dom), (st.pos + shift, moved)):
        win.CANDIDATES["sums"] = None
        want = win.build(d.wrap(pos), d, spec)
        n0 = win.BUILDS["n"]
        sums0 = win.CANDIDATES["sums"].clone()
        got = g(pos, d)
        assert win.BUILDS["n"] == n0 + 1
        assert torch.equal(g.pos, d.wrap(pos))
        assert torch.equal(win.CANDIDATES["sums"], 2 * sums0)
        for k, a in want._asdict().items():
            if k == "src":      # unspecified on the pad rows, by contract
                a, b = a[want.is_real], got.src[want.is_real]
            else:
                b = getattr(got, k)
            if a is not None:
                assert torch.equal(b, a), k


@pytest.mark.gpu
def test_simulate_with_the_graphed_build_equals_eager(cuda, monkeypatch):
    """wengine.simulate's fixed-cadence loop through the graphed build
    gives the eager loop's states and dts bit for bit, and its peak of
    allocated memory (the graph's capture included) is the eager loop's
    within 0.5 %."""
    st, dom, spec, cfg = _kh_box(cuda)
    st = wengine.update_derived(st, cfg, dom, spec)
    runs = {}
    for mode in ("eager", "graph", "graph again"):
        with monkeypatch.context() as m:
            if mode == "eager":
                m.setattr(wengine, "graphed_build", lambda *a: None)
            if mode != "graph again":
                wengine._GRAPHS.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sn, _, dts, ovf = wengine.simulate(st, cfg, dom, spec, 8)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            # the outputs leave the card, so that the next run's peak
            # holds only what that run keeps
            runs[mode] = (sn._replace(**{f: getattr(sn, f).cpu()
                                         for f in sn._fields}),
                          dts.cpu(), int(ovf), peak)
            del sn, dts, ovf
    se, de, oe, peak_e = runs["eager"]
    for mode in ("graph", "graph again"):
        sg, dg, og, peak_g = runs[mode]
        assert og == oe == 0
        assert torch.equal(dg, de)
        for f in st._fields:
            assert torch.equal(getattr(sg, f), getattr(se, f)), (mode, f)
        assert peak_g <= 1.005 * peak_e, (mode, peak_g, peak_e)


@pytest.mark.gpu
def test_graphed_loop_hands_steps_its_buffer(cuda, monkeypatch):
    """The graphed fixed-cadence loop keeps the positions between builds in
    the graph's buffer, one graph per spec and shape whatever the box
    object: a state it hands to a step before its last holds that buffer,
    which later steps overwrite; the last step's input state (what a
    recorder of a chunk's last step keeps) and the returned state keep
    their positions."""
    st, dom, spec, cfg = _kh_box(cuda)
    st = wengine.update_derived(st, cfg, dom, spec)
    seen, real_step = [], leapfrog.step

    def step(state, *a, **k):
        seen.append((state, state.pos.clone()))
        return real_step(state, *a, **k)
    monkeypatch.setattr(leapfrog, "step", step)
    wengine._GRAPHS.clear()
    for d in (dom, box(dom.lo.clone(), dom.hi.clone())):
        seen.clear()
        sn, _, _, ovf = wengine.simulate(st, cfg, d, spec, 4)
        assert int(ovf) == 0 and len(wengine._GRAPHS) == 1
        buf = next(iter(wengine._GRAPHS.values())).pos
        assert all(s.pos is buf for s, _ in seen[:-1])
        assert not torch.equal(seen[0][0].pos, seen[0][1])
        assert torch.equal(seen[-1][0].pos, seen[-1][1])
        assert sn.pos is not buf and st.pos is not buf


@pytest.mark.gpu
def test_cloud_runs_c_grav_and_the_mesh_once_a_step(cuda):
    """``cloud`` (n = 32, a 48^3 mesh) on the card: each step of the
    fixed-cadence loop launches kernel C once, in its gravity mode, and
    solves the mesh once through the two CIC kernels, and a derived pass
    in fp64 equals the plain P3M path on the CPU (1e-10 of the largest
    acceleration)."""
    p = problems.cloud(n=32, mesh=48, dtype=torch.float64, device=cuda,
                       seed=2**31 + 3)
    n0, s0 = dict(wk.LAUNCHES), pm.SOLVES["n"]
    c0 = dict(pm.LAUNCHES)
    _, _, dts, ovf = wengine.simulate(p.state, p.cfg, p.domain, p.wspec, 4)
    torch.cuda.synchronize()
    assert int(ovf) == 0 and len(dts) == 4
    grown = {k: wk.LAUNCHES[k] - n0[k] for k in n0}
    assert grown["forces_grav"] == 4 and grown["forces"] == 0
    assert grown["solve_h_density"] == 4
    assert pm.SOLVES["n"] == s0 + 4
    # each solve deposits and interpolates through the CIC kernels
    assert {k: pm.LAUNCHES[k] - c0[k] for k in c0} == {"cic_deposit": 4,
                                                       "cic_interp": 4}
    # the same state's pass on the CPU (the generators of the two devices
    # draw different fields, so the card's state is copied over)
    st = p.state._replace(**{f: getattr(p.state, f).cpu()
                             for f in p.state._fields})
    dom = box(torch.zeros(3, dtype=torch.float64),
              torch.ones(3, dtype=torch.float64))
    got = wengine.update_derived(p.state, p.cfg, p.domain, p.wspec)
    want = wengine.update_derived(st, p.cfg, dom, p.wspec)
    scale = float(want.acc.abs().max())
    torch.testing.assert_close(got.acc.cpu(), want.acc, rtol=1e-10,
                               atol=1e-10 * scale)
    torch.testing.assert_close(got.rho.cpu(), want.rho, rtol=1e-10, atol=0)


def _cic_case(dev, dtype, periodic, M=24, seed=11):
    """Positions for the CIC kernels on a box whose cells are not powers of
    two (so the divides round): 10,007 seeded uniform rows, 257 exactly on
    cell faces (lo + k cell, rounded), and rows at lo, just below hi and
    1e-7 of the box below lo (wrapped just below hi on a periodic box);
    10,267 in all, no multiple of the kernels' 256-thread block. Seeded
    masses and three seeded [M, M, M] grids."""
    dom = box(torch.tensor([-0.5, 0.25, 0.0], dtype=dtype, device=dev),
              torch.tensor([0.5, 1.25, 1.7], dtype=dtype, device=dev),
              periodic=periodic)
    lo, cell = dom.lo, dom.extent / M
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((10_007, 3), generator=g, dtype=torch.float64)
    faces = torch.randint(0, M, (257, 3), generator=g)
    pos = torch.cat([lo + u.to(dev, dtype) * dom.extent,
                     lo + faces.to(dev, dtype) * cell,
                     torch.stack([lo, torch.nextafter(dom.hi, dom.lo),
                                  lo - 1e-7 * dom.extent])])
    pos = dom.wrap(pos)
    n = pos.shape[0]
    mass = ((torch.rand(n, generator=g, dtype=torch.float64) + 0.5)
            / n).to(dev, dtype)
    grids = torch.randn((3, M, M, M), generator=g,
                        dtype=torch.float64).to(dev, dtype)
    return dom, pos, mass, lo, cell, M, grids


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cic_interp_is_the_plain_interp_bit_for_bit(cuda, dtype, periodic):
    """``pm._interp`` on the card (kernel ``cic_interp``, one launch a
    call) equals ``pm._interp_plain`` on the same card bit for bit, on 3
    stacked grids, on 1 and on a list of 3."""
    _, pos, _, lo, cell, M, grids = _cic_case(cuda, dtype, periodic)
    for gs in (grids, grids[:1], list(grids)):
        n0 = pm.LAUNCHES["cic_interp"]
        got = pm._interp(gs, pos, lo, cell, M, periodic)
        assert pm.LAUNCHES["cic_interp"] == n0 + 1
        want = pm._interp_plain(gs, pos, lo, cell, M, periodic)
        assert got.shape == (pos.shape[0], len(gs))
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cic_deposit_matches_the_plain_deposit(cuda, dtype, periodic):
    """``pm._deposit`` on the card (kernel ``cic_deposit``, one launch a
    call) against ``pm._deposit_plain`` on the same card: within 1e-12
    (fp64) or 1e-6 (fp32) of the largest cell, since both add in the order
    their atomics land; the total mass within the same share of it."""
    _, pos, mass, lo, cell, M, _ = _cic_case(cuda, dtype, periodic)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    n0 = pm.LAUNCHES["cic_deposit"]
    got = pm._deposit(pos, mass, lo, cell, M, periodic)
    assert pm.LAUNCHES["cic_deposit"] == n0 + 1
    want = pm._deposit_plain(pos, mass, lo, cell, M, periodic)
    assert got.shape == (M, M, M) and got.dtype == dtype
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    total = float(mass.double().sum())
    assert abs(float(got.double().sum()) - total) <= tol * total


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_accel_on_the_card_matches_the_cpu(cuda, dtype, periodic):
    """``pm.mesh_accel`` on the card (one deposit and one interpolation
    kernel a solve) against the plain path on the CPU: fp32 3e-5, fp64
    1e-10 of the largest acceleration (the FFTs and the deposit's sums
    differ in order)."""
    dom, pos, mass, _, _, M, _ = _cic_case(cuda, dtype, periodic)
    cfg = dataclasses.replace(P3M, grav_mesh=M)
    n0 = dict(pm.LAUNCHES)
    got = pm.mesh_accel(pos, mass, cfg, dom)
    assert {k: pm.LAUNCHES[k] - n0[k] for k in n0} == {"cic_deposit": 1,
                                                       "cic_interp": 1}
    cpu = box(dom.lo.cpu(), dom.hi.cpu(), periodic=periodic)
    want = pm.mesh_accel(pos.cpu(), mass.cpu(), cfg, cpu)
    every = torch.ones(pos.shape[0], dtype=torch.bool)
    _compare(got.cpu(), want, every, TOL[dtype], "mesh_accel")
