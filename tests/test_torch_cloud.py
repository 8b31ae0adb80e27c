"""The self-gravitating cloud (``cloud``, ``ics.cloud``): its ICs, the
window engine's P3M path against the benchmark's plain P3M reference
(``portbench/reference_p3m.py``), the reference's gravity against an Ewald
sum, the check's verdict on planted faults, the P3M potential energy of a
periodic record, and the mesh's span and counter.

Sizes: n = 16 particles a side with a 24^3 mesh (the configuration's 384^3
mesh at 256^3, scaled with n), float64 for the parity (1e-10 of what
bounds each field's rounding, as ``portbench/check.py`` scales it) and
float32 for the check's verdicts (the cell's own limits).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
from scipy.special import erfc

from portbench import check as K
from portbench import ics as ICS
from portbench import reference_p3m as R
from portbench import spec as bench_spec
from sphax_torch import make_state, problems
from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import box
from sphax_torch.diag import conservation
from sphax_torch.ics import cloud
from sphax_torch.integrate import leapfrog
from sphax_torch.io import metrics
from sphax_torch.physics import pm, wengine
from tests.test_torch_gates import ewald_accel

F64, F32 = torch.float64, torch.float32
CONFIG = bench_spec.load("configs", "cloud-kbb98-256")
LIMITS = bench_spec.load("workloads", "cloud256.p3m")["limits"]
N_SIDE, MESH = 16, 24
SEED = 2**31 + 77


def _setup(dtype, seed=SEED):
    """(the benchmark's ICs, the program's state on them, the problem)."""
    made = ICS.make(dict(CONFIG["ics"], n_side=N_SIDE), seed, dtype, "cpu")
    st = make_state(made["pos"], made["vel"], made["mass"], made["u"],
                    made["h"])
    p = problems.cloud(n=N_SIDE, mesh=MESH, dtype=dtype, device="cpu",
                       seed=seed)
    return made, st, p


def _sph():
    return dict(CONFIG["sph"], grav_mesh=MESH)


ABS_OF = {"divv": "div_abs", "acc": "acc_abs", "du_dt": "du_abs"}


def _close(got, want, fields, tol):
    for k in fields:
        a, b = got[k].double(), want[k].double()
        scale = float(want[ABS_OF.get(k, k)].abs().max())
        gap = float((a - b).abs().max())
        assert gap <= tol * scale, (k, gap / max(scale, 1e-300))


# ---- the ICs ----------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 32])
def test_program_ics_equal_the_benchmarks(n):
    """``ics.cloud.build`` and the benchmark's ``gauss_cloud`` give the same
    bits from generators seeded alike."""
    got = cloud.build(n, kmax=16, delta_rms=0.1,
                      gen=torch.Generator().manual_seed(n))
    ic = dict(CONFIG["ics"], n_side=n)
    want = ICS.builder(ic["kind"])(ic, torch.Generator().manual_seed(n), F64,
                                   "cpu")
    for k in ("pos", "vel", "mass", "u", "h"):
        assert torch.equal(got[k], want[k]), k
    assert got["G"] == CONFIG["sph"]["G"] == math.pi * 222 ** (2 / 3)


def test_problem_takes_its_ics_from_the_seed():
    p = problems.cloud(n=N_SIDE, mesh=MESH, dtype=F64, device="cpu", seed=9)
    ic = cloud.build(N_SIDE, seed=9)
    assert torch.equal(p.state.pos, ic["pos"])
    assert p.cfg.G == ic["G"] and p.cfg.grav_mesh == MESH
    assert p.cfg.grav_solver == "p3m" and p.cfg.gravity
    assert p.t_end == pytest.approx(math.sqrt(3 * math.pi / (32 * p.cfg.G)))
    # planned at the lattice h, as the configuration's window states
    assert p.wspec.cutoff == pytest.approx(2 * 1.25 * 1.3 * 1.3 / N_SIDE,
                                           rel=1e-12)


@pytest.mark.parametrize("n,kmax", [(32, 16), (64, 16), (64, 6)])
def test_field_spectrum_and_rms(n, kmax):
    """delta has the stated rms and zero mean, lives on 1 <= |k| <= kmax
    with no Nyquist component, has P(k) k^2 flat across the band (shell
    means, four seeds), and equals -div psi mode by mode."""
    power = {}
    for seed in range(4):
        delta, psi = cloud.gaussian_field(n, kmax, 0.1,
                                          torch.Generator().manual_seed(seed),
                                          "cpu")
        assert float(torch.sqrt(torch.mean(delta ** 2))) == pytest.approx(
            0.1, rel=1e-12)
        assert abs(float(delta.mean())) < 1e-15
        dk = torch.fft.rfftn(delta.reshape(n, n, n))
        kf = torch.fft.fftfreq(n, d=1.0 / n, dtype=F64)
        kr = torch.fft.rfftfreq(n, d=1.0 / n, dtype=F64)
        ks = (kf[:, None, None], kf[None, :, None], kr[None, None, :])
        k = torch.sqrt(ks[0] ** 2 + ks[1] ** 2 + ks[2] ** 2)
        nyq = (ks[0].abs() == n / 2) | (ks[1].abs() == n / 2) | (
            ks[2] == n / 2)
        outside = (k < 1) | (k > kmax) | nyq
        assert float(dk.abs()[outside].max()) < 1e-12 * float(dk.abs().max())
        div = sum(torch.fft.rfftn(psi[:, d].reshape(n, n, n))
                  * (2j * math.pi * ks[d]) for d in range(3))
        assert float((div + dk).abs().max()) < 1e-10 * float(dk.abs().max())
        shell = torch.round(k).long()
        for s in range(1, int(kmax) + 1):
            sel = (shell == s) & ~outside
            power[s] = power.get(s, 0.0) + float(
                (dk.abs()[sel] ** 2).mean()) * s * s
    lo = np.mean([power[s] for s in range(2, 4)])
    hi = np.mean([power[s] for s in range(int(kmax) // 2, int(kmax) + 1)])
    assert 0.75 < hi / lo < 1.33, (lo, hi)


def test_ics_lattice_displacement_and_h():
    n = 16
    ic = cloud.build(n, kmax=8, delta_rms=0.1, seed=3)
    delta, psi = cloud.gaussian_field(n, 8, 0.1,
                                      torch.Generator().manual_seed(3), "cpu")
    ax = (torch.arange(n, dtype=F64) + 0.5) / n
    q = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    d = ic["pos"] - q.reshape(-1, 3) - psi
    assert float((d - torch.round(d)).abs().max()) < 1e-15
    assert float(ic["pos"].min()) >= 0 and float(ic["pos"].max()) < 1
    m = 1.0 / n ** 3
    torch.testing.assert_close(ic["h"], 1.3 * (m / (1 + delta)) ** (1 / 3),
                               rtol=1e-15, atol=0)
    assert float(ic["vel"].abs().max()) == 0.0
    assert float(ic["mass"].sum()) == pytest.approx(1.0, rel=1e-14)


# ---- the program against the plain P3M reference ----------------------------


def test_window_engine_matches_the_p3m_reference():
    """The set-up's derived pass on seeded cloud ICs, then one KDK step,
    against ``reference_p3m`` in float64: 1e-10 of each field's scale."""
    made, st, p = _setup(F64)
    sph, hcap, rows = _sph(), 0.5 * p.wspec.cutoff, torch.arange(st.n)
    s0 = p.engine(st)
    ref = R.derived_start(R.Arith(), made, rows, sph, hcap, 1.0)
    _close(s0._asdict(), ref, ("h", "rho", "omega", "acc"), 1e-10)
    # gravity is a few per cent of the scale: the test sees it
    grav = float((ref["acc"].norm(dim=-1) / ref["acc_abs"]).max())
    assert grav > 0.01
    want, dt = leapfrog.step(s0, p.cfg, p.domain, p.engine)
    ref = R.kdk_step(R.Arith(), s0._asdict(), rows, sph, hcap, 1.0)
    assert float(ref["dt"]) == pytest.approx(float(dt), rel=1e-12)
    _close(want._asdict(), ref, ("vel", "u", "h", "rho", "divv", "acc",
                                 "du_dt"), 1e-10)
    d = want.pos - ref["pos"]
    assert float((d - torch.round(d)).abs().max()) <= 1e-12


def test_reference_refuses_driving_and_rungs():
    for fn in (R.rung_tick, R.drive_modes, R.ou_update):
        with pytest.raises(NotImplementedError):
            fn()


def test_reference_gravity_matches_an_ewald_sum():
    """The reference's mesh and short range together against a brute-force
    Ewald sum at 512 clustered particles (M = 64, r_s = 2 mesh cells, every
    pair inside a cutoff of L / 2). The tolerance is P3M's own error at
    this mesh: the CIC mesh's aliasing and the W^2 deconvolution's clamp
    leave about 1e-3 of the force, which the JAX package's gate for the
    same method and cloud (``tests/test_torch_gates.py``) bounds by an rms
    of 3e-3 and a 99th percentile of 9e-3."""
    cfg = SPHConfig(dim=3, gravity=True, G=1.0, grav_eps=0.004,
                    grav_solver="p3m", grav_mesh=64, grav_rs_cells=2.0)
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.random((256, 3)), np.mod(
        0.3 + 0.12 * rng.standard_normal((256, 3)), 1.0)])
    mass = rng.random(512) + 0.5
    want = ewald_accel(pos, mass, cfg)
    sph = dict(G=1.0, grav_eps=0.004, grav_mesh=64, grav_rs_cells=2.0)
    x, m = torch.as_tensor(pos), torch.as_tensor(mass)
    rows = torch.arange(512)
    rs = R.split_scale(sph, 0.5, 1.0)
    assert rs == 2.0 / 64
    ar = R.Arith()
    got = (R.short_accel(ar, x, m, rows, sph, rs, 0.5, 1.0)[0]
           + R.mesh_accel(ar, x, m, rows, sph, rs, 1.0)[0]).numpy()
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.sqrt(np.mean(rel ** 2)) < 3e-3, np.sqrt(np.mean(rel ** 2))
    assert np.percentile(rel, 99) < 9e-3, np.percentile(rel, 99)


# ---- the check's verdict on planted faults ----------------------------------


@functools.lru_cache(maxsize=1)
def _f32_case():
    """The float32 set-up and the reference's derived pass on its ICs."""
    made, st, p = _setup(F32)
    ref = R.derived_start(R.Arith(), made, torch.arange(st.n), _sph(),
                          0.5 * p.wspec.cutoff, 1.0)
    return st, p, ref


def _start_reading(p, st, ref, cfg, patch=()):
    """The check's ``start_err`` of the program's derived pass under
    ``cfg`` and the module attributes ``patch`` replaces."""
    rows = torch.arange(st.n)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, fn in patch:
            mp.setattr(mod, name, fn)
        s0 = wengine.update_derived(st, cfg, p.domain, p.wspec)
    return K.worst(K.derived_gaps(K.start_values(s0, rows), ref))


def _cut_at_2h(p):
    short = wengine.gravity_short_pass
    h0 = 1.3 / N_SIDE

    def planted(wd, spec, *args):
        return short(wd, dataclasses.replace(spec, cutoff=2.0 * h0), *args)
    return [(wengine, "gravity_short_pass", planted)]


FAULTS = {
    "sound": lambda p: (p.cfg, []),
    "mesh_dropped": lambda p: (p.cfg, [(pm, "mesh_accel", lambda pos, *a,
                                        **k: torch.zeros_like(pos))]),
    "G_1pc": lambda p: (dataclasses.replace(p.cfg, G=1.01 * p.cfg.G), []),
    "rs_10pc": lambda p: (dataclasses.replace(
        p.cfg, grav_rs_cells=1.1 * p.cfg.grav_rs_cells), []),
    "short_cut_at_2h": lambda p: (p.cfg, _cut_at_2h(p)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_check_refuses_planted_faults(fault):
    """At float32, the program reads under the cell's ``start_err`` limit,
    and each planted fault reads over it: the mesh dropped, G 1 % off, r_s
    10 % off (unclamped at this size), the short range cut at 2 h."""
    st, p, ref = _f32_case()
    cfg, patch = FAULTS[fault](p)
    got = _start_reading(p, st, ref, cfg, patch)
    if fault == "sound":
        assert got <= LIMITS["start_err"] / 10, got
    else:
        assert got > 3 * LIMITS["start_err"], got


# ---- the P3M potential energy -----------------------------------------------


def ewald_energy(pos, mass, G, rs, eps, L=1.0, kmax=21):
    """The periodic potential energy by brute force, Ewald-split at rs with
    the neutralising background (the potential of zero mean): the
    erfc-screened, Plummer-softened pair potential over the 27 nearest
    images, the Gaussian-screened k-space sum to |k_i| <= kmax with k = 0
    dropped, minus each particle's own Gaussian, plus the background's
    short range."""
    e = 0.0
    for off in np.array(np.meshgrid(*[[-1, 0, 1]] * 3)).reshape(3, -1).T:
        dx = pos[:, None, :] - pos[None, :, :] + off * L
        r = np.sqrt(np.einsum("ijk,ijk->ij", dx, dx))
        t = erfc(r / (2 * rs)) / np.sqrt(r * r + eps * eps)
        if not off.any():
            np.fill_diagonal(t, 0.0)
        e -= 0.5 * G * np.einsum("i,ij,j->", mass, t, mass)
    k1 = np.arange(-kmax, kmax + 1)
    ks = np.array(np.meshgrid(k1, k1, k1)).reshape(3, -1).T
    ks = ks[np.any(ks != 0, axis=1)] * (2 * np.pi / L)
    k2 = np.einsum("kd,kd->k", ks, ks)
    phase = pos @ ks.T
    s2 = (np.cos(phase).T @ mass) ** 2 + (np.sin(phase).T @ mass) ** 2
    e -= 0.5 * G * 4 * np.pi / L ** 3 * np.sum(np.exp(-k2 * rs * rs) / k2
                                                * s2)
    e += G * np.sum(mass ** 2) / (2 * rs * np.sqrt(np.pi))
    e += 0.5 * G * 4 * np.pi * rs * rs * mass.sum() ** 2 / L ** 3
    return e


@pytest.mark.parametrize("cutoff", [None, 0.2])
def test_p3m_energy_matches_an_ewald_sum(cutoff):
    """``pm.p3m_energy`` (the record of a periodic P3M run) against the
    Ewald energy of 400 clustered particles at M = 64, r_s = 2 mesh cells:
    within 2e-3 of the energy's scale, the sum of |m_i phi_i| / 2. That is
    P3M's own error (the mesh's potential carries the ~1e-3 error of its
    force; the cutoff at 0.2 = 6.4 r_s leaves an erfc tail below 1e-5)."""
    rng = np.random.default_rng(11)
    pos = np.concatenate([rng.random((200, 3)), np.mod(
        0.6 + 0.1 * rng.standard_normal((200, 3)), 1.0)])
    mass = (rng.random(400) + 0.5) / 400
    cfg = SPHConfig(dim=3, gravity=True, G=2.0, grav_eps=0.003,
                    grav_solver="p3m", grav_mesh=64, grav_rs_cells=2.0)
    dom = box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64))
    x, m = torch.as_tensor(pos), torch.as_tensor(mass)
    got = float(pm.p3m_energy(x, m, cfg, dom, cutoff=cutoff))
    rs = 2.0 / 64
    want = ewald_energy(pos, mass, 2.0, rs, 0.003)
    phi = pm.short_potential(x, m, cfg, dom, torch.tensor(rs, dtype=F64),
                             cutoff=cutoff)
    scale = 0.5 * float(torch.sum(m * phi.abs()))
    assert abs(got - want) < 2e-3 * scale, (got, want, scale)


@pytest.mark.parametrize("n,cutoff,chunks", [
    (4096, 0.264, (1 << 24, 3000)),
    (300, 0.3, (7, 1)),            # a row's candidates outgrow the chunk
    (300, None, (1 << 24, 1000))])  # no cutoff: every pair, rows blocked
def test_short_potential_cell_walk_equals_every_pair(n, cutoff, chunks):
    """The cell walk, in chunks down to single rows, equals the sum over
    every pair of the minimum images inside the cutoff."""
    g = torch.Generator().manual_seed(n)
    pos = torch.rand((n, 3), generator=g, dtype=F64) * 2.0 - 0.5
    mass = torch.rand(n, generator=g, dtype=F64) / n
    cfg = SPHConfig(gravity=True, G=3.0, grav_eps=0.01, grav_solver="p3m",
                    grav_mesh=24, grav_rs_cells=1.25)
    dom = box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64))
    rs = torch.tensor(0.05, dtype=F64)
    x = dom.wrap(pos)
    r = dom.displacement(x[:, None] - x[None]).norm(dim=-1)
    t = mass[None] * torch.special.erfc(r / (2 * rs)) / torch.sqrt(
        r * r + cfg.grav_eps ** 2)
    keep = (r > 0) if cutoff is None else (r > 0) & (r <= cutoff)
    want = -cfg.G * torch.where(keep, t, 0.0).sum(1)
    for chunk in chunks:
        got = pm.short_potential(pos, mass, cfg, dom, rs, cutoff=cutoff,
                                 chunk=chunk)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_record_takes_the_p3m_energy_only_for_periodic_p3m():
    """A periodic P3M state's record, given its domain, takes
    ``pm.p3m_energy``; without the domain, and for the direct solver or an
    open box, the record keeps the direct sum, bit for bit."""
    _, st, p = _setup(F64)
    cut = p.wspec.cutoff
    old = conservation.gravitational_energy(st, p.cfg)
    rec = conservation.summary(st, p.cfg, 0.5)
    assert rec["e_grav"] == float(old)
    rec = conservation.summary(st, p.cfg, 0.5, p.domain, cut)
    assert rec["e_grav"] == float(pm.p3m_energy(st.pos, st.mass, p.cfg,
                                                p.domain, cut))
    assert rec["e_grav"] != float(old)
    direct = dataclasses.replace(p.cfg, grav_solver="direct")
    assert float(conservation.gravitational_energy(
        st, direct, domain=p.domain, cutoff=cut)) == float(
            conservation.gravitational_energy(st, direct))
    open_box = box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64),
                   periodic=False)
    assert float(conservation.gravitational_energy(
        st, p.cfg, domain=open_box)) == float(old)


def test_cli_records_the_p3m_energy(tmp_path, capsys):
    """``python -m sphax_torch cloud`` on the CPU: two steps, a record with
    h_capped, mesh_fb and the P3M potential of the final state."""
    import json

    from sphax_torch import __main__ as cli
    out = tmp_path / "run"
    st, t, step = cli.main(["cloud", f"n={N_SIDE}", f"mesh={MESH}",
                            "device=cpu", "max_steps=2", "chunk=2",
                            f"out={out}", "checkpoint_every=0"])
    recs = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert step == 2 and "h_capped" in recs[0] and "mesh_fb" in recs[0]
    assert recs[0]["h_capped"] == 0
    p = problems.cloud(n=N_SIDE, mesh=MESH, device="cpu")
    want = pm.p3m_energy(st.pos, st.mass, p.cfg, p.domain, p.wspec.cutoff)
    assert recs[-1]["e_grav"] == pytest.approx(float(want), rel=1e-6)


# ---- the mesh's span and counter --------------------------------------------


def test_a_p3m_pass_solves_the_mesh_once_inside_its_span():
    _, st, p = _setup(F64)
    n0 = pm.SOLVES["n"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        p.engine(st)
    assert pm.SOLVES["n"] == n0 + 1
    names = [e.name for e in prof.events()]
    assert names.count(metrics.MESH_SPAN) == 1
    assert names.count("sphax_torch.derived") == 1
    assert metrics.MESH_SPAN not in metrics.SPANS
    # no span and no solve on a pass without gravity
    cfg = dataclasses.replace(p.cfg, gravity=False)
    wengine.update_derived(st, cfg, p.domain, p.wspec)
    assert pm.SOLVES["n"] == n0 + 1
