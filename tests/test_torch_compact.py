"""The compact-candidate mode (``spec.cwidth > 0``) against ``sphax``.

The compaction's integer tables equal the JAX build's exactly, the runs the
CUDA kernels walk concatenate to the reference's ``c_idx``, the overflow
counter and the exactness gate of tests/parity/test_compact.py hold, the
plain versions of kernels A and C in compact mode match the Pallas kernels
in compact mode (interpret mode, float64, 1e-10), and a compact derived pass
equals the in-place one. The CUDA compact walks are held against the plain
versions in tests/test_torch_gpu.py.

Rows that are not real particles are don't-care by contract, so the kernel
comparisons are on ``is_real`` rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.neighbors import window as jwin
from sphax.physics import pallas_kernels as pk
from sphax.physics import pm as jpm
from sphax_torch import configs as tconf
from sphax_torch import convert, make_state
from sphax_torch.neighbors import window as twin
from sphax_torch.physics import pm as tpm
from sphax_torch.physics import wengine as teng
from sphax_torch.physics import window_kernels as wk
from tests.parity.test_dense_vs_reference import make_problem

torch.set_num_threads(1)

RTOL = 1e-10
_jbuild = jax.jit(jwin.build, static_argnums=2)
# tests/parity/test_window_vs_dense.py's dim2 configuration (2 Newton
# updates, as that file runs it)
DIM2 = tconf.SPHConfig(dim=2, adaptive_h=True, grad_h=True, balsara=True,
                       newton_iters=2)
A_CASES = {
    "cold_newton2": (3, 1, dataclasses.replace(tconf.TURB, newton_iters=2)),
    "h_predict": (3, 2, dataclasses.replace(tconf.TURB, newton_iters=1,
                                            h_predict=True)),
    "dim2": (2, 1, DIM2),
}
C_CASES = {
    "exact_bf": (3, 2, tconf.TURB, False),
    "grav": (3, 1, dataclasses.replace(tconf.TURB, gravity=True,
                                       grav_solver="p3m", G=1.3,
                                       grav_eps=0.01, grav_mesh=16), True),
    "dim2": (2, 1, DIM2, False),
}
A_ARGS = ("pos_s", "mass_s", "h0_s")
C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s", "om_s",
          "bf_s")


def _jcfg(cfg):
    return sphax.SPHConfig(**dataclasses.asdict(cfg))


def _domains(dim):
    jd = sphax.box(jnp.zeros(dim), jnp.ones(dim))
    td = convert.domain_from_numpy(np.zeros(dim), np.ones(dim), True, "cpu",
                                   torch.float64)
    return jd, td


def _geometry(dim, rgroups, seed=3):
    """tests/parity/test_compact.py's geometry: make_problem at n_side 8
    (3D) or 12 (2D), plan_compact with h_max 1.25 x and fast_sub=2; both
    builds on the same positions."""
    pos, vel, mass, u, h = make_problem(dim=dim, n_side=8 if dim == 3 else 12,
                                        seed=seed)
    jd, td = _domains(dim)
    kw = dict(h_max=float(h.max()) * 1.25, dim=dim, fast_sub=2,
              rgroups=rgroups)
    spec = jwin.plan_compact(jnp.asarray(pos), jd, **kw)
    tspec = twin.plan_compact(torch.as_tensor(pos), td, **kw)
    jw = _jbuild(jnp.asarray(pos), jd, spec)
    tw = twin.build(torch.as_tensor(pos), td, tspec)
    return (pos, vel, mass, u, h), spec, tspec, jw, tw


def _problem(dim, rgroups, seed=3):
    """Sorted kernel inputs made with numpy from a seed, owner-consistent on
    ghost rows (tests/test_torch_kernels.py's recipe)."""
    (pos, vel, mass, u, h), spec, tspec, jw, tw = _geometry(dim, rgroups,
                                                            seed)
    n = len(pos)
    rng = np.random.default_rng(seed)
    g = np.minimum(np.asarray(jw.g), n)

    def srt(a, fill):
        return np.concatenate([a, np.full((1,) + a.shape[1:], fill)])[g]

    rho = rng.uniform(0.8, 1.2, n)
    P, cs = rho * rng.uniform(0.9, 1.1, n), rng.uniform(0.8, 1.2, n)
    f = dict(pos_s=np.array(jw.pos_s), vel_s=srt(vel, 0.0),
             mass_s=srt(mass, 0.0), u_s=srt(u, 0.0), h0_s=srt(h, 1.0),
             h_s=srt(h * rng.uniform(0.95, 1.05, n), 1.0),
             rho_s=srt(rho, 1.0), P_s=srt(P, 1.0), cs_s=srt(cs, 1.0),
             om_s=srt(rng.uniform(0.9, 1.1, n), 1.0),
             bf_s=srt(rng.uniform(0.0, 1.0, n), 0.0))
    return spec, tspec, jw, tw, f, np.asarray(jw.is_real)


def _compare(got, want, real, what):
    got, want = np.asarray(got)[real], np.asarray(want)[real]
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("dim,rgroups", [(3, 1), (3, 2), (2, 1)])
def test_compaction_equals_reference(dim, rgroups):
    """plan_compact returns the reference's spec; c_n, c_max, overflow and
    compact_index equal the reference's c_n, c_max, overflow and c_idx; the
    runs (c_lo, c_len) concatenate to c_idx[:c_n]; gather_cands equals the
    reference's buffer."""
    (pos, *_), spec, tspec, jw, tw = _geometry(dim, rgroups)
    assert spec.cwidth > 0
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    for f in ("c_n", "c_max", "overflow", "w_lo", "w_nact"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)
    assert int(tw.overflow) == 0
    for f in ("c_lo", "c_len"):
        t = getattr(tw, f)
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert tuple(t.shape) == (tspec.n_groups, tspec.n_seg)
    c_idx = np.asarray(jw.c_idx)
    np.testing.assert_array_equal(twin.compact_index(tw, tspec).numpy(),
                                  c_idx)
    c_lo, c_len, c_n = (getattr(tw, f).numpy() for f in ("c_lo", "c_len",
                                                         "c_n"))
    for g in range(tspec.n_groups):
        runs = [np.arange(a, a + n) for a, n in zip(c_lo[g], c_len[g])]
        np.testing.assert_array_equal(np.concatenate(runs), c_idx[g, :c_n[g]])
    cols = np.random.default_rng(0).normal(size=(tspec.n_sorted, 4))
    np.testing.assert_array_equal(
        twin.gather_cands(torch.as_tensor(cols), tw, tspec, 2).numpy(),
        np.asarray(jwin.gather_cands(jnp.asarray(cols), jw, 2)))


def test_compact_overflow_counted():
    """A cwidth below the true requirement is counted, not silent, and the
    truncated table still equals the reference's."""
    (pos, *_), spec, tspec, jw, tw = _geometry(3, 1)
    assert int(tw.c_max) > 128, "probe problem too small to pin overflow"
    small = dataclasses.replace(tspec, cwidth=128)
    _, td = _domains(3)
    tw2 = twin.build(torch.as_tensor(pos), td, small)
    jw2 = _jbuild(jnp.asarray(pos), _domains(3)[0],
                  dataclasses.replace(spec, cwidth=128))
    assert int(tw2.overflow) == int(jw2.overflow) > 0
    np.testing.assert_array_equal(twin.compact_index(tw2, small).numpy(),
                                  np.asarray(jw2.c_idx))


def test_compact_lists_exact():
    """Each group's compacted list holds every sorted row within the cutoff
    of each of its real rows, with no duplicates (the exactness gate of
    tests/parity/test_compact.py, on every group)."""
    (pos, *_), spec, tspec, jw, tw = _geometry(3, 2)
    pos_s, real = tw.pos_s.numpy(), tw.is_real.numpy()
    c_idx = twin.compact_index(tw, tspec).numpy()
    c_n = tw.c_n.numpy()
    Tg = tspec.group
    for g in range(tspec.n_groups):
        lst = c_idx[g, :c_n[g]]
        assert len(np.unique(lst)) == len(lst)
        rows = np.arange(g * Tg, (g + 1) * Tg)
        rows = rows[real[rows]]
        if len(rows) == 0:
            assert c_n[g] == 0
            continue
        d = np.linalg.norm(pos_s[rows][:, None, :] - pos_s[None, :, :],
                           axis=-1)
        need = np.unique(np.nonzero((d <= tspec.cutoff) & real[None, :])[1])
        assert np.setdiff1d(need, lst).size == 0, g


@pytest.mark.parametrize("case", sorted(A_CASES))
def test_solve_h_density_plain_compact_matches_pallas(case):
    dim, rgroups, cfg = A_CASES[case]
    spec, tspec, jw, tw, f, real = _problem(dim, rgroups)
    vel = f["vel_s"] if cfg.need_divv else None
    want = pk.solve_h_density(jw, spec, *(jnp.asarray(f[k]) for k in A_ARGS),
                              _jcfg(cfg), vel_s=None if vel is None
                              else jnp.asarray(vel),
                              u_s=jnp.asarray(f["u_s"]))
    got = wk.solve_h_density(tw, tspec, *(torch.as_tensor(f[k])
                                          for k in A_ARGS), cfg,
                             vel_s=None if vel is None
                             else torch.as_tensor(vel))
    assert len(got) == len(want) == (5 if cfg.need_divv else 3)
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, real, f"{case} output {k}")


@pytest.mark.parametrize("case", sorted(C_CASES))
def test_forces_plain_compact_matches_pallas(case):
    """Kernel C in compact mode; with gravity the compacted lists must hold
    every pair out to the cutoff, past 2h, for the screened short range."""
    dim, rgroups, cfg, grav = C_CASES[case]
    spec, tspec, jw, tw, f, real = _problem(dim, rgroups, seed=4)
    jgrav = tgrav = None
    if grav:
        jd, td = _domains(dim)
        jrs = jpm.rs_traced(_jcfg(cfg), jd, jnp.float64, cutoff=spec.cutoff)
        trs = tpm.rs_traced(cfg, td, torch.float64, cutoff=tspec.cutoff)
        jgrav, tgrav = (jrs, cfg.grav_eps), (trs, cfg.grav_eps)
    want = pk.forces(jw, spec, *(jnp.asarray(f[k]) for k in C_ARGS),
                     _jcfg(cfg), grav=jgrav)
    got = wk.forces(tw, tspec, *(torch.as_tensor(f[k]) for k in C_ARGS), cfg,
                    grav=tgrav)
    assert tuple(got[0].shape) == (tspec.n_sorted, dim)
    _compare(got[0], want[0], real, "acc")
    _compare(got[1], want[1], real, "du")


@pytest.mark.parametrize("dim", [3, 2])
def test_update_derived_compact_equals_in_place(dim):
    """The compact walk sums the in-place walk's pairs in another order:
    a derived pass with a compact spec equals one with the in-place spec
    on every particle."""
    (pos, vel, mass, u, h), _, tspec, _, _ = _geometry(dim, 2)
    cfg = (dataclasses.replace(tconf.TURB, newton_iters=2) if dim == 3
           else DIM2)
    _, td = _domains(dim)
    st = make_state(*(torch.as_tensor(a) for a in (pos, vel, mass, u, h)))
    a = teng.update_derived(st, cfg, td, tspec)
    b = teng.update_derived(st, cfg, td, dataclasses.replace(tspec,
                                                             cwidth=0))
    every = np.ones(st.n, bool)
    for k in ("h", "rho", "P", "omega", "divv", "acc", "du_dt"):
        _compare(getattr(a, k), getattr(b, k), every, k)
