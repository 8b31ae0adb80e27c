"""Kernels A and C: the plain torch versions against the Pallas kernels (run
in interpret mode on the CPU, as the JAX package's own tests run them). The
CUDA kernels are held against the plain versions in tests/test_torch_gpu.py,
which imports no JAX.

Rows that are not real particles (ghost images, padding) are don't-care by
contract (wengine.stage_density), and the Pallas kernels' tile-level early
out differs from the port's group-level one there, so every comparison is
on ``is_real`` rows.
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
from sphax_torch import configs as tconf
from sphax_torch import convert
from sphax_torch.neighbors import window as twin
from sphax_torch.physics import window_kernels as wk
from tests.parity.test_dense_vs_reference import make_problem

torch.set_num_threads(1)

RTOL = 1e-10
TURB2 = dataclasses.replace(tconf.TURB, newton_iters=2)
A_CASES = {
    "cold_newton2": TURB2,
    "h_predict": dataclasses.replace(tconf.TURB, newton_iters=1,
                                     h_predict=True),
    "balsara_off": tconf.SPHConfig(dim=3, adaptive_h=True, newton_iters=2),
}


def _jcfg(cfg):
    return sphax.SPHConfig(**dataclasses.asdict(cfg))


def _problem(rgroups, seed=3):
    """n_side=8 as tests/parity/test_window_vs_dense.py plans it; sorted
    inputs made with numpy from a seed, owner-consistent on ghost rows."""
    pos, vel, mass, u, h = make_problem(dim=3, n_side=8, seed=seed)
    n = len(pos)
    rng = np.random.default_rng(seed)
    jd = sphax.box(jnp.zeros(3), jnp.ones(3))
    spec = jwin.plan_windows(jd, h_max=float(h.max()) * 1.25, n=n, dim=3,
                             rgroups=rgroups)
    jw = jax.jit(jwin.build, static_argnums=2)(jnp.asarray(pos), jd, spec)
    td = convert.domain_from_numpy(np.zeros(3), np.ones(3), True, "cpu",
                                   torch.float64)
    tspec = convert.spec_from_fields(**dataclasses.asdict(spec))
    tw = twin.build(torch.as_tensor(pos), td, tspec)
    g = np.minimum(np.asarray(jw.g), n)

    def srt(a, fill):
        return np.concatenate([a, np.full((1,) + a.shape[1:], fill)])[g]

    rho = rng.uniform(0.8, 1.2, n)
    P, cs = rho * rng.uniform(0.9, 1.1, n), rng.uniform(0.8, 1.2, n)
    fields = dict(pos_s=np.array(jw.pos_s), vel_s=srt(vel, 0.0),
                  mass_s=srt(mass, 0.0), u_s=srt(u, 0.0), h0_s=srt(h, 1.0),
                  h_s=srt(h * rng.uniform(0.95, 1.05, n), 1.0),
                  rho_s=srt(rho, 1.0), P_s=srt(P, 1.0), cs_s=srt(cs, 1.0),
                  om_s=srt(rng.uniform(0.9, 1.1, n), 1.0),
                  bf_s=srt(rng.uniform(0.0, 1.0, n), 0.0))
    return spec, tspec, jw, tw, fields, np.asarray(jw.is_real)


def _compare(got, want, real, what):
    got, want = np.asarray(got)[real], np.asarray(want)[real]
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("rgroups,case", [(1, "cold_newton2"),
                                          (1, "h_predict"),
                                          (1, "balsara_off"),
                                          (2, "cold_newton2")])
def test_solve_h_density_plain_matches_pallas(rgroups, case):
    cfg = A_CASES[case]
    spec, tspec, jw, tw, f, real = _problem(rgroups)
    args = ("pos_s", "mass_s", "h0_s")
    vel = f["vel_s"] if cfg.need_divv else None
    want = pk.solve_h_density(jw, spec, *(jnp.asarray(f[k]) for k in args),
                              _jcfg(cfg),
                              vel_s=None if vel is None else jnp.asarray(vel),
                              u_s=jnp.asarray(f["u_s"]))
    got = wk.solve_h_density(tw, tspec, *(torch.as_tensor(f[k])
                                          for k in args), cfg,
                             vel_s=None if vel is None
                             else torch.as_tensor(vel))
    assert len(got) == len(want) == (5 if cfg.need_divv else 3)
    for k, (a, b) in enumerate(zip(got, want)):
        _compare(a, b, real, f"{case} output {k}")


@pytest.mark.parametrize("rgroups,balsara", [(1, True), (1, False),
                                             (2, True)])
def test_forces_plain_matches_pallas(rgroups, balsara):
    cfg = dataclasses.replace(tconf.TURB, balsara=balsara)
    spec, tspec, jw, tw, f, real = _problem(rgroups, seed=4)
    args = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
            "om_s", "bf_s")
    want = pk.forces(jw, spec, *(jnp.asarray(f[k]) for k in args),
                     _jcfg(cfg))
    got = wk.forces(tw, tspec, *(torch.as_tensor(f[k]) for k in args), cfg)
    _compare(got[0], want[0], real, "acc")
    _compare(got[1], want[1], real, "du")
