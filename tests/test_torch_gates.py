"""The JAX package's gravity gates on the port, with their own sizes and
bounds (float64 on the CPU):

- ``tests/problems/test_evrard.py::test_evrard_p3m_variant_tracks_direct``:
  the P3M variant of the Evrard problem tracks the direct sum over 4 steps
  (|dv| < 5 % of the velocity scale). The file's energy gate (n = 1024 to
  t = 0.5) takes about a minute on one CPU thread and runs on the card
  instead, in fp64 (``chip_smoke.py`` phase 40);
- ``tests/unit/test_pm.py::test_p3m_periodic_matches_brute_ewald`` (slow in
  the JAX package): ``pm.p3m_accel_dense`` on a periodic box against a
  brute-force Ewald sum in numpy (real-space erfc images over the 27
  neighbour cells, the k-space sum to kmax = 21): rms relative error
  < 3e-3, p99 < 9e-3.
"""
import numpy as np
import torch
from scipy.special import erfc

from sphax_torch import problems
from sphax_torch.configs import SPHConfig
from sphax_torch.core.state import box
from sphax_torch.integrate import leapfrog
from sphax_torch.physics import pm

torch.set_num_threads(1)
F64 = torch.float64


def test_evrard_p3m_variant_tracks_direct():
    pd = problems.evrard(n=700, dtype=F64, device="cpu")
    pp = problems.evrard(n=700, solver="p3m", mesh=32, dtype=F64,
                         device="cpu")
    sd, sp = pd.state, pp.state
    for _ in range(4):
        sd, _ = leapfrog.step(sd, pd.cfg, pd.domain, pd.engine)
        sp, _ = leapfrog.step(sp, pp.cfg, pp.domain, pp.engine)
    assert bool(torch.isfinite(sp.rho).all())
    dv = float((sp.vel - sd.vel).abs().max())
    vscale = float(sd.vel.abs().max()) + 1e-30
    assert dv < 0.05 * vscale, (dv, vscale)


# tests/unit/test_pm.py's configuration and cloud
P3M = SPHConfig(dim=3, gravity=True, G=1.0, grav_eps=0.004,
                grav_solver="p3m", grav_mesh=64, grav_rs_cells=2.0)


def _cloud(n, seed=5):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.random((n // 2, 3)),
                          np.mod(0.3 + 0.12 * rng.standard_normal(
                              (n // 2, 3)), 1.0)])
    return np.clip(pos, 1e-3, 1 - 1e-3), rng.random(n) + 0.5


def ewald_accel(pos, mass, cfg, L=1.0, kmax=21):
    """Periodic gravity by brute force, Ewald-split at the P3M scale rs:
    erfc-screened Plummer pairs over the 27 nearest images, and the
    Gaussian-screened k-space lattice sum to |k_i| <= kmax (Jeans swindle:
    k = 0 dropped)."""
    G = cfg.G
    rs = cfg.grav_rs_cells * L / cfg.grav_mesh
    acc = np.zeros_like(pos)
    for off in np.array(np.meshgrid(*[[-1, 0, 1]] * 3)).reshape(3, -1).T:
        dx = pos[:, None, :] - pos[None, :, :] + off * L
        r2 = np.einsum("ijk,ijk->ij", dx, dx)
        r = np.sqrt(np.maximum(r2, 1e-30))
        x = r / (2 * rs)
        s = erfc(x) + (r / (rs * np.sqrt(np.pi))) * np.exp(-x * x)
        f = s * (r2 + cfg.grav_eps ** 2) ** -1.5
        if not off.any():
            np.fill_diagonal(f, 0.0)
        acc -= G * np.einsum("ij,ijk->ik", f * mass[None, :], dx)
    k1 = np.arange(-kmax, kmax + 1)
    ks = np.array(np.meshgrid(k1, k1, k1)).reshape(3, -1).T
    ks = ks[np.any(ks != 0, axis=1)] * (2 * np.pi / L)
    k2 = np.einsum("kd,kd->k", ks, ks)
    coef = 4 * np.pi * G / L ** 3 * np.exp(-k2 * rs * rs) / k2
    phase = pos @ ks.T
    s_re = (np.cos(phase).T * mass).sum(1)
    s_im = (np.sin(phase).T * mass).sum(1)
    amp = (np.sin(phase) * s_re - np.cos(phase) * s_im) * coef
    return acc - amp @ ks


def test_p3m_periodic_matches_brute_ewald():
    pos, mass = _cloud(500)
    want = ewald_accel(pos, mass, P3M)
    dom = box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64))
    got = pm.p3m_accel_dense(torch.as_tensor(pos), torch.as_tensor(mass),
                             P3M, dom).numpy()
    rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.sqrt(np.mean(rel ** 2)) < 3e-3, np.sqrt(np.mean(rel ** 2))
    assert np.percentile(rel, 99) < 9e-3, np.percentile(rel, 99)
