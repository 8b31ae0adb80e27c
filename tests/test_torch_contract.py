"""The port's copies and numerical contract against the JAX package.

Configs and ICs are copies (importing anything from ``sphax`` imports JAX),
so each copy is held equal to its original; the kernel, pair and EOS
formulae agree on random float64 inputs at rtol 1e-12; and importing every
``sphax_torch`` module imports no JAX.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.ics import lattice as j_lattice
from sphax.ics import turbulence as j_turb
from sphax.integrate import timestep as j_timestep
from sphax.physics import eos as j_eos
from sphax.physics import kernels as j_kernels
from sphax.physics import pairs as j_pairs
from sphax_torch import configs as t_configs
from sphax_torch import convert
from sphax_torch.core.state import ParticleState as TState
from sphax_torch.ics import lattice as t_lattice
from sphax_torch.ics import turbulence as t_turb
from sphax_torch.integrate import timestep as t_timestep
from sphax_torch.physics import eos as t_eos
from sphax_torch.physics import kernels as t_kernels
from sphax_torch.physics import pairs as t_pairs

torch.set_num_threads(1)

RTOL = 1e-12
CANONICAL = ("SOD", "SEDOV", "KH", "EVRARD", "TURB")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(t, j, rtol=RTOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = np.abs(j).max() + 1e-300
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(sphax.SPHConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(t_configs.SPHConfig)]
    assert tf == jf
    for name in CANONICAL:
        j, t = getattr(sphax.configs, name), getattr(t_configs, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert (t.visc_factor_on, t.need_divv, t.support) == (
            j.visc_factor_on, j.need_divv, j.support)
    with pytest.raises(ValueError):
        t_configs.SPHConfig(h_predict=True)


@pytest.mark.parametrize("kw", [dict(n_side=6), dict(n_side=9, seed=3,
                                                     jitter=0.1)])
def test_ics_equal(kw):
    a, b = j_turb.build(**kw), t_turb.build(**kw)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
    np.testing.assert_array_equal(
        t_lattice.cubic_lattice((3, 4), [0, -1], [1, 2]),
        j_lattice.cubic_lattice((3, 4), [0, -1], [1, 2]))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernels_agree(dim):
    rng = np.random.default_rng(dim)
    r = rng.uniform(0.0, 2.5, 4000)
    r[:5] = 0.0
    h = rng.uniform(0.5, 1.5, 4000)
    for fn in ("W", "dW_dq", "grad_W_over_r", "dW_dh"):
        _close(getattr(t_kernels, fn)(_t(r), _t(h), dim),
               getattr(j_kernels, fn)(jnp.asarray(r), jnp.asarray(h), dim))
    assert t_kernels.sigma(dim) == j_kernels.sigma(dim)


def _pair_inputs(seed, n=600, dim=3):
    rng = np.random.default_rng(seed)
    dx = rng.uniform(-1.0, 1.0, (n, dim))
    dx[:3] = 0.0
    r = np.sqrt(np.sum(dx * dx, -1))
    dv = rng.normal(size=(n, dim))
    pos = lambda lo, hi: rng.uniform(lo, hi, n)
    return dict(dx=dx, r=r, dv=dv, h_i=pos(0.4, 1.0), h_j=pos(0.4, 1.0),
                rho_i=pos(0.5, 2), rho_j=pos(0.5, 2), P_i=pos(0.1, 1),
                P_j=pos(0.1, 1), cs_i=pos(0.5, 1.5), cs_j=pos(0.5, 1.5),
                om_i=pos(0.8, 1.2), om_j=pos(0.8, 1.2), m_j=pos(0.5, 1.5),
                bf_i=pos(0, 1), bf_j=pos(0, 1))


@pytest.mark.parametrize("balsara", [False, True])
def test_pairs_agree(balsara):
    cfg_kw = dict(balsara=balsara, alpha_visc=1.3, beta_visc=2.1,
                  eps_visc=0.02)
    tcfg, jcfg = t_configs.SPHConfig(**cfg_kw), sphax.SPHConfig(**cfg_kw)
    p = _pair_inputs(1 + balsara)
    names = ("dx", "r", "dv", "h_i", "h_j", "rho_i", "rho_j", "P_i", "P_j",
             "cs_i", "cs_j", "om_i", "om_j", "m_j")
    bf = ("bf_i", "bf_j") if balsara else ()
    tf = t_pairs.force_terms(*(_t(p[k]) for k in names), tcfg,
                             *(_t(p[k]) for k in bf))
    jf = j_pairs.force_terms(*(jnp.asarray(p[k]) for k in names), jcfg,
                             *(jnp.asarray(p[k]) for k in bf))
    for a, b in zip(tf, jf):
        _close(a, b)
    for a, b in zip(t_pairs.density_terms(_t(p["r"]), _t(p["h_i"]),
                                          _t(p["m_j"]), 3),
                    j_pairs.density_terms(jnp.asarray(p["r"]),
                                          jnp.asarray(p["h_i"]),
                                          jnp.asarray(p["m_j"]), 3)):
        _close(a, b)
    for dim in (2, 3):
        q = _pair_inputs(7, dim=dim)
        args = ("dx", "r", "dv", "h_i", "m_j")
        for a, b in zip(
                t_pairs.balsara_terms(*(_t(q[k]) for k in args), dim),
                j_pairs.balsara_terms(*(jnp.asarray(q[k]) for k in args),
                                      dim)):
            _close(a, b)
    args = ("P_i", "cs_i", "cs_j", "h_i")  # divv, curl, cs, h stand-ins
    _close(t_pairs.balsara_factor(*(_t(p[k]) - 0.5 for k in args[:1]),
                                  *(_t(p[k]) for k in args[1:])),
           j_pairs.balsara_factor(*(jnp.asarray(p[k]) - 0.5
                                    for k in args[:1]),
                                  *(jnp.asarray(p[k]) for k in args[1:])))
    mm = dict(mm_visc=True, balsara=balsara)
    tv = t_pairs.visc_factor(t_configs.SPHConfig(**mm), bf=_t(p["bf_i"]),
                             alpha=_t(p["bf_j"]))
    jv = j_pairs.visc_factor(sphax.SPHConfig(**mm),
                             bf=jnp.asarray(p["bf_i"]),
                             alpha=jnp.asarray(p["bf_j"]))
    _close(tv, jv)
    _close(t_pairs.mm_alpha_update(_t(p["bf_i"]), _t(p["P_j"]) - 0.5,
                                   _t(p["h_i"]), _t(p["cs_i"]), 0.03,
                                   t_configs.SPHConfig(**mm)),
           j_pairs.mm_alpha_update(jnp.asarray(p["bf_i"]),
                                   jnp.asarray(p["P_j"]) - 0.5,
                                   jnp.asarray(p["h_i"]),
                                   jnp.asarray(p["cs_i"]), 0.03,
                                   sphax.SPHConfig(**mm)))


@pytest.mark.parametrize("isothermal", [False, True])
def test_eos_and_timestep_agree(isothermal):
    kw = dict(isothermal=isothermal, cs_iso=1.7, gamma=1.4)
    rng = np.random.default_rng(5)
    rho, u = rng.uniform(0.1, 3, 500), rng.uniform(0.1, 2, 500)
    for a, b in zip(t_eos.eos(_t(rho), _t(u), t_configs.SPHConfig(**kw)),
                    j_eos.eos(jnp.asarray(rho), jnp.asarray(u),
                              sphax.SPHConfig(**kw))):
        _close(a, b)
    n = 300
    fields = dict(pos=rng.normal(size=(n, 3)), vel=rng.normal(size=(n, 3)),
                  acc=rng.normal(size=(n, 3)), cs=rng.uniform(0.5, 2, n),
                  h=rng.uniform(0.05, 0.2, n))
    full = {k: fields.get(k, np.ones(n)) for k in TState._fields}
    ts = TState(**{k: _t(v) for k, v in full.items()})
    js = sphax.ParticleState(**{k: jnp.asarray(v) for k, v in full.items()})
    _close(t_timestep.particle_dt(ts, t_configs.SPHConfig(**kw)),
           j_timestep.particle_dt(js, sphax.SPHConfig(**kw)))


@pytest.mark.parametrize("periodic", [True, (True, False, True)])
def test_domain_agrees(periodic):
    rng = np.random.default_rng(9)
    lo, hi = np.array([0.0, -1.0, 0.5]), np.array([1.0, 2.0, 1.25])
    pos = rng.uniform(-2.0, 3.0, (400, 3))
    dx = rng.uniform(-3.0, 3.0, (400, 3))
    jd = sphax.Domain(jnp.asarray(lo), jnp.asarray(hi), periodic=periodic)
    td = convert.domain_from_numpy(lo, hi, periodic, "cpu", torch.float64)
    assert td.periodic_axes(3) == jd.periodic_axes(3)
    _close(td.wrap(_t(pos)), jd.wrap(jnp.asarray(pos)))
    _close(td.displacement(_t(dx)), jd.displacement(jnp.asarray(dx)))


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "pre = set(sys.modules)\n"
        "import sphax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    sphax_torch.__path__, 'sphax_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - pre\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'sphax',\n"
        "                                                  'jaxlib'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules or 'jax' in pre\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
