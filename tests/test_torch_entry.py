"""The twins of ``__graft_entry__``'s entry points.

``sphax_torch.entry.dryrun_multichip`` against
``__graft_entry__.dryrun_multichip``'s checks, on 4 gloo ranks over CPU
tensors at the JAX dry run's sizes (the turbulence lattice at
ceil(3.8 * 4)^3 = 16^3, the pencil's own 12^3): the slab chunk, the
rebalance and migration to convergence, the B = 2 rung span and the 2x2
pencil chunk, each with its own checks inside.

``sphax_torch.entry.entry`` against the JAX step that
``__graft_entry__.entry()`` builds, in float64 on the CPU: the flagship
from ``__graft_entry__._flagship`` (``configs.TURB`` on the turbulence
lattice at 10^3: the JAX step's compile takes about a minute a core at the
entry point's 16^3), the same window plan, the jnp walks (``use_pallas=False``)
on the JAX side and the plain walks on the port's. The set-up pass and two
steps from the same bits are held at 1e-10 (rtol, and atol 1e-10 of the
field's largest value), the dts at 1e-12.

The flagship's cell grid (``_entry_flagship``) and the dry run's set-up
pass through the cell list (``clist.update_derived``, one Newton update)
against ``__graft_entry__._flagship``'s grid and the JAX cell-list pass on
it, in float64 at the dry run's 16^3: the same grid, the fields at 1e-10.
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sphax_torch import convert
from sphax_torch.entry import _entry_flagship, dryrun_multichip, entry
from sphax_torch.integrate.timestep import local_dt

torch.set_num_threads(1)

RTOL = 1e-10
N_SIDE = 10


def test_dryrun_multichip_four_ranks(capfd):
    rec = dryrun_multichip(4, "cpu", timeout=120)
    assert rec["n"] == 16 ** 3 and rec["pencil"]["n"] == 12 ** 3
    s = rec["slab"]
    assert s["steps"] == 2 and s["dt_last"] > 0 and s["rung_ticks"] == 2
    assert 1 <= s["migrate_passes"] <= 4 and s["rung_closings"] > 0
    assert rec["pencil"]["steps"] == 2
    assert "dryrun_multichip OK: 4 ranks" in capfd.readouterr().out


def test_flagship_grid_and_setup_pass_match_jax():
    import dataclasses

    import jax.numpy as jnp

    from sphax.physics import clist as jclist
    from sphax_torch.physics import clist

    jst, jcfg, jdom, jgrid = graft._flagship(n_side=16, dtype=jnp.float64)
    st, cfg, dom, grid = _entry_flagship(16, torch.float64, "cpu")
    assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))
    want = jclist.update_derived(
        jst, dataclasses.replace(jcfg, newton_iters=1), jdom, jgrid)
    got = clist.update_derived(st, dataclasses.replace(cfg, newton_iters=1),
                               dom, grid)
    _close(got, want, ("h", "rho", "P", "omega", "divv", "acc", "du_dt"),
           "dry run set-up pass")


def _jax_entry():
    """``__graft_entry__.entry()``'s step in float64 through the jnp walks:
    (jitted step with its dt, state after the set-up pass)."""
    import jax.numpy as jnp

    from sphax.integrate import leapfrog
    from sphax.neighbors import window as win
    from sphax.physics import wengine

    st, cfg, dom, _ = graft._flagship(n_side=N_SIDE, dtype=jnp.float64)
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)
    engine = lambda s: wengine.update_derived(s, cfg, dom, spec,
                                              use_pallas=False)
    step = jax.jit(lambda s: leapfrog.step(s, cfg, dom, engine))
    return step, engine(st)


def _close(got, want, fields, what):
    for k in fields:
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{what}: {k}")


def test_entry_matches_the_jax_entry_step():
    step_j, st_j = _jax_entry()
    fn, (st,) = entry(device="cpu", dtype=torch.float64, n_side=N_SIDE)
    assert st.n == N_SIDE ** 3 and st.pos.dtype == torch.float64
    assert fn.cfg.newton_iters == 6 and fn.cfg.balsara
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(st_j.pos))
    _close(st, st_j, ("h", "rho", "P", "omega", "divv", "acc", "du_dt"),
           "set-up pass")

    # two steps from the same bits: the JAX state carried across
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in st_j._asdict().items()}, "cpu",
        torch.float64)
    for _ in range(2):
        dt = float(local_dt(st, fn.cfg))   # the dt that fn's step takes
        st_j, dt_j = step_j(st_j)
        np.testing.assert_allclose(dt, float(dt_j), rtol=1e-12)
        st = fn(st)
    _close(st, st_j, ("pos", "vel", "u", "h", "rho"), "after two steps")


def test_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
