"""The port's pencil decomposition's host functions, geometry, routes,
set-up, histograms, rebalance and migration against ``sphax.dist.pencil``:
``plan``, ``equal_cuts``, ``refine_wseg`` and ``rebalance`` equal the JAX
functions exactly and raise where they raise; the local bin box, the
trash band's parking spots and the wrap of the non-cut axes at 1e-12;
``distribute`` the JAX layout's rows; ``_plan_routes`` on every rank of a
2x2 grid the same rows, validity and drops; and on tests/dist/
test_pencil.py:152's clustered problem (n_side=20, squashed into a corner
along both cut axes) the marginal histograms, the quantile cuts, the
count balance, and the migration back to equal cuts, against the JAX
package at 1e-10 with no particle dropped or lost.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sphax import box as jbox
from sphax import make_state as jmake_state
from sphax.dist import pencil as jpen
from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.dist import pencil as tpen
from tests.dist.test_pencil import PENCIL_CONFIGS
from tests.dist.test_wslab import _problem
from tests.parity.test_dense_vs_reference import make_problem
from tests.test_torch_pencil_lockstep import check_records, run_both

torch.set_num_threads(1)


def _tdom(jdom):
    return convert.domain_from_numpy(np.asarray(jdom.lo), np.asarray(jdom.hi),
                                     jdom.periodic, "cpu", torch.float64)


def _tspec(jspec):
    return convert.pencil_spec_from_fields(**dataclasses.asdict(jspec))


@pytest.mark.parametrize("grid,kw", [
    ((2, 2), {}), ((1, 2), dict(fast_sub=3, rgroups=2)),
    ((2, 1), dict(pad_factor=2.6, balance_headroom=1.9)),
    ((2, 3), dict(cutoff_scale=1.05, ghost_safety=1.4, migrate_frac=0.5))])
def test_host_functions_equal_reference(grid, kw):
    """plan, equal_cuts, refine_wseg and rebalance give what the JAX
    functions give."""
    st, jdom = _problem(PENCIL_CONFIGS["fixed_h"], n_side=20)
    tdom = _tdom(jdom)
    h_max = float(st.h.max()) * 1.1
    jspec = jpen.plan(jdom, st.n, h_max, *grid, **kw)
    tspec = tpen.plan(tdom, st.n, h_max, *grid, **kw)
    assert tspec == _tspec(jspec)
    assert tspec.n_comb == jspec.n_comb and tspec.n_shards == grid[0] * \
        grid[1]
    for a in (0, 1):
        nc, ns = (tspec.ncell0, grid[0]) if a == 0 else (tspec.ncell1,
                                                         grid[1])
        np.testing.assert_array_equal(tpen.equal_cuts(nc, ns),
                                      jpen.equal_cuts(nc, ns))
    for mr in (1, 200, 777, 5000):
        assert tpen.refine_wseg(tspec, mr) == _tspec(jpen.refine_wseg(jspec,
                                                                      mr))
    rng = np.random.default_rng(sum(grid))
    for h0, h1 in ((rng.integers(0, 50, tspec.ncell0),
                    rng.integers(0, 50, tspec.ncell1)),
                   (np.ones(tspec.ncell0), np.r_[np.zeros(tspec.ncell1 - 1),
                                                 9.0])):
        for a, b in zip(tpen.rebalance(h0, h1, tspec),
                        jpen.rebalance(h0, h1, jspec)):
            np.testing.assert_array_equal(a, b)


def test_plan_raises_where_reference_raises():
    """Thinner pencils than the ghost margin, and a 2D box (two cut axes
    and the window's fast axis need three)."""
    st, jdom = _problem(PENCIL_CONFIGS["fixed_h"])
    for args in ((st.n, 0.2, 4, 1), (st.n, 0.05, 1, 12)):
        with pytest.raises(ValueError, match="thinner"):
            jpen.plan(jdom, *args)
        with pytest.raises(ValueError, match="thinner"):
            tpen.plan(_tdom(jdom), *args)
    d2 = jbox(jnp.zeros(2), jnp.ones(2))
    with pytest.raises(ValueError, match="dim >= 3"):
        jpen.plan(d2, 100, 0.05, 2, 2)
    with pytest.raises(ValueError, match="dim >= 3"):
        tpen.plan(_tdom(d2), 100, 0.05, 2, 2)


def test_geometry_equals_reference():
    """The local bin box (trash band below the x-slab, both cut axes open),
    the parking spots of the two ghost bands and of padding rows, and the
    wrap of the non-cut axes only, in the reference's arithmetic."""
    st, jdom = _problem(PENCIL_CONFIGS["fixed_h"], n_side=20)
    jspec = jpen.plan(jdom, st.n, float(st.h.max()) * 1.1, 2, 3)
    tspec, tdom = _tspec(jspec), _tdom(jdom)
    f64 = jnp.float64
    for lo0, lo1 in ((0.0, 0.0), (0.3, 0.7)):
        jl0, jl1 = jnp.asarray(lo0, f64), jnp.asarray(lo1, f64)
        tl0, tl1 = (torch.tensor(v, dtype=torch.float64) for v in (lo0, lo1))
        jd = jpen._local_domain(jdom, jspec, jl0, jl1, f64)
        td = tpen._local_domain(tdom, tspec, tl0, tl1, torch.float64)
        np.testing.assert_allclose(td.lo.numpy(), np.asarray(jd.lo),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(td.hi.numpy(), np.asarray(jd.hi),
                                   rtol=1e-12, atol=1e-12)
        assert td.periodic == jd.periodic == (False, False, True)
        for n, salt in ((jspec.ghost_cap0, 0.61803398875),
                        (jspec.ghost_cap1, 0.7548776662), (300, 0.5352919)):
            np.testing.assert_allclose(
                tpen._trash_pos(n, tdom, tspec, tl0, tl1, torch.float64,
                                salt=salt).numpy(),
                np.asarray(jpen._trash_pos(n, jdom, jspec, jl0, jl1, f64,
                                           salt=salt)),
                rtol=1e-12, atol=1e-12)
    pos = np.random.default_rng(1).uniform(-0.7, 1.8, (64, 3))
    np.testing.assert_allclose(
        tpen._wrap_other(torch.as_tensor(pos), tdom).numpy(),
        np.asarray(jpen._wrap_other(jnp.asarray(pos), jdom)), rtol=1e-12,
        atol=1e-12)


def _routes_rank(c, rows, domain, spec, cuts):
    """``_plan_routes`` on this rank; every rank's (takes, valids, drops)
    gathered on rank 0, in rank order."""
    c.grid(spec.ns0, spec.ns1)
    st = convert.shard_from_numpy(rows, spec, c.rank, "cpu", torch.float64)
    dom = convert.domain_from_numpy(*domain, device="cpu",
                                    dtype=torch.float64)
    routes, _, _, dropped = tpen._plan_routes(c, st, *cuts, dom, spec)
    out = []
    for take, valid in routes:
        out += [take.double(), valid.double()]
    out = c.gather_rows(torch.cat(out + [dropped.double().reshape(1)]))
    return None if out is None else out.numpy()


def test_distribute_and_routes_equal_reference():
    """Each rank's pencil of a single-device state (padding parked in its
    trash band) is the JAX layout's rows; the two-hop routes select the
    same rows, with the same validity and drops, on every rank."""
    st, jdom = _problem(PENCIL_CONFIGS["fixed_h"])
    jspec = jpen.plan(jdom, st.n, float(st.h.max()) * 1.1, 2, 2)
    cuts = (jpen.equal_cuts(jspec.ncell0, 2), jpen.equal_cuts(jspec.ncell1,
                                                              2))
    mesh = jpen.make_mesh(2, 2)
    jsh = jpen.distribute(st, jdom, mesh, jspec, *cuts)
    tspec, tdom = _tspec(jspec), _tdom(jdom)
    tst = convert.state_from_numpy({k: np.asarray(getattr(st, k))
                                    for k in st._fields}, "cpu",
                                   torch.float64)
    got = [tpen.distribute(tst, tdom, tspec, *cuts, r) for r in range(4)]
    for k in st._fields:
        np.testing.assert_allclose(
            np.concatenate([getattr(g, k).numpy() for g in got]),
            np.asarray(getattr(jsh, k)), rtol=1e-15, atol=1e-15, err_msg=k)

    ax = P((jpen.AX0, jpen.AX1))

    def local(s, c0, c1, d):
        routes, _, _, dropped = jpen._plan_routes(s, c0, c1, d, jspec)
        flat = []
        for take, valid in routes:
            flat += [take.astype(jnp.float64), valid.astype(jnp.float64)]
        return jnp.concatenate(flat + [jnp.asarray(dropped,
                                                   jnp.float64)[None]])

    want = np.asarray(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(ax, P(), P(), P()), out_specs=ax,
        check_vma=False))(jsh, *(jnp.asarray(c) for c in cuts), jdom))
    rows = {k: np.asarray(getattr(jsh, k)) for k in jsh._fields}
    have = comm.launch(_routes_rank, 4, "cpu", "gloo", timeout=60,
                       deadline=120,
                       args=(rows, (np.asarray(jdom.lo), np.asarray(jdom.hi),
                                    jdom.periodic), tspec, cuts))
    np.testing.assert_array_equal(have, want)
    # the y faces select from the combined rows: some take an x ghost
    G0, G1, nl = jspec.ghost_cap0, jspec.ghost_cap1, jspec.n_local
    per = 4 * G0 + 4 * G1 + 1
    for r in range(4):
        y_takes = want[r * per + 4 * G0:r * per + 4 * G0 + 4 * G1]
        y_lo = y_takes[:G1][y_takes[G1:2 * G1] > 0]
        assert (y_lo >= nl).any(), r


def test_migrate_and_rebalance_equal_reference():
    """tests/dist/test_pencil.py:152's clustered ICs: from the per-axis
    quantile cuts of the host histograms (the JAX function's), the sharded
    marginal histograms equal the host ones, no pencil holds over 2.5x its
    fair share, and migration back to equal cuts converges with nothing
    dropped or lost: every state at 1e-10 of the JAX package's."""
    cfg = PENCIL_CONFIGS["fixed_h"]
    pos, vel, mass, u, h = make_problem(dim=3, n_side=20, seed=7,
                                        vel_scale=0.0)
    pos = np.asarray(pos)
    pos[:, 0] = pos[:, 0] ** 2.5
    pos[:, 1] = pos[:, 1] ** 2.5
    dom = jbox(jnp.zeros(3), jnp.ones(3))
    st = jmake_state(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
                     jnp.asarray(u), jnp.asarray(h))
    kw = dict(balance_headroom=1.9, pad_factor=2.6)
    jspec = jpen.plan(dom, st.n, float(st.h.max()) * 1.1, 2, 2, **kw)
    tspec = tpen.plan(_tdom(dom), st.n, float(st.h.max()) * 1.1, 2, 2, **kw)
    hists = [np.histogram(pos[:, a] * nc, bins=np.arange(nc + 1))[0]
             for a, nc in ((0, jspec.ncell0), (1, jspec.ncell1))]
    cuts = jpen.rebalance(*hists, jspec)
    for a, b in zip(tpen.rebalance(*hists, tspec), cuts):
        np.testing.assert_array_equal(a, b)
    eq = tuple(tuple(jpen.equal_cuts(nc, 2).tolist())
               for nc in (jspec.ncell0, jspec.ncell1))
    assert any(tuple(a) != b for a, b in zip(cuts, eq))
    got, want, _ = run_both(cfg, st, dom, (2, 2),
                            [("rebalance",), ("cuts", *eq), ("migrate",)],
                            plan_kw=kw, cuts=cuts, refine=False)
    check_records(got, want, "clustered 2x2")
    for a, b in zip(got[0]["hist"], hists):
        np.testing.assert_array_equal(a, b)
    nl = got[0]["rows"]["mass"].shape[0] // 4
    counts = (got[0]["rows"]["mass"].reshape(4, nl) > 0).sum(1)
    assert counts.max() / (st.n / 4) < 2.5, counts
    real = got[-1]["rows"]["mass"] > 0
    assert real.sum() == st.n
    p = got[-1]["rows"]["pos"][real]
    oi = np.lexsort((p[:, 2], p[:, 1], p[:, 0]))
    oj = np.lexsort((pos[:, 2], pos[:, 1], pos[:, 0]))
    np.testing.assert_allclose(p[oi], pos[oj], rtol=1e-12)
