"""The port's cell-list engine against ``sphax`` on the same inputs.

``sphax_torch.neighbors.morton`` (keys exactly equal to the JAX uint32
keys), ``neighbors.cell_list`` (``choose_grid``, ``build`` with its
overflow, ``neighbor_cids`` on periodic, open and mixed boxes) and
``physics.clist.update_derived`` at 1e-10 in float64 against
``sphax.physics.clist`` for the configurations of
tests/parity/test_clist_vs_dense.py, and against the port's own dense
engine at 1e-10; the blocking changes no result; and the problem registry
takes the cell list above 3,000 particles on the CPU, as ``sphax.problems``
does, with the same derived state.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax import problems as jprob
from sphax.neighbors import cell_list as jcl
from sphax.neighbors import morton as jmorton
from sphax.physics import clist as jclist
from sphax_torch import configs as tconf
from sphax_torch import convert, problems
from sphax_torch.core.state import box, make_state
from sphax_torch.neighbors import cell_list as tcl
from sphax_torch.neighbors import morton as tmorton
from sphax_torch.physics import clist, dense
from tests.parity.test_dense_vs_reference import CONFIGS, make_problem

torch.set_num_threads(1)

DERIVED = ("h", "rho", "P", "cs", "omega", "divv", "acc", "du_dt")


def _close(got, want, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() + 1e-300
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _tcfg(cfg):
    return tconf.SPHConfig(**dataclasses.asdict(cfg))


def _states(cfg, n_side, seed=3):
    """The same jittered lattice as a JAX and a torch float64 state, and
    the unit box for each."""
    pos, vel, mass, u, h = make_problem(dim=cfg.dim, n_side=n_side,
                                        seed=seed)
    jdom = sphax.box(jnp.zeros(cfg.dim), jnp.ones(cfg.dim))
    jst = sphax.make_state(*(jnp.asarray(a) for a in (pos, vel, mass, u, h)))
    tdom = box(torch.zeros(cfg.dim, dtype=torch.float64),
               torch.ones(cfg.dim, dtype=torch.float64))
    tst = make_state(*(torch.as_tensor(a, dtype=torch.float64)
                       for a in (pos, vel, mass, u, h)))
    return jst, jdom, tst, tdom


# ---------------------------------------------------------------------------
# Morton keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,bits", [(1, 20), (2, 16), (3, 10)])
def test_morton_keys_equal_jax(dim, bits):
    """encode equals the JAX uint32 key bit for bit over the whole
    coordinate range (the corners included); decode inverts it, as JAX's
    does; spread/compact equal JAX's on every value of the axis."""
    rng = np.random.default_rng(dim)
    c = rng.integers(0, 1 << bits, size=(4096, dim)).astype(np.int32)
    c[0], c[1] = 0, (1 << bits) - 1
    want = np.asarray(jmorton.encode(jnp.asarray(c))).astype(np.int64)
    got = tmorton.encode(torch.as_tensor(c))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmorton.decode(got, dim).numpy(), c)
    np.testing.assert_array_equal(
        tmorton.decode(got, dim).numpy(),
        np.asarray(jmorton.decode(jnp.asarray(want.astype(np.uint32)),
                                  dim)).astype(np.int64))
    if dim > 1:
        x = np.arange(1 << bits, dtype=np.int32)
        sp, co = {2: ("spread2", "compact2"), 3: ("spread3", "compact3")}[dim]
        s_j = np.asarray(getattr(jmorton, sp)(jnp.asarray(x)))
        s_t = getattr(tmorton, sp)(torch.as_tensor(x))
        np.testing.assert_array_equal(s_t.numpy(), s_j.astype(np.int64))
        np.testing.assert_array_equal(
            getattr(tmorton, co)(s_t).numpy(),
            np.asarray(getattr(jmorton, co)(jnp.asarray(s_j))).astype(
                np.int64))


# ---------------------------------------------------------------------------
# the grid and the build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ext,h_max,n", [
    ((1.0, 1.0, 1.0), 0.06, 4096), ((1.0, 0.25, 0.25), 0.02, 3000),
    ((2.0, 1.0), 0.011, 20000), ((1.0, 1.0, 1.0), 0.0003, 10**6)])
def test_choose_grid_matches(ext, h_max, n):
    """The same resolution and capacity as the JAX version, the max_cells
    halving included (the last case)."""
    d = len(ext)
    jg = jcl.choose_grid(sphax.box(jnp.zeros(d), jnp.asarray(ext)), h_max, n)
    tg = tcl.choose_grid(box(torch.zeros(d, dtype=torch.float64),
                             torch.tensor(ext, dtype=torch.float64)),
                         h_max, n)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert tg == convert.grid_from_fields(**dataclasses.asdict(jg))
    assert tg.n_candidates == jg.n_candidates
    np.testing.assert_array_equal(tg.offsets(), jg.offsets())


@pytest.mark.parametrize("dim,n_side,res,cap", [
    (3, 8, (3, 3, 3), 64), (3, 8, (4, 2, 1), 64), (2, 12, (5, 4), 16),
    (3, 8, (3, 3, 3), 8), (1, 40, (7,), 4)])
def test_build_matches(dim, n_side, res, cap):
    """perm, cid, slot, table and overflow equal the JAX build's, ties in
    the Morton key included; the last two cases overflow their cells."""
    pos = make_problem(dim=dim, n_side=n_side, seed=5)[0]
    grid = jcl.Grid(res=res, capacity=cap)
    jdom = sphax.box(jnp.zeros(dim), jnp.ones(dim))
    tdom = box(torch.zeros(dim, dtype=torch.float64),
               torch.ones(dim, dtype=torch.float64))
    want = jcl.build(jnp.asarray(pos), jdom, grid)
    got = tcl.build(torch.as_tensor(pos), tdom,
                    convert.grid_from_fields(**dataclasses.asdict(grid)))
    for k in ("perm", "cid", "slot", "table"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    assert int(got.overflow) == int(want.overflow)
    if cap <= 8:
        assert int(got.overflow) > 0


@pytest.mark.parametrize("periodic", [True, False, (True, False, True)])
@pytest.mark.parametrize("res", [(5, 4, 3), (2, 1, 3)])
def test_neighbor_cids_match(periodic, res):
    """Neighbour ids and validity of every cell equal the JAX version's on
    periodic, open and mixed boxes, with the deduplicated offsets of
    resolutions 2 and 1."""
    grid = jcl.Grid(res=res, capacity=4)
    cids = np.arange(grid.ncells, dtype=np.int32)
    wid, wok = jcl.neighbor_cids(jnp.asarray(cids), grid, periodic)
    gid, gok = tcl.neighbor_cids(torch.as_tensor(cids, dtype=torch.int64),
                                 tcl.Grid(res=res, capacity=4), periodic)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(wid))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _grid(cfg):
    """tests/parity/test_clist_vs_dense.py's grid: cells of a third of the
    box, 256 slots."""
    n_side = 12 if cfg.dim == 2 else 8
    return n_side, jcl.Grid(res=tuple([max(1, int(n_side / 3))] * cfg.dim),
                            capacity=256)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_update_derived_matches_jax(name):
    """clist.update_derived against sphax.physics.clist.update_derived at
    1e-10, float64, on the parity test's lattice and grid; its two
    counters too."""
    cfg = CONFIGS[name]
    n_side, grid = _grid(cfg)
    jst, jdom, tst, tdom = _states(cfg, n_side)
    tgrid = convert.grid_from_fields(**dataclasses.asdict(grid))
    want = jclist.update_derived(jst, cfg, jdom, grid, cell_block=8)
    got = clist.update_derived(tst, _tcfg(cfg), tdom, tgrid, cell_block=8)
    for k in DERIVED:
        _close(getattr(got, k), getattr(want, k), 1e-10, k)
    assert int(clist.overflow_count(tst, tdom, tgrid)) == int(
        jclist.overflow_count(jst, jdom, grid)) == 0
    assert int(clist.h_saturation_count(got, tdom, tgrid)) == int(
        jclist.h_saturation_count(want, jdom, grid))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clist_matches_port_dense(name):
    """The port's cell list against the port's dense engine at 1e-10: the
    candidates find every pair."""
    cfg = _tcfg(CONFIGS[name])
    n_side, grid = _grid(cfg)
    _, _, tst, tdom = _states(cfg, n_side)
    tgrid = convert.grid_from_fields(**dataclasses.asdict(grid))
    a = dense.update_derived(tst, cfg, tdom, block=64)
    b = clist.update_derived(tst, cfg, tdom, tgrid)
    for k in DERIVED:
        _close(getattr(b, k), getattr(a, k), 1e-10, k)


@pytest.mark.parametrize("cell_block", [1, 5, 64, 10**4])
def test_cell_block_changes_nothing(cell_block):
    """Any cell_block (one cell, a block that does not divide the cells,
    more than all cells) gives the auto block's results bit for bit."""
    cfg = _tcfg(CONFIGS["balsara"])
    _, _, tst, tdom = _states(cfg, 8)
    grid = tcl.Grid(res=(3, 3, 3), capacity=64)
    assert int(clist.overflow_count(tst, tdom, grid)) == 0
    want = clist.update_derived(tst, cfg, tdom, grid)
    got = clist.update_derived(tst, cfg, tdom, grid, cell_block=cell_block)
    for k in DERIVED:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy(), k)


@pytest.mark.parametrize("case", [("sedov", 15), ("kh", 48)])
def test_auto_engine_takes_the_cell_list(case, monkeypatch):
    """Above 3,000 particles on the CPU the registry takes the cell list,
    as sphax.problems does: the same grid and the first derived state at
    1e-10."""
    name, n = case
    grids = []

    def spy(*a, **kw):
        grids.append(real(*a, **kw))
        return grids[-1]
    real = jcl.choose_grid
    monkeypatch.setattr(jcl, "choose_grid", spy)
    jp = jprob.REGISTRY[name](n=n, dtype=jnp.float64)
    tp = problems.REGISTRY[name](n=n, dtype=torch.float64, device="cpu")
    assert tp.state.n == jp.state.n > 3000
    assert tp.engine_name == "clist" and tp.wspec is None is jp.wspec
    assert len(grids) == 1
    assert dataclasses.asdict(tp.grid) == dataclasses.asdict(grids[0])
    for k in DERIVED:
        _close(getattr(tp.state, k), getattr(jp.state, k), 1e-10, k)
    # and at or below 3,000 it stays dense on both sides
    small = problems.REGISTRY[name](n=8 if name != "kh" else 16,
                                    dtype=torch.float64, device="cpu")
    assert small.state.n <= 3000 and small.engine_name == "dense"
