"""The P3M mesh's CIC deposit and interpolation on the CPU: the plain
versions (``pm._deposit_plain``, ``pm._interp_plain``) that the CUDA
kernels of ``csrc/cic.cu`` are held to on the card, and the wrappers'
choice of them for a CPU tensor. Periodic and open boxes, fp32 and fp64.
"""
import pytest
import torch

from sphax_torch import configs
from sphax_torch.core.state import box
from sphax_torch.physics import pm

M = 8
DTYPES = [torch.float32, torch.float64]
# sums of a few hundred terms in fp32; fp64 near its rounding
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}


def _geometry(periodic, dtype, lo=(-0.5, 0.25, 0.0), hi=(0.5, 1.25, 2.0)):
    dom = box(lo, hi, periodic=periodic, dtype=dtype)
    return dom, dom.lo.to(dtype), dom.extent.to(dtype) / M


def _positions(dom, n, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 3), generator=g, dtype=torch.float64)
    return dom.wrap((dom.lo + u.to(dtype) * dom.extent).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periodic", [True, False])
def test_deposit_conserves_mass(periodic, dtype):
    dom, lo, cell = _geometry(periodic, dtype)
    pos = _positions(dom, 500, 1, dtype)
    # the corners of the box too: at lo, just below hi, and just below lo
    # (wrapped to just below hi on a periodic box)
    edge = torch.stack([dom.lo, torch.nextafter(dom.hi, dom.lo),
                        dom.lo - 1e-7 * dom.extent])
    pos = torch.cat([pos, dom.wrap(edge.to(dtype))])
    mass = torch.linspace(0.5, 1.5, pos.shape[0], dtype=dtype)
    grid = pm._deposit(pos, mass, lo, cell, M, periodic)
    assert grid.shape == (M, M, M) and grid.dtype == dtype
    assert float((grid < 0).sum()) == 0
    torch.testing.assert_close(grid.sum(), mass.sum(), rtol=TOL[dtype],
                               atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periodic", [True, False])
def test_a_particle_on_a_node_lands_wholly_on_it(periodic, dtype):
    """Nodes at lo + k cell, k = 0 .. M - 1 (on the open box the last node
    is the clipped cell's right node: frac 1 there)."""
    dom, lo, cell = _geometry(periodic, dtype)
    nodes = torch.tensor([[0, 0, 0], [3, 5, 1], [M - 1, M - 1, M - 1],
                          [M - 1, 0, 6]])
    pos = (lo + nodes.to(dtype) * cell).to(dtype)
    mass = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=dtype)
    grid = pm._deposit(pos, mass, lo, cell, M, periodic)
    want = torch.zeros((M, M, M), dtype=dtype)
    want[nodes[:, 0], nodes[:, 1], nodes[:, 2]] = mass
    assert torch.equal(grid, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("periodic", [True, False])
def test_interp_of_a_linear_field_is_exact(periodic, dtype):
    """A field linear in each axis over the nodes comes back at any point
    whose 8 corners lie inside the grid (the periodic box's wrap would
    break the line)."""
    dom, lo, cell = _geometry(periodic, dtype)
    k = torch.arange(M, dtype=torch.float64)
    coef = torch.tensor([[0.3, -1.2, 0.7], [2.0, 0.5, -0.25],
                         [-0.4, 0.9, 1.5]], dtype=torch.float64)
    grids = torch.stack([c[0] * k[:, None, None] + c[1] * k[None, :, None]
                         + c[2] * k[None, None, :] + 1.0 for c in coef])
    g = torch.Generator().manual_seed(2)
    u = torch.rand((300, 3), generator=g, dtype=torch.float64) * (M - 1)
    pos = (lo + u.to(dtype) * cell).to(dtype)
    got = pm._interp(grids.to(dtype), pos, lo, cell, M, periodic)
    u_back = ((pos - lo) / cell).double()
    want = u_back @ coef.T + 1.0
    torch.testing.assert_close(got.double(), want, rtol=4 * TOL[dtype],
                               atol=4 * TOL[dtype] * float(want.abs().max()))


@pytest.mark.parametrize("periodic", [True, False])
def test_the_cpu_takes_the_plain_versions_and_launches_nothing(periodic):
    """On a CPU tensor ``_deposit`` and ``_interp`` are the plain versions
    bit for bit (a stacked [D, M, M, M] tensor of grids as a list of them),
    and neither they nor ``mesh_accel`` touch ``pm.LAUNCHES``."""
    dtype = torch.float64
    dom, lo, cell = _geometry(periodic, dtype)
    pos = _positions(dom, 400, 3, dtype)
    mass = torch.full((400,), 1.0 / 400, dtype=dtype)
    before = dict(pm.LAUNCHES)
    grid = pm._deposit(pos, mass, lo, cell, M, periodic)
    assert torch.equal(grid, pm._deposit_plain(pos, mass, lo, cell, M,
                                               periodic))
    grids = torch.stack([grid, 2.0 * grid, grid * grid])
    got = pm._interp(grids, pos, lo, cell, M, periodic)
    assert torch.equal(got, pm._interp_plain(list(grids), pos, lo, cell, M,
                                             periodic))
    assert torch.equal(got[:, :1], pm._interp([grid], pos, lo, cell, M,
                                              periodic))
    cfg = configs.SPHConfig(dim=3, gravity=True, G=1.0, grav_eps=0.01,
                            grav_solver="p3m", grav_mesh=M)
    acc = pm.mesh_accel(pos, mass, cfg, dom)
    assert acc.shape == (400, 3) and bool(torch.isfinite(acc).all())
    assert pm.LAUNCHES == before


def test_every_entry_point_names_a_source_of_the_library():
    """``_build.open_library`` declares the entry points of the sources a
    library was built from: each entry point's source is one of them, and
    the CIC's are ``cic.cu``'s."""
    from sphax_torch import _build

    names = {src.name for src in _build.SOURCES}
    of = {b: _build._SOURCE_OF[b.split("_")[1]] for b in _build._ARGTYPES}
    assert set(of.values()) == names
    assert of["sphax_cic_deposit"] == of["sphax_cic_interp"] == "cic.cu"


def test_a_shard_rank_counts_the_cic_launches():
    """A shard rank's chunk record sums the CIC kernels' launches with the
    other hand kernels' (``dist.runner``)."""
    from sphax_torch.dist import runner

    assert set(pm.LAUNCHES) <= set(runner._launches())
