"""The derived pass's row gathers and packing (``physics/rowpack.py``).

On the CPU: each plain version equals the composition it stands for,
as the derived pass ran it before the three CUDA kernels
(``tests/_rowpack_frozen.py``), bit for bit (C's window on pad rows apart
from P, cs and ci, see ``rowpack``'s docstring), in 1D, 2D and 3D, fp32
and fp64, with and without the Balsara sums and the Morris-Monaghan
alpha, on in-place and compact structures (ghost rows and pad rows
present); and the whole derived pass equals the frozen pass bit for bit.

On a card (``-m gpu``, skipped without one): each CUDA kernel equals its
plain version bit for bit, a derived pass equals the frozen pass bit for
bit, and it launches each of the three kernels once. Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rowpack.py -q
"""
import dataclasses
import functools

import pytest
import torch

from sphax_torch import configs, make_state
from sphax_torch.core.state import box
from sphax_torch.neighbors import window as win
from sphax_torch.physics import eos as eos_mod
from sphax_torch.physics import rowpack, wengine
from tests._rowpack_frozen import (frozen_a_window, frozen_c_window,
                                   frozen_derived, frozen_gather,
                                   frozen_mirror, frozen_scatter)
from tests._torch_helpers import make_problem

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (balsara, mm_visc): need_divv off, Balsara alone, the alpha alone, both
VISC = {"plain": (False, False), "balsara": (True, False),
        "mm": (False, True), "balsara_mm": (True, True)}
# lattice sides: a few hundred particles, ghosts on every face
N_SIDE = {1: 64, 2: 14, 3: 8}


def _cfg(dim, visc):
    balsara, mm = VISC[visc]
    return configs.SPHConfig(dim=dim, gamma=5.0 / 3.0, adaptive_h=True,
                             grad_h=True, newton_iters=1, balsara=balsara,
                             mm_visc=mm)


@functools.lru_cache(maxsize=None)
def _structure(dim, dtype_name, compact, device="cpu"):
    """A jittered periodic lattice with random velocities, u and alpha, its
    domain, spec and structure; the structure has ghost rows and pad
    rows."""
    dtype = DTYPES[dtype_name]
    pos, vel, mass, u, h = make_problem(dim=dim, n_side=N_SIDE[dim], seed=3)
    t = [torch.as_tensor(a, dtype=dtype, device=device)
         for a in (pos, vel, mass, u, h)]
    st = make_state(*t)
    alpha = 0.1 + torch.rand(st.n, generator=torch.Generator().manual_seed(5),
                             dtype=dtype).to(device)
    st = st._replace(alpha=alpha)
    dom = box(torch.zeros(dim, dtype=dtype, device=device),
              torch.ones(dim, dtype=dtype, device=device), periodic=True)
    plan = win.plan_compact if compact else win.plan_measured
    spec = plan(st.pos, dom, h_max=float(st.h.max()) * 1.05, dim=dim,
                cutoff_scale=1.25, fast_sub=3, rgroups=2)
    wd = win.build(st.pos, dom, spec)
    n = st.n
    assert bool((wd.g == n).any()), "no pad rows"
    assert bool(((~wd.is_real) & (wd.g < n)).any()), "no ghost rows"
    return st, dom, spec, wd


def _sorted_fields(wd, dtype, device, seed=11):
    """Random sorted h, rho, om, bf on every row, as a density stage
    leaves them (not owner-mirrored)."""
    g = torch.Generator().manual_seed(seed)
    Ns = wd.g.shape[0]

    def rnd(lo, hi):
        return (lo + (hi - lo) * torch.rand(Ns, generator=g, dtype=dtype)
                ).to(device)
    return rnd(0.05, 0.2), rnd(0.8, 1.2), rnd(0.9, 1.1), rnd(0.0, 1.0)


FIELDS = ("h", "rho", "P", "cs", "omega", "acc", "du_dt", "divv")


def _same(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(got, want), (
        f"{what}: {int((got != want).sum())} entries differ, largest "
        f"{float((got - want).abs().max())}")


# ---------------------------------------------------------------------------
# CPU: the plain versions and the derived pass
# ---------------------------------------------------------------------------

CASES = pytest.mark.parametrize(
    "dim,dtype,visc,compact",
    [(d, t, v, c) for d in (1, 2, 3) for t in DTYPES for v in VISC
     for c in (False, True)])


@CASES
def test_gather_a_plain_equals_thefrozen_gather(dim, dtype, visc, compact):
    st, _, _, wd = _structure(dim, dtype, compact)
    cfg = _cfg(dim, visc)
    win_a, h0_s, u_s, alpha_s = rowpack.gather_a(st, wd, cfg)
    pos_s, vel_s, mass_s, u_w, h_w, alpha_w = frozen_gather(st, wd, cfg)
    assert win_a.is_contiguous() and win_a.shape == (2 * dim + 1,
                                                      wd.g.shape[0])
    fuse = cfg.need_divv
    a_rows = (2 if fuse else 1) * dim + 1
    _same(win_a[:a_rows], frozen_a_window(pos_s, mass_s, vel_s, fuse),
          "A's window")
    _same(win_a[dim + 1:], vel_s.T, "velocity rows")
    _same(h0_s, h_w, "h0")
    _same(u_s, u_w, "u")
    if cfg.mm_visc:
        _same(alpha_s, alpha_w, "alpha")
    else:
        assert alpha_s is None
    pad = wd.g == st.n
    assert bool((h0_s[pad] == 1).all() and (win_a[dim][pad] == 0).all())


@CASES
def test_gather_c_plain_equals_thefrozen_mirror_and_packing(dim, dtype, visc,
                                                             compact):
    st, _, _, wd = _structure(dim, dtype, compact)
    cfg = _cfg(dim, visc)
    win_a, _, u_s, _ = rowpack.gather_a(st, wd, cfg)
    h_s, rho_s, om_s, bf_s = _sorted_fields(wd, DTYPES[dtype], "cpu")
    # the derived pass's order: the EOS on the stage's own rows
    P_s, cs_s = eos_mod.eos(rho_s, u_s, cfg)
    win_c, mirrored = rowpack.gather_c(win_a, wd, cfg, h_s, rho_s, om_s,
                                       bf_s, P_s, cs_s)
    want_m = frozen_mirror(wd, u_s, h_s, rho_s, om_s, bf_s, cfg)
    want = frozen_c_window(win_a[:dim].T, win_a[dim + 1:].T, win_a[dim],
                            *want_m, cfg)
    assert win_c.shape == (rowpack.c_rows(dim, cfg.visc_factor_on),
                           wd.g.shape[0])
    # the owner mirror of a pad row is a non-real row the build leaves
    # unspecified (a parallel scatter picks one); where that is a ghost,
    # the EOS of its row reads the ghost's u where the frozen EOS read the
    # pad row's 0: P, cs and ci differ there, every other entry is equal
    real = wd.g < st.n
    pad_free = [k for k in range(win_c.shape[0])
                if k not in (2 * dim + 4, 2 * dim + 5)]
    for k, (a, b) in enumerate(zip(mirrored, want_m)):
        _same(a[real], b[real], f"mirrored field {k}")
        if k not in (2, 3):
            _same(a, b, f"mirrored field {k}, pad rows")
    _same(win_c[:, real], want[:, real], "C's window")
    _same(win_c[pad_free], want[pad_free], "C's window, pad rows")


@CASES
def test_scatter_out_plain_equals_thefrozen_unsort(dim, dtype, visc,
                                                    compact):
    st, _, _, wd = _structure(dim, dtype, compact)
    Ns = wd.g.shape[0]
    g = torch.Generator().manual_seed(17)
    fields = [torch.randn(Ns, generator=g, dtype=DTYPES[dtype])
              for _ in range(7)]
    acc_s = torch.randn((Ns, dim), generator=g, dtype=DTYPES[dtype])
    got = rowpack.scatter_out(wd, *fields, acc_s)
    want = frozen_scatter(wd, *fields, acc_s)
    assert len(got) == 8
    for k, (a, b) in enumerate(zip(got, want)):
        _same(a, b, f"output {k}")


@CASES
def test_derived_with_equals_thefrozen_pass(dim, dtype, visc, compact):
    st, dom, spec, wd = _structure(dim, dtype, compact)
    cfg = _cfg(dim, visc)
    got = wengine.derived_with(st, wd, cfg, dom, spec)
    want = frozen_derived(st, wd, cfg, dom, spec)
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f), f)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, st, wd):
    return (st._replace(**{f: getattr(st, f).to(dev) for f in st._fields}),
            wd._replace(**{f: (getattr(wd, f).to(dev)
                               if getattr(wd, f) is not None else None)
                           for f in wd._fields}))


GPU_CASES = pytest.mark.parametrize(
    "dim,dtype,visc", [(d, t, v) for d in (1, 2, 3) for t in DTYPES
                       for v in VISC])


@pytest.mark.gpu
@GPU_CASES
def test_kernels_equal_their_plain_versions(cuda, dim, dtype, visc):
    st, _, _, wd = _structure(dim, dtype, False)
    st, wd = _on(cuda, st, wd)
    cfg = _cfg(dim, visc)
    n0 = dict(rowpack.LAUNCHES)
    got_a = rowpack.gather_a(st, wd, cfg)
    want_a = rowpack.gather_a_plain(st, wd, cfg)
    for k, (a, b) in enumerate(zip(got_a, want_a)):
        if b is None:
            assert a is None
        else:
            _same(a, b, f"gather_a output {k}")
    win_a, _, u_s, _ = got_a
    h_s, rho_s, om_s, bf_s = _sorted_fields(wd, DTYPES[dtype], cuda)
    P_s, cs_s = eos_mod.eos(rho_s, u_s, cfg)
    got_c, none = rowpack.gather_c(win_a, wd, cfg, h_s, rho_s, om_s, bf_s,
                                   P_s, cs_s)
    assert none == (None,) * 6
    want_c, _ = rowpack.gather_c_plain(win_a, wd, cfg, h_s, rho_s, om_s,
                                       bf_s, P_s, cs_s)
    _same(got_c, want_c, "C's window")
    du_s, divv_s = torch.randn_like(h_s), torch.randn_like(h_s)
    acc_s = torch.randn((h_s.shape[0], dim), dtype=h_s.dtype, device=cuda)
    args = (wd, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s, acc_s)
    got = rowpack.scatter_out(*args)
    assert all(t.is_contiguous() for t in got)
    for k, (a, b) in enumerate(zip(got, rowpack.scatter_out_plain(*args))):
        _same(a, b, f"scatter_out output {k}")
    assert {k: rowpack.LAUNCHES[k] - n0[k] for k in n0} == {
        k: 1 for k in n0}


@pytest.mark.gpu
@GPU_CASES
def test_derived_with_on_the_card_equals_thefrozen_pass(cuda, dim, dtype,
                                                         visc):
    st, dom, spec, wd = _structure(dim, dtype, False)
    st, wd = _on(cuda, st, wd)
    dom = dataclasses.replace(dom, lo=dom.lo.to(cuda), hi=dom.hi.to(cuda))
    cfg = _cfg(dim, visc)
    n0 = dict(rowpack.LAUNCHES)
    got = wengine.derived_with(st, wd, cfg, dom, spec)
    torch.cuda.synchronize()
    assert {k: rowpack.LAUNCHES[k] - n0[k] for k in n0} == {
        k: 1 for k in n0}
    want = frozen_derived(st, wd, cfg, dom, spec)
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f), f)
        assert getattr(got, f).is_contiguous(), f
