"""The rest of tests/test_torch_prungs.py's cases (a file of their own to
keep each file's time down): block timesteps with ``h_predict``
(tests/dist/test_prungs.py:93's case) on the 2x2 grid against
``sphax.dist.prungs`` at 1e-10, and the blast off centre, where a pencil
holds no closer on the span's first tick: against the JAX package, and
that rank still takes part in all four exchanges of a derived pass, its
kernels A and C (their plain versions) running on a fully masked
structure and handing back h0 and zeros on every row.
"""
import numpy as np
import torch

from sphax_torch import convert
from sphax_torch.dist import comm
from sphax_torch.integrate.rungs import _rung_of
from sphax_torch.integrate.timestep import particle_dt
from sphax_torch.physics import window_kernels as wk
from tests._slab_helpers import kernel_calls
from tests.test_torch_prungs import check_rungs

torch.set_num_threads(1)

OFF = (0.15, 0.3, 0.5)


def test_pencil_rungs_h_predict_match_reference():
    check_rungs("h_predict")


def _quiet_pass(c, rows, domain, cfg, spec, cuts):
    """Every rank: the closers of the span's first tick, then one rung
    derived pass recording kernel A's and C's arguments. Each rank returns
    (its closers, whether its kernels' outputs were h0 and zeros on every
    row), gathered on rank 0."""
    c.grid(spec.ns0, spec.ns1)
    st = convert.shard_from_numpy(rows, spec, c.rank, c.device,
                                  torch.float64)
    dom = convert.domain_from_numpy(*domain, device=c.device,
                                    dtype=torch.float64)
    real = st.mass > 0
    dt = torch.where(real, particle_dt(st, cfg), cfg.dt_max)
    rung = _rung_of(dt, c.all_reduce_min(dt.amin()), 3)
    close_m = real & (rung == 0)        # tick 0 closes rung 0 only
    calls, _ = kernel_calls(c, st, cuts, dom, cfg, spec, close_m)
    (a, ka), (ac, kc) = calls["A"], calls["C"]
    outs_a = wk.solve_h_density(*a, **ka)
    outs_c = wk.forces(*ac, **kc)
    blank = (torch.equal(outs_a[0], a[4])
             and not any(bool(o.any()) for o in outs_a[1:] + tuple(outs_c)))
    mine = torch.tensor([[float(close_m.sum()), float(blank)]],
                        dtype=torch.float64)
    got = c.gather_rows(mine)
    return None if got is None else got.numpy()


def test_pencil_rungs_offcentre_quiet_rank():
    """The blast at (0.15, 0.3, 0.5): the span matches the JAX package, and
    on its first tick only pencil (0, 0) holds closers; the three others
    run both kernels on fully masked structures, which give h0 and zeros
    on every row."""
    _, _, args = check_rungs("sedov", centre=OFF)
    got = comm.launch(_quiet_pass, 4, "cpu", "gloo", timeout=60,
                      deadline=120, args=args)
    closers, blank = got[:, 0], got[:, 1] > 0
    assert closers[0] > 0 and np.all(closers[1:] == 0), closers
    assert not blank[0] and np.all(blank[1:]), blank
