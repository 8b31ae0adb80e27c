"""The port's window structure against ``sphax.neighbors.window``: on the
same positions and spec the integer tables are EQUAL, the sorted positions
and shifts are equal, and plan_measured returns an equal spec. The
compaction (spec.cwidth > 0) is held in tests/test_torch_compact.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.ics import turbulence
from sphax.neighbors import window as jwin
from sphax_torch import convert
from sphax_torch.neighbors import window as twin
from tests.parity.test_dense_vs_reference import make_problem

torch.set_num_threads(1)

_jbuild = jax.jit(jwin.build, static_argnums=2)


def _domains(periodic=True):
    jd = sphax.box(jnp.zeros(3), jnp.ones(3), periodic=periodic)
    td = convert.domain_from_numpy(np.zeros(3), np.ones(3), periodic,
                                   device="cpu", dtype=torch.float64)
    return jd, td


def _assert_same_structure(jw, tw, n):
    for f in ("g", "inv", "is_real", "w_lo", "w_nact", "t_lo", "t_nact",
              "overflow", "max_run"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)
    # pad rows' src comes from duplicate scatter writes: unspecified
    own = np.asarray(jw.g) < n
    np.testing.assert_array_equal(tw.src.numpy()[own], np.asarray(jw.src)[own])
    for f in ("pos_s", "shift_s"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)
    assert tw.w_lo.dtype == torch.int32 and tw.w_nact.dtype == torch.int32


@pytest.mark.parametrize("fast_sub,rgroups", [(3, 2), (1, 1)])
def test_build_equals_reference(fast_sub, rgroups):
    """Production knobs (fast_sub=3, rgroups=2) and the planner's 1/1."""
    ic = turbulence.build(n_side=10)
    pos = ic["pos"]
    jd, td = _domains()
    kw = dict(h_max=float(ic["h"].max()) * 1.05, dim=3, cutoff_scale=1.05,
              ghost_safety=1.4, fast_sub=fast_sub, rgroups=rgroups)
    jspec = jwin.plan_measured(jnp.asarray(pos), jd, **kw)
    tspec = twin.plan_measured(torch.as_tensor(pos), td, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert convert.spec_from_fields(**dataclasses.asdict(jspec)) == tspec

    jw = _jbuild(jnp.asarray(pos), jd, jspec)
    tw = twin.build(torch.as_tensor(pos), td, tspec)
    _assert_same_structure(jw, tw, len(pos))
    assert int(tw.overflow) == 0

    # the gathers that move fields between original and sorted order
    rng = np.random.default_rng(0)
    cols = rng.normal(size=(len(pos), 4))
    fills = [0.0, 1.0, 2.0, 3.0]
    np.testing.assert_array_equal(
        twin.gather_sorted_cols(torch.as_tensor(cols), tw, fills).numpy(),
        np.asarray(jwin.gather_sorted_cols(jnp.asarray(cols), jw, fills)))
    srt = rng.normal(size=(tspec.n_sorted,))
    np.testing.assert_array_equal(
        twin.mirror_owner(torch.as_tensor(srt), tw).numpy(),
        np.asarray(jwin.mirror_owner(jnp.asarray(srt), jw)))
    np.testing.assert_array_equal(
        twin.scatter_real(torch.as_tensor(srt), tw, len(pos)).numpy(),
        np.asarray(jwin.scatter_real(jnp.asarray(srt), jw, len(pos))))
    moved = pos + 1e-3 * rng.normal(size=pos.shape)
    np.testing.assert_array_equal(
        twin.refresh_pos(torch.as_tensor(moved), tw).numpy(),
        np.asarray(jwin.refresh_pos(jnp.asarray(moved), jw)))


def test_open_box_equals_reference():
    """Non-periodic axes: no ghosts and clamped binning coordinates."""
    pos, *_ = make_problem(dim=3, n_side=8, seed=3)
    pos = pos * 1.02 - 0.01          # some rows drift outside the open box
    jd, td = _domains(periodic=(False, True, False))
    spec = jwin.plan_windows(jd, h_max=0.2, n=len(pos), dim=3)
    tspec = twin.plan_windows(td, h_max=0.2, n=len(pos), dim=3)
    assert tspec == convert.spec_from_fields(**dataclasses.asdict(spec))
    _assert_same_structure(_jbuild(jnp.asarray(pos), jd, spec),
                           twin.build(torch.as_tensor(pos), td, tspec),
                           len(pos))


def test_overflow_detected_when_wseg_too_small():
    """The overflow case of tests/parity/test_window_vs_dense.py."""
    pos, _, _, _, h = make_problem(dim=3, n_side=8, seed=3)
    jd, td = _domains()
    kw = dict(h_max=float(h.max()), n=len(pos), dim=3, tile=64, wseg=128,
              seg_safety=0.01)
    jspec = jwin.plan_windows(jd, **kw)
    tspec = twin.plan_windows(td, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    jw = _jbuild(jnp.asarray(pos), jd, jspec)
    tw = twin.build(torch.as_tensor(pos), td, tspec)
    assert int(tw.overflow) > 0
    _assert_same_structure(jw, tw, len(pos))
